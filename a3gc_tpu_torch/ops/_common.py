r"""Argument handling, binding and launch shared by the wrappers of the
port's scan kernels (``gcn_lstm``, ``ggru``, ``lstm``).

Each ``csrc/<name>.cu`` exports a plain C interface: ``<name>_forward``
(device pointers, then ints, then the CUDA stream; returns a
``cudaError_t``), ``<name>_error_string``, ``<name>_max_active`` (ints)
and ``<name>_func_attributes`` (ints, then two ``int*``), all bound by
:func:`kernel_library`.

The launch plans are computed in Python and passed to C: :func:`k_slices`
is the thread mapping the kernels use, and each module's ``cached_plan``
keeps its ``launch_plan``'s answer per key (:func:`plan_or_refusal`), which
the dispatch and the launch both read.

The operand format of the nets' products is settled here too: a net's
``precision`` ("highest" or "default", the JAX package's
``GraphNetConfig.precision``) becomes "fp32" or "tf32" on a device
(:func:`operand_format`), and at "tf32" every product takes its operands
rounded to TF32 (:func:`round_tf32`; :func:`operand` for an activation,
:func:`weight_operand` for a parameter, rounded once a version) and sums
in fp32: the arithmetic of one tensor-core pass, which is what XLA's
``Precision.DEFAULT`` computes on an Ampere or Hopper card. The kernels'
TF32 instantiations round by the same rule (``csrc/scan_common.cuh``
``tf32_round``). The
rounding is explicit, not ``torch.backends.cuda.matmul.allow_tf32``: that
switch is global to the process, would reach the geometry and the metrics
(which JAX keeps at HIGHEST) and would leak across the server's
threads."""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict

import torch

from a3gc_tpu_torch._runtime import span

__all__ = ["SMEM_LIMIT", "SMEM_HEADER", "THREADS", "MAX_CLUSTER", "f32",
           "PRECISIONS", "FORMATS", "check_precision", "operand_format",
           "round_tf32", "operand", "weight_operand", "WEIGHT_CACHE_ENTRIES",
           "step_operand", "like",
           "n_valid_tensor", "check_f32", "check_n_valid", "check_aligned",
           "k_slices", "mma_row_stride", "sm_count", "device_index",
           "plan_or_refusal", "planned", "kernel_library", "launch",
           "max_active_query", "attributes_query"]

SMEM_LIMIT = 232448          # bytes of shared memory one block can have
SMEM_HEADER = 64             # bytes before the float arrays (scan_common.cuh)
THREADS = 256                # threads per CTA of lstm.cu and gcn_lstm.cu
MAX_CLUSTER = 8              # the portable thread-block cluster size


def k_slices(columns: int, K: int, threads: int = THREADS) -> int:
    r"""k-slices per column of a product over K rows: the largest power of
    two ≤ 32 such that ``columns`` × slices threads fit in ``threads`` and
    every slice is a whole number of float4 (K % (4·slices) == 0). Lanes
    ``ks·(32 / slices) + column`` of a warp share a column and are summed by
    shuffles (scan_common.cuh ``reduce_k_slices``)."""
    ks = 1
    while ks < 32 and columns * ks * 2 <= threads and K % (8 * ks) == 0:
        ks *= 2
    return ks


def mma_row_stride(K: int) -> int:
    r"""Row stride (floats) of an A operand of the TF32 instantiations'
    tensor-core products in shared memory, ≡ 16 (mod 32)
    (``csrc/scan_common.cuh`` ``mma_row_stride``): a quarter-warp's 16-byte
    fragment loads of two adjacent rows then fall on distinct banks."""
    return K + (48 - K % 32) % 32


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    r"""Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_index(dev: torch.device) -> int:
    r"""The index of CUDA device ``dev``; a bare ``cuda`` is the current
    device."""
    return dev.index if dev.index is not None else torch.cuda.current_device()


def f32(t: torch.Tensor) -> torch.Tensor:
    r"""bf16/fp16 inputs are upcast at the boundary: the kernels are fp32
    inside."""
    return t if t.dtype == torch.float32 else t.float()


PRECISIONS = ("highest", "default")
FORMATS = ("fp32", "tf32")


def check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


def operand_format(precision: str, device) -> str:
    r"""The operand format of a net's products at ``precision`` on
    ``device``: "highest" → "fp32" everywhere; "default" → "tf32" on a CUDA
    device and "fp32" on the CPU, as ``jax.lax.Precision.DEFAULT`` is one
    TF32 tensor-core pass on an Ampere or Hopper card and fp32 on the CPU.
    Raises ``ValueError`` on any other precision."""
    check_precision(precision)
    if precision == "highest":
        return "fp32"
    return "tf32" if torch.device(device).type == "cuda" else "fp32"


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    r"""fp32 ``t`` rounded to TF32 (10 mantissa bits), to nearest, ties to
    even, kept in fp32; inf and NaN as they are, a finite value past the
    largest TF32 to inf: ``jax.lax.reduce_precision(t, 8, 10)`` bit for
    bit. No gradient (see :func:`operand`)."""
    i = t.detach().view(torch.int32)
    r = ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), r, t.detach())


def operand(t: torch.Tensor, fmt: str) -> torch.Tensor:
    r"""``t`` as an operand of a product in format ``fmt``: itself at
    "fp32"; at "tf32" an fp32 ``t`` rounded by :func:`round_tf32` with a
    straight-through gradient (the rounding's own derivative is zero
    almost everywhere; JAX differentiates a DEFAULT product through
    DEFAULT products, the port through fp32 ones). A bf16 or fp16 ``t`` is
    a TF32 value already. The rounding is the span ``a3gc.round``; a
    per-frame step takes :func:`step_operand`, which opens none."""
    if fmt == "fp32" or t.dtype != torch.float32:
        return t
    with span("a3gc.round"):
        return step_operand(t, fmt)


WEIGHT_CACHE_ENTRIES = 128   # rounded weights kept, least recently used out
_WEIGHT_LOCK = threading.Lock()


def weight_operand(w: torch.Tensor, fmt: str) -> torch.Tensor:
    r"""A parameter ``w`` (or a view of one) as an operand of a product in
    format ``fmt``: :func:`operand`'s value, bit for bit. At "tf32" the
    rounded copy is kept in ``weight_operand.cache`` and served again while
    ``w`` is the same weight at the same version, so a net's weights are
    rounded once, not on every call. The key is what the view reads
    (address, storage offset, sizes, strides, dtype, device), so a fresh
    view of a weight (``kernel[:, :F]``, a reshape) finds it; the entry
    keeps its version counter's value (views share their base's), so an
    in-place update anywhere in the storage's base makes it stale, and a
    strong reference to ``w``, so its memory is never reused while the
    entry lives. At most :data:`WEIGHT_CACHE_ENTRIES` entries, least
    recently used evicted first.

    The cache steps aside, rounding as :func:`operand` does, where autograd
    records ``w`` (its straight-through gradient), for an inference tensor
    (no version counter), and while ``torch.export`` or
    ``torch.compile`` traces (the program keeps its rounding nodes).
    Hit or miss, the call is the span ``a3gc.round``; a hit does no tensor
    operation. Counters: ``hits``, ``misses``, ``bypassed``."""
    if fmt == "fp32" or w.dtype != torch.float32:
        return w
    with span("a3gc.round"):
        return _cached_round(w, fmt)


def _cached_round(w: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt != "tf32":
        raise ValueError(f"operand format must be one of {FORMATS}, got "
                         f"{fmt!r}")
    if torch.compiler.is_compiling() or w.is_inference() \
            or (w.requires_grad and torch.is_grad_enabled()):
        weight_operand.bypassed += 1
        return step_operand(w, fmt)
    key = (w.data_ptr(), w.storage_offset(), w.shape, w.stride(), w.dtype,
           w.device)
    version = w._version
    cache = weight_operand.cache
    with _WEIGHT_LOCK:
        entry = cache.get(key)
        if entry is not None and entry[0] == version:
            cache.move_to_end(key)
            weight_operand.hits += 1
            return entry[2]
    with torch.inference_mode(False):   # a copy autograd may save later
        r = round_tf32(w)
    with _WEIGHT_LOCK:
        cache[key] = (version, w, r)
        cache.move_to_end(key)
        weight_operand.misses += 1
        while len(cache) > WEIGHT_CACHE_ENTRIES:
            cache.popitem(last=False)
    return r


weight_operand.cache = OrderedDict()   # key -> (version, source, rounded)
weight_operand.hits = 0         # served from the cache since the last reset
weight_operand.misses = 0       # rounded and kept
weight_operand.bypassed = 0     # rounded as operand does (see above)


def step_operand(t: torch.Tensor, fmt: str) -> torch.Tensor:
    r""":func:`operand` without its span, for the products of a per-frame
    step: a span there would be one a frame."""
    if fmt == "fp32" or t.dtype != torch.float32:
        return t
    if fmt != "tf32":
        raise ValueError(f"operand format must be one of {FORMATS}, got "
                         f"{fmt!r}")
    r = round_tf32(t)
    if not t.requires_grad:
        return r
    return t + torch.where(torch.isfinite(t), r - t.detach(), 0.0)


def like(out, ref: torch.Tensor):
    r"""``out`` (a tensor or a tuple of them) in the dtype of ``ref``: the
    fp32 results of a layer given bf16 inputs go back as bf16."""
    if isinstance(out, tuple):
        return tuple(like(t, ref) for t in out)
    return out if out.dtype == ref.dtype else out.to(ref.dtype)


def n_valid_tensor(n_valid, S: int, T: int, device) -> torch.Tensor:
    r"""Per-stream valid lengths as int32 [S]: None → T everywhere, a
    scalar → broadcast."""
    if n_valid is None:
        return torch.full((S,), T, dtype=torch.int32, device=device)
    nv = torch.as_tensor(n_valid, device=device).to(torch.int32).reshape(-1)
    return nv.expand(S).contiguous() if nv.numel() == 1 else nv


def check_f32(kernel: str, dev: torch.device, pairs):
    r"""Raise unless each tensor of ``pairs`` ((tensor, shape), …) is a
    contiguous float32 tensor of that shape on ``dev``."""
    for t, shape in pairs:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: expected a contiguous float32 "
                             f"tensor {tuple(shape)} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def check_n_valid(kernel: str, dev: torch.device, n_valid: torch.Tensor,
                  S: int):
    if n_valid.device != dev or n_valid.dtype != torch.int32 \
            or n_valid.shape != (S,):
        raise ValueError(f"{kernel}: n_valid must be int32 [{S}] on {dev}")


def check_aligned(kernel: str, *tensors):
    r"""Raise unless each tensor starts on a 16-byte boundary: the kernels
    copy their inputs with 16-byte cp.async and cp.async.bulk."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: a {tuple(t.shape)} input is not "
                             "16-byte aligned")


def plan_or_refusal(launch_plan, *args, **kwargs):
    r"""``launch_plan(*args, **kwargs)``, or the message of the
    ``ValueError`` it raises: what a module's ``cached_plan`` keeps."""
    try:
        return launch_plan(*args, **kwargs)
    except ValueError as e:
        return str(e)


def planned(plan_or_message):
    r"""The plan of a ``cached_plan`` answer; raise ``ValueError`` with its
    message where it is a refusal."""
    if isinstance(plan_or_message, str):
        raise ValueError(plan_or_message)
    return plan_or_message


@functools.lru_cache(maxsize=None)
def kernel_library(name: str, n_pointers: int, n_ints: int, n_active: int,
                   n_attributes: int):
    r"""Build (at first use) and load ``csrc/<name>.cu``, with the ctypes
    signatures of its exports set from their arities (ints beside the
    pointers of ``_forward`` and the two ``int*`` of ``_func_attributes``)."""
    from a3gc_tpu_torch.ops._build import load_library
    lib = load_library(name).lib
    ints, out = [ctypes.c_int], [ctypes.POINTER(ctypes.c_int)]
    for export, argtypes, restype in (
            ("forward", [ctypes.c_void_p] * n_pointers + ints * n_ints
             + [ctypes.c_void_p], ctypes.c_int),
            ("error_string", ints, ctypes.c_char_p),
            ("max_active", ints * n_active, ctypes.c_int),
            ("func_attributes", ints * n_attributes + out * 2,
             ctypes.c_int)):
        fn = getattr(lib, f"{name}_{export}")
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _check(name: str, lib, err: int, what: str):
    r"""Raise ``RuntimeError`` unless the ``cudaError_t`` ``err`` is 0."""
    if err != 0:
        raise RuntimeError(f"{name} {what} failed: "
                           + getattr(lib, f"{name}_error_string")(err)
                           .decode())


def launch(name: str, lib, dev: torch.device, *args):
    r"""Call ``<name>_forward(*args, stream)`` on the current stream of
    ``dev``; raise if the launch was refused."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_forward")(*args, stream)
    _check(name, lib, err, "kernel launch")


def max_active_query(name: str, lib, *ints) -> int:
    r"""``<name>_max_active(*ints)``, raising where it returns minus a
    ``cudaError_t``."""
    n = getattr(lib, f"{name}_max_active")(*ints)
    _check(name, lib, -min(n, 0), "occupancy query")
    return n


def attributes_query(name: str, lib, *ints) -> dict:
    r"""``<name>_func_attributes(*ints, &regs, &local_bytes)`` as
    {"regs": …, "local_bytes": …}, raising on an error."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    _check(name, lib, getattr(lib, f"{name}_func_attributes")(
        *ints, ctypes.byref(regs), ctypes.byref(local)), "attribute query")
    return {"regs": regs.value, "local_bytes": local.value}
