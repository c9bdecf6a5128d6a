r"""Argument handling, binding and launch shared by the wrappers of the
port's scan kernels (``gcn_lstm``, ``ggru``, ``lstm``).

Each ``csrc/<name>.cu`` exports a plain C interface: ``<name>_forward``
(device pointers, then ints, then the CUDA stream; returns a
``cudaError_t``), ``<name>_error_string`` and ``<name>_smem_bytes``."""

from __future__ import annotations

import ctypes

import torch

__all__ = ["SMEM_LIMIT", "f32", "n_valid_tensor", "check_f32",
           "check_n_valid", "kernel_library", "launch"]

SMEM_LIMIT = 232448          # bytes of shared memory one block can have


def f32(t: torch.Tensor) -> torch.Tensor:
    r"""bf16/fp16 inputs are upcast at the boundary: the kernels are fp32
    inside."""
    return t if t.dtype == torch.float32 else t.float()


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


def kernel_library(name: str, n_pointers: int, n_ints: int,
                   n_smem_args: int):
    r"""Build (at first use) and load ``csrc/<name>.cu``, with the ctypes
    signatures of its C interface set."""
    from a3gc_tpu_torch.ops._build import load_library
    lib = load_library(name).lib
    fn = getattr(lib, f"{name}_forward")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes = [ctypes.c_int] * n_smem_args
        smem.restype = ctypes.c_size_t
    return lib


def launch(name: str, lib, dev: torch.device, *args):
    r"""Call ``<name>_forward(*args, stream)`` on the current stream of
    ``dev``; raise if the launch was refused."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_forward")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + getattr(lib, f"{name}_error_string")(err)
                           .decode())
