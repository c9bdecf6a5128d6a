r"""Bidirectional G-GRU layer over a whole window in one kernel launch
(counterpart of ``a3gc_tpu/ops/pallas_gcn_lstm.py`` ``bi_ggru_pallas``).

:func:`bi_ggru` hoists the input projection ``zi = x·W_in + b_in`` out of
the scan with one ``torch.matmul`` (as the JAX package leaves it to XLA
outside its kernel) and launches ``csrc/ggru.cu``, both directions in one
launch: a thread-block cluster of C CTAs per (stream, direction) that split
the hidden columns, keep their slice of the recurrent weights in shared
memory for the whole window, and exchange their columns through distributed
shared memory each frame (``st.async`` stores completing on the receiver's
mbarriers). :func:`launch_plan` chooses C; :func:`cached_plan` keeps its
answer per key.

The kernel reassociates the cell's recurrent chain: adj·(h·G)·W_hid =
(adj·h)·(G·W_hid). Each CTA forms its columns of W = G·W_hid once per
launch, inside the kernel, and a frame is then one product on one resident
matrix with one exchange (adj·h): 6·N·H² FLOP a frame instead of the 8·N·H²
of the JAX cell's op order (msg = adj·(h·G), zh = msg·W_hid, two exchanges),
which took 1.3-1.6× the time. The same function with its sums in another
order: within 5e-7 of the plain version on an H100 (within 4e-6 at twice
the initial recurrent weights, as a kernel in the cell's own order is).
The TF32 instantiation keeps the cell's order, because TF32 rounds each
product's operands and the fold would round other values; its products run
on the tensor cores (``mma.sync`` m16n8k8 TF32, plan field ``mma``): with
all of G resident up to H = 128, each CTA forms all of h·G and msg itself
and a frame has one exchange, as the fold has; at H = 256 (G's own columns)
msg is exchanged too.

The launch is the CUDA implementation of the registered op
``a3gc_tpu_torch::ggru_scan`` (:mod:`a3gc_tpu_torch.ops.library`), whose
CPU implementation is :func:`scan_reference`, the plain PyTorch version of
the same function (the JAX cell's op order): on a CPU tensor
:func:`bi_ggru` computes it, on a CUDA tensor it launches the kernel or
raises.

The function, for x [S, T, N, F], h2 [2, S, N, H] and per-stream
``n_valid`` [S]:

  * direction 0 walks frames 0 … T-1, direction 1 walks T-1 … 0;
  * frames < n_valid[s] update stream s's state, later frames carry it;
  * y [S, T, N, 2H] is the carried h after each frame, forward ‖ backward
    (no tanh on this cell) — on valid frames the cell output, on the
    others the carried h (the Pallas kernel's output there);
  * returns (y, h) with the final state h [2, S, N, H].

The kernel has no backward: the op's autograd formula reruns
:func:`scan_reference` on the saved inputs. The kernel is fp32 inside;
the outputs come back in the dtypes of x and of the state. ``fmt`` (the
net's operand format) at "tf32" rounds the products' operands to TF32:
the hoisted x·W_in here; in the plain version and in the kernel's TF32
instantiation the cell's h·G, adj·hg and msg·W_hid (``csrc/ggru.cu``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple, Optional, Union

import torch

from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops._common import (MAX_CLUSTER, SMEM_HEADER, SMEM_LIMIT,
                                        attributes_query, check_aligned,
                                        check_f32, check_n_valid,
                                        device_index, f32, k_slices,
                                        kernel_library, launch, like,
                                        max_active_query, mma_row_stride,
                                        n_valid_tensor, plan_or_refusal,
                                        planned, sm_count)
from a3gc_tpu_torch.parallel import tensor as TP

__all__ = ["LaunchPlan", "bi_ggru", "bi_ggru_reference", "cached_plan",
           "func_attributes", "gate_pad", "launch_plan", "max_active",
           "mma_ok", "one_wave", "scan", "scan_inputs", "scan_reference",
           "smem_bytes"]

NODES = 16           # node rows padded to 16
THREADS = 256        # threads per CTA of ggru.cu


class LaunchPlan(NamedTuple):
    r"""How ``csrc/ggru.cu`` runs one layer call: a cluster of C CTAs per
    (stream, direction)."""
    C: int             # CTAs per cluster; CTA c owns hidden columns c·H/C …
    KS: int            # k-slices per pair of units (6 gate columns) of the
                       # product on G·W_hid
    threads: int
    smem: int          # dynamic shared memory per CTA, bytes
    mma: int = 0       # the TF32 instantiation's products on the tensor
                       # cores: 1 with G's own columns (two exchanges a
                       # frame), 2 with all of G resident (one); 0: FMA loops

    @property
    def cluster(self) -> int:
        return self.C


def gate_pad(M: int) -> int:
    r"""Floats between the 4-row groups of the gate matrix [H, M] in shared
    memory (``gate_pad`` in C): k-slices 4 rows apart then read banks 4
    apart."""
    return (36 - (4 * M) % 32) % 32


def mma_ok(H: int, Hc: int) -> bool:
    r"""Whether the TF32 instantiation can take the tensor-core paths at
    this split (``mma_ok`` in C): k in 16-deep blocks and swizzled weights
    (H % 32 == 0), whole 8-column n-tiles of own columns (Hc % 8 == 0)."""
    return H % 32 == 0 and Hc % 8 == 0


def smem_bytes(N: int, H: int, C: int, tf32: bool = False,
               mma: int = 0) -> int:
    r"""Dynamic shared memory of one CTA (C: ``smem_floats``): the
    slice [H, 3H/C] of G·W_hid (:func:`gate_pad` floats after every 4 rows),
    the full adj·h [16, H], double-buffered, zi [N, 3H/C], the gate
    pre-activations [16, 3H/C], the adjacency padded to 16 × 16 and the own
    columns of h [16, H/C]. The TF32 instantiation (``tf32``; the slice of
    W_hid in place of G·W_hid, msg in place of adj·h) adds its slice
    [H, H/C] of G and the full h [16, H], double-buffered. On the tensor
    cores (``mma`` 1: G's own columns, 2: all of G) the W_hid and G slices
    are transposed, unpadded, the rows of h and msg padded to
    ``_common.mma_row_stride``, and mma 2 keeps one msg buffer."""
    Hc = H // C
    M = 3 * Hc
    if mma:
        HS = mma_row_stride(H)
        return SMEM_HEADER + 4 * (
            H * M + (1 if mma == 2 else 2) * NODES * HS + N * M + NODES * M
            + NODES * NODES + NODES * Hc + (H if mma == 2 else Hc) * H
            + 2 * NODES * HS)
    floats = (H * M + H // 4 * gate_pad(M) + 2 * NODES * H + N * M
              + NODES * M + NODES * NODES + NODES * Hc)
    if tf32:
        floats += H * Hc + H // 4 * gate_pad(Hc) + 2 * NODES * H
    return SMEM_HEADER + 4 * floats


def one_wave(C: int, sms: int = 132) -> int:
    r"""Clusters of C CTAs, one CTA an SM, that a card of ``sms`` SMs is
    sure to run at once. ``cudaOccupancyMaxActiveClusters`` gave 15
    clusters of 8 and 30 of 4 on every H100 (132 SMs) asked: the SMs of a
    GPC that do not fill a cluster stay out, about one in eleven. (Some of
    those cards then ran 16 clusters of 8 at once, some ran them in two
    waves.)"""
    return (sms - sms // 11) // C


def _mma_choice(N: int, H: int, C: int, tf32: bool,
                mma: Optional[int]) -> int:
    r"""The tensor-core path of a TF32 plan at C: ``mma`` if given (checked),
    else all of G resident where it fits (one exchange a frame), else G's
    own columns, else (no tensor-core shape, or nothing fits) 0."""
    if mma is not None:
        if mma and (not tf32 or mma not in (1, 2)
                    or not mma_ok(H, H // C)):
            raise ValueError(f"ggru: no launch plan with mma={mma} for "
                             f"H={H}, C={C}, tf32={tf32}")
        return mma
    if not tf32 or not mma_ok(H, H // C):
        return 0
    return next((m for m in (2, 1)
                 if smem_bytes(N, H, C, True, m) <= SMEM_LIMIT), 0)


def launch_plan(S: int, N: int, H: int, C: Optional[int] = None,
                sms: int = 132, tf32: bool = False,
                mma: Optional[int] = None) -> LaunchPlan:
    r"""The clusters for S streams of N ≤ 16 nodes at hidden width H, for
    the fp32 or (``tf32``) the TF32 instantiation.

    C: the largest of 8, 4, 2, 1 that leaves a CTA at least 8 hidden
    columns, fits in shared memory and whose 2·S clusters run in one wave
    (:func:`one_wave`); else the largest that fits. ``C`` forces it, for
    measuring C against 2C. Raises if nothing fits.

    Measured on H100s (``scripts/torch_kernel_ab.py``, T = 60): a frame's
    time falls with C, so one stream takes clusters of 8 (H = 128: 0.18 ms
    against 0.24 with 4), and 8 streams take 4 at H = 64 and 128, where
    16 clusters of 8 may need two waves (0.25 against 0.35 ms at H = 128).
    At H = 256 only C = 8 fits, and 8 streams took 0.74 ms on a card that
    ran the sixteen clusters in two waves and 0.46 ms on one that ran them
    at once.

    The TF32 instantiation's path (:func:`_mma_choice`; ``mma`` forces it:
    0 keeps the FMA loops, for measuring one against the other) does not
    change C."""
    if S <= 0 or N <= 0 or N > NODES or H <= 0 or H % 4:
        raise ValueError(f"ggru: needs S >= 1, N <= {NODES} and H % 4 == 0, "
                         f"got S={S}, N={N}, H={H}")
    if C is not None:
        cs = [C] if 0 < C <= MAX_CLUSTER and H % C == 0 and H // C % 4 == 0 \
            else []
    else:
        cs = [c for c in (8, 4, 2, 1) if H % c == 0 and H // c % 4 == 0
              and (H // c >= 8 or c == 1)]
    cs = [c for c in cs if smem_bytes(N, H, c, tf32) <= SMEM_LIMIT]
    if not cs:
        raise ValueError(f"ggru: no launch plan for S={S}, N={N}, H={H}"
                         + (f", C={C}" if C is not None else ""))
    c = next((c for c in cs if 2 * S <= one_wave(c, sms)), cs[0])
    m = _mma_choice(N, H, c, tf32, mma)
    smem = smem_bytes(N, H, c, tf32, m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ggru: no launch plan for S={S}, N={N}, H={H}, "
                         f"C={c}, mma={m}")
    return LaunchPlan(c, k_slices(H // c // 2, H, THREADS), THREADS, smem,
                      m)


@functools.lru_cache(maxsize=None)
def cached_plan(S: int, N: int, H: int, tf32: bool,
                sms: int) -> Union[LaunchPlan, str]:
    r""":func:`launch_plan`'s plan for a layer call on a card of ``sms``
    SMs, or its refusal message, computed once per key. The launch
    (:func:`scan`) and the nets' dispatch (``models/nets.py``
    ``plan_refusal``) both read it."""
    return plan_or_refusal(launch_plan, S, N, H, sms=sms, tf32=tf32)


def _hoist(params2: C.GGRUCellParams, x: torch.Tensor,
           fmt: str = "fp32") -> torch.Tensor:
    r"""zi = x·W_in + b_in for both directions, forward frame order:
    [2, S, T, N, 3H]."""
    S, T, N, F = x.shape
    zi = TP.matmul(x.reshape(1, S * T * N, F), f32(params2.w_in), fmt=fmt)
    zi = zi + f32(params2.b_in)[:, None, :]
    return zi.reshape(2, S, T, N, -1)


def bi_ggru_reference(params2: C.GGRUCellParams, x: torch.Tensor, h2,
                      n_valid=None, fmt: str = "fp32"):
    r"""The plain PyTorch version of :func:`bi_ggru` — the same function on
    any device: :func:`scan_inputs`, then :func:`scan_reference` (while
    ``torch.export`` traces, as the one node of the op
    ``a3gc_tpu_torch::ggru_scan_plain``). The tests use it; on the card it
    is what the kernel is held to."""
    args = scan_inputs(params2, x, h2, n_valid, fmt)
    if torch.compiler.is_compiling():
        from a3gc_tpu_torch.ops.library import ggru_scan_plain
        y, h = ggru_scan_plain(*args, fmt == "tf32")
    else:
        y, h = scan_reference(*args, tf32=fmt == "tf32")
    return like(y, x), like(h, h2)


def scan_reference(zi: torch.Tensor, gcn_kernel: torch.Tensor,
                   adj: torch.Tensor, w_hid: torch.Tensor, h0: torch.Tensor,
                   n_valid: torch.Tensor, tf32: bool = False):
    r"""The plain PyTorch version of :func:`scan`, on the same hoisted
    inputs and any device: the cell's hoisted step (the JAX cell's op
    order, its products' operands rounded to TF32 when ``tf32``) in the
    masked bidirectional scan, the state as a 1-tuple. The CPU
    implementation of the registered op
    (:mod:`a3gc_tpu_torch.ops.library`)."""
    T = zi.shape[2]
    zt = zi.transpose(1, 2)                                   # [2,T,S,N,3H]
    seq_stack = torch.stack((zt[0], zt[1].flip(0)))
    frame_mask = torch.arange(T, device=zi.device)[None] < n_valid[:, None]
    cell = SimpleNamespace(gcn_kernel=gcn_kernel, adj=adj, w_hid=w_hid)
    step = functools.partial(C.ggru_step_hoisted,
                             fmt="tf32" if tf32 else "fp32")
    hs, (h,) = L.bi_rnn_precomputed(step, cell, seq_stack, (h0,),
                                    frame_mask=frame_mask)
    y = torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1)
    return y, h


def _library():
    return kernel_library("ggru", 8, 10, 9, 2)


def max_active(plan: LaunchPlan, S: int, N: int, H: int,
               tf32: bool = False) -> int:
    r"""Clusters of ``plan`` the current card holds at once
    (``cudaOccupancyMaxActiveClusters``), for the fp32 or the TF32
    instantiation. Raises on a plan the kernel refuses."""
    return max_active_query("ggru", _library(), S, N, H, *plan, int(tf32))


def func_attributes(tf32: bool, mma: int = 0) -> dict:
    r"""Registers a thread and local-memory bytes (spills) of the
    instantiation a launch of (tf32, mma) runs (``cudaFuncGetAttributes``):
    {"regs": …, "local_bytes": …}."""
    return attributes_query("ggru", _library(), int(tf32), int(mma))


def scan(zi: torch.Tensor, gcn_kernel: torch.Tensor, adj: torch.Tensor,
         w_hid: torch.Tensor, h0: torch.Tensor, n_valid: torch.Tensor,
         plan: Optional[LaunchPlan] = None, tf32: bool = False):
    r"""Launch the kernel on hoisted inputs. zi [2, S, T, N, 3H] (both
    directions in forward frame order), gcn_kernel [2, H, H], adj [2, N, N],
    w_hid [2, H, 3H], h0 [2, S, N, H], n_valid [S] int32 — all contiguous
    fp32 on one card. ``plan`` defaults to :func:`cached_plan`'s
    (``ValueError`` where it refuses); ``tf32`` launches the TF32
    instantiation. Returns (y [S, T, N, 2H], h [2, S, N, H])."""
    _, S, T, N, G3 = zi.shape
    H = G3 // 3
    dev = zi.device
    check_f32("ggru", dev, [(zi, (2, S, T, N, 3 * H)),
                            (gcn_kernel, (2, H, H)), (adj, (2, N, N)),
                            (w_hid, (2, H, 3 * H)), (h0, (2, S, N, H))])
    check_n_valid("ggru", dev, n_valid, S)
    check_aligned("ggru", zi, gcn_kernel, w_hid)
    if plan is None:
        plan = planned(cached_plan(S, N, H, tf32,
                                   sm_count(device_index(dev))))
    lib = _library()
    y = torch.empty((S, T, N, 2 * H), dtype=torch.float32, device=dev)
    h_out = torch.empty((2, S, N, H), dtype=torch.float32, device=dev)
    launch("ggru", lib, dev, zi.data_ptr(), gcn_kernel.data_ptr(),
           adj.data_ptr(), w_hid.data_ptr(), h0.data_ptr(),
           n_valid.data_ptr(), y.data_ptr(), h_out.data_ptr(), S, T, N, H,
           *plan, int(tf32))
    bi_ggru.launches += 1
    bi_ggru.tf32_launches += int(tf32)
    by_c = bi_ggru.launches_by_cluster
    by_c[plan.C] = by_c.get(plan.C, 0) + 1
    return y, h_out


def bi_ggru(params2: C.GGRUCellParams, x: torch.Tensor, h2, n_valid=None,
            fmt: str = "fp32"):
    r"""Bidirectional G-GRU layer: x [S, T, N, F], h2 [2, S, N, H],
    ``n_valid`` None | int | [S] → (y [S, T, N, 2H], h [2, S, N, H]), the
    products' operands in format ``fmt``.
    Hoists the input projection (:func:`scan_inputs`) and calls the
    registered op ``a3gc_tpu_torch::ggru_scan``
    (:mod:`a3gc_tpu_torch.ops.library`): on CUDA tensors it launches the
    kernel (one launch, both directions) or raises, on CPU tensors it
    computes :func:`scan_reference`."""
    from a3gc_tpu_torch.ops.library import ggru_scan
    y, h = ggru_scan(*scan_inputs(params2, x, h2, n_valid, fmt),
                     fmt == "tf32")
    return like(y, x), like(h, h2)


def scan_inputs(params2: C.GGRUCellParams, x: torch.Tensor, h2,
                n_valid=None, fmt: str = "fp32") -> tuple:
    r"""The arguments of :func:`scan` for one layer call: the hoisted input
    projection for both directions (one ``torch.matmul`` on operands in
    format ``fmt``, forward frame order) and the parameters and state in
    the kernel's layouts."""
    x = f32(x)
    S, T = x.shape[0], x.shape[1]
    return (_hoist(params2, x, fmt), f32(params2.gcn_kernel).contiguous(),
            f32(params2.adj).contiguous(), f32(params2.w_hid).contiguous(),
            f32(h2).contiguous(), n_valid_tensor(n_valid, S, T, x.device))


bi_ggru.launches = 0    # kernel launches since the last reset to 0
bi_ggru.tf32_launches = 0   # of them, of the TF32 instantiation
bi_ggru.launches_by_cluster = {}    # of them, by the plan's C
bi_ggru.plain_dispatches = 0    # layer calls on a card that backend="auto"
                                # gave the plain version (no plan)
