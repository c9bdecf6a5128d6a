r"""Bidirectional graph-LSTM layer over a whole window in one kernel launch
(counterpart of ``a3gc_tpu/ops/pallas_gcn_lstm.py`` ``bi_gcn_lstm_pallas``
and ``bi_gcn_lstm_pallas_dirfused``).

:func:`bi_gcn_lstm` hoists the input projection ``u = x·W_x`` out of the
scan with one ``torch.matmul`` (as the JAX package leaves it to XLA outside
its kernel) and launches ``csrc/gcn_lstm.cu``, both directions in one
launch: a thread-block cluster of C CTAs per (stream, direction) that split
the hidden units, keep their slice of the recurrent weights in shared
memory (and registers) for the whole window, and exchange h and the
attention sums through distributed shared memory each frame (``st.async``
stores completing on the receiver's mbarriers; with attention two
exchanges a frame: the hy slice with the CTA's partial q, then the partial
s·u).
:func:`launch_plan` chooses C; :func:`cached_plan` keeps its answer per
key. The launch is the CUDA implementation of
the registered op ``a3gc_tpu_torch::gcn_lstm_scan``
(:mod:`a3gc_tpu_torch.ops.library`), whose CPU implementation is
:func:`scan_reference`, the plain PyTorch version of the same function: on
a CPU tensor :func:`bi_gcn_lstm` computes it, on a CUDA tensor it launches
the kernel or raises.

The function, for x [S, T, N, F], state2 (h, c) each [2, S, N, H] and
per-stream ``n_valid`` [S]:

  * direction 0 walks frames 0 … T-1, direction 1 walks T-1 … 0;
  * frames < n_valid[s] update stream s's state, later frames carry it;
  * y [S, T, N, 2H] is tanh of the carried h after each frame, forward ‖
    backward — on valid frames the cell output, on the others tanh of the
    carried h (the Pallas kernels' output there);
  * returns (y, (h, c)) with the final states [2, S, N, H].

The kernel has no backward: the op's autograd formula reruns
:func:`scan_reference` on the saved inputs. The kernel is fp32 inside;
the outputs come back in the dtypes of x and of the state. ``fmt`` (the
net's operand format, :func:`a3gc_tpu_torch.ops._common.operand_format`)
at "tf32" rounds every product's operands to TF32 where the JAX cell's
products take them: the hoisted x·W_x here, and inside the scan h·W_h,
the adjacency mix and the attention products (the kernel's TF32
instantiation, the ``tf32`` flag of :func:`scan`; h·W_h, the mix and hy·Wh
on the tensor cores, ``mma.sync`` m16n8k8 TF32, where the plan's ``mma``
says so: every serving width).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple, Optional, Union

import torch

from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops._common import (MAX_CLUSTER, SMEM_HEADER, SMEM_LIMIT,
                                        THREADS, attributes_query,
                                        check_aligned, check_f32,
                                        check_n_valid, f32 as _f32, k_slices,
                                        kernel_library, launch, like,
                                        max_active_query, mma_row_stride,
                                        n_valid_tensor as _n_valid,
                                        plan_or_refusal, planned)
from a3gc_tpu_torch.parallel import tensor as TP

__all__ = ["LaunchPlan", "bi_gcn_lstm", "bi_gcn_lstm_reference",
           "cached_plan", "func_attributes", "launch_plan", "max_active",
           "mma_ok", "scan", "scan_inputs", "scan_reference", "smem_bytes"]

NODES = 16           # node rows padded to 16
MAX_KW = 32          # attention weights a thread keeps in registers: of
MAX_KCA = 32         # W 1 column × H / C rows, of Wh 2 columns × H / KSA
MAX_CLUSTER_WIDE = 16   # a non-portable cluster (kMaxClusterWide in C):
                        # the tensor-core plans only


class LaunchPlan(NamedTuple):
    r"""How ``csrc/gcn_lstm.cu`` runs one layer call: a cluster of C CTAs
    per (stream, direction)."""
    C: int             # CTAs per cluster; CTA c owns hidden units c·H/C …
    KS: int            # k-slices per group of 4 gate columns of h·W_h
    KSA: int           # k-slices per column pair of hy·Wh (attention)
    KSQ: int           # k-slices per column of q·Wq
    threads: int
    smem: int          # dynamic shared memory per CTA, bytes
    mma: int = 0       # 1: the TF32 instantiation's products on the tensor
                       # cores (mma.sync m16n8k8), 0: FMA loops

    @property
    def cluster(self) -> int:
        return self.C


def att_split(H: int, Hc: int) -> int:
    r"""k parts of the tensor-core path's hy·Wh (``att_split`` in C): each
    of its Hc / 8 n-tiles over at most 4 warps, so that a warp holds at most
    8 k-blocks of Wh in registers."""
    ks = min(4, 8 // (Hc // 8))
    while ks > 1 and (H // 16) % ks:
        ks //= 2
    return ks


def mma_ok(H: int, Hc: int, attention: bool) -> bool:
    r"""Whether the TF32 instantiation can take the tensor-core path at
    this split (``mma_ok`` in C): k in 16-deep blocks and a swizzled W_h^T
    (H % 32 == 0), 8 or 16 n-tiles of gate columns over the 8 warps (4·Hc
    = 64 or 128), a warp's tiles in one gate, at most 8 k-blocks of Wh's
    fragments a warp."""
    M = 4 * Hc
    if H % 32 or M not in (64, 128) or Hc % (8 * (M // 64)):
        return False
    return not attention or H // 16 // att_split(H, Hc) <= MAX_KCA // 4


def smem_bytes(N: int, H: int, C: int, attention: bool,
               mma: bool = False) -> int:
    r"""Dynamic shared memory of one CTA (C: ``smem_floats``):
    the W_h slice [H, 4H/C] (rows padded by 4 floats), the full h
    double-buffered [2, 16, H], the mixed gates [16, 4H/C], u [N, 4H/C],
    c [N, H/C], bias, adjacency; with attention Wq's columns [H, H/C]
    (unpadded, rows rotated), the ranks' partial q [C, THREADS] (this
    CTA's slot then holds q) and the small vectors (hy·Wh and s reuse the
    mixed gates' buffer). The
    tensor-core path (``mma``) holds the W_h slice transposed and swizzled,
    unpadded, pads h's rows to :func:`mma_row_stride` and the mixed gates'
    rows by 8 floats."""
    Hc = H // C
    M = 4 * Hc
    HS, MP = (mma_row_stride(H), M + 8) if mma else (H, M)
    floats = (H * M + (0 if mma else 4 * H) + 2 * NODES * HS + NODES * MP
              + N * M + N * Hc + M + 4 * N * N)
    if attention:
        floats += H * Hc + C * THREADS + 2 * Hc + C * NODES + 2 * NODES
    return SMEM_HEADER + 4 * floats


def launch_plan(N: int, H: int, attention: bool, C: Optional[int] = None,
                tf32: bool = False, mma: Optional[bool] = None,
                S: Optional[int] = None) -> LaunchPlan:
    r"""The cluster for a layer of N ≤ 16 nodes at hidden width H: the
    smallest C ≤ 4 whose CTAs own at most 64 gate columns each, else the
    smallest C ≤ 8 with at most 128 (wider only where no C gives that),
    whose slices fit in shared memory and, with attention, whose W
    column (over the H / C own rows) and Wh column pair fit in 32 + 32
    registers a thread. The
    64-column step is measured (``scripts/torch_kernel_ab.py``: C = 4
    beats 2 at H = 64 on an H100); clusters of 8 stop at 4 because 16
    clusters of 8, one (stream, direction) each at S = 8, do not all fit
    on the card at once (an H100 holds 15). ``C``
    forces the split, for measuring C against 2C. Raises if nothing
    fits.

    The TF32 instantiation (``tf32``) takes the same split, on the tensor
    cores where :func:`mma_ok` and its shared memory allow (``mma`` forces
    the choice: False keeps the FMA loops, for measuring one against the
    other). At one stream (``S`` = 1: two clusters, most of the card's SMs
    idle) a tensor-core plan spreads each (stream, direction) over twice
    the CTAs where the doubled split keeps a tensor-core plan: C = 16 at H
    = 256 (a non-portable cluster, :data:`MAX_CLUSTER_WIDE`), 8 at 128; H
    = 64 keeps 4 (its doubled split has 32 gate columns a CTA, no
    tensor-core plan). ``S`` None or ≥ 2 keeps the split above."""
    if N <= 0 or N > NODES or H <= 0 or H % 4:
        raise ValueError(f"gcn_lstm: needs N <= {NODES} and H % 4 == 0, got "
                         f"N={N}, H={H}")
    if S is not None and S <= 0:
        raise ValueError(f"gcn_lstm: needs S >= 1, got S={S}")
    plan = _split_plan(N, H, attention, C, tf32, mma)
    if C is None and S == 1 and plan.mma:
        try:
            return _split_plan(N, H, attention, 2 * plan.C, tf32, True)
        except ValueError:          # no tensor-core plan at the wider split
            pass
    return plan


def _split_plan(N: int, H: int, attention: bool, C: Optional[int],
                tf32: bool, mma: Optional[bool]) -> LaunchPlan:
    r""":func:`launch_plan` without the one-stream widening. A cluster
    past :data:`MAX_CLUSTER` only on the tensor cores."""
    passes = (((THREADS, MAX_CLUSTER_WIDE),) if C is not None
              else ((64, 4), (128, MAX_CLUSTER), (THREADS, MAX_CLUSTER)))
    for widest, most in passes:
        for c in ([C] if C is not None else range(1, most + 1)):
            if c <= 0 or c > MAX_CLUSTER_WIDE or H % c:
                continue
            Hc = H // c
            if Hc % 4 or 4 * Hc > widest:
                continue
            ksa, ksq = k_slices(Hc // 2, H), k_slices(Hc, H)
            smem = smem_bytes(N, H, c, attention)
            if smem > SMEM_LIMIT or (attention and (
                    2 * (H // ksa) > MAX_KCA or Hc > MAX_KW or H > THREADS)):
                continue
            smem_mma = smem_bytes(N, H, c, attention, True)
            fits = (tf32 and mma_ok(H, Hc, attention)
                    and smem_mma <= SMEM_LIMIT)
            if mma and not fits:
                raise ValueError(f"gcn_lstm: no launch plan on the tensor "
                                 f"cores for N={N}, H={H}, C={c}, "
                                 f"tf32={tf32}")
            use = fits if mma is None else bool(mma)
            if c > MAX_CLUSTER and not use:
                continue            # a non-portable cluster: mma only
            if use:
                smem = smem_mma
            return LaunchPlan(c, k_slices(Hc, H), ksa, ksq, THREADS, smem,
                              int(use))
    raise ValueError(f"gcn_lstm: no launch plan for N={N}, H={H}, "
                     f"attention={attention}"
                     + (f", C={C}" if C is not None else ""))


@functools.lru_cache(maxsize=None)
def cached_plan(N: int, H: int, attention: bool, tf32: bool,
                S: int) -> Union[LaunchPlan, str]:
    r""":func:`launch_plan`'s plan for a layer call of S streams, or its
    refusal message, computed once per key. The launch (:func:`scan`) and
    the nets' dispatch (``models/nets.py`` ``plan_refusal``) both read
    it."""
    return plan_or_refusal(launch_plan, N, H, attention, tf32=tf32, S=S)


def bi_gcn_lstm_reference(params2: C.GCNLSTMCellParams, x: torch.Tensor,
                          state2, n_valid=None, fmt: str = "fp32"):
    r"""The plain PyTorch version of :func:`bi_gcn_lstm` — the same function
    on any device: :func:`scan_inputs`, then :func:`scan_reference` (while
    ``torch.export`` traces, as the one node of the op
    ``a3gc_tpu_torch::gcn_lstm_scan_plain``). The tests use it; on the card
    it is what the kernel is held to."""
    u, wh, adj, bias, att, h0, c0, nv = scan_inputs(params2, x, state2,
                                                    n_valid, fmt)
    if torch.compiler.is_compiling():
        from a3gc_tpu_torch.ops.library import gcn_lstm_scan_plain
        y, h, c = gcn_lstm_scan_plain(u, wh, adj, bias,
                                      *(att or (None,) * 6), h0, c0, nv,
                                      fmt == "tf32")
    else:
        y, h, c = scan_reference(u, wh, adj, bias, att, h0, c0, nv,
                                 tf32=fmt == "tf32")
    return like(y, x), like((h, c), state2[0])


def scan_reference(u: torch.Tensor, wh: torch.Tensor, adj: torch.Tensor,
                   bias: torch.Tensor, attention: Optional[tuple],
                   h0: torch.Tensor, c0: torch.Tensor,
                   n_valid: torch.Tensor, tf32: bool = False):
    r"""The plain PyTorch version of :func:`scan`, on the same hoisted
    inputs and any device: the cells' hoisted step in the masked
    bidirectional scan, its products' operands rounded to TF32 when
    ``tf32``. The CPU implementation of the registered op
    (:mod:`a3gc_tpu_torch.ops.library`)."""
    T = u.shape[2]
    H = bias.shape[-1]
    ut = u.transpose(1, 2)                                     # [2,T,S,N,4H]
    seq_stack = torch.stack((ut[0], ut[1].flip(0)))
    frame_mask = (torch.arange(T, device=u.device)[None]
                  < n_valid[:, None])
    att = None
    if attention is not None:
        w, wq, wh_att, u_att, bs, bu = attention
        att = SimpleNamespace(w=w, wq=wq, wh=wh_att, u=u_att.reshape(2, H, 1),
                              bs=bs, bu=bu)
    cell = SimpleNamespace(adj=adj, bias=bias, attention=att)

    fmt = "tf32" if tf32 else "fp32"

    def step(p, u_t, st):
        return C.gcn_lstm_step_hoisted(p, u_t, st, hidden_kernel=wh, fmt=fmt)

    hs, (h, c) = L.bi_rnn_precomputed(step, cell, seq_stack, (h0, c0),
                                      frame_mask=frame_mask)
    y = torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1)
    return torch.tanh(y), h, c


def _library():
    return kernel_library("gcn_lstm", 16, 13, 12, 3)


def _plan_ints(plan: LaunchPlan):
    return (plan.C, plan.KS, plan.KSA, plan.KSQ, plan.threads, plan.smem,
            plan.mma)


def max_active(plan: LaunchPlan, S: int, N: int, H: int,
               attention: bool, tf32: bool = False) -> int:
    r"""Clusters of ``plan`` the current card holds at once
    (``cudaOccupancyMaxActiveClusters``), for the fp32 or the TF32
    instantiation. Raises on a plan the kernel refuses."""
    return max_active_query("gcn_lstm", _library(), S, N, H, int(attention),
                            *_plan_ints(plan), int(tf32))


def func_attributes(attention: bool, tf32: bool,
                    mma: bool = False) -> dict:
    r"""Registers a thread and local-memory bytes (spills) of the
    instantiation a launch of (attention, tf32, mma) runs
    (``cudaFuncGetAttributes``): {"regs": …, "local_bytes": …}."""
    return attributes_query("gcn_lstm", _library(), int(attention),
                            int(tf32), int(mma))


def scan(u: torch.Tensor, wh: torch.Tensor, adj: torch.Tensor,
         bias: torch.Tensor, attention: Optional[tuple], h0: torch.Tensor,
         c0: torch.Tensor, n_valid: torch.Tensor,
         plan: Optional[LaunchPlan] = None, tf32: bool = False):
    r"""Launch the kernel on hoisted inputs. u [2, S, T, N, 4H] (both
    directions in forward frame order), wh [2, H, 4H], adj [2, 4, N, N],
    bias [2, 4, H], attention None or (w, wq, wh, u [2, H], bs, bu), h0/c0
    [2, S, N, H], n_valid [S] int32 — all contiguous fp32 on one card.
    ``plan`` defaults to :func:`cached_plan`'s (``ValueError`` where it
    refuses); ``tf32`` launches the TF32 instantiation (the products'
    operands rounded to TF32). Returns (y [S, T, N, 2H], h [2, S, N, H],
    c [2, S, N, H])."""
    _, S, T, N, G = u.shape
    H = G // 4
    dev = u.device
    shapes = [(u, (2, S, T, N, 4 * H)), (wh, (2, H, 4 * H)),
              (adj, (2, 4, N, N)), (bias, (2, 4, H)), (h0, (2, S, N, H)),
              (c0, (2, S, N, H))]
    if attention is not None:
        shapes += list(zip(attention, [(2, H, H)] * 3 + [(2, H)] * 2
                           + [(2, N)]))
    check_f32("gcn_lstm", dev, shapes)
    check_n_valid("gcn_lstm", dev, n_valid, S)
    check_aligned("gcn_lstm", u, wh, *(attention[1:2] if attention else ()))
    if plan is None:
        plan = planned(cached_plan(N, H, attention is not None, tf32, S))
    lib = _library()
    y = torch.empty((S, T, N, 2 * H), dtype=torch.float32, device=dev)
    h_out = torch.empty((2, S, N, H), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    att = [t.data_ptr() for t in attention] if attention else [None] * 6
    launch("gcn_lstm", lib, dev, u.data_ptr(), wh.data_ptr(),
           adj.data_ptr(), bias.data_ptr(), *att, h0.data_ptr(),
           c0.data_ptr(), n_valid.data_ptr(), y.data_ptr(), h_out.data_ptr(),
           c_out.data_ptr(), S, T, N, H, int(attention is not None),
           *_plan_ints(plan), int(tf32))
    bi_gcn_lstm.launches += 1
    bi_gcn_lstm.tf32_launches += int(tf32)
    by_c = bi_gcn_lstm.launches_by_cluster
    by_c[plan.C] = by_c.get(plan.C, 0) + 1
    return y, h_out, c_out


def bi_gcn_lstm(params2: C.GCNLSTMCellParams, x: torch.Tensor, state2,
                n_valid=None, fmt: str = "fp32"):
    r"""Bidirectional graph-LSTM layer: x [S, T, N, F], state2 (h, c) each
    [2, S, N, H], ``n_valid`` None | int | [S] → (y [S, T, N, 2H], (h, c)),
    the products' operands in format ``fmt``.
    Hoists the input projection (:func:`scan_inputs`) and calls the
    registered op ``a3gc_tpu_torch::gcn_lstm_scan``
    (:mod:`a3gc_tpu_torch.ops.library`), as a loaded ``torch.export``
    program does: on CUDA tensors it launches the kernel (one launch, both
    directions) or raises, on CPU tensors it computes
    :func:`scan_reference`."""
    from a3gc_tpu_torch.ops.library import gcn_lstm_scan
    u, wh, adj, bias, att, h0, c0, nv = scan_inputs(params2, x, state2,
                                                    n_valid, fmt)
    y, h, c = gcn_lstm_scan(u, wh, adj, bias, *(att or (None,) * 6), h0, c0,
                            nv, fmt == "tf32")
    return like(y, x), like((h, c), state2[0])


def scan_inputs(params2: C.GCNLSTMCellParams, x: torch.Tensor, state2,
                n_valid=None, fmt: str = "fp32") -> tuple:
    r"""The arguments of :func:`scan` for one layer call: the hoisted input
    projection u = x·W_x for both directions (one ``torch.matmul`` on
    operands in format ``fmt``, forward frame order) and the parameters and
    state in the kernel's layouts."""
    x = _f32(x)
    S, T, N, F = x.shape
    H = params2.bias.shape[-1]
    kernel = _f32(params2.kernel)
    u = TP.matmul(x.reshape(1, S * T * N, F), kernel[:, :F], fmt=fmt)
    att = params2.attention
    attention = None
    if att is not None:
        attention = tuple(_f32(t).contiguous() for t in (
            att.w, att.wq, att.wh, att.u.reshape(2, H), att.bs, att.bu))
    h0, c0 = (_f32(s).contiguous() for s in state2)
    return (u.reshape(2, S, T, N, 4 * H), kernel[:, F:].contiguous(),
            _f32(params2.adj).contiguous(), _f32(params2.bias).contiguous(),
            attention, h0, c0, _n_valid(n_valid, S, T, x.device))


bi_gcn_lstm.launches = 0    # kernel launches since the last reset to 0
bi_gcn_lstm.tf32_launches = 0   # of them, of the TF32 instantiation
bi_gcn_lstm.launches_by_cluster = {}    # of them, by the plan's C
bi_gcn_lstm.plain_dispatches = 0    # layer calls on a card that
                                    # backend="auto" gave the plain version
                                    # (no plan for their shape)
