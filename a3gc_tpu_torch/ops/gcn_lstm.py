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
stores completing on the receiver's mbarriers).
:func:`launch_plan` chooses C. The launch is the CUDA implementation of
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

The kernel is forward-only: a CUDA call with grad enabled raises. The
``torch.autograd.Function`` whose backward reruns the plain path comes with
the training slice (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops._common import (MAX_CLUSTER, SMEM_HEADER, SMEM_LIMIT,
                                        THREADS, check_aligned, check_f32,
                                        check_n_valid, f32 as _f32, k_slices,
                                        kernel_library, launch,
                                        n_valid_tensor as _n_valid)

__all__ = ["LaunchPlan", "bi_gcn_lstm", "bi_gcn_lstm_reference",
           "launch_plan", "max_active", "scan", "scan_inputs",
           "scan_reference", "smem_bytes"]

NODES = 16           # node rows padded to 16
MAX_KW = 32          # attention weights a thread keeps in registers: of
MAX_KCA = 32         # W 1 column × H / KSQ rows, of Wh 2 columns × H / KSA


class LaunchPlan(NamedTuple):
    r"""How ``csrc/gcn_lstm.cu`` runs one layer call: a cluster of C CTAs
    per (stream, direction)."""
    C: int             # CTAs per cluster; CTA c owns hidden units c·H/C …
    KS: int            # k-slices per group of 4 gate columns of h·W_h
    KSA: int           # k-slices per column pair of hy·Wh (attention)
    KSQ: int           # k-slices per column of q·Wq and (Σ hy)·W
    threads: int
    smem: int          # dynamic shared memory per CTA, bytes

    @property
    def cluster(self) -> int:
        return self.C


def smem_bytes(N: int, H: int, C: int, KSQ: int, attention: bool) -> int:
    r"""Dynamic shared memory of one CTA (``gcn_lstm_smem_bytes`` in C):
    the W_h slice [H, 4H/C] (rows padded by 4 floats), the full h
    double-buffered [2, 16, H], the mixed gates [16, 4H/C], u [N, 4H/C],
    c [N, H/C], bias, adjacency; with attention Wq's columns [H, H/C]
    (rows padded by max(4, 32/KSQ) floats), s, q, Σ_nodes hy and the
    partial sums."""
    Hc = H // C
    M = 4 * Hc
    floats = (H * (M + 4) + 2 * NODES * H + NODES * M + N * M + N * Hc + M
              + 4 * N * N)
    if attention:
        floats += (H * (Hc + max(4, 32 // KSQ)) + NODES * Hc + 2 * H
                   + 2 * Hc + C * NODES + 2 * NODES)
    return SMEM_HEADER + 4 * floats


def launch_plan(N: int, H: int, attention: bool,
                C: Optional[int] = None) -> LaunchPlan:
    r"""The cluster for a layer of N ≤ 16 nodes at hidden width H: the
    smallest C ≤ 4 whose CTAs own at most 64 gate columns each, else the
    smallest C ≤ 8 with at most 128 (wider only where no C gives that),
    whose slices fit in shared memory and, with attention, whose W
    column and Wh column pair fit in 32 + 32 registers a thread. The
    64-column step is measured (``scripts/torch_kernel_ab.py``: C = 4
    beats 2 at H = 64 on an H100); clusters of 8 stop at 4 because 16
    clusters of 8, one (stream, direction) each at S = 8, do not all fit
    on the card at once (an H100 holds 15). ``C``
    forces the split, for measuring C against 2C. Raises if nothing
    fits."""
    if N <= 0 or N > NODES or H <= 0 or H % 4:
        raise ValueError(f"gcn_lstm: needs N <= {NODES} and H % 4 == 0, got "
                         f"N={N}, H={H}")
    passes = (((THREADS, MAX_CLUSTER),) if C is not None
              else ((64, 4), (128, MAX_CLUSTER), (THREADS, MAX_CLUSTER)))
    for widest, most in passes:
        for c in ([C] if C is not None else range(1, most + 1)):
            Hc = H // c
            if c > MAX_CLUSTER or H % c or Hc % 4 or 4 * Hc > widest:
                continue
            ksa, ksq = k_slices(Hc // 2, H), k_slices(Hc, H)
            smem = smem_bytes(N, H, c, ksq, attention)
            if smem > SMEM_LIMIT or (attention and (
                    2 * (H // ksa) > MAX_KCA or H // ksq > MAX_KW)):
                continue
            return LaunchPlan(c, k_slices(Hc, H), ksa, ksq, THREADS, smem)
    raise ValueError(f"gcn_lstm: no launch plan for N={N}, H={H}, "
                     f"attention={attention}"
                     + (f", C={C}" if C is not None else ""))


def bi_gcn_lstm_reference(params2: C.GCNLSTMCellParams, x: torch.Tensor,
                          state2, n_valid=None):
    r"""The plain PyTorch version of :func:`bi_gcn_lstm` — the same function
    on any device: :func:`scan_inputs`, then :func:`scan_reference`. The
    tests use it; on the card it is what the kernel is held to."""
    y, h, c = scan_reference(*scan_inputs(params2, x, state2, n_valid))
    return y, (h, c)


def scan_reference(u: torch.Tensor, wh: torch.Tensor, adj: torch.Tensor,
                   bias: torch.Tensor, attention: Optional[tuple],
                   h0: torch.Tensor, c0: torch.Tensor,
                   n_valid: torch.Tensor):
    r"""The plain PyTorch version of :func:`scan`, on the same hoisted
    inputs and any device: the cells' hoisted step in the masked
    bidirectional scan. The CPU implementation of the registered op
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

    def step(p, u_t, st):
        return C.gcn_lstm_step_hoisted(p, u_t, st, hidden_kernel=wh)

    hs, (h, c) = L.bi_rnn_precomputed(step, cell, seq_stack, (h0, c0),
                                      frame_mask=frame_mask)
    y = torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1)
    return torch.tanh(y), h, c


def _library():
    return kernel_library("gcn_lstm", 16, 11, 5)


def _plan_ints(plan: LaunchPlan):
    return (plan.C, plan.KS, plan.KSA, plan.KSQ, plan.threads, plan.smem)


def max_active(plan: LaunchPlan, S: int, N: int, H: int,
               attention: bool) -> int:
    r"""Clusters of ``plan`` the current card holds at once
    (``cudaOccupancyMaxActiveClusters``). Raises on a plan the kernel
    refuses."""
    lib = _library()
    fn = lib.gcn_lstm_max_active
    fn.argtypes = [ctypes.c_int] * 10
    fn.restype = ctypes.c_int
    n = fn(S, N, H, int(attention), *_plan_ints(plan))
    if n < 0:
        raise RuntimeError("gcn_lstm occupancy query failed: "
                           + lib.gcn_lstm_error_string(-n).decode())
    return n


def scan(u: torch.Tensor, wh: torch.Tensor, adj: torch.Tensor,
         bias: torch.Tensor, attention: Optional[tuple], h0: torch.Tensor,
         c0: torch.Tensor, n_valid: torch.Tensor,
         plan: Optional[LaunchPlan] = None):
    r"""Launch the kernel on hoisted inputs. u [2, S, T, N, 4H] (both
    directions in forward frame order), wh [2, H, 4H], adj [2, 4, N, N],
    bias [2, 4, H], attention None or (w, wq, wh, u [2, H], bs, bu), h0/c0
    [2, S, N, H], n_valid [S] int32 — all contiguous fp32 on one card.
    ``plan`` defaults to :func:`launch_plan`. Returns (y [S, T, N, 2H],
    h [2, S, N, H], c [2, S, N, H])."""
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
        plan = launch_plan(N, H, attention is not None)
    lib = _library()
    y = torch.empty((S, T, N, 2 * H), dtype=torch.float32, device=dev)
    h_out = torch.empty((2, S, N, H), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    att = [t.data_ptr() for t in attention] if attention else [None] * 6
    launch("gcn_lstm", lib, dev, u.data_ptr(), wh.data_ptr(),
           adj.data_ptr(), bias.data_ptr(), *att, h0.data_ptr(),
           c0.data_ptr(), n_valid.data_ptr(), y.data_ptr(), h_out.data_ptr(),
           c_out.data_ptr(), S, T, N, H, int(attention is not None),
           *_plan_ints(plan))
    bi_gcn_lstm.launches += 1
    return y, h_out, c_out


def bi_gcn_lstm(params2: C.GCNLSTMCellParams, x: torch.Tensor, state2,
                n_valid=None):
    r"""Bidirectional graph-LSTM layer: x [S, T, N, F], state2 (h, c) each
    [2, S, N, H], ``n_valid`` None | int | [S] → (y [S, T, N, 2H], (h, c)).
    Hoists the input projection (:func:`scan_inputs`) and calls the
    registered op ``a3gc_tpu_torch::gcn_lstm_scan``
    (:mod:`a3gc_tpu_torch.ops.library`), as a loaded ``torch.export``
    program does: on CUDA tensors it launches the kernel (one launch, both
    directions) or raises, on CPU tensors it computes
    :func:`scan_reference`."""
    if x.is_cuda and torch.is_grad_enabled():
        raise RuntimeError(
            "bi_gcn_lstm: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or torch.inference_mode() (gradients come with "
            "the training slice, ROADMAP Queue 1 item 11)")
    from a3gc_tpu_torch.ops.library import gcn_lstm_scan
    u, wh, adj, bias, att, h0, c0, nv = scan_inputs(params2, x, state2,
                                                    n_valid)
    y, h, c = gcn_lstm_scan(u, wh, adj, bias, *(att or (None,) * 6), h0, c0,
                            nv)
    return y, (h, c)


def scan_inputs(params2: C.GCNLSTMCellParams, x: torch.Tensor, state2,
                n_valid=None) -> tuple:
    r"""The arguments of :func:`scan` for one layer call: the hoisted input
    projection u = x·W_x for both directions (one ``torch.matmul``, forward
    frame order) and the parameters and state in the kernel's layouts."""
    x = _f32(x)
    S, T, N, F = x.shape
    H = params2.bias.shape[-1]
    kernel = _f32(params2.kernel)
    u = torch.matmul(x.reshape(1, S * T * N, F), kernel[:, :F])
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
