r"""Bidirectional G-GRU layer over a whole window in one kernel launch
(counterpart of ``a3gc_tpu/ops/pallas_gcn_lstm.py`` ``bi_ggru_pallas``).

:func:`bi_ggru` hoists the input projection ``zi = x·W_in + b_in`` out of
the scan with one ``torch.matmul`` (as the JAX package leaves it to XLA
outside its kernel) and launches ``csrc/ggru.cu``: grid (streams,
directions), both directions in one launch, the recurrent state in shared
memory for the whole window. On a CPU tensor it computes
:func:`bi_ggru_reference`, the plain PyTorch version of the same function;
on a CUDA tensor it launches the kernel or raises.

The function, for x [S, T, N, F], h2 [2, S, N, H] and per-stream
``n_valid`` [S]:

  * direction 0 walks frames 0 … T-1, direction 1 walks T-1 … 0;
  * frames < n_valid[s] update stream s's state, later frames carry it;
  * y [S, T, N, 2H] is the carried h after each frame, forward ‖ backward
    (no tanh on this cell) — on valid frames the cell output, on the
    others the carried h (the Pallas kernel's output there);
  * returns (y, h) with the final state h [2, S, N, H].

The kernel is forward-only: a CUDA call with grad enabled raises.
"""

from __future__ import annotations

import torch

from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops._common import (SMEM_LIMIT, check_f32, check_n_valid,
                                        f32, kernel_library, launch,
                                        n_valid_tensor)

__all__ = ["bi_ggru", "bi_ggru_reference", "scan", "scan_inputs"]


def _hoist(params2: C.GGRUCellParams, x: torch.Tensor) -> torch.Tensor:
    r"""zi = x·W_in + b_in for both directions, forward frame order:
    [2, S, T, N, 3H]."""
    S, T, N, F = x.shape
    zi = torch.matmul(x.reshape(1, S * T * N, F), f32(params2.w_in))
    zi = zi + f32(params2.b_in)[:, None, :]
    return zi.reshape(2, S, T, N, -1)


def bi_ggru_reference(params2: C.GGRUCellParams, x: torch.Tensor, h2,
                      n_valid=None):
    r"""The plain PyTorch version of :func:`bi_ggru` — the same function on
    any device, built from the cell's hoisted step and the masked
    bidirectional scan (the state as a 1-tuple). The CPU path and the tests
    use it; on the card it is what the kernel is held to."""
    x = f32(x)
    S, T = x.shape[0], x.shape[1]
    zi = _hoist(params2, x).transpose(1, 2)                   # [2,T,S,N,3H]
    seq_stack = torch.stack((zi[0], zi[1].flip(0)))
    nv = n_valid_tensor(n_valid, S, T, x.device)
    frame_mask = torch.arange(T, device=x.device)[None] < nv[:, None]
    hs, (h,) = L.bi_rnn_precomputed(C.ggru_step_hoisted, params2, seq_stack,
                                    (f32(h2),), frame_mask=frame_mask)
    y = torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1)
    return y, h


def scan(zi: torch.Tensor, gcn_kernel: torch.Tensor, adj: torch.Tensor,
         w_hid: torch.Tensor, h0: torch.Tensor, n_valid: torch.Tensor):
    r"""Launch the kernel on hoisted inputs. zi [2, S, T, N, 3H] (both
    directions in forward frame order), gcn_kernel [2, H, H], adj [2, N, N],
    w_hid [2, H, 3H], h0 [2, S, N, H], n_valid [S] int32 — all contiguous
    fp32 on one card. Returns (y [S, T, N, 2H], h [2, S, N, H])."""
    _, S, T, N, G3 = zi.shape
    H = G3 // 3
    dev = zi.device
    check_f32("ggru", dev, [(zi, (2, S, T, N, 3 * H)),
                            (gcn_kernel, (2, H, H)), (adj, (2, N, N)),
                            (w_hid, (2, H, 3 * H)), (h0, (2, S, N, H))])
    check_n_valid("ggru", dev, n_valid, S)
    if H % 4 or N > 16:
        raise ValueError(f"ggru: needs H % 4 == 0 and N <= 16, got H={H}, "
                         f"N={N}")
    lib = kernel_library("ggru", 8, 4, 1)
    if lib.ggru_smem_bytes(H) > SMEM_LIMIT:
        raise ValueError(f"ggru: H={H} needs more shared memory than a "
                         "block has")
    y = torch.empty((S, T, N, 2 * H), dtype=torch.float32, device=dev)
    h_out = torch.empty((2, S, N, H), dtype=torch.float32, device=dev)
    launch("ggru", lib, dev, zi.data_ptr(), gcn_kernel.data_ptr(),
           adj.data_ptr(), w_hid.data_ptr(), h0.data_ptr(),
           n_valid.data_ptr(), y.data_ptr(), h_out.data_ptr(), S, T, N, H)
    bi_ggru.launches += 1
    return y, h_out


def bi_ggru(params2: C.GGRUCellParams, x: torch.Tensor, h2, n_valid=None):
    r"""Bidirectional G-GRU layer: x [S, T, N, F], h2 [2, S, N, H],
    ``n_valid`` None | int | [S] → (y [S, T, N, 2H], h [2, S, N, H]). CPU
    tensors take :func:`bi_ggru_reference`; CUDA tensors launch the kernel
    (one launch, both directions) or raise."""
    if not x.is_cuda:
        return bi_ggru_reference(params2, x, h2, n_valid)
    if torch.is_grad_enabled():
        raise RuntimeError(
            "bi_ggru: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or torch.inference_mode() (gradients come with "
            "the training slice, ROADMAP Queue 1 item 11)")
    return scan(*scan_inputs(params2, x, h2, n_valid))


def scan_inputs(params2: C.GGRUCellParams, x: torch.Tensor, h2,
                n_valid=None) -> tuple:
    r"""The arguments of :func:`scan` for one layer call: the hoisted input
    projection for both directions (one ``torch.matmul``, forward frame
    order) and the parameters and state in the kernel's layouts."""
    x = f32(x)
    S, T = x.shape[0], x.shape[1]
    return (_hoist(params2, x), f32(params2.gcn_kernel).contiguous(),
            f32(params2.adj).contiguous(), f32(params2.w_hid).contiguous(),
            f32(h2).contiguous(), n_valid_tensor(n_valid, S, T, x.device))


bi_ggru.launches = 0    # kernel launches since the last reset to 0
