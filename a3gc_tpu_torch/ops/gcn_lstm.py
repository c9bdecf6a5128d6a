r"""Bidirectional graph-LSTM layer over a whole window in one kernel launch
(counterpart of ``a3gc_tpu/ops/pallas_gcn_lstm.py`` ``bi_gcn_lstm_pallas``
and ``bi_gcn_lstm_pallas_dirfused``).

:func:`bi_gcn_lstm` hoists the input projection ``u = x·W_x`` out of the
scan with one ``torch.matmul`` (as the JAX package leaves it to XLA outside
its kernel) and launches ``csrc/gcn_lstm.cu``: grid (streams, directions),
both directions in one launch, the recurrent state in shared memory for the
whole window. On a CPU tensor it computes :func:`bi_gcn_lstm_reference`,
the plain PyTorch version of the same function; on a CUDA tensor it
launches the kernel or raises.

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

from typing import Optional

import torch

from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops._common import (SMEM_LIMIT, check_f32, check_n_valid,
                                        f32 as _f32, kernel_library, launch,
                                        n_valid_tensor as _n_valid)

__all__ = ["bi_gcn_lstm", "bi_gcn_lstm_reference", "scan", "scan_inputs"]


def bi_gcn_lstm_reference(params2: C.GCNLSTMCellParams, x: torch.Tensor,
                          state2, n_valid=None):
    r"""The plain PyTorch version of :func:`bi_gcn_lstm` — the same function
    on any device, built from the cells' hoisted step and the masked
    bidirectional scan. The CPU path and the tests use it; on the card it
    is what the kernel is held to."""
    x = _f32(x)
    h2, c2 = (_f32(s) for s in state2)
    S, T, N, F = x.shape
    H = params2.bias.shape[-1]
    u = torch.matmul(x.reshape(1, S * T * N, F), params2.kernel[:, :F])
    u = u.reshape(2, S, T, N, 4 * H).transpose(1, 2)           # [2,T,S,N,4H]
    seq_stack = torch.stack((u[0], u[1].flip(0)))
    nv = _n_valid(n_valid, S, T, x.device)
    frame_mask = (torch.arange(T, device=x.device)[None] < nv[:, None])

    def step(p, u_t, st):
        return C.gcn_lstm_step_hoisted(p, u_t, st,
                                       hidden_kernel=p.kernel[:, F:])

    hs, (h, c) = L.bi_rnn_precomputed(step, params2, seq_stack, (h2, c2),
                                      frame_mask=frame_mask)
    y = torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1)
    return torch.tanh(y), (h, c)


def scan(u: torch.Tensor, wh: torch.Tensor, adj: torch.Tensor,
         bias: torch.Tensor, attention: Optional[tuple], h0: torch.Tensor,
         c0: torch.Tensor, n_valid: torch.Tensor):
    r"""Launch the kernel on hoisted inputs. u [2, S, T, N, 4H] (both
    directions in forward frame order), wh [2, H, 4H], adj [2, 4, N, N],
    bias [2, 4, H], attention None or (w, wq, wh, u [2, H], bs, bu), h0/c0
    [2, S, N, H], n_valid [S] int32 — all contiguous fp32 on one card.
    Returns (y [S, T, N, 2H], h [2, S, N, H], c [2, S, N, H])."""
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
    if H % 4 or N > 16:
        raise ValueError(f"gcn_lstm: needs H % 4 == 0 and N <= 16, got "
                         f"H={H}, N={N}")
    lib = kernel_library("gcn_lstm", 16, 5, 2)
    if lib.gcn_lstm_smem_bytes(N, H) > SMEM_LIMIT:
        raise ValueError(f"gcn_lstm: H={H} needs more shared memory than a "
                         "block has")
    y = torch.empty((S, T, N, 2 * H), dtype=torch.float32, device=dev)
    h_out = torch.empty((2, S, N, H), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    att = [t.data_ptr() for t in attention] if attention else [None] * 6
    launch("gcn_lstm", lib, dev, u.data_ptr(), wh.data_ptr(),
           adj.data_ptr(), bias.data_ptr(), *att, h0.data_ptr(),
           c0.data_ptr(), n_valid.data_ptr(), y.data_ptr(), h_out.data_ptr(),
           c_out.data_ptr(), S, T, N, H, int(attention is not None))
    bi_gcn_lstm.launches += 1
    return y, h_out, c_out


def bi_gcn_lstm(params2: C.GCNLSTMCellParams, x: torch.Tensor, state2,
                n_valid=None):
    r"""Bidirectional graph-LSTM layer: x [S, T, N, F], state2 (h, c) each
    [2, S, N, H], ``n_valid`` None | int | [S] → (y [S, T, N, 2H], (h, c)).
    CPU tensors take :func:`bi_gcn_lstm_reference`; CUDA tensors launch the
    kernel (one launch, both directions) or raise."""
    if not x.is_cuda:
        return bi_gcn_lstm_reference(params2, x, state2, n_valid)
    if torch.is_grad_enabled():
        raise RuntimeError(
            "bi_gcn_lstm: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or torch.inference_mode() (gradients come with "
            "the training slice, ROADMAP Queue 1 item 11)")
    y, h, c = scan(*scan_inputs(params2, x, state2, n_valid))
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
