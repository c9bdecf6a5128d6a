r"""Bidirectional dense LSTM layer over a whole window in one kernel launch
(counterpart of ``a3gc_tpu/ops/pallas_gcn_lstm.py`` ``bi_lstm_pallas``),
the recurrent layer of the DIP net and of the TransPose cascade.

:func:`bi_lstm` hoists the input projection ``u = x·W_ih + b_ih + b_hh``
out of the scan with one ``torch.matmul`` (as the JAX package leaves it to
XLA outside its kernel) and launches ``csrc/lstm.cu``: grid (blocks of up
to 8 streams, directions), both directions in one launch, the recurrent
state in shared memory for the whole window. On a CPU tensor it computes
:func:`bi_lstm_reference`, the plain PyTorch version of the same function;
on a CUDA tensor it launches the kernel or raises.

The function, for x [S, T, F], state2 (h, c) each [2, S, H] and
per-stream ``n_valid`` [S] (the Pallas kernel takes one scalar for all
rows; the port keeps the per-row contract of the JAX XLA path):

  * direction 0 walks frames 0 … T-1, direction 1 walks T-1 … 0;
  * gate order i, f, g, o (torch.nn.LSTM's);
  * frames < n_valid[s] update stream s's state, later frames carry it;
  * y [S, T, 2H] is the carried h after each frame, forward ‖ backward;
  * returns (y, (h, c)) with the final states [2, S, H].

The kernel is forward-only: a CUDA call with grad enabled raises.
"""

from __future__ import annotations

import torch
from torch import nn

from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops._common import (SMEM_LIMIT, check_f32, check_n_valid,
                                        f32, kernel_library, launch,
                                        n_valid_tensor)

__all__ = ["bi_lstm", "bi_lstm_reference", "lstm_step_hoisted", "scan",
           "scan_inputs"]


def _hoist(params2: nn.Module, x: torch.Tensor) -> torch.Tensor:
    r"""u = x·W_ih + b_ih + b_hh for both directions, forward frame order:
    [2, S, T, 4H]."""
    S, T, F = x.shape
    u = torch.matmul(x.reshape(1, S * T, F), f32(params2.w_ih))
    u = u + (f32(params2.b_ih) + f32(params2.b_hh))[:, None, :]
    return u.reshape(2, S, T, -1)


def lstm_step_hoisted(p: nn.Module, u_t: torch.Tensor, state):
    r"""Dense LSTM step on direction-stacked parameters, the input half
    hoisted: u_t [D, B, 4H], state (h, c) each [D, B, H]. z = u_t + h·W_hh,
    gates i, f, g, o. Returns the new state (h', c')."""
    h, c = state
    H = h.shape[-1]
    z = u_t + torch.matmul(h, p.w_hh)
    i = torch.sigmoid(z[..., 0:H])
    f = torch.sigmoid(z[..., H:2 * H])
    g = torch.tanh(z[..., 2 * H:3 * H])
    o = torch.sigmoid(z[..., 3 * H:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def bi_lstm_reference(params2: nn.Module, x: torch.Tensor, state2,
                      n_valid=None):
    r"""The plain PyTorch version of :func:`bi_lstm` — the same function on
    any device, built from the hoisted step and the masked bidirectional
    scan. ``params2`` holds direction-stacked ``w_ih`` [2, F, 4H], ``w_hh``
    [2, H, 4H], ``b_ih`` and ``b_hh`` [2, 4H]. The CPU path and the tests
    use it; on the card it is what the kernel is held to."""
    x = f32(x)
    S, T = x.shape[0], x.shape[1]
    u = _hoist(params2, x).transpose(1, 2)                    # [2,T,S,4H]
    seq_stack = torch.stack((u[0], u[1].flip(0)))
    nv = n_valid_tensor(n_valid, S, T, x.device)
    frame_mask = torch.arange(T, device=x.device)[None] < nv[:, None]
    hs, (h, c) = L.bi_rnn_precomputed(
        lstm_step_hoisted, params2, seq_stack,
        tuple(f32(s) for s in state2), frame_mask=frame_mask)
    y = torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1)
    return y, (h, c)


def scan(u: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
         c0: torch.Tensor, n_valid: torch.Tensor):
    r"""Launch the kernel on hoisted inputs. u [2, S, T, 4H] (both
    directions in forward frame order), w_hh [2, H, 4H], h0/c0 [2, S, H],
    n_valid [S] int32 — all contiguous fp32 on one card. Returns (y [S, T,
    2H], h [2, S, H], c [2, S, H])."""
    _, S, T, G = u.shape
    H = G // 4
    dev = u.device
    check_f32("lstm", dev, [(u, (2, S, T, 4 * H)), (w_hh, (2, H, 4 * H)),
                            (h0, (2, S, H)), (c0, (2, S, H))])
    check_n_valid("lstm", dev, n_valid, S)
    if H % 4:
        raise ValueError(f"lstm: needs H % 4 == 0, got H={H}")
    lib = kernel_library("lstm", 8, 3, 2)
    if lib.lstm_smem_bytes(S, H) > SMEM_LIMIT:
        raise ValueError(f"lstm: H={H} needs more shared memory than a "
                         "block has")
    y = torch.empty((S, T, 2 * H), dtype=torch.float32, device=dev)
    h_out = torch.empty((2, S, H), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    launch("lstm", lib, dev, u.data_ptr(), w_hh.data_ptr(), h0.data_ptr(),
           c0.data_ptr(), n_valid.data_ptr(), y.data_ptr(), h_out.data_ptr(),
           c_out.data_ptr(), S, T, H)
    bi_lstm.launches += 1
    return y, h_out, c_out


def bi_lstm(params2: nn.Module, x: torch.Tensor, state2, n_valid=None):
    r"""Bidirectional dense LSTM layer: x [S, T, F], state2 (h, c) each
    [2, S, H], ``n_valid`` None | int | [S] → (y [S, T, 2H], (h, c)). CPU
    tensors take :func:`bi_lstm_reference`; CUDA tensors launch the kernel
    (one launch, both directions) or raise."""
    if not x.is_cuda:
        return bi_lstm_reference(params2, x, state2, n_valid)
    if torch.is_grad_enabled():
        raise RuntimeError(
            "bi_lstm: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or torch.inference_mode() (gradients come with "
            "the training slice, ROADMAP Queue 1 item 11)")
    y, h, c = scan(*scan_inputs(params2, x, state2, n_valid))
    return y, (h, c)


def scan_inputs(params2: nn.Module, x: torch.Tensor, state2,
                n_valid=None) -> tuple:
    r"""The arguments of :func:`scan` for one layer call: the hoisted input
    projection for both directions (one ``torch.matmul``, forward frame
    order) and the parameters and state in the kernel's layouts."""
    x = f32(x)
    S, T = x.shape[0], x.shape[1]
    h0, c0 = (f32(s).contiguous() for s in state2)
    return (_hoist(params2, x), f32(params2.w_hh).contiguous(), h0, c0,
            n_valid_tensor(n_valid, S, T, x.device))


bi_lstm.launches = 0    # kernel launches since the last reset to 0
