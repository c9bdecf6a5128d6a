r"""Graph-recurrent cells of the A3GC/AAGC/AGC family and the G-GRU cell
(counterpart of ``a3gc_tpu/models/cells.py``).

Parameter containers are ``nn.Module``s whose parameters keep the JAX
names and layouts:

  * dense kernels are stored ``[in, out]``;
  * the fused gate kernel is ``[F+H, 4H]``, gate order i, f, g(c), o, the
    recurrent half in the last H rows;
  * adjacency matrices are left-multiplying: ``out[n] = Σ_m L[n, m]·x[m]``;
  * recurrent layers stack both directions on a leading axis of 2
    (:func:`a3gc_tpu_torch.models.layers.stack_directions`).

The step functions below take direction-stacked parameters (leading axis
D) and run both directions at once — the port's form of the JAX package's
``vmap`` over the direction axis. The hoisted steps serve inference (the
plain versions of the kernels); the unhoisted ``gcn_lstm_step`` and
``ggru_step`` serve training, where dropout falls on each frame's input and
recurrent state.

Dropout takes a ``torch.Generator`` (the mask is drawn where it is applied)
or a precomputed bool keep-mask (:func:`keep_mask`): the training layers
draw a window's masks before their loop, so that a step recomputed under
``torch.utils.checkpoint`` applies the same mask (checkpointing restores
the global RNG state, not an explicit generator's).

The steps read a parameter through :mod:`a3gc_tpu_torch.parallel.tensor`
(``TP.matmul`` where it is a product's right operand, ``TP.full``
elsewhere), so that under tensor parallelism a split parameter's products
run column-parallel over its blocks; on a plain tensor both are the plain
operation. Every product takes an operand format ``fmt`` ("fp32" or
"tf32", :func:`a3gc_tpu_torch.ops._common.operand_format`): at "tf32" its
operands are rounded to TF32 where the JAX cell's products at
``precision`` take them, and summed in fp32. The steps round without the
profiler span ``a3gc.round`` (``step_operand``, ``TP.matmul(...,
step=True)``), which would be one a frame; :func:`graph_conv`, once a
call, rounds with it, its parameters through ``weight_operand`` (rounded
once a weight version).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from a3gc_tpu_torch._device import random_rows
from a3gc_tpu_torch.ops._common import (operand, step_operand,
                                        weight_operand)
from a3gc_tpu_torch.parallel import tensor as TP

__all__ = [
    "GraphConvParams", "AttentionParams", "GCNLSTMCellParams",
    "GGRUCellParams", "keep_mask", "graph_conv", "gcn_lstm_gates",
    "gcn_lstm_step", "gcn_lstm_step_hoisted", "ggru_step",
    "ggru_step_hoisted", "init_graph_conv", "init_attention",
    "init_gcn_lstm_cell", "init_ggru_cell",
]


def _param(t) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(t, dtype=torch.float32))


class GraphConvParams(nn.Module):
    r"""AAGC projection layer: graph mix + dense."""

    def __init__(self, kernel, adj, bias):
        super().__init__()
        self.kernel = _param(kernel)     # [in, out]
        self.adj = _param(adj)           # [N, N] left-multiplying
        self.bias = _param(bias)         # [out]


class AttentionParams(nn.Module):
    r"""Joint attention of the A3GC/AGC cells."""

    def __init__(self, w, wq, wh, u, bs, bu):
        super().__init__()
        self.w = _param(w)               # [H, H]
        self.wq = _param(wq)             # [H, H]
        self.wh = _param(wh)             # [H, H]
        self.u = _param(u)               # [H, 1]
        self.bs = _param(bs)             # [H]
        self.bu = _param(bu)             # [N]


class GCNLSTMCellParams(nn.Module):
    r"""AAGC (``attention is None``) / A3GC / AGC LSTM cell parameters."""

    def __init__(self, kernel, adj, bias,
                 attention: Optional[AttentionParams] = None):
        super().__init__()
        self.kernel = _param(kernel)     # [F+H, 4H] fused, gate order i,f,g,o
        self.adj = _param(adj)           # [4, N, N] per-gate left-multiplying
        self.bias = _param(bias)         # [4, H]
        self.attention = attention


class GGRUCellParams(nn.Module):
    r"""G-GRU cell: a GRU with a graph message on the hidden state."""

    def __init__(self, w_in, b_in, w_hid, gcn_kernel, adj):
        super().__init__()
        self.w_in = _param(w_in)             # [F, 3H] gate order r, u, c
        self.b_in = _param(b_in)             # [3H]
        self.w_hid = _param(w_hid)           # [H, 3H] (no bias)
        self.gcn_kernel = _param(gcn_kernel)  # [H, H]
        self.adj = _param(adj)               # [N, N] left-multiplying


# ---------------------------------------------------------------------------
# forward math
# ---------------------------------------------------------------------------

def keep_mask(rng: Optional[torch.Generator], shape, rate: float,
              device, batch_axis: int = 0) -> Optional[torch.Tensor]:
    r"""A bool keep-mask of ``shape`` (each element kept with probability
    1 − rate), drawn from ``rng`` on ``device`` (a generator lives on the
    device of the tensors it fills; a :class:`~a3gc_tpu_torch._device.
    RowDraws` draws at the global batch along ``batch_axis`` and keeps its
    shard's rows); None when there is no rng or the rate is 0."""
    if rng is None or rate <= 0.0:
        return None
    return random_rows(torch.rand, rng, shape, device, batch_axis) \
        < 1.0 - rate


def _dropout(x: torch.Tensor, rate: float, rng) -> torch.Tensor:
    r"""Inverted dropout; identity when ``rng`` is None or rate == 0.
    ``rng``: a ``torch.Generator`` or a bool keep-mask of x's shape."""
    if rng is None or rate <= 0.0:
        return x
    mask = rng if isinstance(rng, torch.Tensor) else keep_mask(
        rng, x.shape, rate, x.device)
    return torch.where(mask, x / (1.0 - rate), 0.0)


def graph_conv(p: GraphConvParams, x: torch.Tensor, *,
               dropout_rate: float = 0.0, rng=None,
               fmt: str = "fp32") -> torch.Tensor:
    r"""AAGC projection ``adj · x · kernel + bias`` over [..., N, F], after
    dropout on x when ``rng`` is given."""
    x = _dropout(x, dropout_rate, rng)
    y = TP.matmul(x, p.kernel, fmt=fmt)
    return torch.matmul(weight_operand(p.adj, fmt), operand(y, fmt)) \
        + TP.full(p.bias)


def _attention_gate(ap: AttentionParams, hy: torch.Tensor,
                    fmt: str = "fp32") -> torch.Tensor:
    r"""Per-node sigmoid attention score a ∈ [0, 1], direction-stacked.

    q = ReLU(Σ_nodes hy·W);  a = σ(tanh(hy·Wh + q·Wq + bs)·u + bu)

    hy [D, B, N, H] → [D, B, N, 1]."""
    q = torch.relu(torch.sum(TP.matmul(hy, ap.w, stacked=True, fmt=fmt,
                                       step=True),
                             dim=2, keepdim=True))                # [D,B,1,H]
    s = torch.tanh(TP.matmul(hy, ap.wh, stacked=True, fmt=fmt, step=True)
                   + TP.matmul(q, ap.wq, stacked=True, fmt=fmt, step=True)
                   + TP.full(ap.bs)[:, None, None, :])            # [D,B,N,H]
    a = torch.matmul(step_operand(s, fmt),
                     step_operand(ap.u, fmt)[:, None])[..., 0] \
        + ap.bu[:, None, :]
    return torch.sigmoid(a)[..., None]


def gcn_lstm_gates(p: GCNLSTMCellParams, z: torch.Tensor,
                   state: Tuple[torch.Tensor, torch.Tensor],
                   fmt: str = "fp32"):
    r"""Tail of the cell step given the pre-activation gate features
    ``z = [x‖h]·W`` (before the graph mix): per-gate adjacency mix, then the
    bias, the nonlinearities and the attention. z [D, B, N, 4H], state (h,
    c) each [D, B, N, H]. Returns the new state (hy, c'): the carried h is
    the post-attention hy, c' the pre-attention cell."""
    h, c = state
    D, B, N = z.shape[0], z.shape[1], z.shape[2]
    bias = TP.full(p.bias)
    H = bias.shape[-1]
    y = z.reshape(D, B, N, 4, H)
    mixed = torch.einsum("dknm,dbmkh->dbnkh", step_operand(p.adj, fmt),
                         step_operand(y, fmt))
    gates = mixed + bias[:, None, None]                            # [D,B,N,4,H]
    i = torch.sigmoid(gates[..., 0, :])
    f = torch.sigmoid(gates[..., 1, :])
    g = torch.tanh(gates[..., 2, :])
    o = torch.sigmoid(gates[..., 3, :])
    c_new = f * c + i * g
    hy = o * torch.tanh(c_new)
    if p.attention is not None:
        hy = hy + hy * _attention_gate(p.attention, hy, fmt)
    return hy, c_new


def gcn_lstm_step_hoisted(p: GCNLSTMCellParams, u_t: torch.Tensor, state, *,
                          hidden_kernel: torch.Tensor, fmt: str = "fp32"):
    r"""Cell step with the input projection ``u_t = x_t·W_x`` hoisted out of
    the scan: ``z = u_t + h·W_h``. u_t [D, B, N, 4H], hidden_kernel [D, H,
    4H]. Returns the new state; the layer's output is tanh of the carried
    h."""
    h, c = state
    z = u_t + torch.matmul(step_operand(h, fmt),
                           step_operand(hidden_kernel, fmt)[:, None])
    return gcn_lstm_gates(p, z, (h, c), fmt)


def gcn_lstm_step(p: GCNLSTMCellParams, x: torch.Tensor, state,
                  x_mask=None, h_mask=None, *, dropout_rate: float = 0.0,
                  recurrent_dropout_rate: float = 0.0, fmt: str = "fp32"):
    r"""One frame of the AAGC/A3GC/AGC LSTM cell, direction-stacked, the
    input projection inside: x [D, B, N, F], state (h, c) each [D, B, N, H];
    dropout on x and on the h entering the gate product where keep-masks
    are given. z = [x‖h]·W, one product on the fused kernel [D, F+H, 4H].
    Returns the new state (hy, c'); the layer's output is tanh of hy."""
    h, c = state
    x = _dropout(x, dropout_rate, x_mask)
    h_in = _dropout(h, recurrent_dropout_rate, h_mask)
    z = TP.matmul(torch.cat((x, h_in), dim=-1), p.kernel, stacked=True,
                  fmt=fmt, step=True)
    return gcn_lstm_gates(p, z, (h, c), fmt)


def ggru_step(p: GGRUCellParams, x: torch.Tensor, state,
              fmt: str = "fp32"):
    r"""One frame of the G-GRU cell, direction-stacked, the input
    projection inside: zi = x·W_in + b_in, then :func:`ggru_step_hoisted`.
    x [D, B, N, F], state ``(h,)``. Returns ``(h',)``."""
    zi = TP.matmul(x, p.w_in, stacked=True, fmt=fmt, step=True) \
        + TP.full(p.b_in)[:, None, None]
    return ggru_step_hoisted(p, zi, state, fmt)


def ggru_step_hoisted(p: GGRUCellParams, zi: torch.Tensor,
                      state: Tuple[torch.Tensor], fmt: str = "fp32"):
    r"""G-GRU step given the hoisted input projection ``zi = x·W_in +
    b_in``, direction-stacked: zi [D, B, N, 3H], state ``(h,)`` with h
    [D, B, N, H]. msg = adj·(h·G), zh = msg·W_hid, r = σ(zi_r + zh_r),
    u = σ(zi_u + zh_u), cand = tanh(zi_c + r·zh_c), h' = u·h + (1−u)·cand.
    Returns the new state ``(h',)``; the layer's output is h'."""
    (h,) = state
    H = h.shape[-1]
    msg = TP.matmul(h, p.gcn_kernel, stacked=True, fmt=fmt, step=True)
    msg = torch.einsum("dnm,dbmh->dbnh", step_operand(p.adj, fmt),
                       step_operand(msg, fmt))
    zh = TP.matmul(msg, p.w_hid, stacked=True, fmt=fmt, step=True)
    r = torch.sigmoid(zi[..., 0:H] + zh[..., 0:H])
    u = torch.sigmoid(zi[..., H:2 * H] + zh[..., H:2 * H])
    cand = torch.tanh(zi[..., 2 * H:] + r * zh[..., 2 * H:])
    return (u * h + (1.0 - u) * cand,)


# ---------------------------------------------------------------------------
# initializers: the JAX package's xavier/zero distributions, drawn from a
# torch.Generator (the bits differ from jax.random's)
# ---------------------------------------------------------------------------

def _xavier_uniform(gen: torch.Generator, torch_shape) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ on a torch-layout [out, in] tensor,
    transposed into the [in, out] layout."""
    fan_out, fan_in = torch_shape
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    w = torch.rand(torch_shape, generator=gen) * (2 * bound) - bound
    return w.T.contiguous()


def _torch_linear_init(gen: torch.Generator, fan_in: int, fan_out: int):
    """torch.nn.Linear's default init, U(±1/√fan_in), for a weight in the
    [in, out] layout and its bias."""
    bound = 1.0 / fan_in ** 0.5
    w = torch.rand((fan_in, fan_out), generator=gen) * (2 * bound) - bound
    b = torch.rand((fan_out,), generator=gen) * (2 * bound) - bound
    return w, b


def init_graph_conv(gen: torch.Generator, units_in: int, units_out: int,
                    adjacency) -> GraphConvParams:
    r"""Xavier kernel, template adjacency (stored as A₀ᵀ), zero bias."""
    a0 = torch.as_tensor(np.asarray(adjacency, np.float32))
    return GraphConvParams(
        kernel=_xavier_uniform(gen, (units_out, units_in)),
        adj=a0.T.contiguous(),
        bias=torch.zeros(units_out))


def init_attention(gen: torch.Generator, units_out: int,
                   num_nodes: int) -> AttentionParams:
    r"""Xavier matrices, zero biases."""
    return AttentionParams(
        w=_xavier_uniform(gen, (units_out, units_out)),
        wq=_xavier_uniform(gen, (units_out, units_out)),
        wh=_xavier_uniform(gen, (units_out, units_out)),
        u=_xavier_uniform(gen, (1, units_out)),
        bs=torch.zeros(units_out),
        bu=torch.zeros(num_nodes))


def init_gcn_lstm_cell(gen: torch.Generator, units_in: int, units_out: int,
                       adjacency, *, attention: bool,
                       shared_fixed_adj: bool = False) -> GCNLSTMCellParams:
    r"""Init an AAGC (attention=False), A3GC (attention=True) or AGC
    (attention=True, shared_fixed_adj=True) cell: per-gate xavier kernels,
    adjacency at the template (A₀ᵀ for AAGC/A3GC, A₀ for AGC), zero bias."""
    fused = torch.cat([
        _xavier_uniform(gen, (units_out, units_in + units_out))
        for _ in range(4)], dim=1)
    a0 = torch.as_tensor(np.asarray(adjacency, np.float32))
    adj = (a0 if shared_fixed_adj else a0.T)[None].expand(4, -1, -1)
    return GCNLSTMCellParams(
        kernel=fused,
        adj=adj.contiguous(),
        bias=torch.zeros(4, units_out),
        attention=(init_attention(gen, units_out, a0.shape[0])
                   if attention else None))


def init_ggru_cell(gen: torch.Generator, units_in: int, units_out: int,
                   adjacency) -> GGRUCellParams:
    r"""torch.nn.Linear inits for the r/u/c input and hidden projections
    (the hidden ones without bias), xavier ``gcn_kernel`` and a xavier
    adjacency: as in the JAX package, only the template's size is used,
    not its values."""
    n = np.asarray(adjacency).shape[0]
    w_in, b_in = zip(*(_torch_linear_init(gen, units_in, units_out)
                       for _ in range(3)))
    w_hid = [_torch_linear_init(gen, units_out, units_out)[0]
             for _ in range(3)]
    return GGRUCellParams(
        w_in=torch.cat(w_in, dim=1),
        b_in=torch.cat(b_in),
        w_hid=torch.cat(w_hid, dim=1),
        gcn_kernel=_xavier_uniform(gen, (units_out, units_out)),
        adj=_xavier_uniform(gen, (n, n)).T.contiguous())
