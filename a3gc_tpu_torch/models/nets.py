r"""Graph nets and the DIP LSTM net (counterpart of
``a3gc_tpu/models/nets.py``), inference only.

Graph-net topology:
    linear_in:  AAGC(in → H)  → ReLU
    rnn1:       Bi-cell(H → H)         (output 2H)
    rnn2:       Bi-cell(2H → H)        (output 2H)
    linear_out: AAGC(2H → out)

The graph-LSTM cells (a3gc/aagc/agc) run their recurrent layers through
:func:`a3gc_tpu_torch.ops.gcn_lstm.bi_gcn_lstm`, the G-GRU cell through
:func:`a3gc_tpu_torch.ops.ggru.bi_ggru`, and the DIP net (dense → ReLU →
stacked bi- or unidirectional LSTM → dense) through
:func:`a3gc_tpu_torch.ops.lstm.bi_lstm`: the Hopper kernels on a CUDA
tensor, or their plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from a3gc_tpu_torch._device import check_module_device, resolve_device
from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops import gcn_lstm as G
from a3gc_tpu_torch.ops import ggru as GG
from a3gc_tpu_torch.ops import lstm as LS

__all__ = ["GraphNetConfig", "GraphNetParams", "init_graph_net",
           "graph_net_zero_state", "graph_net_apply", "DenseParams",
           "LSTMLayerParams", "DIPConfig", "DIPParams", "init_dip",
           "dip_zero_state", "dip_apply", "check_ones_prefix"]

CELL_KINDS = ("aagc", "a3gc", "agc", "ggru")
BACKENDS = ("auto", "eager", "cuda")


@dataclasses.dataclass(frozen=True)
class GraphNetConfig:
    r"""Static net hyperparameters.

    ``backend``: "auto" runs the recurrent layers through the CUDA kernel on
    CUDA tensors and through the plain version on CPU tensors; "eager"
    always runs the plain version; "cuda" runs the kernel or raises."""

    cell: str = "a3gc"
    units_in: int = 12
    units_out: int = 9
    units_hidden: int = 256
    num_nodes: int = 15
    backend: str = "auto"

    def __post_init__(self):
        if self.cell not in CELL_KINDS:
            raise ValueError(f"unknown cell {self.cell!r}")
        _check_backend(self.backend)


def _check_backend(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


class GraphNetParams(nn.Module):
    def __init__(self, linear_in: C.GraphConvParams, rnn1: nn.Module,
                 rnn2: nn.Module, linear_out: C.GraphConvParams):
        super().__init__()
        self.linear_in = linear_in
        self.rnn1 = rnn1      # direction-stacked [2, ...]
        self.rnn2 = rnn2
        self.linear_out = linear_out


def _init_cell(gen, cfg: GraphNetConfig, units_in: int, adjacency):
    if cfg.cell == "ggru":
        return C.init_ggru_cell(gen, units_in, cfg.units_hidden, adjacency)
    return C.init_gcn_lstm_cell(
        gen, units_in, cfg.units_hidden, adjacency,
        attention=cfg.cell in ("a3gc", "agc"),
        shared_fixed_adj=cfg.cell == "agc")


def init_graph_net(gen: torch.Generator, cfg: GraphNetConfig,
                   adjacency) -> GraphNetParams:
    r"""Initialize a graph net on the CPU from ``gen`` (move it with
    ``.to(device)``)."""
    H = cfg.units_hidden
    return GraphNetParams(
        linear_in=C.init_graph_conv(gen, cfg.units_in, H, adjacency),
        rnn1=L.stack_directions(_init_cell(gen, cfg, H, adjacency),
                                _init_cell(gen, cfg, H, adjacency)),
        rnn2=L.stack_directions(_init_cell(gen, cfg, 2 * H, adjacency),
                                _init_cell(gen, cfg, 2 * H, adjacency)),
        linear_out=C.init_graph_conv(gen, 2 * H, cfg.units_out, adjacency))


def graph_net_zero_state(cfg: GraphNetConfig, batch: int, device="cuda",
                         dtype=torch.float32):
    r"""Zero recurrent state: (h, c), each [2, B, N, H], for the LSTM
    cells; the single tensor h [2, B, N, H] for ggru. ONE state threads
    through BOTH rnn layers: rnn2 starts from rnn1's final state."""
    shape = (2, batch, cfg.num_nodes, cfg.units_hidden)
    dev = resolve_device(device)
    if cfg.cell == "ggru":
        return torch.zeros(shape, dtype=dtype, device=dev)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def _pick(backend: str, x: torch.Tensor, kernel_fn, plain_fn):
    r"""The layer function of a backend: "eager" → the plain version,
    "cuda" → the kernel's wrapper or raise off the card, "auto" → the
    wrapper (kernel on CUDA tensors, plain version on CPU tensors)."""
    if backend == "eager":
        return plain_fn
    if backend == "cuda" and not x.is_cuda:
        raise RuntimeError("backend='cuda' needs CUDA tensors, got a tensor "
                           f"on {x.device}")
    return kernel_fn


def _rnn_layer(cfg: GraphNetConfig, x: torch.Tensor):
    if cfg.cell == "ggru":
        return _pick(cfg.backend, x, GG.bi_ggru, GG.bi_ggru_reference)
    return _pick(cfg.backend, x, G.bi_gcn_lstm, G.bi_gcn_lstm_reference)


def check_ones_prefix(frame_mask):
    r"""Raise ``ValueError`` unless ``frame_mask`` [B, T] has rows that are
    ones-prefix (valid frames, then only padding), the form the layers can
    take as per-row lengths. Checked where the mask lies on the host (numpy,
    a list, a CPU tensor); a mask already on the card is taken as it is, so
    that the sessions' own whole-row masks add no host sync, and so is a
    mask being traced by ``torch.export``, which has no values (the
    artifact sessions of :mod:`a3gc_tpu_torch.export` check theirs before
    it enters the program)."""
    if frame_mask is None or torch.compiler.is_compiling() or (
            isinstance(frame_mask, torch.Tensor)
            and frame_mask.device.type != "cpu"):
        return
    m = (frame_mask.detach().numpy() if isinstance(frame_mask, torch.Tensor)
         else np.asarray(frame_mask))
    if m.ndim != 2:
        raise ValueError(f"frame_mask must be [B, T], got shape {m.shape}")
    valid = m != 0
    bad = np.flatnonzero((valid[:, 1:] > valid[:, :-1]).any(axis=1))
    if bad.size:
        raise ValueError(
            f"frame_mask row {int(bad[0])} is not a ones-prefix (a valid "
            "frame follows a masked one); the port takes per-row lengths: "
            "end-pad each row")


def _n_valid(frame_mask, dev):
    if frame_mask is None:
        return None
    check_ones_prefix(frame_mask)
    return (torch.as_tensor(frame_mask, device=dev) != 0).sum(dim=1).to(
        torch.int32)


def graph_net_apply(params: GraphNetParams, cfg: GraphNetConfig, x,
                    state=None, frame_mask=None, *, device="cuda"):
    r"""Forward pass at inference. x [B, T, N, F_in] → ([B, T, N, F_out],
    new state). ``frame_mask`` [B, T] marks valid frames; rows must be
    ones-prefix (end padding, or a whole idle row), since the layers take
    per-row lengths ``n_valid = Σ_t frame_mask``: a host mask that is not
    raises ``ValueError`` (:func:`check_ones_prefix`). Outputs on masked
    frames are undefined; the state carries through them."""
    dev = resolve_device(device)
    check_module_device(params, dev)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if state is None:
        state = graph_net_zero_state(cfg, x.shape[0], dev)
    n_valid = _n_valid(frame_mask, dev)
    layer = _rnn_layer(cfg, x)
    x = torch.relu(C.graph_conv(params.linear_in, x))
    x, state = layer(params.rnn1, x, state, n_valid)
    x, state = layer(params.rnn2, x, state, n_valid)
    return C.graph_conv(params.linear_out, x), state


# ---------------------------------------------------------------------------
# DIP biLSTM: dense → ReLU → stacked biLSTM → dense
# ---------------------------------------------------------------------------

class DenseParams(nn.Module):
    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel = C._param(kernel)   # [in, out]
        self.bias = C._param(bias)       # [out]


class LSTMLayerParams(nn.Module):
    r"""One LSTM layer in torch.nn.LSTM's gate order i, f, g, o, both bias
    vectors kept; direction-stacked (leading axis 2) inside the DIPParams
    of a bidirectional net, unstacked in a unidirectional one."""

    def __init__(self, w_ih, w_hh, b_ih, b_hh):
        super().__init__()
        self.w_ih = C._param(w_ih)       # [F, 4H]
        self.w_hh = C._param(w_hh)       # [H, 4H]
        self.b_ih = C._param(b_ih)       # [4H]
        self.b_hh = C._param(b_hh)       # [4H]


@dataclasses.dataclass(frozen=True)
class DIPConfig:
    r"""Static DIP-net hyperparameters. ``backend`` as in
    :class:`GraphNetConfig`."""

    n_input: int = 60
    n_output: int = 135
    n_hidden: int = 512
    n_layers: int = 2
    bidirectional: bool = True
    backend: str = "auto"

    def __post_init__(self):
        _check_backend(self.backend)

    @property
    def directions(self) -> int:
        return 2 if self.bidirectional else 1


class DIPParams(nn.Module):
    def __init__(self, linear1: DenseParams, lstm, linear2: DenseParams):
        super().__init__()
        self.linear1 = linear1
        self.lstm = nn.ModuleList(lstm)   # per layer (direction-stacked if
                                          # bidirectional)
        self.linear2 = linear2


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (2 * bound) - bound


def init_dip(gen: torch.Generator, cfg: DIPConfig) -> DIPParams:
    r"""torch.nn.Linear and torch.nn.LSTM default inits (U(±1/√fan_in) and
    U(±1/√H)) in the JAX layouts, drawn from ``gen`` on the CPU."""
    H = cfg.n_hidden

    def linear(fan_in, fan_out):
        return DenseParams(*C._torch_linear_init(gen, fan_in, fan_out))

    def direction(f_in):
        b = 1.0 / H ** 0.5
        return LSTMLayerParams(
            w_ih=_uniform(gen, (f_in, 4 * H), b),
            w_hh=_uniform(gen, (H, 4 * H), b),
            b_ih=_uniform(gen, (4 * H,), b), b_hh=_uniform(gen, (4 * H,), b))

    D = cfg.directions
    linear1 = linear(cfg.n_input, H)
    linear2 = linear(D * H, cfg.n_output)
    lstm = []
    for i in range(cfg.n_layers):
        dirs = [direction(H if i == 0 else D * H) for _ in range(D)]
        lstm.append(L.stack_directions(*dirs) if D == 2 else dirs[0])
    return DIPParams(linear1, lstm, linear2)


def dip_zero_state(cfg: DIPConfig, batch: int, device="cuda",
                   dtype=torch.float32):
    r"""Zero state: per layer (h, c), each [2, B, H] (bidirectional) or
    [B, H] (unidirectional). Unlike the graph nets, every layer carries its
    own state."""
    dev = resolve_device(device)
    shape = (2,) * (cfg.directions - 1) + (batch, cfg.n_hidden)
    return tuple((torch.zeros(shape, dtype=dtype, device=dev),
                  torch.zeros(shape, dtype=dtype, device=dev))
                 for _ in range(cfg.n_layers))


def dip_apply(params: DIPParams, cfg: DIPConfig, x, state=None,
              frame_mask=None, *, device="cuda"):
    r"""DIP forward at inference: x [B, T, n_input] → ([B, T, n_output],
    new state). ``frame_mask`` [B, T] as in :func:`graph_net_apply`: per
    row, ones-prefix; outputs on masked frames are undefined and the state
    carries through them."""
    dev = resolve_device(device)
    check_module_device(params, dev)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if state is None:
        state = dip_zero_state(cfg, x.shape[0], dev)
    n_valid = _n_valid(frame_mask, dev)
    layer = _pick(cfg.backend, x, LS.bi_lstm, LS.bi_lstm_reference)
    x = torch.relu(torch.matmul(x, params.linear1.kernel)
                   + params.linear1.bias)
    new_states = []
    for layer_params, layer_state in zip(params.lstm, state):
        x, fin = layer(layer_params, x, layer_state, n_valid)
        new_states.append(fin)
    y = torch.matmul(x, params.linear2.kernel) + params.linear2.bias
    return y, tuple(new_states)
