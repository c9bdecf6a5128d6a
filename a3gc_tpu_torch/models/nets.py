r"""Graph nets and the DIP LSTM net (counterpart of
``a3gc_tpu/models/nets.py``).

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
tensor, or their plain versions; the kernels' gradients are their plain
versions' (:mod:`a3gc_tpu_torch.ops.library`).

Training (an ``rng``, a ``torch.Generator`` on the inputs' device, given):
dropout is on, and the layers take the plain path, as in the JAX package.
The graph cells step frame by frame with the input projection inside the
step, dropout on each frame's input and on the recurrent h (keep-masks
drawn for the whole window before the loop), the step rematerialized in
the backward pass (``remat``); no kernel computes that per-frame dropout.
The DIP net drops its input and runs the plain hoisted scan.

``precision`` ("highest" or "default", the JAX package's field) sets the
operand format of every product of a net (:func:`a3gc_tpu_torch.ops.
_common.operand_format`): fp32 at "highest"; at "default" TF32 operands
on a card, as XLA's ``Precision.DEFAULT`` there, and fp32 on the CPU.

Each recurrent layer call, kernel or plain, is the profiler span
``a3gc.rnn`` (:func:`a3gc_tpu_torch._runtime.span`).
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from a3gc_tpu_torch._device import check_module_device, resolve_device
from a3gc_tpu_torch._runtime import span
from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops import gcn_lstm as G
from a3gc_tpu_torch.ops import ggru as GG
from a3gc_tpu_torch.ops import lstm as LS
from a3gc_tpu_torch.ops._common import (check_precision, device_index,
                                        operand_format, sm_count)
from a3gc_tpu_torch.parallel import tensor as TP

__all__ = ["GraphNetConfig", "GraphNetParams", "init_graph_net",
           "graph_net_zero_state", "graph_net_apply", "DenseParams",
           "LSTMLayerParams", "DIPConfig", "DIPParams", "init_dip",
           "dip_zero_state", "dip_apply", "check_ones_prefix",
           "plan_refusal"]

CELL_KINDS = ("aagc", "a3gc", "agc", "ggru")
BACKENDS = ("auto", "eager", "cuda")


@dataclasses.dataclass(frozen=True)
class GraphNetConfig:
    r"""Static net hyperparameters.

    ``backend``: "auto" runs the recurrent layers through the CUDA kernel on
    CUDA tensors where it has a launch plan for their shape (else, and on
    CPU tensors, through the plain version); "eager" always runs the plain
    version; "cuda" runs the kernel or raises. The
    dropout rates and ``remat`` (rematerialize the cell step in the
    backward pass: the stored per-frame intermediates otherwise dominate
    device memory) act only in training. ``precision``: "highest" (fp32
    products) or "default" (TF32 operands on a card, fp32 on the CPU)."""

    cell: str = "a3gc"
    units_in: int = 12
    units_out: int = 9
    units_hidden: int = 256
    num_nodes: int = 15
    backend: str = "auto"
    linear_dropout: float = 0.2
    dropout: float = 0.3
    recurrent_dropout: float = 0.3
    remat: bool = True
    precision: str = "highest"

    def __post_init__(self):
        if self.cell not in CELL_KINDS:
            raise ValueError(f"unknown cell {self.cell!r}")
        _check_backend(self.backend)
        check_precision(self.precision)


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


def plan_refusal(cfg, streams: int, fmt: str, device) -> Optional[str]:
    r"""Why the kernel of ``cfg``'s recurrent layers (a
    :class:`GraphNetConfig` or a :class:`DIPConfig`) has no launch plan for
    a layer call of ``streams`` streams at operand format ``fmt`` on CUDA
    device ``device``: its module's ``plan_refusal`` (None where it has a
    plan). The key holds no input width, so rnn1 (F = H) and rnn2
    (F = 2H), and every layer of a DIP net, get the same answer: a net
    runs its kernel in every layer or in none."""
    if isinstance(cfg, DIPConfig):
        return LS.plan_refusal(streams, cfg.n_hidden,
                               sm_count(device_index(device)),
                               cfg.directions, fmt == "tf32")
    if cfg.cell == "ggru":
        return GG.plan_refusal(streams, cfg.num_nodes, cfg.units_hidden,
                               fmt == "tf32",
                               sm_count(device_index(device)))
    return G.plan_refusal(cfg.num_nodes, cfg.units_hidden,
                          cfg.cell in ("a3gc", "agc"), fmt == "tf32")


_NOTED_PLAIN = set()    # (kernel, refusal, fmt) already noted on stderr


def _pick(cfg, x: torch.Tensor, kernel_fn, plain_fn, fmt: str):
    r"""The layer function of ``cfg.backend``, at operand format ``fmt``:
    "eager" → the plain version, "cuda" → the kernel's wrapper or raise off
    the card, "auto" → the wrapper on CPU tensors (which computes the plain
    version there) and, on CUDA tensors, the wrapper where the kernel has a
    launch plan for the layer call (:func:`plan_refusal`, from the shapes,
    before anything launches), else the plain version: JAX's ``use_pallas``
    takes the XLA scan where its kernel does not fit. A plain layer call
    on a card adds one to ``kernel_fn.plain_dispatches``; the first of each
    (kernel, shape, format) notes it on stderr."""
    if cfg.backend == "cuda" and not x.is_cuda:
        raise RuntimeError("backend='cuda' needs CUDA tensors, got a tensor "
                           f"on {x.device}")
    fn = plain_fn if cfg.backend == "eager" else kernel_fn
    if cfg.backend == "auto" and x.is_cuda:
        why = plan_refusal(cfg, x.shape[0], fmt, x.device)
        if why is not None:
            if (kernel_fn.__name__, why, fmt) not in _NOTED_PLAIN:
                _NOTED_PLAIN.add((kernel_fn.__name__, why, fmt))
                print(f"note: {why}; backend='auto' runs this layer's plain "
                      f"version at operand format {fmt} on {x.device}, no "
                      "kernel launch", file=sys.stderr)

            def fn(*args):
                kernel_fn.plain_dispatches += 1
                return plain_fn(*args)

    return lambda params, inputs, state, n_valid: fn(params, inputs, state,
                                                     n_valid, fmt)


def _rnn_layer(cfg: GraphNetConfig, x: torch.Tensor, fmt: str):
    r"""The function of both recurrent layers of the net: one choice, as
    :func:`plan_refusal` gives rnn1 and rnn2 the same answer."""
    if cfg.cell == "ggru":
        return _pick(cfg, x, GG.bi_ggru, GG.bi_ggru_reference, fmt)
    return _pick(cfg, x, G.bi_gcn_lstm, G.bi_gcn_lstm_reference, fmt)


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


def _as_input(x, dev) -> torch.Tensor:
    r"""x on ``dev``: a bf16 / fp16 tensor keeps its dtype (mixed-precision
    training), anything else becomes fp32."""
    if isinstance(x, torch.Tensor) and x.dtype in (torch.bfloat16,
                                                   torch.float16):
        return x.to(dev)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _layer_in_scan(cfg: GraphNetConfig, params2, x: torch.Tensor, state,
                   frame_mask, rng, fmt: str):
    r"""One bidirectional graph layer in training: the unhoisted cell step
    in :func:`layers.bi_rnn`, with per-frame dropout on the input and on
    the recurrent h (LSTM cells; the G-GRU cell has none) from keep-masks
    drawn for the whole window, rematerialized in the backward pass when
    ``cfg.remat``. Returns (y [B, T, N, 2H], state)."""
    B, T, N, F = x.shape
    if cfg.cell == "ggru":
        step = functools.partial(C.ggru_step, fmt=fmt)
        extras, state = (), (state,)
    else:
        step = functools.partial(
            C.gcn_lstm_step, dropout_rate=cfg.dropout,
            recurrent_dropout_rate=cfg.recurrent_dropout, fmt=fmt)
        H = cfg.units_hidden
        extras = (C.keep_mask(rng, (2, T, B, N, F), cfg.dropout, x.device,
                              batch_axis=2),
                  C.keep_mask(rng, (2, T, B, N, H), cfg.recurrent_dropout,
                              x.device, batch_axis=2))
    if cfg.remat:
        step = functools.partial(checkpoint, step, use_reentrant=False,
                                 preserve_rng_state=False)
    y, state = L.bi_rnn(step, params2, x, state, frame_mask=frame_mask,
                        extras=extras)
    if cfg.cell == "ggru":
        return y, state[0]
    return torch.tanh(y), state


def graph_net_apply(params: GraphNetParams, cfg: GraphNetConfig, x,
                    state=None, frame_mask=None, *, device="cuda",
                    rng: Optional[torch.Generator] = None):
    r"""Forward pass. x [B, T, N, F_in] → ([B, T, N, F_out], new state).
    ``frame_mask`` [B, T] marks valid frames; rows must be ones-prefix (end
    padding, or a whole idle row), since the layers take per-row lengths
    ``n_valid = Σ_t frame_mask``: a host mask that is not raises
    ``ValueError`` (:func:`check_ones_prefix`). Outputs on masked frames
    are undefined; the state carries through them. ``rng`` (training): a
    ``torch.Generator`` on ``device``; dropout on, the layers stepped frame
    by frame on the plain path (:func:`_layer_in_scan`)."""
    dev = resolve_device(device)
    check_module_device(params, dev)
    fmt = operand_format(cfg.precision, dev)
    x = _as_input(x, dev)
    if state is None:
        state = graph_net_zero_state(cfg, x.shape[0], dev, x.dtype)
    n_valid = _n_valid(frame_mask, dev)
    drop_rng = None if cfg.cell == "ggru" else rng
    x = torch.relu(C.graph_conv(params.linear_in, x,
                                dropout_rate=cfg.linear_dropout,
                                rng=drop_rng, fmt=fmt))
    if rng is None:
        layer = _rnn_layer(cfg, x, fmt)
        for params2 in (params.rnn1, params.rnn2):
            with span("a3gc.rnn"):
                x, state = layer(params2, x, state, n_valid)
    else:
        mask = (None if n_valid is None else
                torch.arange(x.shape[1], device=dev)[None] < n_valid[:, None])
        for params2 in (params.rnn1, params.rnn2):
            with span("a3gc.rnn"):
                x, state = _layer_in_scan(cfg, params2, x, state, mask,
                                          drop_rng, fmt)
    return C.graph_conv(params.linear_out, x, fmt=fmt), state


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
    r"""Static DIP-net hyperparameters. ``backend`` and ``precision`` as in
    :class:`GraphNetConfig`; ``dropout`` on the input, in training only."""

    n_input: int = 60
    n_output: int = 135
    n_hidden: int = 512
    n_layers: int = 2
    bidirectional: bool = True
    backend: str = "auto"
    dropout: float = 0.2
    precision: str = "highest"

    def __post_init__(self):
        _check_backend(self.backend)
        check_precision(self.precision)

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
              frame_mask=None, *, device="cuda",
              rng: Optional[torch.Generator] = None):
    r"""DIP forward: x [B, T, n_input] → ([B, T, n_output], new state).
    ``frame_mask`` [B, T] as in :func:`graph_net_apply`: per row,
    ones-prefix; outputs on masked frames are undefined and the state
    carries through them. ``rng`` (training): dropout on the input, the
    layers on the plain path."""
    dev = resolve_device(device)
    check_module_device(params, dev)
    fmt = operand_format(cfg.precision, dev)
    x = _as_input(x, dev)
    if state is None:
        state = dip_zero_state(cfg, x.shape[0], dev, x.dtype)
    n_valid = _n_valid(frame_mask, dev)
    if rng is None:
        layer = _pick(cfg, x, LS.bi_lstm, LS.bi_lstm_reference, fmt)
    else:
        x = C._dropout(x, cfg.dropout, rng)
        layer = _pick(dataclasses.replace(cfg, backend="eager"), x, None,
                      LS.bi_lstm_reference, fmt)
    x = torch.relu(TP.matmul(x, params.linear1.kernel, fmt=fmt)
                   + TP.full(params.linear1.bias))
    new_states = []
    for layer_params, layer_state in zip(params.lstm, state):
        with span("a3gc.rnn"):
            x, fin = layer(layer_params, x, layer_state, n_valid)
        new_states.append(fin)
    y = TP.matmul(x, params.linear2.kernel, fmt=fmt) \
        + TP.full(params.linear2.bias)
    return y, tuple(new_states)
