r"""Reference ``.tar`` checkpoints → the port's modules (counterpart of
``a3gc_tpu/compat/torch_import.py``).

The reference ships trained checkpoints as ``{'epoch': int, 'state_dict':
OrderedDict}``. This module turns such a state dict into the port's
parameter modules, in the JAX layouts the port keeps (see
``a3gc_tpu_torch/models/cells.py``):

  * dense kernels: torch [out, in] → [in, out] (transpose);
  * adjacency matrices → the left-multiplying orientation:
      - the AAGC/A3GC per-gate adjacencies and the graph-conv ``adj``: the
        reference computes ``einsum('bnf,nm->bmf', x, adj.t())`` = stored ⋅
        x, so the stored tensor IS the left-multiplier — copied as stored;
      - AGC's shared ``adjacency`` and G-GRU's ``adjacency``: the reference
        computes ``einsum('nm,bmf->bnf', adj.t(), x)`` = storedᵀ ⋅ x —
        transposed (AGC's broadcast to the four gates);
  * the four gate kernels/biases are fused on the gate axis in the order
    i, f, c, o; G-GRU's ``dense_{r,u,c}_{in,hid}`` are concatenated;
  * cuDNN LSTM weights keep torch's i, f, g, o gate blocks, transposed
    only.

Every module is built from fresh tensors on the CPU and then moved to
``device`` (``cuda`` unless the caller asks for the CPU), so the
reference's own aliasing of its adjacency Parameters never reaches the
port. Given ``cfg``, the net's config, every tensor is first held to the
shape a net of that config has, and one of another width raises
``ValueError`` naming the key and both shapes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from a3gc_tpu_torch.compat.torch_export import (dip_state_dict,
                                                graph_net_state_dict)
from a3gc_tpu_torch.data import load_adjacency_template
from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.utils.checkpoint import check_shapes

__all__ = ["load_torch_checkpoint", "graph_net_params_from_state_dict",
           "dip_params_from_state_dict"]

GATE_ORDER = ("i", "f", "c", "o")


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    r"""Load a reference ``.tar`` checkpoint into a flat numpy state
    dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _strip_prefix(sd: Mapping, prefix: str) -> Dict:
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return out if out else dict(sd)


def _a(v) -> np.ndarray:
    r"""A fresh contiguous fp32 copy: no module shares memory with the
    state dict, and no parameter keeps a transposed layout."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, np.float32)


def _at(v) -> np.ndarray:
    r"""torch [out, in] → [in, out], contiguous."""
    return np.ascontiguousarray(_a(v).T)


def _graph_conv(sd, base: str) -> C.GraphConvParams:
    return C.GraphConvParams(kernel=_at(sd[f"{base}.gcn_kernel"]),
                             adj=_a(sd[f"{base}.adj"]),
                             bias=_a(sd[f"{base}.gcn_bias"]))


def _attention(sd, base: str) -> C.AttentionParams:
    return C.AttentionParams(
        w=_at(sd[f"{base}.attention_w"]),
        wq=_at(sd[f"{base}.attention_wq"]),
        wh=_at(sd[f"{base}.attention_wh"]),
        u=_at(sd[f"{base}.attention_u"]),
        bs=_a(sd[f"{base}.attention_bs"]),
        bu=_a(sd[f"{base}.attention_bu"]))


def _gcn_lstm_cell(sd, base: str, cell: str) -> C.GCNLSTMCellParams:
    kernel = np.concatenate(
        [_at(sd[f"{base}.gcn_kernel_{g}"]) for g in GATE_ORDER], axis=1)
    bias = np.stack([_a(sd[f"{base}.gcn_bias_{g}"]) for g in GATE_ORDER])
    if cell == "agc":
        # one shared fixed adjacency, applied as storedᵀ
        a = _at(sd[f"{base}.adjacency"])
        adj = np.broadcast_to(a[None], (4,) + a.shape).copy()
    else:
        # per-gate adjacencies, applied as stored
        adj = np.stack([_a(sd[f"{base}.adjacency_{g}"]) for g in GATE_ORDER])
    attention = (_attention(sd, base) if f"{base}.attention_w" in sd
                 else None)
    return C.GCNLSTMCellParams(kernel=kernel, adj=adj, bias=bias,
                               attention=attention)


def _ggru_cell(sd, base: str) -> C.GGRUCellParams:
    def lin_w(name):
        return _at(sd[f"{base}.{name}.weight"])

    def lin_b(name):
        return _a(sd[f"{base}.{name}.bias"])

    gates = ("dense_r", "dense_u", "dense_c")
    return C.GGRUCellParams(
        w_in=np.concatenate([lin_w(g + "_in") for g in gates], axis=1),
        b_in=np.concatenate([lin_b(g + "_in") for g in gates]),
        w_hid=np.concatenate([lin_w(g + "_hid") for g in gates], axis=1),
        gcn_kernel=_at(sd[f"{base}.gcn_kernel"]),
        adj=_at(sd[f"{base}.adjacency"]))


def graph_net_params_from_state_dict(
        sd: Mapping, cell: str, prefix: str = "pose_net.", *,
        cfg: Optional[N.GraphNetConfig] = None,
        device="cuda") -> N.GraphNetParams:
    r"""A reference PoseNet / PoseNet3 / PoseNet_AGC / PoseNet_GGRU state
    dict (keys ``pose_net.{linear_in,rnn1,rnn2,linear_out}``,
    ``rnnX.directions.{0,1}.cell.*``; numpy arrays or tensors) → the port's
    ``GraphNetParams`` on ``device``. ``cfg`` (its ``cell`` must be
    ``cell``) holds every tensor to that config's shapes first."""
    sd = _strip_prefix(sd, prefix)
    if cfg is not None:
        if cfg.cell != cell:
            raise ValueError(f"cell {cell!r} given with a config of cell "
                             f"{cfg.cell!r}")
        template = N.init_graph_net(torch.Generator().manual_seed(0), cfg,
                                    load_adjacency_template())
        check_shapes(sd, graph_net_state_dict(template, cell, ""),
                     f"{cell} graph net")

    def cell_pair(rnn: str):
        def make(d):
            base = f"{rnn}.directions.{d}.cell"
            return (_ggru_cell(sd, base) if cell == "ggru"
                    else _gcn_lstm_cell(sd, base, cell))
        return L.stack_directions(make(0), make(1))

    return N.GraphNetParams(
        linear_in=_graph_conv(sd, "linear_in"), rnn1=cell_pair("rnn1"),
        rnn2=cell_pair("rnn2"), linear_out=_graph_conv(sd, "linear_out"),
    ).to(device)


def dip_params_from_state_dict(sd: Mapping, prefix: str = "pose_net.",
                               n_layers: int = 2, bidirectional: bool = True,
                               *, cfg: Optional[N.DIPConfig] = None,
                               device="cuda") -> N.DIPParams:
    r"""A reference DIP / PoseNetTP / PoseNetDIP state dict (keys
    ``pose_net.{linear1,linear2,rnn.weight_ih_l{k}[_reverse]}``,
    torch.nn.LSTM naming) → the port's ``DIPParams`` on ``device``: per
    layer a direction-stacked ``LSTMLayerParams`` (bidirectional) or an
    unstacked one. ``cfg`` gives ``n_layers`` and ``bidirectional`` and
    holds every tensor to its shapes first."""
    sd = _strip_prefix(sd, prefix)
    if cfg is not None:
        n_layers, bidirectional = cfg.n_layers, cfg.bidirectional
        template = N.init_dip(torch.Generator().manual_seed(0), cfg)
        check_shapes(sd, dip_state_dict(template, ""), "DIP net")

    def dense(base):
        return N.DenseParams(kernel=_at(sd[f"{base}.weight"]),
                             bias=_a(sd[f"{base}.bias"]))

    def lstm_dir(layer, reverse):
        sfx = f"l{layer}" + ("_reverse" if reverse else "")
        return N.LSTMLayerParams(w_ih=_at(sd[f"rnn.weight_ih_{sfx}"]),
                                 w_hh=_at(sd[f"rnn.weight_hh_{sfx}"]),
                                 b_ih=_a(sd[f"rnn.bias_ih_{sfx}"]),
                                 b_hh=_a(sd[f"rnn.bias_hh_{sfx}"]))

    layers = [L.stack_directions(lstm_dir(k, False), lstm_dir(k, True))
              if bidirectional else lstm_dir(k, False)
              for k in range(n_layers)]
    return N.DIPParams(linear1=dense("linear1"), lstm=layers,
                       linear2=dense("linear2")).to(device)
