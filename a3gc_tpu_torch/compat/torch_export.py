r"""The port's modules → reference ``.tar`` checkpoints (counterpart of
``a3gc_tpu/compat/torch_export.py``): the exact inverse of
:mod:`a3gc_tpu_torch.compat.torch_import`.

A net served or trained with the port can be handed back to the
reference's torch tooling, and to the JAX package's importer, as
``{'epoch': int, 'state_dict': OrderedDict}`` with the reference's key
schema and tensor layouts:

  * dense kernels: [in, out] → torch [out, in];
  * the AAGC/A3GC per-gate adjacencies are written as they are; AGC's
    shared adjacency and G-GRU's are transposed back;
  * the fused gate kernels/biases are split into per-gate tensors
    (i, f, c, o); cuDNN LSTM blocks keep torch's gate order;
  * G-GRU cells also carry the fixed adjacency template as the Parameter
    ``a``, unused by the reference's forward but required by its strict
    ``load_state_dict``.

Key order and values equal the JAX exporter's on the same parameters.
"""

from __future__ import annotations

import collections
from typing import Dict

import numpy as np
import torch
from torch import nn

from a3gc_tpu_torch.models import nets as N

__all__ = ["graph_net_state_dict", "dip_state_dict",
           "save_torch_checkpoint"]

GATE_ORDER = ("i", "f", "c", "o")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _take_dir(params2: nn.Module, d: int) -> Dict[str, torch.Tensor]:
    r"""Direction ``d`` of a direction-stacked container, as a flat dict
    of its tensors by dotted name."""
    return {k: v[d] for k, v in params2.named_parameters()}


def _graph_conv_sd(p, base: str, out: Dict[str, np.ndarray]):
    out[f"{base}.gcn_kernel"] = _np(p.kernel).T
    out[f"{base}.adj"] = _np(p.adj)
    out[f"{base}.gcn_bias"] = _np(p.bias)


def _gcn_lstm_cell_sd(p, base: str, cell: str, out: Dict[str, np.ndarray]):
    H = p["bias"].shape[-1]
    for g, name in enumerate(GATE_ORDER):
        out[f"{base}.gcn_kernel_{name}"] = _np(
            p["kernel"][:, g * H:(g + 1) * H]).T
        out[f"{base}.gcn_bias_{name}"] = _np(p["bias"][g])
        if cell != "agc":
            out[f"{base}.adjacency_{name}"] = _np(p["adj"][g])
    if cell == "agc":
        out[f"{base}.adjacency"] = _np(p["adj"][0]).T
    if "attention.w" in p:
        for name in ("w", "wq", "wh", "u"):
            out[f"{base}.attention_{name}"] = _np(p[f"attention.{name}"]).T
        out[f"{base}.attention_bs"] = _np(p["attention.bs"])
        out[f"{base}.attention_bu"] = _np(p["attention.bu"])


def _ggru_cell_sd(p, base: str, out: Dict[str, np.ndarray], nira):
    H = p["w_in"].shape[1] // 3
    for i, name in enumerate(("dense_r", "dense_u", "dense_c")):
        cols = slice(i * H, (i + 1) * H)
        out[f"{base}.{name}_in.weight"] = _np(p["w_in"][:, cols]).T
        out[f"{base}.{name}_in.bias"] = _np(p["b_in"][cols])
        out[f"{base}.{name}_hid.weight"] = _np(p["w_hid"][:, cols]).T
    out[f"{base}.gcn_kernel"] = _np(p["gcn_kernel"]).T
    out[f"{base}.adjacency"] = _np(p["adj"]).T
    out[f"{base}.a"] = np.asarray(nira, np.float32)


def graph_net_state_dict(params: N.GraphNetParams, cell: str,
                         prefix: str = "pose_net.",
                         nira: np.ndarray = None) -> Dict[str, np.ndarray]:
    r"""Reference-schema state dict of a graph net (inverse of
    ``graph_net_params_from_state_dict``). ``nira`` is the fixed adjacency
    template the net was built with (G-GRU checkpoints carry it as ``a``);
    it defaults to the port's copy of the packaged template."""
    if cell == "ggru" and nira is None:
        from a3gc_tpu_torch.data import load_adjacency_template
        nira = load_adjacency_template()
    out: Dict[str, np.ndarray] = {}
    _graph_conv_sd(params.linear_in, f"{prefix}linear_in", out)
    for rnn in ("rnn1", "rnn2"):
        for d in (0, 1):
            base = f"{prefix}{rnn}.directions.{d}.cell"
            p = _take_dir(getattr(params, rnn), d)
            if cell == "ggru":
                _ggru_cell_sd(p, base, out, nira)
            else:
                _gcn_lstm_cell_sd(p, base, cell, out)
    _graph_conv_sd(params.linear_out, f"{prefix}linear_out", out)
    return out


def dip_state_dict(params: N.DIPParams, prefix: str = "pose_net."
                   ) -> Dict[str, np.ndarray]:
    r"""Reference-schema state dict of a DIP / TransPose LSTM net,
    bidirectional or not (torch.nn.LSTM key naming; inverse of
    ``dip_params_from_state_dict``)."""
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}linear1.weight"] = _np(params.linear1.kernel).T
    out[f"{prefix}linear1.bias"] = _np(params.linear1.bias)
    for layer, lp in enumerate(params.lstm):
        bidirectional = lp.w_ih.dim() == 3
        for d in range(2 if bidirectional else 1):
            t = (_take_dir(lp, d) if bidirectional
                 else dict(lp.named_parameters()))
            sfx = f"l{layer}" + ("_reverse" if d else "")
            out[f"{prefix}rnn.weight_ih_{sfx}"] = _np(t["w_ih"]).T
            out[f"{prefix}rnn.weight_hh_{sfx}"] = _np(t["w_hh"]).T
            out[f"{prefix}rnn.bias_ih_{sfx}"] = _np(t["b_ih"])
            out[f"{prefix}rnn.bias_hh_{sfx}"] = _np(t["b_hh"])
    out[f"{prefix}linear2.weight"] = _np(params.linear2.kernel).T
    out[f"{prefix}linear2.bias"] = _np(params.linear2.bias)
    return out


def save_torch_checkpoint(path: str, state_dict: Dict[str, np.ndarray],
                          epoch: int = 0) -> str:
    r"""Write the reference's ``.tar`` format (``{'epoch',
    'state_dict'}``)."""
    sd = collections.OrderedDict(
        (k, torch.from_numpy(np.ascontiguousarray(v)))
        for k, v in state_dict.items())
    torch.save({"epoch": epoch, "state_dict": sd}, path)
    return path
