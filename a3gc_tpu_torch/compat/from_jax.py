r"""Parameter bridge: the JAX package's graph-net and DIP-net parameter
pytrees → the port's modules.

The functions take the pytree with numpy leaves (for example
``jax.tree_util.tree_map(np.asarray, params)``) and read its fields by
attribute name (``.linear_in.kernel``, ``.rnn1.attention.wq``, …), so the
port never imports flax or ``a3gc_tpu``. Layouts carry over unchanged: the
port keeps the JAX ones.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import nets as N

__all__ = ["cell_params_from_jax", "graph_net_params_from_jax",
           "lstm_layer_params_from_jax", "dip_params_from_jax",
           "cascade_params_from_jax"]


def _a(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _graph_conv(t) -> C.GraphConvParams:
    return C.GraphConvParams(kernel=_a(t.kernel), adj=_a(t.adj),
                             bias=_a(t.bias))


def _cell(t):
    if hasattr(t, "w_in"):
        return C.GGRUCellParams(w_in=_a(t.w_in), b_in=_a(t.b_in),
                                w_hid=_a(t.w_hid),
                                gcn_kernel=_a(t.gcn_kernel), adj=_a(t.adj))
    att = t.attention
    return C.GCNLSTMCellParams(
        kernel=_a(t.kernel), adj=_a(t.adj), bias=_a(t.bias),
        attention=None if att is None else C.AttentionParams(
            w=_a(att.w), wq=_a(att.wq), wh=_a(att.wh), u=_a(att.u),
            bs=_a(att.bs), bu=_a(att.bu)))


def cell_params_from_jax(tree, device="cuda"):
    r"""One direction-stacked JAX ``GCNLSTMCellParams`` or
    ``GGRUCellParams`` pytree (told apart by its ``w_in`` field) → the
    port's module of the same name on ``device``."""
    return _cell(tree).to(device)


def graph_net_params_from_jax(tree, device="cuda") -> N.GraphNetParams:
    r"""One JAX ``GraphNetParams`` pytree → the port's ``GraphNetParams``
    on ``device``."""
    return N.GraphNetParams(
        linear_in=_graph_conv(tree.linear_in), rnn1=_cell(tree.rnn1),
        rnn2=_cell(tree.rnn2), linear_out=_graph_conv(tree.linear_out),
    ).to(device)


def _dense(t) -> N.DenseParams:
    return N.DenseParams(kernel=_a(t.kernel), bias=_a(t.bias))


def lstm_layer_params_from_jax(t, device="cuda") -> N.LSTMLayerParams:
    r"""One direction-stacked JAX ``LSTMLayerParams`` pytree → the port's
    ``LSTMLayerParams`` on ``device``."""
    return N.LSTMLayerParams(w_ih=_a(t.w_ih), w_hh=_a(t.w_hh),
                             b_ih=_a(t.b_ih), b_hh=_a(t.b_hh)).to(device)


def dip_params_from_jax(tree, device="cuda") -> N.DIPParams:
    r"""One JAX ``DIPParams`` pytree (bidirectional) → the port's
    ``DIPParams`` on ``device``."""
    return N.DIPParams(
        linear1=_dense(tree.linear1),
        lstm=[lstm_layer_params_from_jax(t, "cpu") for t in tree.lstm],
        linear2=_dense(tree.linear2)).to(device)


def cascade_params_from_jax(trees3: Sequence, device="cuda") -> Tuple:
    r"""The three stages' pytrees → a tuple of the port's modules: DIP
    nets for a TransPose cascade (told apart by their ``lstm`` field),
    graph nets otherwise."""
    return tuple(dip_params_from_jax(t, device) if hasattr(t, "lstm")
                 else graph_net_params_from_jax(t, device) for t in trees3)
