"""The port's graph nets (a3gc_tpu_torch.models.nets.graph_net_apply, on
the CPU) against the JAX graph_net_apply on its XLA scan, for the a3gc,
aagc and agc cells, with and without a frame mask.

With a mask, the JAX scan emits each step's own output on masked frames
and the port tanh of the carried h, so outputs are compared on valid
frames; the carried states are compared whole. Tolerance 1e-5 absolute:
fp32 on both sides, sums reordered over an 8-frame recurrence and two
graph convolutions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.models import nets as JN
from a3gc_tpu_torch.compat.from_jax import graph_net_params_from_jax
from a3gc_tpu_torch.models import nets as TN

from torch_port_oracle import jax_graph_net, to_jnp

TOL = 1e-5
H = 8


def _port_cfg(jcfg):
    return TN.GraphNetConfig(cell=jcfg.cell, units_in=jcfg.units_in,
                             units_out=jcfg.units_out,
                             units_hidden=jcfg.units_hidden)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cell", ["a3gc", "aagc", "agc"])
def test_torch_port_graph_net_matches_jax(cell, masked):
    B, T = 2, 8
    jcfg, params = jax_graph_net(cell, 15, 9, H, seed=11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(B, T, 15, 15)).astype(np.float32)
    h = (0.5 * rng.normal(size=(2, B, 15, H))).astype(np.float32)
    c = (0.5 * rng.normal(size=(2, B, 15, H))).astype(np.float32)
    lengths = np.array([T, 5]) if masked else np.array([T, T])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)

    ref_y, (ref_h, ref_c) = JN.graph_net_apply(
        to_jnp(params), jcfg, jnp.asarray(x), (h, c),
        frame_mask=jnp.asarray(mask) if masked else None)
    p = graph_net_params_from_jax(params, device="cpu")
    with torch.no_grad():
        y, (hn, cn) = TN.graph_net_apply(
            p, _port_cfg(jcfg), x, (torch.from_numpy(h), torch.from_numpy(c)),
            frame_mask=mask if masked else None, device="cpu")
    assert y.shape == (B, T, 15, 9)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(y[b, :n].numpy(), np.asarray(ref_y)[b, :n],
                                   atol=TOL)
    np.testing.assert_allclose(hn.numpy(), np.asarray(ref_h), atol=TOL)
    np.testing.assert_allclose(cn.numpy(), np.asarray(ref_c), atol=TOL)


def test_torch_port_graph_net_zero_state_default():
    """No state given: both packages start from zeros."""
    jcfg, params = jax_graph_net("a3gc", 12, 3, H, seed=13)
    x = np.random.default_rng(14).normal(size=(1, 6, 15, 12)).astype(
        np.float32)
    ref_y, (ref_h, _) = JN.graph_net_apply(to_jnp(params), jcfg,
                                           jnp.asarray(x))
    p = graph_net_params_from_jax(params, device="cpu")
    with torch.no_grad():
        y, (hn, _) = TN.graph_net_apply(p, _port_cfg(jcfg), x, device="cpu")
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=TOL)
    np.testing.assert_allclose(hn.numpy(), np.asarray(ref_h), atol=TOL)


def test_torch_port_init_graph_net_shapes_match_jax():
    """torch.Generator init: the JAX layouts and distributions' supports
    (zero biases, template adjacency), different bits."""
    from a3gc_tpu_torch.data import load_adjacency_template
    jcfg, jparams = jax_graph_net("a3gc", 12, 9, H, seed=15)
    cfg = _port_cfg(jcfg)
    p = TN.init_graph_net(torch.Generator().manual_seed(0), cfg,
                          load_adjacency_template())
    for name, t in p.named_parameters():
        ref = jparams
        for part in name.split("."):
            ref = getattr(ref, part)
        assert tuple(t.shape) == np.shape(ref), name
    nira = load_adjacency_template()
    np.testing.assert_array_equal(p.rnn1.adj[0, 2].detach().numpy(), nira.T)
    assert not p.rnn1.bias.detach().any()
    with pytest.raises(ValueError, match="unknown cell"):
        TN.GraphNetConfig(cell="gru")
