"""The port's ``forward_offline`` and ``pose_loss`` (a3gc_tpu_torch.models
.pipeline) against the JAX package's on the CPU, and the refusal of a frame
mask that is not a ones-prefix at every entry point that takes one
(``graph_net_apply``, ``dip_apply``, ``pose_net_forward``,
``cascade_apply``): the layers take per-row lengths, so such a mask would be
read as its row sums. Tolerance 1e-5 absolute on the nets (fp32, 8-frame
recurrences), 1e-4 on poses after IK and 1e-6 on the loss (one sum of
squares)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu_torch.compat.from_jax import (dip_params_from_jax,
                                            graph_net_params_from_jax)
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import cascades, jax_dip, jax_graph_net, to_jnp

torch.set_num_threads(1)

TOL = 1e-5
POSE_TOL = 1e-4
H = 8


@pytest.fixture(scope="module")
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


def _net(kind, rotsize):
    """(JAX PoseNetConfig, port PoseNetConfig, port params, JAX params,
    input feature shape) of one stage-3 net."""
    out = rotsize
    if kind == "dip_uni":
        jnet, params = jax_dip(60, 15 * out, H, seed=31, bidirectional=False)
        tnet = TN.DIPConfig(n_input=60, n_output=15 * out, n_hidden=H,
                            bidirectional=False)
        return (JPL.PoseNetConfig(net=jnet, rotsize=rotsize),
                TPL.PoseNetConfig(net=tnet, rotsize=rotsize),
                dip_params_from_jax(params, device="cpu"), params, (60,))
    jnet, params = jax_graph_net(kind, 15, out, H, seed=32)
    tnet = TN.GraphNetConfig(cell=kind, units_in=15, units_out=out,
                             units_hidden=H)
    return (JPL.PoseNetConfig(net=jnet, rotsize=rotsize),
            TPL.PoseNetConfig(net=tnet, rotsize=rotsize),
            graph_net_params_from_jax(params, device="cpu"), params, (15, 15))


@pytest.mark.parametrize("kind,rotsize", [("a3gc", 9), ("ggru", 6),
                                          ("a3gc", 3), ("dip_uni", 9)])
def test_torch_port_forward_offline_matches_jax(jax_model, kind, rotsize):
    jcfg, tcfg, tparams, params, feat = _net(kind, rotsize)
    B, T = 2, 8
    imu = np.random.default_rng(33).normal(size=(B, T) + feat).astype(
        np.float32)
    want = np.asarray(JPL.forward_offline(to_jnp(params), jcfg, jax_model,
                                          jnp.asarray(imu)))
    got = TPL.forward_offline(tparams, tcfg, ParametricModel(),
                              torch.from_numpy(imu)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=TOL if rotsize == 3 else POSE_TOL)


@pytest.mark.parametrize("case", ["plain", "weighted", "frame_mask",
                                  "sample_weight", "empty_mask"])
def test_torch_port_pose_loss_matches_jax(case):
    rng = np.random.default_rng(34)
    B, T, F = 3, 5, 9
    pred = rng.normal(size=(B, T, 15, F)).astype(np.float32)
    target = rng.normal(size=(B, T, 15, F)).astype(np.float32)
    kw = {}
    if case == "weighted":
        kw["loss_weight"] = rng.uniform(size=(F,)).astype(np.float32)
    if case in ("frame_mask", "empty_mask"):
        mask = (np.arange(T)[None] < np.array([[5], [2], [0]])).astype(
            np.float32)
        kw["frame_mask"] = mask * (case == "frame_mask")
    if case == "sample_weight":
        kw["sample_weight"] = np.array([1.0, 1.0, 0.0], np.float32)
    want = float(JPL.pose_loss(jnp.asarray(pred), jnp.asarray(target),
                               **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = TPL.pose_loss(torch.from_numpy(pred), torch.from_numpy(target),
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dim() == 0
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))
    if case == "sample_weight":
        with pytest.raises(ValueError, match="excludes frame_mask"):
            TPL.pose_loss(torch.from_numpy(pred), torch.from_numpy(target),
                          frame_mask=torch.ones(B, T),
                          sample_weight=torch.ones(B))


def _holed_mask(B, T):
    """Row 1 has a valid frame after a masked one."""
    mask = np.ones((B, T), np.float32)
    mask[1, 2] = 0.0
    return mask


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("entry", ["graph_net_apply", "dip_apply",
                                   "pose_net_forward", "cascade_apply"])
def test_torch_port_mask_not_a_ones_prefix_raises(entry, as_tensor):
    B, T = 2, 6

    def mask_of(m):
        return torch.from_numpy(m) if as_tensor else m

    ends = np.ones((B, T), np.float32)
    ends[0, 4:] = 0.0                 # end padding and a whole idle row
    ends[1] = 0.0
    rng = np.random.default_rng(35)
    if entry == "cascade_apply":
        _, tcfg, params = cascades("a3gc", hidden=H)
        from a3gc_tpu_torch.compat.from_jax import cascade_params_from_jax
        p3 = cascade_params_from_jax(params, device="cpu")
        imu = rng.normal(size=(B, T, 15, 12)).astype(np.float32)

        def call(m):
            return TPL.cascade_apply(p3, tcfg, ParametricModel(), imu,
                                     frame_mask=mask_of(m), device="cpu")
    else:
        dense = entry == "dip_apply"
        _, tcfg, tparams, _, feat = _net("dip_uni" if dense else "a3gc", 3)
        x = rng.normal(size=(B, T) + feat).astype(np.float32)

        def call(m):
            if entry == "pose_net_forward":
                return TPL.pose_net_forward(tparams, tcfg,
                                            torch.from_numpy(x),
                                            frame_mask=mask_of(m))
            apply = TN.dip_apply if dense else TN.graph_net_apply
            return apply(tparams, tcfg.net, x, frame_mask=mask_of(m),
                         device="cpu")
    with torch.no_grad():
        call(ends)                                    # ones-prefix rows run
        with pytest.raises(ValueError, match="row 1 is not a ones-prefix"):
            call(_holed_mask(B, T))


def test_torch_port_check_ones_prefix_skips_the_cards_masks():
    """A mask already on the card is not pulled back to check it (the
    sessions' own whole-row masks would otherwise sync every window); on
    the host, a mask of another rank is refused."""
    TN.check_ones_prefix(None)
    TN.check_ones_prefix(torch.ones(2, 3, device="meta"))
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        TN.check_ones_prefix(np.ones(3))
    TN.check_ones_prefix([[1, 1, 0], [0, 0, 0]])
