"""The port's serving path end to end on the CPU against the JAX package:
cascade_apply, and StreamingCascade over three windows with normalization,
a per-slot reset and an idle slot. Active-slot poses and every carried
state are compared (idle slots' poses are undefined in both packages).
Tolerance 1e-5 absolute: fp32, three stages of 8-frame recurrences, then a
3×3 product per joint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.data import load_adjacency_template
from a3gc_tpu.eval.streaming import StreamingCascade as JaxStreamingCascade
from a3gc_tpu.models import nets as JN
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu_torch.compat.from_jax import cascade_params_from_jax
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.eval.streaming import StreamingCascade
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import perturbed, to_jnp

TOL = 1e-5
H = 8


def _cascades(rotsize, cell="a3gc"):
    def j(ui, uo, rot):
        return JPL.PoseNetConfig(net=JN.GraphNetConfig(
            cell=cell, units_in=ui, units_out=uo, units_hidden=H,
            backend="xla"), rotsize=rot)

    def t(ui, uo, rot):
        return TPL.PoseNetConfig(net=TN.GraphNetConfig(
            cell=cell, units_in=ui, units_out=uo, units_hidden=H),
            rotsize=rot)

    out3 = 9 if rotsize == 9 else 6
    jcfg = JPL.CascadeConfig(stage1=j(12, 3, 3), stage2=j(15, 3, 3),
                             stage3=j(15, out3, rotsize))
    tcfg = TPL.CascadeConfig(stage1=t(12, 3, 3), stage2=t(15, 3, 3),
                             stage3=t(15, out3, rotsize))
    nira = load_adjacency_template()
    params = tuple(perturbed(JPL.init_pose_net(jax.random.PRNGKey(i), c,
                                               nira), seed=20 + i)
                   for i, c in enumerate((jcfg.stage1, jcfg.stage2,
                                          jcfg.stage3)))
    return jcfg, tcfg, params


@pytest.fixture(scope="module")
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


@pytest.mark.parametrize("rotsize", [9, 6])
def test_torch_port_cascade_apply_matches_jax(jax_model, rotsize):
    jcfg, tcfg, params = _cascades(rotsize)
    B, T = 2, 8
    rng = np.random.default_rng(30)
    imu = rng.normal(size=(B, T, 15, 12)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0.0
    ref = np.asarray(JPL.cascade_apply(to_jnp(params), jcfg, jax_model,
                                       jnp.asarray(imu),
                                       frame_mask=jnp.asarray(mask)))
    out = TPL.cascade_apply(cascade_params_from_jax(params, device="cpu"),
                            tcfg, ParametricModel(), imu, frame_mask=mask,
                            device="cpu").numpy()
    assert out.shape == (B * T, 24, 3, 3)
    valid = mask.reshape(-1) > 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=TOL)


def _assert_states_close(ours, ref):
    for (h, c), (rh, rc) in zip(ours, ref):
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=TOL)


def test_torch_port_streaming_cascade_matches_jax(jax_model):
    jcfg, tcfg, params = _cascades(9)
    S, W = 2, 6
    stats = load_stats()
    ref = JaxStreamingCascade(to_jnp(params), jcfg, jax_model, window=W,
                              stats=stats, normalize=True, streams=S)
    sess = StreamingCascade(cascade_params_from_jax(params, device="cpu"),
                            tcfg, ParametricModel(), window=W, stats=stats,
                            normalize=True, streams=S, device="cpu")
    rng = np.random.default_rng(31)
    plan = [None, "reset1", np.array([0.0, 1.0], np.float32), None]
    for item in plan:
        if isinstance(item, str):
            ref.reset(stream=1)
            sess.reset(stream=1)
            _assert_states_close(sess._states, ref._states)
            continue
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(size=(S, W, 18)).astype(np.float32)
        want = ref.step(ori, acc, active=item)
        got = sess.step(ori, acc, active=item)
        assert got.shape == (S, W, 24, 3, 3) and isinstance(got, np.ndarray)
        active = np.ones(S, bool) if item is None else item.astype(bool)
        np.testing.assert_allclose(got[active], want[active], atol=TOL)
        _assert_states_close(sess._states, ref._states)


def test_torch_port_streaming_rejects_unported_modes():
    _, tcfg, params = _cascades(9)
    p3 = cascade_params_from_jax(params, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        StreamingCascade(p3, tcfg, ParametricModel(), mesh=object(),
                         device="cpu")
    # lookahead/history, flush, step_async and run_windows are ported: a
    # buffered session builds, and a plain one has nothing to flush
    sess = StreamingCascade(p3, tcfg, ParametricModel(), lookahead=1,
                            history=1, device="cpu")
    assert (sess.lookahead, sess.history, sess.fused) == (1, 1, True)
    assert sess.flush() is None
    plain = StreamingCascade(p3, tcfg, ParametricModel(), fused=True,
                             device="cpu")
    assert plain.flush() is None and plain.fused is False
    with pytest.raises(ValueError, match=">= 0"):
        StreamingCascade(p3, tcfg, ParametricModel(), lookahead=-1,
                         device="cpu")
