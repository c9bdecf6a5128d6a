"""The port's evaluation of the dense-LSTM families against the JAX
package's, as ``test_torch_port_eval.py`` does for A3GC: the TransPose
cascade through ``CascadeEvaluator`` (``evaluate``, ``evaluate_batched``,
``evaluate_streaming`` at W = 30, K = P = 1) and the DIP net through
``DipEvaluator`` (``evaluate``, ``evaluate_streaming`` at W = 30, K = P = 1,
one slot and two), hidden 8, on ragged 70, 130 and 200-frame sequences:
within 1e-3 on every entry of the [5, 2] table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.eval import run as JR
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu.smpl import load_parametric_model as jax_load
from a3gc_tpu.smpl import write_synthetic_smpl_pickle
from a3gc_tpu_torch.compat.from_jax import (cascade_params_from_jax,
                                            dip_params_from_jax)
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.eval import run as TR
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL
from a3gc_tpu_torch.smpl import load_parametric_model

from torch_port_oracle import cascades, eval_sequences, jax_dip, to_jnp

torch.set_num_threads(1)

TABLE_TOL = 1e-3
LENGTHS = (70, 130, 200)
W, K, P = 30, 1, 1


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_synthetic_smpl_pickle(
        str(tmp_path_factory.mktemp("smpl") / "smpl.pkl"), n_vertices=192)
    return load_parametric_model(path, device="cpu"), jax_load(path)


@pytest.fixture(scope="module")
def seqs():
    return eval_sequences(LENGTHS, seed=7)


@pytest.fixture(scope="module")
def tp(models):
    jcfg, tcfg, params = cascades("tp")
    stats = load_stats()
    ref = JR.CascadeEvaluator(tuple(jax.tree_util.tree_map(jnp.asarray, p)
                                    for p in params), jcfg, models[1], stats,
                              normalize=True)
    ours = TR.CascadeEvaluator(cascade_params_from_jax(params, "cpu"), tcfg,
                               models[0], stats, normalize=True, device="cpu")
    return ours, ref


@pytest.fixture(scope="module")
def dip(models):
    jnet, params = jax_dip(60, 135, 8, seed=9)
    stats = load_stats()
    ref = JR.DipEvaluator(to_jnp(params), JPL.PoseNetConfig(net=jnet),
                          models[1], stats)
    tcfg = TPL.PoseNetConfig(net=TN.DIPConfig(n_input=60, n_output=135,
                                              n_hidden=8))
    ours = TR.DipEvaluator(dip_params_from_jax(params, "cpu"), tcfg,
                           models[0], stats, device="cpu")
    return ours, ref


def _table(got, want):
    assert got.shape == want.shape == (5, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TABLE_TOL)


@pytest.mark.parametrize("protocol", ["evaluate", "evaluate_batched",
                                      "evaluate_streaming"])
def test_torch_port_tp_evaluation_matches_jax(tp, seqs, protocol):
    ours, ref = tp
    kw = {"evaluate": {}, "evaluate_batched": {"streams": 2},
          "evaluate_streaming": {"window": W, "lookahead": K,
                                 "history": P}}[protocol]
    got, _, frames = getattr(ours, protocol)(seqs, **kw)
    want, _, want_frames = getattr(ref, protocol)(seqs, **kw)
    _table(got, want)
    assert frames == want_frames == sum(LENGTHS)


def test_torch_port_dip_evaluate_matches_jax(dip, seqs):
    ours, ref = dip
    got, seconds, frames = ours.evaluate(seqs)
    want, _, want_frames = ref.evaluate(seqs)
    _table(got, want)
    assert frames == want_frames == sum(LENGTHS) and seconds > 0
    assert ours.split["metrics_s"] > 0


@pytest.mark.parametrize("batch_streams", [1, 2])
def test_torch_port_dip_evaluate_streaming_matches_jax(dip, seqs,
                                                       batch_streams):
    ours, ref = dip
    got, _, frames = ours.evaluate_streaming(
        seqs, window=W, lookahead=K, history=P, batch_streams=batch_streams)
    want, _, _ = ref.evaluate_streaming(
        seqs, window=W, lookahead=K, history=P, batch_streams=batch_streams)
    _table(got, want)
    assert frames == sum(LENGTHS)


@pytest.mark.parametrize("fmt", ["fp32", "tf32"])
def test_torch_port_dip_evaluate_poses_are_the_inline_steps(dip, seqs, fmt,
                                                            monkeypatch):
    """``DipEvaluator.evaluate`` scores the poses of ``forward_offline``
    (the single net's whole step), bit for bit those of the steps it
    strung together inline before: the prep, ``pose_net_forward``, then
    ``_stage_out`` and IK; at fp32 and with the nets' products on TF32
    operands, as on a card."""
    ours, _ = dip
    monkeypatch.setattr(TN, "operand_format", lambda precision, dev: fmt)
    scored = []
    score = ours._score

    def keep(poses, gts, t0):
        scored.extend(poses)
        return score(poses, gts, t0)

    monkeypatch.setattr(ours, "_score", keep)
    ours.evaluate(seqs)
    assert len(scored) == len(seqs)
    with torch.no_grad():
        for seq, got in zip(seqs, scored):
            out, _ = TPL.pose_net_forward(ours.params, ours.cfg,
                                          ours._prep(seq))
            want = TPL.reduced_global_to_full_local(
                TPL._stage_out(out, ours.cfg.rotsize), ours.model,
                rotsize=ours.cfg.rotsize)
            assert got.shape == (seq["ori"].shape[0], 24, 3, 3)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
