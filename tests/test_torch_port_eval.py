"""The port's cascade evaluation (a3gc_tpu_torch.eval.run) against the JAX
package's on the A3GC cascade at hidden 8, one synthetic SMPL pickle (192
vertices) and three ragged sequences (70, 130 and 200 frames), the same
parameters and the shipped stats: ``evaluate``, ``evaluate_batched`` and
``evaluate_streaming`` (W = 30, K = P = 1) within 1e-3 on every entry of
the [5, 2] table, the predictions within 1e-4. In the port alone: batched
equals per-sequence, a sequence padded to its bucket scores as at its own
length, and the input helpers (``pose_to_r6d``, ``dip_batch``,
``load_test_sequences``, ``bucket_length``, ``prepare_graph_inputs``,
``reduced_to_full``) against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.data import pipeline as JP
from a3gc_tpu.data.factory.dipimu import load_test_sequences as jax_load_seqs
from a3gc_tpu.eval import run as JR
from a3gc_tpu.smpl import load_parametric_model as jax_load
from a3gc_tpu.smpl import write_synthetic_smpl_pickle
from a3gc_tpu_torch.compat.from_jax import cascade_params_from_jax
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.data import pipeline as TP
from a3gc_tpu_torch.data.factory.dipimu import load_test_sequences
from a3gc_tpu_torch.eval import run as TR
from a3gc_tpu_torch.smpl import ParametricModel, load_parametric_model

from torch_port_oracle import cascades, eval_sequences

torch.set_num_threads(1)

TABLE_TOL = 1e-3
POSE_TOL = 1e-4
LENGTHS = (70, 130, 200)
W, K, P = 30, 1, 1


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = write_synthetic_smpl_pickle(
        str(tmp_path_factory.mktemp("smpl") / "smpl.pkl"), n_vertices=192)
    jcfg, tcfg, params = cascades("a3gc")
    stats = load_stats()
    ref = JR.CascadeEvaluator(tuple(jax.tree_util.tree_map(jnp.asarray, p)
                                    for p in params), jcfg, jax_load(path),
                              stats, normalize=True)
    ours = TR.CascadeEvaluator(cascade_params_from_jax(params, "cpu"), tcfg,
                               load_parametric_model(path, device="cpu"),
                               stats, normalize=True, device="cpu")
    return ours, ref, eval_sequences(LENGTHS, seed=3)


@pytest.fixture(scope="module")
def port_offline(setup):
    """The port's per-sequence protocol, shared by the checks against it."""
    ours, _, seqs = setup
    return ours.evaluate(seqs, return_preds=True)


def _table(got, want):
    assert got.shape == want.shape == (5, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TABLE_TOL)


def test_torch_port_evaluate_matches_jax(setup, port_offline):
    ours, ref, seqs = setup
    mean, seconds, frames, preds = port_offline
    want, _, want_frames, want_preds = ref.evaluate(seqs, return_preds=True)
    _table(mean, want)
    assert frames == want_frames == sum(LENGTHS) and seconds > 0
    for p, q in zip(preds, want_preds):
        assert p.shape == q.shape
        np.testing.assert_allclose(p, q, rtol=0, atol=POSE_TOL)
    ours.evaluate(seqs[:1])
    assert ours.split["cascade_s"] > 0 and ours.split["metrics_s"] > 0


@pytest.mark.parametrize("streams", [2, 3])
def test_torch_port_evaluate_batched_matches_jax_and_per_sequence(
        setup, port_offline, streams):
    ours, ref, seqs = setup
    mean, _, frames = ours.evaluate_batched(seqs, streams=streams)
    _table(mean, ref.evaluate_batched(seqs, streams=streams)[0])
    # batched equals per-sequence in the port: the same math per stream,
    # sums reordered by the batch's matmuls
    np.testing.assert_allclose(mean, port_offline[0], rtol=1e-5, atol=1e-5)
    assert frames == sum(LENGTHS)


def test_torch_port_evaluate_streaming_matches_jax(setup):
    ours, ref, seqs = setup
    mean, _, frames, preds = ours.evaluate_streaming(
        seqs, window=W, lookahead=K, history=P, return_preds=True)
    want, _, _, want_preds = ref.evaluate_streaming(
        seqs, window=W, lookahead=K, history=P, return_preds=True)
    _table(mean, want)
    assert frames == sum(LENGTHS)
    for p, q in zip(preds, want_preds):
        np.testing.assert_allclose(p, q, rtol=0, atol=POSE_TOL)
    # multiplexed over two recycled slots: the same table
    multi = ours.evaluate_streaming(seqs, window=W, lookahead=K, history=P,
                                    batch_streams=2)[0]
    np.testing.assert_allclose(multi, mean, rtol=1e-5, atol=1e-5)


def test_torch_port_padded_sequence_scores_as_at_its_own_length(setup):
    """A sequence end-padded to its bucket (cascade frame mask + masked
    metrics) gives the table it gives at its own length."""
    ours, _, seqs = setup
    seq = seqs[0]
    T = seq["ori"].shape[0]
    L = TR.bucket_length(T)
    gt = TR.reduced_to_full(seq["pose"].reshape(T, 15, 3, 3))
    native, pose_n, _ = ours._run(seq["ori"][None], seq["acc"][None], [gt],
                                  [T])
    pad = ((0, 0), (0, L - T), (0, 0))
    padded, pose_p, _ = ours._run(np.pad(seq["ori"][None], pad),
                                  np.pad(seq["acc"][None], pad), [gt], [T])
    assert pose_p.shape == (1, L, 24, 3, 3)
    np.testing.assert_allclose(padded, native, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pose_p[0, :T].numpy(), pose_n[0].numpy(),
                               rtol=0, atol=1e-5)


def test_torch_port_evaluate_sequences_writes_the_report(setup,
                                                        port_offline,
                                                        tmp_path):
    ours, _, seqs = setup
    path = str(tmp_path / "evaluation_results" / "a3gc_test.npz.txt")
    mean, _, frames = TR.evaluate_sequences(
        ours.params3, ours.cfg, ours.model, seqs, stats=load_stats(),
        normalize=True, report_path=path, dataset_name="test.npz",
        device="cpu")
    np.testing.assert_allclose(mean, port_offline[0], rtol=0, atol=1e-6)
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "Dataset: test.npz" and lines[1].startswith(
        "offline time ")
    assert lines[2] == "SIP Error (deg): %.2f (+/- %.2f)" % tuple(mean[0])
    assert len(lines) == 7 and frames == sum(LENGTHS)


def test_torch_port_evaluators_refuse_mesh_and_a_model_elsewhere(setup):
    ours, _, seqs = setup
    with pytest.raises(NotImplementedError, match="item 14"):
        TR.CascadeEvaluator(ours.params3, ours.cfg, ours.model, mesh=object(),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        ours.evaluate_streaming(seqs, window=W, mesh=object())
    with pytest.raises(ValueError, match="load_parametric_model"):
        TR.CascadeEvaluator(ours.params3, ours.cfg, ParametricModel(),
                            device="cpu")
    with pytest.raises(ValueError, match="streams"):
        ours.evaluate_batched(seqs, streams=0)
    ours.warmup(LENGTHS)
    assert ours.split == {"cascade_s": 0.0, "metrics_s": 0.0}


def test_torch_port_eval_helpers_match_jax():
    assert [TR.bucket_length(n) for n in (1, 128, 129, 700, 2400)] == \
        [JR.bucket_length(n) for n in (1, 128, 129, 700, 2400)]
    seq = eval_sequences((40,), seed=4)[0]
    stats = load_stats()
    np.testing.assert_allclose(
        TR.prepare_graph_inputs(seq["ori"], seq["acc"], stats),
        JR.prepare_graph_inputs(seq["ori"], seq["acc"],
                                {k: jnp.asarray(v) for k, v in
                                 stats.items()}), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(TR.reduced_to_full(seq["pose"]),
                                  JR.reduced_to_full(seq["pose"]))


@pytest.mark.parametrize("rotsize", [9, 6])
def test_torch_port_pose_to_r6d_and_dip_batch_match_jax(rotsize):
    seq = eval_sequences((30, 30), seed=5)
    raw = {k: np.stack([s[k] for s in seq]) for k in ("ori", "acc", "pose")}
    stats = load_stats()
    for no_root in (True, False):
        got = TP.dip_batch({k: torch.as_tensor(v) for k, v in raw.items()},
                           {k: torch.as_tensor(v) for k, v in stats.items()},
                           no_root=no_root, rotsize=rotsize)
        want = JP.dip_batch({k: jnp.asarray(v) for k, v in raw.items()},
                            {k: jnp.asarray(v) for k, v in stats.items()},
                            no_root=no_root, rotsize=rotsize)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
    np.testing.assert_allclose(
        TP.pose_to_r6d(torch.as_tensor(raw["pose"])).numpy(),
        np.asarray(JP.pose_to_r6d(jnp.asarray(raw["pose"]))), rtol=0,
        atol=1e-6)


def test_torch_port_load_test_sequences_matches_jax(tmp_path):
    seqs = eval_sequences((12, 5, 9, 7, 3, 4, 8, 6, 2, 10, 11), seed=6)
    path = str(tmp_path / "test.npz")
    np.savez(path, **{f"seq{i}_{k}": v for i, s in enumerate(seqs)
                      for k, v in s.items()})
    ours, ref = load_test_sequences(path), jax_load_seqs(path)
    assert len(ours) == len(ref) == len(seqs)
    for a, b, s in zip(ours, ref, seqs):      # in sequence order: 0, 1, ...
        assert a.keys() == b.keys() == s.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], s[k])
