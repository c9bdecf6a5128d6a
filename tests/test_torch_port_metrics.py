"""The port's metrics (a3gc_tpu_torch.metrics), the best/worst-frame tools
(a3gc_tpu_torch.eval.worst_frames) and the report writers
(a3gc_tpu_torch.utils.logging) against the JAX package's, on one synthetic
SMPL pickle (192 vertices): the [11, 2] table of ``full_motion_metrics``
with and without ``n_valid`` padding, ``PoseEvaluator``,
``masked_global_angle_per_frame``, the basic evaluators. Within 1e-4,
relative on the large rows (jerk in m/s³, cm-scaled positions)."""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu import metrics as JM
from a3gc_tpu.eval import worst_frames as JW
from a3gc_tpu.smpl import load_parametric_model as jax_load
from a3gc_tpu.smpl import write_synthetic_smpl_pickle
from a3gc_tpu.utils import logging as JL
from a3gc_tpu_torch import metrics as TM
from a3gc_tpu_torch.eval import worst_frames as TW
from a3gc_tpu_torch.smpl import load_parametric_model
from a3gc_tpu_torch.utils import logging as TL

SIP = (1, 2, 16, 17)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_synthetic_smpl_pickle(
        str(tmp_path_factory.mktemp("smpl") / "smpl.pkl"), n_vertices=192)
    return load_parametric_model(path, device="cpu"), jax_load(path)


def _poses(n, seed, noise=0.0):
    """Smooth-ish rotation sequences [n, 24, 3, 3], optionally perturbed
    off SO(3) (the nets emit unconstrained 9D matrices)."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=0.5, size=(1, 24, 3))
    drift = rng.normal(scale=0.4, size=(1, 24, 3))
    t = np.linspace(0, 2 * np.pi, n)[:, None, None]
    r = Rotation.from_rotvec((base + drift * np.sin(t)).reshape(-1, 3))
    m = r.as_matrix().reshape(n, 24, 3, 3)
    if noise:
        m = m + noise * rng.normal(size=m.shape)
    return m.astype(np.float32)


def _close(ours, ref, rtol=1e-4, atol=1e-4):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_valid", [None, 100])
@pytest.mark.parametrize("joint_mask", [None, SIP])
@pytest.mark.parametrize("with_mesh", [True, False])
def test_torch_port_full_motion_metrics_matches_jax(models, n_valid,
                                                    joint_mask, with_mesh):
    ours, ref = models
    pp, pt = _poses(130, 1, noise=0.05), _poses(130, 2)
    got = TM.full_motion_metrics(ours, pp, pt, n_valid=n_valid,
                                 joint_mask=joint_mask, with_mesh=with_mesh)
    want = JM.full_motion_metrics(
        ref, jnp.asarray(pp), jnp.asarray(pt),
        n_valid=None if n_valid is None else jnp.asarray(n_valid),
        joint_mask=joint_mask, with_mesh=with_mesh)
    assert got.shape == (11, 2)
    _close(got, want)


def test_torch_port_full_motion_metrics_with_shape_and_translation(models):
    ours, ref = models
    rng = np.random.default_rng(3)
    pp, pt = _poses(80, 3, noise=0.02), _poses(80, 4)
    sp, st = (rng.normal(size=(80, 10)).astype(np.float32) for _ in range(2))
    tp, tt = (rng.normal(size=(80, 3)).astype(np.float32) for _ in range(2))
    got = TM.full_motion_metrics(ours, pp, pt, sp, st, tp, tt, fps=30,
                                 joint_mask=SIP)
    want = JM.full_motion_metrics(ref, *(jnp.asarray(a) for a in
                                         (pp, pt, sp, st, tp, tt)),
                                  fps=30, joint_mask=SIP)
    _close(got, want)


def test_torch_port_padded_metrics_equal_the_native_length(models):
    """End padding with n_valid scores as the sequence at its own length."""
    ours, _ = models
    pp, pt = _poses(150, 5, noise=0.05), _poses(150, 6)
    eye = np.tile(np.eye(3, dtype=np.float32), (106, 24, 1, 1))
    padded = TM.full_motion_metrics(
        ours, np.concatenate([pp, eye]), np.concatenate([pt, eye]),
        n_valid=150, joint_mask=SIP)
    native = TM.full_motion_metrics(ours, pp, pt, joint_mask=SIP)
    _close(padded, native, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_valid", [None, 90])
def test_torch_port_pose_evaluator_matches_jax(models, n_valid):
    ours, ref = models
    pp, pt = _poses(120, 7, noise=0.05), _poses(120, 8)
    got = TM.PoseEvaluator(ours)(pp.reshape(120, -1), pt, n_valid=n_valid)
    want = JM.PoseEvaluator(ref)(jnp.asarray(pp), jnp.asarray(pt),
                                 n_valid=n_valid)
    assert got.shape == (5, 2)
    _close(got, want)
    assert TM.PoseEvaluator.METRIC_NAMES == JM.PoseEvaluator.METRIC_NAMES
    assert TM.PoseEvaluator.format(got) == JM.PoseEvaluator.format(
        got.numpy())
    assert torch.equal(TM.PoseEvaluator(ours).eval(pp, pt), TM.PoseEvaluator(
        ours)(pp, pt))
    # a perfect prediction scores 0 on the angle and position rows
    perfect = TM.PoseEvaluator(ours)(pt, pt)
    assert float(perfect[:3].abs().max()) < 1e-3


def test_torch_port_full_motion_evaluator_matches_jax(models):
    ours, ref = models
    pp, pt = _poses(70, 9, noise=0.05), _poses(70, 10)
    got = TM.FullMotionEvaluator(ours, fps=60, joint_mask=[1, 2])(
        torch.as_tensor(pp), pt, n_valid=60)
    want = JM.FullMotionEvaluator(ref, fps=60, joint_mask=[1, 2])(
        jnp.asarray(pp), jnp.asarray(pt), n_valid=jnp.asarray(60))
    _close(got, want)


@pytest.mark.parametrize("joint_mask", [None, SIP])
def test_torch_port_masked_global_angle_per_frame_matches_jax(models,
                                                              joint_mask):
    ours, ref = models
    pp, pt = _poses(50, 11, noise=0.05), _poses(50, 12)
    got = TM.masked_global_angle_per_frame(ours, pp, pt, joint_mask)
    want = JM.masked_global_angle_per_frame(ref, jnp.asarray(pp),
                                            jnp.asarray(pt), joint_mask)
    assert got.shape == (50,)
    _close(got, want)


@pytest.mark.parametrize("after_sigmoid", [False, True])
def test_torch_port_binary_evaluators_match_jax(after_sigmoid):
    rng = np.random.default_rng(13)
    p = rng.normal(size=200).astype(np.float32)
    if after_sigmoid:
        p = 1 / (1 + np.exp(-p))
    t = (rng.uniform(size=200) > 0.4).astype(np.float32)
    cm = TM.binary_confusion_matrix(torch.as_tensor(p), torch.as_tensor(t),
                                    after_sigmoid)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(
        JM.binary_confusion_matrix(jnp.asarray(p), jnp.asarray(t),
                                   after_sigmoid)))
    _close(TM.binary_classification_errors(torch.as_tensor(p),
                                           torch.as_tensor(t), after_sigmoid),
           JM.binary_classification_errors(jnp.asarray(p), jnp.asarray(t),
                                           after_sigmoid), rtol=1e-6)


def test_torch_port_binary_errors_of_an_absent_class_match_jax():
    """Zero denominators give NaN in both packages, at the same places."""
    got = TM.binary_classification_errors(torch.ones(4), torch.zeros(4))
    want = JM.binary_classification_errors(jnp.ones(4), jnp.zeros(4))
    assert torch.isnan(got).any()
    _close(got, want)


@pytest.mark.parametrize("p_norm", [1, 2])
def test_torch_port_position_and_rotation_error_match_jax(p_norm):
    rng = np.random.default_rng(14)
    p = rng.normal(size=(10, 24, 3)).astype(np.float32)
    t = rng.normal(size=(10, 24, 3)).astype(np.float32)
    _close(TM.position_error(torch.as_tensor(p), torch.as_tensor(t),
                             p_norm=p_norm),
           JM.position_error(jnp.asarray(p), jnp.asarray(t), p_norm=p_norm),
           rtol=1e-6)
    a, b = _poses(10, 15, noise=0.05), _poses(10, 16)
    _close(TM.rotation_error(torch.as_tensor(a), torch.as_tensor(b)),
           JM.rotation_error(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("align_joint", [0, 3])
def test_torch_port_joint_and_mesh_errors_match_jax(models, align_joint):
    ours, ref = models
    pp, pt = _poses(20, 17, noise=0.05), _poses(20, 18)
    jp, jt = jnp.asarray(pp), jnp.asarray(pt)
    _close(TM.per_joint_errors(ours, pp, pt, align_joint),
           JM.per_joint_errors(ref, jp, jt, align_joint))
    _close(TM.mean_per_joint_errors(ours, pp, pt, align_joint),
           JM.mean_per_joint_errors(ref, jp, jt, align_joint))
    rng = np.random.default_rng(19)
    sp = rng.normal(size=(20, 10)).astype(np.float32)
    _close(TM.mesh_error(ours, pp, pt, sp, None, align_joint),
           JM.mesh_error(ref, jp, jt, jnp.asarray(sp), None,
                         align_joint=align_joint))


def test_torch_port_select_extreme_frames_matches_jax():
    rng = np.random.default_rng(20)
    scores = rng.normal(size=3000)
    for largest in (True, False):
        assert (TW.select_extreme_frames(scores, 5, 200, largest)
                == JW.select_extreme_frames(scores, 5, 200, largest))
    scores = np.zeros(2000)
    scores[[100, 150, 900, 1500]] = [10, 9, 8, 7]
    assert TW.select_extreme_frames(scores, k=3, min_separation=300) == \
        [100, 900, 1500]


def test_torch_port_compare_models_matches_jax(models, tmp_path):
    """The per-frame errors, every selection, the combined payloads and the
    reference's 18-pickle layout; ``render=True``'s PNGs."""
    ours, ref = models
    gt = _poses(700, 21)
    pred_a, pred_b = _poses(700, 21, noise=0.2), _poses(700, 22, noise=0.05)
    gts, a, b = ([x[:400], x[400:]] for x in (gt, pred_a, pred_b))
    _close(TW.per_frame_errors(ours, gts, a),
           JW.per_frame_errors(ref, gts, a))
    got = TW.compare_models(ours, gts, a, b, k=3, min_separation=100,
                            out_dir=str(tmp_path / "ours"))
    want = JW.compare_models(ref, gts, a, b, k=3, min_separation=100,
                             out_dir=str(tmp_path / "ref"))
    assert got == want
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ref")
                   for d, _, fs in os.walk(tmp_path / "ref") for f in fs)
    assert len([n for n in names if os.sep in n]) == 18
    for name in names:
        with open(tmp_path / "ours" / name, "rb") as f:
            x = pickle.load(f)
        with open(tmp_path / "ref" / name, "rb") as f:
            y = pickle.load(f)
        if isinstance(y, dict):
            assert x.keys() == y.keys()
            for k in y:
                _close(np.asarray(x[k]), np.asarray(y[k]))
        else:
            np.testing.assert_array_equal(x, y)
    # render=True: a PNG a selected frame (gt | A | B) beside the pickles,
    # as JAX draws it; FK rounding may move an edge pixel (<= 0.1 %)
    TW.compare_models(ours, gts, a, b, k=2, min_separation=100,
                      out_dir=str(tmp_path / "ours_png"), render=True,
                      render_size=64)
    JW.compare_models(ref, gts, a, b, k=2, min_separation=100,
                      out_dir=str(tmp_path / "ref_png"), render=True,
                      render_size=64)
    from PIL import Image
    pngs = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ref_png")
                  for d, _, fs in os.walk(tmp_path / "ref_png") for f in fs
                  if f.endswith(".png"))
    assert len(pngs) == 12
    for name in pngs:
        x = np.asarray(Image.open(tmp_path / "ours_png" / name))
        y = np.asarray(Image.open(tmp_path / "ref_png" / name))
        assert x.shape == y.shape == (64, 64, 3)
        assert (x != y).any(-1).mean() <= 1e-3, name


def test_torch_port_eval_report_is_byte_equal_to_jax(tmp_path):
    errors = np.random.default_rng(23).normal(size=(5, 2)).astype(np.float32)
    for mod, name in ((TL, "ours"), (JL, "ref")):
        path = str(tmp_path / name / "r.txt")
        mod.write_eval_report(path, "test.npz", 1.2345, errors,
                              TM.PoseEvaluator.METRIC_NAMES)
        mod.write_eval_report(path, "second", 2.0, errors,
                              TM.PoseEvaluator.METRIC_NAMES)
    TL.write_eval_report(str(tmp_path / "tensor.txt"), "test.npz", 1.2345,
                         torch.as_tensor(errors),
                         TM.PoseEvaluator.METRIC_NAMES)
    with open(tmp_path / "ours" / "r.txt") as f, \
            open(tmp_path / "ref" / "r.txt") as g, \
            open(tmp_path / "tensor.txt") as h:
        ours, ref, tensor = f.read(), g.read(), h.read()
    assert ours == ref and ref.startswith(tensor)


def test_torch_port_jsonl_logger(tmp_path, capsys):
    path = str(tmp_path / "logs" / "run.jsonl")
    log = TL.JsonlLogger(path)
    log({"loss": np.float32(0.5), "step": 1})
    TL.JsonlLogger(path, echo=False)({"step": 2})
    with open(path) as f:
        events = [json.loads(line) for line in f]
    assert [e["step"] for e in events] == [1, 2]
    assert events[0]["loss"] == 0.5 and "time" in events[0]
    assert json.loads(capsys.readouterr().out) == events[0]
