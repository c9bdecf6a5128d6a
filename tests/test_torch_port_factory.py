"""The port's data factory (a3gc_tpu_torch.data.factory) against the JAX
package's on the CPU: every function of ``transform`` on seeded inputs
(NaN patterns, exact-zero axis-angles, rotations at the identity, at and
near pi, off orthonormal), the three raw walkers on the same on-disk trees
(the AMASS frame-rate branches and an unreadable file, the DIP-IMU split
selection, the TotalCapture length sync), ``process_amass_split`` with and
without the mirror, ``process_dipimu`` for every split with NaNs,
``process_totalcapture`` with the faulty sequence, the npz files both
write, the frame-chunked skinning against one call, and the data root read
when a factory is called.

Sizes: a synthetic SMPL body of 160 vertices, sensor vertices (10, 20, 30,
40, 50, 60), sequences of at most 700 frames. Tolerances: 1e-5 on
rotations, positions and poses, 1e-4 on normalized accelerations; host
numpy code bit-equal."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from a3gc_tpu import config as JCFG
from a3gc_tpu.data.factory import amass as JA
from a3gc_tpu.data.factory import dipimu as JD
from a3gc_tpu.data.factory import totalcapture as JT
from a3gc_tpu.data.factory import transform as JTF
from a3gc_tpu.smpl import load_parametric_model as jax_load
from a3gc_tpu_torch import config as TCFG
from a3gc_tpu_torch.data.factory import amass as TA
from a3gc_tpu_torch.data.factory import dipimu as TD
from a3gc_tpu_torch.data.factory import totalcapture as TT
from a3gc_tpu_torch.data.factory import transform as TTF
from a3gc_tpu_torch.smpl import (load_parametric_model,
                                 write_synthetic_smpl_pickle)
from a3gc_tpu_torch.smpl.armature import SMPL_PARENT

from torch_port_raw import (assert_factory_close, write_raw_amass,
                            write_raw_dip, write_raw_totalcapture)

torch.set_num_threads(1)

VI = (10, 20, 30, 40, 50, 60)
ROT_TOL = 1e-5

# one length a corpus where the oracle runs FK (JAX compiles every op for
# every new shape)
AMASS_SPECS = (
    ("CMU", "01", "walk", 1200, 120),      # → 600 frames, 2 chunks
    ("CMU", "01", "run", 600, 60),
    ("CMU", "02", "broken", 0, None),      # unreadable: skipped
    ("KIT", "3", "jump", 600, 59),
    ("KIT", "3", "dance", 500, 100),       # 100 fps: skipped
    ("ACCAD", "s1", "kick", 600, 120),     # the valid split
)
DIP_SPECS = (
    ("s_01", "01", 400, "burst"),
    ("s_01", "05", 400, "burst"),          # s_01_05: the valid split
    ("s_02", "02", 400, None),
    ("s_02", "03", 400, "dead"),           # NaNs survive: discarded
    ("s_03", "05", 400, None),             # s_03_05: valid
    ("s_09", "01", 250, "burst"),          # test subjects
    ("s_10", "02", 200, None),
)
TC_SPECS = (("s1_acting1", 320, 325),      # acc longer than the pose
            ("s2_freestyle", 3560, 3560),  # the faulty length: dropped
            ("s3_walking", 200, 198))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_synthetic_smpl_pickle(
        str(tmp_path_factory.mktemp("smpl") / "smpl.pkl"), n_vertices=160)
    return jax_load(path), load_parametric_model(path, device="cpu")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A data root holding the three raw corpora in their layouts."""
    root = tmp_path_factory.mktemp("data_root")
    paths = TCFG.Paths(data_root=str(root))
    write_raw_amass(paths.resolve(paths.raw_amass_dir), AMASS_SPECS)
    write_raw_dip(paths.resolve(paths.raw_dipimu_dir), DIP_SPECS)
    write_raw_totalcapture(paths.resolve(paths.raw_totalcapture_dir),
                           TC_SPECS)
    return str(root)


def _paths(root):
    return JCFG.Paths(data_root=root), TCFG.Paths(data_root=root)


def _assert_same_raw(got, want):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "id":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])


def _assert_same_npz(got_path, want_path):
    with np.load(got_path) as g, np.load(want_path) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            atol = 1e-4 if k.split("_")[-1] == "acc" else ROT_TOL
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# constants and configuration
# ---------------------------------------------------------------------------

def test_torch_port_factory_constants_match_jax():
    for name in ("ACC_SCALE", "SMPL_MIRROR", "ORI_MIRROR", "ACC_MIRROR"):
        assert tuple(np.atleast_1d(getattr(TCFG, name))) == \
            tuple(np.atleast_1d(getattr(JCFG, name))), name
    assert TTF.SMPL_MAJOR_JOINTS == JTF.SMPL_MAJOR_JOINTS
    assert TTF.LEAF_NODES == JTF.LEAF_NODES
    assert sorted(TTF.__all__) == sorted(JTF.__all__)
    for name in ("TRAIN_SPLIT", "VAL_SPLIT", "AMASS_VI_MASK",
                 "AMASS_JI_MASK"):
        assert getattr(TA, name) == getattr(JA, name), name
    np.testing.assert_array_equal(TA.AMASS_ROT, JA.AMASS_ROT)
    for name in ("IMU_MASK", "TEST_SPLIT", "VALID_FILE_ID_BASES", "TRIM"):
        assert getattr(TD, name) == getattr(JD, name), name
    assert TT.SENSOR_ORDER == JT.SENSOR_ORDER
    assert TT.FAULTY_LENGTH == JT.FAULTY_LENGTH


def test_torch_port_paths_match_jax(monkeypatch):
    monkeypatch.setenv("A3GC_DATA_ROOT", "/somewhere/data")
    ours, ref = TCFG.Paths(), JCFG.Paths()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for rel in (ours.raw_amass_dir, "/abs/x.npz", ours.train_stats):
        assert ours.resolve(rel) == ref.resolve(rel)


def test_torch_port_factory_reads_the_data_root_at_call_time(
        models, data_root, monkeypatch, tmp_path):
    """``paths=None`` builds ``Paths()`` when the factory is called, so a
    data root set after the import is the one read (the JAX factories read
    the root of their import)."""
    _, tm = models
    monkeypatch.setenv("A3GC_DATA_ROOT", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        TD.process_dipimu(tm, split="test")
    monkeypatch.setenv("A3GC_DATA_ROOT", data_root)
    got = TD.process_dipimu(tm, split="test")
    want = TD.process_dipimu(tm, split="test",
                             paths=TCFG.Paths(data_root=data_root))
    assert_factory_close(got, want, "test")
    assert len(got) == 2
    assert len(TT.process_totalcapture(tm)) == 2
    assert len(TA.process_amass_split(tm, mode="valid", vi_mask=VI)) == 1


# ---------------------------------------------------------------------------
# transform.py
# ---------------------------------------------------------------------------

def _rotations(n, seed):
    return Rotation.random(n, random_state=seed).as_matrix().astype(
        np.float32)


def test_torch_port_normalizations_bit_equal_jax():
    rng = np.random.default_rng(0)
    T = 40
    ori = _rotations(T * 6, 1).reshape(T, 54)
    acc = rng.normal(size=(T, 18)).astype(np.float32)
    for a, b in zip(TTF.normalize_transpose(ori, acc),
                    JTF.normalize_transpose(ori, acc)):
        np.testing.assert_array_equal(a, b)
    for root in (5, 0, 3):
        for a, b in zip(TTF.normalize_root_relative(ori, acc, root),
                        JTF.normalize_root_relative(ori, acc, root)):
            np.testing.assert_array_equal(a, b)
    full = rng.normal(size=(T, 15)).astype(np.float32)
    leaf = rng.normal(size=(T, 15)).astype(np.float32)
    for a, b in zip(TTF.normalize_pos(full, leaf),
                    JTF.normalize_pos(full, leaf)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_torch_port_pose_space_bit_equal_jax(dtype):
    T = 30
    local = _rotations(T * 24, 2).reshape(T, 24, 3, 3).astype(dtype)
    np.testing.assert_array_equal(
        TTF.local_to_reduced_global(local, SMPL_PARENT),
        JTF.local_to_reduced_global(local, SMPL_PARENT))
    np.testing.assert_array_equal(
        TTF.local_to_reduced_global(local.reshape(T, 216), SMPL_PARENT),
        JTF.local_to_reduced_global(local.reshape(T, 216), SMPL_PARENT))
    reduced = _rotations(T * 15, 3).reshape(T, 135).astype(dtype)
    np.testing.assert_array_equal(
        TTF.reduced_local_to_reduced_global(reduced, SMPL_PARENT),
        JTF.reduced_local_to_reduced_global(reduced, SMPL_PARENT))
    np.testing.assert_array_equal(TTF._batched_fk_np(local, SMPL_PARENT),
                                  JTF._batched_fk_np(local, SMPL_PARENT))


def test_torch_port_mirror_pose_bit_equal_jax():
    pose = (Rotation.random(10 * 24, random_state=4).as_rotvec()
            ).reshape(10, 24, 3).astype(np.float32)
    pose[0] = 0.0                        # exact-zero axis-angles
    pose[1, 3] = [0.0, -0.0, 0.0]
    pose[2, 5] = [np.pi, 0.0, 0.0]
    for x in (pose, pose.reshape(10, 72), pose.astype(np.float64)):
        got, want = TTF.mirror_pose_axis_angle(x), \
            JTF.mirror_pose_axis_angle(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _hard_rotations():
    """[T, 6, 3, 3] fp32: random rotations, the identity, rotations by pi
    and within 1e-4 of it about random and axis-aligned axes, and random
    rotations off orthonormal by 1e-3."""
    rng = np.random.default_rng(5)
    T = 24
    ori = _rotations(T * 6, 6).reshape(T, 6, 3, 3)
    ori[0] = np.eye(3)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    ori[1] = Rotation.from_rotvec(axes * np.pi).as_matrix()
    ori[2] = Rotation.from_rotvec(axes * (np.pi - 1e-4)).as_matrix()
    ori[3] = Rotation.from_rotvec(np.eye(3).repeat(2, 0) * np.pi).as_matrix()
    ori[4] = Rotation.from_rotvec(axes * 1e-7).as_matrix()
    ori[5:8] += rng.normal(scale=1e-3, size=ori[5:8].shape)
    return ori.astype(np.float32), rng.normal(size=(T, 6, 3)).astype(
        np.float32)


def test_torch_port_mirror_imu_matches_jax():
    """Matrices compared, not axis-angles: at pi the axis-angle's sign may
    flip and mirror to the same matrix."""
    ori, acc = _hard_rotations()
    o, a = TTF.mirror_imu(ori, acc, device="cpu")
    jo, ja = JTF.mirror_imu(ori, acc)
    assert o.shape == jo.shape and o.dtype == jo.dtype == np.float32
    np.testing.assert_allclose(o, jo, rtol=0, atol=ROT_TOL)
    np.testing.assert_array_equal(a, ja)
    # mirrored twice is the input (orthonormal rows)
    o2, a2 = TTF.mirror_imu(o, a, device="cpu")
    np.testing.assert_allclose(o2[:5], ori[:5], rtol=0, atol=ROT_TOL)
    np.testing.assert_array_equal(a2, acc)


def test_torch_port_nan_fill_bit_equal_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(40, 6, 3)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    x[:6, 0] = np.nan                      # a head burst past 4 passes
    x[-3:, 1] = np.nan                     # a tail burst
    x[:, 2, 0] = np.nan                    # a dead channel
    for passes in (4, 1, 0):
        got = TTF.nan_fill_nearest(x, passes)
        np.testing.assert_array_equal(got, JTF.nan_fill_nearest(x, passes))
    assert np.isnan(TTF.nan_fill_nearest(x)).any()
    ori = _rotations(20 * 6, 8).reshape(20, 6, 3, 3)
    ori[3:5, 2] = np.nan
    np.testing.assert_array_equal(TTF.nan_fill_nearest(ori),
                                  JTF.nan_fill_nearest(ori))


@pytest.mark.parametrize("T", [1, 2, 3, 8, 9, 50])
@pytest.mark.parametrize("smooth_n", [4, 1, 0])
def test_torch_port_syn_acc_bit_equal_jax(T, smooth_n):
    v = np.random.default_rng(T).normal(size=(T, 6, 3)).astype(np.float32)
    got = TTF.syn_acc(v, smooth_n=smooth_n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JTF.syn_acc(v, smooth_n=smooth_n))
    np.testing.assert_array_equal(TTF.syn_acc(v, smooth_n, fps=30.0),
                                  JTF.syn_acc(v, smooth_n, fps=30.0))


def test_torch_port_chunk_and_pack_bit_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    seqs = [{"a": rng.normal(size=(T, 2)), "b": rng.normal(size=(T, 3, 3))}
            for T in (650, 200, 300, 901)]
    got = TTF.chunk_sequences(seqs, 300)
    want = JTF.chunk_sequences(seqs, 300)
    assert len(got) == len(want) == 2 + 0 + 1 + 3
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert len(TTF.chunk_sequences(seqs, 100)) == \
        len(JTF.chunk_sequences(seqs, 100))
    for fields in (None, ["b"]):
        ours = TTF.pack_dataset(got, str(tmp_path / "t" / "ours.npz"),
                                fields)
        ref = JTF.pack_dataset(want, str(tmp_path / "j" / "ref.npz"), fields)
        with np.load(ours) as g, np.load(ref) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                assert g[k].dtype == w[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# raw walkers
# ---------------------------------------------------------------------------

def test_torch_port_raw_walkers_match_jax(data_root):
    jp, tp = _paths(data_root)
    amass_dir = tp.resolve(tp.raw_amass_dir)
    for split in (TA.TRAIN_SPLIT, TA.VAL_SPLIT):
        got = list(TA.iter_amass_raw(amass_dir, split))
        _assert_same_raw(got, list(JA.iter_amass_raw(amass_dir, split)))
    train = list(TA.iter_amass_raw(amass_dir, TA.TRAIN_SPLIT))
    # 120 fps halved, 60 and 59 kept, 100 fps and the broken file skipped
    assert [r["poses"].shape[0] for r in train] == [600, 600, 600]
    assert [os.path.basename(r["id"]) for r in train] == [
        "run_poses.npz", "walk_poses.npz", "jump_poses.npz"]
    assert [r["poses"].shape[1:] for r in train] == [(156,)] * 3
    assert all(r["betas"].shape == (10,) for r in train)

    dip_dir = tp.resolve(tp.raw_dipimu_dir)
    for split in ("test", "train", "valid"):
        _assert_same_raw(list(TD.iter_dipimu_raw(dip_dir, split)),
                         list(JD.iter_dipimu_raw(dip_dir, split)))
    ids = {split: [r["id"] for r in TD.iter_dipimu_raw(dip_dir, split)]
           for split in ("test", "train", "valid")}
    assert ids["valid"] == ["DIP_IMU_s_01_05.pkl", "DIP_IMU_s_03_05.pkl"]
    assert ids["test"] == ["DIP_IMU_s_09_01.pkl", "DIP_IMU_s_10_02.pkl"]
    assert ids["train"] == ["DIP_IMU_s_01_01.pkl", "DIP_IMU_s_02_02.pkl",
                            "DIP_IMU_s_02_03.pkl"]

    tc_dir = tp.resolve(tp.raw_totalcapture_dir)
    got = list(TT.iter_totalcapture_raw(tc_dir))
    _assert_same_raw(got, list(JT.iter_totalcapture_raw(tc_dir)))
    assert [(r["acc"].shape[0], r["pose"].shape[0]) for r in got] == \
        [(320, 320), (3560, 3560), (198, 198)]


# ---------------------------------------------------------------------------
# the pipelines, every field against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sym", [False, True])
def test_torch_port_process_amass_matches_jax(models, data_root, tmp_path,
                                              sym):
    jm, tm = models
    jp, tp = _paths(data_root)
    ours = str(tmp_path / "ours.npz")
    ref = str(tmp_path / "ref.npz")
    got = TA.process_amass_split(tm, "train", sym=sym, out_path=ours,
                                 paths=tp, vi_mask=VI)
    want = JA.process_amass_split(jm, "train", sym=sym, out_path=ref,
                                  paths=jp, vi_mask=VI)
    assert len(got) == (2 + 2 + 2) * (2 if sym else 1)
    assert_factory_close(got, want, f"amass sym={sym}")
    _assert_same_npz(ours, ref)
    with np.load(ours) as z:
        assert z["full_pos"].shape == (len(got), 300, 24, 3)
        assert z["leaf_pos"].shape == (len(got), 300, 5, 3)
        np.testing.assert_allclose(z["full_pos"][:, :, 0], 0.0, atol=1e-6)


def test_torch_port_process_amass_min_length_and_chunk_size(models,
                                                           data_root):
    jm, tm = models
    _, tp = _paths(data_root)
    raws = list(TA.iter_amass_raw(tp.resolve(tp.raw_amass_dir), ("CMU",)))
    raws.insert(0, {k: v[:12] if k in ("poses", "trans") else v
                    for k, v in raws[0].items()})
    got = TA.process_amass_split(tm, raw_iter=iter(raws), chunk_size=250,
                                 vi_mask=VI, ji_mask=(0, 1, 2, 3, 4, 5))
    want = JA.process_amass_split(jm, raw_iter=iter(raws), chunk_size=250,
                                  vi_mask=VI, ji_mask=(0, 1, 2, 3, 4, 5))
    assert len(got) == 2 + 2             # the 12-frame sequence is dropped
    assert_factory_close(got, want, "amass chunk 250")


def test_torch_port_synthesize_sequence_matches_jax(models):
    """The on-device vertex selection and the frame-chunked skinning give
    JAX's outputs (which copy the whole mesh off the device)."""
    jm, tm = models
    rng = np.random.default_rng(12)
    T = 600
    pose = (Rotation.random(T * 24, random_state=13).as_rotvec() * 0.4
            ).reshape(T, 24, 3).astype(np.float32)
    shape = rng.normal(scale=0.5, size=10).astype(np.float32)
    trans = np.cumsum(rng.normal(scale=0.01, size=(T, 3)), 0).astype(
        np.float32)
    got = TA.synthesize_sequence(tm, pose, shape, trans, vi_mask=VI)
    want = JA.synthesize_sequence(jm, pose, shape, trans, vi_mask=VI)
    assert_factory_close([got], [want], "synthesize")
    aligned = TA._align_global_frame(pose, trans, "cpu")
    for a, b in zip(aligned, JA._align_global_frame(pose, trans)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ROT_TOL)
    poses52 = rng.normal(size=(T, 156)).astype(np.float32)
    np.testing.assert_array_equal(TA._body_pose_24(poses52),
                                  JA._body_pose_24(poses52))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_port_chunked_skinning_equals_one_call(models, dtype):
    tm = models[1]._astype(dtype)       # synthesize_sequence skins in fp64
    rng = np.random.default_rng(14)
    T = 700
    rot = torch.as_tensor(_rotations(T * 24, 15).reshape(T, 24, 3, 3),
                          dtype=dtype)
    shape = rng.normal(size=10).astype(np.float32)
    trans = rng.normal(size=(T, 3)).astype(np.float32)
    whole = TA._skin_sensors(tm, rot, shape, trans, VI, chunk=T)
    _, joint, verts = tm.forward_kinematics(rot, tm.as_tensor(shape)[None],
                                            tm.as_tensor(trans),
                                            calc_mesh=True)
    torch.testing.assert_close(whole[1], joint, rtol=0, atol=0)
    torch.testing.assert_close(whole[2], verts[:, list(VI)], rtol=0, atol=0)
    for chunk in (1, 7, 300, 2048):
        for a, b in zip(TA._skin_sensors(tm, rot, shape, trans, VI, chunk),
                        whole):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("split,sym", [("train", False), ("train", True),
                                       ("valid", False), ("test", False),
                                       ("test", True)])
def test_torch_port_process_dipimu_matches_jax(models, data_root, tmp_path,
                                               split, sym):
    jm, tm = models
    jp, tp = _paths(data_root)
    ours = str(tmp_path / "o" / "ours.npz")
    ref = str(tmp_path / "r" / "ref.npz")
    got = TD.process_dipimu(tm, split, sym=sym, out_path=ours, paths=tp)
    want = JD.process_dipimu(jm, split, sym=sym, out_path=ref, paths=jp)
    # one chunk a train or valid motion of 320-400 frames (s_02_03
    # discarded), twice with the mirror; the test split is never mirrored
    assert len(got) == 2 * (2 if sym and split == "train" else 1)
    assert_factory_close(got, want, f"dipimu {split} sym={sym}")
    _assert_same_npz(ours, ref)
    if split == "test":
        assert [s["ori"].shape for s in got] == [(238, 54), (188, 54)]
        assert "full_pos" not in got[0]
        back = TD.load_test_sequences(ours)
        for a, b in zip(back, got):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def test_torch_port_preprocess_sequence_matches_jax():
    rng = np.random.default_rng(16)
    ori, acc = _hard_rotations()
    T = len(ori)
    raw = {"ori": ori, "acc": acc,
           "pose": rng.normal(scale=0.3, size=(T, 72)).astype(np.float32)}
    raw["acc"][5:7, 1] = np.nan
    for mirror in (False, True):
        got = TD.preprocess_sequence(raw, mirror=mirror, device="cpu")
        want = JD.preprocess_sequence(raw, mirror=mirror)
        assert_factory_close([got], [want], f"mirror={mirror}")
    dead = dict(raw, acc=np.full_like(raw["acc"], np.nan))
    assert TD.preprocess_sequence(dead, device="cpu") is None
    short = {k: v[:12] for k, v in raw.items()}
    assert TD.preprocess_sequence(short, device="cpu") is None
    assert JD.preprocess_sequence(short) is None


@pytest.mark.parametrize("drop_faulty", [True, False])
def test_torch_port_process_totalcapture_matches_jax(models, data_root,
                                                     tmp_path, drop_faulty):
    jm, tm = models
    jp, tp = _paths(data_root)
    if drop_faulty:
        ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
        got = TT.process_totalcapture(tm, out_path=ours, paths=tp)
        want = JT.process_totalcapture(jm, out_path=ref, paths=jp)
        assert [s["pose"].shape for s in got] == [(320, 135), (198, 135)]
        _assert_same_npz(ours, ref)
    else:
        raws = list(TT.iter_totalcapture_raw(
            tp.resolve(tp.raw_totalcapture_dir)))
        got = TT.process_totalcapture(tm, raw_iter=iter(raws),
                                      drop_faulty=False)
        want = JT.process_totalcapture(jm, raw_iter=iter(raws),
                                       drop_faulty=False)
        assert [s["pose"].shape[0] for s in got] == [320, 3560, 198]
    assert_factory_close(got, want, f"totalcapture drop={drop_faulty}")
