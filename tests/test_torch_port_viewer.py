"""The port's motion viewer (a3gc_tpu_torch.smpl.viewer and the
``view_*`` methods of ParametricModel) against the JAX package's on the
CPU: ``render_skeleton`` and ``render_mesh`` frames bit-equal on the same
numpy input, ``save_animation`` files byte-equal, ``view_joint`` and
``view_mesh`` files with equal frames, and ``view_motion`` (FK and skinning
in each package) with at most 0.1 % of the pixels of a frame differing: FK
rounding (1e-7 m) may move an edge pixel or swap two faces of equal depth.

Sizes: a synthetic SMPL body of 160 vertices, 3-4 frames, 64-96 pixels."""

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence
from scipy.spatial.transform import Rotation

from a3gc_tpu.smpl import load_parametric_model as jax_load
from a3gc_tpu.smpl import viewer as JV
from a3gc_tpu_torch.smpl import (SMPL_PARENT, load_parametric_model,
                                 write_synthetic_smpl_pickle)
from a3gc_tpu_torch.smpl import viewer as TV

torch.set_num_threads(1)

PIXEL_SHARE = 1e-3      # view_motion: pixels of a frame allowed to differ


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_synthetic_smpl_pickle(
        str(tmp_path_factory.mktemp("smpl") / "smpl.pkl"), n_vertices=160)
    return jax_load(path), load_parametric_model(path, device="cpu")


def _frames(path):
    with Image.open(path) as im:
        return np.stack([np.asarray(f.convert("RGB"))
                         for f in ImageSequence.Iterator(im)])


def _same_file(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def _poses(T, seed, scale=0.4):
    return Rotation.from_rotvec(
        Rotation.random(T * 24, random_state=seed).as_rotvec() * scale
    ).as_matrix().reshape(T, 24, 3, 3).astype(np.float32)


def test_torch_port_viewer_exports_match_jax():
    assert TV.__all__ == JV.__all__


@pytest.mark.parametrize("subjects,colors", [(1, None), (3, None),
                                             (2, [(0, 0, 0)])])
def test_torch_port_render_skeleton_bit_equal_jax(subjects, colors):
    rng = np.random.default_rng(subjects)
    joints = [rng.normal(size=(3, 24, 3)).astype(np.float32) + [i, 0, 0]
              for i in range(subjects)]
    arg = joints[0] if subjects == 1 else joints
    got = TV.render_skeleton(arg, SMPL_PARENT, size=64, colors=colors)
    want = JV.render_skeleton(arg, SMPL_PARENT, size=64, colors=colors)
    assert got.shape == (3, 64, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # a parent list with a -1 root draws the same skeleton
    np.testing.assert_array_equal(
        TV.render_skeleton(arg, (-1,) + SMPL_PARENT[1:], size=64,
                           colors=colors), want)


@pytest.mark.parametrize("subjects", [1, 2])
def test_torch_port_render_mesh_bit_equal_jax(models, subjects):
    jm, tm = models
    rng = np.random.default_rng(10 + subjects)
    verts = [rng.normal(scale=0.3, size=(3, tm.n_vertices, 3)).astype(
        np.float32) + [i, 0, 0] for i in range(subjects)]
    arg = verts[0] if subjects == 1 else verts
    got = TV.render_mesh(arg, tm.faces, size=72)
    np.testing.assert_array_equal(got, JV.render_mesh(arg, jm.faces,
                                                      size=72))
    np.testing.assert_array_equal(
        TV.render_mesh(arg, tm.faces, size=72, light=(0.0, 0.0, 1.0)),
        JV.render_mesh(arg, jm.faces, size=72, light=(0.0, 0.0, 1.0)))


@pytest.mark.parametrize("T,name,fps", [(1, "one.gif", 60),
                                        (3, "three.gif", 30),
                                        (3, "first.png", 60)])
def test_torch_port_save_animation_byte_equal_jax(tmp_path, T, name, fps):
    frames = np.random.default_rng(T).integers(0, 256, size=(T, 16, 16, 3),
                                               dtype=np.uint8)
    ours = TV.save_animation(frames, str(tmp_path / ("t_" + name)), fps=fps)
    ref = JV.save_animation(frames, str(tmp_path / ("j_" + name)), fps=fps)
    assert ours == str(tmp_path / ("t_" + name))
    assert _same_file(ours, ref)
    np.testing.assert_array_equal(_frames(ours), _frames(ref))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_torch_port_view_joint_matches_jax(models, tmp_path, as_tensor):
    jm, tm = models
    rng = np.random.default_rng(20)
    joints = [rng.normal(size=(4, 24, 3)).astype(np.float32)
              for _ in range(2)]
    arg = [torch.as_tensor(j) for j in joints] if as_tensor else joints
    ours = tm.view_joint(arg, fps=30, distance_between_subjects=0.5,
                         out_path=str(tmp_path / "ours.gif"), size=64)
    ref = jm.view_joint(joints, fps=30, distance_between_subjects=0.5,
                        out_path=str(tmp_path / "ref.gif"), size=64)
    np.testing.assert_array_equal(_frames(ours), _frames(ref))
    assert _same_file(ours, ref)
    # the caller's arrays are left as they were
    np.testing.assert_array_equal(np.asarray(arg[1]), joints[1])


def test_torch_port_view_mesh_matches_jax(models, tmp_path):
    jm, tm = models
    rng = np.random.default_rng(21)
    verts = [rng.normal(scale=0.3, size=(3, tm.n_vertices, 3)).astype(
        np.float32) for _ in range(2)]
    ours = tm.view_mesh(verts, out_path=str(tmp_path / "ours.png"), size=80)
    ref = jm.view_mesh(verts, out_path=str(tmp_path / "ref.png"), size=80)
    np.testing.assert_array_equal(_frames(ours), _frames(ref))
    ours = tm.view_mesh([torch.as_tensor(verts[0])],
                        out_path=str(tmp_path / "ours.gif"), size=80)
    ref = jm.view_mesh(verts[:1], out_path=str(tmp_path / "ref.gif"),
                       size=80)
    np.testing.assert_array_equal(_frames(ours), _frames(ref))


@pytest.mark.parametrize("with_tran", [False, True])
def test_torch_port_view_motion_matches_jax(models, tmp_path, with_tran):
    jm, tm = models
    rng = np.random.default_rng(22)
    poses = [_poses(3, 23), _poses(3, 24)]
    trans = ([np.cumsum(rng.normal(scale=0.05, size=(3, 3)), 0).astype(
        np.float32) for _ in poses] if with_tran else None)
    ours = tm.view_motion(poses, trans, out_path=str(tmp_path / "ours.gif"),
                          size=96)
    ref = jm.view_motion(poses, trans, out_path=str(tmp_path / "ref.gif"),
                         size=96)
    got, want = _frames(ours), _frames(ref)
    assert got.shape == want.shape == (3, 96, 96, 3)
    differ = (got != want).any(-1).reshape(3, -1).mean(-1)
    assert (differ <= PIXEL_SHARE).all(), differ
    # the same frames as view_mesh of the port's own skinning
    verts = [tm.forward_kinematics(
        torch.as_tensor(p), tran=None if trans is None else
        torch.as_tensor(t - t[:1]), calc_mesh=True)[2].numpy()
        for p, t in zip(poses, trans or [None] * 2)]
    mesh = tm.view_mesh(verts, out_path=str(tmp_path / "mesh.gif"), size=96)
    np.testing.assert_array_equal(_frames(mesh), got)
