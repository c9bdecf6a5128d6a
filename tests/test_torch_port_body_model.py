"""The port's body model against the JAX package's, both loading the same
synthetic SMPL pickle (192 vertices): the synthetic model's arrays bit-equal
for the same seed, ``load_parametric_model`` (scipy-sparse J_regressor), the
zero pose with and without shape, FK with shape, translation, mesh and pose
blendshapes, the tree ops, IK, the exports, and the rest of the kinematics
module (a3gc_tpu_torch.ops.kinematics). Within 1e-5."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.ops import kinematics as JK
from a3gc_tpu.smpl import armature as JA
from a3gc_tpu.smpl import load_parametric_model as jax_load
from a3gc_tpu.smpl import synthetic_smpl_data as jax_synthetic
from a3gc_tpu.smpl import write_synthetic_smpl_pickle as jax_write
from a3gc_tpu_torch.ops import kinematics as TK
from a3gc_tpu_torch.smpl import (SMPL_PARENT, ParametricModel,
                                 load_parametric_model, synthetic_smpl_data,
                                 write_synthetic_smpl_pickle)
from a3gc_tpu_torch.smpl import armature as TA

TOL = 1e-5
V = 192


@pytest.fixture(scope="module")
def smpl_pickle(tmp_path_factory):
    return jax_write(str(tmp_path_factory.mktemp("smpl") / "smpl.pkl"),
                     n_vertices=V)


@pytest.fixture(scope="module")
def models(smpl_pickle):
    return (load_parametric_model(smpl_pickle, device="cpu"),
            jax_load(smpl_pickle))


def _poses(rng, b, scale=1.0):
    from scipy.spatial.transform import Rotation
    aa = Rotation.random(b * 24, random_state=rng).as_rotvec() * scale
    return Rotation.from_rotvec(aa).as_matrix().reshape(b, 24, 3, 3).astype(
        np.float32)


def _close(ours, ref, tol=TOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("n_vertices,seed", [(192, 0), (432, 0), (100, 7),
                                             (6890, 0)])
def test_torch_port_synthetic_smpl_data_is_bit_equal(n_vertices, seed):
    ours = synthetic_smpl_data(n_vertices=n_vertices, seed=seed)
    ref = jax_synthetic(n_vertices=n_vertices, seed=seed)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_torch_port_synthetic_pickle_is_the_jax_pickle(tmp_path):
    import pickle
    ours = write_synthetic_smpl_pickle(str(tmp_path / "a.pkl"), n_vertices=V)
    ref = jax_write(str(tmp_path / "b.pkl"), n_vertices=V)
    with open(ours, "rb") as f, open(ref, "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert a.keys() == b.keys()
    assert type(a["J_regressor"]) is type(b["J_regressor"])
    for k in a:
        x, y = a[k], b[k]
        if hasattr(x, "toarray"):
            x, y = x.toarray(), y.toarray()
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_torch_port_load_parametric_model(models):
    ours, ref = models
    assert ours.parent == ref.parent == SMPL_PARENT
    assert ours.device == torch.device("cpu")
    assert (ours.n_joints, ours.n_vertices) == (ref.n_joints, ref.n_vertices)
    for name in ("j_regressor", "skinning_weights", "posedirs", "shapedirs",
                 "v_template", "joints_template"):
        t = getattr(ours, name)
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(ours.faces, np.asarray(ref.faces))


def test_torch_port_armature_matches_jax():
    assert TA.SMPL_PARENT == JA.SMPL_PARENT
    for name in ("MANOJoint", "SMPLJoint", "SMPLHJoint"):
        ours, ref = getattr(TA, name), getattr(JA, name)
        assert ({m: ours[m].value for m in ours.__members__}
                == {m: ref[m].value for m in ref.__members__})


def test_torch_port_tree_only_model_refuses_fk():
    m = ParametricModel()
    assert m.device is None and m.n_joints == 24
    with pytest.raises(ValueError, match="load_parametric_model"):
        m.forward_kinematics(torch.eye(3).expand(1, 24, 3, 3))
    with pytest.raises(ValueError, match="all of"):
        ParametricModel(v_template=np.zeros((3, 3)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        m.view_motion([])


@pytest.mark.parametrize("with_shape", [False, True])
def test_torch_port_zero_pose_matches_jax(models, with_shape):
    ours, ref = models
    shape = (np.random.default_rng(1).normal(size=(3, 10)).astype(np.float32)
             if with_shape else None)
    j, v = ours.get_zero_pose_joint_and_vertex(shape)
    jr, vr = ref.get_zero_pose_joint_and_vertex(
        None if shape is None else jnp.asarray(shape))
    _close(j, jr)
    _close(v, vr)


@pytest.mark.parametrize("case", ["pose", "shape_tran_mesh", "one_shape_row",
                                  "mesh", "pose_blendshape"])
def test_torch_port_forward_kinematics_matches_jax(smpl_pickle, case):
    rng = np.random.default_rng(2)
    blend = case == "pose_blendshape"
    ours = load_parametric_model(smpl_pickle, use_pose_blendshape=blend,
                                 device="cpu")
    ref = jax_load(smpl_pickle, use_pose_blendshape=blend)
    B = 5
    pose = _poses(rng, B)
    shape = tran = None
    if case == "shape_tran_mesh":
        shape = rng.normal(size=(B, 10)).astype(np.float32)
        tran = rng.normal(size=(B, 3)).astype(np.float32)
    if case == "one_shape_row":
        shape = rng.normal(size=(1, 10)).astype(np.float32)
    mesh = case != "pose"
    got = ours.forward_kinematics(pose, shape, tran, calc_mesh=mesh)
    want = ref.forward_kinematics(
        jnp.asarray(pose), None if shape is None else jnp.asarray(shape),
        None if tran is None else jnp.asarray(tran), calc_mesh=mesh)
    assert len(got) == len(want) == (3 if mesh else 2)
    for a, b in zip(got, want):
        _close(a, b)
    batch = ours.forward_kinematics_batch(torch.as_tensor(pose), shape, tran,
                                          calc_mesh=mesh, batch_size=2)
    for a, b in zip(batch, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["forward_kinematics_R",
                                    "inverse_kinematics_R"])
def test_torch_port_model_rotation_tree_ops_match_jax(models, method):
    ours, ref = models
    r = _poses(np.random.default_rng(3), 4)
    _close(getattr(ours, method)(torch.as_tensor(r)),
           getattr(ref, method)(jnp.asarray(r)))
    # the IK of the FK is the identity on the tree
    back = ours.inverse_kinematics_R(ours.forward_kinematics_R(
        torch.as_tensor(r)))
    _close(back, r)


def _transforms(rng, b):
    r = _poses(rng, b)
    p = rng.normal(size=(b, 24, 3)).astype(np.float32)
    return np.array(JK.transformation_matrix(jnp.asarray(r),
                                             jnp.asarray(p)))


def test_torch_port_transformation_matrices_match_jax():
    rng = np.random.default_rng(4)
    r = _poses(rng, 2)
    p = rng.normal(size=(2, 24, 3)).astype(np.float32)
    t = TK.transformation_matrix(torch.as_tensor(r), torch.as_tensor(p))
    _close(t, JK.transformation_matrix(jnp.asarray(r), jnp.asarray(p)))
    R_, p_ = TK.decode_transformation_matrix(t)
    _close(R_, r)
    _close(p_, p)
    _close(TK.inverse_transformation_matrix(t),
           JK.inverse_transformation_matrix(jnp.asarray(t.numpy())))


@pytest.mark.parametrize("method", ["forward_kinematics_T",
                                    "inverse_kinematics_T"])
def test_torch_port_transform_tree_ops_match_jax(models, method):
    ours, ref = models
    t = _transforms(np.random.default_rng(5), 3)
    _close(getattr(ours, method)(torch.as_tensor(t)),
           getattr(ref, method)(jnp.asarray(t)))


def test_torch_port_bone_and_joint_tree_ops_match_jax(models):
    ours, ref = models
    x = np.random.default_rng(6).normal(size=(4, 24, 3)).astype(np.float32)
    for method in ("bone_vector_to_joint_position",
                   "joint_position_to_bone_vector"):
        _close(getattr(ours, method)(torch.as_tensor(x)),
               getattr(ref, method)(jnp.asarray(x)))


@pytest.mark.parametrize("parent", [SMPL_PARENT,
                                    (None, 0, 1, 1, 3, -1),
                                    (-1, 0, 0, 2, 2, 4, 4)])
def test_torch_port_tree_levels_and_fk_on_other_trees(parent):
    assert TK.tree_levels(tuple(parent)) == JK.tree_levels(tuple(parent))
    rng = np.random.default_rng(7)
    J = len(parent)
    r = _poses(rng, 3)[:, :J]
    p = rng.normal(size=(3, J, 3)).astype(np.float32)
    got = TK.forward_kinematics(torch.as_tensor(r), torch.as_tensor(p),
                                parent)
    want = JK.forward_kinematics(jnp.asarray(r), jnp.asarray(p), parent)
    for a, b in zip(got, want):
        _close(a, b)


def test_torch_port_kinematics_refuses_a_bad_parent_list():
    with pytest.raises(ValueError, match="smaller"):
        TK.tree_levels((None, 2, 0))


def test_torch_port_kinematics_numpy_helpers_match_jax():
    rng = np.random.default_rng(8)
    r, p = _poses(rng, 1)[0, 0], rng.normal(size=3)
    np.testing.assert_array_equal(TK.transformation_matrix_np(r, p),
                                  JK.transformation_matrix_np(r, p))
    np.testing.assert_array_equal(TK.adjoint_transformation_matrix_np(r, p),
                                  JK.adjoint_transformation_matrix_np(r, p))


def test_torch_port_exports_match_jax(models, tmp_path):
    ours, ref = models
    rng = np.random.default_rng(9)
    pose = _poses(rng, 3)
    tran = rng.normal(size=(3, 3)).astype(np.float32)
    verts = ours.forward_kinematics(pose, calc_mesh=True)[2][0]
    ours.save_obj_mesh(verts, str(tmp_path / "a.obj"))
    ref.save_obj_mesh(np.asarray(verts), str(tmp_path / "b.obj"))
    with open(tmp_path / "a.obj") as f, open(tmp_path / "b.obj") as g:
        assert f.read() == g.read()
    ParametricModel.save_unity_motion(pose, tran, str(tmp_path / "u1"))
    type(ref).save_unity_motion(jnp.asarray(pose), tran,
                                str(tmp_path / "u2"))
    for name in ("pose.txt", "tran.txt"):
        a = np.loadtxt(os.path.join(tmp_path, "u1", name), delimiter=",")
        b = np.loadtxt(os.path.join(tmp_path, "u2", name), delimiter=",")
        # 4-decimal text: a last-digit rounding flip at most
        np.testing.assert_allclose(a, b, rtol=0, atol=1.01e-4)
