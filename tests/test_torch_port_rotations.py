"""The port's rotation math (a3gc_tpu_torch.ops.rotations) against the JAX
package's on the same numpy inputs, within 1e-5: every conversion, the SVD
projection on orthonormal, perturbed, near-singular and reflected matrices,
angle_between on orthonormal and non-orthonormal input at angles near 0 and
near π, Kabsch, the Euler sequences, the small utilities and the numpy
helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.ops import rotations as JR
from a3gc_tpu_torch.ops import rotations as TR

TOL = 1e-5


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(n, 3, 3).astype(np.float32)


def _axis_angles(rng, n, angles):
    """Axis-angle vectors at the given angles about axes whose components
    are all away from 0 (so the near-π signs are well defined)."""
    axis = rng.uniform(0.3, 1.0, size=(n, 3)) * rng.choice((-1, 1), (n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    return (axis * np.asarray(angles).reshape(-1, 1)).astype(np.float32)


def _both(name, *args, **kw):
    """(torch result, JAX result) of the function ``name`` on numpy args."""
    ours = getattr(TR, name)(*(torch.tensor(a) if isinstance(a, np.ndarray)
                               else a for a in args), **kw)
    ref = getattr(JR, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args), **kw)
    return ours.numpy(), np.asarray(ref)


def _close(ours, ref, tol=TOL):
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


ANGLES = {"generic": lambda rng, n: rng.uniform(0.1, 3.0, n),
          "near_zero": lambda rng, n: 10.0 ** rng.uniform(-7, -3, n),
          "near_pi": lambda rng, n: np.pi - 10.0 ** rng.uniform(-6, -2, n),
          "zero": lambda rng, n: np.zeros(n)}


@pytest.mark.parametrize("regime", sorted(ANGLES))
def test_torch_port_axis_angle_round_trip_matches_jax(regime):
    rng = np.random.default_rng(1)
    aa = _axis_angles(rng, 64, ANGLES[regime](rng, 64))
    r_ours, r_ref = _both("axis_angle_to_rotation_matrix", aa)
    _close(r_ours, r_ref)
    back_ours, back_ref = _both("rotation_matrix_to_axis_angle", r_ref)
    _close(back_ours, back_ref)
    q_ours, q_ref = _both("axis_angle_to_quaternion", aa)
    _close(q_ours, q_ref)


def test_torch_port_axis_angle_of_perturbed_matrices_projects_like_jax():
    rng = np.random.default_rng(2)
    m = _rotations(rng, 64) + 0.05 * rng.normal(size=(64, 3, 3)).astype(
        np.float32)
    ours, ref = _both("rotation_matrix_to_axis_angle", m, project=True)
    _close(ours, ref)


@pytest.mark.parametrize("name", ["quaternion_to_axis_angle",
                                  "quaternion_to_rotation_matrix"])
def test_torch_port_quaternion_functions_match_jax(name):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = (1.0, 0.0, 0.0, 0.0)                       # the zero rotation
    q[1] = (-2.0, 1e-9, 0.0, 0.0)
    _close(*_both(name, q))


def test_torch_port_rotation_matrix_to_quaternion_matches_jax_on_every_case():
    rng = np.random.default_rng(4)
    # one matrix for each of Shepperd's four cases, then random ones
    r = np.concatenate([
        TR.axis_angle_to_rotation_matrix(torch.as_tensor(_axis_angles(
            rng, 3, [0.2, 0.2, 0.2]))).numpy(),
        TR.axis_angle_to_rotation_matrix(torch.tensor(
            [[3.0, 0.1, 0.1], [0.1, 3.0, 0.1], [0.1, 0.1, 3.0]])).numpy(),
        _rotations(rng, 64)])
    _close(*_both("rotation_matrix_to_quaternion", r))


def test_torch_port_r6d_functions_match_jax():
    rng = np.random.default_rng(5)
    r = _rotations(rng, 64)
    ours, ref = _both("rotation_matrix_to_r6d", r)
    _close(ours, ref)
    _close(*_both("r6d_to_rotation_matrix",
                  ref + 0.1 * rng.normal(size=ref.shape).astype(np.float32)))


@pytest.mark.parametrize("seq", ["XYZ", "xyz", "ZYX", "zxy", "YXZ", "yzx"])
def test_torch_port_euler_round_trip_matches_jax(seq):
    rng = np.random.default_rng(6)
    q = rng.uniform(-np.pi, np.pi, size=(64, 3)).astype(np.float32)
    q[:, 1] = rng.uniform(-1.4, 1.4, size=64)
    ours, ref = _both("euler_angle_to_rotation_matrix", q, seq)
    _close(ours, ref)
    back_ours, back_ref = _both("rotation_matrix_to_euler_angle", ref, seq)
    _close(back_ours, back_ref)


def test_torch_port_euler_at_gimbal_lock_matches_jax():
    q = np.array([[0.3, np.pi / 2, 0.4], [-1.0, -np.pi / 2, 0.2]],
                 np.float32)
    r = JR.euler_angle_to_rotation_matrix(jnp.asarray(q), "XYZ")
    _close(*_both("rotation_matrix_to_euler_angle", np.asarray(r), "XYZ"))


def test_torch_port_euler_refuses_improper_sequences():
    with pytest.raises(ValueError):
        TR.rotation_matrix_to_euler_angle(torch.eye(3)[None], "XYX")
    with pytest.raises(ValueError):
        TR.euler_angle_to_rotation_matrix(torch.zeros(1, 3), "XY")


@pytest.mark.parametrize("rep,make", [
    ("AXIS_ANGLE", lambda rng: _axis_angles(rng, 32,
                                            rng.uniform(0, 3, 32))),
    ("QUATERNION", lambda rng: rng.normal(size=(32, 4)).astype(np.float32)),
    ("R6D", lambda rng: rng.normal(size=(32, 6)).astype(np.float32)),
    ("EULER_ANGLE", lambda rng: rng.uniform(-1, 1, (32, 3)).astype(
        np.float32)),
    ("ROTATION_MATRIX", lambda rng: _rotations(rng, 32)),
])
def test_torch_port_to_rotation_matrix_and_angle_between_every_rep(rep, make):
    rng = np.random.default_rng(7)
    a, b = make(rng), make(rng)
    _close(TR.to_rotation_matrix(torch.as_tensor(a),
                                 TR.RotationRepresentation[rep]).numpy(),
           np.asarray(JR.to_rotation_matrix(
               jnp.asarray(a), JR.RotationRepresentation[rep])))
    ours = TR.angle_between(torch.as_tensor(a), torch.as_tensor(b),
                            TR.RotationRepresentation[rep]).numpy()
    ref = np.asarray(JR.angle_between(jnp.asarray(a), jnp.asarray(b),
                                      JR.RotationRepresentation[rep]))
    _close(ours, ref)


def test_torch_port_rotation_representation_matches_jax():
    assert ({m.name: m.value for m in TR.RotationRepresentation}
            == {m.name: m.value for m in JR.RotationRepresentation})


def _near(rng, regime, n):
    """(r1, r2) with r1ᵀ·r2 at angles of ``regime``."""
    r1 = _rotations(rng, n)
    rel = TR.axis_angle_to_rotation_matrix(torch.as_tensor(
        _axis_angles(rng, n, ANGLES[regime](rng, n)))).numpy()
    return r1, np.einsum("nij,njk->nik", r1, rel).astype(np.float32)


@pytest.mark.parametrize("regime", ["generic", "near_zero", "near_pi"])
@pytest.mark.parametrize("orthonormal", [True, False])
def test_torch_port_angle_between_matches_jax(regime, orthonormal):
    """The nets emit unconstrained 9D matrices: ``project=True`` must agree
    on perturbed input too, at both ends of [0, π]."""
    rng = np.random.default_rng(8)
    r1, r2 = _near(rng, regime, 128)
    if not orthonormal:
        r1 = r1 + 0.02 * rng.normal(size=r1.shape).astype(np.float32)
        r2 = r2 + 0.02 * rng.normal(size=r2.shape).astype(np.float32)
    ours, ref = _both("angle_between", r1, r2)
    _close(ours, ref)
    if orthonormal:                       # the projection is a no-op there
        _close(*_both("angle_between", r1, r2, project=False))


def _singular(rng, n, third):
    """Matrices U·diag(1, 0.5, third)·Vᵀ: ``third`` tiny → near-singular,
    negative → reflected."""
    u, v = _rotations(rng, n), _rotations(rng, n)
    s = np.array([1.0, 0.5, third], np.float32)
    return np.einsum("nij,j,nkj->nik", u, s, v).astype(np.float32)


@pytest.mark.parametrize("kind", ["rotation", "perturbed", "near_singular",
                                  "reflected", "reflected_near_singular"])
def test_torch_port_project_to_rotation_matches_jax(kind):
    """U·Vᵀ with the determinant fix does not depend on the signs the SVD
    gives U and V: LAPACK here, cuSOLVER on the card."""
    rng = np.random.default_rng(9)
    m = {"rotation": lambda: _rotations(rng, 64),
         "perturbed": lambda: _rotations(rng, 64) + 0.1 * rng.normal(
             size=(64, 3, 3)).astype(np.float32),
         "near_singular": lambda: _singular(rng, 64, 1e-4),
         "reflected": lambda: _singular(rng, 64, -0.2),
         "reflected_near_singular": lambda: _singular(rng, 64, -1e-4)}[kind]()
    ours, ref = _both("project_to_rotation", m)
    _close(ours, ref)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), ours.shape)
    _close(np.einsum("nji,njk->nik", ours, ours), eye)
    _close(np.linalg.det(ours), np.ones(len(ours), np.float32))


@pytest.mark.parametrize("reflect", [False, True])
def test_torch_port_svd_rotate_matches_jax(reflect):
    rng = np.random.default_rng(10)
    src = rng.normal(size=(8, 20, 3)).astype(np.float32)
    rot = _rotations(rng, 8)
    dst = np.einsum("nij,nmj->nmi", rot, src)
    if reflect:
        dst[..., 0] *= -1
    dst = (dst + 0.01 * rng.normal(size=dst.shape)).astype(np.float32)
    ours, ref = _both("svd_rotate", src, dst)
    _close(ours, ref)


def test_torch_port_generate_random_rotation_matrix():
    """Normalized Gaussian quaternions from the generator: proper
    rotations, reproducible by seed, the JAX conversion of the same draws."""
    a = TR.generate_random_rotation_matrix(torch.Generator().manual_seed(3),
                                           50)
    b = TR.generate_random_rotation_matrix(torch.Generator().manual_seed(3),
                                           50, device="cpu")
    assert a.shape == (50, 3, 3) and torch.equal(a, b)
    q = torch.randn((50, 4), generator=torch.Generator().manual_seed(3))
    _close(a.numpy(), np.asarray(JR.quaternion_to_rotation_matrix(
        jnp.asarray(q.numpy()))))
    _close(np.linalg.det(a.numpy()), np.ones(50, np.float32))


def test_torch_port_general_utilities_match_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    y = rng.normal(size=(6, 4)).astype(np.float32)
    _close(TR.lerp(torch.as_tensor(x), torch.as_tensor(y), 0.3).numpy(),
           np.asarray(JR.lerp(jnp.asarray(x), jnp.asarray(y), 0.3)))
    for dim in (0, -1):
        _close(TR.append_value(torch.as_tensor(x), 2.5, dim=dim).numpy(),
               np.asarray(JR.append_value(jnp.asarray(x), 2.5, axis=dim)))
    _close(TR.append_zero(torch.as_tensor(x)).numpy(),
           np.asarray(JR.append_zero(jnp.asarray(x))))
    _close(TR.append_one(torch.as_tensor(x)).numpy(),
           np.asarray(JR.append_one(jnp.asarray(x))))
    n_ours, norm_ours = TR.normalize_tensor(torch.as_tensor(x),
                                            return_norm=True)
    n_ref, norm_ref = JR.normalize_tensor(jnp.asarray(x), return_norm=True)
    _close(n_ours.numpy(), np.asarray(n_ref))
    _close(norm_ours.numpy(), np.asarray(norm_ref))
    v = rng.normal(size=(5, 3)).astype(np.float32)
    _close(*_both("vector_cross_matrix", v))


def test_torch_port_angle_utilities_match_jax():
    rng = np.random.default_rng(12)
    q = rng.uniform(-20, 20, size=200).astype(np.float32)
    q[:4] = (np.pi, -np.pi, 0.0, 2 * np.pi)
    p = rng.uniform(-20, 20, size=200).astype(np.float32)
    _close(*_both("normalize_angle", q), tol=1e-5 * 20)
    _close(*_both("angle_difference", q, p), tol=1e-5 * 40)
    np.testing.assert_allclose(TR.radian_to_degree(torch.as_tensor(q)).numpy(),
                               np.asarray(JR.radian_to_degree(jnp.asarray(q))),
                               rtol=1e-6)
    np.testing.assert_allclose(TR.degree_to_radian(torch.as_tensor(q)).numpy(),
                               np.asarray(JR.degree_to_radian(jnp.asarray(q))),
                               rtol=1e-6)


def test_torch_port_numpy_helpers_match_jax():
    rng = np.random.default_rng(13)
    v = rng.normal(size=3)
    np.testing.assert_array_equal(TR.vector_cross_matrix_np(v),
                                  JR.vector_cross_matrix_np(v))
    blocks = [rng.normal(size=(2, 3)), rng.normal(size=(1, 1)),
              rng.normal(size=(3, 2))]
    np.testing.assert_array_equal(TR.block_diagonal_matrix_np(blocks),
                                  JR.block_diagonal_matrix_np(blocks))
    q = rng.uniform(-1, 1, size=(10, 3))
    for seq in ("XYZ", "zyx"):
        r_ours = TR.euler_angle_to_rotation_matrix_np(q, seq)
        r_ref = JR.euler_angle_to_rotation_matrix_np(q, seq)
        _close(r_ours, r_ref)
        _close(TR.rotation_matrix_to_euler_angle_np(r_ref, seq),
               JR.rotation_matrix_to_euler_angle_np(r_ref, seq))
    for qq in (q, q[0]):
        ours = TR.euler_convert_np(qq, "XYZ", "ZYX")
        ref = JR.euler_convert_np(qq, "XYZ", "ZYX")
        assert ours.shape == ref.shape
        _close(ours, ref)
