r"""Rotation representations and conversions (counterpart of
``a3gc_tpu/ops/rotations.py``), fp32 torch on whatever device the input lies
on.

Conventions as there: quaternions are wxyz; Euler angles use scipy-style
sequences ('XYZ' intrinsic / 'xyz' extrinsic); 6D rotation vectors are the
first two columns of the rotation matrix flattened column by column. Every
function accepts leading batch dims where the JAX one does and returns the
same [N, ...] layout.

``project_to_rotation`` runs one batched SVD over all its matrices: the JAX
package's chunking of that batch bounds TPU scoped vmem, which a card does
not have.
"""

from __future__ import annotations

import enum
from functools import partial

import numpy as np
import torch

__all__ = [
    "RotationRepresentation", "to_rotation_matrix", "radian_to_degree",
    "degree_to_radian", "normalize_angle", "angle_difference", "angle_between",
    "svd_rotate", "generate_random_rotation_matrix",
    "axis_angle_to_rotation_matrix", "rotation_matrix_to_axis_angle",
    "project_to_rotation",
    "r6d_to_rotation_matrix", "rotation_matrix_to_r6d",
    "quaternion_to_axis_angle", "axis_angle_to_quaternion",
    "quaternion_to_rotation_matrix", "rotation_matrix_to_quaternion",
    "rotation_matrix_to_euler_angle", "euler_angle_to_rotation_matrix",
    "lerp", "normalize_tensor", "append_value", "append_zero", "append_one",
    "vector_cross_matrix", "vector_cross_matrix_np",
    "block_diagonal_matrix_np", "rotation_matrix_to_euler_angle_np",
    "euler_angle_to_rotation_matrix_np", "euler_convert_np",
]

_EPS = 1e-8


class RotationRepresentation(enum.Enum):
    r"""Rotation representations."""

    AXIS_ANGLE = 0
    ROTATION_MATRIX = 1
    QUATERNION = 2
    R6D = 3
    EULER_ANGLE = 4


# ---------------------------------------------------------------------------
# general utils
# ---------------------------------------------------------------------------

def lerp(a, b, t):
    r"""Unclamped linear interpolation."""
    return a * (1 - t) + b * t


def normalize_tensor(x: torch.Tensor, dim: int = -1,
                     return_norm: bool = False):
    r"""Normalize to unit norm along ``dim``; a zero vector gives NaN, which
    the callers scrub where the JAX package does."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    normalized = x / norm
    return (normalized, norm) if return_norm else normalized


def append_value(x: torch.Tensor, value: float, dim: int = -1) -> torch.Tensor:
    r"""Append a constant slice along ``dim``."""
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat((x, x.new_full(shape, value)), dim=dim)


append_zero = partial(append_value, value=0.0)
append_one = partial(append_value, value=1.0)


def vector_cross_matrix(x: torch.Tensor) -> torch.Tensor:
    r"""Skew-symmetric matrix :math:`[v]_\times` per vector. [N, 3, 3]."""
    x = x.reshape(-1, 3)
    zeros = torch.zeros_like(x[:, 0])
    m = torch.stack(
        (zeros, -x[:, 2], x[:, 1],
         x[:, 2], zeros, -x[:, 0],
         -x[:, 1], x[:, 0], zeros), dim=1)
    return m.reshape(-1, 3, 3)


# ---------------------------------------------------------------------------
# angles
# ---------------------------------------------------------------------------

def radian_to_degree(q):
    return q * (180.0 / np.pi)


def degree_to_radian(q):
    return q * (np.pi / 180.0)


def normalize_angle(q: torch.Tensor) -> torch.Tensor:
    r"""Normalize radians into [-pi, pi)."""
    mod = torch.remainder(q, 2 * np.pi)
    return torch.where(mod >= np.pi, mod - 2 * np.pi, mod)


def angle_difference(target, source):
    r"""Normalized target - source."""
    return normalize_angle(target - source)


def _det3(m: torch.Tensor) -> torch.Tensor:
    r"""Determinants of a batch of 3×3 matrices, closed form."""
    return torch.sum(m[..., 0, :] * torch.linalg.cross(m[..., 1, :],
                                                       m[..., 2, :], dim=-1),
                     dim=-1)


def project_to_rotation(m: torch.Tensor) -> torch.Tensor:
    r"""Project matrices to the nearest proper rotation: U·Vᵀ of a batched
    3×3 SVD with the reflection fix (the last column of U flipped where
    det(U·Vᵀ) < 0). The result does not depend on the signs the SVD gives U
    and V (LAPACK and cuSOLVER differ there) wherever the two smallest
    singular values differ. cv2.Rodrigues projects this way on every input,
    so a path that must match the reference's angles on non-orthonormal
    input (the nets' raw 9D outputs) projects first. [..., 3, 3] → [N, 3, 3].
    """
    m = m.reshape(-1, 3, 3)
    u, _, vh = torch.linalg.svd(m)
    sign = torch.sign(_det3(u) * _det3(vh))
    u = torch.cat((u[..., :2], u[..., 2:] * sign[:, None, None]), dim=-1)
    return torch.matmul(u, vh)


def angle_between(rot1: torch.Tensor, rot2: torch.Tensor,
                  rep: RotationRepresentation =
                  RotationRepresentation.ROTATION_MATRIX,
                  project: bool = True) -> torch.Tensor:
    r"""Angle in radians between two batches of rotations. ``project=True``
    snaps the relative rotation r1ᵀ·r2 to the nearest rotation first, as
    the reference's cv2.Rodrigues does (the nets emit unconstrained 9D
    matrices); the angle is then read off with the atan2 form, exact over
    [0, π] and stable at both ends. [N]."""
    r1 = to_rotation_matrix(rot1, rep)
    r2 = to_rotation_matrix(rot2, rep)
    offset = torch.matmul(r1.transpose(-1, -2), r2)
    if project:
        offset = project_to_rotation(offset)
    trace = offset[..., 0, 0] + offset[..., 1, 1] + offset[..., 2, 2]
    w = torch.stack((
        offset[..., 2, 1] - offset[..., 1, 2],
        offset[..., 0, 2] - offset[..., 2, 0],
        offset[..., 1, 0] - offset[..., 0, 1]), dim=-1)
    sin_theta = 0.5 * torch.linalg.vector_norm(w, dim=-1)
    cos_theta = 0.5 * (trace - 1.0)
    return torch.atan2(sin_theta, cos_theta)


# ---------------------------------------------------------------------------
# axis-angle <-> rotation matrix
# ---------------------------------------------------------------------------

def axis_angle_to_rotation_matrix(a: torch.Tensor) -> torch.Tensor:
    r"""Rodrigues formula, batch. [..., 3] → [N, 3, 3]."""
    a = a.reshape(-1, 3)
    angle = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    axis = torch.where(angle > _EPS, a / torch.clamp(angle, min=_EPS),
                       torch.zeros_like(a))
    angle = angle[..., None]                                    # [N, 1, 1]
    c = torch.cos(angle)
    s = torch.sin(angle)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(
        a.shape[0], 3, 3)
    outer = axis[:, :, None] * axis[:, None, :]
    return c * eye + (1 - c) * outer + s * vector_cross_matrix(axis)


def rotation_matrix_to_axis_angle(r: torch.Tensor,
                                  project: bool = False) -> torch.Tensor:
    r"""Closed-form SO(3) log map, batch. [..., 3, 3] → [N, 3].

    ``project=True`` snaps the input to the nearest rotation first, as
    cv2.Rodrigues does on non-orthonormal input. Three regimes, chosen per
    matrix without a branch on the host:

      * generic:  axis = vee(R - Rᵀ) / (2 sin θ), θ = atan2(|w|, (tr-1)/2)
      * θ → 0:    aa ≈ vee(R - Rᵀ)/2 · (1 + θ²/6 + 7θ⁴/360)
      * θ → π:    axis² from diag(R) = cos θ + (1 - cos θ) axis², signs from
                  the symmetric off-diagonals
    """
    r = r.reshape(-1, 3, 3)
    if project:
        r = project_to_rotation(r)
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    w = 0.5 * torch.stack((
        r[..., 2, 1] - r[..., 1, 2],
        r[..., 0, 2] - r[..., 2, 0],
        r[..., 1, 0] - r[..., 0, 1]), dim=-1)              # = sin θ · axis
    sin_theta = torch.linalg.vector_norm(w, dim=-1)
    cos_theta = 0.5 * (trace - 1.0)
    theta = torch.atan2(sin_theta, cos_theta)

    # generic / small-angle factor θ / sin θ, Taylor-expanded near 0
    small = theta < 1e-3
    t2 = theta * theta
    factor = torch.where(
        small,
        1.0 + t2 / 6.0 + 7.0 * t2 * t2 / 360.0,
        theta / torch.where(small, torch.ones_like(sin_theta),
                            torch.clamp(sin_theta, min=_EPS)))
    aa_generic = w * factor[..., None]

    # near π: sin θ ≈ 0, the axis comes from the symmetric part
    one_minus_cos = torch.clamp(1.0 - cos_theta, min=_EPS)
    diag = torch.stack((r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]), dim=-1)
    axis_sq = torch.clamp((diag - cos_theta[..., None])
                          / one_minus_cos[..., None], 0.0, 1.0)
    axis_abs = torch.sqrt(axis_sq)
    # the dominant component positive, the others signed by the symmetric
    # off-diagonal products (R_ij + R_ji)/2 = (1 - cos θ) a_i a_j
    s01 = torch.sign(r[..., 0, 1] + r[..., 1, 0])
    s02 = torch.sign(r[..., 0, 2] + r[..., 2, 0])
    s12 = torch.sign(r[..., 1, 2] + r[..., 2, 1])
    dominant = torch.argmax(axis_abs, dim=-1)
    ax, ay, az = axis_abs.unbind(-1)
    cand0 = torch.stack((ax, ay * s01, az * s02), dim=-1)
    cand1 = torch.stack((ax * s01, ay, az * s12), dim=-1)
    cand2 = torch.stack((ax * s02, ay * s12, az), dim=-1)
    axis_pi = torch.where(
        (dominant == 0)[..., None], cand0,
        torch.where((dominant == 1)[..., None], cand1, cand2))
    # orient with the (tiny but signed) antisymmetric part, so the result
    # is continuous with the generic branch
    w_dot = torch.sum(axis_pi * w, dim=-1, keepdim=True)
    axis_pi = torch.where(w_dot < 0, -axis_pi, axis_pi)
    aa_pi = axis_pi * theta[..., None]

    near_pi = cos_theta < -1.0 + 1e-4
    return torch.where(near_pi[..., None], aa_pi, aa_generic)


# ---------------------------------------------------------------------------
# 6D representation
# ---------------------------------------------------------------------------

def r6d_to_rotation_matrix(r6d: torch.Tensor) -> torch.Tensor:
    r"""Gram-Schmidt 6D → R, batch. [..., 6] → [M, 3, 3]. NaNs from
    degenerate input are scrubbed to 0 (infinities to the largest finite
    float, as ``jnp.nan_to_num`` does)."""
    r6d = r6d.reshape(-1, 6)
    col0 = normalize_tensor(r6d[:, 0:3])
    col1 = (r6d[:, 3:6]
            - torch.sum(col0 * r6d[:, 3:6], dim=1, keepdim=True) * col0)
    col1 = normalize_tensor(col1)
    col2 = torch.linalg.cross(col0, col1, dim=-1)
    r = torch.stack((col0, col1, col2), dim=-1)
    return torch.nan_to_num(r, nan=0.0)


def rotation_matrix_to_r6d(r: torch.Tensor) -> torch.Tensor:
    r"""R → 6D: the first two columns, one after the other. [N, 6]."""
    r = r.reshape(-1, 3, 3)
    return r[:, :, :2].transpose(1, 2).reshape(-1, 6)


# ---------------------------------------------------------------------------
# quaternions (wxyz)
# ---------------------------------------------------------------------------

def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    r"""Quaternion wxyz → axis-angle. [N, 3]. The angle is 2·acos(w) in
    [0, 2π) with w clamped; the zero rotation gives 0."""
    q = normalize_tensor(q.reshape(-1, 4))
    theta_half = torch.acos(torch.clamp(q[:, 0], -1.0, 1.0))
    sin_half = torch.sin(theta_half)
    big = torch.abs(sin_half) > _EPS
    scale = torch.where(
        big, 2.0 * theta_half / torch.where(big, sin_half,
                                            torch.ones_like(sin_half)),
        torch.full_like(sin_half, 2.0))    # 2θ/sin θ → 2 as θ → 0
    return q[:, 1:] * scale[:, None]


def axis_angle_to_quaternion(a: torch.Tensor) -> torch.Tensor:
    r"""Axis-angle → quaternion wxyz. [N, 4]."""
    a = a.reshape(-1, 3)
    angle = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    axis = torch.where(angle > _EPS, a / torch.clamp(angle, min=_EPS),
                       torch.zeros_like(a))
    half = angle / 2
    return torch.cat((torch.cos(half), torch.sin(half) * axis), dim=1)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    r"""(Unnormalized) quaternion wxyz → R. [N, 3, 3]."""
    q = normalize_tensor(q.reshape(-1, 4))
    a, b, c, d = q.unbind(1)
    r = torch.stack((
        1 - 2 * (c * c + d * d), 2 * (b * c - a * d), 2 * (a * c + b * d),
        2 * (b * c + a * d), 1 - 2 * (b * b + d * d), 2 * (c * d - a * b),
        2 * (b * d - a * c), 2 * (a * b + c * d), 1 - 2 * (b * b + c * c)),
        dim=1)
    return r.reshape(-1, 3, 3)


def rotation_matrix_to_quaternion(r: torch.Tensor) -> torch.Tensor:
    r"""R → quaternion wxyz by Shepperd's method (the largest of the trace
    and the diagonal picks the formula per matrix). [N, 4]."""
    r = r.reshape(-1, 3, 3)
    m00, m01, m02 = r[:, 0, 0], r[:, 0, 1], r[:, 0, 2]
    m10, m11, m12 = r[:, 1, 0], r[:, 1, 1], r[:, 1, 2]
    m20, m21, m22 = r[:, 2, 0], r[:, 2, 1], r[:, 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) / 2

    qw0 = root(1 + tr)
    q0 = torch.stack((qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)), dim=-1)
    qx1 = root(1 + m00 - m11 - m22)
    q1 = torch.stack(((m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)), dim=-1)
    qy2 = root(1 - m00 + m11 - m22)
    q2 = torch.stack(((m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)), dim=-1)
    qz3 = root(1 - m00 - m11 + m22)
    q3 = torch.stack(((m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3), dim=-1)

    idx = torch.argmax(torch.stack((tr, m00, m11, m22), dim=-1), dim=-1)
    q = torch.where((idx == 0)[:, None], q0,
                    torch.where((idx == 1)[:, None], q1,
                                torch.where((idx == 2)[:, None], q2, q3)))
    return normalize_tensor(q)


# ---------------------------------------------------------------------------
# Euler angles (closed form, scipy conventions)
# ---------------------------------------------------------------------------

_AXIS_IDX = {"X": 0, "Y": 1, "Z": 2, "x": 0, "y": 1, "z": 2}


def _single_axis_matrix(axis: int, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one = torch.ones_like(angle)
    zero = torch.zeros_like(angle)
    if axis == 0:
        rows = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == 1:
        rows = (c, zero, s, zero, one, zero, -s, zero, c)
    else:
        rows = (c, -s, zero, s, c, zero, zero, zero, one)
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_angle_to_rotation_matrix(q: torch.Tensor,
                                   seq: str = "XYZ") -> torch.Tensor:
    r"""Euler → R as scipy.spatial.transform.Rotation: uppercase =
    intrinsic (R = R1 @ R2 @ R3), lowercase = extrinsic (R = R3 @ R2 @ R1).
    [N, 3, 3]."""
    if len(seq) != 3:
        raise ValueError(f"an Euler sequence has three axes, got {seq!r}")
    q = q.reshape(-1, 3)
    ms = [_single_axis_matrix(_AXIS_IDX[ax], q[:, i])
          for i, ax in enumerate(seq)]
    if seq.isupper():
        return torch.matmul(torch.matmul(ms[0], ms[1]), ms[2])
    return torch.matmul(torch.matmul(ms[2], ms[1]), ms[0])


def rotation_matrix_to_euler_angle(r: torch.Tensor,
                                   seq: str = "XYZ") -> torch.Tensor:
    r"""R → Euler as scipy, for proper (Tait-Bryan) sequences, all three
    axes distinct. Extrinsic 'abc' is the reverse of intrinsic 'CBA'. At
    gimbal lock everything folds into the first angle and the third is 0.
    [N, 3]."""
    if len(seq) != 3:
        raise ValueError(f"an Euler sequence has three axes, got {seq!r}")
    if not seq.isupper():
        return torch.flip(
            rotation_matrix_to_euler_angle(r, seq[::-1].upper()), dims=(1,))
    i, j, k = (_AXIS_IDX[ax] for ax in seq)
    if len({i, j, k}) != 3:
        raise ValueError("only proper (Tait-Bryan) sequences are supported, "
                         f"got {seq!r}")
    r = r.reshape(-1, 3, 3)
    # parity of the axis permutation; R = Ri(a) Rj(b) Rk(c) has
    # R[i, k] = eps · sin(b)
    eps = 1.0 if (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1.0
    sin_b = torch.clamp(eps * r[:, i, k], -1.0, 1.0)
    b = torch.asin(sin_b)
    a = torch.atan2(-eps * r[:, j, k], r[:, k, k])
    c = torch.atan2(-eps * r[:, i, j], r[:, i, i])
    locked = torch.abs(sin_b) > 1.0 - 1e-7
    a = torch.where(locked, torch.atan2(eps * r[:, j, i], r[:, j, j]), a)
    c = torch.where(locked, torch.zeros_like(c), c)
    return torch.stack((a, b, c), dim=-1)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def to_rotation_matrix(r: torch.Tensor,
                       rep: RotationRepresentation) -> torch.Tensor:
    r"""Convert any representation to rotation matrices [N, 3, 3]."""
    if rep == RotationRepresentation.AXIS_ANGLE:
        return axis_angle_to_rotation_matrix(r)
    if rep == RotationRepresentation.QUATERNION:
        return quaternion_to_rotation_matrix(r)
    if rep == RotationRepresentation.R6D:
        return r6d_to_rotation_matrix(r)
    if rep == RotationRepresentation.EULER_ANGLE:
        return euler_angle_to_rotation_matrix(r)
    if rep == RotationRepresentation.ROTATION_MATRIX:
        return r.reshape(-1, 3, 3)
    raise ValueError(f"unknown rotation representation: {rep}")


def svd_rotate(source_points: torch.Tensor,
               target_points: torch.Tensor) -> torch.Tensor:
    r"""Kabsch: the rotations mapping source → target point sets [B, M, 3]
    (batched SVD, the reflection fixed by flipping V's last column where
    det(V·Uᵀ) < 0). [B, 3, 3]."""
    m = torch.matmul(source_points.transpose(-1, -2), target_points)
    u, _, vh = torch.linalg.svd(m)
    v = vh.transpose(-1, -2)
    flip = torch.where(_det3(v) * _det3(u) < 0, -1.0, 1.0).to(m.dtype)
    v = torch.cat((v[..., :2], v[..., 2:] * flip[..., None, None]), dim=-1)
    return torch.matmul(v, u.transpose(-1, -2))


def generate_random_rotation_matrix(gen: torch.Generator, n: int = 1,
                                    device="cpu") -> torch.Tensor:
    r"""Uniform random rotations from normalized Gaussian quaternions
    (exactly uniform on SO(3)), drawn from ``gen`` on the CPU and moved to
    ``device``. [n, 3, 3]."""
    q = torch.randn((n, 4), generator=gen)
    return quaternion_to_rotation_matrix(q).to(device)


# ---------------------------------------------------------------------------
# numpy single-item helpers (host-side utilities, not compute paths)
# ---------------------------------------------------------------------------

def vector_cross_matrix_np(x) -> np.ndarray:
    r"""Skew-symmetric matrix of one 3-vector."""
    x = np.asarray(x).reshape(3)
    return np.array([[0, -x[2], x[1]],
                     [x[2], 0, -x[0]],
                     [-x[1], x[0], 0]], dtype=float)


def block_diagonal_matrix_np(matrix2d_list) -> np.ndarray:
    r"""Block-diagonal matrix from 2-D blocks."""
    shapes = np.array([np.asarray(m).shape for m in matrix2d_list])
    out = np.zeros(shapes.sum(axis=0))
    r = c = 0
    for m in matrix2d_list:
        m = np.asarray(m)
        lr, lc = m.shape
        out[r:r + lr, c:c + lc] = m
        r += lr
        c += lc
    return out


def rotation_matrix_to_euler_angle_np(r, seq: str = "XYZ") -> np.ndarray:
    r"""R → Euler, numpy batch (computed in fp32)."""
    r = torch.as_tensor(np.asarray(r, np.float64).reshape(-1, 3, 3),
                        dtype=torch.float32)
    return rotation_matrix_to_euler_angle(r, seq).numpy()


def euler_angle_to_rotation_matrix_np(q, seq: str = "XYZ") -> np.ndarray:
    r"""Euler → R, numpy batch (computed in fp32)."""
    q = torch.as_tensor(np.asarray(q, np.float64).reshape(-1, 3),
                        dtype=torch.float32)
    return euler_angle_to_rotation_matrix(q, seq).numpy()


def euler_convert_np(q, from_seq: str = "XYZ",
                     to_seq: str = "XYZ") -> np.ndarray:
    r"""Re-express Euler angles in another axis order, through the rotation
    matrix."""
    q = np.asarray(q, np.float64)
    single = q.ndim == 1
    mats = euler_angle_to_rotation_matrix_np(q.reshape(-1, 3), from_seq)
    out = rotation_matrix_to_euler_angle_np(mats, to_seq)
    return out[0] if single else out.reshape(q.shape)
