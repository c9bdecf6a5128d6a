r"""Articulated-body kinematics on a kinematic tree (counterpart of
``a3gc_tpu/ops/kinematics.py``), fp32 on the input's device.

Joints are grouped by tree depth, so forward kinematics is one gather and
one batched matmul per level (8 levels for SMPL) and inverse kinematics one
gather and one matmul in all, since a joint's local rotation depends only on
its parent's global one. Parent lists are tuples; the index tensors of each
level are cached per device."""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from a3gc_tpu_torch._device import index_tensor

__all__ = [
    "transformation_matrix", "transformation_matrix_np",
    "adjoint_transformation_matrix_np", "decode_transformation_matrix",
    "inverse_transformation_matrix", "bone_vector_to_joint_position",
    "joint_position_to_bone_vector", "forward_kinematics_R",
    "inverse_kinematics_R", "forward_kinematics_T", "inverse_kinematics_T",
    "forward_kinematics", "tree_levels",
]


def _canonical_parent(parent: Sequence[Optional[int]]) -> Tuple[int, ...]:
    """Parent list with the root marked as -1 (accepts None / -1 at index 0)."""
    out = []
    for i, p in enumerate(parent):
        if i == 0 or p is None or p < 0:
            out.append(-1)
        else:
            if p >= i:
                raise ValueError("parent[i] must be smaller than i")
            out.append(int(p))
    return tuple(out)


@lru_cache(maxsize=None)
def tree_levels(parent: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """Group joint indices by depth. level[0] = roots, level[d] = depth-d
    joints."""
    parent = _canonical_parent(parent)
    depth = [0] * len(parent)
    for i, p in enumerate(parent):
        if p >= 0:
            depth[i] = depth[p] + 1
    levels = [[] for _ in range(max(depth) + 1)]
    for i, d in enumerate(depth):
        levels[d].append(i)
    return tuple(tuple(l) for l in levels)


def _level_indices(parent, device):
    r"""Per level below the roots: (joint index, parent index) tensors."""
    parent = _canonical_parent(tuple(parent))
    return [(index_tensor(level, device),
             index_tensor(tuple(parent[i] for i in level), device))
            for level in tree_levels(parent)[1:]]


# ---------------------------------------------------------------------------
# homogeneous transforms
# ---------------------------------------------------------------------------

def transformation_matrix(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    r"""T ∈ SE(3) from R [*, 3, 3] and p [*, 3]. [*, 4, 4]."""
    Rp = torch.cat((R, p[..., None]), dim=-1)
    bottom = torch.zeros(Rp.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat((Rp, bottom), dim=-2)


def decode_transformation_matrix(T: torch.Tensor):
    r"""Split T into (R, p)."""
    return T[..., :3, :3], T[..., :3, 3]


def inverse_transformation_matrix(T: torch.Tensor) -> torch.Tensor:
    r"""Closed-form SE(3) inverse."""
    R, p = decode_transformation_matrix(T)
    invR = R.transpose(-1, -2)
    invp = -torch.matmul(invR, p[..., None])[..., 0]
    return transformation_matrix(invR, invp)


# ---------------------------------------------------------------------------
# level-batched tree reductions
# ---------------------------------------------------------------------------

def _forward_tree_matmul(x_local: torch.Tensor, parent) -> torch.Tensor:
    """Compose square matrices root → leaf. [B, J, k, k] → [B, J, k, k]."""
    x_global = x_local.clone()
    for idx, pidx in _level_indices(parent, x_local.device):
        x_global[:, idx] = torch.matmul(x_global[:, pidx], x_local[:, idx])
    return x_global


def _forward_tree_add(x_local: torch.Tensor, parent) -> torch.Tensor:
    """Accumulate vectors root → leaf (prefix sums along branches)."""
    x_global = x_local.clone()
    for idx, pidx in _level_indices(parent, x_local.device):
        x_global[:, idx] = x_global[:, pidx] + x_local[:, idx]
    return x_global


def _parent_gather(x: torch.Tensor, parent) -> torch.Tensor:
    """x[:, parent[i]] with the root mapped to itself."""
    parent = _canonical_parent(tuple(parent))
    pidx = tuple(p if p >= 0 else i for i, p in enumerate(parent))
    return x[:, index_tensor(pidx, x.device)]


def _root_mask(parent, device, dtype=torch.float32) -> torch.Tensor:
    parent = _canonical_parent(tuple(parent))
    mask = index_tensor(tuple(1 if p < 0 else 0 for p in parent), device)
    return mask.to(dtype)


# ---------------------------------------------------------------------------
# public tree ops
# ---------------------------------------------------------------------------

def bone_vector_to_joint_position(bone_vec: torch.Tensor,
                                  parent) -> torch.Tensor:
    r"""Bone vectors → joint positions in the base frame. [B, J, 3]."""
    bone_vec = bone_vec.reshape(bone_vec.shape[0], -1, 3)
    return _forward_tree_add(bone_vec, parent)


def joint_position_to_bone_vector(joint_pos: torch.Tensor,
                                  parent) -> torch.Tensor:
    r"""Joint positions → bone vectors: bone[i] = pos[i] - pos[parent[i]],
    the root keeping its position. [B, J, 3]."""
    joint_pos = joint_pos.reshape(joint_pos.shape[0], -1, 3)
    parent_pos = _parent_gather(joint_pos, parent)
    mask = _root_mask(parent, joint_pos.device, joint_pos.dtype)[
        None, :, None]
    return joint_pos - parent_pos * (1.0 - mask)


def forward_kinematics_R(R_local: torch.Tensor, parent) -> torch.Tensor:
    r"""Local → global joint rotations. [B, J·9 | J, 3, 3] → [B, J, 3, 3]."""
    R_local = R_local.reshape(R_local.shape[0], -1, 3, 3)
    return _forward_tree_matmul(R_local, parent)


def inverse_kinematics_R(R_global: torch.Tensor, parent) -> torch.Tensor:
    r"""Global → local joint rotations: R_local[i] = R_global[parent[i]]ᵀ @
    R_global[i], the root keeping its global rotation. One gather and one
    batched matmul. [B, J·9 | J, 3, 3] → [B, J, 3, 3]."""
    R_global = R_global.reshape(R_global.shape[0], -1, 3, 3)
    parent_R = _parent_gather(R_global, parent)
    local = torch.matmul(parent_R.transpose(-1, -2), R_global)
    mask = _root_mask(parent, R_global.device, R_global.dtype)[
        None, :, None, None]
    return local * (1.0 - mask) + R_global * mask


def forward_kinematics_T(T_local: torch.Tensor, parent) -> torch.Tensor:
    r"""Local → global homogeneous transforms. [B, J, 4, 4]."""
    T_local = T_local.reshape(T_local.shape[0], -1, 4, 4)
    return _forward_tree_matmul(T_local, parent)


def inverse_kinematics_T(T_global: torch.Tensor, parent) -> torch.Tensor:
    r"""Global → local homogeneous transforms, as
    :func:`inverse_kinematics_R`. [B, J, 4, 4]."""
    T_global = T_global.reshape(T_global.shape[0], -1, 4, 4)
    parent_T = _parent_gather(T_global, parent)
    local = torch.matmul(inverse_transformation_matrix(parent_T), T_global)
    mask = _root_mask(parent, T_global.device, T_global.dtype)[
        None, :, None, None]
    return local * (1.0 - mask) + T_global * mask


def forward_kinematics(R_local: torch.Tensor, p_local: torch.Tensor, parent):
    r"""FK for rotations and positions together: R_global by rotation FK,
    then p_global[i] = p_global[parent] + R_global[parent] @ p_local[i],
    level by level, in 3×3 math (no 4×4 chains).
    :return: (R_global [B, J, 3, 3], p_global [B, J, 3])."""
    B = R_local.shape[0]
    R_local = R_local.reshape(B, -1, 3, 3)
    p_local = p_local.reshape(B, -1, 3)
    R_global = _forward_tree_matmul(R_local, parent)
    p_global = p_local.clone()
    for idx, pidx in _level_indices(parent, R_local.device):
        moved = torch.matmul(R_global[:, pidx], p_local[:, idx, :, None])
        p_global[:, idx] = p_global[:, pidx] + moved[..., 0]
    return R_global, p_global


# ---------------------------------------------------------------------------
# numpy single-item helpers
# ---------------------------------------------------------------------------

def transformation_matrix_np(R, p) -> np.ndarray:
    r"""Homogeneous transform [4, 4] from R [3, 3] and p [3]."""
    T = np.zeros((4, 4))
    T[:3, :3] = np.asarray(R)
    T[:3, 3] = np.asarray(p)
    T[3, 3] = 1
    return T


def adjoint_transformation_matrix_np(R, p) -> np.ndarray:
    r"""Adjoint representation [Ad_T] [6, 6] of T = (R, p)."""
    from a3gc_tpu_torch.ops.rotations import vector_cross_matrix_np

    R = np.asarray(R)
    AdT = np.zeros((6, 6))
    AdT[:3, :3] = R
    AdT[3:, 3:] = R
    AdT[3:, :3] = vector_cross_matrix_np(p) @ R
    return AdT
