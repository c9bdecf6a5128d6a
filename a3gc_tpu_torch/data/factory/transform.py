r"""Data-factory transforms (counterpart of
``a3gc_tpu/data/factory/transform.py``): IMU normalization, pose-space
conversion, mirroring, NaN fill, synthetic accelerations, chunking and
packing. Host numpy, as in the JAX package, but for ``mirror_imu``'s
rotation conversions, which run on a torch device in fp32.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from a3gc_tpu_torch.config import ACC_MIRROR, ACC_SCALE, ORI_MIRROR, SMPL_MIRROR
from a3gc_tpu_torch.config import joint_set as JS
from a3gc_tpu_torch.ops import rotations as R
from a3gc_tpu_torch.ops.kinematics import tree_levels

__all__ = [
    "normalize_transpose", "normalize_root_relative", "normalize_pos",
    "local_to_reduced_global", "reduced_local_to_reduced_global",
    "mirror_pose_axis_angle", "mirror_imu", "nan_fill_nearest",
    "chunk_sequences", "pack_dataset", "syn_acc",
]

SMPL_MAJOR_JOINTS = list(JS.reduced)
LEAF_NODES = [7, 8, 12, 20, 21]


# ---------------------------------------------------------------------------
# IMU normalization
# ---------------------------------------------------------------------------

def normalize_transpose(glb_ori: np.ndarray, glb_acc: np.ndarray):
    r"""TransPose-style root-relative normalization:
      acc' = [5 relative accs ‖ root acc] · R_root / acc_scale
      ori' = [R_rootᵀ · R_i (5 sensors) ‖ R_root]
    :return: (ori [T, 54], acc [T, 18]).
    """
    glb_acc = np.reshape(glb_acc, (-1, 6, 3))
    glb_ori = np.reshape(glb_ori, (-1, 6, 3, 3))
    acc = (np.concatenate((glb_acc[:, :5] - glb_acc[:, 5:], glb_acc[:, 5:]),
                          axis=1) @ glb_ori[:, -1]) / ACC_SCALE
    ori = np.concatenate(
        (np.swapaxes(glb_ori[:, 5:], -1, -2) @ glb_ori[:, :5],
         glb_ori[:, 5:]), axis=1)
    return ori.reshape(-1, 54), acc.reshape(-1, 18)


def normalize_root_relative(ori: np.ndarray, acc: np.ndarray, root: int = 5):
    r"""Legacy per-sensor normalization, root sensor dropped.
    :return: (ori [T, 45], acc [T, 15])."""
    ori = np.reshape(ori, (-1, 6, 3, 3)).copy()
    acc = np.reshape(acc, (-1, 6, 3)).copy()
    root_ori = ori[:, root]                               # [T,3,3]
    root_acc = acc[:, root]
    ori = np.einsum("tyx,tnyz->tnxz", root_ori, ori)      # R_rootᵀ · R_n
    acc = np.einsum("tyx,tny->tnx", root_ori, acc - root_acc[:, None])
    keep = [i for i in range(6) if i != root]
    return ori[:, keep].reshape(-1, 45), acc[:, keep].reshape(-1, 15)


def normalize_pos(full_pos: np.ndarray, leaf_pos: np.ndarray):
    r"""Root-relative positions: (leaf [T, 5, 3], full [T, 5, 3])."""
    leaf_pos = np.reshape(leaf_pos, (-1, 5, 3))
    full_pos = np.reshape(full_pos, (-1, 5, 3))
    root = full_pos[:, :1]
    return leaf_pos - root, full_pos - root


# ---------------------------------------------------------------------------
# pose-space conversion
# ---------------------------------------------------------------------------

def _batched_fk_np(local: np.ndarray, parent: Sequence[int]) -> np.ndarray:
    """Level-batched numpy FK over [T, 24, 3, 3]."""
    parent_t = tuple(-1 if (i == 0 or p is None) else int(p)
                     for i, p in enumerate(parent))
    glob = local.copy()
    for level in tree_levels(parent_t)[1:]:
        idx = list(level)
        pidx = [parent_t[i] for i in level]
        glob[:, idx] = np.einsum("tjxy,tjyz->tjxz", glob[:, pidx],
                                 local[:, idx])
    return glob


def local_to_reduced_global(smpl_pose: np.ndarray,
                            parent: Sequence[int]) -> np.ndarray:
    r"""Local 24-joint pose → reduced 15-joint GLOBAL rotmats, the root set
    to the identity first. [T, 24, 3, 3] (or [T, 216]) → [T, 135]."""
    pose = np.reshape(smpl_pose, (-1, 24, 3, 3)).copy()
    pose[:, 0] = np.eye(3)
    glob = _batched_fk_np(pose, parent)
    return glob[:, SMPL_MAJOR_JOINTS].reshape(-1, 135)


def reduced_local_to_reduced_global(reduced_pose: np.ndarray,
                                    parent: Sequence[int]) -> np.ndarray:
    r"""Reduced 15-joint LOCAL → reduced global. [T, 135] → [T, 135]."""
    T = np.reshape(reduced_pose, (-1, 135)).shape[0]
    local = np.tile(np.eye(3), (T, 24, 1, 1))
    local[:, SMPL_MAJOR_JOINTS] = np.reshape(reduced_pose, (T, 15, 3, 3))
    glob = _batched_fk_np(local, parent)
    return glob[:, SMPL_MAJOR_JOINTS].reshape(-1, 135)


# ---------------------------------------------------------------------------
# contralateral (mirror) augmentation — CDA
# ---------------------------------------------------------------------------

_ROT_MIRROR = np.array([1.0, -1.0, -1.0], np.float32)
_TRA_MIRROR = np.array([-1.0, 1.0, 1.0], np.float32)


def mirror_pose_axis_angle(pose: np.ndarray) -> np.ndarray:
    r"""Mirror an axis-angle pose: left/right joint permutation, x kept and
    y/z negated per axis-angle. [T, 24, 3]."""
    pose = np.reshape(pose, (-1, 24, 3))
    return (pose[:, list(SMPL_MIRROR)] * _ROT_MIRROR).astype(pose.dtype)


def mirror_imu(ori: np.ndarray, acc: np.ndarray, device="cuda"):
    r"""Mirror raw IMU data: sensor permutation, acc x-negation, ori mirrored
    through the axis-angle sign flip, the rotation conversions in fp32 on
    ``device`` and one copy back.

    :param ori: [T, 6, 3, 3]; :param acc: [T, 6, 3].
    """
    acc_m = acc[:, list(ACC_MIRROR)] * _TRA_MIRROR
    ori_p = ori[:, list(ORI_MIRROR)]
    aa = R.rotation_matrix_to_axis_angle(torch.as_tensor(
        ori_p.reshape(-1, 3, 3), dtype=torch.float32, device=device))
    aa = aa * torch.as_tensor(_ROT_MIRROR, device=aa.device)
    ori_m = R.axis_angle_to_rotation_matrix(aa).cpu().numpy().reshape(
        ori.shape)
    return ori_m.astype(ori.dtype), acc_m.astype(acc.dtype)


# ---------------------------------------------------------------------------
# NaN scrub
# ---------------------------------------------------------------------------

def nan_fill_nearest(x: np.ndarray, passes: int = 4) -> np.ndarray:
    r"""4-pass bidirectional nearest-neighbor NaN fill along frames: each
    pass first pulls from the previous frame, then from the next."""
    x = np.array(x, copy=True)
    for _ in range(passes):
        nan = np.isnan(x[1:])
        x[1:][nan] = x[:-1][nan]
        nan = np.isnan(x[:-1])
        x[:-1][nan] = x[1:][nan]
    return x


# ---------------------------------------------------------------------------
# synthetic accelerations
# ---------------------------------------------------------------------------

def syn_acc(vertices: np.ndarray, smooth_n: int = 4,
            fps: float = 60.0) -> np.ndarray:
    r"""Accelerometer readings from vertex trajectories by second-order
    finite differences, with a wider smoothed stencil in the interior.

    :param vertices: [T, S, 3] sensor-vertex positions.
    :return: [T, S, 3] accelerations.
    """
    v = np.asarray(vertices)
    T = v.shape[0]
    scale = fps * fps
    acc = np.zeros_like(v)
    if T > 2:
        acc[1:-1] = (v[:-2] + v[2:] - 2 * v[1:-1]) * scale
    mid = smooth_n // 2
    if mid != 0 and T > smooth_n * 2:
        acc[smooth_n:-smooth_n] = (
            (v[:-smooth_n * 2] + v[smooth_n * 2:]
             - 2 * v[smooth_n:-smooth_n]) * scale / (smooth_n ** 2))
    return acc


# ---------------------------------------------------------------------------
# chunking & packing
# ---------------------------------------------------------------------------

def chunk_sequences(sequences: Iterable[Dict[str, np.ndarray]],
                    chunk_size: int = 300) -> List[Dict[str, np.ndarray]]:
    r"""Cut each sequence dict into consecutive fixed-size windows, dropping
    the remainder."""
    out = []
    for seq in sequences:
        T = len(next(iter(seq.values())))
        for i in range(T // chunk_size):
            sl = slice(chunk_size * i, chunk_size * (i + 1))
            out.append({k: v[sl] for k, v in seq.items()})
    return out


def pack_dataset(chunks: Sequence[Dict[str, np.ndarray]], path: str,
                 fields: Optional[Sequence[str]] = None) -> str:
    r"""Stack equal-length chunk dicts into one npz of fp32 arrays (the
    schema ``data.pipeline.load_packed`` reads)."""
    fields = fields or list(chunks[0].keys())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    packed = {f: np.stack([c[f] for c in chunks]).astype(np.float32)
              for f in fields}
    np.savez(path, **packed)
    return path
