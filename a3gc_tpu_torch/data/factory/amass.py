r"""AMASS synthesis: raw AMASS mocap → synthetic IMU training data
(counterpart of ``a3gc_tpu/data/factory/amass.py``).

Per sequence: the SMPLH pose cut to SMPL's 24 joints, the global frame
turned onto DIP-IMU's, FK and 6890-vertex linear blend skinning in fp64
on the body model's device (the hot loop), accelerations synthesized from
the sensor vertices, then the training fields (root-free joint positions,
reduced global pose, TransPose IMU normalization) cut into 300-frame
chunks.
``sym=True`` adds the contralateral mirror of every sequence (CDA).

The raw-data walk is ``iter_amass_raw``; tests inject synthetic sequences
through ``raw_iter``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from a3gc_tpu_torch._device import index_tensor
from a3gc_tpu_torch.config import Paths
from a3gc_tpu_torch.data.factory import transform as TF
from a3gc_tpu_torch.ops import rotations as R
from a3gc_tpu_torch.smpl.model import ParametricModel

__all__ = ["TRAIN_SPLIT", "VAL_SPLIT", "AMASS_VI_MASK", "AMASS_JI_MASK",
           "iter_amass_raw", "synthesize_sequence", "process_amass_split"]

# corpora per split
TRAIN_SPLIT = ("BioMotionLab_NTroje", "BMLhandball", "BMLmovi", "CMU",
               "MPI_mosh", "DanceDB", "Eyes_Japan_Dataset", "MPI_HDM05", "KIT")
VAL_SPLIT = ("ACCAD", "DFaust67", "SFU", "EKUT", "HumanEva", "SSM_synced",
             "MPI_Limits")

# sensor mesh vertices / joints
AMASS_VI_MASK = (1961, 5424, 1177, 4662, 411, 3021)
AMASS_JI_MASK = (18, 19, 4, 5, 15, 0)

# AMASS → DIP global frame alignment
AMASS_ROT = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0.0]], np.float32)

# frames of one skinning call: the [frames, V, 3, 3] blend intermediates of
# ParametricModel.forward_kinematics stay near 0.5 GiB each at 6890 vertices
# in fp64
_LBS_CHUNK = 1024


def iter_amass_raw(raw_dir: str, datasets: Sequence[str]
                   ) -> Iterator[Dict[str, np.ndarray]]:
    r"""Walk AMASS npz files, resampled to 60 fps (120 fps: every second
    frame; 60 and 59 fps as they are; other rates and unreadable files
    skipped). Yields dicts with poses [T, 52, 3] (axis-angle), trans [T, 3],
    betas [10], id."""
    for ds_name in datasets:
        pattern = os.path.join(raw_dir, ds_name, ds_name, "*/*_poses.npz")
        for npz_fname in sorted(glob.glob(pattern)):
            try:
                cdata = np.load(npz_fname)
            except Exception:
                continue
            framerate = int(cdata["mocap_framerate"])
            if framerate == 120:
                step = 2
            elif framerate in (60, 59):
                step = 1
            else:
                continue
            yield {
                "poses": cdata["poses"][::step].astype(np.float32),
                "trans": cdata["trans"][::step].astype(np.float32),
                "betas": cdata["betas"][:10].astype(np.float32),
                "id": npz_fname,
            }


def _body_pose_24(poses: np.ndarray) -> np.ndarray:
    r"""52-joint SMPLH axis-angle → 24-joint SMPL body with the right hand
    remapped."""
    pose = poses.reshape(-1, 52, 3).copy()
    pose[:, 23] = pose[:, 37]
    return pose[:, :24]


def _align_global_frame(pose24: np.ndarray, trans: np.ndarray, device="cuda"):
    r"""Rotate the AMASS global frame onto DIP's: the translation on the
    host, the root rotation on ``device``."""
    trans = trans @ AMASS_ROT.T
    root = R.axis_angle_to_rotation_matrix(
        torch.as_tensor(pose24[:, 0], device=device))
    root = torch.as_tensor(AMASS_ROT, device=root.device)[None] @ root
    pose24 = pose24.copy()
    pose24[:, 0] = R.rotation_matrix_to_axis_angle(root).cpu().numpy()
    return pose24, trans


def _skin_sensors(model: ParametricModel, rot: torch.Tensor, shape, trans,
                  vi_mask, chunk: int = _LBS_CHUNK):
    r"""FK + LBS of local rotations ``rot`` [T, 24, 3, 3] on the model's
    device, ``chunk`` frames a call, keeping the ``vi_mask`` vertices of the
    mesh there: (R_global [T, J, 3, 3], joints [T, J, 3], sensor vertices
    [T, len(vi_mask), 3]), device tensors. Frames are independent, so the
    chunking changes no value."""
    shape = model.as_tensor(shape).reshape(1, -1)
    trans = model.as_tensor(trans).reshape(-1, 3)
    vi = index_tensor(tuple(vi_mask), rot.device)
    grot, joint, vert = [], [], []
    for s in range(0, rot.shape[0], chunk):
        g, j, v = model.forward_kinematics(rot[s:s + chunk], shape,
                                           trans[s:s + chunk], calc_mesh=True)
        grot.append(g)
        joint.append(j)
        vert.append(v.index_select(1, vi))
    return torch.cat(grot), torch.cat(joint), torch.cat(vert)


def synthesize_sequence(model: ParametricModel, pose24: np.ndarray,
                        shape: np.ndarray, trans: np.ndarray,
                        smooth_n: int = 4,
                        vi_mask=AMASS_VI_MASK,
                        ji_mask=AMASS_JI_MASK) -> Dict[str, np.ndarray]:
    r"""FK and the mesh of one sequence on the model's device, and its
    synthetic IMU readings: vertex finite-difference accelerations at the
    6 sensor vertices and global rotations at the 6 sensor joints.

    The skinning runs in frame chunks and only the sensor vertices of the
    mesh are copied to the host; frames are independent and the selected
    vertices are those the JAX package keeps after copying the whole mesh,
    so neither choice changes a value. FK and skinning run in fp64 and are
    rounded once to fp32, the JAX package's dtype: the finite difference
    multiplies the vertices' rounding by up to fps² / ACC_SCALE (120 at
    60 fps), and fp32 skinning, which the card and the CPU round
    differently, leaves their normalized accelerations up to ~1e-4 apart
    at a sequence's ends. The pose, its root aligned by
    :func:`_align_global_frame`, is an fp32 input, as in JAX.

    :return: dict with pose [T,24,3] aa, pose_global [T,24,3,3],
        joint [T,24,3], vrot [T,6,3,3], vacc [T,6,3], shape [10].
    """
    T = pose24.shape[0]
    model = model._astype(torch.float64)
    p = R.axis_angle_to_rotation_matrix(
        model.as_tensor(pose24.reshape(-1, 3))).reshape(T, 24, 3, 3)
    grot, joint, vert = (t.float().cpu().numpy() for t in _skin_sensors(
        model, p, shape, trans, vi_mask))
    vacc = TF.syn_acc(vert, smooth_n=smooth_n)
    return {
        "pose": pose24,
        "pose_global": grot,
        "joint": joint[:, :24],
        "vrot": grot[:, list(ji_mask)],
        "vacc": vacc,
        "shape": shape,
    }


def _transform_to_training(model: ParametricModel,
                           seq: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    r"""Synthesized sequence → training fields: root-free joint positions,
    reduced global pose, TransPose IMU normalization."""
    T = seq["pose"].shape[0]
    p = R.axis_angle_to_rotation_matrix(
        model.as_tensor(seq["pose"].reshape(-1, 3))).reshape(T, 24, 3, 3)
    p_rootfree = p.clone()
    p_rootfree[:, 0] = torch.eye(3, dtype=p.dtype, device=p.device)
    _, joint = model.forward_kinematics(p_rootfree,
                                        model.as_tensor(seq["shape"])
                                        .reshape(1, -1))
    p, full_pos = p.cpu().numpy(), joint[:, :24].cpu().numpy()
    smplg_re = TF.local_to_reduced_global(p, model.parent)
    ori_tp, acc_tp = TF.normalize_transpose(
        seq["vrot"].reshape(T, 54), seq["vacc"].reshape(T, 18))
    return {
        "ori": ori_tp.astype(np.float32),
        "acc": acc_tp.astype(np.float32),
        "leaf_pos": full_pos[:, TF.LEAF_NODES].astype(np.float32),
        "full_pos": full_pos.astype(np.float32),
        "pose": smplg_re.astype(np.float32),
    }


def process_amass_split(model: ParametricModel, mode: str = "train",
                        sym: bool = False,
                        raw_iter: Optional[Iterable[Dict]] = None,
                        out_path: Optional[str] = None,
                        chunk_size: int = 300,
                        paths: Optional[Paths] = None,
                        min_length: int = 13,
                        vi_mask=AMASS_VI_MASK,
                        ji_mask=AMASS_JI_MASK) -> List[Dict[str, np.ndarray]]:
    r"""Full AMASS pipeline: raw → synthetic IMU → training fields →
    ``chunk_size``-frame chunks (→ packed npz if ``out_path``). ``sym=True``
    adds the mirrored duplicate of every sequence (CDA). ``paths=None``
    reads the raw corpora under ``Paths()`` made at the call
    (``$A3GC_DATA_ROOT`` as it stands then)."""
    if raw_iter is None:
        paths = paths or Paths()
        datasets = TRAIN_SPLIT if mode == "train" else VAL_SPLIT
        raw_iter = iter_amass_raw(paths.resolve(paths.raw_amass_dir), datasets)

    sequences = []
    for raw in raw_iter:
        pose24 = _body_pose_24(raw["poses"])
        if pose24.shape[0] < min_length:
            continue
        pose24, trans = _align_global_frame(pose24, raw["trans"],
                                            model.device)
        variants = [pose24]
        if sym:
            variants.append(TF.mirror_pose_axis_angle(pose24))
        for pv in variants:
            synth = synthesize_sequence(model, pv, raw["betas"], trans,
                                        vi_mask=vi_mask, ji_mask=ji_mask)
            sequences.append(_transform_to_training(model, synth))

    chunks = TF.chunk_sequences(sequences, chunk_size)
    if out_path and chunks:
        TF.pack_dataset(chunks, out_path)
    return chunks
