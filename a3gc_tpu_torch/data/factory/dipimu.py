r"""DIP-IMU preprocessing: raw sensor pickles → test / train / valid sets
(counterpart of ``a3gc_tpu/data/factory/dipimu.py``):

  * the 6-sensor subset ``IMU_MASK``,
  * the 4-pass nearest-neighbor NaN fill and the 6-frame head/tail trim,
  * sequences whose NaNs survive the fill are discarded,
  * the optional contralateral mirror of pose AND raw IMU,
  * FK joint positions and reduced-global pose targets, the rotation
    conversions and the FK on the body model's device.

The raw walk is ``iter_dipimu_raw``; tests inject synthetic sequences
through ``raw_iter``. ``load_test_sequences`` reads a test split back.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from a3gc_tpu_torch.config import Paths
from a3gc_tpu_torch.data.factory import transform as TF
from a3gc_tpu_torch.ops import rotations as R
from a3gc_tpu_torch.smpl.model import ParametricModel

__all__ = ["IMU_MASK", "TEST_SPLIT", "VALID_FILE_ID_BASES", "iter_dipimu_raw",
           "preprocess_sequence", "process_dipimu", "load_test_sequences"]

IMU_MASK = (7, 8, 11, 12, 0, 2)
TEST_SPLIT = ("s_09", "s_10")
VALID_FILE_ID_BASES = ("s_01_05", "s_03_05", "s_07_04")
TRIM = 6                                     # head/tail frames


def iter_dipimu_raw(raw_dir: str, split: str = "test"
                    ) -> Iterator[Dict[str, np.ndarray]]:
    r"""Walk raw DIP-IMU subject pickles (``raw_dir/<subject>/<motion>.pkl``)
    selecting a split: test = subjects ``TEST_SPLIT``; valid = the motions
    ``VALID_FILE_ID_BASES`` of the other subjects; train = the rest. Yields
    acc [T,6,3], ori [T,6,3,3], pose [T,72] axis-angle, id."""
    assert split in ("test", "train", "valid")
    for subject in sorted(os.listdir(raw_dir)):
        in_test = subject in TEST_SPLIT
        if (split == "test") != in_test and split == "test":
            continue
        if split != "test" and in_test:
            continue
        subj_dir = os.path.join(raw_dir, subject)
        if not os.path.isdir(subj_dir):
            continue
        for motion in sorted(os.listdir(subj_dir)):
            file_id = subject + "_" + motion[:-4]
            if split == "train" and file_id in VALID_FILE_ID_BASES:
                continue
            if split == "valid" and file_id not in VALID_FILE_ID_BASES:
                continue
            with open(os.path.join(subj_dir, motion), "rb") as f:
                data = pickle.load(f, encoding="latin1")
            yield {
                "acc": np.asarray(data["imu_acc"], np.float32)[:, list(IMU_MASK)],
                "ori": np.asarray(data["imu_ori"], np.float32)[:, list(IMU_MASK)],
                "pose": np.asarray(data["gt"], np.float32),
                "id": "_".join(["DIP_IMU", subject, motion]),
            }


def preprocess_sequence(raw: Dict[str, np.ndarray], mirror: bool = False,
                        device="cuda") -> Optional[Dict[str, np.ndarray]]:
    r"""NaN-fill, trim, (optionally) mirror one raw sequence, the mirror's
    rotation conversions on ``device``. Returns None when NaNs survive the
    fill (such sequences are discarded)."""
    acc = TF.nan_fill_nearest(raw["acc"])
    ori = TF.nan_fill_nearest(raw["ori"])
    pose = raw["pose"].reshape(-1, 24, 3)
    if mirror:
        pose = TF.mirror_pose_axis_angle(pose)
        ori, acc = TF.mirror_imu(ori, acc, device=device)
    acc, ori, pose = acc[TRIM:-TRIM], ori[TRIM:-TRIM], pose[TRIM:-TRIM]
    if (np.isnan(acc).any() or np.isnan(ori).any() or np.isnan(pose).any()
            or len(acc) == 0):
        return None
    return {"acc": acc, "ori": ori, "pose": pose}


def _to_training_fields(model: ParametricModel,
                        seq: Dict[str, np.ndarray],
                        with_positions: bool = True) -> Dict[str, np.ndarray]:
    r"""Preprocessed sequence → training fields: TransPose-normalized IMU,
    reduced global pose and (``with_positions``) root-free FK positions."""
    T = seq["pose"].shape[0]
    p = R.axis_angle_to_rotation_matrix(
        model.as_tensor(seq["pose"].reshape(-1, 3))).reshape(T, 24, 3, 3)
    joint = None
    if with_positions:
        p_rf = p.clone()
        p_rf[:, 0] = torch.eye(3, dtype=p.dtype, device=p.device)
        _, joint = model.forward_kinematics(p_rf)
        full_pos = joint[:, :24].cpu().numpy()
    p = p.cpu().numpy()
    ori_tp, acc_tp = TF.normalize_transpose(
        seq["ori"].reshape(T, 54), seq["acc"].reshape(T, 18))
    out = {
        "ori": ori_tp.astype(np.float32),
        "acc": acc_tp.astype(np.float32),
        "pose": TF.local_to_reduced_global(p, model.parent).astype(np.float32),
    }
    if with_positions:
        out["full_pos"] = full_pos.astype(np.float32)
        out["leaf_pos"] = full_pos[:, TF.LEAF_NODES].astype(np.float32)
    return out


def process_dipimu(model: ParametricModel, split: str = "test",
                   sym: bool = False,
                   raw_iter: Optional[Iterable[Dict]] = None,
                   out_path: Optional[str] = None,
                   chunk_size: int = 300,
                   paths: Optional[Paths] = None):
    r"""Full DIP-IMU pipeline for one split. The test split keeps
    native-length sequences (returned as a list; saved as ``seq{i}_{field}``
    npz arrays); train/valid are ``chunk_size``-frame chunks, packed.
    ``paths=None`` reads the raw pickles under ``Paths()`` made at the call
    (``$A3GC_DATA_ROOT`` as it stands then)."""
    if raw_iter is None:
        paths = paths or Paths()
        raw_iter = iter_dipimu_raw(paths.resolve(paths.raw_dipimu_dir), split)

    sequences = []
    for raw in raw_iter:
        variants = [False, True] if (sym and split != "test") else [False]
        for mirror in variants:
            pre = preprocess_sequence(raw, mirror=mirror, device=model.device)
            if pre is None:
                continue
            sequences.append(_to_training_fields(
                model, pre, with_positions=split != "test"))

    if split == "test":
        if out_path and sequences:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            np.savez(out_path, **{
                f"seq{i}_{k}": v for i, s in enumerate(sequences)
                for k, v in s.items()})
        return sequences

    chunks = TF.chunk_sequences(sequences, chunk_size)
    if out_path and chunks:
        TF.pack_dataset(chunks, out_path)
    return chunks


def load_test_sequences(path: str) -> List[Dict[str, np.ndarray]]:
    r"""Load a test npz of per-sequence arrays ``seq{i}_{field}`` (the
    layout ``preprocess --split test`` writes: ``ori`` [T, 54], ``acc``
    [T, 18], ``pose`` [T, 135] reduced global rotations) into a list of
    dicts, in sequence order."""
    with np.load(path) as z:
        seqs: Dict[int, Dict[str, np.ndarray]] = {}
        for key in z.files:
            head, field = key.split("_", 1)
            seqs.setdefault(int(head[3:]), {})[field] = z[key]
    return [seqs[i] for i in sorted(seqs)]
