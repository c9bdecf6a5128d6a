r"""TotalCapture preprocessing, DIP-recalculated ground truth (counterpart
of ``a3gc_tpu/data/factory/totalcapture.py``): sensor reorder
``SENSOR_ORDER``, acc/pose length sync, TransPose normalization, reduced
global pose targets (the rotation conversion on the body model's device),
and the faulty sequence of ``FAULTY_LENGTH`` frames dropped.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from a3gc_tpu_torch.config import Paths
from a3gc_tpu_torch.data.factory import transform as TF
from a3gc_tpu_torch.ops import rotations as R
from a3gc_tpu_torch.smpl.model import ParametricModel

__all__ = ["SENSOR_ORDER", "FAULTY_LENGTH", "iter_totalcapture_raw",
           "process_totalcapture"]

SENSOR_ORDER = (2, 3, 0, 1, 4, 5)
FAULTY_LENGTH = 3560


def iter_totalcapture_raw(raw_dir: str) -> Iterator[Dict[str, np.ndarray]]:
    r"""Walk DIP-recalculated TotalCapture pickles. Yields acc [T,6,3],
    ori [T,6,3,3], pose [T,24,3] aa, id — acc/ori and pose cut to the
    shorter length."""
    for file_ in sorted(glob.glob(os.path.join(raw_dir, "*"))):
        with open(file_, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        ori = np.asarray(data["ori"], np.float32)[:, list(SENSOR_ORDER)]
        acc = np.asarray(data["acc"], np.float32)[:, list(SENSOR_ORDER)]
        pose = np.asarray(data["gt"], np.float32).reshape(-1, 24, 3)
        n = min(acc.shape[0], pose.shape[0])
        yield {"acc": acc[:n], "ori": ori[:n], "pose": pose[:n],
               "id": os.path.basename(file_)}


def process_totalcapture(model: ParametricModel,
                         raw_iter: Optional[Iterable[Dict]] = None,
                         out_path: Optional[str] = None,
                         drop_faulty: bool = True,
                         paths: Optional[Paths] = None
                         ) -> List[Dict[str, np.ndarray]]:
    r"""Raw TotalCapture → test sequences in the evaluation schema (ori
    [T,54], acc [T,18], pose [T,135] reduced global), saved as
    ``seq{i}_{field}`` npz arrays if ``out_path``. ``paths=None`` reads the
    raw pickles under ``Paths()`` made at the call."""
    if raw_iter is None:
        paths = paths or Paths()
        raw_iter = iter_totalcapture_raw(
            paths.resolve(paths.raw_totalcapture_dir))

    sequences = []
    for raw in raw_iter:
        T = raw["pose"].shape[0]
        if drop_faulty and T == FAULTY_LENGTH:
            continue
        p = R.axis_angle_to_rotation_matrix(model.as_tensor(
            raw["pose"].reshape(-1, 3))).reshape(T, 24, 3, 3).cpu().numpy()
        ori_tp, acc_tp = TF.normalize_transpose(
            raw["ori"].reshape(T, 54), raw["acc"].reshape(T, 18))
        sequences.append({
            "ori": ori_tp.astype(np.float32),
            "acc": acc_tp.astype(np.float32),
            "pose": TF.local_to_reduced_global(p, model.parent).astype(
                np.float32),
        })

    if out_path and sequences:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.savez(out_path, **{
            f"seq{i}_{k}": v for i, s in enumerate(sequences)
            for k, v in s.items()})
    return sequences
