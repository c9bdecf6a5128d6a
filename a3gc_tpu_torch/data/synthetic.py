r"""Synthetic packed datasets for tests and smoke runs (a copy of
``a3gc_tpu/data/synthetic.py``; the same seed gives the same arrays).

The arrays have the schema the data factory produces (acc 18 / ori 54 /
pose 135 / leaf_pos 5×3 / full_pos 24×3 per frame), with rotation matrices
in the orientation and pose fields.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["synthetic_packed_dataset"]


def _smooth_rotmats(rng, n, t, k):
    """[n, t, k, 3, 3] smoothly-varying rotation matrices."""
    from scipy.spatial.transform import Rotation

    base = rng.normal(size=(n, 1, k, 3)) * 0.4
    drift = rng.normal(size=(n, 1, k, 3)) * 0.3
    phase = np.sin(np.linspace(0, 2 * np.pi, t))[None, :, None, None]
    aa = base + drift * phase                     # [n, t, k, 3]
    return Rotation.from_rotvec(aa.reshape(-1, 3)).as_matrix().reshape(
        n, t, k, 3, 3)


def synthetic_packed_dataset(n_seqs: int = 8, seq_len: int = 30,
                             seed: int = 0) -> Dict[str, np.ndarray]:
    r"""``n_seqs`` sequences of ``seq_len`` frames from ``seed``, fp32."""
    rng = np.random.default_rng(seed)
    n, t = n_seqs, seq_len

    ori = _smooth_rotmats(rng, n, t, 6).reshape(n, t, 54)
    acc = rng.normal(scale=0.3, size=(n, t, 18))
    pose = _smooth_rotmats(rng, n, t, 15).reshape(n, t, 135)
    full_pos = rng.normal(scale=0.3, size=(n, t, 24, 3))
    full_pos[:, :, 0] = 0.0  # root-relative, as the factory writes it
    leaf_pos = full_pos[:, :, [7, 8, 12, 20, 21]]

    return {
        "acc": acc.astype(np.float32),
        "ori": ori.astype(np.float32),
        "pose": pose.astype(np.float32),
        "leaf_pos": leaf_pos.astype(np.float32),
        "full_pos": full_pos.astype(np.float32),
    }
