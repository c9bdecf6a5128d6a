r"""Normalization statistics: computation, storage and conversion
(counterpart of ``a3gc_tpu/data/stats.py``). npz keys are
``{field}_{mean_channel,std_channel,mean_all,std_all}`` for the fields
acc (18), ori (54), pose (135), leaf_pos (5, 3), full_pos (24, 3); the port
ships copies of the two stats assets. ``convert_torch_stats`` imports the
reference's ``.pt`` stats files.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping

import numpy as np

__all__ = ["load_stats", "STATS_ASSET", "StreamingStats", "compute_stats",
           "save_stats", "convert_torch_stats"]

STATS_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "stats", "all_train_stats.npz")
STAT_KEYS = ("mean_channel", "std_channel", "mean_all", "std_all")


class StreamingStats:
    r"""One-pass streaming mean/std (Chan's parallel variance): no split
    is ever concatenated in memory."""

    def __init__(self):
        self.n = 0
        self.mean = None
        self.m2 = None

    def update(self, x: np.ndarray):
        """x: [n_samples, ...channel dims]."""
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        n_b = x.shape[0]
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        if self.mean is None:
            self.n, self.mean, self.m2 = n_b, mean_b, m2_b
            return
        delta = mean_b - self.mean
        n = self.n + n_b
        self.mean = self.mean + delta * (n_b / n)
        self.m2 = self.m2 + m2_b + delta ** 2 * (self.n * n_b / n)
        self.n = n

    def finalize(self, ddof: int = 1):
        """(mean_channel, std_channel), torch's ddof=1."""
        std = np.sqrt(self.m2 / max(self.n - ddof, 1))
        return self.mean, std


def compute_stats(arrays: Mapping[str, Iterable[np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    r"""Per-channel and global mean/std per field. ``arrays[field]``
    iterates [Ni, ...] chunks of frames, streamed."""
    out = {}
    for field, chunks in arrays.items():
        ch = StreamingStats()
        al = StreamingStats()
        for c in chunks:
            c = np.asarray(c)   # [frames, ...channel dims]
            ch.update(c)
            al.update(c.reshape(-1, 1))
        mean_c, std_c = ch.finalize()
        mean_a, std_a = al.finalize()
        out[f"{field}_mean_channel"] = mean_c.astype(np.float32)
        out[f"{field}_std_channel"] = std_c.astype(np.float32)
        out[f"{field}_mean_all"] = np.float32(mean_a[0])
        out[f"{field}_std_all"] = np.float32(std_a[0])
    return out


def save_stats(stats: Mapping[str, np.ndarray], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **stats)
    return path


def load_stats(path: str = None) -> Dict[str, np.ndarray]:
    r"""Load a stats npz into a dict of numpy arrays (the shipped
    ``all_train_stats.npz`` when ``path`` is None)."""
    with np.load(path or STATS_ASSET) as z:
        return {k: z[k] for k in z.files}


def convert_torch_stats(pt_path: str, npz_path: str) -> str:
    r"""Convert a reference ``all*_train_stats.pt`` ({field: {mean_channel,
    std_channel, mean_all, std_all}}) into the npz layout."""
    import torch

    data = torch.load(pt_path, map_location="cpu", weights_only=False)
    flat = {}
    for field, entry in data.items():
        for k in STAT_KEYS:
            flat[f"{field}_{k}"] = np.asarray(entry[k], np.float32)
    return save_stats(flat, npz_path)
