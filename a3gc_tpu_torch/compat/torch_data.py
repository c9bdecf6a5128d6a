r"""Reference packed-dataset (``.pt``) → npz converter (counterpart of
``a3gc_tpu/compat/torch_data.py``). Both packed layouts of the reference
convert:

- stacked training chunks (``{'acc','ori','pose'[,'leaf_pos','full_pos']}``
  tensors [N, T, ...]) → one npz of fp32 arrays in the train schema
  (``data.pipeline.load_packed``);
- per-sequence lists (test sets) → the ``seq{i}_{field}`` npz that
  ``data.factory.dipimu.load_test_sequences`` reads, ``full_pos`` /
  ``leaf_pos`` kept when present.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["convert_torch_dataset"]

_FLAT = {"ori": 54, "acc": 18}


def _np(x):
    return (x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x))


def convert_torch_dataset(pt_path: str, npz_path: str) -> str:
    r"""Convert either reference packed layout to the matching npz, the
    layout detected from the data: stacked tensors ⇒ train schema, lists of
    per-sequence tensors ⇒ test schema. Returns ``npz_path``."""
    data = torch.load(pt_path, map_location="cpu", weights_only=False)
    assert {"ori", "acc", "pose"} <= set(data), (
        f"not a reference packed dataset (keys: {sorted(data)})")
    os.makedirs(os.path.dirname(os.path.abspath(npz_path)), exist_ok=True)

    if torch.is_tensor(data["ori"]) or isinstance(data["ori"], np.ndarray):
        # stacked training chunks [N, T, ...]
        out = {}
        N, T = _np(data["ori"]).shape[:2]
        for field, width in _FLAT.items():
            out[field] = _np(data[field]).reshape(N, T, width).astype(
                np.float32)
        out["pose"] = _np(data["pose"]).reshape(N, T, -1).astype(np.float32)
        for pos in ("full_pos", "leaf_pos"):
            if pos in data:
                out[pos] = _np(data[pos]).reshape(
                    N, T, -1, 3).astype(np.float32)
        np.savez(npz_path, **out)
        return npz_path

    # per-sequence lists (test sets)
    out = {}
    for i in range(len(data["ori"])):
        T = len(_np(data["ori"][i]))
        for field, width in _FLAT.items():
            out[f"seq{i}_{field}"] = _np(data[field][i]).reshape(
                T, width).astype(np.float32)
        out[f"seq{i}_pose"] = _np(data["pose"][i]).reshape(T, -1).astype(
            np.float32)
        for pos in ("full_pos", "leaf_pos"):
            if pos in data:
                out[f"seq{i}_{pos}"] = _np(data[pos][i]).reshape(
                    T, -1, 3).astype(np.float32)
    np.savez(npz_path, **out)
    return npz_path
