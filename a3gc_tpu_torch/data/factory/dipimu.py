r"""The DIP-IMU test-set reader (counterpart of
``a3gc_tpu/data/factory/dipimu.py`` ``load_test_sequences``; the raw-data
preprocessing waits for ROADMAP Queue 1 item 15)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["load_test_sequences"]


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
