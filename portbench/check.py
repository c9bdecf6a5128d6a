r"""The comparison that decides ``correct``.

Each compared answer is the local pose of a whole sequence [T, 24, 3, 3] as
the program delivered it, beside the reference's for the same inputs and
weights. Only the 15 predicted joints are compared: the others are the
identity on both sides by construction. Per sequence, with d = program −
reference and r the reference's root mean square over those joints and
frames,

    pose_rms = rms(d) / r        pose_max = max|d| / r

and a run reports the worst sequence of each. A number passes where it is
at most its limit; a missing answer fails the run.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.reference.common import REDUCED

NUMBERS = ("pose_rms", "pose_max")


def numbers(answers: List[np.ndarray], references: List[np.ndarray]
            ) -> Dict[str, float]:
    r"""The worst sequence's ``pose_rms`` and ``pose_max`` over pairs of
    [T, 24, 3, 3] poses; NaN (which fails every limit) where an answer is
    missing, misshapen or not finite."""
    worst = {k: 0.0 for k in NUMBERS}
    if not answers or len(answers) != len(references):
        return {k: float("nan") for k in NUMBERS}
    for got, want in zip(answers, references):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape or not np.isfinite(got).all():
            return {k: float("nan") for k in NUMBERS}
        d = (got - want)[:, list(REDUCED)]
        scale = np.sqrt(np.mean(want[:, list(REDUCED)] ** 2))
        worst["pose_rms"] = max(worst["pose_rms"],
                                float(np.sqrt(np.mean(d ** 2)) / scale))
        worst["pose_max"] = max(worst["pose_max"],
                                float(np.abs(d).max() / scale))
    return worst


def passes(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    r"""Every number at most its limit (NaN never passes)."""
    return all(values.get(k, float("nan")) <= limits[k] for k in limits)
