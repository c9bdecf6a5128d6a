r"""Best/worst-frame extraction (counterpart of
``a3gc_tpu/eval/worst_frames.py``): given per-sequence ground-truth and
prediction dumps of two models ("tp" and "our" in the reference), the
per-frame masked global angle error of each, and the k frames where model B
most improves on / regresses from model A, plus each model's own best and
worst frames, each pick at least ``min_separation`` frames from the others.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from a3gc_tpu_torch.metrics import masked_global_angle_per_frame
from a3gc_tpu_torch.smpl.model import ParametricModel

__all__ = ["per_frame_errors", "select_extreme_frames", "compare_models"]


def per_frame_errors(model: ParametricModel,
                     gts: Sequence[np.ndarray],
                     preds: Sequence[np.ndarray],
                     joint_mask: Optional[Tuple[int, ...]] = None
                     ) -> np.ndarray:
    r"""Per-frame mean global angle errors of every sequence, concatenated
    (all joints unless ``joint_mask``)."""
    errs = []
    for gt, pred in zip(gts, preds):
        errs.append(masked_global_angle_per_frame(
            model, model.as_tensor(pred).reshape(-1, 24, 3, 3),
            model.as_tensor(gt).reshape(-1, 24, 3, 3),
            joint_mask=joint_mask).cpu().numpy())
    return np.concatenate(errs)


def select_extreme_frames(scores: np.ndarray, k: int = 10,
                          min_separation: int = 300,
                          largest: bool = True) -> List[int]:
    r"""k frame indices with extreme scores, each more than
    ``min_separation`` frames from every one chosen before it."""
    order = np.argsort(scores)
    if largest:
        order = order[::-1]
    chosen: List[int] = []
    for idx in order:
        if all(abs(int(idx) - c) > min_separation for c in chosen):
            chosen.append(int(idx))
        if len(chosen) == k:
            break
    return chosen


def compare_models(model: ParametricModel,
                   gts: Sequence[np.ndarray],
                   preds_a: Sequence[np.ndarray],
                   preds_b: Sequence[np.ndarray],
                   k: int = 10, min_separation: int = 300,
                   out_dir: Optional[str] = None,
                   render: bool = False,
                   render_size: int = 360) -> Dict[str, List[int]]:
    r"""Frames where model B most improves on / regresses from model A, and
    each model's own best and worst frames. With ``out_dir``: one pickle of
    each selection's poses and errors, and the reference's 18-pickle layout
    ``{respect_our, respect_tp, respect_comp}/{worst, best}/{gt, tp,
    our}.p`` (model A is the reference's 'tp', model B its 'our'; 'comp'
    ranks by err_A − err_B, worst = B improves most). ``render=True`` also
    draws each selected frame as a PNG beside them, ``{rank:02d}_frame
    {index}.png`` (gt | A | B skeletons, FK on the model's device), of
    ``render_size`` pixels a side."""
    err_a = per_frame_errors(model, gts, preds_a)
    err_b = per_frame_errors(model, gts, preds_b)
    if err_a.shape != err_b.shape:
        raise ValueError(f"the two models' dumps cover {err_a.shape[0]} and "
                         f"{err_b.shape[0]} frames")
    diff = err_a - err_b    # positive = B better

    result = {
        "b_improves_most": select_extreme_frames(diff, k, min_separation,
                                                 largest=True),
        "b_regresses_most": select_extreme_frames(diff, k, min_separation,
                                                  largest=False),
        "a_worst": select_extreme_frames(err_a, k, min_separation, True),
        "a_best": select_extreme_frames(err_a, k, min_separation, False),
        "b_worst": select_extreme_frames(err_b, k, min_separation, True),
        "b_best": select_extreme_frames(err_b, k, min_separation, False),
    }
    if not out_dir:
        return result

    def stacked(arrs):
        return np.concatenate([np.asarray(a).reshape(-1, 24, 3, 3)
                               for a in arrs])

    gt_all, a_all, b_all = stacked(gts), stacked(preds_a), stacked(preds_b)
    os.makedirs(out_dir, exist_ok=True)
    for name, frames in result.items():
        payload = {"frames": frames, "gt": gt_all[frames],
                   "pred_a": a_all[frames], "pred_b": b_all[frames],
                   "err_a": err_a[frames], "err_b": err_b[frames]}
        with open(os.path.join(out_dir, f"{name}.p"), "wb") as f:
            pickle.dump(payload, f)

    contract = {
        ("respect_our", "worst"): result["b_worst"],
        ("respect_our", "best"): result["b_best"],
        ("respect_tp", "worst"): result["a_worst"],
        ("respect_tp", "best"): result["a_best"],
        ("respect_comp", "worst"): result["b_improves_most"],
        ("respect_comp", "best"): result["b_regresses_most"],
    }
    for (crit, kind), frames in contract.items():
        d = os.path.join(out_dir, crit, kind)
        os.makedirs(d, exist_ok=True)
        for fname, arr in (("gt.p", gt_all), ("tp.p", a_all),
                           ("our.p", b_all)):
            with open(os.path.join(d, fname), "wb") as f:
                pickle.dump(arr[frames], f)
        if render:
            for rank, fidx in enumerate(frames):
                poses = model.as_tensor(np.stack(
                    (gt_all[fidx], a_all[fidx], b_all[fidx])))  # [3,24,3,3]
                _, joints = model.forward_kinematics(poses)
                joints = joints.cpu().numpy()                   # [3,24,3]
                model.view_joint(                               # gt | A | B
                    [joints[0:1], joints[1:2], joints[2:3]],
                    distance_between_subjects=0.9,
                    out_path=os.path.join(d, f"{rank:02d}_frame{fidx}.png"),
                    size=render_size)
    return result
