r"""Motion-error evaluators (counterpart of ``a3gc_tpu/metrics/evaluator.py``),
fp32 on the body model's device.

``full_motion_metrics`` runs FK and skinning for prediction and ground
truth and returns the [11, 2] (mean, std) table, standard deviations
Bessel-corrected (ddof = 1) like torch's ``Tensor.std``:

  0 joint position err   1 vertex err      2 local angle err (deg)
  3 global angle err     4 pred jerk       5 true jerk
  6 translation err      7 masked pos err  8 masked local angle
  9 masked global angle (SIP when mask = hips+shoulders)   10 jerk err

An ``n_valid`` frame count makes every row ignore the frames of an
end-padded sequence past it, so a padded sequence scores as at its own
length.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from a3gc_tpu_torch._device import index_tensor
from a3gc_tpu_torch.config import joint_set as JS
from a3gc_tpu_torch.ops import rotations as R
from a3gc_tpu_torch.smpl.model import ParametricModel

__all__ = [
    "full_motion_metrics", "masked_global_angle_per_frame", "PoseEvaluator",
    "FullMotionEvaluator", "binary_confusion_matrix",
    "binary_classification_errors", "position_error", "rotation_error",
    "per_joint_errors", "mean_per_joint_errors", "mesh_error",
]


# ---------------------------------------------------------------------------
# weighted statistics (Bessel-corrected, as torch.std)
# ---------------------------------------------------------------------------

def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over all elements of x, frame-weighted by w [N] when given."""
    if w is None:
        return x.mean()
    wx = w.reshape((-1,) + (1,) * (x.dim() - 1))
    denom = w.sum() * math.prod(x.shape[1:])
    return (x * wx).sum() / torch.clamp(denom, min=1.0)


def _wstd_over_frames_mean(x: torch.Tensor,
                           w: Optional[torch.Tensor]) -> torch.Tensor:
    """torch's ``x.std(dim=0).mean()``: per-column ddof-1 std over frames,
    then the mean over columns; frame-weighted when w is given. x [N, J]."""
    if w is None:
        n = x.shape[0]
        mu = x.mean(dim=0, keepdim=True)
        var = ((x - mu) ** 2).sum(dim=0) / max(n - 1, 1)
        return torch.sqrt(var).mean()
    wc = w.reshape(-1, 1)
    n = w.sum()
    mu = (x * wc).sum(dim=0, keepdim=True) / torch.clamp(n, min=1.0)
    var = (wc * (x - mu) ** 2).sum(dim=0) / torch.clamp(n - 1.0, min=1.0)
    return torch.sqrt(var).mean()


def _stats(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.stack((_wmean(x, w), _wstd_over_frames_mean(x, w)))


# ---------------------------------------------------------------------------
# the full-motion metric suite
# ---------------------------------------------------------------------------

def _frame_weights(n_valid, length: int, window: int, device, dtype):
    """w[i] = 1 if frames [i, i + window] are all valid (end-padded
    layout); None without n_valid."""
    if n_valid is None:
        return None
    idx = torch.arange(length, device=device)
    return (idx < (n_valid - window)).to(dtype)


def full_motion_metrics(model: ParametricModel, pose_p, pose_t,
                        shape_p=None, shape_t=None, tran_p=None, tran_t=None,
                        n_valid=None, fps: int = 60,
                        joint_mask: Optional[Tuple[int, ...]] = None,
                        with_mesh: bool = True) -> torch.Tensor:
    r"""The 11 × [mean, std] motion-error table.

    :param pose_p/pose_t: local pose rotation matrices [N, 24, 3, 3] (numpy
        or tensors; computed on the model's device).
    :param n_valid: the true frame count (int or 0-d tensor) of sequences
        end-padded to N frames, or None.
    :param joint_mask: joint ids of the masked rows, or None (rows 0).
    """
    pose_p = model.as_tensor(pose_p)
    pose_t = model.as_tensor(pose_t)
    N = pose_p.shape[0]
    f = fps
    dtype, dev = pose_p.dtype, pose_p.device

    if with_mesh:
        pose_g_p, joint_p, vertex_p = model.forward_kinematics(
            pose_p, shape_p, tran_p, calc_mesh=True)
        pose_g_t, joint_t, vertex_t = model.forward_kinematics(
            pose_t, shape_t, tran_t, calc_mesh=True)
    else:
        pose_g_p, joint_p = model.forward_kinematics(pose_p, shape_p, tran_p)
        pose_g_t, joint_t = model.forward_kinematics(pose_t, shape_t, tran_t)

    offset = joint_t[:, :1] - joint_p[:, :1]                   # align root
    je = torch.linalg.vector_norm(joint_p + offset - joint_t, dim=2)  # [N,J]
    lae = R.radian_to_degree(
        R.angle_between(pose_p, pose_t).reshape(N, -1))               # [N,J]
    gae = R.radian_to_degree(
        R.angle_between(pose_g_p, pose_g_t).reshape(N, -1))           # [N,J]

    def jerk(x):
        return (x[3:] - 3 * x[2:-1] + 3 * x[1:-2] - x[:-3]) * (f ** 3)

    jkp = torch.linalg.vector_norm(jerk(joint_p), dim=2)             # [N-3,J]
    jkt = torch.linalg.vector_norm(jerk(joint_t), dim=2)
    jer = torch.linalg.vector_norm(jerk(joint_p) - jerk(joint_t), dim=2)
    te = torch.linalg.vector_norm(
        (joint_p[f:, :1] - joint_p[:-f, :1])
        - (joint_t[f:, :1] - joint_t[:-f, :1]), dim=2)               # [N-f,1]

    w = _frame_weights(n_valid, N, 0, dev, dtype)
    w3 = _frame_weights(n_valid, max(N - 3, 0), 3, dev, dtype)
    wf = _frame_weights(n_valid, max(N - f, 0), f, dev, dtype)

    if joint_mask is not None:
        m = index_tensor(tuple(joint_mask), dev)
        mje, mlae, mgae = je[:, m], lae[:, m], gae[:, m]
        wm = w
    else:
        mje = mlae = mgae = torch.zeros((1, 1), dtype=dtype, device=dev)
        wm = None
    zeros = torch.zeros(2, dtype=dtype, device=dev)
    return torch.stack((
        _stats(je, w),
        (_stats(torch.linalg.vector_norm(vertex_p + offset - vertex_t, dim=2),
                w) if with_mesh else zeros),
        _stats(lae, w),
        _stats(gae, w),
        _stats(jkp, w3),
        _stats(jkt, w3),
        _stats(te, wf) if N > f else zeros,
        _stats(mje, wm),
        _stats(mlae, wm),
        _stats(mgae, wm),
        _stats(jer, w3),
    ))


def masked_global_angle_per_frame(model: ParametricModel, pose_p, pose_t,
                                  joint_mask: Optional[Tuple[int, ...]] = None
                                  ) -> torch.Tensor:
    r"""Per-frame mean global angle error in degrees over ``joint_mask``
    (all joints when None). [N]."""
    pose_p = model.as_tensor(pose_p)
    pose_t = model.as_tensor(pose_t)
    N = pose_p.shape[0]
    gae = R.radian_to_degree(R.angle_between(
        model.forward_kinematics_R(pose_p),
        model.forward_kinematics_R(pose_t)).reshape(N, -1))
    if joint_mask is not None:
        gae = gae[:, index_tensor(tuple(joint_mask), gae.device)]
    return gae.mean(dim=1)


class FullMotionEvaluator:
    r"""Object-style wrapper: holds the body model and the config;
    ``__call__`` returns the [11, 2] table."""

    def __init__(self, model: ParametricModel, fps: int = 60,
                 joint_mask=None, with_mesh: bool = True):
        self.model = model
        self.fps = fps
        self.joint_mask = (tuple(int(i) for i in joint_mask)
                           if joint_mask is not None else None)
        self.with_mesh = with_mesh

    def __call__(self, pose_p, pose_t, shape_p=None, shape_t=None,
                 tran_p=None, tran_t=None, n_valid=None):
        return full_motion_metrics(
            self.model, self.model.as_tensor(pose_p).reshape(-1, 24, 3, 3),
            self.model.as_tensor(pose_t).reshape(-1, 24, 3, 3), shape_p,
            shape_t, tran_p, tran_t, n_valid=n_valid, fps=self.fps,
            joint_mask=self.joint_mask, with_mesh=self.with_mesh)


class PoseEvaluator:
    r"""The reporting evaluator of the evaluation scripts: SIP / angular /
    positional / jerk / jitter errors at the reference's scales, with the
    ignored joints set to the identity in both poses. [5, 2]."""

    METRIC_NAMES = ("SIP Error (deg)", "Angular Error (deg)",
                    "Positional Error (cm)", "jerk error (km/s^3)",
                    "Jitter Error (100m/s^3)")

    def __init__(self, model: ParametricModel, fps: int = 60):
        self.model = model
        self.fps = fps

    def __call__(self, pose_p, pose_t, n_valid=None) -> torch.Tensor:
        pose_p = self.model.as_tensor(pose_p).reshape(-1, 24, 3, 3).clone()
        pose_t = self.model.as_tensor(pose_t).reshape(-1, 24, 3, 3).clone()
        ignored = index_tensor(JS.ignored, pose_p.device)
        eye = torch.eye(3, dtype=pose_p.dtype, device=pose_p.device)
        pose_p[:, ignored] = eye
        pose_t[:, ignored] = eye
        errs = full_motion_metrics(
            self.model, pose_p, pose_t, n_valid=n_valid, fps=self.fps,
            joint_mask=JS.sip_joints)
        return torch.stack((errs[9], errs[3], errs[0] * 100,
                            errs[10] / 1000, errs[4] / 100))

    eval = __call__

    @staticmethod
    def format(errors) -> str:
        errors = np.asarray(torch.as_tensor(errors).cpu())
        return "\n".join(
            "%s: %.2f (+/- %.2f)" % (name, errors[i, 0], errors[i, 1])
            for i, name in enumerate(PoseEvaluator.METRIC_NAMES))


# ---------------------------------------------------------------------------
# basic evaluators
# ---------------------------------------------------------------------------

def binary_confusion_matrix(p: torch.Tensor, t: torch.Tensor,
                            is_after_sigmoid: bool = False) -> torch.Tensor:
    r"""[2, 2] confusion matrix in the reference's convention: positive = 0,
    negative = 1."""
    pred = ((p > 0.5) if is_after_sigmoid else (p > 0)).to(torch.float32)
    tp = torch.sum((pred == 0) & (t == 0))
    fn = torch.sum((pred == 1) & (t == 0))
    fp = torch.sum((pred == 0) & (t == 1))
    tn = torch.sum((pred == 1) & (t == 1))
    return torch.stack((torch.stack((tp, fn)), torch.stack((fp, tn))))


def binary_classification_errors(p: torch.Tensor, t: torch.Tensor,
                                 is_after_sigmoid: bool = False
                                 ) -> torch.Tensor:
    r"""[3, 2] precision / recall / f1 for the positive and negative class.
    A zero denominator (a class absent from prediction and target) gives
    NaN, as the reference's division does."""
    (tp, fn), (fp, tn) = binary_confusion_matrix(
        p, t, is_after_sigmoid).to(torch.float32)
    prec_p = tp / (tp + fp)
    rec_p = tp / (tp + fn)
    f1_p = 2 / (1 / prec_p + 1 / rec_p)
    prec_n = tn / (tn + fn)
    rec_n = tn / (tn + fp)
    f1_n = 2 / (1 / prec_n + 1 / rec_n)
    return torch.stack((torch.stack((prec_p, prec_n)),
                        torch.stack((rec_p, rec_n)),
                        torch.stack((f1_p, f1_n))))


def position_error(p: torch.Tensor, t: torch.Tensor, dimension: int = 3,
                   p_norm: int = 2) -> torch.Tensor:
    r"""Mean p-norm distance between point sets."""
    d = p.reshape(-1, dimension) - t.reshape(-1, dimension)
    return torch.linalg.vector_norm(d, ord=p_norm, dim=1).mean()


def rotation_error(p: torch.Tensor, t: torch.Tensor,
                   rep=R.RotationRepresentation.ROTATION_MATRIX
                   ) -> torch.Tensor:
    r"""Mean angle between rotation sets, degrees."""
    return R.radian_to_degree(R.angle_between(p, t, rep).mean())


def per_joint_errors(model: ParametricModel, pose_p, pose_t,
                     align_joint: int = 0) -> torch.Tensor:
    r"""[3, J]: per-joint position / local angle / global angle errors
    (angles in degrees)."""
    pose_p = model.as_tensor(pose_p)
    pose_t = model.as_tensor(pose_t)
    B = pose_p.shape[0]
    pose_p = pose_p.reshape(B, -1, 3, 3)
    pose_t = pose_t.reshape(B, -1, 3, 3)
    pose_g_p, joint_p = model.forward_kinematics(pose_p)
    pose_g_t, joint_t = model.forward_kinematics(pose_t)
    offset = (joint_t[:, align_joint] - joint_p[:, align_joint])[:, None]
    pos_err = torch.linalg.vector_norm(joint_p + offset - joint_t,
                                       dim=2).mean(dim=0)
    local = R.angle_between(pose_p, pose_t).reshape(B, -1).mean(dim=0)
    glob = R.angle_between(pose_g_p, pose_g_t).reshape(B, -1).mean(dim=0)
    return torch.stack((pos_err, R.radian_to_degree(local),
                        R.radian_to_degree(glob)))


def mean_per_joint_errors(model: ParametricModel, pose_p, pose_t,
                          align_joint: int = 0) -> torch.Tensor:
    r"""[3]: the means of :func:`per_joint_errors`."""
    return per_joint_errors(model, pose_p, pose_t, align_joint).mean(dim=1)


def mesh_error(model: ParametricModel, pose_p, pose_t, shape_p=None,
               shape_t=None, align_joint: int = 0) -> torch.Tensor:
    r"""Mean mesh vertex position error."""
    pose_p = model.as_tensor(pose_p)
    pose_t = model.as_tensor(pose_t)
    B = pose_p.shape[0]
    _, joint_p, mesh_p = model.forward_kinematics(
        pose_p.reshape(B, -1, 3, 3), shape_p, calc_mesh=True)
    _, joint_t, mesh_t = model.forward_kinematics(
        pose_t.reshape(B, -1, 3, 3), shape_t, calc_mesh=True)
    offset = (joint_t[:, align_joint] - joint_p[:, align_joint])[:, None]
    return torch.linalg.vector_norm(mesh_p + offset - mesh_t, dim=2).mean()
