r"""Input pipeline: raw IMU → net inputs (counterpart of
``a3gc_tpu/data/pipeline.py`` ``normalize_imu``, ``scatter_graph_inputs``,
``pose_to_r6d`` and ``dip_batch``; the training feed waits for ROADMAP
Queue 1 item 10)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from a3gc_tpu_torch._device import index_tensor
from a3gc_tpu_torch.config import joint_set as JS
from a3gc_tpu_torch.ops import rotations as R

__all__ = ["normalize_imu", "scatter_graph_inputs", "pose_to_r6d",
           "dip_batch"]


def normalize_imu(ori: torch.Tensor, acc: torch.Tensor,
                  stats: Optional[Dict[str, torch.Tensor]]):
    r"""Per-channel (x − μ)/σ. ``stats`` holds tensors on the inputs'
    device, or is None for no normalization."""
    if stats is None:
        return ori, acc
    ori = (ori - stats["ori_mean_channel"]) / stats["ori_std_channel"]
    acc = (acc - stats["acc_mean_channel"]) / stats["acc_std_channel"]
    return ori, acc


def scatter_graph_inputs(ori: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    r"""Scatter the 5 non-root sensors' (acc3 + ori9) onto the 15-node graph.
    ori [..., 54], acc [..., 18] → [..., 15, 12]; the other nodes are 0."""
    lead = ori.shape[:-1]
    acc5 = acc.reshape(lead + (6, 3))[..., :5, :]
    ori5 = ori.reshape(lead + (6, 9))[..., :5, :]
    feats = torch.cat((acc5, ori5), dim=-1)                   # [..., 5, 12]
    out = ori.new_zeros(lead + (15, 12))
    out[..., index_tensor(JS.input_joints, ori.device), :] = feats
    return out


def pose_to_r6d(pose135: torch.Tensor) -> torch.Tensor:
    r"""Reduced global rotation matrices [..., 135] → 6D [..., 90]."""
    lead = pose135.shape[:-1]
    return R.rotation_matrix_to_r6d(pose135.reshape(-1, 3, 3)).reshape(
        lead + (90,))


def dip_batch(raw: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
              no_root: bool = True, rotsize: int = 9):
    r"""A DIP net's batch: drop the root sensor's channels (``no_root``),
    normalize with the train stats, concatenate acc ‖ ori; the targets as
    stored, or as 6D for ``rotsize=6``. ``raw`` holds ori [B, T, 54], acc
    [B, T, 18], pose [B, T, 135]; ``stats`` tensors on their device.

    :return: (inputs [B, T, 60], smpl [B, T, 135 | 90])."""
    ori, acc = raw["ori"], raw["acc"]
    om, os_ = stats["ori_mean_channel"], stats["ori_std_channel"]
    am, as_ = stats["acc_mean_channel"], stats["acc_std_channel"]
    if no_root:
        ori, om, os_ = ori[..., :-9], om[..., :-9], os_[..., :-9]
        acc, am, as_ = acc[..., :-3], am[..., :-3], as_[..., :-3]
    ori = (ori - om) / os_
    acc = (acc - am) / as_
    smpl = pose_to_r6d(raw["pose"]) if rotsize == 6 else raw["pose"]
    return torch.cat((acc, ori), dim=-1), smpl
