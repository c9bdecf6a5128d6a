r"""Pose pipelines: net + reduced-global → full-local pose, the offline
single-net forward, the 3-stage cascade and the pose loss (counterpart of
``a3gc_tpu/models/pipeline.py``), for graph nets and DIP nets.

``rotsize``: 3 → raw per-node positions; 6 → 6D rotations → full local
pose via IK; 9 → rotation matrices → full local pose via IK.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from a3gc_tpu_torch._device import (check_module_device, index_tensor,
                                    resolve_device)
from a3gc_tpu_torch.config import joint_set as JS
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.ops import rotations as R

__all__ = ["PoseNetConfig", "CascadeConfig", "init_pose_net",
           "pose_net_forward", "reduced_global_to_full_local",
           "forward_offline", "cascade_apply", "pose_loss"]


@dataclasses.dataclass(frozen=True)
class PoseNetConfig:
    r"""Static config of one pipeline stage: a graph net or a DIP net."""

    net: object = None          # N.GraphNetConfig | N.DIPConfig
    rotsize: int = 9

    def __post_init__(self):
        if not isinstance(self.net, (N.GraphNetConfig, N.DIPConfig)):
            raise TypeError("PoseNetConfig.net must be a GraphNetConfig or "
                            f"a DIPConfig, got {type(self.net).__name__}")

    @property
    def is_graph(self) -> bool:
        return isinstance(self.net, N.GraphNetConfig)


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    r"""The 3-stage cascade: IMU → leaf pos → all pos → pose."""

    stage1: PoseNetConfig = None
    stage2: PoseNetConfig = None
    stage3: PoseNetConfig = None

    @property
    def stages(self) -> Tuple[PoseNetConfig, PoseNetConfig, PoseNetConfig]:
        return (self.stage1, self.stage2, self.stage3)

    @property
    def is_graph(self) -> bool:
        return self.stage1.is_graph


def init_pose_net(gen: torch.Generator, cfg: PoseNetConfig, adjacency=None):
    r"""Initialize one stage's net on the CPU from ``gen``."""
    if cfg.is_graph:
        return N.init_graph_net(gen, cfg.net, adjacency)
    return N.init_dip(gen, cfg.net)


def pose_net_forward(params, cfg: PoseNetConfig, imu: torch.Tensor,
                     state=None, frame_mask=None, rng=None):
    r"""Raw net forward on the device ``imu`` lies on; ``rng`` (a
    ``torch.Generator`` there) turns on dropout (training)."""
    apply = N.graph_net_apply if cfg.is_graph else N.dip_apply
    return apply(params, cfg.net, imu, state, frame_mask=frame_mask,
                 device=imu.device, rng=rng)


def reduced_global_to_full_local(glb_reduced: torch.Tensor, model,
                                 rotsize: int = 9) -> torch.Tensor:
    r"""Scatter 15 predicted global rotations into the 24-joint skeleton,
    run IK, and identity-fill the ignored joints.

    :param glb_reduced: [F, 15, 3, 3] rotation matrices (rotsize 9) or
        [F, 15, 6] 6D rotations (rotsize 6).
    :return: full local pose [F, 24, 3, 3].
    """
    if rotsize == 6:
        glb_reduced = R.r6d_to_rotation_matrix(glb_reduced).reshape(
            -1, JS.n_reduced, 3, 3)
    F = glb_reduced.shape[0]
    dev = glb_reduced.device
    eye = torch.eye(3, dtype=glb_reduced.dtype, device=dev)
    full_glb = eye.expand(F, 24, 3, 3).clone()
    full_glb[:, index_tensor(JS.reduced, dev)] = glb_reduced
    pose = model.inverse_kinematics_R(full_glb)
    pose[:, index_tensor(JS.ignored, dev)] = eye
    return pose


@torch.no_grad()
def forward_offline(params, cfg: PoseNetConfig, model, imu: torch.Tensor,
                    state=None) -> torch.Tensor:
    r"""Offline forward of one net on the device ``imu`` lies on: net +
    (for rotsize 9 / 6) the reduced → full IK conversion. imu [B, T, ...] →
    rotsize 9 / 6: full local pose [B·T, 24, 3, 3]; rotsize 3: the raw net
    output."""
    out, _ = pose_net_forward(params, cfg, imu, state)
    if cfg.rotsize == 3:
        return out
    return reduced_global_to_full_local(_stage_out(out, cfg.rotsize), model,
                                        rotsize=cfg.rotsize)


def pose_loss(pred: torch.Tensor, target: torch.Tensor,
              loss_weight: Optional[torch.Tensor] = None,
              frame_mask: Optional[torch.Tensor] = None,
              sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    r"""Weighted squared error: sum over the last dim, mean over the rest.
    ``frame_mask`` [B, T] restricts the mean to valid frames;
    ``sample_weight`` [B] to real batch elements (the mean a tail batch
    padded to the static batch size would have had at its own size). The
    two exclude each other."""
    err = torch.square(target - pred)
    if loss_weight is not None:
        err = err * loss_weight
    err = err.sum(dim=-1)
    if sample_weight is not None:
        if frame_mask is not None:
            raise ValueError("sample_weight excludes frame_mask")
        w = sample_weight.reshape(sample_weight.shape
                                  + (1,) * (err.dim() - 1))
        denom = sample_weight.sum() * err[0].numel()
        return (err * w).sum() / torch.clamp(denom, min=1.0)
    if frame_mask is None:
        return err.mean()
    w = frame_mask.reshape(frame_mask.shape + (1,) * (err.dim() - 2))
    denom = w.sum() * (err[0, 0].numel() if err.dim() > 2 else 1.0)
    return (err * w).sum() / torch.clamp(denom, min=1.0)


def _node_features(cfg: CascadeConfig, out: torch.Tensor, B: int,
                   T: int) -> torch.Tensor:
    r"""A stage's output as the next stage's extra features: per node
    [B, T, 15, 3] in a graph cascade, flat [B, T, F] in a TransPose one."""
    return out.reshape(B, T, JS.n_reduced, 3) if cfg.is_graph else out


def _stage_out(out: torch.Tensor, rotsize: int) -> torch.Tensor:
    rep = (3, 3) if rotsize == 9 else (rotsize,)
    return out.reshape((-1, JS.n_reduced) + rep)


@torch.no_grad()
def cascade_apply(params3: Tuple, cfg: CascadeConfig, model, imu,
                  frame_mask=None, *, device="cuda") -> torch.Tensor:
    r"""Full cascade at inference → full local pose [B·T, 24, 3, 3].
    Graph variant: imu [B, T, 15, 12], stage outputs concatenated onto the
    node features. Flat variant (TransPose): imu [B, T, 72], stage outputs
    concatenated onto the flat features."""
    dev = resolve_device(device)
    for p in params3:
        check_module_device(p, dev)
    imu = torch.as_tensor(imu, dtype=torch.float32, device=dev)
    if frame_mask is not None:
        N.check_ones_prefix(frame_mask)     # before it leaves the host
        frame_mask = torch.as_tensor(frame_mask, device=dev)
    p1, p2, p3 = params3
    B, T = imu.shape[0], imu.shape[1]

    leaf, _ = pose_net_forward(p1, cfg.stage1, imu, frame_mask=frame_mask)
    x2 = torch.cat((imu, _node_features(cfg, leaf, B, T)), dim=-1)
    full, _ = pose_net_forward(p2, cfg.stage2, x2, frame_mask=frame_mask)
    x3 = torch.cat((imu, _node_features(cfg, full, B, T)), dim=-1)
    out, _ = pose_net_forward(p3, cfg.stage3, x3, frame_mask=frame_mask)
    rotsize = cfg.stage3.rotsize
    return reduced_global_to_full_local(_stage_out(out, rotsize), model,
                                        rotsize=rotsize)
