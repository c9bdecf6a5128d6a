r"""Data-parallel serving: the stream axis of the cascade split over a mesh
(counterpart of ``a3gc_tpu/parallel/serving.py``).

The multi-stream cascade folds B sequences onto its kernels' stream axis;
past what one card serves, the B streams split over the mesh's ``data``
axis and every device runs the whole cascade, its own kernel launches
included, on its B/D streams. The streams are independent (block-diagonal
adjacency, per-stream ``n_valid``), so the shards need no collective: every
shard's work is issued before anything waits, and the poses come together
on the mesh's first device once, after the last shard.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from a3gc_tpu_torch.models.pipeline import CascadeConfig, cascade_apply
from a3gc_tpu_torch.parallel.mesh import (Mesh, batch_sharding, replicate,
                                          shard_rows)

__all__ = ["cascade_apply_sharded"]


def serving_shards(mesh: Mesh, rows: int):
    r"""The row block and device of each shard of a serving mesh, which
    must lie in one process (serving runs no process group)."""
    if mesh.process_count != 1:
        raise ValueError("a serving mesh spans one process's devices; "
                         f"this one spans {mesh.process_count} processes")
    return list(zip(batch_sharding(mesh, rows), mesh.devices))


def cascade_apply_replicas(replicas: Sequence[Tuple], cfg: CascadeConfig,
                           model, imu, mesh: Mesh,
                           frame_mask=None) -> torch.Tensor:
    r""":func:`cascade_apply_sharded` on parameters already placed by
    :func:`~a3gc_tpu_torch.parallel.mesh.replicate` (one tuple a shard)."""
    shards = serving_shards(mesh, imu.shape[0])
    if frame_mask is not None and not isinstance(frame_mask, torch.Tensor):
        frame_mask = np.asarray(frame_mask)     # checked on the host
    poses = []
    for (rows, dev), p3 in zip(shards, replicas):
        fm = None if frame_mask is None else frame_mask[rows]
        poses.append(cascade_apply(p3, cfg, model,
                                   shard_rows(imu, rows, dev),
                                   frame_mask=fm, device=dev))
    first = mesh.devices[0]
    return torch.cat([p.to(first) for p in poses])


def cascade_apply_sharded(params3: Tuple, cfg: CascadeConfig, model, imu,
                          mesh: Mesh, frame_mask=None) -> torch.Tensor:
    r"""``cascade_apply`` with the stream axis split over ``mesh['data']``.

    imu [B, T, ...] (a host array or a tensor) with B divisible by the data
    axis (else ``ValueError``), ``frame_mask`` [B, T] or None; ``params3``
    are copied to each distinct device of the mesh that does not hold them.
    Returns the same [B·T, 24, 3, 3] as ``cascade_apply``, stream-major, on
    the mesh's first device."""
    return cascade_apply_replicas(replicate(tuple(params3), mesh), cfg,
                                  model, imu, mesh, frame_mask)
