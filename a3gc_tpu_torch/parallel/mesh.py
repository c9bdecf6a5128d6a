r"""Device meshes and data placement (counterpart of
``a3gc_tpu/parallel/mesh.py``).

A :class:`Mesh` is a plain object: the ordered devices that hold this
process's shards of the ``data`` axis, and, in a multi-process run
(:mod:`a3gc_tpu_torch.parallel.multihost`), the process's place among the
others, whose shards follow its own. The ``model`` axis is always 1: tensor
parallelism (the JAX package's ``param_sharding`` / ``shard_params``) waits
for ROADMAP Queue 1 item 14 (d).

Shard d of a batch of B rows is the contiguous, stream-major block of rows
``[d·B/D, (d+1)·B/D)``. A device may appear more than once: its shards then
run in turn on it (torch has one CPU device, so a CPU mesh of several
shards repeats it). With one device the mesh is the single-device semantics
exactly.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from a3gc_tpu_torch._device import resolve_device
from a3gc_tpu_torch.config import MeshConfig

__all__ = ["Mesh", "make_mesh", "batch_sharding", "shard_rows",
           "shard_batch", "replicate"]

TP_WAITS_FOR = ("tensor parallelism (a mesh 'model' axis above 1, --tp > 1) "
                "waits for ROADMAP Queue 1 item 14")


class Mesh:
    r"""This process's devices of a (data, model) mesh, in shard order, and
    the process's index and count (the global ``data`` axis is
    ``len(devices) · process_count`` shards, process p holding shards
    ``[p·len(devices), (p+1)·len(devices))``)."""

    def __init__(self, devices: Sequence, process_index: int = 0,
                 process_count: int = 1):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def shape(self):
        return {"data": len(self.devices) * self.process_count, "model": 1}

    @property
    def first_shard(self) -> int:
        r"""The global index of this process's first shard."""
        return self.process_index * len(self.devices)

    def __repr__(self):
        return (f"Mesh(devices={[str(d) for d in self.devices]}, "
                f"process {self.process_index}/{self.process_count})")


def _local_devices() -> List[torch.device]:
    r"""Every visible card, or this process's own device in a multi-process
    run (one process a card)."""
    from a3gc_tpu_torch.parallel import multihost
    if multihost.process_device() is not None:
        return [multihost.process_device()]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a3gc_tpu_torch: a mesh over the cards was asked for but no CUDA "
            "device is available; pass devices=['cpu'] (cli: --device cpu)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    r"""Build a (data, model) mesh: by default every visible card on
    ``data`` (in a multi-process run: this process's device, the other
    processes' following); ``devices=`` takes an explicit list, which may
    repeat a device. ``cfg`` takes the first ``cfg.data`` devices (across
    processes); a ``model`` axis above 1 raises (not ported)."""
    from a3gc_tpu_torch.parallel import multihost
    devices = list(devices) if devices is not None else _local_devices()
    n_proc = multihost.process_count()
    if cfg is None:
        cfg = MeshConfig(data=len(devices) * n_proc, model=1)
    if cfg.model != 1:
        raise NotImplementedError(TP_WAITS_FOR)
    if cfg.data % n_proc or cfg.data // n_proc > len(devices) \
            or cfg.data < 1:
        raise ValueError(
            f"mesh {cfg.data}x{cfg.model} over {n_proc} process(es) needs "
            f"{cfg.data // n_proc or 1} device(s) a process, have "
            f"{len(devices)}")
    return Mesh(devices[:cfg.data // n_proc], multihost.process_index(),
                n_proc)


def batch_sharding(mesh: Mesh, batch: int) -> List[slice]:
    r"""The rows of a batch of ``batch`` that each of this process's
    devices holds: one contiguous block a shard, in shard order. Raises
    ``ValueError`` unless the ``data`` axis divides the batch."""
    n = mesh.shape["data"]
    if batch % n:
        raise ValueError(f"the data axis ({n} shards) must divide the "
                         f"{batch} rows of the batch")
    b = batch // n
    return [slice((mesh.first_shard + d) * b, (mesh.first_shard + d + 1) * b)
            for d in range(len(mesh.devices))]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def shard_rows(x, rows: slice, dev: torch.device) -> torch.Tensor:
    r"""Rows ``rows`` of an array or tensor as a tensor on ``dev`` (a host
    array's rows are copied straight there)."""
    if isinstance(x, torch.Tensor):
        return x[rows].to(dev)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)[rows]),
                           device=dev)


def shard_batch(batch, mesh: Mesh) -> list:
    r"""A pytree (dict, tuple, list) of [B, ...] arrays or tensors as one
    pytree a shard of this process, each holding its rows on its device
    (host arrays are copied straight there)."""
    leaves = []
    _tree_map(leaves.append, batch)
    B = len(leaves[0])
    return [_tree_map(lambda x, sl=sl, dev=dev: shard_rows(x, sl, dev),
                      batch)
            for sl, dev in zip(batch_sharding(mesh, B), mesh.devices)]


def replicate(tree, mesh: Mesh) -> list:
    r"""One copy of ``tree`` (a module, a tensor, or a tuple of them) per
    distinct device of the mesh, as a list aligned with ``mesh.devices``:
    shards on one device share its copy, and a tree already on a device is
    used there as it is."""
    copies = {}

    def on(t, dev):
        if isinstance(t, (tuple, list)):
            return tuple(on(x, dev) for x in t)
        if isinstance(t, torch.nn.Module):
            if all(p.device == dev for p in t.parameters()):
                return t
            return copy.deepcopy(t).to(dev)
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        return t

    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = on(tree, dev)
    return [copies[dev] for dev in mesh.devices]
