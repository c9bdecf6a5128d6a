r"""Device meshes, data placement and the tensor-parallel policy
(counterpart of ``a3gc_tpu/parallel/mesh.py``).

A :class:`Mesh` is a plain object over a (data, model) grid of devices laid
out as JAX lays them (``devices[:D·M].reshape(D, M)``): a model group is a
run of M consecutive devices in the global order. ``Mesh.devices`` lists
one device a local data shard, the first of its group (the lead), and
``Mesh.model_devices`` the group's local members; so everything that reads
only ``devices`` shards over ``data`` and replicates over ``model``, as
JAX's serving and evaluation do on a (data, model) mesh. In a
multi-process run (:mod:`a3gc_tpu_torch.parallel.multihost`) a group lies
in one process, or takes one device from each of M consecutive processes,
which then share a data shard and the ``torch.distributed`` subgroups of
:func:`~a3gc_tpu_torch.parallel.multihost.model_groups`.

Shard d of a batch of B rows is the contiguous, stream-major block of rows
``[d·B/D, (d+1)·B/D)``. A device may appear more than once: its shards then
run in turn on it (torch has one CPU device, so a CPU mesh of several
shards repeats it). With one device the mesh is the single-device semantics
exactly.

Tensor parallelism: :func:`param_sharding` is JAX's policy (the last axis
of a parameter split over ``model``), :func:`shard_params` places a module
by it; the products over the blocks are in
:mod:`a3gc_tpu_torch.parallel.tensor`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from a3gc_tpu_torch._device import resolve_device
from a3gc_tpu_torch.config import MeshConfig
from a3gc_tpu_torch.parallel.tensor import map_parameters

__all__ = ["Mesh", "make_mesh", "local_devices", "batch_sharding",
           "shard_rows", "shard_batch", "replicate", "ParamSharding",
           "param_sharding", "split_names", "shard_params"]


class Mesh:
    r"""This process's part of a (data, model) mesh: ``model_devices``, the
    local members of each local data shard's model group (in shard order;
    the first of each is its lead, listed in ``devices``); ``data`` and
    ``model``, the global axis sizes; ``first_shard``, the global index of
    the first local data shard; the process's index and count. When the
    model groups span processes, ``model_rank`` is this process's member
    index and ``model_group`` / ``data_group`` its ``torch.distributed``
    subgroups (the members of its group; the processes of its member
    index); otherwise ``model_rank`` is 0 and both are None (the data axis
    then spans every process)."""

    def __init__(self, model_devices: Sequence[Sequence],
                 process_index: int = 0, process_count: int = 1, *,
                 data: Optional[int] = None,
                 first_shard: Optional[int] = None, model: int = 1,
                 model_rank: int = 0, model_group=None, data_group=None):
        self.model_devices = tuple(tuple(resolve_device(d) for d in g)
                                   for g in model_devices)
        if not self.model_devices or not all(self.model_devices):
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(g[0] for g in self.model_devices)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.data = (len(self.devices) * self.process_count if data is None
                     else int(data))
        self.first_shard = (self.process_index * len(self.devices)
                            if first_shard is None else int(first_shard))
        self.model = int(model)
        self.model_rank = int(model_rank)
        self.model_group = model_group
        self.data_group = data_group

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    def __repr__(self):
        return (f"Mesh(data={self.data}, model={self.model}, groups="
                f"{[[str(d) for d in g] for g in self.model_devices]}, "
                f"process {self.process_index}/{self.process_count})")


def local_devices() -> List[torch.device]:
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
    processes' following); ``devices=`` takes this process's list, which
    may repeat a device. ``cfg`` takes the first ``cfg.data · cfg.model``
    devices of the global order (process after process), grouped in runs of
    ``cfg.model``. A layout that fits no process (too few devices, a count
    the processes cannot split evenly, a model group neither inside one
    process nor one device a process) raises ``ValueError``."""
    from a3gc_tpu_torch.parallel import multihost
    devices = list(devices) if devices is not None else local_devices()
    n_proc, rank = multihost.process_count(), multihost.process_index()
    if cfg is None:
        cfg = MeshConfig(data=len(devices) * n_proc, model=1)
    D, M = cfg.data, cfg.model
    if D < 1 or M < 1 or (D * M) % n_proc \
            or (D * M) // n_proc > len(devices):
        raise ValueError(
            f"mesh {D}x{M} over {n_proc} process(es) needs "
            f"{max((D * M) // n_proc, 1)} device(s) a process, have "
            f"{len(devices)}")
    per_proc = D * M // n_proc
    if per_proc % M == 0:                      # groups inside the process
        groups = [devices[i:i + M] for i in range(0, per_proc, M)]
        return Mesh(groups, rank, n_proc, data=D, model=M,
                    first_shard=rank * len(groups))
    if per_proc != 1:
        raise ValueError(
            f"mesh {D}x{M}: a model group of {M} must lie in one process "
            f"or take one device from each of {M} processes; each of the "
            f"{n_proc} processes would hold {per_proc}")
    model_group, data_group = multihost.model_groups(M)
    return Mesh([devices[:1]], rank, n_proc, data=D, model=M,
                first_shard=rank // M, model_rank=rank % M,
                model_group=model_group, data_group=data_group)


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


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSharding:
    r"""Where one parameter lies over a mesh's ``model`` axis: ``axis`` -1
    (the last axis split in ``parts`` equal column blocks, one a member) or
    None (replicated, ``parts`` 1)."""
    axis: Optional[int] = None
    parts: int = 1

    @property
    def split(self) -> bool:
        return self.axis is not None


def param_sharding(mesh: Mesh, x) -> ParamSharding:
    r"""JAX's tensor-parallel placement of one parameter: the gate/feature
    axis is the LAST axis of every kernel ([in, 4H] gate kernels, [H, H]
    attention kernels, [F, 3H] GRU input kernels, behind a leading
    direction axis or not) and of the matching bias arrays, so split the
    last axis over ``model`` when the mesh has ``model > 1``, ``x`` has at
    least two axes and its last axis divides evenly and is at least 32
    wide. Everything else (15×15 adjacencies, narrow projections, 1-D
    biases) is replicated."""
    m = mesh.shape.get("model", 1)
    if (m > 1 and hasattr(x, "ndim") and x.ndim >= 2
            and x.shape[-1] % m == 0 and x.shape[-1] >= 32):
        return ParamSharding(-1, m)
    return ParamSharding()


def split_names(module: nn.Module, mesh: Mesh) -> frozenset:
    r"""The names of ``module``'s parameters that :func:`param_sharding`
    splits over ``mesh``."""
    return frozenset(n for n, p in module.named_parameters()
                     if param_sharding(mesh, p).split)


def shard_params(module: nn.Module, mesh: Mesh, shard: int = 0
                 ) -> List[nn.Module]:
    r"""``module`` placed by :func:`param_sharding` on the model group of
    local data shard ``shard``: one module a local member (all M when the
    group lies in this process, the process's own when it spans
    processes), of the same classes and parameter names, on the member's
    device, holding a fresh ``nn.Parameter`` of its column block
    ``[..., last / M]`` of every split parameter and a copy of every
    replicated one."""
    M = mesh.shape["model"]
    split = split_names(module, mesh)
    members = []
    for k, dev in enumerate(mesh.model_devices[shard]):
        j = mesh.model_rank + k

        def place(name, p, j=j, dev=dev):
            t = p.detach()
            if name in split:
                t = t.chunk(M, dim=-1)[j]
            return nn.Parameter(t.to(dev).clone(
                memory_format=torch.contiguous_format),
                requires_grad=p.requires_grad)
        members.append(map_parameters(module, place))
    return members
