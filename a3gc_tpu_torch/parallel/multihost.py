r"""Multi-process training (counterpart of ``a3gc_tpu/parallel/multihost.py``):
N processes, one a card, join one ``torch.distributed`` process group, and
the mesh machinery spans them:

  * :func:`~a3gc_tpu_torch.parallel.mesh.make_mesh` then lists this
    process's device as its shard of a ``data`` axis of N shards;
  * every process builds the same global batch on the host (same flags,
    files and seed give the same sampler order) and runs its own rows;
  * a step reduces the shards' weighted gradient and loss sums over the
    processes with one all-reduce, so every replica takes the same Adam
    step and every process sees the same losses (and early-stops alike);
  * with tensor parallelism over processes (a model group of M processes,
    one device each), :func:`model_groups` makes the subgroups: the
    products all-gather over the group, and the step's all-reduce runs over
    the processes of one member index (the data axis) only.

The group uses ``nccl`` when the process's device is a card and ``gloo``
when it is the CPU; a failed initialisation raises. Process r runs on card
``r % device_count()``, and NCCL takes one rank a card. Process 0 writes the
JSONL log, stdout and the checkpoint directories; the others wait for it at
a barrier. Wired into ``cli train --coordinator``.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["initialize_multihost", "is_coordinator", "process_index",
           "process_count", "process_device", "fetch_replicated", "any_flag",
           "all_reduce_sum", "barrier", "interrupt_checker", "model_groups"]


def initialize_multihost(coordinator: str, num_processes: int,
                         process_id: int, device=None,
                         timeout_s: float = 600.0) -> Tuple[int, int]:
    r"""Join the process group whose process 0 listens on ``coordinator``
    (``host:port``) as rank ``process_id`` of ``num_processes``. ``device``:
    ``"cpu"`` (``gloo``), or a card (``nccl``; default: card ``process_id %
    device_count()``). Call it before building the mesh. Returns
    ``(process_index, process_count)``."""
    import torch.distributed as dist

    dev = torch.device(device) if device is not None else torch.device(
        "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a3gc_tpu_torch: a multi-process run on the cards was asked "
                "for but no CUDA device is available; pass device='cpu' "
                "(cli: --device cpu) for a gloo group on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend, extra = "nccl", {"device_id": dev}
    elif dev.type == "cpu":
        backend, extra = "gloo", {}
    else:
        raise ValueError(f"no process group for device {dev}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **extra)
    return dist.get_rank(), dist.get_world_size()


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if _initialized() else 1


def process_device() -> Optional[torch.device]:
    r"""This process's device in a multi-process run (the card
    :func:`initialize_multihost` made current for ``nccl``, the CPU for
    ``gloo``), else None."""
    if not _initialized():
        return None
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def is_coordinator() -> bool:
    r"""True on the process that owns logging, stdout and checkpoint
    writes (a single-process run is its own coordinator)."""
    return process_index() == 0


def model_groups(model: int):
    r"""The ``torch.distributed`` subgroups of model groups that span
    processes, ``model`` consecutive processes a group: (the group holding
    this process, the processes of this process's member index: its data
    axis). Every process creates every subgroup, in the same order, so all
    must call together (:func:`~a3gc_tpu_torch.parallel.mesh.make_mesh`
    does, on every process)."""
    import torch.distributed as dist
    n, rank = process_count(), process_index()
    mine = {}
    for g in range(n // model):
        ranks = list(range(g * model, (g + 1) * model))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["model"] = group
    for j in range(model):
        ranks = list(range(j, n, model))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["data"] = group
    return mine["model"], mine["data"]


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    r"""Sum each tensor over the processes (of ``group``, default all), in
    place, with one all-reduce of their concatenation on this process's
    device (a no-op when there is one process). Every process of the group
    must call with the same shapes."""
    if not tensors:
        return
    import torch.distributed as dist
    if process_count() == 1 or (group is not None
                                and dist.get_world_size(group) == 1):
        return
    dev = process_device()
    flat = torch.cat([t.reshape(-1).to(dev, torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def barrier() -> None:
    r"""Wait for every process (a no-op in a single-process run)."""
    if process_count() > 1:
        import torch.distributed as dist
        dist.barrier()


def any_flag(flag: bool, mesh=None) -> bool:
    r"""Collective OR of a per-process host flag (e.g. "this process got
    SIGTERM"): an all-reduce MAX, so that a decision every process must take
    at the same step (a preemption checkpoint) is taken everywhere. All
    processes must call together."""
    del mesh                    # the flag is per process, not per shard
    if process_count() == 1:
        return bool(flag)
    import torch.distributed as dist
    t = torch.tensor([1.0 if flag else 0.0], device=process_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def fetch_replicated(tree, mesh=None):
    r"""A host numpy copy of a replicated tree (a module as its named
    parameters, a tensor, or a dict / tuple / list of them). The port
    replicates every parameter and optimizer leaf, so this process's copy
    is the global value (under tensor parallelism, a runner's
    ``state.params``, gathered over the model group, is); compare the copies
    of two processes to check that their replicas agree."""
    del mesh
    if isinstance(tree, torch.nn.Module):
        return {k: v.detach().cpu().numpy()
                for k, v in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: fetch_replicated(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(fetch_replicated(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def interrupt_checker(interrupt, mesh):
    r"""The per-epoch "stop now?" predicate of the training drivers.
    Single-process: the flag itself. Multi-process: the flag OR-ed over
    the processes (:func:`any_flag`), so every process stops at the same
    epoch boundary. Multi-process training without a mesh is refused up
    front: with nothing spanning the processes, a signalled process would
    stop alone and the others would wait in their next collective."""
    if interrupt is None:
        return lambda: False
    multihost = process_count() > 1
    if multihost and mesh is None:
        raise ValueError(
            "multi-process training needs a process-spanning mesh to "
            "sync the interrupt flag (run with --mesh, or build runners "
            "with mesh=)")

    def _interrupted() -> bool:
        trig = bool(interrupt())
        return any_flag(trig, mesh) if multihost else trig

    return _interrupted
