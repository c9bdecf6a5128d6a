r"""Device resolution, small device-resident index tensors and the random
draws of a sharded training step, shared by the port's modules."""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch


def resolve_device(device="cuda") -> torch.device:
    r"""The ``torch.device`` an entry point runs on. ``cuda`` is the default
    of every entry point; asking for it on a machine without a usable card
    raises — there is no silent CPU path."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a3gc_tpu_torch: CUDA was asked for but no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_module_device(module: torch.nn.Module, device: torch.device,
                        what: str = "params"):
    r"""Raise unless every tensor of ``module`` lies on ``device``."""
    for t in module.parameters():
        if t.device != device:
            raise ValueError(
                f"{what} lie on {t.device}, the call runs on {device}; move "
                f"them with .to({str(device)!r})")


def index_tensor(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    r"""A cached int64 index tensor on ``device``, so that gathers and
    scatters on the card do not copy a host index on every call. Under
    ``torch.export`` tracing the tensor is made anew and not cached: it is
    a traced (fake) tensor there, which becomes a constant of the program
    and must not outlive the trace."""
    if torch.compiler.is_compiling():
        return torch.tensor(values, dtype=torch.long, device=device)
    return _cached_index_tensor(values, device)


@lru_cache(maxsize=None)
def _cached_index_tensor(values: Tuple[int, ...],
                         device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.long, device=device)


class RowDraws:
    r"""One data shard's view of a training step's generator. Every random
    draw (teacher-forcing noise, dropout keep-masks) is made at the size of
    the global batch and the shard keeps its own rows of it, so the shards
    of a step split over devices draw exactly the numbers the unsharded
    step draws. ``generator`` lies on the shard's device and starts in the
    unsharded step's state; ``batch`` is the global batch size, ``start``
    and ``length`` the shard's rows."""

    def __init__(self, generator: torch.Generator, batch: int, start: int,
                 length: int):
        self.generator = generator
        self.batch = batch
        self.start = start
        self.length = length


def random_rows(fn, rng, shape, device, batch_axis: int = 0, **kw):
    r"""``fn(shape, generator=rng, device=device, **kw)`` (``torch.rand``
    or ``torch.randn``); for a :class:`RowDraws`, the draw at the global
    batch size along ``batch_axis``, narrowed to the shard's rows."""
    if not isinstance(rng, RowDraws):
        return fn(shape, generator=rng, device=device, **kw)
    full = list(shape)
    full[batch_axis] = rng.batch
    return fn(full, generator=rng.generator, device=device, **kw).narrow(
        batch_axis, rng.start, rng.length)
