r"""Column-parallel products for tensor parallelism (TP) over a mesh's
``model`` axis. The JAX package has no counterpart: there XLA partitions
the products of a parameter that ``param_sharding`` splits and inserts the
collectives; here the forward calls them out.

A parameter that :func:`~a3gc_tpu_torch.parallel.mesh.param_sharding`
splits lies as column blocks on the members of a model group (its last
axis split in M equal parts, member j holding part j). The TP forward sees
a view of the lead's module (:func:`column_view`) in which each such
parameter is a :class:`Columns`. The nets read their parameters through
three functions, which pass a plain tensor through unchanged:

  * :func:`matmul` where the parameter is the right operand of a product:
    member j computes ``x @ W_j`` on its device from the whole left
    operand, and the blocks are concatenated on the lead; autograd splits
    the gradient back into the blocks;
  * :func:`full` for any other read (a bias add, a slice): the blocks
    gathered on the lead, once a forward;
  * :func:`blockwise` for a cast or a reshape that keeps the last axis.

Everything else (the per-gate adjacency mix, the cell, the attention's
reductions, the loss) runs on the lead on whole tensors. A ``Columns``
supports nothing else, so a read that forgets to gather raises.

When a group spans processes (one device a process), a ``Columns`` holds
the process's own block and the group's ``torch.distributed`` subgroup,
and :func:`matmul` uses Megatron's pair: ``f`` on the left operand
(forward identity, backward all-reduce over the group) and ``g`` on the
output (forward all-gather over the group, backward keep the own slice).
Every member then holds the group's activations and computes the
non-product work too, as JAX's replication over ``model`` does.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch
from torch import nn

from a3gc_tpu_torch.ops._common import operand

__all__ = ["Columns", "matmul", "full", "blockwise", "column_view",
           "gather_module", "map_parameters"]


class Columns:
    r"""A parameter split on its last axis over a model group: ``blocks``
    (one a local member, in member order, the lead's first), ``full``
    (their gather on the lead, or across the group) and ``group`` (the
    process subgroup when the group spans processes, else None)."""

    def __init__(self, blocks: Sequence[torch.Tensor], full: torch.Tensor,
                 group=None):
        self.blocks = tuple(blocks)
        self.full = full
        self.group = group

    @property
    def device(self) -> torch.device:
        r"""The lead's device, where the products meet."""
        return self.blocks[0].device


def _gather_blocks(blocks: Sequence[torch.Tensor], group) -> torch.Tensor:
    if group is not None:
        return _GatherFromGroup.apply(blocks[0], group)
    lead = blocks[0].device
    return torch.cat([b.to(lead) for b in blocks], dim=-1)


def full(w):
    r"""The whole parameter: a plain tensor as it is, a :class:`Columns`
    gathered on the lead."""
    return w.full if isinstance(w, Columns) else w


def blockwise(w, fn: Callable[[torch.Tensor], torch.Tensor]):
    r"""``fn(w)``; for a :class:`Columns`, ``fn`` of each block and of the
    gather (``fn`` must keep the last axis: a cast, a reshape to
    ``(..., -1)``, an index of the leading axes)."""
    if not isinstance(w, Columns):
        return fn(w)
    return Columns([fn(b) for b in w.blocks], fn(w.full), w.group)


def matmul(x: torch.Tensor, w, stacked: bool = False,
           fmt: str = "fp32") -> torch.Tensor:
    r"""``x @ w`` (``torch.matmul``) on operands in format ``fmt``
    (:func:`~a3gc_tpu_torch.ops._common.operand`: at "tf32" both rounded
    to TF32, summed in fp32); ``stacked``: ``w`` carries a leading
    direction axis that x has before its batch axes (``x @ w[:, None]``).
    For a :class:`Columns`, the column-parallel product: member j's block
    on its device, the outputs concatenated on x's device; across
    processes, ``g(f(x) @ W_own)``. Rounding is elementwise, so a block
    rounds as its columns of the whole do."""
    def right(t):
        t = operand(t, fmt)
        return t[:, None] if stacked else t

    x = operand(x, fmt)
    if not isinstance(w, Columns):
        return torch.matmul(x, right(w))
    if w.group is not None:
        y = torch.matmul(_CopyToGroup.apply(x, w.group), right(w.blocks[0]))
        return _GatherFromGroup.apply(y, w.group)
    lead = x.device
    return torch.cat([torch.matmul(x.to(b.device), right(b)).to(lead)
                      for b in w.blocks], dim=-1)


class _CopyToGroup(torch.autograd.Function):
    r"""Megatron's ``f``: identity forward; the backward sums the
    members' partial gradients of the left operand over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    r"""Megatron's ``g``: the members' column blocks concatenated in
    member order on every member; the backward keeps the own slice (every
    member computed the same gradient of the whole)."""

    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist
        y = y.contiguous()
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        ctx.start = dist.get_rank(group) * y.shape[-1]
        ctx.width = y.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.start, ctx.width).contiguous(), None


def map_parameters(module: nn.Module,
                   fn: Callable[[str, torch.Tensor], object]) -> nn.Module:
    r"""A structural copy of ``module`` whose parameter ``name`` (as
    ``named_parameters`` names it) is ``fn(name, p)``: a new module tree of
    the same classes, the originals untouched."""
    def walk(m, prefix):
        clone = copy.copy(m)
        clone._parameters = {k: None if v is None else fn(prefix + k, v)
                             for k, v in m._parameters.items()}
        clone._modules = {k: None if c is None else walk(c, f"{prefix}{k}.")
                          for k, c in m._modules.items()}
        return clone
    return walk(module, "")


def column_view(members: Sequence[nn.Module], split, group=None
                ) -> nn.Module:
    r"""The module a TP forward reads: the lead's (``members[0]``) with
    each parameter named in ``split`` a :class:`Columns` of the members'
    blocks, gathered once here; the others the lead's. ``group``: the
    process subgroup when the model group spans processes."""
    named = [dict(m.named_parameters()) for m in members]

    def pick(name, p):
        if name not in split:
            return p
        blocks = [n[name] for n in named]
        return Columns(blocks, _gather_blocks(blocks, group), group)
    return map_parameters(members[0], pick)


def gather_module(members: Sequence[nn.Module], split,
                  group=None) -> nn.Module:
    r"""The whole module on the lead, detached: each parameter named in
    ``split`` the concatenation of the members' blocks (across the group's
    processes when ``group`` is given: a collective), the others the
    lead's copies."""
    with torch.no_grad():
        view = column_view(members, split, group)
        return map_parameters(view, lambda _, p: nn.Parameter(
            full(p).detach().clone()))
