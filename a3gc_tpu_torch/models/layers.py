r"""The masked scans (counterpart of ``a3gc_tpu/models/layers.py``):
``stack_directions``, ``_masked_state``, ``_scan_rnn``, ``uni_rnn``,
``bi_rnn_precomputed`` over hoisted inputs — the building blocks of the
plain versions of the three scan kernels (graph-LSTM, G-GRU, dense LSTM) —
and ``bi_rnn`` over a layer's input, the training layers' scan, whose step
takes the frame's dropout masks."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

__all__ = ["stack_directions", "uni_rnn", "bi_rnn", "bi_rnn_precomputed"]


def stack_directions(fwd: nn.Module, bwd: nn.Module) -> nn.Module:
    r"""Stack two identically-shaped parameter containers on a new leading
    axis (the containers' constructor arguments are their attribute
    names)."""
    kw = {name: torch.stack((p.detach(), getattr(bwd, name).detach()))
          for name, p in fwd.named_parameters(recurse=False)}
    kw.update({name: stack_directions(m, getattr(bwd, name))
               for name, m in fwd.named_children()})
    return type(fwd)(**kw)


def _masked_state(new_state, old_state, m_t: torch.Tensor):
    """Carry the old state through masked-out (padding) steps. m_t [D, B]
    (or [B]) bool; state leaves [D, B, ...] (or [B, ...])."""
    def sel(a, b):
        m = m_t.reshape(m_t.shape + (1,) * (a.dim() - m_t.dim()))
        return torch.where(m, a, b)

    return tuple(sel(a, b) for a, b in zip(new_state, old_state))


def _scan_rnn(step_fn: Callable, params, seq: torch.Tensor, init_state,
              mask_tm: Optional[torch.Tensor] = None, extras=()):
    r"""Step a cell frame by frame over axis 1 of ``seq``:
    ``step_fn(params, seq[:, t], state, *(e[:, t] for e in extras))`` (an
    extra that is None passes None); frames where ``mask_tm[t]`` is False
    carry the state through. Returns (the carried h of every frame stacked
    on axis 1, the final state)."""
    state = tuple(init_state)
    outs = []
    for t in range(seq.shape[1]):
        new = step_fn(params, seq[:, t], state,
                      *(None if e is None else e[:, t] for e in extras))
        if mask_tm is not None:
            new = _masked_state(new, state, mask_tm[t])
        state = tuple(new)
        outs.append(state[0])
    return torch.stack(outs, dim=1), state


def uni_rnn(step_fn: Callable, params, seq: torch.Tensor, init_state,
            frame_mask: Optional[torch.Tensor] = None, extras=()):
    r"""Unidirectional layer, forward in time.

    :param step_fn: ``step_fn(params, u_t [B, ...], state, *extras_t) ->
        state``.
    :param seq: [B, T, ...].
    :param init_state: state tuple, each leaf [B, ...].
    :param frame_mask: [B, T] validity mask; masked steps carry the state
        through.
    :param extras: per-frame inputs of the step (dropout masks), each
        [B, T, ...] or None.
    :return: (carried h of every step [B, T, ...], final state). As in
        :func:`bi_rnn_precomputed`, the carried h where the JAX layer emits
        each step's own output: the two agree on valid frames.
    """
    mask_tm = None if frame_mask is None else frame_mask.T.bool()  # [T, B]
    return _scan_rnn(step_fn, params, seq, init_state, mask_tm, extras)


def _direction_masks(frame_mask: Optional[torch.Tensor]):
    r"""[B, T] validity mask → [T, 2, B] in each direction's walk order."""
    if frame_mask is None:
        return None
    mask_tm = frame_mask.T.bool()                                 # [T, B]
    return torch.stack((mask_tm, mask_tm.flip(0)), dim=1)


def bi_rnn(step_fn: Callable, params2, x: torch.Tensor, init_state2,
           frame_mask: Optional[torch.Tensor] = None, extras=()):
    r"""Bidirectional layer over a layer's input x [B, T, ...]: direction 0
    walks frames 0 … T-1, direction 1 walks T-1 … 0, both in one loop on
    direction-stacked parameters (the JAX layer's ``vmap`` over the
    direction axis).

    :param step_fn: ``step_fn(params2, x_t [2, B, ...], state, *extras_t)
        -> state``.
    :param init_state2: state tuple, each leaf [2, B, ...].
    :param frame_mask: [B, T] validity mask (ones-prefix rows); masked
        steps carry the state through.
    :param extras: per-frame inputs of the step in walk order, each
        [2, T, B, ...] or None (the dropout masks).
    :return: (carried h of every frame [B, T, ..., 2H], forward ‖ backward
        in frame order, final state).
    """
    x_tm = x.transpose(0, 1)                                     # [T, B, ...]
    seq_stack = torch.stack((x_tm, x_tm.flip(0)))
    hs, state = _scan_rnn(step_fn, params2, seq_stack, init_state2,
                          _direction_masks(frame_mask), extras)
    return torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1), state


def bi_rnn_precomputed(step_fn: Callable, params2, seq_stack: torch.Tensor,
                       init_state2,
                       frame_mask: Optional[torch.Tensor] = None):
    r"""Bidirectional layer over direction-specific precomputed inputs.

    :param step_fn: ``step_fn(params2, u_t [2, B, ...], state) -> state``
        on direction-stacked parameters and states.
    :param seq_stack: [2, T, B, ...] — direction 1's sequence already
        time-flipped.
    :param init_state2: state tuple, each leaf [2, B, ...] (a 1-tuple for
        the G-GRU cell).
    :param frame_mask: [B, T] validity mask (ones-prefix rows for
        end-padded input); masked steps carry the state through.
    :return: (carried h of every step [2, T, B, ...] in walk order — the
        backward direction's still flipped — , final state). Unlike the JAX
        layer, which emits each step's own output, this emits the carried
        h: the two agree on valid frames, and on masked frames this is the
        Pallas kernels' (and the CUDA kernel's) output.
    """
    return _scan_rnn(step_fn, params2, seq_stack, init_state2,
                     _direction_masks(frame_mask))
