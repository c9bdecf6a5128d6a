r"""The masked scans over hoisted inputs (counterpart of
``a3gc_tpu/models/layers.py`` ``stack_directions``, ``_masked_state``,
``uni_rnn`` and ``bi_rnn_precomputed``), inference only. They are the
building blocks of the plain versions of the three scan kernels
(graph-LSTM, G-GRU, dense LSTM)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

__all__ = ["stack_directions", "uni_rnn", "bi_rnn_precomputed"]


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


def uni_rnn(step_fn: Callable, params, seq: torch.Tensor, init_state,
            frame_mask: Optional[torch.Tensor] = None):
    r"""Unidirectional layer over precomputed inputs, forward in time.

    :param step_fn: ``step_fn(params, u_t [B, ...], state) -> state``.
    :param seq: [B, T, ...].
    :param init_state: state tuple, each leaf [B, ...].
    :param frame_mask: [B, T] validity mask; masked steps carry the state
        through.
    :return: (carried h of every step [B, T, ...], final state). As in
        :func:`bi_rnn_precomputed`, the carried h where the JAX layer emits
        each step's own output: the two agree on valid frames.
    """
    mask_tm = None if frame_mask is None else frame_mask.T.bool()  # [T, B]
    state = tuple(init_state)
    outs = []
    for t in range(seq.shape[1]):
        new = step_fn(params, seq[:, t], state)
        if mask_tm is not None:
            new = _masked_state(new, state, mask_tm[t])
        state = tuple(new)
        outs.append(state[0])
    return torch.stack(outs, dim=1), state


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
    T = seq_stack.shape[1]
    mask_stack = None
    if frame_mask is not None:
        mask_tm = frame_mask.T.bool()                             # [T, B]
        mask_stack = torch.stack((mask_tm, mask_tm.flip(0)), dim=1)  # [T,2,B]
    state = tuple(init_state2)
    outs = []
    for t in range(T):
        new = step_fn(params2, seq_stack[:, t], state)
        if mask_stack is not None:
            new = _masked_state(new, state, mask_stack[t])
        state = tuple(new)
        outs.append(state[0])
    return torch.stack(outs, dim=1), state
