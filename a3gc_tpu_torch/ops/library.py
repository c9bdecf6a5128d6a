r"""The three scan kernels as ``torch.library`` custom ops, on the hoisted
inputs their ``scan`` functions take: ``a3gc_tpu_torch::gcn_lstm_scan``,
``a3gc_tpu_torch::ggru_scan`` and ``a3gc_tpu_torch::lstm_scan``.

Each op has three implementations:

  * CUDA: the kernel's ``scan`` (``ops/gcn_lstm.py``, ``ops/ggru.py``,
    ``ops/lstm.py``), with its argument checks, its launch plan (the
    module's ``cached_plan``, the one the nets' dispatch reads) and its
    launch counter — they run wherever the op runs, in the eager layers
    and in a loaded ``torch.export`` program alike;
  * CPU: the kernel's plain version on the same inputs (``scan_reference``);
  * fake (``register_fake``): the output shapes only, for tracing;

and one autograd formula (``register_autograd``): the kernels have no
backward, so the backward reruns the plain version on the saved inputs,
on their device, and differentiates that — the JAX package's
``custom_jvp`` of its Pallas layers, which recomputes on the XLA scan. The
integer ``n_valid`` and absent attention inputs get no gradient.

Each op ends in ``bool tf32=False``, the operand format of its products
(the kernel's TF32 instantiation on the card, the plain version's rounded
products on the CPU and in the backward). A program exported before the
flag existed calls the ops without it and keeps its fp32 meaning; one
exported from a net at "default" on the card holds ``tf32=True`` in its
graph.

Beside them, ``a3gc_tpu_torch::gcn_lstm_scan_plain`` / ``ggru_scan_plain``
/ ``lstm_scan_plain`` take the same arguments and compute the plain version
on every device: the form in which a traced program (``torch.export``)
holds the plain version of a layer whose kernel has no launch plan at the
traced shape (``bi_*_reference`` calls them while tracing). One node a
layer call, where the frame loop traced op by op is tens of thousands
(``scripts/torch_export_plain.py``, the A3GC cascade at ``--hu1 80``,
S = 8, W = 60, TF32 operands, on an H100's host: 767 nodes against
25,525, 19 s against 160 s to export, 1.7 s against 53 s to load). Each
adds one to its kernel wrapper's ``plain_dispatches``, as the eager
dispatch does.

No op writes its inputs (``mutates_args=()``): no launch writes its
initial state. ``bi_gcn_lstm``, ``bi_ggru`` and ``bi_lstm`` call the ops,
so a program exported from the port's window step holds one node per layer
call, and a process that loads such a program must import this module
first (:func:`a3gc_tpu_torch.export.load_exported` does). Importing it
builds nothing: the kernel libraries are built at their first launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from a3gc_tpu_torch.ops import gcn_lstm as G
from a3gc_tpu_torch.ops import ggru as GG
from a3gc_tpu_torch.ops import lstm as LS

__all__ = ["NAMESPACE", "gcn_lstm_scan", "ggru_scan", "lstm_scan",
           "gcn_lstm_scan_plain", "ggru_scan_plain", "lstm_scan_plain"]

NAMESPACE = "a3gc_tpu_torch"


def _contiguous(*ts: Tensor):
    return tuple(t.contiguous() for t in ts)


# -- gcn_lstm ----------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::gcn_lstm_scan", mutates_args=(),
                         device_types="cpu")
def gcn_lstm_scan(u: Tensor, wh: Tensor, adj: Tensor, bias: Tensor,
                  att_w: Optional[Tensor], att_wq: Optional[Tensor],
                  att_wh: Optional[Tensor], att_u: Optional[Tensor],
                  att_bs: Optional[Tensor], att_bu: Optional[Tensor],
                  h0: Tensor, c0: Tensor, n_valid: Tensor,
                  tf32: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    r"""One graph-LSTM layer call, both directions: the arguments of
    ``gcn_lstm.scan`` with the attention tuple spread (all six None for an
    AAGC cell). Returns (y [S, T, N, 2H], h, c [2, S, N, H])."""
    return _contiguous(*_gcn_lstm_plain(u, wh, adj, bias, att_w, att_wq,
                                        att_wh, att_u, att_bs, att_bu, h0,
                                        c0, n_valid, tf32))


def _attention(*att):
    return None if att[0] is None else tuple(att)


def _gcn_lstm_plain(u, wh, adj, bias, att_w, att_wq, att_wh, att_u, att_bs,
                    att_bu, h0, c0, n_valid, tf32=False):
    att = _attention(att_w, att_wq, att_wh, att_u, att_bs, att_bu)
    return G.scan_reference(u, wh, adj, bias, att, h0, c0, n_valid, tf32)


@gcn_lstm_scan.register_kernel("cuda")
def _gcn_lstm_cuda(u, wh, adj, bias, att_w, att_wq, att_wh, att_u, att_bs,
                   att_bu, h0, c0, n_valid, tf32=False):
    att = _attention(att_w, att_wq, att_wh, att_u, att_bs, att_bu)
    return G.scan(u, wh, adj, bias, att, h0, c0, n_valid, tf32=tf32)


@gcn_lstm_scan.register_fake
def _gcn_lstm_fake(u, wh, adj, bias, att_w, att_wq, att_wh, att_u, att_bs,
                   att_bu, h0, c0, n_valid, tf32=False):
    _, S, T, N, G4 = u.shape
    H = G4 // 4
    return (u.new_empty((S, T, N, 2 * H)), h0.new_empty((2, S, N, H)),
            h0.new_empty((2, S, N, H)))


# -- ggru --------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::ggru_scan", mutates_args=(),
                         device_types="cpu")
def ggru_scan(zi: Tensor, gcn_kernel: Tensor, adj: Tensor, w_hid: Tensor,
              h0: Tensor, n_valid: Tensor,
              tf32: bool = False) -> Tuple[Tensor, Tensor]:
    r"""One G-GRU layer call, both directions: the arguments of
    ``ggru.scan``. Returns (y [S, T, N, 2H], h [2, S, N, H])."""
    return _contiguous(*GG.scan_reference(zi, gcn_kernel, adj, w_hid, h0,
                                          n_valid, tf32))


@ggru_scan.register_kernel("cuda")
def _ggru_cuda(zi, gcn_kernel, adj, w_hid, h0, n_valid, tf32=False):
    return GG.scan(zi, gcn_kernel, adj, w_hid, h0, n_valid, tf32=tf32)


@ggru_scan.register_fake
def _ggru_fake(zi, gcn_kernel, adj, w_hid, h0, n_valid, tf32=False):
    _, S, T, N, G3 = zi.shape
    H = G3 // 3
    return zi.new_empty((S, T, N, 2 * H)), h0.new_empty((2, S, N, H))


# -- lstm --------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::lstm_scan", mutates_args=(),
                         device_types="cpu")
def lstm_scan(u: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor,
              n_valid: Tensor,
              tf32: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    r"""One dense LSTM layer call, D = u.shape[0] directions: the arguments
    of ``lstm.scan``. Returns (y [S, T, D·H], h, c [D, S, H])."""
    return _contiguous(*LS.scan_reference(u, w_hh, h0, c0, n_valid, tf32))


@lstm_scan.register_kernel("cuda")
def _lstm_cuda(u, w_hh, h0, c0, n_valid, tf32=False):
    return LS.scan(u, w_hh, h0, c0, n_valid, tf32=tf32)


@lstm_scan.register_fake
def _lstm_fake(u, w_hh, h0, c0, n_valid, tf32=False):
    D, S, T, G4 = u.shape
    H = G4 // 4
    return (u.new_empty((S, T, D * H)), h0.new_empty((D, S, H)),
            h0.new_empty((D, S, H)))


# -- the plain versions as ops ------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::gcn_lstm_scan_plain",
                         mutates_args=())
def gcn_lstm_scan_plain(u: Tensor, wh: Tensor, adj: Tensor, bias: Tensor,
                        att_w: Optional[Tensor], att_wq: Optional[Tensor],
                        att_wh: Optional[Tensor], att_u: Optional[Tensor],
                        att_bs: Optional[Tensor], att_bu: Optional[Tensor],
                        h0: Tensor, c0: Tensor, n_valid: Tensor,
                        tf32: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    r""":func:`gcn_lstm_scan`'s plain version on any device."""
    G.bi_gcn_lstm.plain_dispatches += 1
    return _contiguous(*_gcn_lstm_plain(u, wh, adj, bias, att_w, att_wq,
                                        att_wh, att_u, att_bs, att_bu, h0,
                                        c0, n_valid, tf32))


@torch.library.custom_op(f"{NAMESPACE}::ggru_scan_plain", mutates_args=())
def ggru_scan_plain(zi: Tensor, gcn_kernel: Tensor, adj: Tensor,
                    w_hid: Tensor, h0: Tensor, n_valid: Tensor,
                    tf32: bool = False) -> Tuple[Tensor, Tensor]:
    r""":func:`ggru_scan`'s plain version on any device."""
    GG.bi_ggru.plain_dispatches += 1
    return _contiguous(*GG.scan_reference(zi, gcn_kernel, adj, w_hid, h0,
                                          n_valid, tf32))


@torch.library.custom_op(f"{NAMESPACE}::lstm_scan_plain", mutates_args=())
def lstm_scan_plain(u: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor,
                    n_valid: Tensor,
                    tf32: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    r""":func:`lstm_scan`'s plain version on any device."""
    LS.bi_lstm.plain_dispatches += 1
    return _contiguous(*LS.scan_reference(u, w_hh, h0, c0, n_valid, tf32))


gcn_lstm_scan_plain.register_fake(_gcn_lstm_fake)
ggru_scan_plain.register_fake(_ggru_fake)
lstm_scan_plain.register_fake(_lstm_fake)


# -- autograd: the plain version's gradients ---------------------------------

def _save_inputs(ctx, inputs, output):
    *tensors, ctx.tf32 = inputs
    ctx.save_for_backward(*tensors)


def _plain_backward(plain):
    r"""The backward of an op whose plain version is ``plain`` (same
    arguments, same outputs): rerun ``plain`` under grad, at the op's
    ``tf32``, on detached copies of the saved inputs that need a gradient
    and return ``torch.autograd.grad`` with respect to them, None for the
    others and for the flag."""
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        needs = [need and t is not None and t.is_floating_point()
                 for need, t in zip(ctx.needs_input_grad, inputs)]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if need else t
                      for t, need in zip(inputs, needs)]
            outs = plain(*leaves, ctx.tf32)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], [t for t, n in zip(leaves, needs) if n],
                [g for _, g in pairs], allow_unused=True))
        return tuple(next(got) if need else None for need in needs) \
            + (None,)
    return backward


gcn_lstm_scan.register_autograd(_plain_backward(_gcn_lstm_plain),
                                setup_context=_save_inputs)
ggru_scan.register_autograd(_plain_backward(GG.scan_reference),
                            setup_context=_save_inputs)
lstm_scan.register_autograd(_plain_backward(LS.scan_reference),
                            setup_context=_save_inputs)
gcn_lstm_scan_plain.register_autograd(_plain_backward(_gcn_lstm_plain),
                                      setup_context=_save_inputs)
ggru_scan_plain.register_autograd(_plain_backward(GG.scan_reference),
                                  setup_context=_save_inputs)
lstm_scan_plain.register_autograd(_plain_backward(LS.scan_reference),
                                  setup_context=_save_inputs)
