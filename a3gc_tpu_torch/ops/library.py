r"""The three scan kernels as ``torch.library`` custom ops, on the hoisted
inputs their ``scan`` functions take: ``a3gc_tpu_torch::gcn_lstm_scan``,
``a3gc_tpu_torch::ggru_scan`` and ``a3gc_tpu_torch::lstm_scan``.

Each op has three implementations:

  * CUDA: the kernel's ``scan`` (``ops/gcn_lstm.py``, ``ops/ggru.py``,
    ``ops/lstm.py``), with its argument checks, its launch plan (a device
    query) and its launch counter — they run wherever the op runs, in the
    eager layers and in a loaded ``torch.export`` program alike;
  * CPU: the kernel's plain version on the same inputs (``scan_reference``);
  * fake (``register_fake``): the output shapes only, for tracing.

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

__all__ = ["NAMESPACE", "gcn_lstm_scan", "ggru_scan", "lstm_scan"]

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
                  h0: Tensor, c0: Tensor,
                  n_valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    r"""One graph-LSTM layer call, both directions: the arguments of
    ``gcn_lstm.scan`` with the attention tuple spread (all six None for an
    AAGC cell). Returns (y [S, T, N, 2H], h, c [2, S, N, H])."""
    att = _attention(att_w, att_wq, att_wh, att_u, att_bs, att_bu)
    return _contiguous(*G.scan_reference(u, wh, adj, bias, att, h0, c0,
                                         n_valid))


def _attention(*att):
    return None if att[0] is None else tuple(att)


@gcn_lstm_scan.register_kernel("cuda")
def _gcn_lstm_cuda(u, wh, adj, bias, att_w, att_wq, att_wh, att_u, att_bs,
                   att_bu, h0, c0, n_valid):
    att = _attention(att_w, att_wq, att_wh, att_u, att_bs, att_bu)
    return G.scan(u, wh, adj, bias, att, h0, c0, n_valid)


@gcn_lstm_scan.register_fake
def _gcn_lstm_fake(u, wh, adj, bias, att_w, att_wq, att_wh, att_u, att_bs,
                   att_bu, h0, c0, n_valid):
    _, S, T, N, G4 = u.shape
    H = G4 // 4
    return (u.new_empty((S, T, N, 2 * H)), h0.new_empty((2, S, N, H)),
            h0.new_empty((2, S, N, H)))


# -- ggru --------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::ggru_scan", mutates_args=(),
                         device_types="cpu")
def ggru_scan(zi: Tensor, gcn_kernel: Tensor, adj: Tensor, w_hid: Tensor,
              h0: Tensor, n_valid: Tensor) -> Tuple[Tensor, Tensor]:
    r"""One G-GRU layer call, both directions: the arguments of
    ``ggru.scan``. Returns (y [S, T, N, 2H], h [2, S, N, H])."""
    return _contiguous(*GG.scan_reference(zi, gcn_kernel, adj, w_hid, h0,
                                          n_valid))


@ggru_scan.register_kernel("cuda")
def _ggru_cuda(zi, gcn_kernel, adj, w_hid, h0, n_valid):
    return GG.scan(zi, gcn_kernel, adj, w_hid, h0, n_valid)


@ggru_scan.register_fake
def _ggru_fake(zi, gcn_kernel, adj, w_hid, h0, n_valid):
    _, S, T, N, G3 = zi.shape
    H = G3 // 3
    return zi.new_empty((S, T, N, 2 * H)), h0.new_empty((2, S, N, H))


# -- lstm --------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::lstm_scan", mutates_args=(),
                         device_types="cpu")
def lstm_scan(u: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor,
              n_valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    r"""One dense LSTM layer call, D = u.shape[0] directions: the arguments
    of ``lstm.scan``. Returns (y [S, T, D·H], h, c [D, S, H])."""
    return _contiguous(*LS.scan_reference(u, w_hh, h0, c0, n_valid))


@lstm_scan.register_kernel("cuda")
def _lstm_cuda(u, w_hh, h0, c0, n_valid):
    return LS.scan(u, w_hh, h0, c0, n_valid)


@lstm_scan.register_fake
def _lstm_fake(u, w_hh, h0, c0, n_valid):
    D, S, T, G4 = u.shape
    H = G4 // 4
    return (u.new_empty((S, T, D * H)), h0.new_empty((D, S, H)),
            h0.new_empty((D, S, H)))
