r"""The DIP family: one dense biLSTM net (``net_aagc.py:22-38``), the leaves
of its weights in the port's parameter layout, the port's objects built on
them, and the work of its products.

The net is one stage of the dense cascade family
(:mod:`portbench.families.dense`), under ``s1.``, with the same layout and
initialisation bounds: ``linear1`` (60 → H, ReLU), ``layers``
bidirectional LSTM layers (F = H, then 2H), ``linear2`` (2H → 135). So the
leaves, the scans and the FLOP of a frame are that family's, counted over
the configuration's one stage; only the port's objects differ (one
:class:`PoseNetConfig` and its :class:`DIPParams`, not a cascade).
"""

from __future__ import annotations

from portbench.families import dense
from portbench.families.dense import flop_per_frame, param_spec, scan_calls

__all__ = ["param_spec", "port_cascade", "scan_calls", "flop_per_frame"]


def port_cascade(cfg, w):
    r"""The port's (PoseNetConfig, DIPParams) on the tensors ``w``, the
    config as ``cli evaluate --model dip`` builds it (``cli._dip_config``:
    60 → 15·rotsize, H = ``--hu1``, the CLI's precision)."""
    cascade, params = dense.port_cascade(cfg, w)
    return cascade.stage1, params[0]
