r"""Arithmetic the metric readers share: percentiles over every request,
kernel rooflines and model FLOP utilisation."""

from __future__ import annotations

from typing import Optional

import numpy as np

from portbench import work as W


def percentile(values, q: float) -> Optional[float]:
    r"""The q-th percentile of every value (linear between order
    statistics); None when there is none."""
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return None
    return float(np.percentile(values, q))


def roofline_pct(m, kernel: str, pattern: str) -> Optional[float]:
    r"""The share of the least time the card could take for the scans of
    ``kernel`` that the window's calls needed (their work counted from
    shapes by the family's ``scan_calls``) in the device time of the
    kernels whose names match ``pattern``. None without a trace, without
    such calls, or where no such kernel ran."""
    if m.trace is None:
        return None
    need = 0.0
    for S, T in m.calls:
        for name, flop, nbytes in m.family.scan_calls(m.config, S, T):
            if name == kernel:
                need += W.bound_seconds(flop, nbytes, m.peak_flops)
    took = m.trace.kernel_seconds(pattern)
    if need == 0.0 or took == 0.0:
        return None
    return 100.0 * need / took


def mfu_pct(m) -> Optional[float]:
    r"""Model FLOP of the frames delivered over the window, as a share of
    the peak of the configuration's format."""
    if not m.frames or not m.window_s:
        return None
    flop = m.family.flop_per_frame(m.config) * m.frames
    return 100.0 * flop / m.window_s / m.peak_flops


def mean_tick_ms(m) -> Optional[float]:
    r"""Mean wall time of the session steps of the window, ms."""
    if m.ticks is None or len(m.ticks) == 0:
        return None
    return 1e3 * float((m.ticks[:, 1] - m.ticks[:, 0]).mean())


def idle_pct(m) -> Optional[float]:
    r"""Share of the traced window in which nothing ran on the device:
    100 × (1 − the union of the device's activity intervals / the
    window)."""
    if m.trace is None or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
