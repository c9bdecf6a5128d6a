r"""The program's layer spans (``a3gc.*``, ``a3gc_tpu_torch/_runtime.py``)
in a traced window, read into the per-layer metrics that say which layer
the device's idle time and the host's launches belong to.

The spans are host events of the same trace as the card's activity, on one
clock. At every instant of the window the innermost open span is the open
one with the latest start (the offline benchmark steps the card from one
thread); each idle nanosecond of the device (the gaps of the union that
``trace.Trace`` takes) then falls in exactly one part:

* ``prep``: ``a3gc.prep``; ``round``: ``a3gc.round``; ``ik``: ``a3gc.ik``;
* ``rnn``: ``a3gc.rnn``, less its ``a3gc.round`` children;
* ``cascade``: ``a3gc.cascade`` or ``a3gc.stageN``, less their children;
* ``outside``: no such span open (the benchmark loop, its copies, the
  profiler).

The parts sum to ``device.idle_pct``. A host launch (an event named
``cudaLaunch*`` or ``cuLaunch*``) counts for the part open at its start.
Every function returns None without a trace, without calls, without
device activity (a run with no card) or where no layer span was recorded
(a program that has none).
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

PART = {"a3gc.prep": "prep", "a3gc.round": "round", "a3gc.rnn": "rnn",
        "a3gc.ik": "ik", "a3gc.cascade": "cascade",
        "a3gc.stage1": "cascade", "a3gc.stage2": "cascade",
        "a3gc.stage3": "cascade"}
PARTS = ("prep", "round", "rnn", "ik", "cascade", "outside")
LAUNCH = ("cudaLaunch", "cuLaunch")


class Spans:
    r"""The window cut into pieces at every span's start and end:
    ``edges`` [P + 1] ns and the part of each piece, ``part`` [P]
    (an index into ``PARTS``); ``idle`` [P]: the device's idle ns in each
    piece; ``launches`` [P]: host launches that start in it."""

    def __init__(self, trace):
        lo, hi = trace.start_ns, trace.stop_ns
        spans = [(max(int(s), lo), min(int(e), hi), PARTS.index(PART[n]))
                 for s, e, n in zip(trace.host_start, trace.host_end,
                                    trace.host_name)
                 if n in PART and e > lo and s < hi]
        self.found = bool(spans)
        edges = sorted({lo, hi} | {t for s, e, _ in spans for t in (s, e)})
        self.edges = np.asarray(edges, np.int64)
        self.part = self._innermost(spans)
        self.idle = self._idle_in_pieces(trace._gaps)   # busy_s's gaps
        self.launches = self._launches_in_pieces(trace)

    def _innermost(self, spans) -> np.ndarray:
        r"""The part of each piece: the open span with the latest start
        (the shorter of two that start together); ``outside`` where none
        is open."""
        starts = sorted(spans)
        part = np.full(len(self.edges) - 1, PARTS.index("outside"),
                       np.int64)
        heap, k = [], 0
        for i, t in enumerate(self.edges[:-1]):
            while k < len(starts) and starts[k][0] <= t:
                s, e, p = starts[k]
                heapq.heappush(heap, (-s, e, p))
                k += 1
            while heap and heap[0][1] <= t:
                heapq.heappop(heap)
            if heap:
                part[i] = heap[0][2]
        return part

    def _idle_in_pieces(self, gaps) -> np.ndarray:
        r"""Idle ns of each piece: the idle time up to each edge (the gaps
        are sorted and apart), differenced."""
        g = np.asarray(sorted(gaps), np.int64).reshape(-1, 2)
        a, b = g[:, 0], g[:, 1]
        j = np.searchsorted(a, self.edges, side="right")  # gaps begun
        whole = np.concatenate(([0], np.cumsum(b - a)))[j]
        # the last gap begun may run on past the edge
        last = np.maximum(j - 1, 0)
        ahead = np.where(j > 0, np.maximum(b[last] - self.edges, 0), 0) \
            if len(a) else 0
        return np.diff(whole - ahead)

    def _launches_in_pieces(self, trace) -> np.ndarray:
        at = np.asarray([s for s, n in zip(trace.host_start,
                                           trace.host_name)
                         if n.startswith(LAUNCH)], np.int64)
        at = at[(at >= self.edges[0]) & (at < self.edges[-1])]
        piece = np.searchsorted(self.edges, at, side="right") - 1
        return np.bincount(piece, minlength=len(self.edges) - 1)


def spans(m) -> Optional[Spans]:
    r"""The run's :class:`Spans`, read once and kept on ``m``; None where
    the functions below have nothing to read."""
    t = m.trace
    if t is None or not m.calls or t.window_s <= 0 or len(t.dev_start) == 0:
        return None
    if getattr(m, "layer_spans", None) is None:
        m.layer_spans = Spans(t)
    return m.layer_spans if m.layer_spans.found else None


def idle_pct(m, part: str) -> Optional[float]:
    r"""The share of the window, %, in which the device was idle with
    ``part`` innermost on the host."""
    s = spans(m)
    if s is None:
        return None
    ns = int(s.idle[s.part == PARTS.index(part)].sum())
    return 100.0 * ns / (m.trace.stop_ns - m.trace.start_ns)


def launches_per_seq(m, part: Optional[str] = None) -> Optional[float]:
    r"""Host launches inside a layer span (of ``part``, or of any part but
    ``outside``), over the window's cascade calls."""
    s = spans(m)
    if s is None:
        return None
    keep = (s.part == PARTS.index(part) if part is not None
            else s.part != PARTS.index("outside"))
    return float(s.launches[keep].sum()) / len(m.calls)
