r"""The device trace of a traced run (``--trace 1``): ``torch.profiler`` over
the measured window, every thread of the process (the server's batcher
steps the card from its own thread), read into the numbers the per-layer
metrics take.

* busy seconds: the union of the device's activity intervals (kernels,
  copies, sets; not the device-side copies of host annotations), so that
  work on two streams at once counts once;
* a kernel's seconds: the sum of its launches' durations, by a pattern on
  its name;
* the breakdown: the device operations that took the most time, and the
  longest idle gaps named by the innermost host operation running at the
  gap's middle.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Optional

import numpy as np

TOP = 10


class Trace:
    r"""What a traced window holds. ``start_ns`` / ``stop_ns``: the window
    on the profiler's clock (wall time); ``device``: (start, end, name)
    arrays of device activity; ``host``: the same of host operations."""

    def __init__(self, start_ns, stop_ns, device, host):
        self.start_ns, self.stop_ns = start_ns, stop_ns
        self.dev_start, self.dev_end, self.dev_name = device
        self.host_start, self.host_end, self.host_name = host
        self.window_s = (stop_ns - start_ns) / 1e9
        self._gaps = None
        self.busy_s = self._union()

    def _union(self) -> float:
        s = np.clip(self.dev_start, self.start_ns, self.stop_ns)
        e = np.clip(self.dev_end, self.start_ns, self.stop_ns)
        if s.size == 0:
            self._gaps = [(self.start_ns, self.stop_ns)]
            return 0.0
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        reach = np.maximum.accumulate(e)
        # a gap opens where an interval starts after everything before it
        gap_at = np.nonzero(s[1:] > reach[:-1])[0]
        gaps = [(int(reach[i]), int(s[i + 1])) for i in gap_at]
        gaps = [(self.start_ns, int(s[0]))] + gaps \
            + [(int(reach[-1]), self.stop_ns)]
        self._gaps = [(a, b) for a, b in gaps if b > a]
        idle = sum(b - a for a, b in self._gaps)
        return (self.stop_ns - self.start_ns - idle) / 1e9

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        keep = np.fromiter((bool(rx.search(n)) for n in self.dev_name),
                           bool, len(self.dev_name))
        return float((self.dev_end[keep] - self.dev_start[keep]).sum()) / 1e9

    def device_ops(self):
        r"""[[name, seconds]] of the device operations that took most
        time, largest first."""
        total = {}
        for n, d in zip(self.dev_name, self.dev_end - self.dev_start):
            total[n] = total.get(n, 0) + int(d)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], d / 1e9] for n, d in top]

    def idle_gaps(self):
        r"""[[what the host was doing, seconds]] of the longest idle gaps,
        longest first."""
        out = []
        for a, b in sorted(self._gaps, key=lambda g: g[0] - g[1])[:TOP]:
            mid = (a + b) // 2
            on = np.nonzero((self.host_start <= mid)
                            & (self.host_end >= mid))[0]
            if on.size:
                inner = on[np.argmin(self.host_end[on]
                                     - self.host_start[on])]
                what = self.host_name[inner][:160]
            else:
                what = "no host operation (Python between operations)"
            out.append([what, (b - a) / 1e9])
        return out


def _events(prof):
    r"""(device, host) arrays from the profiler's raw events."""
    from torch.autograd import DeviceType
    dev, host = ([], [], []), ([], [], [])
    for ev in prof.profiler.kineto_results.events():
        kind = ev.device_type()
        if kind == DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            out = dev
        elif kind == DeviceType.CPU:
            out = host
        else:
            continue
        start = ev.start_ns()
        out[0].append(start)
        out[1].append(start + ev.duration_ns())
        out[2].append(ev.name())
    as_arrays = (lambda t: (np.asarray(t[0], np.int64),
                            np.asarray(t[1], np.int64), t[2]))
    return as_arrays(dev), as_arrays(host)


class Tracer:
    r"""``with tracer.window():`` profiles the block when ``on``; then
    ``tracer.trace`` holds its :class:`Trace` (else None)."""

    def __init__(self, on: bool, cuda: bool = True):
        self.on, self.cuda = on, cuda
        self.trace: Optional[Trace] = None
        self.bounds = None      # the measured window, monotonic seconds

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        prof = profile(activities=acts,
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
        prof.start()
        start = time.time_ns()
        try:
            yield
        finally:
            stop = time.time_ns()
            prof.stop()
        dev, host = _events(prof)
        self.trace = Trace(start, stop, dev, host)
