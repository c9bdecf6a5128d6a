r"""Median client-side round trip of every ``/v1/step`` request completed in
the window (acquire and release requests are not windows and stay out)."""

from portbench.metric_math import percentile


def read(m):
    return None if m.rtt_ms is None else percentile(m.rtt_ms, 50)
