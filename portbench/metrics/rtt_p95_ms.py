r"""95th percentile of the client-side round trip of every ``/v1/step``
request completed in the window."""

from portbench.metric_math import percentile


def read(m):
    return None if m.rtt_ms is None else percentile(m.rtt_ms, 95)
