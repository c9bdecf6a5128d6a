r"""Mean wall time of the window step: the benchmark's own span around each
``step`` of the session it hands to ``PoseServer(session=)`` (normalise →
three stages → IK → the poses on the host), over every tick in the
window."""

from portbench.metric_math import mean_tick_ms


def read(m):
    return mean_tick_ms(m)
