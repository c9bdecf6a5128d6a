r"""``device.idle_pct`` of ``dip.offline_seq`` (it moves
``frames_per_s.transpose``)."""

from portbench.metric_math import idle_pct


def read(m):
    return idle_pct(m)
