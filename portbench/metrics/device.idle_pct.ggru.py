r"""``device.idle_pct`` of ``ggru_tp.offline_seq``."""

from portbench.metric_math import idle_pct


def read(m):
    return idle_pct(m)
