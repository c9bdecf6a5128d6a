r"""Share of the traced window's wall time in which nothing ran on the
device (``a3gc_tp.offline_seq``: it moves ``frames_per_s``)."""

from portbench.metric_math import idle_pct


def read(m):
    return idle_pct(m)
