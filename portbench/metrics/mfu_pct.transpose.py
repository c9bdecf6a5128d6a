r"""``mfu_pct`` of ``transpose.offline_seq`` (it moves
``frames_per_s.transpose``)."""

from portbench.metric_math import mfu_pct


def read(m):
    return mfu_pct(m)
