r"""``mfu_pct`` of ``ggru_tp.offline_seq``: every product of the G-GRU
cascade's three stages for a frame × the frames delivered ÷ the window's
seconds ÷ the peak of the configuration's format."""

from portbench.metric_math import mfu_pct


def read(m):
    return mfu_pct(m)
