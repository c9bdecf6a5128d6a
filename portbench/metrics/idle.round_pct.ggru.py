r"""``ggru_tp.offline_seq``: share of the traced window in which the device
was idle with ``a3gc.round`` (``ops/_common.py`` ``operand``) innermost on
the host (``span_math``)."""

from portbench.span_math import idle_pct


def read(m):
    return idle_pct(m, "round")
