r"""``dip.offline_seq`` (it moves ``frames_per_s.transpose``): share of the
traced window in which the device was idle with ``a3gc.round``
(``ops/_common.py`` ``operand``) innermost on the host (``span_math``). The
six parts sum to ``device.idle_pct.dip``."""

from portbench.span_math import idle_pct


def read(m):
    return idle_pct(m, "round")
