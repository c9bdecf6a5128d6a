r"""``ggru_tp.offline_seq``: share of the traced window in which the device
was idle with ``a3gc.rnn`` (``models/nets.py``, a G-GRU layer call)
innermost, its ``a3gc.round`` children apart on the host
(``span_math``)."""

from portbench.span_math import idle_pct


def read(m):
    return idle_pct(m, "rnn")
