r"""``ggru_tp.offline_seq`` (it moves the cell's frames-per-second metric):
share of its roofline that ``ops/csrc/ggru.cu`` reached: the least time of
the G-GRU scans that the window's inputs needed (``families/ggru.py``
``ggru_layer_work`` of each layer call, the card's peaks) over the device
time of the kernels named ``ggru_kernel``."""

from portbench.metric_math import roofline_pct


def read(m):
    return roofline_pct(m, "ggru", r"\bggru_kernel")
