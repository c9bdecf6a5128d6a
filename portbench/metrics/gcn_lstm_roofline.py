r"""Share of its roofline that ``ops/csrc/gcn_lstm.cu`` reached: the least
time of the graph-LSTM scans that the window's inputs needed (``work.
layer_work`` of each layer call, the card's peaks) over the device time of
the kernels named ``gcn_lstm_kernel``."""

from portbench.metric_math import roofline_pct


def read(m):
    return roofline_pct(m, "gcn_lstm", r"\bgcn_lstm_kernel")
