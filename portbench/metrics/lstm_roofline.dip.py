r"""``dip.offline_seq`` (it moves ``frames_per_s.transpose``): share of its
roofline that ``ops/csrc/lstm.cu``'s cooperative plan (P = 32 at H = 512)
reached: the least time of the DIP net's two biLSTM scans that the
window's inputs needed (``work.lstm_layer_work`` of each layer call, F =
512 then 1,024) over the device time of the kernels named
``lstm_kernel``."""

from portbench.metric_math import roofline_pct


def read(m):
    return roofline_pct(m, "lstm", r"\blstm_kernel")
