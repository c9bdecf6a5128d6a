r"""``gcn_lstm_roofline`` of a serving cell (it moves
``served_frames_per_s``): the work of the active slots' scans of each tick
over the device time of the kernels named ``gcn_lstm_kernel``."""

from portbench.metric_math import roofline_pct


def read(m):
    return roofline_pct(m, "gcn_lstm", r"\bgcn_lstm_kernel")
