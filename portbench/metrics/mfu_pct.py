r"""Model FLOP utilisation of the whole step (``a3gc_tp.offline_seq``: it
moves ``frames_per_s``): every product of the three stages for a frame
(counted from the configuration's widths) × the frames delivered ÷ the
window's seconds ÷ the peak of the configuration's format (TF32:
495e12 FLOP/s)."""

from portbench.metric_math import mfu_pct


def read(m):
    return mfu_pct(m)
