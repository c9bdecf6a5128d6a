r"""``mfu_pct`` of ``dip.offline_seq`` (it moves ``frames_per_s.transpose``):
every product of the DIP net for a frame (≈ 21.3 MFLOP) × the frames
delivered ÷ the window's seconds ÷ the peak of the configuration's
format."""

from portbench.metric_math import mfu_pct


def read(m):
    return mfu_pct(m)
