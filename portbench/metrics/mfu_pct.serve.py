r"""``mfu_pct`` of a serving cell (it moves ``served_frames_per_s``): the
frames the clients received."""

from portbench.metric_math import mfu_pct


def read(m):
    return mfu_pct(m)
