r"""``device.idle_pct`` of a serving cell (it moves
``served_frames_per_s``)."""

from portbench.metric_math import idle_pct


def read(m):
    return idle_pct(m)
