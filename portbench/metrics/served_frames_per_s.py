r"""Serving: the pose frames in the replies that clients received, over the
whole measured window (from its opening to the last answer)."""


def read(m):
    return m.frames / m.window_s if m.window_s > 0 else None
