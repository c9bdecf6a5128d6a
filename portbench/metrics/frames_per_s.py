r"""``a3gc_tp.offline_seq``: the frames of the sequences whose poses reached
the host, over the whole measured window."""


def read(m):
    return m.frames / m.window_s if m.window_s > 0 else None
