r"""``transpose.offline_seq``: the frames of the sequences whose poses
reached the host, over the whole measured window. Apart from
``frames_per_s`` because this cell is host-bound (≈ 38 % of its window
idle on the card) and spreads ≈ 10× more from run to run: one bound for
both would hide a tenfold larger loss in the A3GC cell."""


def read(m):
    return m.frames / m.window_s if m.window_s > 0 else None
