r"""``a3gc_tp.offline_seq`` (it moves ``frames_per_s``): host launch calls
(``cudaLaunch*``, ``cuLaunch*``) made inside ``a3gc.round``
(``ops/_common.py`` ``operand``: the per-call TF32 rounding), over the
sequences of the window (``span_math``)."""

from portbench.span_math import launches_per_seq


def read(m):
    return launches_per_seq(m, "round")
