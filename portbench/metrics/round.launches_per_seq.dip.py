r"""``dip.offline_seq`` (it moves ``frames_per_s.transpose``): host launch
calls (``cudaLaunch*``, ``cuLaunch*``) made inside ``a3gc.round``
(``ops/_common.py`` ``operand``: the TF32 rounding of the activations, and
of a weight on a cache miss), over the sequences of the window
(``span_math``)."""

from portbench.span_math import launches_per_seq


def read(m):
    return launches_per_seq(m, "round")
