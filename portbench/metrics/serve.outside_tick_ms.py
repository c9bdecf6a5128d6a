r"""What a round trip spends outside the window step: the mean client round
trip of a ``/v1/step`` request minus the mean tick (HTTP, the request's
decode and the reply's encode, the queue and the coalescing wait of the
batcher, the client)."""

from portbench.metric_math import mean_tick_ms


def read(m):
    tick = mean_tick_ms(m)
    if tick is None or m.rtt_ms is None or len(m.rtt_ms) == 0:
        return None
    return float(m.rtt_ms.mean()) - tick
