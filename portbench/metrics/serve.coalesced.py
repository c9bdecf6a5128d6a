r"""Requests a batcher tick served over the window: Δ``requests`` /
Δ``ticks`` of the server's ``/v1/stats`` counters, read at the window's
opening and after its close (its ``mean_coalesced`` covers only the last
1,024 ticks)."""


def read(m):
    if m.stats0 is None or m.stats1 is None:
        return None
    ticks = m.stats1["ticks"] - m.stats0["ticks"]
    if ticks <= 0:
        return None
    return (m.stats1["requests"] - m.stats0["requests"]) / ticks
