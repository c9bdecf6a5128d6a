r"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test run holds: hidden
width 8, short sequences, a small pool, 3 clients of 3 slots of 6 frames."""

import os

import torch

from portbench import harness


# cells whose driver, mix and limits are in portbench/ but which
# BENCHMARK.json does not hold yet (PERF.md, Open questions)
HELD_BACK = [
    {"name": "transpose.serve_http8", "config": "transpose",
     "traffic": "serve_http8", "chips": 1},
    {"name": "a3gc_tp.serve_http8", "config": "a3gc_tp",
     "traffic": "serve_http8", "chips": 1}]


def bench():
    return harness._json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def cell(name: str, hidden: int = 8) -> harness.Cell:
    b = bench()
    b["workloads"] = b["workloads"] + HELD_BACK
    c = harness.Cell(b, name)
    for st in c.config["stages"]:
        for k in ("units_hidden", "n_hidden"):
            if k in st:
                st[k] = hidden
    t = c.traffic
    t["pool"] = {"sequences": 4, "frames": 600}
    if "lengths" in t:
        t["lengths"] = {"lo": 30, "hi": 120, "count": 4}
        t["sample"] = {"drawn": 3, "among": 6}
    if "windows_per_sequence" in t:
        t.update(window=6, clients=3, streams=3, client_cpus=0,
                 windows_per_sequence={"lo": 1, "hi": 4, "count": 4},
                 sample={"drawn": 1, "among": 2})
    return c


def measure(c, seed=2 ** 31 + 7, seconds=1.5, trace=False):
    import time
    return harness.measure(c, seed, seconds, trace, torch.device("cpu"),
                           time.monotonic())
