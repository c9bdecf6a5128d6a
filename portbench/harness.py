r"""One run of one cell of the port's benchmark.

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
harness finds everything else by those names:

* ``portbench/configs/<config>.json``: the configuration's sizes, its
  ``family`` (``portbench/families/<family>.py``: the weights' leaves in the
  port's layout, the port's objects built on them, the work of its
  products) and its ``reference`` (``portbench/reference/<name>.py``);
* ``portbench/traffic/<mix>.json``: the mix's parameters and its
  ``driver`` (``portbench/drivers/<driver>.py``);
* ``portbench/limits/<cell>.json``: the limits of the numbers compared
  with the reference;
* ``portbench/metrics/<metric>.py``: the reader of each metric.

A run: set-up (weights from the seed on the card, the program, the
traffic, warm-up of every shape the cell uses), the measured window, the
device's peak memory, the program stopped and freed, then the comparison
of the kept answers with the reference. The last line of standard output
is the result; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# the port's kernel libraries: built on a checkout's first run, loaded by
# their hashed names afterwards
BUILD_DIR = os.path.join(ROOT, "build", "portbench", "kernels")
FORBIDDEN = ("jax", "jaxlib", "flax", "a3gc_tpu")


def _json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    r"""One entry of ``workloads`` with everything it names."""

    def __init__(self, bench: dict, name: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                           f"{', '.join(by_name)}")
        entry = by_name[name]
        self.name, self.chips = name, int(entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        self.config = _json(os.path.join(ROOT, conf["file"]))
        self.traffic = _json(os.path.join(HERE, "traffic",
                                          entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(HERE, "limits", name + ".json"))
        self.family = importlib.import_module(
            "portbench.families." + self.config["family"])
        self.reference = importlib.import_module(
            "portbench.reference." + self.config["reference"])
        self.driver = importlib.import_module(
            "portbench.drivers." + self.traffic["driver"])
        self.stats_path = os.path.join(HERE, "stats", self.config["stats"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]

    def stats(self) -> dict:
        import numpy as np
        with np.load(self.stats_path) as z:
            return {k: z[k] for k in z.files}


def reader(metric: str):
    r"""The reader module of ``metric``: ``portbench/metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"),
        os.path.join(HERE, "metrics", metric + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    r"""Top-level names of ``modules`` (default: ``sys.modules``) that the
    run must not hold, the part before the first dot compared whole."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card(cell: Cell):
    r"""The first card, or exit: no result without the cards the cell
    asks for."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is False: no "
                         "card, no result")
    if torch.cuda.device_count() < cell.chips:
        raise SystemExit(f"portbench: the cell needs {cell.chips} cards, "
                         f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float):
    r"""Set-up, window, comparison. Returns (measurement, result dict);
    the result's ``compared`` maps each number to (value, limit)."""
    import torch

    from portbench import check, work
    from portbench.trace import Tracer

    tracer = Tracer(trace, cuda=device.type == "cuda")
    t_run = time.monotonic()
    run = cell.driver.Run(cell, seed, device, tracer)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.monotonic() - t_start
        print(f"portbench: set-up {setup_s:.3f} s, of which the cell's "
              f"{time.monotonic() - t_run:.3f} s (weights, program, traffic, "
              "warm-up)", file=sys.stderr, flush=True)
        m = run.window(seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    finally:
        run.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    m.setup_s = setup_s
    m.config, m.family = cell.config, cell.family
    m.peak_flops = work.peak_flops(cell.config["precision"])
    m.trace = tracer.trace
    if m.trace is not None and tracer.bounds is not None:
        m.trace = _clipped(tracer, m.trace)
    answers = run.program_answers()
    values = check.numbers(answers, run.reference_answers("fp32"))
    correct = (check.passes(values, cell.limits) and m.failed == 0
               and bool(answers))
    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = reader(entry["name"]).read(m)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(m.attempted),
              "failed": int(m.failed), "metrics": metrics, "device": dev}
    if m.trace is not None:
        dev["busy_s"] = m.trace.busy_s
        dev["window_s"] = m.trace.window_s
        result["breakdown"] = {"device_ops": m.trace.device_ops(),
                               "idle_gaps": m.trace.idle_gaps()}
    result["compared"] = {k: {"value": values[k], "limit": cell.limits[k]}
                          for k in cell.limits}
    return m, result


def _clipped(tracer, trace):
    r"""The trace cut to the measured window (monotonic seconds → the
    profiler's wall-clock nanoseconds)."""
    from portbench.trace import Trace
    offset = time.time_ns() - time.monotonic_ns()
    t_open, t_close = tracer.bounds
    return Trace(int(t_open * 1e9) + offset, int(t_close * 1e9) + offset,
                 (trace.dev_start, trace.dev_end, trace.dev_name),
                 (trace.host_start, trace.host_end, trace.host_name))


def parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="portbench/run.py",
        description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start=None, device=None) -> int:
    r"""The command. ``device`` (tests only) skips the look for a card and
    runs there."""
    t_start = time.monotonic() if t_start is None else t_start
    args = parse(argv)
    os.environ["A3GC_TORCH_BUILD_DIR"] = BUILD_DIR
    try:
        bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
        cell = Cell(bench, args.workload)
        import a3gc_tpu_torch
        where = os.path.dirname(os.path.abspath(a3gc_tpu_torch.__file__))
        if os.path.dirname(where) != ROOT:
            raise SystemExit(f"portbench: a3gc_tpu_torch imported from "
                             f"{where}, not from this checkout")
        if device is None:
            device = card(cell)
        m, result = measure(cell, args.seed, args.seconds,
                            bool(args.trace), device, t_start)
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run imported {', '.join(bad)}; no result",
              file=sys.stderr)
        return 2
    if getattr(m, "errors", None):
        print("portbench: request errors: " + " | ".join(m.errors),
              file=sys.stderr)
    if device.type == "cuda":
        print("portbench: card " + _power_limit(), file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
