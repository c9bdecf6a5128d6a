#!/usr/bin/env python3
r"""Where a frame of the port's weight-stationary scan kernels
(``gcn_lstm.cu``, ``ggru.cu``, ``lstm.cu``) goes, on one CUDA card: builds
them with ``-DSCAN_PHASE_CLOCK`` (``csrc/scan_common.cuh`` ``PhaseClock``),
runs one launch per layer shape of the serving paths (S = 8) and the batch-1
path (S = 1), T = 60, every frame valid, and prints the SM cycles that
thread 0 of CTA (0, 0, 0) spent per frame in each phase (per launch for the
phases before and after the frames), barrier waits included, beside the
launch's time (CUDA events, the instrumented build). ``--tf32`` runs
the TF32 instantiations instead (a net's precision="default" on the card:
all three on the tensor cores), ``--tf32 --fma`` their FMA path (what a
shape without a tensor-core plan takes), forced by plan; ``--lstm_P``
forces ``lstm``'s split (its plans at another P; a width without a plan
there is skipped).

    python3 scripts/torch_kernel_phases.py [--kernels ggru,lstm]
                                           [--tf32 [--fma]] [--lstm_P P]
                                           [--out FILE]

One JSON line per shape, then the card's name and power limit. The marks
cost a few cycles each; the shipped build has none. Imports nothing of JAX
or of the JAX package.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 24
ONCE = (16, 17, 21)       # slots marked once per launch, not per frame
PHASES = {
    "gcn_lstm": {16: "init", 0: "wait u, sync", 1: "masked frame",
                 2: "h.W_h", 3: "s.u wait, sigma(a), sync",
                 20: "u + scale (mma: z staged)", 4: "graph mix", 5: "sync",
                 6: "cell", 7: "sync", 8: "hy push",
                 18: "own sum_nodes hy, partial q, push",
                 9: "hy + partial q wait (barrier without attention)",
                 15: "previous y", 19: "q = relu(sum of partials)",
                 10: "hy.Wh", 11: "sync", 12: "q.Wq, s", 13: "sync",
                 14: "s.u partials, push",
                 22: "tf32: s.u wait, sigma(a)",
                 23: "tf32: h = hy + hy.sigma(a), y, round, sync",
                 17: "final state"},
    "ggru": {16: "init", 21: "G.W_hid slice (tf32: weights staged)",
             6: "exchange wait, sync",
             10: "tf32: h.G, store (mma: h.G, mix, msg push)",
             11: "tf32: sync, msg mix, push", 12: "tf32: msg wait, sync",
             3: "gate product", 9: "gate k-slice sum, store",
             4: "wait zi, sync", 5: "cell", 7: "carried frame",
             1: "sync, graph mix, push", 17: "final state"},
    "lstm": {21: "init: A fragments (mma)", 16: "init", 0: "frame check",
             1: "skipped frame",
             2: "h wait (cooperative: from L2; mma cluster: st.async)",
             3: "h.W_hh", 4: "wait u, sync",
             5: "cell (mma cluster: and st.async h push)", 6: "sync",
             7: "prefetch u", 8: "h push (DSMEM)",
             9: "cluster barrier / release", 17: "final state"},
}


def build(name):
    """nvcc ``csrc/<name>.cu`` with the phase clock into build/."""
    from a3gc_tpu_torch.ops._build import (_CSRC, BUILD_DIR, NVCC_FLAGS,
                                           _nvcc)
    out_dir = os.path.join(os.path.dirname(BUILD_DIR), "kernels_phase")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{name}_phase.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-DSCAN_PHASE_CLOCK", "-o",
                           out, os.path.join(_CSRC, name + ".cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    n_ptr, n_int = {"lstm": (10, 13), "ggru": (8, 10),
                    "gcn_lstm": (16, 13)}[name]
    fn = getattr(lib, f"{name}_forward")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    cyc = getattr(lib, f"{name}_phase_cycles")
    cyc.argtypes = [ctypes.c_void_p]
    cyc.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--kernels", default="gcn_lstm,ggru,lstm",
                    help="comma-separated kernels to run (default: all)")
    ap.add_argument("--tf32", action="store_true",
                    help="run the TF32 instantiations")
    ap.add_argument("--fma", action="store_true",
                    help="with --tf32: the kernels' FMA path")
    ap.add_argument("--lstm_P", type=int,
                    help="lstm's split P (default: its launch plan's)")
    args = ap.parse_args()
    wanted = args.kernels.split(",")
    fmt = "tf32" if args.tf32 else "fp32"
    if args.fma and not args.tf32:
        ap.error("--fma needs --tf32")
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    from a3gc_tpu_torch.ops._common import sm_count
    smoke = CS.Smoke()
    with ThreadPoolExecutor(3) as pool:
        libs = dict(zip(CS.LIBRARIES, pool.map(build, CS.LIBRARIES)))
    G._library = lambda: libs["gcn_lstm"]        # the instrumented builds
    GG._library = lambda: libs["ggru"]
    LS._library = lambda: libs["lstm"]

    def cycles(name):
        buf = (ctypes.c_ulonglong * SLOTS)()
        err = getattr(libs[name], f"{name}_phase_cycles")(buf)
        if err:
            raise RuntimeError(f"{name}_phase_cycles failed ({err})")
        return list(buf)

    gen = torch.Generator().manual_seed(10)
    T = CS.WINDOW
    shapes = [("gcn_lstm", H, cell) for H, _, _, _ in CS.STAGES
              for cell in ("a3gc", "aagc")]
    shapes += [("ggru", H, None) for H, _, _, _ in CS.STAGES]
    shapes += [("lstm", H, None) for H, _, _, _ in CS.TP_STAGES]
    shapes.append(("lstm", CS.DIP[0], None))
    lines = []
    for S in (CS.S_SERVE, 1):
        for name, H, cell in shapes:
            if name not in wanted:
                continue
            if name == "gcn_lstm":
                mod, p = G, smoke.cell(gen, cell, H, H)
                x, st, nv = smoke.layer_inputs(gen, S, T, H, H, [T] * S)
            elif name == "ggru":
                mod, p = GG, smoke.cell(gen, "ggru", H, H)
                x, st, nv = smoke.layer_inputs(gen, S, T, H, H, [T] * S,
                                               n_state=1)
                cell = "C=%d" % GG.launch_plan(S, CS.N_NODES, H,
                                               tf32=args.tf32).C
            else:
                mod, p = LS, smoke.lstm_layer(gen, H, H)
                x, st, nv = smoke.layer_inputs(gen, S, T, H, H, [T] * S,
                                               nodes=False)
            plan = None
            if args.tf32 and name == "gcn_lstm":
                plan = G.launch_plan(CS.N_NODES, H, cell == "a3gc",
                                     tf32=True, mma=not args.fma, S=S)
            elif args.tf32 and name == "ggru":
                plan = GG.launch_plan(S, CS.N_NODES, H, tf32=True,
                                      mma=0 if args.fma else None)
            elif name == "lstm" and (args.tf32 or args.lstm_P):
                try:
                    plan = LS.launch_plan(S, H, sm_count(0), P=args.lstm_P,
                                          tf32=args.tf32,
                                          mma=False if args.fma else None)
                except ValueError:        # no plan at the forced split
                    continue
            with torch.no_grad():
                sargs = mod.scan_inputs(p, x, st, nv, fmt)
                mod.scan(*sargs, plan=plan, tf32=args.tf32)
                torch.cuda.synchronize()
                cycles(name)                      # zero the slots
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                mod.scan(*sargs, plan=plan, tf32=args.tf32)
                end.record()
                torch.cuda.synchronize()
            got = cycles(name)
            total = sum(got)
            ms = start.elapsed_time(end)
            line = {"kernel": name, "cell": cell, "format": fmt, "S": S,
                    "H": H, "T": T,
                    "plan": plan._asdict() if plan is not None else None,
                    "ms": ms, "cycles_total": total,
                    "ns_per_cycle": ms * 1e6 / total if total else None,
                    "cycles_per_frame": {
                        label: got[i] / (1 if i in ONCE else T)
                        for i, label in PHASES[name].items() if got[i]}}
            lines.append(line)
            print(json.dumps(line), flush=True)
    card = CS.nvidia_smi()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
            f.write(json.dumps({"card": card}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
