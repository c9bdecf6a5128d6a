#!/usr/bin/env python3
r"""A/B of the port's weight-stationary scan kernels (``gcn_lstm.cu``,
``ggru.cu``, ``lstm.cu`` in ``a3gc_tpu_torch/ops/csrc``) on one CUDA card,
in one process, timed in turns with CUDA events:

  * against an earlier design of the same kernels, built from a directory
    of sources (``--old``) that export the single-CTA C interfaces
    ``lstm_forward(u, whh, h0, c0, n_valid, y, h_out, c_out, S, T, H,
    stream)``, ``gcn_lstm_forward(<16 pointers>, S, T, N, H, attention,
    stream)`` and ``ggru_forward(zi, G, adj, W_hid, h0, n_valid, y, h_out,
    S, T, N, H, stream)`` — one CTA per (stream block, direction), the
    recurrent weights read from L2 every frame;
  * the default split of the hidden units (P CTAs for ``lstm``, a cluster
    of C for ``gcn_lstm`` and ``ggru``) against twice that split, or half
    of it where twice is no plan.

Shapes: the recurrent layers of the serving paths (S = 8) and of the
batch-1 path (S = 1), T = 60: ``gcn_lstm`` at the A3GC stage widths
(a3gc cell, H = 256 / 64 / 128), ``ggru`` at the same widths, ``lstm`` at
the TransPose widths and the DIP width (H = 256 / 64 / 128 / 512). The
kernel's time does not depend on the input width F (its input projection
is hoisted), so one shape stands for both layers of a stage; a window's
sum counts each twice.

    python3 scripts/torch_kernel_ab.py --old DIR [--kernels ggru] [--out FILE]

Each shape prints one JSON line (times in ms per launch, the largest
difference between the two designs' outputs, the plans and how many of
their groups the card holds at once), then one summary line per kernel
(sums over a serving window at S = 8) and the card's name and power limit.
Imports nothing of JAX or of the JAX package. Exits non-zero without a card
or if the two designs disagree by more than 1e-5.

``--tf32`` instead times the TF32 plans of each kernel of ``--kernels``
that has several (``lstm``, ``gcn_lstm``) against each other. ``lstm``, in
turns: the FMA form at the fp32 plan's P (``mma`` = 0), the tensor-core
form (``mma`` = 1) at each candidate P of the dense serving widths
(TF32_CANDIDATES), the default TF32 plan and the fp32 kernel, at H = 256 /
64 / 128 / 512, S = 8 and 1, D = 2 and 1, T = 60; with ``--shapes all``
also the default plan against the FMA form at T = 120 (H = 512, S = 8), S =
16, T = 1024 and S = 1, T = 2048, beside the plain version at "tf32" and
cuDNN's ``torch.nn.LSTM`` with TF32 allowed (a yardstick of time only).
Each shape prints one JSON line: per plan its ms as chip_smoke.py times a
call (CUDA events around back-to-back calls: the host's time a call shows
where it exceeds the kernel's) and its device ms (the card kept busy while
the host enqueues the calls), max|d| from the plain scan at "tf32", rms
ratio to the gap between the plain scan's formats, registers and local
memory. Exits non-zero if a plan is off the plain
version by more than 8.05e-3 (chip_smoke.py PREC_KERNEL_TOL).

``gcn_lstm``, in turns: the tensor-core form at each cluster size C that
its plan allows at the A3GC stage widths (GCN_CANDIDATES: H = 256 / 64 /
128), one stream (S = 1, where the grid leaves most SMs idle), T = 60 and
2048, the a3gc and the aagc cell; per C its ms, device ms, max|d| and rms
ratio as for ``lstm``, and how many of its clusters the card holds at once;
the plan ``launch_plan`` chooses at S = 1 is marked ``default``, and the
layer call at that plan (``wrapper_ms``: the hoisted input projection
too) and the plain scan at "tf32" (``plain_ms``, one call) are timed. Exits
non-zero if a plan is off the plain version by more than 8.05e-3.

    python3 scripts/torch_kernel_ab.py --tf32 [--kernels lstm,gcn_lstm]
                                       [--shapes serving|all] [--reps N]
                                       [--out FILE]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
# the P to time the tensor-core form at, per dense serving width
TF32_CANDIDATES = {64: (2, 4, 8), 128: (8, 16), 256: (8, 16), 512: (32,)}
# the cluster sizes to time gcn_lstm's tensor-core form at (those with a
# tensor-core plan: 64 or 128 gate columns a CTA)
GCN_CANDIDATES = {64: (2, 4), 128: (4, 8), 256: (8, 16)}


def build_old(src_dir, name):
    """nvcc the earlier design's ``<name>.cu`` with the port's flags and
    bind its ``<name>_forward``."""
    from a3gc_tpu_torch.ops._build import BUILD_DIR, NVCC_FLAGS, _nvcc
    out_dir = os.path.join(os.path.dirname(BUILD_DIR), "kernels_ab")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{name}_old.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", out,
                           os.path.join(src_dir, name + ".cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    fn = getattr(lib, f"{name}_forward")
    n_ptr, n_int = {"lstm": (8, 3), "ggru": (8, 4), "gcn_lstm": (16, 5)}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def old_scan(torch, name, fn, args):
    """The earlier design on the arguments of the current ``scan``."""
    if name == "lstm":
        u, w_hh, h0, c0, nv = args
        _, S, T, G = u.shape
        H = G // 4
        y = torch.empty((S, T, 2 * H), device=u.device)
        ptrs = [u, w_hh, h0, c0, nv]
        ints = [S, T, H]
    elif name == "ggru":
        zi, gk, adj, w_hid, h0, nv = args
        _, S, T, N, G3 = zi.shape
        H = G3 // 3
        y = torch.empty((S, T, N, 2 * H), device=zi.device)
        h_out = torch.empty_like(h0)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[t.data_ptr() for t in (zi, gk, adj, w_hid, h0, nv, y,
                                          h_out)], S, T, N, H, stream)
        if err:
            raise RuntimeError(f"earlier ggru kernel: launch failed ({err})")
        return y, h_out
    else:
        u, wh, adj, bias, att, h0, c0, nv = args
        _, S, T, N, G = u.shape
        H = G // 4
        y = torch.empty((S, T, N, 2 * H), device=u.device)
        ptrs = [u, wh, adj, bias, *(att or [None] * 6), h0, c0, nv]
        ints = [S, T, N, H, int(att is not None)]
    h_out, c_out = torch.empty_like(h0), torch.empty_like(c0)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*[None if t is None else t.data_ptr() for t in ptrs],
             y.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), *ints, stream)
    if err:
        raise RuntimeError(f"earlier {name} kernel: launch failed ({err})")
    return y, h_out, c_out


def device_ms(torch, fn, reps, warmup=2):
    """Mean device time of fn() in ms over reps calls, the card kept busy
    (torch.cuda._sleep) while the host enqueues them, so that the host's
    time a call (Python, checks, allocation, the launch) does not show."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e5) * reps + int(1e6))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tf32_ab(args):
    """``--tf32`` for ``lstm``: its TF32 plans against each other (see the
    module docstring); returns (JSON lines, whether every plan is within
    PREC_KERNEL_TOL)."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from a3gc_tpu_torch.ops import lstm as LS
    from a3gc_tpu_torch.ops._build import load_library
    from a3gc_tpu_torch.ops._common import sm_count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = CS.Smoke()
    load_library("lstm")
    sms = sm_count(0)
    gen = torch.Generator().manual_seed(17)
    widths = [h for h, _, _, _ in CS.TP_STAGES] + [CS.DIP[0]]
    shapes = [(H, S, D, CS.WINDOW, True) for S in (CS.S_SERVE, 1)
              for H in widths for D in (2, 1)]
    if args.shapes == "all":
        shapes.append((CS.DIP[0], CS.S_SERVE, 2, 120, False))
        shapes += [(H, S, 2, T, False) for S, T in CS.EVAL_TIMED_SHAPES
                   for H in widths]
    lines, ok = [], True
    for H, S, D, T, candidates in shapes:
        p = smoke.lstm_layer(gen, H, H, D=D)
        x, st, nv = smoke.layer_inputs(gen, S, T, H, H, [T] * S,
                                       nodes=False, D=D)
        plans = {"fp32": (LS.launch_plan(S, H, sms, D=D), False),
                 "tf32_fma": (LS.launch_plan(S, H, sms, D=D, tf32=True,
                                             mma=False), True),
                 "tf32": (LS.launch_plan(S, H, sms, D=D, tf32=True), True)}
        refused = {}
        for P in TF32_CANDIDATES[H] if candidates else ():
            try:
                plans[f"tf32_mma_P{P}"] = (LS.launch_plan(
                    S, H, sms, P=P, D=D, tf32=True, mma=True), True)
            except ValueError as e:
                refused[f"tf32_mma_P{P}"] = str(e)
        with torch.no_grad():
            sargs = LS.scan_inputs(p, x, st, nv, "tf32")
            want = LS.scan_reference(*sargs, tf32=True)
            gap = rms(LS.scan_reference(*sargs, tf32=False), want)
            got = {k: LS.scan(*sargs, plan=pl, tf32=tf32)
                   for k, (pl, tf32) in plans.items()}
            torch.cuda.synchronize()
            calls = {k: (lambda pl=pl, tf32=tf32: LS.scan(
                *sargs, plan=pl, tf32=tf32)) for k, (pl, tf32)
                in plans.items()}
            reps = args.reps if T <= CS.WINDOW * 2 else max(2, args.reps // 5)
            times = dict.fromkeys(calls, 0.0)
            busy = dict.fromkeys(calls, 0.0)
            for k in list(calls) + list(reversed(calls)):
                times[k] += CS.cuda_ms(calls[k], reps) / 2
                busy[k] += device_ms(torch, calls[k], reps) / 2
            line = {"kernel": "lstm", "H": H, "S": S, "D": D, "T": T,
                    "ms": times, "device_ms": busy, "refused": refused,
                    "plans": {}}
            for k, (pl, tf32) in plans.items():
                err = max(float((a - b).abs().max())
                          for a, b in zip(got[k], want))
                fine = all(bool(torch.isfinite(t).all()) for t in got[k])
                if k != "fp32":
                    ok &= fine and err <= CS.PREC_KERNEL_TOL
                line["plans"][k] = {
                    "plan": pl._asdict(), "max_abs_err": err,
                    "rms_ratio": rms(got[k], want) / gap, "finite": fine,
                    "attributes": LS.func_attributes(pl, H, tf32)}
            line["rms_gap"] = gap
            line["mma_over_fma"] = {k: busy[k] / busy["tf32_fma"]
                                    for k in busy if "mma" in k
                                    or k == "tf32"}
            if not candidates:
                plain = lambda: LS.bi_lstm_reference(p, x, st, nv,
                                                     fmt="tf32")
                line["plain_ms"] = CS.cuda_ms(plain, 1, warmup=0)
                cudnn = smoke.cudnn_lstm(p, x, st, tf32=True)
                line["cudnn_tf32_ms"] = CS.cuda_ms(cudnn, reps)
                line["cudnn_tf32_device_ms"] = device_ms(torch, cudnn, reps)
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines, ok


def write_lines(args, lines):
    """Print the card's name and power limit; with ``--out``, write the
    JSON lines and the card there."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    card = CS.nvidia_smi()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
            f.write(json.dumps({"card": card}) + "\n")


def rms(a, b):
    """Root mean square of a - b over lists of tensors, in float64."""
    num = sum(float((x.double() - y.double()).square().sum())
              for x, y in zip(a, b))
    return (num / sum(x.numel() for x in a)) ** 0.5


def gcn_tf32_ab(args):
    """``--tf32`` for ``gcn_lstm``: its tensor-core plans at each cluster
    size against each other at S = 1 (see the module docstring); returns
    (JSON lines, whether every plan is within PREC_KERNEL_TOL)."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops._build import load_library
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = CS.Smoke()
    load_library("gcn_lstm")
    gen = torch.Generator().manual_seed(21)
    S, N = 1, CS.N_NODES
    lines, ok = [], True
    for cell in ("a3gc", "aagc"):
        att = cell == "a3gc"
        for T in (CS.WINDOW, CS.PREC_T):
            for H, _, _, _ in CS.STAGES:
                p = smoke.cell(gen, cell, H, H)
                x, st, nv = smoke.layer_inputs(gen, S, T, H, H, [T] * S)
                plans = {f"C{c}": G.launch_plan(N, H, att, C=c, tf32=True,
                                                mma=True)
                         for c in GCN_CANDIDATES[H]}
                default = G.launch_plan(N, H, att, tf32=True, S=S)
                with torch.no_grad():
                    sargs = G.scan_inputs(p, x, st, nv, "tf32")
                    want = G.scan_reference(*sargs, tf32=True)
                    gap = rms(G.scan_reference(*sargs, tf32=False), want)
                    got = {k: G.scan(*sargs, plan=pl, tf32=True)
                           for k, pl in plans.items()}
                    torch.cuda.synchronize()
                    calls = {k: (lambda pl=pl: G.scan(*sargs, plan=pl,
                                                      tf32=True))
                             for k, pl in plans.items()}
                    reps = args.reps if T <= 2 * CS.WINDOW else 4
                    times = dict.fromkeys(calls, 0.0)
                    busy = dict.fromkeys(calls, 0.0)
                    for k in (list(calls) + list(reversed(calls))) * 2:
                        times[k] += CS.cuda_ms(calls[k], reps) / 4
                        busy[k] += device_ms(torch, calls[k], reps) / 4
                    wrapper = lambda: G.bi_gcn_lstm(p, x, st, nv, "tf32")
                    line = {"kernel": "gcn_lstm", "cell": cell, "H": H,
                            "S": S, "T": T, "default": f"C{default.C}",
                            "ms": times, "device_ms": busy,
                            "wrapper_ms": CS.cuda_ms(wrapper, reps),
                            "plain_ms": CS.cuda_ms(lambda: G.scan_reference(
                                *sargs, tf32=True), 1, warmup=0),
                            "rms_gap": gap, "plans": {}}
                for k, pl in plans.items():
                    err = max(float((a - b).abs().max())
                              for a, b in zip(got[k], want))
                    fine = all(bool(torch.isfinite(t).all()) for t in got[k])
                    ok &= fine and err <= CS.PREC_KERNEL_TOL
                    line["plans"][k] = {
                        "plan": pl._asdict(), "max_abs_err": err,
                        "rms_ratio": rms(got[k], want) / gap, "finite": fine,
                        "max_active": G.max_active(pl, S, N, H, att,
                                                   tf32=True)}
                lines.append(line)
                print(json.dumps(line), flush=True)
    return lines, ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old",
                    help="directory with the earlier <kernel>.cu of every "
                    "kernel asked for")
    ap.add_argument("--tf32", action="store_true",
                    help="time the TF32 plans of lstm and gcn_lstm "
                    "(those of --kernels) against each other")
    ap.add_argument("--shapes", choices=("serving", "all"), default="all",
                    help="with --tf32: the serving shapes only, or also "
                    "T = 120 and the evaluation lengths")
    ap.add_argument("--reps", type=int, default=20,
                    help="with --tf32: timed launches a plan and turn")
    ap.add_argument("--kernels", default="gcn_lstm,ggru,lstm",
                    help="comma-separated kernels to compare (default: all)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    if not args.tf32 and not args.old:
        ap.error("--old is required without --tf32")
    names = [n for n in ("gcn_lstm", "ggru", "lstm")
             if n in args.kernels.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.tf32:
        lines, ok = [], True
        for name, run in (("lstm", tf32_ab), ("gcn_lstm", gcn_tf32_ab)):
            if name in names:
                got, fine = run(args)
                lines += got
                ok &= fine
        write_lines(args, lines)
        return 0 if ok else 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    from a3gc_tpu_torch.ops._build import load_library
    from a3gc_tpu_torch.ops._common import sm_count
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = CS.Smoke()
    with ThreadPoolExecutor(6) as pool:
        old = {n: pool.submit(build_old, args.old, n) for n in names}
        new = [pool.submit(load_library, n) for n in names]
        old = {n: f.result() for n, f in old.items()}
        for f in new:
            f.result()

    lines, ok = [], True
    gen = torch.Generator().manual_seed(9)
    T, N = CS.WINDOW, CS.N_NODES
    shapes = [("gcn_lstm", H) for H, _, _, _ in CS.STAGES]
    shapes += [("ggru", H) for H, _, _, _ in CS.STAGES]
    shapes += [("lstm", H) for H, _, _, _ in CS.TP_STAGES]
    shapes.append(("lstm", CS.DIP[0]))
    shapes = [sh for sh in shapes if sh[0] in names]
    for S in (CS.S_SERVE, 1):
        for name, H in shapes:
            mod = {"gcn_lstm": G, "ggru": GG, "lstm": LS}[name]
            if name == "ggru":
                p = smoke.cell(gen, "ggru", H, H)
                x, st, nv = smoke.layer_inputs(gen, S, T, H, H, [T] * S,
                                               n_state=1)
                plan = GG.launch_plan(S, N, H)
                split = {"C": plan.C}
                plan2 = None
                for c2 in (2 * plan.C, plan.C // 2):
                    try:
                        plan2 = GG.launch_plan(S, N, H, C=c2)
                        break
                    except ValueError:
                        pass
                active = lambda pl: GG.max_active(pl, S, N, H)
            elif name == "gcn_lstm":
                p = smoke.cell(gen, "a3gc", H, H)
                x, st, nv = smoke.layer_inputs(gen, S, T, H, H, [T] * S)
                plan = G.launch_plan(N, H, True)
                split = {"C": plan.C}
                try:
                    plan2 = G.launch_plan(N, H, True, C=2 * plan.C)
                except ValueError:
                    plan2 = None
                active = lambda pl: G.max_active(pl, S, N, H, True)
            else:
                p = smoke.lstm_layer(gen, H, H)
                x, st, nv = smoke.layer_inputs(gen, S, T, H, H, [T] * S,
                                               nodes=False)
                plan = LS.launch_plan(S, H, sm_count(0))
                split = {"P": plan.P, "cooperative": plan.cooperative}
                try:
                    plan2 = LS.launch_plan(S, H, sm_count(0), P=2 * plan.P)
                except ValueError:
                    plan2 = None
                active = lambda pl: LS.max_active(pl, S, H)
            with torch.no_grad():
                sargs = mod.scan_inputs(p, x, st, nv)
                calls = {"old_ms": lambda: old_scan(torch, name, old[name],
                                                    sargs),
                         "new_ms": lambda: mod.scan(*sargs)}
                if plan2 is not None:
                    calls["new_2x_ms"] = lambda: mod.scan(*sargs, plan=plan2)
                got = {k: f() for k, f in calls.items()}
                torch.cuda.synchronize()
                err = {k: max(float((a - b).abs().max()) for a, b in
                              zip(got[k], got["old_ms"]))
                       for k in got if k != "old_ms"}
                order = list(calls) + list(reversed(calls))
                times = {k: 0.0 for k in calls}
                for k in order:                # old, new, 2x, 2x, new, old
                    times[k] += CS.cuda_ms(calls[k], 20) / 2
            ok &= all(e <= TOL for e in err.values())
            line = {"kernel": name, "S": S, "H": H, "T": T, **times,
                    "max_abs_diff_vs_old": err, "split": split,
                    "smem": plan.smem, "max_active": active(plan),
                    "split_2x": None if plan2 is None else
                    {"split": plan2.P if name == "lstm" else plan2.C,
                     "smem": plan2.smem, "max_active": active(plan2)}}
            lines.append(line)
            print(json.dumps(line), flush=True)
    for name in names:
        rows = [r for r in lines if r["kernel"] == name
                and r["S"] == CS.S_SERVE]
        summary = {"kernel": name, "window_S": CS.S_SERVE,
                   "launches": 2 * len(rows),
                   "old_ms": sum(2 * r["old_ms"] for r in rows),
                   "new_ms": sum(2 * r["new_ms"] for r in rows)}
        summary["new_over_old"] = summary["new_ms"] / summary["old_ms"]
        lines.append(summary)
        print(json.dumps(summary), flush=True)
    write_lines(args, lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
