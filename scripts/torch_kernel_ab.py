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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier <kernel>.cu of every "
                    "kernel asked for")
    ap.add_argument("--kernels", default="gcn_lstm,ggru,lstm",
                    help="comma-separated kernels to compare (default: all)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    names = [n for n in ("gcn_lstm", "ggru", "lstm")
             if n in args.kernels.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
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
    card = CS.nvidia_smi()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
            f.write(json.dumps({"card": card}) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
