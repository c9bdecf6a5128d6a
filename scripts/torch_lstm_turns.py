#!/usr/bin/env python3
r"""Times ``ops/lstm.py``'s layer calls of one checkout of the port on one
CUDA card, so that two commits can be compared in turns in one machine
session: run it from each checkout's package in alternation (a, b, b, a).

    python3 scripts/torch_lstm_turns.py [--tree DIR] [--tag NAME]
                                        [--reps N] [--out FILE]

``--tree`` imports ``a3gc_tpu_torch`` from another checkout (default: the
one holding this script); its kernels are built there, as that checkout
builds them. Every shape runs the fp32 and the TF32 instantiation, each as
the kernel alone (``scan``) and as the layer's wrapper (``bi_lstm``: the
input projection, the operands' rounding and the scan), timed in turns
(fp32 scan, fp32 wrapper, TF32 scan, TF32 wrapper, then back) with CUDA
events around back-to-back calls, as ``chip_smoke.py`` times a call. The
shapes are those of PERF.md's ``lstm`` rows: TransPose H = 256 / 64 / 128
and DIP H = 512, D = 2, S = 8 and 1, T = 60; DIP's unidirectional layer
(D = 1) at S = 8 and 1; H = 512 at T = 120 (S = 8); every width at S = 16,
T = 1024 and S = 1, T = 2048. A window is the ten layer calls of S = 8, T =
60: TransPose's three stages and DIP each at F = H and 2H, and DIP's
unidirectional net at F = H twice; its sums are printed per format.

Weights and inputs come from fixed seeds on the CPU, so every checkout
sees the same tensors; each shape also prints a digest of the outputs (y,
h, c) at ragged valid lengths per format, which two checkouts share
exactly where their kernels compute the same bits. Output: one JSON line
per shape, one summary line, the card's name and power limit. Imports
nothing of JAX or of the JAX package; exits non-zero without a card.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP_WIDTHS, DIP_H, LONG = (256, 64, 128), 512, ((16, 1024), (1, 2048))


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean ms of fn() over reps back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer(torch, seed, F, H, D):
    """A dense LSTM layer's parameters, uniform in ±1/√H, on the card."""
    from a3gc_tpu_torch.models import layers as L
    from a3gc_tpu_torch.models import nets as N
    gen = torch.Generator().manual_seed(seed)
    b = 1.0 / H ** 0.5

    def u(*shape):
        return torch.rand(shape, generator=gen) * (2 * b) - b

    def one():
        return N.LSTMLayerParams(w_ih=u(F, 4 * H), w_hh=u(H, 4 * H),
                                 b_ih=u(4 * H), b_hh=u(4 * H))

    return (L.stack_directions(one(), one()) if D == 2 else one()).cuda()


def ragged(S, T):
    """Valid lengths with full, short and empty streams."""
    return ([T, T - 24, T // 2, T, 0, 3 * T // 4, T, min(37, T)] * 2)[:S] \
        if S > 1 else [T - 48]


def digest(tensors):
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def shapes():
    """(name, S, T, F, H, D, in_window) of every timed call."""
    out = []
    for S in (8, 1):
        for H in TP_WIDTHS + (DIP_H,):
            for F in ((H, 2 * H) if S == 8 else (H,)):
                out.append((f"S={S} H={H} F={F}", S, 60, F, H, 2, S == 8))
        for F in ((DIP_H, DIP_H) if S == 8 else (DIP_H,)):
            out.append((f"uni S={S} H={DIP_H}", S, 60, F, DIP_H, 1, S == 8))
    out.append((f"S=8 T=120 H={DIP_H}", 8, 120, DIP_H, DIP_H, 2, False))
    for S, T in LONG:
        for H in TP_WIDTHS + (DIP_H,):
            out.append((f"S={S} T={T} H={H}", S, T, H, H, 2, False))
    return out


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose a3gc_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a name for this run's lines")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls a timing at T <= 120 (a fifth beyond)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_lstm_turns: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import a3gc_tpu_torch
    from a3gc_tpu_torch.ops import lstm as LS
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    package = os.path.dirname(os.path.abspath(a3gc_tpu_torch.__file__))
    window = {"fp32": 0.0, "tf32": 0.0, "fp32_scan": 0.0, "tf32_scan": 0.0}
    for i, (name, S, T, F, H, D, in_window) in enumerate(shapes()):
        p = layer(torch, 100 + i, F, H, D)
        gen = torch.Generator().manual_seed(200 + i)
        x = torch.randn((S, T, F), generator=gen).cuda()
        st = tuple((0.5 * torch.randn((2,) * (D - 1) + (S, H),
                                      generator=gen)).cuda()
                   for _ in range(2))
        full = torch.full((S,), T, dtype=torch.int32, device="cuda")
        nv = torch.tensor(ragged(S, T), dtype=torch.int32, device="cuda")
        row = {"tag": args.tag, "shape": name, "S": S, "T": T, "F": F,
               "H": H, "D": D}
        calls = {}
        with torch.no_grad():
            for fmt in ("fp32", "tf32"):
                y, (h, c) = LS.bi_lstm(p, x, st, nv, fmt=fmt)
                row[f"digest_{fmt}"] = digest((y, h, c))
                sa = LS.scan_inputs(p, x, st, full, fmt)
                tf32 = fmt == "tf32"
                calls[f"{fmt}_scan"] = (
                    lambda sa=sa, tf32=tf32: LS.scan(*sa, tf32=tf32))
                calls[fmt] = lambda fmt=fmt: LS.bi_lstm(p, x, st, full,
                                                        fmt=fmt)
            reps = args.reps if T <= 120 else max(1, args.reps // 5)
            ms = dict.fromkeys(calls, 0.0)
            for k in list(calls) + list(reversed(calls)):
                ms[k] += cuda_ms(torch, calls[k], reps) / 2
        row.update({f"{k}_ms": v for k, v in ms.items()})
        if in_window:
            for k in window:
                window[k] += ms[k]
        emit(row)
        del p, x, st, calls
        torch.cuda.empty_cache()
    emit({"tag": args.tag, "package": package,
          "window_ms": window, "torch": torch.__version__,
          "device": torch.cuda.get_device_name(0)})
    emit({"card": card()})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
