#!/usr/bin/env python3
r"""A deployment artifact whose stage 1 has no kernel launch plan (the A3GC
cascade at ``--hu1 80``): how the plain version enters the ``torch.export``
program, and how the artifact steps against its live session.

    python3 scripts/torch_export_plain.py [--device cpu] [--hu1 80] [--loop]

For precision "default" and "highest": the cascade initialised as ``cli
export`` initialises it (seed i per stage), exported at S = 8, W = 60 with
the shipped stats; the program's node count, the export and load seconds,
and max |artifact - live| of the poses over 3 windows and of the final
states. ``--loop`` adds, at "default", the same export with the plain
version traced op by op (the frame loop unrolled into the program) in place
of the one op node a layer call (``a3gc_tpu_torch::gcn_lstm_scan_plain``).
``--by_stage`` splits the gap by stage instead: the three nets' calls of
one live window at "default", each held against its own ``torch.export``
program on the same input (stage 1 on its plain op node, stages 2 and 3 on
the kernel op), a plain stage again with its eager layers' y made
contiguous as the op returns it, and stage 1's scan called directly and
through its plain op against ``gcn_lstm.scan_reference``.
One JSON line; on a card, its name and power limit after it.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def random_rotations(rng, shape):
    import numpy as np
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(shape + (3, 3)).astype(np.float32)


def run(device, hu1, precision, loop):
    import numpy as np
    import torch
    from a3gc_tpu_torch import cli
    from a3gc_tpu_torch import export as X
    from a3gc_tpu_torch.eval.streaming import StreamingCascade
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import library as LIB
    from a3gc_tpu_torch.smpl import ParametricModel

    S, W = 8, 60
    args = cli.build_parser().parse_args(
        ["export", "--norm", "--hu1", str(hu1), "--precision", precision,
         "--output", "unused"])
    cascade, is_graph = cli._stage_configs(args, precision=precision)
    params = cli._load_cascade_params(args, cascade, is_graph, device)
    stats = cli._load_stats(args)
    model = ParametricModel()
    live = StreamingCascade(params, cascade, model, window=W, stats=stats,
                            normalize=True, streams=S, device=device)
    plain_op = LIB.gcn_lstm_scan_plain
    if loop:        # the plain version traced op by op, not one node

        def traced(u, wh, adj, bias, *rest):
            att, (h0, c0, nv, tf32) = rest[:6], rest[6:]
            return G.scan_reference(u, wh, adj, bias,
                                    None if att[0] is None else att,
                                    h0, c0, nv, tf32)
        LIB.gcn_lstm_scan_plain = traced
    try:
        t0 = time.perf_counter()
        ep, manifest = X.export_streaming_cascade(
            params, cascade, model, window=W, streams=S, stats=stats,
            normalize=True)
        export_s = time.perf_counter() - t0
    finally:
        LIB.gcn_lstm_scan_plain = plain_op
    with tempfile.TemporaryDirectory() as d:
        X.save_exported(d, ep, manifest)
        t0 = time.perf_counter()
        sess = X.ArtifactSession(X.load_exported(d, device=device))
        load_s = time.perf_counter() - t0
    rng = np.random.default_rng(17)
    errs = []
    for _ in range(3):
        ori = random_rotations(rng, (S, W, 6)).reshape(S, W, 54)
        acc = rng.normal(scale=0.5, size=(S, W, 18)).astype(np.float32)
        errs.append(float(np.abs(sess.step(ori, acc)
                                 - live.step(ori, acc)).max()))

    def leaves(t):
        return ([x for sub in t for x in leaves(sub)]
                if isinstance(t, (tuple, list)) else [t])
    state_err = max(float((a - b).abs().max()) for a, b in
                    zip(leaves(sess._states), leaves(live._states)))
    return {"recurrent": manifest["recurrent"],
            "nodes": len(ep.graph.nodes), "export_s": export_s,
            "load_s": load_s, "pose_max_abs_err_per_window": errs,
            "state_max_abs_err": state_err}


def by_stage(device, hu1):
    """max |exported - eager| of each stage's net on one live window's
    inputs at "default", and stage 1's scan through its ops."""
    import dataclasses
    import numpy as np
    import torch
    from a3gc_tpu_torch import cli
    from a3gc_tpu_torch.eval.streaming import StreamingCascade
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import library as LIB
    from a3gc_tpu_torch.ops._common import operand_format
    from a3gc_tpu_torch.smpl import ParametricModel

    S, W = 8, 60
    args = cli.build_parser().parse_args(
        ["export", "--norm", "--hu1", str(hu1), "--precision", "default",
         "--output", "unused"])
    cascade, is_graph = cli._stage_configs(args, precision="default")
    params = cli._load_cascade_params(args, cascade, is_graph, device)
    live = StreamingCascade(params, cascade, ParametricModel(), window=W,
                            stats=cli._load_stats(args), normalize=True,
                            streams=S, device=device)
    calls, apply = [], N.graph_net_apply

    def recording(p, cfg, x, state=None, **kw):
        calls.append((p, cfg, x.clone(), state, kw))
        return apply(p, cfg, x, state, **kw)
    N.graph_net_apply = recording
    try:
        rng = np.random.default_rng(17)
        ori = random_rotations(rng, (S, W, 6)).reshape(S, W, 54)
        acc = rng.normal(scale=0.5, size=(S, W, 18)).astype(np.float32)
        live.step(ori, acc)
    finally:
        N.graph_net_apply = apply

    def leaves(t):
        return ([x for sub in t for x in leaves(sub)]
                if isinstance(t, (tuple, list)) else [t])

    out = {"stages": []}
    for i, (p, cfg, x, state, kw) in enumerate(calls):
        fmt = operand_format(cfg.precision, device)
        plain = N.plan_refusal(cfg, S, fmt, device) is not None
        pinned = dataclasses.replace(cfg, backend="eager" if plain else (
            "cuda" if device.type == "cuda" else "auto"))

        class Net(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.p = p

            def forward(self, x, state):
                return N.graph_net_apply(self.p, pinned, x, state, **kw)

        with torch.no_grad():
            want = apply(p, cfg, x, state, **kw)
            ep = torch.export.export(Net(), (x, state), strict=False)
            got = ep.module()(x, state)
        errs = [float((a - b).abs().max())
                for a, b in zip(leaves(got), leaves(want))]
        row = {"stage": i + 1, "H": cfg.units_hidden, "fmt": fmt,
               "plain": plain, "max_abs_err_y_state": errs}
        if plain:
            # the eager plain layer's y made contiguous, as the op returns
            # it (its y is a transposed view): the products after it then
            # see the program's layout
            reference = G.bi_gcn_lstm_reference

            def contiguous(*a, **k):
                y, st = reference(*a, **k)
                return y.contiguous(), st
            G.bi_gcn_lstm_reference = contiguous
            try:
                with torch.no_grad():
                    again = apply(p, cfg, x, state, **kw)
            finally:
                G.bi_gcn_lstm_reference = reference
            row["max_abs_err_y_state_eager_contiguous"] = [
                float((a - b).abs().max())
                for a, b in zip(leaves(got), leaves(again))]
            row["eager_y_strides"] = list(reference(
                p.rnn2, torch.zeros((S, 2, 15, 2 * cfg.units_hidden),
                                    device=device),
                tuple(torch.zeros((2, S, 15, cfg.units_hidden),
                                  device=device) for _ in range(2)),
                fmt=fmt)[0].stride())
        out["stages"].append(row)
    # stage 1's rnn1 scan on random hoisted inputs: the reference twice and
    # the plain op, called eagerly
    p, cfg, x, state, kw = calls[0]
    with torch.no_grad():
        st = N.graph_net_zero_state(cfg, S, device, x.dtype) \
            if state is None else state
        u = torch.randn((2, S, W, 15, 4 * cfg.units_hidden),
                        generator=torch.Generator().manual_seed(3)).to(device)
        wh = p.rnn1.kernel[:, -cfg.units_hidden:].contiguous()
        att = p.rnn1.attention
        att = tuple(t.contiguous() for t in (
            att.w, att.wq, att.wh, att.u.reshape(2, -1), att.bs, att.bu))
        h0, c0 = (t.contiguous() for t in st[0])
        nv = torch.full((S,), W, dtype=torch.int32, device=device)
        ref = G.scan_reference(u, wh, p.rnn1.adj.contiguous(),
                               p.rnn1.bias.contiguous(), att, h0, c0, nv,
                               tf32=True)
        op = LIB.gcn_lstm_scan_plain(u, wh, p.rnn1.adj.contiguous(),
                                     p.rnn1.bias.contiguous(), *att, h0, c0,
                                     nv, True)
        again = G.scan_reference(u, wh, p.rnn1.adj.contiguous(),
                                 p.rnn1.bias.contiguous(), att, h0, c0, nv,
                                 tf32=True)
    out["stage1_scan_op_vs_reference"] = max(
        float((a - b).abs().max()) for a, b in zip(op, ref))
    out["stage1_scan_reference_twice"] = max(
        float((a - b).abs().max()) for a, b in zip(again, ref))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--hu1", type=int, default=80)
    p.add_argument("--loop", action="store_true")
    p.add_argument("--by_stage", action="store_true")
    a = p.parse_args()
    import torch
    from a3gc_tpu_torch._device import resolve_device
    device = resolve_device(a.device)
    out = {"device": str(device), "hu1": a.hu1}
    if a.by_stage:
        out["by_stage"] = by_stage(device, a.hu1)
    for precision in ("default", "highest") if not a.by_stage else ():
        out[precision] = run(device, a.hu1, precision, False)
    if a.loop:
        out["default_loop"] = run(device, a.hu1, "default", True)
    print(json.dumps(out))
    if device.type == "cuda":
        print(torch.cuda.get_device_name(device), subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main()
