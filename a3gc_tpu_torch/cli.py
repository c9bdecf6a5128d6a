r"""Command-line interface of the port (counterpart of ``a3gc_tpu/cli.py``):
the ``serve`` subcommand.

Usage:
    python -m a3gc_tpu_torch.cli serve --port 8765 --streams 8 --norm \
        --quality balanced                       # on the card
    python -m a3gc_tpu_torch.cli serve --device cpu ...

The cascades (``--model a3gc | aagc | agc | ggru | tp``) are served from
freshly initialised weights (``torch.Generator``, seed i for stage i), with
the shipped normalization stats and the IK-only body model. Loading
checkpoints, serving a deployment artifact, a mesh of cards and the other
subcommands wait for later slices (see ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import os
import sys

MODEL_CHOICES = ("a3gc", "aagc", "agc", "ggru", "tp", "dip")

QUALITY_PRESETS = {
    # named (window, lookahead K, history P) bundles — one flag instead of
    # three. Device work per W emitted frames is one pass over (P+K+1)·W
    # frames and one over W:
    #   latency:  (60, K=0, P=1) no added latency
    #   balanced: (60, K=1, P=1) +1 window of latency
    #   max:      (60, K=1, P=4) the latency of balanced (P is compute only)
    #   ultra:    (120, 1, 2) 2 s windows + 2 s lookahead
    "latency": (60, 0, 1),
    "balanced": (60, 1, 1),
    "max": (60, 1, 4),
    "ultra": (120, 1, 2),
}

# flags of the JAX CLI's `serve` that the port parses and refuses: what
# each waits for
_WAITS_FOR = {
    "path": "--path (checkpoint discovery) waits for ROADMAP Queue 1 item 9",
    "torch_checkpoints": "--torch_checkpoints (reference .tar checkpoints) "
                         "waits for ROADMAP Queue 1 item 9",
    "artifact": "--artifact (serving a deployment artifact) waits for "
                "ROADMAP Queue 1 item 13",
    "mesh": "--mesh (slots sharded over several cards) waits for ROADMAP "
            "Queue 1 item 14",
}


def _add_quality_flag(p):
    p.add_argument("--quality", choices=tuple(QUALITY_PRESETS),
                   default=None,
                   help="streaming-quality preset: a named (window, "
                        "lookahead, history) bundle. latency = no added "
                        "latency (60, K=0, P=1); balanced = +1 window of "
                        "latency (60, 1, 1); max = the same latency, more "
                        "past context (60, 1, 4); ultra = 2 s windows and "
                        "2 s lookahead (120, 1, 2). Explicit "
                        "--window/--lookahead/--history override the "
                        "preset's components (an explicit 0 wins over the "
                        "preset)")


def _require(cond, msg):
    r"""Validate user input: exit with an actionable message instead of an
    assert (which vanishes under ``python -O`` and then surfaces as an
    opaque downstream error)."""
    if not cond:
        raise SystemExit(f"error: {msg}")


def _apply_quality(args):
    r"""Resolve ``--quality`` into (window, lookahead, history): the preset
    fills values the user left unset; explicit flags override its
    components (``--lookahead``/``--history`` parse to None so an explicit
    0 is distinguishable from the default and wins over the preset)."""
    if getattr(args, "quality", None):
        W, K, P = QUALITY_PRESETS[args.quality]
        if getattr(args, "lookahead", None) is None:
            args.lookahead = K
        if getattr(args, "history", None) is None:
            args.history = P
        if getattr(args, "window", None) is None:
            args.window = W
    # no preset (or preset applied): unset K/P mean plain windowing
    for attr in ("lookahead", "history"):
        if getattr(args, attr, 0) is None:
            setattr(args, attr, 0)


def _add_common_model_flags(p):
    p.add_argument("--model", choices=MODEL_CHOICES, default="a3gc")
    p.add_argument("--hu1", type=int, default=256,
                   help="stage-1 hidden units")
    p.add_argument("--hu2", type=int, default=64)
    p.add_argument("--hu3", type=int, default=128)
    p.add_argument("--norm", action="store_true",
                   help="normalize inputs with train stats")
    p.add_argument("--cda", action="store_true",
                   help="use contralateral-augmented (sym) stats")
    p.add_argument("--rotsize", type=int, default=9, choices=(3, 6, 9),
                   help="stage-3 rotation representation")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the server runs on (default: the "
                        "card; 'cpu' runs the plain versions of the "
                        "kernels)")


def _stage_configs(args):
    r"""The per-model cascade stage configs: (CascadeConfig, is_graph)."""
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import CascadeConfig, PoseNetConfig

    if args.model in ("a3gc", "aagc", "agc", "ggru"):
        def g(ui, uo, h, rot):
            return PoseNetConfig(net=N.GraphNetConfig(
                cell=args.model, units_in=ui, units_out=uo, units_hidden=h),
                rotsize=rot)

        return CascadeConfig(stage1=g(12, 3, args.hu1, 3),
                             stage2=g(15, 3, args.hu2, 3),
                             stage3=g(15, args.rotsize, args.hu3,
                                      args.rotsize)), True
    if args.model == "tp":
        def d(ni, no, h, rot):
            return PoseNetConfig(net=N.DIPConfig(
                n_input=ni, n_output=no, n_hidden=h), rotsize=rot)

        return CascadeConfig(stage1=d(72, 15, 256, 3),
                             stage2=d(87, 69, 64, 3),
                             stage3=d(141, 15 * args.rotsize, 128,
                                      args.rotsize)), False
    # dip: single stage, handled separately
    return None, False


def _load_stats(args):
    r"""The shipped copy of the reference's stats assets (sym with
    ``--cda``), or None if the package was installed without them."""
    from a3gc_tpu_torch.data import load_stats
    name = "all_sym_train_stats.npz" if args.cda else "all_train_stats.npz"
    shipped = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "assets", "stats", name)
    return load_stats(shipped) if os.path.isfile(shipped) else None


def _init_cascade_params(cascade, is_graph, device):
    r"""Fresh init, stage i from ``torch.Generator`` seed i (benchmarking
    and smoke runs without checkpoints)."""
    import torch

    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models.pipeline import init_pose_net

    nira = load_adjacency_template() if is_graph else None
    return tuple(
        init_pose_net(torch.Generator().manual_seed(i), c, nira).to(device)
        for i, c in enumerate(cascade.stages))


def cmd_serve(args):
    r"""Dynamic-batching HTTP pose serving (see a3gc_tpu_torch/serve.py):
    up to --streams concurrent clients share ONE multi-stream step;
    requests arriving within --max_wait_ms coalesce into one device
    step."""
    import json as _json

    _apply_quality(args)
    for attr, msg in _WAITS_FOR.items():
        _require(not getattr(args, attr), msg)
    _require(args.model != "dip",
             "--model dip serves a trained checkpoint only; loading one "
             "waits for ROADMAP Queue 1 item 9")

    # NOTE: construction happens inside this helper so its frame (and the
    # session/params/model locals pinning device tensors) is POPPED before
    # serve_forever runs. An exec recycle's pre-exec teardown
    # (serve._do_recycle) can only free the device if nothing else
    # references the session — a long-lived cmd_serve frame holding it
    # would keep its tensors alive into the exec.
    srv, streams, window = _build_server(args)
    host, port = srv.address[:2]
    print(_json.dumps({"serving": f"http://{host}:{port}",
                       "streams": streams, "window": window}),
          flush=True)
    srv.serve_forever()


def _build_server(args):
    r"""Build the PoseServer for cmd_serve (see the note there: short-lived
    frame by design — do not inline into cmd_serve)."""
    from a3gc_tpu_torch._device import resolve_device
    from a3gc_tpu_torch.serve import PoseServer
    from a3gc_tpu_torch.smpl import ParametricModel

    args.window = args.window or 60
    args.streams = args.streams or 8
    device = resolve_device(args.device)
    cascade, is_graph = _stage_configs(args)
    params3 = _init_cascade_params(cascade, is_graph, device)
    stats = _load_stats(args) if args.norm else None
    _require(stats is not None or not args.norm,
             "--norm needs the shipped stats assets "
             "(a3gc_tpu_torch/assets/stats)")
    srv = PoseServer(params3, cascade, ParametricModel(),
                     window=args.window, streams=args.streams, stats=stats,
                     normalize=args.norm, host=args.host, port=args.port,
                     max_wait_ms=args.max_wait_ms,
                     lookahead=args.lookahead, history=args.history,
                     recycle_rss_mb=args.recycle_rss_mb,
                     allow_recycle=True, device=device,
                     # POST /v1/reload re-runs the init; with checkpoint
                     # loading it will re-discover the latest ones
                     reload_fn=lambda: _init_cascade_params(
                         cascade, is_graph, device))
    return srv, args.streams, args.window


def build_parser():
    p = argparse.ArgumentParser(
        prog="a3gc_tpu_torch",
        description="PyTorch/CUDA port of a3gc_tpu: pose serving")
    sub = p.add_subparsers(dest="command", required=True)

    sv = sub.add_parser("serve", help="dynamic-batching HTTP pose serving "
                        "(multi-stream, per-client state)")
    _add_common_model_flags(sv)
    sv.add_argument("--window", type=int, default=None,
                    help="frames per window (default 60)")
    sv.add_argument("--streams", type=int, default=None,
                    help="max concurrent client sessions (default 8)")
    sv.add_argument("--host", type=str, default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8765)
    sv.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="request-coalescing window per device step")
    sv.add_argument("--lookahead", type=int, default=None,
                    help="K-window lookahead: emissions lag K windows but "
                         "each emitted window's backward direction sees K "
                         "extra windows of future context (lower "
                         "streaming-vs-offline divergence; one pass over "
                         "(K+1) windows and one over 1 per emission)")
    sv.add_argument("--history", type=int, default=None,
                    help="P-window history: emissions re-run up to P past "
                         "windows as leading attention context (lower "
                         "divergence at no added latency; composes with "
                         "--lookahead)")
    sv.add_argument("--recycle_rss_mb", type=int, default=0,
                    help="self-recycle when the process RSS exceeds this "
                         "(MB): drain in-flight work, snapshot every live "
                         "session's carried state, exec a fresh process "
                         "that inherits the listening socket and resumes "
                         "the sessions. POST /v1/recycle triggers one on "
                         "demand. 0 = off")
    sv.add_argument("--mesh", action="store_true",
                    help="not ported yet: " + _WAITS_FOR["mesh"])
    sv.add_argument("--artifact", type=str, default="",
                    help="not ported yet: " + _WAITS_FOR["artifact"])
    sv.add_argument("--path", type=str, default="",
                    help="not ported yet: " + _WAITS_FOR["path"])
    sv.add_argument("--torch_checkpoints", nargs="+", default=None,
                    help="not ported yet: "
                         + _WAITS_FOR["torch_checkpoints"])
    _add_quality_flag(sv)
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
