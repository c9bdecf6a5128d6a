r"""Command-line interface of the port (counterpart of ``a3gc_tpu/cli.py``):
the ``serve``, ``stream``, ``export``, ``evaluate`` and
``convert-checkpoint`` subcommands.

Usage:
    python -m a3gc_tpu_torch.cli serve --torch_checkpoints s1.tar s2.tar \
        s3.tar --norm --quality balanced         # on the card
    python -m a3gc_tpu_torch.cli serve --path runs/x --type finetuning \
        --mid1 12 ...                            # discovered checkpoints
    python -m a3gc_tpu_torch.cli serve --model dip --hu1 512 \
        --torch_checkpoints dip.tar              # the single DIP net
    python -m a3gc_tpu_torch.cli serve --device cpu ...
    python -m a3gc_tpu_torch.cli export --norm --streams 1 8 --window 60 \
        --lookahead 1 --history 1 --output exported/a3gc   # a bundle
    python -m a3gc_tpu_torch.cli serve --artifact exported/a3gc \
        --streams 8 --quality balanced           # no checkpoint needed
    python -m a3gc_tpu_torch.cli stream --input test.npz [--artifact DIR |
        --torch_checkpoints ...] [--streams 8 | --pipelined | --evaluate]
    python -m a3gc_tpu_torch.cli evaluate --model a3gc --norm \
        --smpl basicModel_m.pkl --datasets test.npz [--batch_streams 8 |
        --streaming 60 --lookahead 1 --history 1 | --save_preds]
    python -m a3gc_tpu_torch.cli convert-checkpoint --torch s1.tar \
        --model a3gc --output runs/x/checkpoint_model1_finetuning_5
    python -m a3gc_tpu_torch.cli convert-checkpoint --to_torch DIR \
        --model a3gc --n_input 12 --n_output 3 --hu1 256 --output s1.tar

The cascades (``--model a3gc | aagc | agc | ggru | tp``) run from reference
``.tar`` checkpoints (``--torch_checkpoints``, one a stage), from the latest
checkpoints of a directory (``--path``, ``--type``, ``--mid1/2/3``) or,
given neither, from freshly initialised weights (``torch.Generator``, seed i
for stage i); ``--model dip`` from a checkpoint only. The body model is the
SMPL pickle of ``--smpl`` (default: ``models/basicModel_m_lbs_10_207_0_
v1.1.0.pkl`` under ``--data_root``), or a synthetic one when that file is
missing; the normalization stats those under ``--data_root``, else the
shipped copies. ``export`` writes a deployment artifact
(:mod:`a3gc_tpu_torch.export`) that ``serve`` and ``stream`` run with
``--artifact`` and nothing else. A mesh of cards and the other subcommands
wait for later slices (see ROADMAP.md, Queue 1).
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

# flags of the JAX CLI that the port parses and refuses: what each waits
# for
_WAITS_FOR = {
    "mesh": "--mesh (streams sharded over several cards) waits for ROADMAP "
            "Queue 1 item 14",
}
# where the JAX package's config looks under the data root
_SMPL_MALE = "models/basicModel_m_lbs_10_207_0_v1.1.0.pkl"
_STATS_UNDER_ROOT = {False: "stats/all_train_stats.npz",
                     True: "stats/all_sym_train_stats.npz"}
# flags of the JAX CLI that steer JAX alone: accepted, noted, ignored
_JAX_ONLY = ("profile", "debug_nans", "compilation_cache")


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
        if hasattr(args, "streaming"):          # evaluate: implies it
            if not args.streaming:
                args.streaming = W
        elif getattr(args, "window", None) is None:
            args.window = W
    # no preset (or preset applied): unset K/P mean plain windowing
    for attr in ("lookahead", "history"):
        if getattr(args, attr, 0) is None:
            setattr(args, attr, 0)


def _add_common_model_flags(p):
    p.add_argument("--model", choices=MODEL_CHOICES, default="a3gc")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="accepted for the JAX CLI's command lines and "
                        "ignored (a jax.profiler trace there)")
    p.add_argument("--debug_nans", action="store_true",
                   help="accepted and ignored (jax_debug_nans there)")
    p.add_argument("--compilation_cache", type=str, default=None,
                   metavar="DIR",
                   help="accepted and ignored (the jax compilation cache "
                        "there; the port's kernels are built once into "
                        "build/kernels)")
    p.add_argument("--hu1", type=int, default=256,
                   help="stage-1 hidden units (the DIP net's with --model "
                        "dip)")
    p.add_argument("--hu2", type=int, default=64)
    p.add_argument("--hu3", type=int, default=128)
    p.add_argument("--norm", action="store_true",
                   help="normalize inputs with train stats")
    p.add_argument("--cda", action="store_true",
                   help="use contralateral-augmented (sym) stats")
    p.add_argument("--smpl", type=str, default=None,
                   help="SMPL pickle path (default: the data root's; a "
                        "missing file falls back to a synthetic body "
                        "model)")
    p.add_argument("--data_root", type=str, default=None,
                   help="where the SMPL file and the stats are looked up "
                        "(default: $A3GC_DATA_ROOT, else ./data)")
    p.add_argument("--precision", choices=("highest", "default"),
                   default=None,
                   help="accepted; the port computes in fp32 whatever it "
                        "says (the JAX CLI serves at 'default')")
    p.add_argument("--rotsize", type=int, default=9, choices=(3, 6, 9),
                   help="stage-3 rotation representation")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the card; "
                        "'cpu' runs the plain versions of the kernels)")


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


def _under_data_root(args, rel: str) -> str:
    r"""``rel`` under ``--data_root`` ($A3GC_DATA_ROOT, else ./data), as the
    JAX package's config resolves it."""
    root = args.data_root or os.environ.get("A3GC_DATA_ROOT", "data")
    return rel if os.path.isabs(rel) else os.path.join(root, rel)


def _load_stats(args):
    r"""The stats under the data root, else the shipped copy of the
    reference's stats assets (sym with ``--cda``), or None if the package
    was installed without them."""
    from a3gc_tpu_torch.data import load_stats
    under_root = _under_data_root(args, _STATS_UNDER_ROOT[bool(args.cda)])
    if os.path.isfile(under_root):
        return load_stats(under_root)
    shipped = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "assets", "stats",
                           os.path.basename(_STATS_UNDER_ROOT[bool(args.cda)]))
    return load_stats(shipped) if os.path.isfile(shipped) else None


def _load_body_model(args, device):
    r"""The SMPL pickle of ``--smpl`` (default: the data root's male model,
    ``$A3GC_SMPL_MALE`` relative to it) on ``device``; when the file is
    missing, the synthetic body model (the JAX CLI's fallback for smoke
    runs), noted on stderr. The synthetic pickle is written into a
    temporary directory of this process's own, so servers started together
    do not race on one file."""
    import tempfile

    from a3gc_tpu_torch.smpl import (load_parametric_model,
                                     write_synthetic_smpl_pickle)
    path = args.smpl or _under_data_root(
        args, os.environ.get("A3GC_SMPL_MALE", _SMPL_MALE))
    if os.path.isfile(path):
        return load_parametric_model(path, device=device)
    print(f"[a3gc_tpu_torch] SMPL pickle {path} not found — using the "
          "synthetic body model", file=sys.stderr)
    with tempfile.TemporaryDirectory() as tmp:
        return load_parametric_model(write_synthetic_smpl_pickle(
            os.path.join(tmp, "synthetic_smpl.pkl")), device=device)


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


def _restore(found, cfg, device, seed=0):
    r"""A discovered checkpoint directory restored into a net of ``cfg``
    on ``device``; a checkpoint the port cannot read exits naming why."""
    import torch

    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models.pipeline import init_pose_net
    from a3gc_tpu_torch.utils import restore_params

    nira = load_adjacency_template() if cfg.is_graph else None
    template = init_pose_net(torch.Generator().manual_seed(seed), cfg,
                             nira).to(device)
    try:
        return restore_params(found[0], template)
    except ValueError as e:
        raise SystemExit(f"error: {e}")


def _import_tar(path, cfg, model, device):
    r"""A reference ``.tar`` as a net of ``cfg`` on ``device``; a file of
    another net or width exits naming the key and both shapes."""
    from a3gc_tpu_torch.compat.torch_import import (
        dip_params_from_state_dict, graph_net_params_from_state_dict,
        load_torch_checkpoint)

    _require(os.path.isfile(path), f"no checkpoint file {path}")
    sd = load_torch_checkpoint(path)
    try:
        if cfg.is_graph:
            return graph_net_params_from_state_dict(sd, model, cfg=cfg.net,
                                                    device=device)
        return dip_params_from_state_dict(sd, cfg=cfg.net, device=device)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"error: {path}: {e}")


def _load_cascade_params(args, cascade, is_graph, device):
    r"""Per-stage checkpoint loading: one reference ``.tar`` a stage
    (``--torch_checkpoints``), or the latest checkpoint of each stage in
    ``--path`` (``--type`` phase, ``--mid1/2/3`` epoch pins); a fresh init
    when neither is given. Every tensor ends on ``device``."""
    pins = (args.mid1, args.mid2, args.mid3)
    if args.torch_checkpoints:
        _require(len(args.torch_checkpoints) == 3,
                 f"--torch_checkpoints takes one .tar per stage (3), got "
                 f"{len(args.torch_checkpoints)}")
        return tuple(_import_tar(path, c, args.model, device)
                     for path, c in zip(args.torch_checkpoints,
                                        cascade.stages))
    if not args.path:
        return _init_cascade_params(cascade, is_graph, device)
    from a3gc_tpu_torch.utils import discover_latest
    params3 = []
    for i, c in enumerate(cascade.stages):
        found = discover_latest(args.path, i + 1, phase=args.type,
                                epoch=pins[i] if pins[i] >= 0 else None)
        _require(found, f"no {args.type} checkpoint for stage {i + 1} in "
                        f"{args.path}" + (f" at epoch {pins[i]}"
                                          if pins[i] >= 0 else ""))
        params3.append(_restore(found, c, device, seed=i))
    return tuple(params3)


def _dip_config(args):
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import PoseNetConfig
    return PoseNetConfig(net=N.DIPConfig(
        n_input=60, n_output=15 * args.rotsize, n_hidden=args.hu1),
        rotsize=args.rotsize)


def _load_dip(args, device, allow_init=False):
    r"""The DIP net's config and params, from ``--torch_checkpoints`` (one
    ``.tar``) or ``--path`` discovery (stage 1, ``--mid1``); DIP serves a
    trained checkpoint only. ``allow_init`` (export) takes a fresh init,
    ``torch.Generator`` seed 0, when neither is given."""
    from a3gc_tpu_torch.models.pipeline import init_pose_net
    from a3gc_tpu_torch.utils import discover_latest

    cfg = _dip_config(args)
    if args.torch_checkpoints:
        return cfg, _import_tar(args.torch_checkpoints[0], cfg, "dip",
                                device)
    if allow_init and not args.path:
        import torch
        return cfg, init_pose_net(torch.Generator().manual_seed(0),
                                  cfg).to(device)
    _require(args.path, "--model dip serves a trained checkpoint: give "
                        "--torch_checkpoints DIP.tar or --path DIR")
    found = discover_latest(args.path, 1, phase=args.type,
                            epoch=args.mid1 if args.mid1 >= 0 else None)
    _require(found, f"no {args.type} DIP checkpoint in {args.path}")
    return cfg, _restore(found, cfg, device)


def _reloading(load):
    r"""``reload_fn`` for the server: ``load()`` on the HTTP thread, with a
    missing or unreadable checkpoint turned from an exit into an error,
    which ``POST /v1/reload`` answers with 500."""
    def reload_fn():
        try:
            return load()
        except SystemExit as e:
            raise RuntimeError(str(e)) from None
    return reload_fn


def _refuse_waiting_flags(args):
    for attr, msg in _WAITS_FOR.items():
        _require(not getattr(args, attr, None), msg)


def _note_ignored_flags(args):
    r"""One note on stderr for the flags that mean something to the JAX
    CLI only."""
    given = [f"--{f}" for f in _JAX_ONLY if getattr(args, f, None)]
    if args.precision:
        given.append(f"--precision {args.precision}")
    if given:
        print(f"[a3gc_tpu_torch] ignoring {' '.join(given)}: the port "
              "computes in fp32 and has no JAX profiler, NaN check or "
              "compilation cache", file=sys.stderr)


def _note_export_flags(args):
    r"""One note on stderr for ``export --backend / --platforms``, which
    choose how XLA lowers the JAX package's artifact: a port artifact always
    holds the three kernel ops (the kernels on the card, their plain
    versions on the CPU) and runs where it was exported, or where
    ``load_exported(device=)`` moves it."""
    given = [f"--backend {args.backend}"] if args.backend != "xla" else []
    if args.platforms:
        given.append("--platforms " + " ".join(args.platforms))
    if given:
        print(f"[a3gc_tpu_torch] ignoring {' '.join(given)}: a port "
              "artifact is a torch.export program of the kernel ops, "
              "exported on --device", file=sys.stderr)


def cmd_serve(args):
    r"""Dynamic-batching HTTP pose serving (see a3gc_tpu_torch/serve.py):
    up to --streams concurrent clients share ONE multi-stream step;
    requests arriving within --max_wait_ms coalesce into one device
    step."""
    import json as _json

    _apply_quality(args)
    _refuse_waiting_flags(args)
    _note_ignored_flags(args)

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

    device = resolve_device(args.device)
    if args.artifact:
        # serve straight from a deployment artifact: no checkpoint, stats
        # or SMPL file (geometry from the manifest; for a bundle,
        # --streams/--window select the geometry)
        session = _artifact_session(args, device)
        srv = PoseServer(None, None, None, host=args.host, port=args.port,
                         max_wait_ms=args.max_wait_ms, session=session,
                         lookahead=args.lookahead, history=args.history,
                         recycle_rss_mb=args.recycle_rss_mb,
                         allow_recycle=True)
        return srv, session.streams, session.window
    args.window = args.window or 60
    args.streams = args.streams or 8
    model = _load_body_model(args, device)
    if args.model == "dip":
        # the single DIP net behind the same batcher: raw IMU in, full
        # local poses out
        from a3gc_tpu_torch.eval.streaming import DipStreamingSession

        stats = _load_stats(args)
        _require(stats is not None,
                 "dip serving needs the shipped stats assets "
                 "(a3gc_tpu_torch/assets/stats)")
        cfg, params = _load_dip(args, device)
        session = DipStreamingSession(
            params, cfg, model, window=args.window, stats=stats,
            streams=args.streams, lookahead=args.lookahead,
            history=args.history, device=device)
        srv = PoseServer(None, None, None, host=args.host, port=args.port,
                         max_wait_ms=args.max_wait_ms, session=session,
                         lookahead=args.lookahead, history=args.history,
                         recycle_rss_mb=args.recycle_rss_mb,
                         allow_recycle=True,
                         # POST /v1/reload re-discovers the checkpoint
                         reload_fn=_reloading(
                             lambda: _load_dip(args, device)[1]))
        return srv, args.streams, args.window
    cascade, is_graph = _stage_configs(args)
    params3 = _load_cascade_params(args, cascade, is_graph, device)
    stats = _load_stats(args) if args.norm else None
    _require(stats is not None or not args.norm,
             "--norm needs the shipped stats assets "
             "(a3gc_tpu_torch/assets/stats)")
    srv = PoseServer(params3, cascade, model,
                     window=args.window, streams=args.streams, stats=stats,
                     normalize=args.norm, host=args.host, port=args.port,
                     max_wait_ms=args.max_wait_ms,
                     lookahead=args.lookahead, history=args.history,
                     recycle_rss_mb=args.recycle_rss_mb,
                     allow_recycle=True, device=device,
                     # POST /v1/reload re-discovers the latest checkpoints
                     # (training can keep writing to --path) on the HTTP
                     # thread, onto the device; the batcher swaps them in
                     reload_fn=_reloading(lambda: _load_cascade_params(
                         args, cascade, is_graph, device)))
    return srv, args.streams, args.window


def _artifact_session(args, device):
    r"""The session over ``--artifact``: an ``ArtifactSession`` on the
    geometry ``--streams`` / ``--window`` select, or with ``--lookahead`` /
    ``--history`` an ``ArtifactLookaheadSession`` over a bundle from
    ``export --lookahead K --history P``. A missing or unreadable artifact
    exits naming why."""
    from a3gc_tpu_torch.export import (ArtifactLookaheadSession,
                                       ArtifactSession, ExportedBundle,
                                       load_exported)
    _require(os.path.isdir(args.artifact),
             f"no artifact directory {args.artifact}")
    try:
        if args.lookahead or args.history:
            return ArtifactLookaheadSession(
                ExportedBundle(args.artifact, device), streams=args.streams,
                window=args.window, lookahead=args.lookahead,
                history=args.history)
        return ArtifactSession(load_exported(
            args.artifact, streams=args.streams, window=args.window,
            device=device))
    except (KeyError, ValueError, FileNotFoundError) as e:
        raise SystemExit(f"error: {args.artifact}: {e}")


def cmd_stream(args):
    r"""Online streaming inference: fixed-size IMU windows of the packed
    test npz ``--input`` flow through a session with per-stage recurrent
    state carried across windows (a live session on checkpoints, or
    ``--artifact``). Writes the predicted poses (``--output``), prints ONE
    JSON line of latency and throughput."""
    import json as _json
    import time as _time

    import numpy as np

    from a3gc_tpu_torch._device import resolve_device
    from a3gc_tpu_torch.data.factory.dipimu import load_test_sequences
    from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                               StreamingCascade)

    _apply_quality(args)
    _refuse_waiting_flags(args)
    _note_ignored_flags(args)
    _require(not (args.pipelined and (args.lookahead or args.history)),
             "--pipelined does not compose with --lookahead/--history "
             "(both buffer windows); drop one")
    _require(not (args.evaluate and (args.streams or 1) > 1),
             "--evaluate runs the per-sequence streaming path; drop "
             "--streams")
    _require(os.path.isfile(args.input), f"no input npz {args.input}")
    device = resolve_device(args.device)
    sequences = load_test_sequences(args.input)
    model = None                    # loaded on demand for --evaluate
    if args.artifact:
        # geometry from the manifest (--streams/--window select within a
        # bundle); no checkpoint, stats or model file needed
        _require(not args.pipelined,
                 "--pipelined drives the live session; artifacts use "
                 "plain step()")
        sess = _artifact_session(args, device)
        if args.lookahead or args.history:
            _require(sess.streams == 1,
                     "artifact lookahead/history streaming is "
                     "single-stream here; multi-client buffered serving "
                     "is `serve --artifact --lookahead/--history`")
        args.window, args.streams = sess.window, sess.streams
        if sess.streams > 1:
            _require(not args.evaluate,
                     "--evaluate needs a single-stream session; select "
                     "a streams=1 geometry from the bundle (--streams 1)")
            return _stream_multi(args, sess, sequences)
    else:
        args.window = args.window or 60
        args.streams = args.streams or 1
        model = _load_body_model(args, device)
        if args.model == "dip":
            stats = _load_stats(args)
            _require(stats is not None,
                     "dip streaming needs the shipped stats assets "
                     "(a3gc_tpu_torch/assets/stats)")
            cfg, params = _load_dip(args, device)
            sess = DipStreamingSession(
                params, cfg, model, window=args.window, stats=stats,
                streams=args.streams, lookahead=args.lookahead,
                history=args.history, device=device)
        else:
            cascade, is_graph = _stage_configs(args)
            params3 = _load_cascade_params(args, cascade, is_graph, device)
            stats = _load_stats(args) if args.norm else None
            _require(stats is not None or not args.norm,
                     "--norm needs the shipped stats assets "
                     "(a3gc_tpu_torch/assets/stats)")
            sess = StreamingCascade(
                params3, cascade, model, window=args.window, stats=stats,
                normalize=args.norm, streams=args.streams,
                lookahead=args.lookahead, history=args.history,
                device=device)
        if args.streams > 1:
            return _stream_multi(args, sess, sequences)
    W = args.window

    # warm up (kernel builds, first launches) outside the timed region;
    # buffered modes reach the steady-state emission at step P+K+1
    for _ in range(args.lookahead + args.history + 1):
        sess.step(sequences[0]["ori"][:W], sequences[0]["acc"][:W])
    if args.lookahead:
        sess.flush()
    sess.reset()

    latencies = []
    outputs = []
    for si, seq in enumerate(sequences):
        sess.reset()
        T = (seq["ori"].shape[0] // W) * W
        poses = []
        for t0 in range(0, T, W):
            t = _time.perf_counter()
            if args.pipelined:
                pose = sess.step_async(seq["ori"][t0:t0 + W],
                                       seq["acc"][t0:t0 + W])
            else:
                pose = sess.step(seq["ori"][t0:t0 + W],
                                 seq["acc"][t0:t0 + W])
            dt = _time.perf_counter() - t
            # lagged modes: the first steps of a sequence only buffer (no
            # device work); only emissions are latency samples
            if pose is not None or not (args.pipelined or args.lookahead):
                latencies.append(dt)
            if pose is not None:
                poses.append(pose)
        if args.pipelined or args.lookahead:
            t = _time.perf_counter()
            tail = sess.flush()
            latencies.append(_time.perf_counter() - t)
            if tail is not None:
                poses.append(tail)
        if poses:
            outputs.append((si, np.concatenate(poses)))

    if args.output:
        np.savez(args.output, **{f"pose_{i:03d}": p
                                 for i, (_, p) in enumerate(outputs)})
    stats_line = {
        "window": W,
        "pipelined": bool(args.pipelined),
        "lookahead": int(args.lookahead),
        "history": int(args.history),
    }
    if args.evaluate:
        # the reference 5-metric table on the streamed emissions: the
        # accuracy of this (window, K, P) configuration against the npz's
        # ground truth
        import torch

        from a3gc_tpu_torch.eval import reduced_to_full
        from a3gc_tpu_torch.metrics import PoseEvaluator

        body = model if model is not None else _load_body_model(args, device)
        pe = PoseEvaluator(body)
        metrics, ev_frames = [], 0
        for si, pred in outputs:
            Tp = pred.shape[0]
            gt = reduced_to_full(
                sequences[si]["pose"][:Tp].reshape(Tp, 15, 3, 3))
            metrics.append(pe(torch.as_tensor(pred, device=device),
                              torch.as_tensor(gt, device=device))
                           .cpu().numpy())
            ev_frames += Tp
        mean = np.stack(metrics).mean(axis=0)
        print(PoseEvaluator.format(mean))
        stats_line["evaluated_frames"] = ev_frames
        stats_line["sip_deg"] = round(float(mean[0, 0]), 3)
    lat = np.asarray(latencies) * 1e3
    stats_line.update({
        "windows": int(lat.size),
        "latency_ms_mean": round(float(lat.mean()), 3),
        "latency_ms_p50": round(float(np.percentile(lat, 50)), 3),
        "latency_ms_p99": round(float(np.percentile(lat, 99)), 3),
        "frames_per_sec": round(W / (lat.mean() / 1e3), 1),
    })
    print(_json.dumps(stats_line))


def _stream_multi(args, sess, sequences):
    r"""Multiplexed online serving: S independent clients share ONE
    multi-stream step per window. Sequences are assigned to client slots
    round-robin; a slot's state is reset when its sequence ends while the
    other slots keep streaming. Prints ONE JSON line of aggregate latency
    and throughput."""
    import json as _json
    import time as _time

    import numpy as np

    S, W = args.streams, args.window

    def slot_feed(playlist):
        for seq in playlist:
            T = (seq["ori"].shape[0] // W) * W
            for t0 in range(0, T, W):
                yield (seq["ori"].reshape(-1, 54)[t0:t0 + W],
                       seq["acc"].reshape(-1, 18)[t0:t0 + W], t0 == 0)

    feeds = [slot_feed(sequences[i::S]) for i in range(S)]
    zero_o, zero_a = np.zeros((W, 54), np.float32), np.zeros((W, 18),
                                                             np.float32)

    lookahead = getattr(args, "lookahead", 0)
    history = getattr(args, "history", 0)
    # warm up outside the timed region; buffered modes need P+K+1 steps to
    # reach the steady-state emission, plus the flush
    for _ in range(lookahead + history + 1):
        sess.step(np.zeros((S, W, 54), np.float32),
                  np.zeros((S, W, 18), np.float32))
    if lookahead:
        sess.flush()
    sess.reset()

    latencies, total_frames, ticks = [], 0, 0
    live = [True] * S
    started = [False] * S
    while any(live):
        ori = np.empty((S, W, 54), np.float32)
        acc = np.empty((S, W, 18), np.float32)
        act_vec = np.zeros(S, np.float32)
        active = 0
        for i in range(S):
            nxt = next(feeds[i], None) if live[i] else None
            if nxt is None:
                live[i] = False
                ori[i], acc[i] = zero_o, zero_a
                continue
            o, a, is_start = nxt
            if is_start and started[i]:
                sess.reset(stream=i)     # client i starts a new sequence
            started[i] = True
            ori[i], acc[i] = o, a
            act_vec[i] = 1.0
            active += 1
        if active == 0:
            break
        t = _time.perf_counter()
        if args.pipelined:
            # submit-side latency; device execution overlaps the next
            # window's host work (see StreamingCascade.step_async)
            sess.step_async(ori, acc)
            total_frames += active * W
        elif lookahead or history:
            # per-slot buffered emission: count only EMITTED frames
            _, emitted = sess.step(ori, acc, active=act_vec)
            total_frames += int(emitted.sum()) * W
        else:
            sess.step(ori, acc)
            total_frames += active * W
        latencies.append(_time.perf_counter() - t)
        ticks += 1
    if lookahead and ticks:
        # drain each slot's buffered tail
        t = _time.perf_counter()
        tails = sess.flush()
        latencies.append(_time.perf_counter() - t)
        total_frames += sum(0 if tl is None else len(tl)
                            for tl in (tails if isinstance(tails, list)
                                       else [tails]))
    if args.pipelined and ticks:
        # drain the last in-flight window inside the timing, so that
        # frames_per_sec counts only executed-and-fetched work
        t = _time.perf_counter()
        sess.flush()
        latencies.append(_time.perf_counter() - t)

    if ticks == 0:
        print(_json.dumps({
            "streams": S, "window": W, "windows": 0,
            "error": f"no sequence reaches the {W}-frame window; "
                     f"use a smaller --window"}))
        return
    lat = np.asarray(latencies) * 1e3
    print(_json.dumps({
        "streams": S,
        "window": W,
        "pipelined": bool(args.pipelined),   # latency = submit-side then
        "lookahead": lookahead,
        "history": history,
        "windows": ticks,
        "latency_ms_mean": round(float(lat.mean()), 3),
        "latency_ms_p50": round(float(np.percentile(lat, 50)), 3),
        "latency_ms_p99": round(float(np.percentile(lat, 99)), 3),
        "frames_per_sec": round(total_frames / max(lat.sum() / 1e3, 1e-9),
                                1),
    }))


def cmd_export(args):
    r"""Deployment export: the windowed streaming program (normalize →
    scatter → 3 stages → IK, carried state, per-slot masking; or the one
    DIP net) as a ``torch.export`` artifact directory, with the
    parameters, the stats and the body model's tree baked in. It runs with
    torch and this package alone: no checkpoint, stats or SMPL file. Export
    on the card (the default ``--device``) to serve there."""
    _apply_quality(args)
    _note_ignored_flags(args)
    _note_export_flags(args)
    from a3gc_tpu_torch._device import resolve_device
    from a3gc_tpu_torch.export import (export_bundle,
                                       export_streaming_cascade,
                                       export_streaming_dip,
                                       lookahead_geometries, save_exported)

    device = resolve_device(args.device)
    model = _load_body_model(args, device)
    cascade, is_graph = _stage_configs(args)
    if cascade is None:
        # the single DIP net: stats are baked in unconditionally (the DIP
        # input always normalizes)
        stats = _load_stats(args)
        _require(stats is not None,
                 "dip export needs normalization stats (the shipped stats "
                 "assets, or stats under --data_root)")
        net_cfg, net_params = _load_dip(args, device, allow_init=True)
    else:
        net_cfg, net_params = cascade, _load_cascade_params(
            args, cascade, is_graph, device)
        stats = _load_stats(args) if args.norm else None
        _require(stats is not None or not args.norm,
                 "--norm needs the shipped stats assets "
                 "(a3gc_tpu_torch/assets/stats)")

    geometries = [(s, w) for s in args.streams for w in args.window]
    if args.lookahead or args.history:
        # lookahead/history serving needs the emission and flush window
        # multiples; appended, so the bundle's first entry stays the
        # user's first (streams, window), which select() defaults to
        extra = [g for w in args.window
                 for g in lookahead_geometries(args.streams, w,
                                               args.lookahead,
                                               args.history)]
        seen = set(geometries)
        for g in extra:     # window multiples of different --window
            if g not in seen:   # values coincide
                geometries.append(g)
                seen.add(g)
    if len(geometries) > 1:
        export_bundle(args.output, net_params, net_cfg, model, geometries,
                      stats=stats, normalize=args.norm)
        total = sum(os.path.getsize(os.path.join(dp, f))
                    for dp, _, fs in os.walk(args.output) for f in fs)
        print(f"exported bundle of {len(geometries)} geometries "
              f"{geometries} (device={device}) -> {args.output} "
              f"({total:,} bytes)")
        return

    (streams, window), = geometries
    if cascade is None:
        ep, manifest = export_streaming_dip(
            net_params, net_cfg, model, window=window, streams=streams,
            stats=stats)
    else:
        ep, manifest = export_streaming_cascade(
            net_params, net_cfg, model, window=window, streams=streams,
            stats=stats, normalize=args.norm)
    save_exported(args.output, ep, manifest)
    sizes = {f: os.path.getsize(os.path.join(args.output, f))
             for f in os.listdir(args.output)}
    print(f"exported {manifest['family']} "
          f"{'net' if cascade is None else 'cascade'} "
          f"(window={manifest['window']}, streams={manifest['streams']}, "
          f"device={manifest['device']}) -> {args.output} "
          f"({sum(sizes.values()):,} bytes)")


def _report_path(args, dataset, tag=""):
    return os.path.join("evaluation_results",
                        f"{args.model}_{os.path.basename(dataset)}{tag}.txt")


def _streaming_tag(args):
    return (f"stream{args.streaming}"
            + (f"_K{args.lookahead}" if args.lookahead else "")
            + (f"_P{args.history}" if args.history else ""))


def cmd_evaluate(args):
    r"""Evaluation on test sets (``--datasets``, npz files of ``preprocess
    --split test``): the reference's 5-metric table per set, printed and
    appended to ``evaluation_results/<model>_<set>.txt``. The reference's
    per-sequence protocol by default; ``--batch_streams N`` folds N
    sequences of a length bucket into one call; ``--streaming W`` (or
    ``--quality``) feeds W-frame windows through the serving sessions;
    ``--save_preds`` dumps per-sequence poses."""
    from a3gc_tpu_torch._device import resolve_device
    from a3gc_tpu_torch.data.factory.dipimu import load_test_sequences
    from a3gc_tpu_torch.eval import CascadeEvaluator, evaluate_sequences
    from a3gc_tpu_torch.metrics import PoseEvaluator
    from a3gc_tpu_torch.utils import write_eval_report

    _apply_quality(args)
    _refuse_waiting_flags(args)
    _note_ignored_flags(args)
    _require(args.batch_streams >= 1, "--batch_streams must be >= 1")
    for dataset in args.datasets:
        _require(os.path.isfile(dataset), f"no test set {dataset}")
    device = resolve_device(args.device)
    model = _load_body_model(args, device)
    if args.model == "dip":
        return _evaluate_dip(args, model, device)

    cascade, is_graph = _stage_configs(args)
    params3 = _load_cascade_params(args, cascade, is_graph, device)
    stats = _load_stats(args) if args.norm else None
    _require(stats is not None or not args.norm,
             "--norm needs the shipped stats assets "
             "(a3gc_tpu_torch/assets/stats) or stats under --data_root")
    if args.save_preds and args.batch_streams > 1:
        print("[a3gc_tpu_torch] --save_preds dumps per-sequence predictions "
              "and runs the per-sequence protocol; --batch_streams is "
              "ignored", file=sys.stderr)
    if (args.lookahead or args.history) and not args.streaming:
        print("[a3gc_tpu_torch] --lookahead/--history only apply to "
              "--streaming evaluation; ignored (offline evaluation always "
              "sees the full sequence)", file=sys.stderr)
    if args.streaming and args.save_preds:
        print("[a3gc_tpu_torch] --save_preds runs the offline per-sequence "
              "protocol; --streaming is ignored", file=sys.stderr)
    for dataset in args.datasets:
        sequences = load_test_sequences(dataset)
        ev = CascadeEvaluator(params3, cascade, model, stats, args.norm,
                              device=device)
        if args.save_preds:
            import pickle
            from a3gc_tpu_torch.eval import reduced_to_full
            ev.warmup([s["ori"].shape[0] for s in sequences])
            mean, seconds, frames, preds = ev.evaluate(sequences,
                                                       return_preds=True)
            ds = "dip" if "dip" in dataset else "tc"
            base = os.path.join("evaluation_results", "sequences", ds,
                                args.model)
            for sub in ("gt", "pred"):
                os.makedirs(os.path.join(base, sub), exist_ok=True)
            for i, (seq, pred) in enumerate(zip(sequences, preds)):
                gt = reduced_to_full(seq["pose"].reshape(-1, 15, 3, 3))
                for sub, arr in (("gt", gt), ("pred", pred)):
                    with open(os.path.join(base, sub, f"{i:03d}.p"),
                              "wb") as f:
                        pickle.dump(arr, f)
            write_eval_report(_report_path(args, dataset), dataset, seconds,
                              mean, PoseEvaluator.METRIC_NAMES)
        elif args.streaming:
            mean, seconds, frames = ev.evaluate_streaming(
                sequences, window=args.streaming, lookahead=args.lookahead,
                history=args.history, batch_streams=args.batch_streams)
            tag = _streaming_tag(args)
            write_eval_report(_report_path(args, dataset, f"_{tag}"),
                              f"{dataset} [{tag}]", seconds, mean,
                              PoseEvaluator.METRIC_NAMES)
        elif args.batch_streams > 1:
            ev.warmup([s["ori"].shape[0] for s in sequences])
            mean, seconds, frames = ev.evaluate_batched(
                sequences, streams=args.batch_streams)
            write_eval_report(_report_path(args, dataset), dataset, seconds,
                              mean, PoseEvaluator.METRIC_NAMES)
        else:
            mean, seconds, frames = evaluate_sequences(
                params3, cascade, model, sequences, stats=stats,
                normalize=args.norm, report_path=_report_path(args, dataset),
                dataset_name=dataset, device=device)
        print(f"== {dataset}: {frames} frames in {seconds:.3f}s "
              f"({frames / max(seconds, 1e-9):,.0f} frames/s)")
        print(PoseEvaluator.format(mean))


def _evaluate_dip(args, model, device):
    r"""Single-net DIP evaluation, offline or (``--streaming``) through the
    net's online mode; printed, as the JAX CLI does."""
    from a3gc_tpu_torch.data.factory.dipimu import load_test_sequences
    from a3gc_tpu_torch.eval import DipEvaluator
    from a3gc_tpu_torch.metrics import PoseEvaluator

    cfg, params = _load_dip(args, device)
    stats = _load_stats(args)
    _require(stats is not None,
             "DIP evaluation needs normalization stats (the shipped stats "
             "assets, or stats under --data_root)")
    ev = DipEvaluator(params, cfg, model, stats, device=device)
    for dataset in args.datasets:
        sequences = load_test_sequences(dataset)
        if args.streaming:
            mean, seconds, frames = ev.evaluate_streaming(
                sequences, window=args.streaming, lookahead=args.lookahead,
                history=args.history, batch_streams=args.batch_streams)
            print(f"== {dataset} [{_streaming_tag(args)}]: {frames} "
                  f"frames in {seconds:.3f}s")
        else:
            mean, seconds, frames = ev.evaluate(sequences)
            print(f"== {dataset}: {frames} frames in {seconds:.3f}s")
        print(PoseEvaluator.format(mean))


def cmd_convert(args):
    r"""Checkpoint conversion, both ways: ``--torch X.tar`` → a checkpoint
    directory of the port's format (``--output``); ``--to_torch DIR`` (the
    port's format) → a reference ``.tar`` (``--output``), for a net of
    ``--n_input`` / ``--n_output`` / ``--hu1``."""
    import torch

    from a3gc_tpu_torch.compat.torch_export import (
        dip_state_dict, graph_net_state_dict, save_torch_checkpoint)
    from a3gc_tpu_torch.compat.torch_import import (
        dip_params_from_state_dict, graph_net_params_from_state_dict,
        load_torch_checkpoint)
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
    from a3gc_tpu_torch.utils import restore_params, write_params

    dense = args.model in ("tp", "dip")
    if args.to_torch:
        if dense:
            cfg = PoseNetConfig(net=N.DIPConfig(
                n_input=args.n_input, n_output=args.n_output,
                n_hidden=args.hu1))
        else:
            cfg = PoseNetConfig(net=N.GraphNetConfig(
                cell=args.model, units_in=args.n_input,
                units_out=args.n_output, units_hidden=args.hu1))
        template = init_pose_net(torch.Generator().manual_seed(0), cfg,
                                 load_adjacency_template())
        try:
            params = restore_params(args.to_torch, template)
        except (ValueError, FileNotFoundError) as e:
            raise SystemExit(f"error: {e}")
        sd = (dip_state_dict(params) if dense
              else graph_net_state_dict(params, args.model))
        save_torch_checkpoint(args.output, sd, epoch=args.epoch)
        print(f"exported {args.to_torch} ({len(sd)} tensors) -> "
              f"{args.output}")
        return
    _require(args.torch, "give --torch (import) or --to_torch (export)")
    _require(os.path.isfile(args.torch), f"no checkpoint file {args.torch}")
    sd = load_torch_checkpoint(args.torch)
    params = (dip_params_from_state_dict(sd, device="cpu") if dense
              else graph_net_params_from_state_dict(sd, args.model,
                                                    device="cpu"))
    write_params(os.path.abspath(args.output), params, epoch=args.epoch)
    n = sum(t.numel() for t in params.parameters())
    print(f"converted {args.torch} ({n:,} params) -> {args.output}")


def build_parser():
    p = argparse.ArgumentParser(
        prog="a3gc_tpu_torch",
        description="PyTorch/CUDA port of a3gc_tpu: pose serving and "
                    "streaming, deployment export, evaluation and "
                    "checkpoint conversion")
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
                    help="serve a `cli export` deployment artifact "
                         "(geometry from its manifest, --streams/--window "
                         "select within a bundle; no checkpoint, stats or "
                         "SMPL file)")
    sv.add_argument("--path", type=str, default="",
                    help="serve the latest checkpoints of this directory "
                         "(checkpoint_model{stage}_{type}_{epoch}, the "
                         "port's format; POST /v1/reload re-discovers)")
    sv.add_argument("--torch_checkpoints", nargs="+", default=None,
                    help="serve reference .tar checkpoints: one per stage "
                         "of a cascade, one for --model dip")
    sv.add_argument("--type", choices=("pretrain", "finetuning"),
                    default="finetuning",
                    help="the phase --path discovery takes")
    sv.add_argument("--mid1", type=int, default=-1,
                    help="pin stage 1 (the DIP net) to this epoch")
    sv.add_argument("--mid2", type=int, default=-1)
    sv.add_argument("--mid3", type=int, default=-1)
    _add_quality_flag(sv)
    sv.set_defaults(fn=cmd_serve)

    st = sub.add_parser("stream", help="online streaming inference "
                        "(windowed, carried recurrent state)")
    _add_common_model_flags(st)
    st.add_argument("--input", type=str, required=True,
                    help="packed test npz (from preprocess)")
    st.add_argument("--window", type=int, default=None,
                    help="frames per streaming window (default 60 = 1 s "
                         "at 60 fps; with --artifact: bundle geometry "
                         "selector)")
    st.add_argument("--output", type=str, default="",
                    help="npz to write predicted pose sequences to")
    st.add_argument("--pipelined", action="store_true",
                    help="overlap device execution with the host round-trip "
                         "(results lag one window; StreamingCascade."
                         "step_async)")
    st.add_argument("--lookahead", type=int, nargs="?", const=1,
                    default=None, metavar="K",
                    help="K-window lookahead (bare flag = 1): each emitted "
                         "window's backward direction also sees the next K "
                         "windows, at K windows of latency")
    st.add_argument("--evaluate", action="store_true",
                    help="after streaming, score the emissions against "
                         "the npz ground truth with the reference 5-metric "
                         "table")
    st.add_argument("--history", type=int, nargs="?", const=1,
                    default=None, metavar="P",
                    help="P-window history (bare flag = 1): each emission "
                         "re-runs up to P already-emitted past windows as "
                         "leading context, at no added latency")
    st.add_argument("--streams", type=int, default=None,
                    help="multiplex N independent clients through one "
                         "multi-stream step (per-client state and reset); "
                         "aggregate stats printed (with --artifact: bundle "
                         "geometry selector)")
    st.add_argument("--mesh", action="store_true",
                    help="not ported yet: " + _WAITS_FOR["mesh"])
    st.add_argument("--artifact", type=str, default="",
                    help="stream through a `cli export` deployment artifact "
                         "(geometry from its manifest; ignores checkpoint, "
                         "stats and model flags)")
    st.add_argument("--path", type=str, default="")
    st.add_argument("--torch_checkpoints", nargs="+", default=None)
    st.add_argument("--type", choices=("pretrain", "finetuning"),
                    default="finetuning")
    st.add_argument("--mid1", type=int, default=-1)
    st.add_argument("--mid2", type=int, default=-1)
    st.add_argument("--mid3", type=int, default=-1)
    _add_quality_flag(st)
    st.set_defaults(fn=cmd_stream)

    ex = sub.add_parser("export", help="deployment export: the streaming "
                        "program as a torch.export artifact (params, stats "
                        "and body tree baked in)")
    _add_common_model_flags(ex)
    ex.add_argument("--output", type=str, required=True,
                    help="artifact directory to write")
    ex.add_argument("--window", type=int, nargs="+", default=[60],
                    help="window size(s); several values (or several "
                         "--streams) produce a multi-geometry BUNDLE: one "
                         "directory indexing a sub-artifact per "
                         "(streams, window) pair")
    ex.add_argument("--streams", type=int, nargs="+", default=[1],
                    help="serving slots of the program (several values -> "
                         "bundle)")
    ex.add_argument("--lookahead", type=int, default=None, metavar="K",
                    help="also export the window multiples a lookahead-K "
                         "deployment needs ({W..(K+1)W} per stream count) "
                         "so `serve/stream --artifact --lookahead K` can "
                         "run buffered emissions from the bundle")
    ex.add_argument("--history", type=int, default=None, metavar="P",
                    help="also export the window multiples a history-P "
                         "deployment needs ({W..(P+K+1)W} per stream "
                         "count) for `serve/stream --artifact --history`")
    ex.add_argument("--backend", choices=("xla", "pallas"), default="xla",
                    help="accepted for the JAX CLI's command lines and "
                         "ignored (how XLA lowers the JAX artifact); a port "
                         "artifact holds the kernel ops")
    ex.add_argument("--platforms", nargs="+", default=None,
                    help="accepted and ignored (the JAX artifact's lowering "
                         "platforms); the artifact runs on --device")
    ex.add_argument("--path", type=str, default="")
    ex.add_argument("--torch_checkpoints", nargs="+", default=None)
    ex.add_argument("--type", choices=("pretrain", "finetuning"),
                    default="finetuning")
    ex.add_argument("--mid1", type=int, default=-1)
    ex.add_argument("--mid2", type=int, default=-1)
    ex.add_argument("--mid3", type=int, default=-1)
    _add_quality_flag(ex)
    ex.set_defaults(fn=cmd_export)

    e = sub.add_parser("evaluate", help="cascade evaluation on test sets")
    _add_common_model_flags(e)
    e.add_argument("--path", type=str, default="",
                   help="directory of the port's checkpoints")
    e.add_argument("--torch_checkpoints", nargs="+", default=None,
                   help="reference .tar checkpoints (stages 1 2 3; just one "
                        "for --model dip)")
    e.add_argument("--type", choices=("pretrain", "finetuning"),
                   default="finetuning")
    e.add_argument("--mid1", type=int, default=-1)
    e.add_argument("--mid2", type=int, default=-1)
    e.add_argument("--mid3", type=int, default=-1)
    e.add_argument("--datasets", nargs="+", required=True,
                   help="test npz files (from preprocess --split test)")
    e.add_argument("--save_preds", action="store_true",
                   help="dump per-sequence gt/pred poses under "
                        "evaluation_results/sequences")
    e.add_argument("--batch_streams", type=int, default=1,
                   help="evaluate N sequences of a length bucket per call "
                        "of the cascade (1 = the reference's per-sequence "
                        "protocol); with --streaming: N session slots")
    e.add_argument("--mesh", action="store_true",
                   help="not ported yet: " + _WAITS_FOR["mesh"])
    _add_quality_flag(e)
    e.add_argument("--streaming", type=int, default=0, metavar="W",
                   help="evaluate through the online path: feed each "
                        "sequence as W-frame windows with carried state "
                        "(the cli serve code path) and score the emissions "
                        "with the same 5-metric table")
    e.add_argument("--lookahead", type=int, default=None, metavar="K",
                   help="with --streaming: buffer K future windows before "
                        "each emission (+K windows latency)")
    e.add_argument("--history", type=int, default=None, metavar="P",
                   help="with --streaming: re-run up to P past windows as "
                        "leading context per emission (no added latency)")
    e.set_defaults(fn=cmd_evaluate)

    c = sub.add_parser("convert-checkpoint",
                       help="reference .tar <-> a checkpoint directory of "
                            "the port (both ways)")
    c.add_argument("--torch", type=str, default="",
                   help="reference .tar to IMPORT (-> --output directory)")
    c.add_argument("--to_torch", type=str, default="",
                   help="a checkpoint directory of the port to EXPORT as a "
                        "reference .tar (-> --output; set --n_input/"
                        "--n_output/--hu1 to the net's sizes)")
    c.add_argument("--model", choices=MODEL_CHOICES, required=True)
    c.add_argument("--output", type=str, required=True)
    c.add_argument("--n_input", type=int, default=15)
    c.add_argument("--n_output", type=int, default=9)
    c.add_argument("--hu1", type=int, default=128,
                   help="hidden units of the exported net")
    c.add_argument("--epoch", type=int, default=0,
                   help="epoch number recorded in the written checkpoint")
    c.add_argument("--compilation_cache", type=str, default=None,
                   metavar="DIR", help="accepted and ignored")
    c.set_defaults(fn=cmd_convert)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
