"""The port's ``export`` and ``stream`` subcommands and ``serve --artifact``
(a3gc_tpu_torch.cli) on the CPU: their parsers against the JAX CLI's,
``cli export`` of an artifact and of a K = 1 bundle, servers built on them
through ``cli._build_server`` with two clients against live sessions, and
``cli stream`` on the same ``.tar`` checkpoints as the JAX CLI's ``stream``
(its ``--output`` npz within 1e-4), live and through an artifact.

Widths: hidden 8, W = 4 frames, S ≤ 2 slots."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from a3gc_tpu import cli as JCLI
from a3gc_tpu.compat import torch_export as JE
from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.client import PoseClient
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.eval.streaming import StreamingCascade
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import cascades, eval_sequences

# tiny tensors: intra-op threads would only contend with the other test
# workers' (and the server's handler threads)
torch.set_num_threads(1)

W, H = 4, 8
POSE_TOL = 1e-4
LIVE_TOL = 1e-6
WIDTH = ["--hu1", str(H), "--hu2", str(H), "--hu3", str(H)]
EXPORT_FLAGS = ("model", "hu1", "hu2", "hu3", "norm", "cda", "rotsize",
                "output", "window", "streams", "lookahead", "history",
                "backend", "platforms", "path", "torch_checkpoints", "type",
                "mid1", "mid2", "mid3", "quality", "smpl", "data_root",
                "precision", "profile", "debug_nans", "compilation_cache")
STREAM_FLAGS = ("model", "hu1", "hu2", "hu3", "norm", "cda", "rotsize",
                "input", "window", "output", "pipelined", "lookahead",
                "evaluate", "history", "streams", "mesh", "artifact", "path",
                "torch_checkpoints", "type", "mid1", "mid2", "mid3",
                "quality", "smpl", "data_root", "precision", "profile",
                "debug_nans", "compilation_cache")


@pytest.mark.parametrize("argv", [
    ["--output", "o"],
    ["--output", "o", "--window", "30", "60", "--streams", "1", "8",
     "--lookahead", "1", "--history", "2", "--backend", "pallas",
     "--platforms", "tpu"],
    ["--output", "o", "--model", "dip", "--hu1", "512", "--quality",
     "balanced", "--torch_checkpoints", "d.tar"],
    ["--output", "o", "--path", "runs/x", "--type", "pretrain", "--mid1",
     "2", "--norm", "--cda", "--rotsize", "6"],
])
def test_torch_port_cli_export_flags_match_jax_cli(argv):
    ours = TCLI.build_parser().parse_args(["export"] + argv)
    ref = JCLI.build_parser().parse_args(["export"] + argv)
    assert ours.fn is TCLI.cmd_export and ours.device == "cuda"
    for flag in EXPORT_FLAGS:
        assert getattr(ours, flag) == getattr(ref, flag), flag
    TCLI._apply_quality(ours)
    JCLI._apply_quality(ref)
    for flag in ("window", "lookahead", "history"):
        assert getattr(ours, flag) == getattr(ref, flag), flag


@pytest.mark.parametrize("argv", [
    ["--input", "t.npz"],
    ["--input", "t.npz", "--lookahead", "--history", "--window", "30",
     "--output", "p.npz", "--evaluate"],
    ["--input", "t.npz", "--pipelined", "--streams", "4", "--mesh",
     "--artifact", "a", "--quality", "max", "--model", "ggru"],
])
def test_torch_port_cli_stream_flags_match_jax_cli(argv):
    ours = TCLI.build_parser().parse_args(["stream"] + argv)
    ref = JCLI.build_parser().parse_args(["stream"] + argv)
    assert ours.fn is TCLI.cmd_stream
    for flag in STREAM_FLAGS:
        assert getattr(ours, flag) == getattr(ref, flag), flag
    TCLI._apply_quality(ours)
    JCLI._apply_quality(ref)
    for flag in ("window", "lookahead", "history"):
        assert getattr(ours, flag) == getattr(ref, flag), flag


def test_torch_port_cli_export_notes_jax_only_flags_once(tmp_path, capsys):
    TCLI._note_export_flags(TCLI.build_parser().parse_args(
        ["export", "--output", "o", "--backend", "pallas", "--platforms",
         "tpu"]))
    err = capsys.readouterr().err
    assert err.count("[a3gc_tpu_torch] ignoring") == 1
    assert "--backend pallas" in err and "--platforms tpu" in err
    TCLI._note_export_flags(TCLI.build_parser().parse_args(
        ["export", "--output", "o"]))
    assert capsys.readouterr().err == ""


def _cli_params():
    """The cascade ``cli`` builds without checkpoints: stage i from
    ``torch.Generator`` seed i."""
    args = TCLI.build_parser().parse_args(["serve"] + WIDTH)
    cascade, is_graph = TCLI._stage_configs(args)
    return cascade, TCLI._init_cascade_params(cascade, is_graph, "cpu")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``cli export`` of a plain S = 2 artifact and of a K = 1 bundle of
    S = 1 and 2."""
    root = tmp_path_factory.mktemp("cli_export")
    plain, bundle = str(root / "plain"), str(root / "bundle")
    base = ["export", "--device", "cpu", "--norm", "--window", str(W)] \
        + WIDTH
    TCLI.main(base + ["--streams", "2", "--output", plain])
    TCLI.main(base + ["--streams", "1", "2", "--lookahead", "1",
                      "--output", bundle])
    return plain, bundle


def test_torch_port_cli_export_writes_an_artifact_and_a_bundle(exported):
    from a3gc_tpu_torch.export import ArtifactSession, load_exported
    plain, bundle = exported
    with open(os.path.join(plain, "manifest.json")) as f:
        man = json.load(f)
    assert (man["family"], man["streams"], man["window"],
            man["normalized"]) == ("a3gc", 2, W, True)
    with open(os.path.join(bundle, "bundle.json")) as f:
        index = json.load(f)
    assert [(g["streams"], g["window"]) for g in index["geometries"]] == [
        (1, W), (2, W), (1, 2 * W), (2, 2 * W)]
    cascade, params3 = _cli_params()
    rng = np.random.default_rng(0)
    for d, S in ((plain, 2), (bundle, 1)):
        sess = ArtifactSession(load_exported(d, device="cpu"))
        live = StreamingCascade(params3, cascade, ParametricModel(),
                                window=W, stats=load_stats(),
                                normalize=True, streams=S, device="cpu")
        for _ in range(3):
            ori = rng.normal(size=(S, W, 54)).astype(np.float32)
            acc = rng.normal(size=(S, W, 18)).astype(np.float32)
            np.testing.assert_allclose(sess.step(ori, acc),
                                       live.step(ori, acc), atol=LIVE_TOL)


def _windows(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(W, 54)).astype(np.float32),
             rng.normal(scale=0.5, size=(W, 18)).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["plain", "balanced"])
def test_torch_port_cli_serve_artifact_with_two_clients(mode, exported):
    """``serve --artifact`` built by ``cli._build_server``: two clients,
    each against a single-slot live session on the same params — plain
    windows from the S = 2 artifact, and ``--lookahead 1`` from the
    bundle."""
    plain, bundle = exported
    argv = ["serve", "--device", "cpu", "--port", "0", "--max_wait_ms",
            "2"]
    K = 0
    if mode == "plain":
        argv += ["--artifact", plain]
    else:
        K = 1
        argv += ["--artifact", bundle, "--streams", "2", "--window",
                 str(W), "--lookahead", "1"]
    args = TCLI.build_parser().parse_args(argv)
    TCLI._apply_quality(args)
    srv, streams, window = TCLI._build_server(args)
    assert (streams, window) == (2, W)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    cascade, params3 = _cli_params()
    refs = [StreamingCascade(params3, cascade, ParametricModel(), window=W,
                             stats=load_stats(), normalize=True,
                             lookahead=K, device="cpu") for _ in range(2)]
    feeds = [_windows(4, seed) for seed in (1, 2)]
    clients = [PoseClient(*srv.address[:2], timeout=30.0, retry_s=5.0,
                          retry_interval=0.05) for _ in range(2)]
    n = 0
    try:
        for c in clients:
            c.acquire()
        for w in range(4):
            for c, ref, feed in zip(clients, refs, feeds):
                got, want = c.step(*feed[w]), ref.step(*feed[w])
                assert (got is None) == (want is None), f"window {w}"
                if want is not None:
                    np.testing.assert_allclose(got, want, atol=LIVE_TOL)
                    n += 1
        if K:
            for c, ref in zip(clients, refs):
                np.testing.assert_allclose(c.flush(), ref.flush(),
                                           atol=LIVE_TOL)
                n += 1
        stats = clients[0].stats()
        assert stats["errors"] == 0 and stats["active_sessions"] == 2
    finally:
        for c in clients:
            c.close()
        srv.shutdown()
    assert n == 8


def test_torch_port_cli_serve_artifact_refuses_what_it_lacks(exported):
    plain, bundle = exported
    for argv, match in (
            (["--artifact", plain + "_nope"], "no artifact directory"),
            (["--artifact", plain, "--streams", "3"], "geometry"),
            (["--artifact", bundle, "--lookahead", "1", "--history", "1"],
             "re-export with `cli export --streams 1 --window 4 "
             "--lookahead 1 --history 1`")):
        args = TCLI.build_parser().parse_args(
            ["serve", "--device", "cpu", "--port", "0"] + argv)
        TCLI._apply_quality(args)
        with pytest.raises(SystemExit, match=match):
            TCLI._build_server(args)


@pytest.fixture(scope="module")
def stream_case(tmp_path_factory):
    """A packed test npz of two sequences (14 and 9 frames: 3 and 2 whole
    windows), three stage ``.tar``s written by the JAX exporter, and the
    JAX CLI's ``stream --evaluate --output`` on them."""
    root = tmp_path_factory.mktemp("stream")
    seqs = eval_sequences([14, 9], seed=3)
    npz = str(root / "test.npz")
    np.savez(npz, **{f"seq{i}_{k}": s[k] for i, s in enumerate(seqs)
                     for k in ("ori", "acc", "pose")})
    _, _, params = cascades("a3gc", hidden=H)
    tars = []
    for i, p in enumerate(params):
        tars.append(str(root / f"s{i + 1}.tar"))
        JE.save_torch_checkpoint(tars[-1], JE.graph_net_state_dict(p, "a3gc"))
    out = str(root / "jax.npz")
    JCLI.main(["stream", "--input", npz, "--torch_checkpoints", *tars,
               "--norm", "--window", str(W), "--evaluate", "--output",
               out] + WIDTH)
    return root, npz, tars, dict(np.load(out))


def _stream(capsys, argv):
    capsys.readouterr()
    TCLI.main(["stream", "--device", "cpu"] + argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_outputs(path, want, tol):
    got = dict(np.load(path))
    assert sorted(got) == sorted(want) == ["pose_000", "pose_001"]
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)


def test_torch_port_cli_stream_matches_jax_cli(stream_case, capsys):
    """``stream`` on the JAX CLI's ``.tar`` checkpoints, live and through
    ``export --torch_checkpoints`` + ``stream --artifact``: the same poses
    within 1e-4, the same JSON line."""
    root, npz, tars, want = stream_case
    line = _stream(capsys, ["--input", npz, "--torch_checkpoints", *tars,
                            "--norm", "--window", str(W), "--evaluate",
                            "--output", str(root / "live.npz")] + WIDTH)
    _assert_outputs(root / "live.npz", want, POSE_TOL)
    assert set(line) == {"window", "pipelined", "lookahead", "history",
                         "evaluated_frames", "sip_deg", "windows",
                         "latency_ms_mean", "latency_ms_p50",
                         "latency_ms_p99", "frames_per_sec"}
    assert line["evaluated_frames"] == 20 and line["windows"] == 5
    art = str(root / "art")
    TCLI.main(["export", "--device", "cpu", "--torch_checkpoints", *tars,
               "--norm", "--window", str(W), "--output", art] + WIDTH)
    line = _stream(capsys, ["--input", npz, "--artifact", art, "--output",
                            str(root / "art.npz")])
    _assert_outputs(root / "art.npz", want, POSE_TOL)
    assert (line["window"], line["windows"]) == (W, 5)


@pytest.mark.parametrize("mode", ["pipelined", "streams", "buffered"])
def test_torch_port_cli_stream_modes(mode, stream_case, exported, capsys):
    """``--pipelined`` (``step_async``) emits the plain poses;
    ``--streams 2`` prints the aggregate line; ``--lookahead 1`` through
    the bundle emits what the live K = 1 session does."""
    root, npz, tars, want = stream_case
    out = str(root / f"{mode}.npz")
    ckpt = ["--torch_checkpoints", *tars, "--norm"] + WIDTH
    if mode == "pipelined":
        line = _stream(capsys, ["--input", npz, "--window", str(W),
                                "--pipelined", "--output", out] + ckpt)
        assert line["pipelined"] is True
        _assert_outputs(out, want, POSE_TOL)
    elif mode == "streams":
        line = _stream(capsys, ["--input", npz, "--window", str(W),
                                "--streams", "2"] + ckpt)
        assert (line["streams"], line["windows"]) == (2, 3)
        line = _stream(capsys, ["--input", npz, "--artifact",
                                exported[0]])
        assert (line["streams"], line["window"], line["windows"]) == (
            2, W, 3)
    else:
        _, bundle = exported
        line = _stream(capsys, ["--input", npz, "--artifact", bundle,
                                "--lookahead", "1", "--streams", "1",
                                "--output", out])
        assert line["lookahead"] == 1
        # the live K = 1 session on the params the bundle was exported
        # from (a fresh init: no checkpoint given to either)
        live_out = str(root / "buffered_live.npz")
        _stream(capsys, ["--input", npz, "--window", str(W), "--lookahead",
                         "1", "--norm", "--output", live_out] + WIDTH)
        _assert_outputs(out, dict(np.load(live_out)), LIVE_TOL)
