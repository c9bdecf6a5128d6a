"""The port's command line (a3gc_tpu_torch.cli, the ``serve`` subcommand):
its parser's defaults and quality presets against the JAX package's for the
flags both have (every flag of the JAX CLI's ``serve``), the flags that wait
for later slices, the JAX-only flags it accepts and ignores, and one
end-to-end
state-preserving exec-recycle of ``python -m a3gc_tpu_torch.cli serve
--device cpu`` at small widths: the clients ride the pause with their seq
and token, and the poses equal an uninterrupted in-process session's at
1e-6 (the same code on the same weights)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from a3gc_tpu import cli as JCLI
from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.client import PoseClient
from a3gc_tpu_torch.eval.streaming import StreamingCascade
from a3gc_tpu_torch.smpl import ParametricModel

# tiny tensors: intra-op threads would only contend with the other test
# workers' (and the server's handler threads)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED_FLAGS = ("model", "hu1", "hu2", "hu3", "norm", "cda", "rotsize",
                "window", "streams", "host", "port", "max_wait_ms",
                "lookahead", "history", "quality", "recycle_rss_mb", "mesh",
                "artifact", "path", "torch_checkpoints", "type", "mid1",
                "mid2", "mid3", "smpl", "data_root", "precision", "profile",
                "debug_nans", "compilation_cache")


@pytest.mark.parametrize("argv", [
    [], ["--quality", "balanced"], ["--quality", "latency"],
    ["--quality", "max", "--history", "0"],
    ["--quality", "ultra", "--window", "30", "--lookahead", "0"],
    ["--lookahead", "2"], ["--model", "ggru", "--hu1", "32", "--norm",
                           "--cda", "--streams", "4", "--port", "0"],
    ["--path", "runs/x", "--type", "pretrain", "--mid1", "3", "--mid2",
     "4", "--mid3", "5"],
    ["--model", "dip", "--torch_checkpoints", "dip.tar", "--smpl", "m.pkl",
     "--data_root", "d", "--precision", "highest", "--profile", "p",
     "--debug_nans", "--compilation_cache", "c"],
])
def test_torch_port_cli_serve_flags_match_jax_cli(argv):
    ours = TCLI.build_parser().parse_args(["serve"] + argv)
    ref = JCLI.build_parser().parse_args(["serve"] + argv)
    assert ours.fn is TCLI.cmd_serve and ours.device == "cuda"
    for flag in SHARED_FLAGS:
        assert getattr(ours, flag) == getattr(ref, flag), flag
    TCLI._apply_quality(ours)
    JCLI._apply_quality(ref)
    for flag in ("window", "lookahead", "history"):
        assert getattr(ours, flag) == getattr(ref, flag), flag
    assert TCLI.QUALITY_PRESETS == JCLI.QUALITY_PRESETS
    assert TCLI.MODEL_CHOICES == JCLI.MODEL_CHOICES


@pytest.mark.parametrize("model", ["a3gc", "aagc", "agc", "ggru", "tp"])
def test_torch_port_cli_stage_configs_match_jax_cli(model):
    argv = ["serve", "--model", model, "--hu1", "24", "--hu2", "16",
            "--hu3", "8", "--rotsize", "6"]
    ours, our_graph = TCLI._stage_configs(
        TCLI.build_parser().parse_args(argv))
    ref, ref_graph = JCLI._stage_configs(
        JCLI.build_parser().parse_args(argv))
    assert our_graph == ref_graph == (model != "tp")
    for a, b in zip(ours.stages, (ref.stage1, ref.stage2, ref.stage3)):
        assert a.rotsize == b.rotsize
        fields = (("cell", "units_in", "units_out", "units_hidden",
                   "num_nodes") if our_graph else
                  ("n_input", "n_output", "n_hidden", "n_layers",
                   "bidirectional"))
        for f in fields:
            assert getattr(a.net, f) == getattr(b.net, f), f


def test_torch_port_cli_shipped_stats_match_jax_cli():
    for argv in (["serve"], ["serve", "--cda"]):
        ours = TCLI._load_stats(TCLI.build_parser().parse_args(argv))
        ref = JCLI._load_stats(JCLI.build_parser().parse_args(argv))
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("argv,item", [
    (["--smpl", "smpl_male.pkl"], "item 4"),
    (["--data_root", "data"], "item 4"),
    (["--artifact", "bundle"], "item 13"),
    (["--mesh"], "item 14"),
    (["--model", "dip", "--data_root", "data"], "item 4"),
])
def test_torch_port_cli_refuses_flags_of_later_slices(argv, item):
    with pytest.raises(SystemExit) as ei:
        TCLI.main(["serve", "--device", "cpu"] + argv)
    assert "ROADMAP Queue 1 " + item in str(ei.value)


@pytest.mark.parametrize("argv,noted", [
    (["--precision", "default"], ["--precision default", "fp32"]),
    (["--precision", "highest", "--profile", "trace", "--debug_nans",
      "--compilation_cache", "cache"],
     ["--profile", "--debug_nans", "--compilation_cache",
      "--precision highest"]),
    ([], []),
])
def test_torch_port_cli_notes_jax_only_flags_once(argv, noted, capsys):
    args = TCLI.build_parser().parse_args(["serve"] + argv)
    TCLI._note_ignored_flags(args)
    err = capsys.readouterr().err
    assert err.count("\n") == (1 if noted else 0)
    for word in noted:
        assert word in err


def test_torch_port_cli_has_serve_only_and_require_exits():
    with pytest.raises(SystemExit):
        TCLI.build_parser().parse_args(["train"])
    with pytest.raises(SystemExit, match="error: nope"):
        TCLI._require(False, "nope")
    TCLI._require(True, "fine")


def _windows(n, W, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(W, 54)).astype(np.float32),
             rng.normal(scale=0.5, size=(W, 18)).astype(np.float32))
            for _ in range(n)]


def test_torch_port_cli_exec_recycle_preserves_sessions(tmp_path):
    """``cli serve`` on the CPU in a subprocess: two clients step, POST
    /v1/recycle, the exec'd process inherits the socket, the slots, their
    carried states and buffered windows, the seq cache and the tokens; the
    next windows equal an uninterrupted local session's."""
    W, K, P = 6, 1, 1
    argv = ["--hu1", "8", "--hu2", "8", "--hu3", "8", "--norm", "--window",
            str(W), "--streams", "2", "--port", "0", "--lookahead", str(K),
            "--history", str(P), "--max_wait_ms", "2", "--device", "cpu"]
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": REPO,
           "HOME": os.environ.get("HOME", "/"), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "a3gc_tpu_torch.cli", "serve"] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()
        info = json.loads(line)
        assert (info["streams"], info["window"]) == (2, W)
        host, port = info["serving"].rsplit("//", 1)[1].rsplit(":", 1)

        # the oracle: the same fresh init the CLI serves
        args = TCLI.build_parser().parse_args(["serve"] + argv)
        TCLI._apply_quality(args)
        cascade, is_graph = TCLI._stage_configs(args)
        params3 = TCLI._init_cascade_params(cascade, is_graph, "cpu")
        feeds = [_windows(5, W, seed=80 + i) for i in range(2)]
        refs = [StreamingCascade(params3, cascade, ParametricModel(),
                                 window=W, stats=TCLI._load_stats(args),
                                 normalize=True, lookahead=K, history=P,
                                 device="cpu") for _ in range(2)]
        clients = [PoseClient(host, int(port), timeout=60.0, retry_s=120.0,
                              retry_interval=0.2) for _ in range(2)]
        for c in clients:
            c.acquire()
        assert sorted(c.slot for c in clients) == [0, 1]

        def step_all(w):
            poses = []
            for c, ref, feed in zip(clients, refs, feeds):
                got, want = c.step(*feed[w]), ref.step(*feed[w])
                assert (got is None) == (want is None) == (w < K)
                if want is not None:
                    np.testing.assert_allclose(got, want, atol=1e-6,
                                               err_msg=f"window {w}")
                poses.append(got)
            return poses

        for w in range(3):
            before = step_all(w)
        clients[0].recycle()
        # a retry of the last applied seq, across the exec: answered from
        # the carried cache, not applied to the restored state again
        clients[0]._seq -= 1
        np.testing.assert_array_equal(clients[0].step(*feeds[0][2]),
                                      before[0])
        for w in (3, 4):
            step_all(w)
        stats = clients[1].stats()       # answered by the new generation
        assert stats["active_sessions"] == 2 and stats["errors"] == 0
        assert stats["ticks"] <= 4       # its counters began anew
        for c, ref in zip(clients, refs):
            np.testing.assert_allclose(c.flush(), ref.flush(), atol=1e-6)
            c.release()
        assert proc.poll() is None       # the same pid serves on
    finally:
        proc.kill()
        proc.wait()
        err = proc.stderr.read()
    assert "recycled: restored 2 live session(s)" in err, err
