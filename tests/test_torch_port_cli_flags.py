"""The run-wide flags of the port's command line against the JAX CLI's
``main`` (a3gc_tpu_torch._runtime), on the CPU at hidden 8:

  * ``--profile D``: one Chrome trace under D holding the JAX-named step
    and metric spans (``jit__run``, ``jit___call__``,
    ``jit_full_motion_metrics``, ``jit_train_step``, ``jit_eval_step``,
    ``jit__step``) and the kernel op ``a3gc_tpu_torch::gcn_lstm_scan``, for
    ``evaluate``, ``train``, ``stream``, ``export`` and ``serve`` (a
    subprocess, its batcher thread traced, the trace written at SIGTERM);
    the report equals a run without the flag; the JAX CLI's ``--profile``
    on the same data exits 0 and writes under its own D;
  * ``--debug_nans``: silent on a clean ``evaluate`` and a clean one-epoch
    ``train`` (same report, same log); ``FloatingPointError`` naming the op
    in both packages for a NaN in stage 1's recurrent weight (both CLIs on
    the same ``.tar`` checkpoints) and inside a training step with a NaN in
    one target frame (both packages' stage runners); the server's batcher
    thread and a loaded ``torch.export`` program run under the check;
  * a span is a no-op without a profiler;
  * ``--compilation_cache D``: the kernel libraries' directory is D while
    the command runs;
  * after every command, ``os.environ``, the dispatch-mode stack, the
    anomaly mode and the profiler are as they were before ``main``."""

import glob
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from a3gc_tpu import cli as JCLI
from a3gc_tpu_torch import _runtime as RT
from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.compat import torch_export as TE
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.ops import _build as B

from torch_port_oracle import eval_sequences, train_runners

torch.set_num_threads(1)
# torch writes $TORCHINDUCTOR_CACHE_DIR when torch._dynamo is first imported,
# which the first command of a process does: import it before any of them,
# so that (d) holds main to what it changes itself
import torch._dynamo  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = ["--hu1", "8", "--hu2", "8", "--hu3", "8"]
SCAN = "a3gc_tpu_torch::gcn_lstm_scan"


@pytest.fixture(autouse=True)
def _no_data_root_from_earlier_tests(monkeypatch):
    # the JAX CLI's main sets $A3GC_DATA_ROOT and leaves it set
    monkeypatch.delenv("A3GC_DATA_ROOT", raising=False)


def _process_state():
    return (dict(os.environ), list(_get_current_dispatch_mode_stack()),
            torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
            torch.autograd.profiler._is_profiler_enabled)


def _main(argv, cwd):
    """``TCLI.main(argv)`` from ``cwd``; (d): the process-wide state after
    it, returned or raised, is the state before it."""
    before = _process_state()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return TCLI.main(argv)
    finally:
        os.chdir(old)
        assert _process_state() == before


def _trace(directory):
    """The one Chrome trace under ``directory``: its event names."""
    files = glob.glob(os.path.join(directory, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A test npz of two sequences, a synthetic SMPL pickle, packed train
    and valid sets, and the three stages of a fresh init as reference
    ``.tar`` checkpoints, clean and with a NaN in stage 1's recurrent
    weight."""
    from a3gc_tpu_torch.smpl import write_synthetic_smpl_pickle
    d = tmp_path_factory.mktemp("flags")
    np.savez(d / "test.npz", **{
        f"seq{i}_{k}": v for i, s in enumerate(eval_sequences([40, 30],
                                                              seed=3))
        for k, v in s.items()})
    np.savez(d / "train.npz", **synthetic_packed_dataset(4, 12, seed=0))
    np.savez(d / "valid.npz", **synthetic_packed_dataset(2, 12, seed=1))
    args = TCLI.build_parser().parse_args(["evaluate", "--datasets", "x"]
                                          + WIDTH)
    cascade, is_graph = TCLI._stage_configs(args)
    params3 = TCLI._init_cascade_params(cascade, is_graph, "cpu")
    tars = {}
    for tag in ("clean", "nan"):
        if tag == "nan":
            H = cascade.stage1.net.units_hidden
            with torch.no_grad():       # [2, F + H, 4H]: the last H rows
                params3[0].rnn1.kernel[0, -H, 0] = float("nan")
        tars[tag] = []
        for i, p in enumerate(params3):
            tars[tag].append(str(d / f"{tag}{i + 1}.tar"))
            TE.save_torch_checkpoint(tars[tag][-1],
                                     TE.graph_net_state_dict(p, "a3gc"))
    smpl = write_synthetic_smpl_pickle(str(d / "smpl.pkl"), n_vertices=96)
    # the JAX CLI's --profile traces every Python call (≈ 30 s here): it
    # runs beside the other tests, and the last one reads its result
    jax_env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1")
    jax_profile = subprocess.Popen(
        [sys.executable, "-m", "a3gc_tpu.cli", "evaluate", "--norm",
         "--smpl", smpl, "--datasets", str(d / "test.npz"),
         "--torch_checkpoints"] + tars["clean"] + WIDTH
        + ["--profile", str(d / "jax_trace")], cwd=str(d), env=jax_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield {"dir": d, "npz": str(d / "test.npz"), "smpl": smpl,
           "train": ["--train_data", str(d / "train.npz"),
                     "--valid_data", str(d / "valid.npz")],
           "tars": tars, "jax_profile": jax_profile}
    if jax_profile.poll() is None:
        jax_profile.kill()
        jax_profile.communicate()


def _evaluate(data, extra, cwd):
    return (["evaluate", "--device", "cpu", "--norm", "--smpl", data["smpl"],
             "--datasets", data["npz"], "--torch_checkpoints"]
            + data["tars"]["clean"] + WIDTH + extra)


def _tables(out):
    """The printed metric tables, without the timing lines."""
    return [line for line in out.splitlines() if not line.startswith("== ")]


@pytest.fixture(scope="module")
def plain_evaluate(data, tmp_path_factory):
    """The report of ``evaluate`` without the run-wide flags."""
    import contextlib
    import io
    cwd = tmp_path_factory.mktemp("plain_eval")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _main(_evaluate(data, [], cwd), cwd)
    return _tables(out.getvalue())


def test_torch_port_cli_profile_traces_evaluate(data, plain_evaluate,
                                                tmp_path, capsys):
    trace_dir = str(tmp_path / "trace")
    _main(_evaluate(data, ["--profile", trace_dir], tmp_path), tmp_path)
    assert _tables(capsys.readouterr().out) == plain_evaluate
    names = _trace(trace_dir)
    for span in ("jit__run", "jit___call__", "jit_full_motion_metrics",
                 SCAN):
        assert span in names, span


@pytest.mark.parametrize("cmd", ["train", "stream", "export"])
def test_torch_port_cli_profile_traces_every_command(cmd, data, tmp_path):
    trace_dir = str(tmp_path / "trace")
    argv = {"train": ["train", "-b", "4", "--epochs", "1", "--norm",
                      "--save_root", str(tmp_path / "runs")] + data["train"],
            "stream": ["stream", "--norm", "--window", "10", "--input",
                       data["npz"], "--smpl", data["smpl"]],
            "export": ["export", "--norm", "--window", "6", "--output",
                       str(tmp_path / "art"), "--smpl", data["smpl"]]}[cmd]
    _main(argv + ["--device", "cpu", "--profile", trace_dir] + WIDTH,
          tmp_path)
    names = _trace(trace_dir)
    want = {"train": ["jit_train_step", "jit_eval_step", SCAN],
            "stream": ["jit__step", SCAN], "export": []}[cmd]
    for span in want:
        assert span in names, span


def test_torch_port_cli_profile_traces_serve_until_sigterm(data, tmp_path):
    """``serve --profile``: the batcher thread's steps are in the trace,
    which the server writes when SIGTERM stops it."""
    from a3gc_tpu_torch.client import PoseClient
    trace_dir = str(tmp_path / "trace")
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": REPO,
           "HOME": os.environ.get("HOME", "/"), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "a3gc_tpu_torch.cli", "serve", "--device",
         "cpu", "--port", "0", "--streams", "2", "--window", "6", "--norm",
         "--smpl", data["smpl"], "--profile", trace_dir] + WIDTH,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()
        host, port = json.loads(line)["serving"].rsplit("//", 1)[1].rsplit(
            ":", 1)
        rng = np.random.default_rng(0)
        with PoseClient(host, int(port), timeout=60.0) as c:
            pose = c.step(rng.normal(size=(6, 54)).astype(np.float32),
                          rng.normal(size=(6, 18)).astype(np.float32))
        assert pose.shape == (6, 24, 3, 3)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 128 + signal.SIGTERM, err[-3000:]
    names = _trace(trace_dir)
    assert "jit__step" in names and SCAN in names


def test_torch_port_cli_debug_nans_is_silent_on_a_clean_evaluate(
        data, plain_evaluate, tmp_path, capsys):
    _main(_evaluate(data, ["--debug_nans"], tmp_path), tmp_path)
    assert _tables(capsys.readouterr().out) == plain_evaluate


def test_torch_port_cli_debug_nans_is_silent_on_a_clean_train(data,
                                                              tmp_path):
    logs = []
    for flag in ([], ["--debug_nans"]):
        root = str(tmp_path / f"runs{len(logs)}")
        _main(["train", "--device", "cpu", "-b", "4", "--epochs", "1",
               "--norm", "--name", "run", "--save_root", root]
              + data["train"] + WIDTH + flag, tmp_path)
        with open(os.path.join(root, "run", "train_log.jsonl")) as f:
            logs.append([[e[k] for k in ("stage", "epoch", "train_loss",
                                         "valid_loss")]
                         for e in map(json.loads, f)])
    assert len(logs[0]) == 3 and logs[0] == logs[1]


def test_torch_port_cli_debug_nans_covers_the_servers_batcher(data):
    """``serve --debug_nans``: the batcher thread, built under the check,
    steps under it too: a clean window answers, a window holding a NaN
    is refused with the op that made the NaN."""
    import threading
    from a3gc_tpu_torch.client import PoseClient, ServerError
    args = TCLI.build_parser().parse_args(
        ["serve", "--device", "cpu", "--port", "0", "--streams", "2",
         "--window", "6", "--norm", "--smpl", data["smpl"], "--debug_nans"]
        + WIDTH)
    TCLI._apply_quality(args)
    with RT.nan_check():
        srv, _, window = TCLI._build_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rng = np.random.default_rng(1)
    ori = rng.normal(size=(window, 54)).astype(np.float32)
    acc = rng.normal(size=(window, 18)).astype(np.float32)
    try:
        with PoseClient(*srv.address[:2], timeout=30.0, retry_s=5.0) as c:
            assert np.isfinite(c.step(ori, acc)).all()
            ori[2, 5] = np.nan
            with pytest.raises(ServerError,
                               match=r"FloatingPointError.*nan.*aten::"):
                c.step(ori, acc)
    finally:
        srv.shutdown()


def test_torch_port_debug_nans_checks_an_artifacts_program(data, tmp_path):
    """``export --debug_nans`` traces as without the flag, and the loaded
    ``torch.export`` program (what ``serve`` / ``stream --artifact`` run)
    steps under the check: the same poses on a clean window, the op that
    makes the NaN named on a window holding one."""
    from a3gc_tpu_torch.export import ArtifactSession, load_exported
    art = str(tmp_path / "art")
    _main(["export", "--device", "cpu", "--norm", "--window", "6",
           "--output", art, "--smpl", data["smpl"], "--debug_nans"] + WIDTH,
          tmp_path)
    rng = np.random.default_rng(2)
    ori = rng.normal(size=(6, 54)).astype(np.float32)
    acc = rng.normal(size=(6, 18)).astype(np.float32)
    want = ArtifactSession(load_exported(art, device="cpu")).step(ori, acc)
    sess = ArtifactSession(load_exported(art, device="cpu"))
    with RT.nan_check():
        np.testing.assert_array_equal(sess.step(ori, acc), want)
        ori[3, 7] = np.nan
        with pytest.raises(FloatingPointError, match=r"nan.*aten::"):
            sess.step(ori, acc)


def test_torch_port_spans_record_only_under_a_profiler():
    """A span is a shared no-op context without a profiler, and a named
    event with one."""
    from torch.profiler import profile
    assert RT.span("jit_x") is RT.span("jit_y")
    with profile() as prof:
        with RT.span("jit_x"):
            torch.ones(2).sum()
    assert "jit_x" in {e.name for e in prof.events()}


@pytest.fixture
def jax_debug_nans():
    """``jax_debug_nans`` as the JAX CLI's ``--debug_nans`` leaves it,
    restored after the test."""
    before = jax.config.jax_debug_nans
    yield
    jax.config.update("jax_debug_nans", before)


def test_torch_port_cli_debug_nans_names_the_op_of_a_nan_weight(
        data, tmp_path, jax_debug_nans, monkeypatch):
    """A NaN in stage 1's recurrent weight: both CLIs raise on the same
    ``.tar`` checkpoints; the port names the layer's kernel op, the first
    that computes with the weight."""
    argv = (["evaluate", "--norm", "--smpl", data["smpl"], "--datasets",
             data["npz"], "--torch_checkpoints"] + data["tars"]["nan"]
            + WIDTH + ["--debug_nans"])
    with pytest.raises(FloatingPointError, match=f"nan.*{SCAN}"):
        _main(argv + ["--device", "cpu"], tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FloatingPointError, match="nan"):
        JCLI.main(argv)


def test_torch_port_debug_nans_stops_a_training_step_at_a_nan_target(
        jax_debug_nans):
    """A NaN in one target frame: both packages' stage-1 training steps
    raise inside the step, the port naming the op (JAX's flag is set
    before its runner is built: the runner donates the train state
    otherwise, and the flag's NaN-locating re-run would find it gone)."""
    from a3gc_tpu_torch.config import joint_set as JS
    jax.config.update("jax_debug_nans", True)
    jr, tr = train_runners("a3gc", 1)
    raw = synthetic_packed_dataset(4, 10, seed=5)
    raw["full_pos"][1, 4, JS.leaf_nodes[0], 0] = np.nan    # a leaf: target
    with pytest.raises(FloatingPointError, match=r"nan.*aten::"):
        with RT.nan_check():
            tr.train_step({k: torch.as_tensor(v) for k, v in raw.items()},
                          torch.Generator().manual_seed(0))
    with pytest.raises(FloatingPointError, match="nan"):
        jr.train_step(jr.state, raw, jax.random.PRNGKey(0))
    assert not torch.is_anomaly_enabled()
    assert not _get_current_dispatch_mode_stack()


@pytest.mark.parametrize("cmd", ["evaluate", "stats"])
def test_torch_port_cli_compilation_cache_places_the_kernel_builds(
        cmd, data, tmp_path, monkeypatch):
    """The kernel loader, swapped for a spy (no nvcc here), finds
    ``build_dir()`` at ``--compilation_cache D`` while the command runs,
    and at its default after it (``stats`` launches no kernel: the flag
    is accepted there and changes nothing it does)."""
    seen = []

    def spy(args):
        seen.append(B.build_dir())

    monkeypatch.setattr(TCLI, f"cmd_{cmd}", spy)
    default = B.build_dir()
    argv = {"evaluate": ["evaluate", "--device", "cpu", "--datasets", "x"],
            "stats": ["stats", "--inputs", "x", "--output", "y"]}[cmd]
    _main(argv + ["--compilation_cache", "kernels"], tmp_path)
    assert seen == [os.path.realpath(tmp_path / "kernels")]
    assert B.build_dir() == default


def test_torch_port_cli_profile_jax_cli_traces_the_same_evaluate(data):
    """The JAX CLI's ``evaluate --profile`` on the same data and
    checkpoints (started with the module's data) exits 0 and writes its
    trace under its own directory."""
    out, _ = data["jax_profile"].communicate(timeout=600)
    assert data["jax_profile"].returncode == 0, out[-3000:]
    assert [f for _, _, fs in os.walk(data["dir"] / "jax_trace") for f in fs]
