"""The port's command line (a3gc_tpu_torch.cli, the ``serve`` subcommand):
its parser's defaults and quality presets against the JAX package's for the
flags both have (every flag of the JAX CLI's ``serve``), the flags that wait
for later slices, ``--precision``, which it accepts and ignores, and one
end-to-end
state-preserving exec-recycle of ``python -m a3gc_tpu_torch.cli serve
--device cpu`` at small widths: the clients ride the pause with their seq
and token, and the poses equal an uninterrupted in-process session's at
1e-6 (the same code on the same weights)."""

import json
import os
import subprocess
import sys
import threading

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


@pytest.fixture(autouse=True)
def _no_data_root_from_earlier_tests(monkeypatch):
    # the JAX CLI's main sets $A3GC_DATA_ROOT and leaves it set: after one
    # of its tests in this process, the port's runs here would read that
    # root's stats and SMPL file and their JAX or subprocess counterparts
    # would not
    monkeypatch.delenv("A3GC_DATA_ROOT", raising=False)


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


def _cli_run(argv, cwd, capsys):
    """``cli <argv>`` in process from ``cwd``: (stdout, stderr)."""
    old = os.getcwd()
    os.chdir(cwd)
    try:
        TCLI.main(argv)
    finally:
        os.chdir(old)
    return capsys.readouterr()


@pytest.mark.parametrize("argv,note", [
    (["stream", "--mesh", "--input", "test.npz"], None),
    (["serve", "--mesh", "--streams", "2"], None),
    (["evaluate", "--mesh", "--batch_streams", "2", "--datasets",
      "test.npz"], None),
    (["evaluate", "--model", "dip", "--batch_streams", "8", "--mesh",
      "--datasets", "test.npz"], "not wired for the single-net dip "
                                 "evaluator"),
])
def test_torch_port_cli_refuses_flags_of_later_slices(argv, note, tmp_path,
                                                      smpl_pickle, capsys,
                                                      monkeypatch):
    """``--mesh`` (ported from the later slice it once waited for) runs
    with ``--device cpu`` on a one-device mesh, and every output equals
    the same run without it; the DIP paths note that the mesh is not wired
    and run unsharded, as the JAX CLI does."""
    from a3gc_tpu_torch.models.pipeline import init_pose_net
    from a3gc_tpu_torch.utils import save_params
    from torch_port_oracle import eval_sequences
    np.savez(tmp_path / "test.npz", **{
        f"seq{i}_{k}": v for i, s in enumerate(eval_sequences([70, 50],
                                                              seed=6))
        for k, v in s.items()})
    common = ["--device", "cpu", "--smpl", smpl_pickle, "--hu1", "8",
              "--hu2", "8", "--hu3", "8", "--norm"]
    if "dip" in argv:
        args = TCLI.build_parser().parse_args(["serve", "--model", "dip",
                                               "--hu1", "8"])
        save_params(init_pose_net(torch.Generator().manual_seed(0),
                                  TCLI._dip_config(args)),
                    str(tmp_path / "dip"), 1, 0)
        common += ["--path", str(tmp_path / "dip"), "--type", "pretrain"]
    from a3gc_tpu_torch.metrics import PoseEvaluator
    tables = []
    monkeypatch.setattr(PoseEvaluator, "format", staticmethod(
        lambda errors: tables.append(np.asarray(errors)) or ""))
    rng = np.random.default_rng(4)
    outs = []
    for mesh in (True, False):
        run = [str(tmp_path / a) if a == "test.npz" else a
               for a in argv if mesh or a != "--mesh"]
        run = run[:1] + common + run[1:]
        if run[0] == "serve":
            args = TCLI.build_parser().parse_args(run + ["--port", "0"])
            TCLI._apply_quality(args)
            srv, streams, window = TCLI._build_server(args)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            try:
                sess = srv.batcher.sess
                assert (sess._mesh is not None) == mesh
                wins = [(rng.normal(size=(streams, window, 54)),
                         rng.normal(size=(streams, window, 18)))
                        for _ in range(3)]
                outs.append([sess.step(o, a) for o, a in wins])
                rng = np.random.default_rng(4)
            finally:
                srv.shutdown()
        elif run[0] == "stream":
            out = str(tmp_path / f"poses_{mesh}.npz")
            _cli_run(run + ["--output", out], tmp_path, capsys)
            with np.load(out) as z:
                outs.append([z[k] for k in sorted(z.files)])
        else:
            cwd = tmp_path / f"eval_{mesh}"
            cwd.mkdir()
            printed = _cli_run(run, cwd, capsys)
            assert (note in printed.err) == mesh if note else True
            outs.append(tables[:])
            tables.clear()
    assert len(outs[0]) == len(outs[1]) > 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def smpl_pickle(tmp_path_factory):
    from a3gc_tpu.smpl import write_synthetic_smpl_pickle
    return write_synthetic_smpl_pickle(
        str(tmp_path_factory.mktemp("smpl") / "smpl.pkl"), n_vertices=96)


def _data_root(tmp_path, smpl_pickle):
    """A data root in the JAX config's layout: the male SMPL pickle and
    stats that differ from the shipped ones."""
    import shutil
    root = tmp_path / "root"
    (root / "models").mkdir(parents=True)
    (root / "stats").mkdir()
    shutil.copy(smpl_pickle, root / "models" / TCLI._SMPL_MALE.split("/")[1])
    stats = {k: v * 1.5 for k, v in TCLI._load_stats(
        TCLI.build_parser().parse_args(["serve"])).items()}
    np.savez(root / "stats" / "all_train_stats.npz", **stats)
    return str(root), stats


def _same_model(ours, ref):
    assert ours.parent == tuple(ref.parent)
    for name in ("j_regressor", "skinning_weights", "posedirs", "shapedirs",
                 "v_template", "joints_template"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("case", ["smpl", "data_root", "missing_smpl",
                                  "dip_data_root"])
def test_torch_port_cli_serve_loads_body_model_and_stats(case, tmp_path,
                                                         smpl_pickle,
                                                         capsys):
    """``--smpl`` and ``--data_root`` locate the SMPL file (and the stats)
    as the JAX CLI's ``_load_body_model`` / ``_load_stats`` do; a missing
    file falls back to the synthetic body model with a note; the server
    built on them answers a step."""
    import threading
    from a3gc_tpu.smpl import load_parametric_model as jax_load
    from a3gc_tpu.smpl import synthetic_smpl_data as jax_synthetic
    root, stats = _data_root(tmp_path, smpl_pickle)
    argv = {"smpl": ["--smpl", smpl_pickle],
            "data_root": ["--data_root", root, "--norm"],
            "missing_smpl": ["--smpl", str(tmp_path / "nope.pkl")],
            "dip_data_root": ["--data_root", root, "--model", "dip"]}[case]
    if case == "dip_data_root":
        from a3gc_tpu_torch.compat import torch_export as TE
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        tar = str(tmp_path / "dip.tar")
        args = TCLI.build_parser().parse_args(["serve", "--hu1", "8"])
        TE.save_torch_checkpoint(tar, TE.dip_state_dict(init_pose_net(
            torch.Generator().manual_seed(0), TCLI._dip_config(args))))
        argv += ["--torch_checkpoints", tar]
    args = TCLI.build_parser().parse_args(
        ["serve", "--device", "cpu", "--port", "0", "--streams", "2",
         "--window", "4", "--hu1", "8", "--hu2", "8", "--hu3", "8"] + argv)
    TCLI._apply_quality(args)
    model = TCLI._load_body_model(args, "cpu")
    assert model.device == torch.device("cpu")
    if case == "missing_smpl":
        assert "synthetic body model" in capsys.readouterr().err
        data = jax_synthetic()
        np.testing.assert_array_equal(model.v_template.numpy(),
                                      data["v_template"].astype(np.float32))
        np.testing.assert_array_equal(model.j_regressor.numpy(),
                                      data["J_regressor"].astype(np.float32))
    else:
        _same_model(model, jax_load(smpl_pickle))
    if "data_root" in case:
        got = TCLI._load_stats(args)
        for k in stats:
            np.testing.assert_array_equal(got[k], stats[k])
    srv, streams, window = TCLI._build_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with PoseClient(*srv.address[:2], timeout=30.0, retry_s=5.0) as c:
            pose = c.step(*_windows(1, window, seed=3)[0])
        assert pose.shape == (window, 24, 3, 3) and np.isfinite(pose).all()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("argv", [
    ["--precision", "default"],
    ["--precision", "highest", "--compilation_cache", "cache"],
    [],
])
def test_torch_port_cli_notes_no_precision(argv, tmp_path, capsys,
                                           monkeypatch):
    """``--precision`` acts (tests/test_torch_port_precision.py): a command
    given it notes nothing about it on stderr, and the run-wide flags are
    not noted either (tests/test_torch_port_cli_flags.py)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("A3GC_DATA_ROOT", raising=False)
    assert not hasattr(TCLI, "_note_ignored_flags")
    TCLI.main(["export", "--device", "cpu", "--hu1", "8", "--hu2", "8",
               "--hu3", "8", "--window", "6", "--streams", "1",
               "--output", str(tmp_path / "art")] + argv)
    err = capsys.readouterr().err
    assert (tmp_path / "art").is_dir()
    for word in ("precision", "ignoring", "fp32", "--compilation_cache"):
        assert word not in err, err


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
            "--history", str(P), "--max_wait_ms", "2", "--device", "cpu",
            "--data_root", str(tmp_path / "data")]    # one root for both
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


def _subparser(build, name):
    import argparse
    sub = next(a for a in build()._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


@pytest.mark.parametrize("argv", [
    [], ["--quality", "balanced"], ["--quality", "max", "--streaming", "30"],
    ["--streaming", "60", "--lookahead", "1", "--history", "0",
     "--batch_streams", "4"],
    ["--model", "tp", "--batch_streams", "8", "--save_preds", "--norm",
     "--cda", "--rotsize", "6"],
    ["--model", "dip", "--hu1", "512", "--torch_checkpoints", "dip.tar",
     "--smpl", "m.pkl", "--data_root", "d", "--precision", "highest"],
    ["--path", "runs/x", "--type", "pretrain", "--mid1", "3", "--mid2", "4",
     "--mid3", "5", "--mesh", "--profile", "p", "--debug_nans",
     "--compilation_cache", "c"],
])
def test_torch_port_cli_evaluate_flags_match_jax_cli(argv):
    """Every flag of the JAX CLI's ``evaluate`` parses, with its default;
    the quality presets resolve alike (a preset implies --streaming)."""
    argv = argv + ["--datasets", "a.npz", "b.npz"]
    ours = TCLI.build_parser().parse_args(["evaluate"] + argv)
    ref = JCLI.build_parser().parse_args(["evaluate"] + argv)
    assert ours.fn is TCLI.cmd_evaluate and ours.device == "cuda"
    jax_flags = {a.dest for a in _subparser(JCLI.build_parser,
                                            "evaluate")._actions} - {"help"}
    our_flags = {a.dest for a in _subparser(TCLI.build_parser,
                                            "evaluate")._actions} - {"help"}
    assert jax_flags <= our_flags and our_flags - jax_flags == {"device"}
    for flag in jax_flags:
        assert getattr(ours, flag) == getattr(ref, flag), flag
    TCLI._apply_quality(ours)
    JCLI._apply_quality(ref)
    for flag in ("streaming", "lookahead", "history"):
        assert getattr(ours, flag) == getattr(ref, flag), flag


def _test_set(path, lengths, seed):
    from torch_port_oracle import eval_sequences
    seqs = eval_sequences(lengths, seed=seed)
    np.savez(path, **{f"seq{i}_{k}": v for i, s in enumerate(seqs)
                      for k, v in s.items()})
    return seqs


def _report_table(path):
    """The [5, 2] table of the last report in a report file."""
    with open(path) as f:
        lines = f.read().splitlines()[-5:]
    return np.array([[float(line.split(": ")[1].split(" (+/- ")[0]),
                      float(line.split("(+/- ")[1].rstrip(")"))]
                     for line in lines])


@pytest.mark.parametrize("mode", ["per_sequence", "batched", "streaming",
                                  "save_preds"])
def test_torch_port_cli_evaluate_writes_report(mode, tmp_path, smpl_pickle,
                                               monkeypatch, capsys):
    """``evaluate --device cpu`` end to end on a tiny test npz: the report
    (and the prediction dumps) the JAX CLI writes, with the table of the
    in-process evaluator on the same fresh init."""
    import pickle
    from a3gc_tpu_torch.eval import CascadeEvaluator
    from a3gc_tpu_torch.smpl import load_parametric_model
    data = str(tmp_path / "dip_test.npz")
    seqs = _test_set(data, (40, 75, 50), seed=11)
    extra = {"per_sequence": [], "batched": ["--batch_streams", "2"],
             "streaming": ["--quality", "balanced", "--streaming", "20"],
             "save_preds": ["--save_preds"]}[mode]
    argv = ["evaluate", "--device", "cpu", "--hu1", "8", "--hu2", "8",
            "--hu3", "8", "--norm", "--smpl", smpl_pickle,
            "--datasets", data] + extra
    monkeypatch.chdir(tmp_path)
    TCLI.main(argv)
    out = capsys.readouterr().out
    assert f"== {data}: {sum(s['ori'].shape[0] for s in seqs)} frames" in out

    args = TCLI.build_parser().parse_args(argv)
    TCLI._apply_quality(args)
    cascade, is_graph = TCLI._stage_configs(args)
    ev = CascadeEvaluator(
        TCLI._init_cascade_params(cascade, is_graph, "cpu"), cascade,
        load_parametric_model(smpl_pickle, device="cpu"),
        TCLI._load_stats(args), normalize=True, device="cpu")
    if mode == "streaming":
        want = ev.evaluate_streaming(seqs, window=20, lookahead=1,
                                     history=1)[0]
        report = tmp_path / "evaluation_results" / \
            "a3gc_dip_test.npz_stream20_K1_P1.txt"
    else:
        # the same protocol in process: a fresh init's raw 9D outputs are far
        # from rotations, where the global-angle rows move by 0.1 deg at a
        # 1e-7 change of the poses, so another protocol's sums would not do
        want = (ev.evaluate_batched(seqs, streams=2) if mode == "batched"
                else ev.evaluate(seqs))[0]
        report = tmp_path / "evaluation_results" / "a3gc_dip_test.npz.txt"
    np.testing.assert_allclose(_report_table(report), want, rtol=0,
                               atol=0.0051)
    if mode == "save_preds":
        base = tmp_path / "evaluation_results" / "sequences" / "dip" / "a3gc"
        for i, seq in enumerate(seqs):
            with open(base / "pred" / f"{i:03d}.p", "rb") as f:
                pred = pickle.load(f)
            with open(base / "gt" / f"{i:03d}.p", "rb") as f:
                gt = pickle.load(f)
            T = seq["ori"].shape[0]
            assert pred.shape == gt.shape == (T, 24, 3, 3)


@pytest.mark.parametrize("streaming", [False, True])
def test_torch_port_cli_evaluate_dip(streaming, tmp_path, smpl_pickle,
                                     capsys):
    from a3gc_tpu_torch.compat import torch_export as TE
    from a3gc_tpu_torch.eval import DipEvaluator
    from a3gc_tpu_torch.models.pipeline import init_pose_net
    from a3gc_tpu_torch.smpl import load_parametric_model
    data = str(tmp_path / "test.npz")
    seqs = _test_set(data, (33, 61), seed=12)
    args = TCLI.build_parser().parse_args(
        ["evaluate", "--model", "dip", "--hu1", "8", "--datasets", data])
    cfg = TCLI._dip_config(args)
    params = init_pose_net(torch.Generator().manual_seed(5), cfg)
    tar = str(tmp_path / "dip.tar")
    TE.save_torch_checkpoint(tar, TE.dip_state_dict(params))
    argv = ["evaluate", "--device", "cpu", "--model", "dip", "--hu1", "8",
            "--smpl", smpl_pickle, "--torch_checkpoints", tar,
            "--datasets", data] + (["--streaming", "16", "--lookahead", "1",
                                    "--batch_streams", "2"]
                                   if streaming else [])
    TCLI.main(argv)
    out = capsys.readouterr().out
    ev = DipEvaluator(params, cfg,
                      load_parametric_model(smpl_pickle, device="cpu"),
                      TCLI._load_stats(args), device="cpu")
    want = (ev.evaluate_streaming(seqs, window=16, lookahead=1,
                                  batch_streams=2) if streaming
            else ev.evaluate(seqs))[0]
    assert ("[stream16_K1]" in out) == streaming and "94 frames" in out
    got = np.array([[float(x) for x in line.split(": ")[1].replace(
        "(+/- ", "").rstrip(")").split()]
        for line in out.splitlines()[-5:]])
    np.testing.assert_allclose(got, want, rtol=0, atol=0.0051)


def test_torch_port_cli_evaluate_refuses_missing_test_sets(tmp_path):
    with pytest.raises(SystemExit, match="no test set"):
        TCLI.main(["evaluate", "--device", "cpu", "--datasets",
                   str(tmp_path / "none.npz")])


def test_torch_port_cli_evaluate_runs_on_the_card_by_default(tmp_path):
    """Without ``--device cpu`` the command asks for the card, and raises
    on a machine without one rather than falling back to the CPU."""
    data = str(tmp_path / "test.npz")
    _test_set(data, (10,), seed=13)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(["evaluate", "--hu1", "8", "--hu2", "8", "--hu3", "8",
                   "--datasets", data])
