"""``python -m a3gc_tpu_torch.cli train`` on the CPU at hidden 8: every flag
of the JAX CLI's ``train`` parses with its default; a run writes a
three-stage ``train_log.jsonl`` and checkpoint directories that ``cli
evaluate --path`` reads; ``--model dip``, ``--resume``, the device-resident
corpus, ``--fse``; a SIGTERM checkpoints and a resumed run picks it up;
``--mesh`` and ``--coordinator`` on one CPU shard equal a run without
them, ``--tp 2`` on one CPU device exits with the JAX CLI's "must divide"
message; ``--device cuda`` without a card raises."""

import json
import os

import numpy as np
import pytest
import torch

from a3gc_tpu import cli as JCLI
from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.utils import discover_latest

from test_torch_port_cli import _subparser

torch.set_num_threads(1)

SMALL = ["--hu1", "8", "--hu2", "8", "--hu3", "8"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_data")
    train, valid = str(d / "train.npz"), str(d / "valid.npz")
    np.savez(train, **synthetic_packed_dataset(6, 16, seed=0))
    np.savez(valid, **synthetic_packed_dataset(3, 16, seed=1))
    return ["--train_data", train, "--valid_data", valid]


@pytest.mark.parametrize("argv", [
    [], ["--model", "dip", "--hu1", "512", "--accum", "2", "--dtype",
         "bfloat16", "--device_data", "--steps_per_dispatch", "4"],
    ["--model", "tp", "--lr", "3e-4", "--wd", "1e-3", "--patience", "7",
     "--epochs", "9", "-f", "--fse", "--resume", "runs/x", "--start_at",
     "2", "--start_epoch", "3", "--seed", "5", "--name", "n",
     "--save_root", "r", "--keep", "2", "--min_delta", "0.1",
     "--eval_batch", "16", "--norm", "--cda", "--rotsize", "6"],
    ["--mesh", "--tp", "2", "--coordinator", "h:1", "--num_processes", "2",
     "--process_id", "1", "--precision", "highest", "--profile", "p",
     "--debug_nans", "--compilation_cache", "c", "--smpl", "m.pkl",
     "--data_root", "d"],
])
def test_torch_port_cli_train_flags_match_jax_cli(argv):
    argv = ["-b", "16"] + argv + ["--train_data", "t.npz", "--valid_data",
                                  "v.npz"]
    ours = TCLI.build_parser().parse_args(["train"] + argv)
    ref = JCLI.build_parser().parse_args(["train"] + argv)
    assert ours.fn is TCLI.cmd_train and ours.device == "cuda"
    jax_flags = {a.dest for a in _subparser(JCLI.build_parser,
                                            "train")._actions} - {"help"}
    our_flags = {a.dest for a in _subparser(TCLI.build_parser,
                                            "train")._actions} - {"help"}
    assert jax_flags <= our_flags and our_flags - jax_flags == {"device"}
    for flag in jax_flags:
        assert getattr(ours, flag) == getattr(ref, flag), flag


def _log(root, name):
    with open(os.path.join(root, name, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_torch_port_cli_train_then_evaluate(data, tmp_path, monkeypatch):
    """Three stages trained on the CPU; their checkpoints evaluated by the
    port's ``cli evaluate --path`` (the table finite)."""
    monkeypatch.chdir(tmp_path)
    runs = str(tmp_path / "runs")
    TCLI.main(["train", "--device", "cpu", "-b", "4", "--epochs", "2",
               "--norm", "--name", "a", "--save_root", runs] + SMALL + data)
    log = _log(runs, "a")
    assert [(e["stage"], e["epoch"]) for e in log] == [
        (s, e) for s in (1, 2, 3) for e in (0, 1)]
    assert all(np.isfinite([e["train_loss"], e["valid_loss"]]).all()
               for e in log)
    for stage in (1, 2, 3):
        assert discover_latest(os.path.join(runs, "a"), stage,
                               phase="pretrain")

    from a3gc_tpu_torch.smpl import write_synthetic_smpl_pickle
    from torch_port_oracle import eval_sequences
    smpl = write_synthetic_smpl_pickle(str(tmp_path / "smpl.pkl"),
                                       n_vertices=64)
    test = str(tmp_path / "test.npz")
    np.savez(test, **{f"seq{i}_{k}": v for i, s in
                      enumerate(eval_sequences([20, 26], seed=2))
                      for k, v in s.items()})
    TCLI.main(["evaluate", "--device", "cpu", "--norm", "--smpl", smpl,
               "--path", os.path.join(runs, "a"), "--type", "pretrain",
               "--datasets", test] + SMALL)
    report = tmp_path / "evaluation_results" / "a3gc_test.npz.txt"
    lines = report.read_text().splitlines()
    assert len(lines) == 7 and "nan" not in report.read_text()


def test_torch_port_cli_train_dip_resume_and_device_data(data, tmp_path):
    runs = str(tmp_path / "runs")
    base = ["train", "--device", "cpu", "--model", "dip", "--hu1", "8",
            "-b", "4", "--save_root", runs] + data
    TCLI.main(base + ["--epochs", "1", "--name", "d", "--dtype", "bfloat16",
                      "--accum", "2", "--device_data"])
    log = _log(runs, "d")
    assert [e["stage"] for e in log] == [1]
    found = discover_latest(os.path.join(runs, "d"), 1)
    assert found and found[1] == 0
    # resume: a second run starts from the first's weights
    TCLI.main(base + ["--epochs", "2", "--start_epoch", "1", "--name", "d",
                      "--resume", os.path.join(runs, "d")])
    log = _log(runs, "d")
    assert [e["epoch"] for e in log] == [0, 1]
    assert log[1]["train_loss"] < log[0]["train_loss"] * 1.5
    with pytest.raises(SystemExit, match="no checkpoint"):
        TCLI.main(base + ["--epochs", "1", "--name", "e", "--resume",
                          str(tmp_path / "nothing")])


@pytest.mark.parametrize("extra", [
    ["--mesh"], ["--tp", "2"], ["--coordinator", "localhost:1234"]])
def test_torch_port_cli_train_refuses_multi_card(data, extra, tmp_path):
    """``--tp 2`` (tensor parallelism) over the one CPU device of a
    single-process run exits with the JAX CLI's ``--tp 2 must divide 1
    devices``. ``--mesh`` (a one-device CPU mesh) and ``--coordinator`` (a
    one-process gloo group on a free port of this host) run since the mesh
    was ported: their logs and checkpoints equal a run without them."""
    import socket
    base = ["train", "--device", "cpu", "-b", "4", "--epochs", "1",
            "--save_root", str(tmp_path)] + SMALL + data
    if "--tp" in extra:
        with pytest.raises(SystemExit) as ei:
            TCLI.main(base + extra)
        assert "--tp 2 must divide 1 devices" in str(ei.value)
        return
    if "--coordinator" in extra:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            extra = ["--coordinator", f"127.0.0.1:{sock.getsockname()[1]}",
                     "--num_processes", "1", "--process_id", "0"]
    TCLI.main(base + ["--name", "plain"])
    TCLI.main(base + ["--name", "meshed"] + extra)
    keys = ("stage", "epoch", "train_loss", "valid_loss")
    logs = [[tuple(e[k] for k in keys) for e in _log(str(tmp_path), name)]
            for name in ("plain", "meshed")]
    assert logs[0] == logs[1] and len(logs[0]) == 3
    for stage in (1, 2, 3):
        a, b = (torch.load(os.path.join(discover_latest(
            os.path.join(tmp_path, name), stage)[0], "params.pt"))
            ["state_dict"] for name in ("plain", "meshed"))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_torch_port_cli_train_guards(data, tmp_path):
    base = ["train", "--device", "cpu", "-b", "4", "--save_root",
            str(tmp_path)] + data
    with pytest.raises(SystemExit, match="--device_data"):
        TCLI.main(base + ["--steps_per_dispatch", "2"])
    with pytest.raises(SystemExit, match="--accum"):
        TCLI.main(base + ["--accum", "3"])


def test_torch_port_cli_train_cuda_without_a_card_raises(data, tmp_path):
    """The default device is the card; without one the run raises before
    anything trains — no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(["train", "-b", "4", "--save_root", str(tmp_path),
                   "--name", "c"] + SMALL + data)
    assert not os.path.exists(tmp_path / "c" / "train_log.jsonl")


def test_torch_port_cli_train_fse(tmp_path):
    """``--fse``: validation on whole variable-length sequences (a
    test-style npz holding the stage targets), one score a stage."""
    packed = synthetic_packed_dataset(4, 16, seed=4)
    train = str(tmp_path / "train.npz")
    np.savez(train, **packed)
    valid = str(tmp_path / "valid.npz")
    np.savez(valid, **{f"seq{i}_{k}": v[i, :n] for i, n in
                       enumerate((16, 9, 12)) for k, v in packed.items()})
    runs = str(tmp_path / "runs")
    TCLI.main(["train", "--device", "cpu", "-b", "2", "--epochs", "1",
               "--fse", "--name", "f", "--save_root", runs,
               "--train_data", train, "--valid_data", valid] + SMALL)
    log = _log(runs, "f")
    assert [e["stage"] for e in log] == [1, 2, 3]
    assert all(np.isfinite(e["valid_loss"]) for e in log)


def test_torch_port_cli_train_sigterm_checkpoints_and_resumes(tmp_path):
    """A SIGTERM mid-training: the run stops at a step boundary, writes a
    checkpoint of the current params, logs "interrupted" and exits 0; a
    resumed run starts from that checkpoint."""
    import signal
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    npz = str(tmp_path / "data.npz")
    np.savez(npz, **synthetic_packed_dataset(8, 16, seed=0))
    runs = str(tmp_path / "runs")
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "a3gc_tpu_torch.cli", "train", "--device",
           "cpu", "-b", "4", "--epochs", "100000", "--patience", "100000",
           "--start_at", "3", "--name", "run", "--save_root", runs,
           "--train_data", npz, "--valid_data", npz] + SMALL
    proc = subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    log_path = os.path.join(runs, "run", "train_log.jsonl")
    deadline = time.time() + 120
    while time.time() < deadline and not (
            os.path.isfile(log_path) and os.path.getsize(log_path)):
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    log = _log(runs, "run")
    assert log[-1].get("event") == "interrupted"
    found = discover_latest(os.path.join(runs, "run"), 3)
    assert found and found[1] == log[-1]["epoch"]
    resumed = subprocess.run(
        cmd[:cmd.index("--epochs") + 1] + [str(log[-1]["epoch"] + 2)]
        + cmd[cmd.index("--epochs") + 2:] + ["--start_epoch",
                                             str(log[-1]["epoch"] + 1),
                                             "--resume",
                                             os.path.join(runs, "run")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert resumed.returncode == 0, resumed.stderr
    assert f"resumed stage 3 from {found[0]}" in resumed.stdout
