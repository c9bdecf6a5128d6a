"""Multi-process training of the port on the CPU: two processes joined in a
``gloo`` group (a3gc_tpu_torch.parallel.multihost), one CPU shard each.
``cli train --coordinator 127.0.0.1:<free port> --num_processes 2
--process_id {0,1} --device cpu`` at hidden 8 follows a single-process run
of the same global batch within 1e-5 over two epochs; only process 0 writes
the log and the checkpoints; a SIGTERM to one process stops both at the
same epoch boundary; ``--fse`` with ``--coordinator`` is refused. Through
the API: a step with unequal shard weights, dropout and teacher-forcing
noise on, leaves the two processes' replicas equal
(``fetch_replicated``), within 1e-5 of one process holding both shards.
Tensor parallelism across the two processes (one model group of two, the
products all-gathered over a gloo subgroup): ``cli train --tp 2`` follows a
single-process run within 1e-5 (weight decay on, so a replicated
parameter's gradient scaled by the group's size would show), and one step's
gradients are the single-device ones: each process's column block of a
split parameter, the whole of a replicated one. A comparison's runs all
read one data root, the test's own (no stats there: the shipped ones)."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.utils import discover_latest

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--hu1", "8", "--hu2", "8", "--hu3", "8"]
TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_data_root_from_earlier_tests(monkeypatch):
    # the JAX CLI's main sets $A3GC_DATA_ROOT and leaves it set: after one
    # of its tests in this process, an in-process run here would read that
    # root's stats
    monkeypatch.delenv("A3GC_DATA_ROOT", raising=False)


def _env():
    r"""The children's environment, as it stands when they are spawned."""
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log(root, name):
    path = os.path.join(root, name, "train_log.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_data")
    train, valid = str(d / "train.npz"), str(d / "valid.npz")
    np.savez(train, **synthetic_packed_dataset(6, 12, seed=0))
    np.savez(valid, **synthetic_packed_dataset(3, 12, seed=1))
    return ["--train_data", train, "--valid_data", valid]


def _spawn(argv, rank, port, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "a3gc_tpu_torch.cli"] + argv
        + ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
           "--process_id", str(rank)],
        cwd=str(cwd), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_torch_port_two_process_train_matches_one_process(data, tmp_path):
    base = ["train", "--device", "cpu", "-b", "4", "--epochs", "2",
            "--norm", "--name", "run",
            "--data_root", str(tmp_path / "data")] + SMALL + data
    TCLI.main(base + ["--save_root", str(tmp_path / "single")])
    port = _free_port()
    procs = [_spawn(base + ["--save_root", str(tmp_path / f"r{r}")], r,
                    port, tmp_path) for r in (0, 1)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    keys = ("stage", "epoch", "train_loss", "valid_loss")
    want = [[e[k] for k in keys] for e in _log(tmp_path / "single", "run")]
    got = [[e[k] for k in keys] for e in _log(tmp_path / "r0", "run")]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL)
    # process 0 logs and checkpoints; process 1 writes nothing, prints no
    # log line
    assert os.listdir(tmp_path / "r1" / "run") == []
    assert all(discover_latest(str(tmp_path / "r0" / "run"), s)
               for s in (1, 2, 3))
    assert '"train_loss"' not in outs[1] and '"train_loss"' in outs[0]
    assert "[multihost] process 1/2 joined" in outs[1]


def test_torch_port_sigterm_stops_both_processes_at_one_epoch(data,
                                                              tmp_path):
    argv = ["train", "--device", "cpu", "-b", "4", "--epochs", "100000",
            "--patience", "100000", "--start_at", "3", "--name", "run",
            "--save_root", str(tmp_path)] + SMALL + data
    port = _free_port()
    procs = [_spawn(argv, r, port, tmp_path) for r in (0, 1)]
    log_path = tmp_path / "run" / "train_log.jsonl"
    deadline = time.time() + 120
    while time.time() < deadline and not (
            log_path.is_file() and log_path.stat().st_size):
        time.sleep(0.2)
    procs[1].send_signal(signal.SIGTERM)     # the non-coordinator only
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    log = _log(tmp_path, "run")
    assert log[-1].get("event") == "interrupted"
    found = discover_latest(str(tmp_path / "run"), 3)
    assert found and found[1] == log[-1]["epoch"]


def test_torch_port_fse_with_coordinator_is_refused(data, tmp_path):
    with pytest.raises(SystemExit, match="--fse"):
        TCLI.main(["train", "--device", "cpu", "-b", "4", "--fse",
                   "--coordinator", f"127.0.0.1:{_free_port()}",
                   "--num_processes", "2", "--save_root", str(tmp_path)]
                  + data)


_REPLICAS = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from a3gc_tpu_torch.config import TrainConfig
from a3gc_tpu_torch.data import load_adjacency_template, load_stats
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
from a3gc_tpu_torch.parallel import (fetch_replicated, initialize_multihost,
                                     make_mesh)
from a3gc_tpu_torch.parallel.multihost import process_count
from a3gc_tpu_torch.train import StageRunner, seeded_generator

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
if rank >= 0:
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
cfg = PoseNetConfig(net=N.GraphNetConfig(cell="a3gc", units_in=15,
                                         units_out=3, units_hidden=8),
                    rotsize=3)
params = init_pose_net(torch.Generator().manual_seed(0), cfg,
                       load_adjacency_template())
mesh = make_mesh(devices=["cpu"] * (1 if rank >= 0 else 2))
assert mesh.shape["data"] == 2 and process_count() == (2 if rank >= 0 else 1)
runner = StageRunner(2, cfg, params, TrainConfig(batch_size=4,
                                                 normalize=True),
                     2, stats=load_stats(), device="cpu", mesh=mesh)
raw = synthetic_packed_dataset(4, 10, seed=3)
raw["_weight"] = np.array([1, 1, 1, 0], np.float32)     # shards: 2 and 1
losses = [float(runner.train_step(raw, seeded_generator("cpu", 0, i)))
          for i in range(2)]
np.savez(out, losses=np.asarray(losses), **fetch_replicated(
    runner.state.params))
"""


def test_torch_port_two_process_replicas_stay_equal(tmp_path):
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REPLICAS, str(r), port,
         str(tmp_path / f"{r}.npz")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1, -1)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    r0, r1, one = (np.load(tmp_path / f"{r}.npz") for r in (0, 1, -1))
    assert r0.files == r1.files == one.files and len(r0.files) > 1
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k])     # the replicas
        np.testing.assert_allclose(r0[k], one[k], rtol=TOL, atol=TOL)


def test_torch_port_two_process_tp_train_matches_one_process(data,
                                                             tmp_path):
    base = ["train", "--device", "cpu", "-b", "4", "--epochs", "2",
            "--norm", "--name", "run", "--hu1", "32", "--hu2", "8",
            "--hu3", "8", "--wd", "0.1",
            "--data_root", str(tmp_path / "data")] + data
    TCLI.main(base + ["--save_root", str(tmp_path / "single")])
    port = _free_port()
    procs = [_spawn(base + ["--tp", "2", "--save_root",
                            str(tmp_path / f"r{r}")], r, port, tmp_path)
             for r in (0, 1)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    keys = ("stage", "epoch", "train_loss", "valid_loss")
    want = [[e[k] for k in keys] for e in _log(tmp_path / "single", "run")]
    got = [[e[k] for k in keys] for e in _log(tmp_path / "r0", "run")]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL)
    assert os.listdir(tmp_path / "r1" / "run") == []
    for stage in (1, 2, 3):
        a, b = (torch.load(os.path.join(discover_latest(
            str(tmp_path / root / "run"), stage)[0], "params.pt"))
            ["state_dict"] for root in ("single", "r0"))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=k)


_TP_GRADS = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from a3gc_tpu_torch.config import MeshConfig, TrainConfig
from a3gc_tpu_torch.data import load_adjacency_template, load_stats
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
from a3gc_tpu_torch.parallel import initialize_multihost, make_mesh
from a3gc_tpu_torch.train import StageRunner, seeded_generator

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh = None
if rank >= 0:
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = make_mesh(MeshConfig(data=1, model=2), devices=["cpu"])
    assert mesh.model_rank == rank and mesh.model_group is not None
cfg = PoseNetConfig(net=N.GraphNetConfig(cell="a3gc", units_in=15,
                                         units_out=3, units_hidden=32),
                    rotsize=3)
params = init_pose_net(torch.Generator().manual_seed(0), cfg,
                       load_adjacency_template())
runner = StageRunner(2, cfg, params, TrainConfig(batch_size=4,
                                                 normalize=True),
                     2, stats=load_stats(), device="cpu", mesh=mesh)
raw = synthetic_packed_dataset(4, 10, seed=3)
if rank < 0:
    raw = {k: torch.as_tensor(v) for k, v in raw.items()}
loss = float(runner.train_step(raw, seeded_generator("cpu", 0, 0)))
master = runner.state.master if rank >= 0 else [runner.state.master]
grads = {"grad." + k: p.grad.numpy() for k, p in
         master[0].named_parameters()}
split = sorted(runner._split) if rank >= 0 else []
np.savez(out, loss=loss, split=np.asarray(split), **grads,
         **{"param." + k: p.detach().numpy()
            for k, p in runner.state.params.named_parameters()})
"""


def test_torch_port_two_process_tp_gradients_are_one_devices(tmp_path):
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TP_GRADS, str(r), port,
         str(tmp_path / f"{r}.npz")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1, -1)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    r0, r1, one = (np.load(tmp_path / f"{r}.npz") for r in (0, 1, -1))
    split = set(r0["split"].tolist())
    assert {"rnn1.kernel", "rnn1.attention.bs"} <= split
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=TOL)
    np.testing.assert_array_equal(r0["loss"], r1["loss"])
    names = [k[5:] for k in one.files if k.startswith("grad.")]
    assert len(names) > len(split) > 0
    for name in names:
        want = one["grad." + name]
        got = (np.concatenate([r0["grad." + name], r1["grad." + name]], -1)
               if name in split else r0["grad." + name])
        if name not in split:
            np.testing.assert_array_equal(r0["grad." + name],
                                          r1["grad." + name])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=name)
        np.testing.assert_array_equal(r0["param." + name],
                                      r1["param." + name])
        np.testing.assert_allclose(r0["param." + name], one["param." + name],
                                   rtol=TOL, atol=TOL, err_msg=name)
