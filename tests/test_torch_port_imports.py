"""The port stands alone: importing a3gc_tpu_torch and serving tiny a3gc,
ggru and TransPose cascades through StreamingCascade and a DIP net (bi- and
unidirectional) through DipStreamingSession on the CPU, a served step
through a3gc_tpu_torch.serve, .client and .cli, a checkpoint written,
discovered, restored, exported to a reference ``.tar`` and imported back
(a3gc_tpu_torch.utils, .compat.torch_export, .compat.torch_import, ``cli
convert-checkpoint``), ``forward_offline`` and ``pose_loss``, and evaluation (a synthetic SMPL
pickle loaded, the metrics, ``CascadeEvaluator`` in its three protocols,
``DipEvaluator``, ``compare_models``, ``cli evaluate``), and training
(``a3gc_tpu_torch.train``, the training feed, ``cli train`` of a cascade and
of DIP, ``cli stats``), and data preparation (``cli preprocess`` of a raw
DIP-IMU tree, ``cli convert-data``, ``cli worst-frames --render``), and the
mesh (``a3gc_tpu_torch.parallel``: its mesh, serving, multihost and tensor
modules, every export of the JAX package's ``parallel`` but the JAX-only
``shard_map_compat``, a sharded cascade, a mesh session, a mesh training
step and a tensor-parallel one), and the driver entry points
(``a3gc_tpu_torch.graft_entry``: ``entry()``, its export check,
``dryrun_multichip``) load no jax, flax or a3gc_tpu module. And
the port's ``parallel`` exports the JAX package's names; the package data
ships every kernel source and header, and the port has its console
script."""

import fnmatch
import json
import os
import subprocess
import sys
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import a3gc_tpu_torch
from a3gc_tpu_torch.data import load_adjacency_template, load_stats
from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                           StreamingCascade)
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                            init_pose_net)
from a3gc_tpu_torch.smpl import ParametricModel

def graph(cell, ui, uo, rot):
    return PoseNetConfig(net=N.GraphNetConfig(
        cell=cell, units_in=ui, units_out=uo, units_hidden=8), rotsize=rot)

def dense(ni, no, rot):
    return PoseNetConfig(net=N.DIPConfig(n_input=ni, n_output=no,
                                         n_hidden=8), rotsize=rot)

gen = torch.Generator().manual_seed(0)
nira = load_adjacency_template()
rng = np.random.default_rng(0)
cascades = [CascadeConfig(*(graph(cell, *d) for d in
                            ((12, 3, 3), (15, 3, 3), (15, 9, 9))))
            for cell in ("a3gc", "ggru")]
cascades.append(CascadeConfig(dense(72, 15, 3), dense(87, 69, 3),
                              dense(141, 135, 9)))
sessions = [StreamingCascade(
    tuple(init_pose_net(gen, c, nira) for c in cfg.stages), cfg,
    ParametricModel(), window=4, stats=load_stats(), normalize=True,
    streams=2, device="cpu") for cfg in cascades]
dip = dense(60, 135, 9)
sessions.append(DipStreamingSession(init_pose_net(gen, dip), dip,
                                    ParametricModel(), window=4,
                                    stats=load_stats(), streams=2,
                                    device="cpu"))
uni = PoseNetConfig(net=N.DIPConfig(n_hidden=8, bidirectional=False),
                    rotsize=9)
sessions.append(DipStreamingSession(init_pose_net(gen, uni), uni,
                                    ParametricModel(), window=4,
                                    stats=load_stats(), streams=2,
                                    device="cpu"))
for sess in sessions:
    pose = sess.step(rng.normal(size=(2, 4, 54)),
                     rng.normal(size=(2, 4, 18)))
    assert pose.shape == (2, 4, 24, 3, 3) and np.isfinite(pose).all()
# the serving stack: a buffered server on the CPU, one client over HTTP
import threading
import a3gc_tpu_torch.cli
from a3gc_tpu_torch.client import PoseClient
from a3gc_tpu_torch.serve import PoseServer
args = a3gc_tpu_torch.cli.build_parser().parse_args(
    ["serve", "--quality", "balanced"])
a3gc_tpu_torch.cli._apply_quality(args)
cfg = cascades[0]
srv = PoseServer(tuple(init_pose_net(gen, c, nira) for c in cfg.stages),
                 cfg, ParametricModel(), window=4, streams=2, port=0,
                 max_wait_ms=1.0, lookahead=args.lookahead,
                 history=args.history, device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
with PoseClient(*srv.address, timeout=30.0, retry_s=2.0) as c:
    served = [c.step(rng.normal(size=(4, 54)), rng.normal(size=(4, 18)))
              for _ in range(3)]
    assert served[0] is None and served[2].shape == (4, 24, 3, 3)
    assert c.flush().shape == (4, 24, 3, 3)
    assert c.stats()["errors"] == 0
srv.shutdown()
# checkpoints: the port's format, the reference .tar both ways, the CLI
import os, tempfile
from a3gc_tpu_torch.compat import torch_export, torch_import
from a3gc_tpu_torch.models.pipeline import forward_offline, pose_loss
from a3gc_tpu_torch.utils import discover_latest, restore_params, save_params
tmp = tempfile.mkdtemp()
net = init_pose_net(gen, cfg.stage1, nira)
path = save_params(net, tmp, 1, 3, finetuning=True)
assert discover_latest(tmp, 1) == (path, 3)
back = restore_params(path, init_pose_net(gen, cfg.stage1, nira))
tar = os.path.join(tmp, "s1.tar")
torch_export.save_torch_checkpoint(
    tar, torch_export.graph_net_state_dict(back, "a3gc"))
again = torch_import.graph_net_params_from_state_dict(
    torch_import.load_torch_checkpoint(tar), "a3gc", cfg=cfg.stage1.net,
    device="cpu")
assert all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                             again.parameters()))
a3gc_tpu_torch.cli.main(["convert-checkpoint", "--torch", tar, "--model",
                         "a3gc", "--output", os.path.join(tmp, "c")])
out = forward_offline(back, cfg.stage1, ParametricModel(),
                      torch.zeros(1, 4, 15, 12))
assert out.shape == (1, 4, 15, 3)
assert float(pose_loss(out, out)) == 0.0
# evaluation: the body model, metrics, evaluators, worst frames, the CLI
from a3gc_tpu_torch.eval import (CascadeEvaluator, DipEvaluator,
                                 compare_models)
from a3gc_tpu_torch.metrics import PoseEvaluator, full_motion_metrics
from a3gc_tpu_torch.ops import kinematics, rotations
from a3gc_tpu_torch.smpl import (load_parametric_model,
                                 write_synthetic_smpl_pickle)
from a3gc_tpu_torch.utils import JsonlLogger, write_eval_report
smpl = write_synthetic_smpl_pickle(os.path.join(tmp, "smpl.pkl"),
                                   n_vertices=48)
model = load_parametric_model(smpl, device="cpu")
seqs = [{"ori": np.tile(np.eye(3, dtype=np.float32), (T, 6, 1, 1)
                        ).reshape(T, 54),
         "acc": rng.normal(size=(T, 18)).astype(np.float32),
         "pose": np.tile(np.eye(3, dtype=np.float32), (T, 15, 1, 1)
                         ).reshape(T, 135)} for T in (9, 14)]
ev = CascadeEvaluator(tuple(init_pose_net(gen, c, nira) for c in cfg.stages),
                      cfg, model, load_stats(), normalize=True, device="cpu")
for table in (ev.evaluate(seqs)[0], ev.evaluate_batched(seqs, 2)[0],
              ev.evaluate_streaming(seqs, window=4, lookahead=1)[0]):
    assert table.shape == (5, 2) and np.isfinite(table).all()
assert DipEvaluator(init_pose_net(gen, dip, nira), dip, model, load_stats(),
                    device="cpu").evaluate(seqs)[0].shape == (5, 2)
pose = np.tile(np.eye(3, dtype=np.float32), (8, 24, 1, 1))
assert full_motion_metrics(model, pose, pose).shape == (11, 2)
compare_models(model, [pose], [pose], [pose], k=1)
npz = os.path.join(tmp, "test.npz")
np.savez(npz, **{f"seq{i}_{k}": v for i, s in enumerate(seqs)
                 for k, v in s.items()})
os.chdir(tmp)
a3gc_tpu_torch.cli.main(["evaluate", "--device", "cpu", "--hu1", "8",
                         "--hu2", "8", "--hu3", "8", "--smpl", smpl,
                         "--datasets", npz])
assert os.path.isfile(os.path.join("evaluation_results",
                                   "a3gc_test.npz.txt"))
# training: the feed, the trainers, cli train and cli stats
import a3gc_tpu_torch.train
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
np.savez("train.npz", **synthetic_packed_dataset(4, 8))
for model in ("a3gc", "dip"):
    a3gc_tpu_torch.cli.main(["train", "--device", "cpu", "--model", model,
                             "-b", "2", "--epochs", "1", "--hu1", "8",
                             "--hu2", "8", "--hu3", "8", "--name", model,
                             "--save_root", "runs", "--train_data",
                             "train.npz", "--valid_data", "train.npz"])
    assert discover_latest(os.path.join("runs", model), 1)
a3gc_tpu_torch.cli.main(["stats", "--inputs", "train.npz", "--output",
                         "stats.npz"])
# data preparation: cli preprocess on a raw DIP-IMU tree, convert-data,
# worst-frames --render
import pickle
def rotations(n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q * np.sign(np.linalg.det(q))[:, None, None]
for subject in ("s_01", "s_09"):
    os.makedirs(os.path.join("raw_datasets", "DIP_IMU", subject))
    with open(os.path.join("raw_datasets", "DIP_IMU", subject, "01.pkl"),
              "wb") as f:
        pickle.dump({"imu_acc": rng.normal(size=(20, 17, 3)),
                     "imu_ori": rotations(20 * 17).reshape(20, 17, 3, 3),
                     "gt": rng.normal(scale=0.3, size=(20, 72))}, f)
a3gc_tpu_torch.cli.main(["preprocess", "--device", "cpu", "--dataset",
                         "dipimu", "--split", "test", "--data_root", ".",
                         "--smpl", smpl, "--output", "dip_test.npz"])
from a3gc_tpu_torch.data.factory.dipimu import load_test_sequences
assert [s["ori"].shape for s in load_test_sequences("dip_test.npz")] == \
    [(8, 54)]
torch.save({k: torch.as_tensor(v) for k, v in
            synthetic_packed_dataset(2, 8).items()}, "packed.pt")
a3gc_tpu_torch.cli.main(["convert-data", "--torch", "packed.pt", "--output",
                         "converted.npz"])
for sub in ("gt", "a", "b"):
    os.makedirs(os.path.join("dumps", sub))
    with open(os.path.join("dumps", sub, "000.p"), "wb") as f:
        pickle.dump(rotations(24 * 24).reshape(24, 24, 3, 3), f)
a3gc_tpu_torch.cli.main(["worst-frames", "--device", "cpu", "--smpl", smpl,
                         "--gt", "dumps/gt", "--pred_a", "dumps/a",
                         "--pred_b", "dumps/b", "--k", "1", "--output",
                         "best_worst", "--render"])
assert os.path.isfile(os.path.join("best_worst", "respect_tp", "worst",
                                   "gt.p"))
assert any(f.endswith(".png") for f in os.listdir(
    os.path.join("best_worst", "respect_tp", "worst")))
# the mesh: a3gc_tpu_torch.parallel (mesh, serving, multihost) on two
# CPU shards: the sharded cascade, a mesh session, a mesh training step
import a3gc_tpu_torch.parallel.multihost
from a3gc_tpu_torch.parallel import (cascade_apply_sharded, fetch_replicated,
                                     make_mesh)
mesh = make_mesh(devices=["cpu", "cpu"])
p3 = tuple(init_pose_net(gen, c, nira) for c in cfg.stages)
assert cascade_apply_sharded(p3, cfg, ParametricModel(),
                             torch.zeros(2, 4, 15, 12),
                             mesh).shape == (8, 24, 3, 3)
meshed = StreamingCascade(p3, cfg, ParametricModel(), window=4, streams=2,
                          mesh=mesh)
assert meshed.step(rng.normal(size=(2, 4, 54)),
                   rng.normal(size=(2, 4, 18))).shape == (2, 4, 24, 3, 3)
runner = a3gc_tpu_torch.train.StageRunner(
    1, cfg.stage1, p3[0], a3gc_tpu_torch.config.TrainConfig(batch_size=2),
    1, device="cpu", mesh=mesh)
runner.train_step(synthetic_packed_dataset(2, 4),
                  a3gc_tpu_torch.train.seeded_generator("cpu", 0))
assert fetch_replicated(runner.state.params)
import a3gc_tpu_torch.parallel as TPAR
import a3gc_tpu_torch.parallel.tensor
for name in ("batch_sharding", "make_mesh", "param_sharding", "replicate",
             "shard_batch", "shard_params", "fetch_replicated",
             "initialize_multihost", "is_coordinator",
             "cascade_apply_sharded"):
    assert name in TPAR.__all__ and callable(getattr(TPAR, name)), name
tp_mesh = make_mesh(a3gc_tpu_torch.config.MeshConfig(data=1, model=2),
                    devices=["cpu", "cpu"])
tp_cfg = PoseNetConfig(net=N.GraphNetConfig(cell="a3gc", units_in=12,
                                            units_out=3, units_hidden=32),
                       rotsize=3)
tp_runner = a3gc_tpu_torch.train.StageRunner(
    1, tp_cfg, init_pose_net(gen, tp_cfg, nira),
    a3gc_tpu_torch.config.TrainConfig(batch_size=2), 1, device="cpu",
    mesh=tp_mesh)
assert len(TPAR.shard_params(tp_runner.state.params, tp_mesh)) == 2
tp_runner.train_step(synthetic_packed_dataset(2, 4),
                     a3gc_tpu_torch.train.seeded_generator("cpu", 0))
assert tp_runner._split and fetch_replicated(tp_runner.state.params)
# the driver entry points: entry()'s forward, its torch.export check and
# dryrun_multichip over eight CPU shards
import a3gc_tpu_torch.graft_entry
assert a3gc_tpu_torch.graft_entry.main(["--device", "cpu"]) == 0
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "a3gc_tpu"))
print(json.dumps(banned))
"""


def test_torch_port_imports_no_jax_or_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_torch_port_parallel_exports_the_jax_packages_names():
    import a3gc_tpu.parallel as JP
    import a3gc_tpu_torch.parallel as TP
    jax_names = {n for n, v in vars(JP).items()
                 if not n.startswith("_") and callable(v)}
    assert "param_sharding" in jax_names and "shard_params" in jax_names
    assert jax_names - {"shard_map_compat"} <= set(TP.__all__)
    assert all(callable(getattr(TP, n)) for n in TP.__all__)


def test_torch_port_package_data_ships_every_kernel_source():
    """An installed package builds its kernels from the sources it ships:
    every file under ``ops/csrc`` (the ``.cu`` sources and the ``.cuh``
    header they include) matches a package-data pattern of the port."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "a3gc_tpu_torch"]
    csrc = os.path.join(REPO, "a3gc_tpu_torch", "ops", "csrc")
    files = sorted(os.listdir(csrc))
    assert any(f.endswith(".cuh") for f in files)
    for name in files:
        rel = "ops/csrc/" + name
        assert any(fnmatch.fnmatch(rel, p) for p in patterns), rel


def test_torch_port_has_its_console_script():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)["project"]
    assert project["scripts"]["a3gc-tpu-torch"] == "a3gc_tpu_torch.cli:main"
    assert project["scripts"]["a3gc-tpu"] == "a3gc_tpu.cli:main"
