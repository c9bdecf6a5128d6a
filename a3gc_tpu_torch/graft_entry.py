r"""Driver entry points of the port: the flagship forward and a multi-device
dry run (counterpart of the repository's ``__graft_entry__.py``).

``entry()`` returns the forward step of the flagship model (the A3GC-TP
three-stage cascade: IMU → leaf positions → all positions → rotations →
IK) and its example arguments. ``dryrun_multichip(n)`` builds an n-device
(data × model) mesh and runs, at tiny shapes, a data- and tensor-parallel
training epoch, an epoch on a device-sharded corpus, the full-width
forward split over ``data``, a sharded narrow forward and the streaming
sessions on a data mesh.

    python -m a3gc_tpu_torch.graft_entry [--device cpu]

On the card it builds ``entry()`` there, checks that ``torch.export``
takes its forward (``compile check: True``) and runs
``dryrun_multichip(8)`` over the visible cards listed in turn to make 8
(a card listed twice runs its shards in turn); ``--device cpu`` runs the
same on eight CPU shards.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["entry", "compile_check", "dryrun_multichip"]

# the kinematic tree of the synthetic body model (SMPL's)
_PARENT = (None, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
           12, 13, 14, 16, 17, 18, 19, 20, 21)


def _body_model(n_vertices: int = 432, device=None):
    r"""Synthetic SMPL body model (the official schema's arrays) for IK and
    the metrics, on ``device`` (default: the card)."""
    from a3gc_tpu_torch.smpl import ParametricModel, synthetic_smpl_data

    data = synthetic_smpl_data(n_vertices=n_vertices)
    return ParametricModel(
        _PARENT, j_regressor=data["J_regressor"],
        skinning_weights=data["weights"], posedirs=data["posedirs"],
        shapedirs=data["shapedirs"], v_template=data["v_template"],
        joints_template=data["J"], faces=data["f"],
        device="cuda" if device is None else device)


def _cascade(model_name: str = "a3gc", hidden=(256, 64, 128),
             precision: str = "default", backend: str = "auto", device=None,
             gen: Optional[torch.Generator] = None):
    r"""A randomly initialized three-stage cascade of any model family
    (the reference sizes of the A3GC-TP and TransPose training scripts) on
    ``device`` (default: the card), its weights drawn from ``gen``
    (default: ``torch.Generator`` seeded 0). Returns (cfg, params3)."""
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                                init_pose_net)

    if model_name == "tp":
        def stage(ni, no, h, rot):
            return PoseNetConfig(net=N.DIPConfig(
                n_input=ni, n_output=no, n_hidden=h, precision=precision,
                backend=backend), rotsize=rot)

        cfg = CascadeConfig(stage1=stage(72, 15, hidden[0], 3),
                            stage2=stage(87, 69, hidden[1], 3),
                            stage3=stage(141, 135, hidden[2], 9))
    else:
        def stage(units_in, units_out, h, rotsize):
            return PoseNetConfig(
                net=N.GraphNetConfig(cell=model_name, units_in=units_in,
                                     units_out=units_out, units_hidden=h,
                                     precision=precision, backend=backend),
                rotsize=rotsize)

        cfg = CascadeConfig(stage1=stage(12, 3, hidden[0], 3),
                            stage2=stage(15, 3, hidden[1], 3),
                            stage3=stage(15, 9, hidden[2], 9))
    gen = torch.Generator().manual_seed(0) if gen is None else gen
    nira = load_adjacency_template()
    dev = "cuda" if device is None else device
    params3 = tuple(init_pose_net(gen, c, nira).to(dev) for c in cfg.stages)
    return cfg, params3


def _flagship(hidden=(256, 64, 128), seq_len: int = 300, batch: int = 1,
              model_name: str = "a3gc", precision: str = "default",
              backend: str = "auto", device=None):
    r"""(cfg, params3, body model, zero IMU [B, T, 15, 12] or [B, T, 72])
    on ``device`` (default: the card)."""
    from a3gc_tpu_torch._device import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    cfg, params3 = _cascade(model_name, hidden, precision, backend, dev)
    model = _body_model(device=dev)
    feature = (15, 12) if cfg.is_graph else (72,)
    imu = torch.zeros((batch, seq_len) + feature, dtype=torch.float32,
                      device=dev)
    return cfg, params3, model, imu


def entry(device=None):
    r"""``(forward, (params3, imu))``: ``forward(params3, imu)`` is the
    flagship cascade's ``cascade_apply`` (A3GC, hidden 256 / 64 / 128, one
    stream of 300 frames, precision "default") on ``device`` (default: the
    card), returning the full local pose [300, 24, 3, 3]."""
    from a3gc_tpu_torch.models.pipeline import cascade_apply

    cfg, params3, model, imu = _flagship(device=device)
    dev = imu.device

    def forward(params3, imu):
        return cascade_apply(params3, cfg, model, imu, device=dev)

    return forward, (params3, imu)


class _Forward(torch.nn.Module):
    r"""``entry()``'s forward as a module holding the nets, for
    ``torch.export``."""

    def __init__(self, forward, params3):
        super().__init__()
        self.nets = torch.nn.ModuleList(params3)
        self._forward = forward

    def forward(self, imu):
        return self._forward(tuple(self.nets), imu)


def compile_check(forward, params3, imu) -> bool:
    r"""Whether ``torch.export`` takes ``forward`` at these arguments (the
    port's form of ``jax.jit(fn).lower(...).compile()``): the recurrent
    layers enter the program as the registered kernel ops."""
    with torch.no_grad():
        ep = torch.export.export(_Forward(forward, params3), (imu,),
                                 strict=False)
    return ep is not None


def _finite(x) -> bool:
    return bool(np.isfinite(np.asarray(x)).all())


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
    r"""Tiny-shape runs of every data- and tensor-parallel path over an
    n-device mesh: ``devices`` (a list that may repeat a device: its shards
    then run in turn) or, by default, the first n visible cards
    (``RuntimeError`` when there are fewer)."""
    from a3gc_tpu_torch.config import MeshConfig, TrainConfig
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.data import pipeline as DPipe
    from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
    from a3gc_tpu_torch.eval.streaming import StreamingCascade
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
    from a3gc_tpu_torch.parallel import make_mesh
    from a3gc_tpu_torch.parallel.serving import cascade_apply_sharded
    from a3gc_tpu_torch.train import StageRunner

    if devices is None:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {have} cards (pass "
                f"devices=, a list that may repeat a device, e.g. "
                f"['cpu'] * {n_devices} or ['cuda:0'] * {n_devices})")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, devices= lists "
                           f"{len(devices)}")

    # the mesh: data-parallel x tensor-parallel, what `cli train --mesh
    # --tp 2` builds
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data_par = n_devices // model_par
    mesh = make_mesh(MeshConfig(data=data_par, model=model_par), devices)

    nira = load_adjacency_template()
    cfg = PoseNetConfig(
        net=N.GraphNetConfig(cell="a3gc", units_in=15, units_out=9,
                             units_hidden=16),   # 4H = 64 splits over TP
        rotsize=9)
    params = init_pose_net(torch.Generator().manual_seed(0), cfg, nira)

    batch = 2 * data_par
    runner = StageRunner(3, cfg, params, TrainConfig(batch_size=batch),
                         steps_per_epoch=1, mesh=mesh)
    packed = synthetic_packed_dataset(n_seqs=batch, seq_len=8, seed=0)
    loss = runner.train_epoch(DPipe.Sampler(packed, batch, seed=0), seed=0)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: training loss {loss}")
    if model_par > 1 and "rnn1.kernel" not in runner._split:
        raise RuntimeError("dryrun_multichip: rnn1's kernel is not split "
                           "over the model group")

    # a device-sharded corpus: each data shard holds 1/D of it and gathers
    # its own batch rows; one epoch must run and stay finite
    dd = DPipe.put_device_sharded(packed, mesh)
    loss = runner.train_epoch(
        DPipe.Sampler(packed, batch, seed=1, pad_remainder=True,
                      device_data=dd), seed=1)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: sharded-corpus loss {loss}")

    # two steps a dispatch (`--steps_per_dispatch 2`): the port runs them
    # one by one, the same parameter trajectory
    runner_m = StageRunner(
        3, cfg, params,
        TrainConfig(batch_size=batch, steps_per_dispatch=2),
        steps_per_epoch=2, mesh=mesh)
    packed_m = synthetic_packed_dataset(n_seqs=2 * batch, seq_len=8, seed=2)
    dd_m = DPipe.put_device_sharded(packed_m, mesh)
    loss = runner_m.train_epoch(
        DPipe.Sampler(packed_m, batch, seed=2, pad_remainder=True,
                      device_data=dd_m), seed=2)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: two-step loss {loss}")

    # entry()'s full-width cascade with its streams split over `data`
    first = devices[0]
    cfg_f, params3, body, imu = _flagship(device=first)
    imu = torch.zeros((data_par, 16) + tuple(imu.shape[2:]),
                      dtype=imu.dtype)
    out = cascade_apply_sharded(params3, cfg_f, body, imu, mesh)
    if not _finite(out.cpu()):
        raise RuntimeError("dryrun_multichip: sharded full-width forward")

    # sharded multi-stream serving at narrow width
    cfg_s, params3_s, body, imu_s = _flagship(
        hidden=(16, 16, 16), seq_len=8, batch=2 * data_par, device=first)
    out = cascade_apply_sharded(params3_s, cfg_s, body, imu_s, mesh)
    if not _finite(out.cpu()):
        raise RuntimeError("dryrun_multichip: sharded narrow forward")

    # online serving: the stateful windowed cascade, slots split over a
    # data-only mesh, with a per-slot reset and an idle slot
    dmesh = make_mesh(MeshConfig(data=n_devices, model=1), devices)
    S, W = 2 * n_devices, 6
    sess = StreamingCascade(params3_s, cfg_s, body, window=W, streams=S,
                            mesh=dmesh)
    rng_np = np.random.default_rng(0)
    ori = rng_np.normal(size=(S, W, 54)).astype(np.float32)
    acc = rng_np.normal(size=(S, W, 18)).astype(np.float32)
    p1 = sess.step(ori, acc)
    sess.reset(stream=1)                       # one client ends
    active = np.ones(S, np.float32)
    active[0] = 0.0                            # one client idles this tick
    p2 = sess.step(ori, acc, active=active)
    if not (_finite(p1) and _finite(p2)):
        raise RuntimeError("dryrun_multichip: streaming poses not finite")

    # buffered-context serving on the mesh: lookahead + history emit once
    # the buffers hold their capacity of 3 windows
    sess = StreamingCascade(params3_s, cfg_s, body, window=W, streams=S,
                            lookahead=1, history=1, mesh=dmesh)
    emitted_any = False
    for _ in range(4):
        ori_k = rng_np.normal(size=(S, W, 54)).astype(np.float32)
        pose, em = sess.step(ori_k, acc)
        if pose is not None:
            if not _finite(pose[em]):
                raise RuntimeError("dryrun_multichip: buffered poses not "
                                   "finite")
            emitted_any = True
    if not emitted_any:
        raise RuntimeError("dryrun_multichip: the buffered mesh session "
                           "never emitted")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m a3gc_tpu_torch.graft_entry",
        description="Build the flagship forward, check that torch.export "
                    "takes it, and run dryrun_multichip(min(8, devices)).")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the visible cards) or 'cpu'")
    args = p.parse_args(argv)
    fn, (params3, imu) = entry(device=args.device)
    print("compile check:", compile_check(fn, params3, imu), flush=True)
    if torch.device(args.device).type == "cpu":
        devices = ["cpu"] * 8
    else:
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(8)]
    dryrun_multichip(8, devices=devices)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
