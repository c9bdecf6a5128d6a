"""The port's meshes and data-parallel cascade (a3gc_tpu_torch.parallel)
against the JAX package's on the CPU: ``MeshConfig`` and ``make_mesh``
(repeated CPU devices stand for cards; torch has one CPU device), the
placement helpers, and ``cascade_apply_sharded`` on 2 and 4 shards against
JAX's ``cascade_apply_sharded`` on a 2- and 4-device JAX mesh (the virtual
CPU devices of the test rig) and against the port's ``cascade_apply``:
1e-5 absolute over valid frames with a ragged frame mask, hidden 8, the
A3GC, G-GRU and TransPose cascades. A one-device mesh is the single-device
path bit for bit; a stream count the data axis cannot divide raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu import config as JC
from a3gc_tpu.parallel import cascade_apply_sharded as jax_sharded
from a3gc_tpu.parallel import make_mesh as jax_make_mesh
from a3gc_tpu_torch import config as TC
from a3gc_tpu_torch.compat.from_jax import cascade_params_from_jax
from a3gc_tpu_torch.models.pipeline import cascade_apply
from a3gc_tpu_torch.parallel import (batch_sharding, cascade_apply_sharded,
                                     make_mesh, replicate, shard_batch)
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import cascades, to_jnp

torch.set_num_threads(1)

TOL = 1e-5
B, T = 4, 8


@pytest.fixture(scope="module")
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


def _jax_sharded(params, jcfg, model, imu, n, mask):
    """JAX's ``cascade_apply_sharded`` on an n-device JAX mesh, under jit
    (as the JAX evaluator calls it; eager ``shard_map`` dispatches op by
    op)."""
    mesh = jax_make_mesh(devices=jax.devices()[:n])
    fn = jax.jit(lambda p, x, m: jax_sharded(p, jcfg, model, x, mesh,
                                             frame_mask=m))
    return np.asarray(fn(to_jnp(params), jnp.asarray(imu),
                         jnp.asarray(mask)))


def _inputs(kind, seed=40):
    rng = np.random.default_rng(seed)
    shape = (B, T, 72) if kind == "tp" else (B, T, 15, 12)
    imu = rng.normal(size=shape).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 5:] = 0.0
    mask[2, 2:] = 0.0
    mask[3, :] = 0.0
    return imu, mask


def test_torch_port_mesh_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TC.MeshConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JC.MeshConfig)}
    assert ours == ref
    assert TC.MeshConfig(data=3, model=2).n_devices == 6
    assert TC.TrainConfig().mesh == TC.MeshConfig()
    assert TC.TrainConfig().mesh.n_devices == JC.TrainConfig().mesh.n_devices


def test_torch_port_make_mesh_over_repeated_cpu_devices():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4, "model": 1}
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert (mesh.process_index, mesh.process_count, mesh.first_shard) == (
        0, 1, 0)
    assert make_mesh(TC.MeshConfig(data=2), devices=["cpu"] * 4).shape == {
        "data": 2, "model": 1}
    assert batch_sharding(mesh, 8) == [slice(0, 2), slice(2, 4),
                                       slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="must divide"):
        batch_sharding(mesh, 6)
    with pytest.raises(ValueError, match="needs"):
        make_mesh(TC.MeshConfig(data=5), devices=["cpu"] * 4)
    tp = make_mesh(TC.MeshConfig(data=2, model=2), devices=["cpu"] * 4)
    assert tp.shape == {"data": 2, "model": 2}
    assert tp.model_devices == ((torch.device("cpu"),) * 2,) * 2
    assert tp.devices == (torch.device("cpu"),) * 2      # the groups' leads
    assert batch_sharding(tp, 8) == [slice(0, 4), slice(4, 8)]
    with pytest.raises(ValueError, match="needs"):
        make_mesh(TC.MeshConfig(data=3, model=2), devices=["cpu"] * 4)


def test_torch_port_shard_batch_and_replicate():
    mesh = make_mesh(devices=["cpu"] * 2)
    batch = {"a": np.arange(12, dtype=np.float32).reshape(4, 3),
             "b": (torch.arange(4), np.ones((4, 2)))}
    shards = shard_batch(batch, mesh)
    assert len(shards) == 2
    np.testing.assert_array_equal(shards[1]["a"].numpy(), batch["a"][2:])
    assert torch.equal(shards[0]["b"][0], torch.arange(2))
    assert isinstance(shards[0]["b"][1], torch.Tensor)
    net = torch.nn.Linear(2, 2)
    copies = replicate((net, torch.zeros(3)), mesh)
    # one device: both shards share the caller's module, not a copy
    assert copies[0] is copies[1] and copies[0][0] is net


@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp"])
def test_torch_port_one_device_mesh_is_the_single_device_path(kind):
    _, tcfg, params = cascades(kind)
    p3 = cascade_params_from_jax(params, device="cpu")
    imu, mask = _inputs(kind)
    want = cascade_apply(p3, tcfg, ParametricModel(), imu, frame_mask=mask,
                         device="cpu")
    got = cascade_apply_sharded(p3, tcfg, ParametricModel(), imu,
                                make_mesh(devices=["cpu"]), frame_mask=mask)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_torch_port_sharded_cascade_matches_jax_mesh(jax_model, n):
    jcfg, tcfg, params = cascades("a3gc")
    imu, mask = _inputs("a3gc")
    ref = _jax_sharded(params, jcfg, jax_model, imu, n, mask)
    p3 = cascade_params_from_jax(params, device="cpu")
    got = cascade_apply_sharded(p3, tcfg, ParametricModel(), imu,
                                make_mesh(devices=["cpu"] * n),
                                frame_mask=mask).numpy()
    local = cascade_apply(p3, tcfg, ParametricModel(), imu,
                          frame_mask=mask, device="cpu").numpy()
    valid = mask.reshape(-1) > 0
    assert got.shape == ref.shape == (B * T, 24, 3, 3)
    np.testing.assert_allclose(got[valid], ref[valid], atol=TOL)
    np.testing.assert_allclose(got[valid], local[valid], atol=TOL)


@pytest.mark.parametrize("kind", ["ggru", "tp"])
def test_torch_port_sharded_families_match_jax_mesh(jax_model, kind):
    jcfg, tcfg, params = cascades(kind)
    imu, mask = _inputs(kind, seed=41)
    ref = _jax_sharded(params, jcfg, jax_model, imu, 2, mask)
    got = cascade_apply_sharded(cascade_params_from_jax(params, device="cpu"),
                                tcfg, ParametricModel(), imu,
                                make_mesh(devices=["cpu"] * 2),
                                frame_mask=mask).numpy()
    valid = mask.reshape(-1) > 0
    np.testing.assert_allclose(got[valid], ref[valid], atol=TOL)


def test_torch_port_sharded_cascade_refuses_indivisible_streams():
    _, tcfg, params = cascades("a3gc")
    imu, _ = _inputs("a3gc")
    with pytest.raises(ValueError, match="must divide"):
        cascade_apply_sharded(cascade_params_from_jax(params, device="cpu"),
                              tcfg, ParametricModel(), imu[:3],
                              make_mesh(devices=["cpu"] * 2))
