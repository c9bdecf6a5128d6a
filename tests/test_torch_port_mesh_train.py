"""Data-parallel training of the port on the CPU (shards on a mesh of
repeated CPU devices) against the single-device port and the JAX package's
mesh runners on its virtual CPU devices, dropout and teacher-forcing noise
off: ``put_device_sharded`` and ``Sampler.iter_indices_sharded`` bit-equal
to JAX's (short shards, ``pad_remainder`` and ``drop_remainder``);
``StageRunner(mesh=)`` steps within 2e-6 of the single-device port and
1e-5 of JAX's mesh step, over a padded tail batch and a batch whose shards
carry unequal weights (where the mean of per-shard means is not the
batch's loss); ``--accum`` over a sharded corpus against JAX's;
``DIPRunner(mesh=)``; validation on the mesh; ``_mesh_eval_chunk``; a
one-shard mesh bit-equal to no mesh, dropout and noise on."""

import jax
import numpy as np
import pytest
import torch

from a3gc_tpu.data import pipeline as JDP
from a3gc_tpu.parallel import make_mesh as jax_make_mesh
from a3gc_tpu.train.loop import _mesh_eval_chunk as jax_eval_chunk
from a3gc_tpu_torch.config import TrainConfig
from a3gc_tpu_torch.data import load_adjacency_template, load_stats
from a3gc_tpu_torch.data import pipeline as TDP
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
from a3gc_tpu_torch.parallel import make_mesh
from a3gc_tpu_torch.train import StageRunner, seeded_generator
from a3gc_tpu_torch.train.loop import _mesh_eval_chunk

from torch_port_oracle import jax_leaf, train_runners

torch.set_num_threads(1)

LOCAL_TOL = 2e-6        # the same math, sums reordered over the shards
JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def packed():
    return synthetic_packed_dataset(n_seqs=10, seq_len=12, seed=0)


def _cpu(n):
    return make_mesh(devices=["cpu"] * n)


def _jax(n):
    return jax_make_mesh(devices=jax.devices()[:n])


def _params_close(a, b, atol):
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   atol=atol, err_msg=name)


def _jax_params_close(runner, state, atol):
    for name, t in runner.state.params.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(),
                                   jax_leaf(state.params, name), atol=atol,
                                   err_msg=name)


def test_torch_port_put_device_sharded_matches_jax(packed):
    ours = TDP.put_device_sharded(packed, _cpu(4))
    ref = JDP.put_device_sharded(packed, _jax(4))
    assert (ours.rows, ours.n_data, set(ours.keys())) == (3, 4, set(packed))
    for k in packed:
        np.testing.assert_array_equal(
            torch.cat([s[k] for s in ours.shards]).numpy(),
            np.asarray(ref[k]))


@pytest.mark.parametrize("n,B,D,pad", [(10, 8, 4, True), (10, 4, 2, False),
                                       (9, 6, 3, True)])
def test_torch_port_iter_indices_sharded_matches_jax(n, B, D, pad):
    data = {"x": np.arange(n)}
    for epoch in range(2):
        kw = dict(shuffle=True, seed=(3, epoch), pad_remainder=pad)
        ours = list(TDP.Sampler(data, B, **kw).iter_indices_sharded(D))
        ref = list(JDP.Sampler(data, B, **kw).iter_indices_sharded(D))
        assert len(ours) == len(ref) > 0
        for (i, w), (ri, rw) in zip(ours, ref):
            np.testing.assert_array_equal(i, ri)
            assert (w is None) == (rw is None)
            if w is not None:
                np.testing.assert_array_equal(w, rw)
    with pytest.raises(ValueError, match="sharded epoch is empty"):
        # 9 rows on 4 shards of 3: the last shard holds none
        next(TDP.Sampler({"x": np.arange(9)}, 8,
                         shuffle=False).iter_indices_sharded(4))


def test_torch_port_mesh_eval_chunk_matches_jax():
    for eval_b in (1, 3, 8, 130):
        for n in (1, 2, 4):
            assert _mesh_eval_chunk(eval_b, _cpu(n)) == jax_eval_chunk(
                eval_b, _jax(n))
    assert _mesh_eval_chunk(7, None) == jax_eval_chunk(7, None) == 7


def test_torch_port_mesh_steps_match_single_device_and_jax(packed):
    """Three steps of a padded epoch (the tail batch's real rows all in
    the first shard) on 4 shards: within 2e-6 of one device, 1e-5 of JAX's
    mesh runner; validation on the mesh likewise."""
    kw = dict(batch_size=8, eval_batch_size=4)
    jr, tr = train_runners("a3gc", 2, mesh=_cpu(4), jax_mesh=_jax(4), **kw)
    _, single = train_runners("a3gc", 2, **kw)
    state = jr.state
    sampler = TDP.Sampler(packed, 8, seed=1, pad_remainder=True)
    for i, raw in enumerate(list(sampler) + list(sampler)[:1]):
        state, jloss = jr.train_step(state, jr._put(raw),
                                     jax.random.PRNGKey(i))
        loss = tr.train_step(raw, seeded_generator("cpu", i))
        want = single.train_step({k: torch.as_tensor(v)
                                  for k, v in raw.items()},
                                 seeded_generator("cpu", i))
        np.testing.assert_allclose(float(loss), float(want), rtol=LOCAL_TOL)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=JAX_TOL)
    _params_close(tr.state.params, single.state.params, LOCAL_TOL)
    _jax_params_close(tr, state, JAX_TOL)
    jr.state = state
    valid = TDP.Sampler(packed, 8, shuffle=False, pad_remainder=True)
    np.testing.assert_allclose(tr.eval_epoch(valid),
                               single.eval_epoch(valid), rtol=LOCAL_TOL)
    np.testing.assert_allclose(
        tr.eval_epoch(valid),
        jr.eval_epoch(JDP.Sampler(packed, 8, shuffle=False,
                                  pad_remainder=True)), rtol=JAX_TOL)


def test_torch_port_mesh_step_with_unequal_shard_weights(packed):
    """Shard weights 2, 1, 4, 0 of 8 rows: the mesh step takes the batch's
    weighted loss and gradient (one division by the whole weight), not the
    mean of the shards' means, which differs here."""
    kw = dict(batch_size=8)
    _, tr = train_runners("a3gc", 1, mesh=_cpu(4), **kw)
    _, single = train_runners("a3gc", 1, **kw)
    raw = {k: v[:8] for k, v in packed.items()}
    raw["_weight"] = np.array([1, 1, 0, 1, 1, 1, 0, 0], np.float32)
    with torch.no_grad():
        shard_means = [float(single.loss(single.state.params, {
            k: torch.as_tensor(v[2 * d:2 * d + 2]) for k, v in raw.items()},
            None)) for d in range(4)]
    want = single.train_step({k: torch.as_tensor(v) for k, v in raw.items()},
                             seeded_generator("cpu", 0))
    loss = tr.train_step(raw, seeded_generator("cpu", 0))
    np.testing.assert_allclose(float(loss), float(want), rtol=LOCAL_TOL)
    assert abs(np.mean(shard_means) - float(want)) > 1e-3 * float(want)
    _params_close(tr.state.params, single.state.params, LOCAL_TOL)


def test_torch_port_mesh_accum_over_sharded_corpus_matches_jax(packed):
    """``--accum 2`` over a corpus sharded on 2 devices: each microbatch
    gathers half of every shard's rows; one epoch against JAX's."""
    kw = dict(batch_size=8, accum_steps=2)
    jr, tr = train_runners("a3gc", 3, mesh=_cpu(2), jax_mesh=_jax(2), **kw)
    ours = TDP.put_device_sharded(packed, tr.mesh)
    ref = JDP.put_device_sharded(packed, jr.mesh)
    loss = tr.train_epoch(TDP.Sampler(packed, 8, seed=(0, 4),
                                      pad_remainder=True, device_data=ours),
                          seed=(0, 4))
    jloss = jr.train_epoch(JDP.Sampler(packed, 8, seed=(0, 4),
                                       pad_remainder=True, device_data=ref),
                           jax.random.PRNGKey(4))
    np.testing.assert_allclose(loss, jloss, rtol=JAX_TOL)
    _jax_params_close(tr, jr.state, JAX_TOL)
    np.testing.assert_allclose(
        tr.eval_epoch(TDP.Sampler(packed, 8, shuffle=False,
                                  pad_remainder=True, device_data=ours)),
        jr.eval_epoch(JDP.Sampler(packed, 8, shuffle=False,
                                  pad_remainder=True, device_data=ref)),
        rtol=JAX_TOL)
    with pytest.raises(ValueError, match="put_device_sharded"):
        tr.train_epoch(TDP.Sampler(packed, 8, device_data=TDP.put_device(
            packed, "cpu")))


def test_torch_port_dip_runner_on_mesh(packed):
    kw = dict(batch_size=4)
    jr, tr = train_runners("dip", 1, mesh=_cpu(2), jax_mesh=_jax(2), **kw)
    _, single = train_runners("dip", 1, **kw)
    state = jr.state
    for i, raw in enumerate(list(TDP.Sampler(packed, 4, seed=2,
                                             pad_remainder=True))[:2]):
        state, jloss = jr.train_step(state, jr._put(raw),
                                     jax.random.PRNGKey(i))
        loss = tr.train_step(raw, seeded_generator("cpu", i))
        single.train_step({k: torch.as_tensor(v) for k, v in raw.items()},
                          seeded_generator("cpu", i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=JAX_TOL)
    _params_close(tr.state.params, single.state.params, LOCAL_TOL)
    _jax_params_close(tr, state, JAX_TOL)


def test_torch_port_one_shard_mesh_is_bit_equal_with_dropout_and_noise(
        packed):
    """Dropout, teacher-forcing noise and a padded epoch on: a one-shard
    mesh draws the unsharded step's numbers and takes its steps bit for
    bit; a 2-shard mesh draws them at the global batch too."""
    cfg = PoseNetConfig(net=TN.GraphNetConfig(cell="a3gc", units_in=15,
                                              units_out=3, units_hidden=8),
                        rotsize=3)
    params = init_pose_net(torch.Generator().manual_seed(0), cfg,
                           load_adjacency_template())
    tc = TrainConfig(batch_size=4, normalize=True)

    def run(mesh):
        r = StageRunner(2, cfg, params, tc, 3, stats=load_stats(),
                        device="cpu", mesh=mesh)
        losses = [r.train_epoch(TDP.Sampler(packed, 4, seed=(0, e),
                                            pad_remainder=True), seed=(0, e))
                  for e in range(2)]
        return r, losses

    single, want = run(None)
    one, got = run(_cpu(1))
    assert got == want
    for a, b in zip(one.state.params.parameters(),
                    single.state.params.parameters()):
        assert torch.equal(a, b)
    two, got = run(_cpu(2))
    np.testing.assert_allclose(got, want, rtol=LOCAL_TOL)
    _params_close(two.state.params, single.state.params, LOCAL_TOL)
