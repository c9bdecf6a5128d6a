"""Data-parallel serving and evaluation of the port on the CPU (slots split
over a mesh of repeated CPU devices): ``StreamingCascade(mesh=)`` on plain
windows and at K = P = 1 (the fused step) with a per-slot reset and an
idle slot against the JAX package's mesh session on a 2-device JAX mesh
(1e-5 over active slots, every carried state), a one-device mesh bit-equal
to no mesh; ``CascadeEvaluator(mesh=)`` batched and streaming against the
unsharded evaluator and JAX's mesh evaluator (1e-3 on the [5, 2] table);
``PoseServer(mesh=)`` serving a client and refusing ``/v1/recycle`` with
the JAX server's message."""

import threading

import jax
import numpy as np
import pytest
import torch

from a3gc_tpu.eval import run as JR
from a3gc_tpu.eval.streaming import StreamingCascade as JaxStreamingCascade
from a3gc_tpu.parallel import make_mesh as jax_make_mesh
from a3gc_tpu.smpl import load_parametric_model as jax_load
from a3gc_tpu.smpl import write_synthetic_smpl_pickle
from a3gc_tpu_torch.client import PoseClient, ServerError
from a3gc_tpu_torch.compat.from_jax import cascade_params_from_jax
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.eval import run as TR
from a3gc_tpu_torch.eval.streaming import StreamingCascade
from a3gc_tpu_torch.parallel import make_mesh
from a3gc_tpu_torch.serve import PoseServer
from a3gc_tpu_torch.smpl import ParametricModel, load_parametric_model

from torch_port_oracle import cascades, eval_sequences, state_leaves, to_jnp

torch.set_num_threads(1)

TOL = 1e-5
TABLE_TOL = 1e-3
S, W = 4, 4
# the JAX server's refusal (a3gc_tpu/serve.py), word for word
RECYCLE_REFUSED = ("recycle is not supported for --mesh serving (sharded "
                   "states; scale by replication)")


@pytest.fixture(scope="module")
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


@pytest.fixture(scope="module")
def a3gc():
    jcfg, tcfg, params = cascades("a3gc")
    return jcfg, tcfg, params, cascade_params_from_jax(params, device="cpu")


def _merged(shard_states):
    """A mesh session's per-shard states as one nest, slots concatenated."""
    if isinstance(shard_states[0], (tuple, list)):
        return tuple(_merged([s[i] for s in shard_states])
                     for i in range(len(shard_states[0])))
    return torch.cat(shard_states, dim=1)


def _plan():
    """Ticks: a reset of slot 1 after tick 1, slot 2 idle in tick 2."""
    idle = np.ones(S, np.float32)
    idle[2] = 0.0
    return [None, "reset", idle, None, None]


@pytest.mark.parametrize("K,P", [(0, 0), (1, 1)])
def test_torch_port_mesh_session_matches_jax_mesh_session(jax_model, a3gc,
                                                          K, P):
    jcfg, tcfg, params, p3 = a3gc
    stats = load_stats()
    ref = JaxStreamingCascade(to_jnp(params), jcfg, jax_model, window=W,
                              stats=stats, normalize=True, streams=S,
                              lookahead=K, history=P,
                              mesh=jax_make_mesh(devices=jax.devices()[:2]))
    sess = StreamingCascade(p3, tcfg, ParametricModel(), window=W,
                            stats=stats, normalize=True, streams=S,
                            lookahead=K, history=P,
                            mesh=make_mesh(devices=["cpu"] * 2))
    assert sess.fused == bool(K or P)
    rng = np.random.default_rng(50)
    for item in _plan():
        if isinstance(item, str):
            ref.reset(stream=1)
            sess.reset(stream=1)
            continue
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(size=(S, W, 18)).astype(np.float32)
        want = ref.step(ori, acc, active=item)
        got = sess.step(ori, acc, active=item)
        if K or P:
            (want, want_em), (got, got_em) = want, got
            np.testing.assert_array_equal(got_em, want_em)
            rows = got_em
        else:
            rows = (np.ones(S, bool) if item is None else item > 0)
        if rows.any():
            np.testing.assert_allclose(got[rows], np.asarray(want)[rows],
                                       atol=TOL)
        for a, b in zip(state_leaves(_merged(sess._states)),
                        state_leaves(ref._states)):
            np.testing.assert_allclose(a, b, atol=TOL)
    if K:
        for a, b in zip(sess.flush(), ref.flush()):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


def test_torch_port_one_device_mesh_session_is_the_unsharded_one(a3gc):
    _, tcfg, _, p3 = a3gc
    stats = load_stats()

    def session(mesh):
        return StreamingCascade(p3, tcfg, ParametricModel(), window=W,
                                stats=stats, normalize=True, streams=S,
                                lookahead=1, history=1, mesh=mesh,
                                device="cpu")
    meshed, single = session(make_mesh(devices=["cpu"])), session(None)
    rng = np.random.default_rng(51)
    for item in _plan():
        if isinstance(item, str):
            meshed.reset(stream=1)
            single.reset(stream=1)
            continue
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(size=(S, W, 18)).astype(np.float32)
        (got, got_em), (want, want_em) = (
            s.step(ori, acc, active=item) for s in (meshed, single))
        np.testing.assert_array_equal(got_em, want_em)
        if got_em.any():
            np.testing.assert_array_equal(got[got_em], want[got_em])
    for a, b in zip(state_leaves(meshed._states[0]),
                    state_leaves(single._states)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory, a3gc):
    jcfg, tcfg, params, p3 = a3gc
    path = write_synthetic_smpl_pickle(
        str(tmp_path_factory.mktemp("smpl") / "smpl.pkl"), n_vertices=64)
    stats = load_stats()
    model = load_parametric_model(path, device="cpu")
    single = TR.CascadeEvaluator(p3, tcfg, model, stats, normalize=True,
                                 device="cpu")
    meshed = TR.CascadeEvaluator(p3, tcfg, model, stats, normalize=True,
                                 mesh=make_mesh(devices=["cpu"] * 2))
    ref = JR.CascadeEvaluator(to_jnp(params), jcfg, jax_load(path), stats,
                              normalize=True,
                              mesh=jax_make_mesh(devices=jax.devices()[:2]))
    return single, meshed, ref, eval_sequences([40, 70, 52], seed=8)


def test_torch_port_mesh_evaluator_batched(evaluators):
    single, meshed, ref, seqs = evaluators
    table = meshed.evaluate_batched(seqs, streams=S)[0]
    assert table.shape == (5, 2) and np.isfinite(table).all()
    np.testing.assert_allclose(table, single.evaluate_batched(seqs, S)[0],
                               atol=TABLE_TOL)
    np.testing.assert_allclose(table, ref.evaluate_batched(seqs, S)[0],
                               atol=TABLE_TOL)
    # three streams of a group pad to four rows over the two shards
    np.testing.assert_allclose(meshed.evaluate_batched(seqs, streams=3)[0],
                               table, atol=TABLE_TOL)


def test_torch_port_mesh_evaluator_streaming(evaluators):
    single, _, ref, seqs = evaluators
    two = make_mesh(devices=["cpu"] * 2)
    kw = dict(window=W, lookahead=1, history=1, batch_streams=2)
    table = single.evaluate_streaming(seqs, mesh=two, **kw)[0]
    np.testing.assert_allclose(table, single.evaluate_streaming(seqs, **kw)[0],
                               atol=TABLE_TOL)
    np.testing.assert_allclose(
        table, ref.evaluate_streaming(
            seqs, mesh=jax_make_mesh(devices=jax.devices()[:2]), **kw)[0],
        atol=TABLE_TOL)
    with pytest.raises(ValueError, match="must divide"):
        single.evaluate_streaming(seqs, window=W, batch_streams=3, mesh=two)


def test_torch_port_mesh_server_serves_and_refuses_recycle(a3gc):
    _, tcfg, _, p3 = a3gc
    stats = load_stats()
    srv = PoseServer(p3, tcfg, ParametricModel(), window=W, streams=S,
                     stats=stats, normalize=True, port=0, max_wait_ms=1.0,
                     mesh=make_mesh(devices=["cpu"] * 2), allow_recycle=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rng = np.random.default_rng(52)
    wins = [(rng.normal(size=(W, 54)).astype(np.float32),
             rng.normal(size=(W, 18)).astype(np.float32)) for _ in range(3)]
    try:
        with PoseClient(*srv.address[:2], timeout=30.0, retry_s=5.0) as c:
            served = [c.step(o, a) for o, a in wins]
            with pytest.raises(ServerError) as ei:
                c.recycle()
    finally:
        srv.shutdown()
    assert ei.value.status == 501 and RECYCLE_REFUSED in str(ei.value)
    ref = StreamingCascade(p3, tcfg, ParametricModel(), window=W,
                           stats=stats, normalize=True, device="cpu")
    for got, (o, a) in zip(served, wins):
        np.testing.assert_allclose(got, ref.step(o, a), atol=TOL)
