"""The port's buffered (lookahead K / history P) cascade and DIP sessions,
their pipelined entry points and ``streaming_predictions*`` against the JAX
package on the CPU (the single-net ``StreamingSession`` is in
test_torch_port_streaming_session.py): the same windows, the same ``active`` pattern, the same
resets through both; ``emitted``, the emitted poses, the ``flush`` tails and
every carried state after every tick are compared.

Tolerance 1e-5 absolute on net outputs and carried states (fp32 on both
sides, sums reordered by the frameworks' matmuls over ≤ 24-frame
recurrences); 1e-4 on poses after three stages and IK, as in the other
cascade tests. The static buffer methods are numpy only and must agree
exactly."""

import collections
import functools

import numpy as np
import pytest
import torch

from a3gc_tpu.eval import streaming as JS
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu_torch.compat.from_jax import (cascade_params_from_jax,
                                            dip_params_from_jax)
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.eval import streaming as TS
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import cascades, jax_dip, state_leaves, to_jnp

# tiny tensors: intra-op threads would only contend with the other test
# workers' (and the server's handler threads)
torch.set_num_threads(1)

TOL = 1e-5
POSE_TOL = 1e-4
W = 6
KP = [(1, 0), (0, 1), (1, 1), (2, 1)]


@functools.lru_cache(maxsize=None)
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


def _script(S, K, P):
    """The ticks of one run: ("step", active | None), ("reset", slot),
    ("flush", slot | None). Slot 1 idles on one tick and is reset midway (so
    it re-warms in a fill group of its own); one slot is flushed alone, the
    session keeps stepping, and everything is flushed at the end."""
    idle = np.ones(S, np.float32)
    idle[S - 1] = 0.0
    ticks = [("step", None)] * (K + 1)
    ticks += [("step", idle if S > 1 else None), ("step", None)]
    ticks += [("reset", S - 1), ("step", None), ("step", None)]
    ticks += [("flush", 0), ("step", None)]
    ticks += [("step", None)] * (P + K)
    ticks += [("flush", None), ("step", None)]
    return ticks


def _drive(sess, S, n_inputs, seed, states_of, step):
    """Run the script; returns the trace [(kind, emitted, values, states)]
    with values the emitted rows (or flushed tails) as numpy arrays."""
    rng = np.random.default_rng(seed)
    trace = []
    for kind, arg in _script(S, sess.lookahead, sess.history):
        if kind == "reset":
            sess.reset(stream=arg)
            emitted, values = None, []
        elif kind == "flush":
            out = sess.flush(stream=arg)
            tails = out if isinstance(out, list) else [out]
            emitted = [t is not None for t in tails]
            values = [np.asarray(t) for t in tails if t is not None]
        else:
            xs = [rng.normal(size=(S, W) + sh).astype(np.float32)
                  for sh in n_inputs]
            out = step(sess, xs, arg)
            if S == 1:
                emitted = [out is not None]
                values = [] if out is None else [np.asarray(out)]
            else:
                if sess.lookahead or sess.history:
                    pose, em = out
                else:               # plain windows: the active rows
                    pose = out
                    em = np.ones(S) if arg is None else arg
                emitted = list(np.asarray(em, bool))
                values = [np.asarray(pose[i]) for i in range(S) if em[i]]
        trace.append((kind, emitted, values, state_leaves(states_of(sess))))
    return trace


def _assert_traces_close(got, want, tol):
    assert len(got) == len(want)
    n_emitted = 0
    for t, ((kind, em, vals, states), (_, rem, rvals, rstates)) in enumerate(
            zip(got, want)):
        assert em == rem, f"tick {t} ({kind}) emitted"
        assert len(vals) == len(rvals)
        for a, b in zip(vals, rvals):
            assert a.shape == b.shape, f"tick {t} ({kind})"
            np.testing.assert_allclose(a, b, atol=tol,
                                       err_msg=f"tick {t} ({kind})")
            n_emitted += 1
        assert len(states) == len(rstates) > 0
        for a, b in zip(states, rstates):
            np.testing.assert_allclose(a, b, atol=TOL,
                                       err_msg=f"tick {t} ({kind}) state")
    assert n_emitted > 0


def _cascade_step(sess, xs, active):
    return sess.step(xs[0], xs[1], active=active)


@functools.lru_cache(maxsize=None)
def _jax_cascade_trace(kind, K, P, S):
    jcfg, _, params = cascades(kind)
    ref = JS.StreamingCascade(to_jnp(params), jcfg, jax_model(), window=W,
                              stats=load_stats(), normalize=True, streams=S,
                              lookahead=K, history=P, fused=False)
    return _drive(ref, S, ((54,), (18,)), 40, lambda s: s._states,
                  _cascade_step)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("K,P", KP)
@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp"])
def test_torch_port_buffered_cascade_matches_jax(kind, K, P, S, fused):
    _, tcfg, params = cascades(kind)
    sess = TS.StreamingCascade(
        cascade_params_from_jax(params, device="cpu"), tcfg,
        ParametricModel(), window=W, stats=load_stats(), normalize=True,
        streams=S, lookahead=K, history=P, fused=fused, device="cpu")
    assert sess.fused is fused
    got = _drive(sess, S, ((54,), (18,)), 40, lambda s: s._states,
                 _cascade_step)
    _assert_traces_close(got, _jax_cascade_trace(kind, K, P, S), POSE_TOL)
    assert all(len(b) == 1 for b in sess._buffers)     # one step since flush


@functools.lru_cache(maxsize=None)
def _jax_dip_session_trace(K, P, S):
    jcfg, params = jax_dip(60, 135, 8, seed=13)
    ref = JS.DipStreamingSession(
        to_jnp(params), JPL.PoseNetConfig(net=jcfg, rotsize=9), jax_model(),
        window=W, stats=load_stats(), streams=S, lookahead=K, history=P,
        fused=False)
    return _drive(ref, S, ((54,), (18,)), 41, lambda s: s._states,
                  _cascade_step)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("K,P", KP)
def test_torch_port_buffered_dip_session_matches_jax(K, P, S, fused):
    _, params = jax_dip(60, 135, 8, seed=13)
    tcfg = TPL.PoseNetConfig(net=TN.DIPConfig(n_hidden=8), rotsize=9)
    sess = TS.DipStreamingSession(
        dip_params_from_jax(params, device="cpu"), tcfg, ParametricModel(),
        window=W, stats=load_stats(), streams=S, lookahead=K, history=P,
        fused=fused, device="cpu")
    got = _drive(sess, S, ((54,), (18,)), 41, lambda s: s._states,
                 _cascade_step)
    _assert_traces_close(got, _jax_dip_session_trace(K, P, S), POSE_TOL)


# -- run_windows / step_async -------------------------------------------------

def _plain_pair(kind):
    jcfg, tcfg, params = cascades(kind)
    ref = JS.StreamingCascade(to_jnp(params), jcfg, jax_model(), window=W,
                              stats=load_stats(), normalize=True)
    sess = TS.StreamingCascade(
        cascade_params_from_jax(params, device="cpu"), tcfg,
        ParametricModel(), window=W, stats=load_stats(), normalize=True,
        device="cpu")
    return ref, sess


@pytest.mark.parametrize("kind", ["a3gc", "tp"])
def test_torch_port_run_windows_matches_jax_and_step_loop(kind):
    ref, sess = _plain_pair(kind)
    rng = np.random.default_rng(43)
    ori = rng.normal(size=(4, W, 54)).astype(np.float32)
    acc = rng.normal(size=(4, W, 18)).astype(np.float32)
    want = ref.run_windows(ori, acc)
    got = sess.run_windows(ori, acc)
    assert got.shape == (4, W, 24, 3, 3)
    np.testing.assert_allclose(got, want, atol=POSE_TOL)
    for a, b in zip(state_leaves(sess._states), state_leaves(ref._states)):
        np.testing.assert_allclose(a, b, atol=TOL)
    states = state_leaves(sess._states)
    sess.reset()
    loop = np.stack([sess.step(o, a) for o, a in zip(ori, acc)])
    np.testing.assert_array_equal(got, loop)
    for a, b in zip(state_leaves(sess._states), states):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["a3gc", "tp"])
def test_torch_port_step_async_matches_jax(kind):
    ref, sess = _plain_pair(kind)
    rng = np.random.default_rng(44)
    got, want = [], []
    for _ in range(3):
        ori = rng.normal(size=(W, 54)).astype(np.float32)
        acc = rng.normal(size=(W, 18)).astype(np.float32)
        want.append(ref.step_async(ori, acc))
        got.append(sess.step_async(ori, acc))
    want.append(ref.flush())
    got.append(sess.flush())
    assert got[0] is None and want[0] is None
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, np.asarray(b), atol=POSE_TOL)
    assert sess.flush() is None
    for a, b in zip(state_leaves(sess._states), state_leaves(ref._states)):
        np.testing.assert_allclose(a, b, atol=TOL)


def test_torch_port_pipelined_entry_points_refuse_buffered_sessions():
    _, tcfg, params = cascades("a3gc")
    p3 = cascade_params_from_jax(params, device="cpu")
    sess = TS.StreamingCascade(p3, tcfg, ParametricModel(), window=W,
                               lookahead=1, device="cpu")
    zeros = np.zeros((W, 54), np.float32), np.zeros((W, 18), np.float32)
    with pytest.raises(ValueError, match="step_async"):
        sess.step_async(*zeros)
    with pytest.raises(ValueError, match="run_windows"):
        sess.run_windows(zeros[0][None], zeros[1][None])
    with pytest.raises(NotImplementedError, match="item 14"):
        TS.StreamingCascade(p3, tcfg, ParametricModel(), mesh=object(),
                            device="cpu")
    assert "shard_window_step" not in TS.__all__
    assert sorted(TS.__all__ + ["shard_window_step"]) == sorted(JS.__all__)


# -- the numpy sequence helpers -----------------------------------------------

@pytest.mark.parametrize("K,P,S", [(0, 0, 1), (1, 1, 1), (0, 0, 3),
                                   (1, 1, 3), (2, 0, 2)])
def test_torch_port_streaming_predictions_ragged_match_jax(K, P, S):
    jcfg, tcfg, params = cascades("a3gc")
    kw = dict(window=W, stats=load_stats(), normalize=True, streams=S,
              lookahead=K, history=P)
    ref = JS.StreamingCascade(to_jnp(params), jcfg, jax_model(), **kw)
    sess = TS.StreamingCascade(
        cascade_params_from_jax(params, device="cpu"), tcfg,
        ParametricModel(), device="cpu", **kw)
    rng = np.random.default_rng(45)
    lengths = (2 * W + 1, 3 * W, W - 2, 4 * W + 3, W)  # ragged, not ·W
    seqs = [(rng.normal(size=(T, 54)).astype(np.float32),
             rng.normal(size=(T, 18)).astype(np.float32)) for T in lengths]
    want = JS.streaming_predictions_multi(ref, seqs)
    got = TS.streaming_predictions_multi(sess, seqs)
    assert [g.shape for g in got] == [(T, 24, 3, 3) for T in lengths]
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, atol=POSE_TOL)
    if S == 1:
        one = TS.streaming_predictions(sess, *seqs[0])
        np.testing.assert_array_equal(one, got[0])
    else:
        with pytest.raises(ValueError, match="one slot"):
            TS.streaming_predictions(sess, *seqs[0])
    assert all(not b for b in sess._buffers)
    assert not any(a.any() for a in state_leaves(sess._states))


# -- the static buffer methods: numpy on both sides, exact --------------------

def _random_buffers(rng, S, K, P, components):
    cap = P + K + 1
    return [collections.deque(
        tuple(rng.normal(size=(W,) + sh).astype(np.float32)
              for sh in components)
        for _ in range(int(rng.integers(0, cap + 1)))) for _ in range(S)]


def _copy_buffers(buffers):
    return [collections.deque(tuple(c.copy() for c in w) for w in b)
            for b in buffers]


def _assert_buffers_equal(a, b):
    assert [len(x) for x in a] == [len(x) for x in b]
    for x, y in zip(a, b):
        for wx, wy in zip(x, y):
            for cx, cy in zip(wx, wy):
                np.testing.assert_array_equal(cx, cy)


@pytest.mark.parametrize("components", [((54,), (18,)), ((15, 12),)])
@pytest.mark.parametrize("K,P", KP + [(0, 2)])
def test_torch_port_static_buffer_methods_equal_jax(K, P, components):
    rng = np.random.default_rng(100 * K + P)
    for trial in range(8):
        S = int(rng.integers(1, 5))
        bufs = _random_buffers(rng, S, K, P, components)
        act = rng.integers(0, 2, size=S).astype(bool)
        ours = TS.StreamingCascade.assemble_buffered(
            _copy_buffers(bufs), act, W, K, P)
        ref = JS.StreamingCascade.assemble_buffered(
            _copy_buffers(bufs), act, W, K, P)
        np.testing.assert_array_equal(ours[0], ref[0])       # emitted
        assert sorted(ours[1]) == sorted(ref[1])             # fill groups
        for f in ref[1]:
            np.testing.assert_array_equal(ours[1][f][0], ref[1][f][0])
            for a, b in zip(ours[1][f][1], ref[1][f][1]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours[2], ref[2])       # adv
        assert (ours[3] is None) == (ref[3] is None)
        if ref[3] is not None:
            for a, b in zip(ours[3], ref[3]):
                np.testing.assert_array_equal(a, b)

        # emit_buffered, with numpy passes: same calls, same pose, same pops
        def passes(log):
            def emission(f, em, ctx):
                log.append(("emit", f, em.copy()))
                return ctx[0] * 2.0

            def advance(advf, adv_ctx):
                log.append(("adv", advf.copy(), adv_ctx[0].copy()))
            return emission, advance

        b1, b2, log1, log2 = _copy_buffers(bufs), _copy_buffers(bufs), [], []
        appended = [i for i in range(S) if act[i] and bufs[i]]
        pose1, em1 = TS.StreamingCascade.emit_buffered(
            b1, act, W, K, P, appended, *passes(log1))
        pose2, em2 = JS.StreamingCascade.emit_buffered(
            b2, act, W, K, P, appended, *passes(log2))
        np.testing.assert_array_equal(em1, em2)
        assert (pose1 is None) == (pose2 is None)
        if pose2 is not None:
            np.testing.assert_array_equal(pose1, pose2)
        assert len(log1) == len(log2)
        for x, y in zip(log1, log2):
            assert x[0] == y[0]
            for p, q in zip(x[1:], y[1:]):
                np.testing.assert_array_equal(p, q)
        _assert_buffers_equal(b1, b2)
        TS.StreamingCascade.commit_buffered(b1, ref[2] & False)
        _assert_buffers_equal(b1, b2)


@pytest.mark.parametrize("fail_in", ["emission", "advance", "fused"])
@pytest.mark.parametrize("S", [1, 3])
def test_torch_port_buffered_tick_is_transactional(S, fail_in):
    """A pass that raises leaves buffers and states as before the tick, and
    the same window can be stepped again."""
    _, tcfg, params = cascades("a3gc")
    K, P = 1, 1
    sess = TS.StreamingCascade(
        cascade_params_from_jax(params, device="cpu"), tcfg,
        ParametricModel(), window=W, streams=S, lookahead=K, history=P,
        fused=fail_in == "fused", device="cpu")
    twin = TS.StreamingCascade(sess.params3, tcfg, ParametricModel(),
                               window=W, streams=S, lookahead=K, history=P,
                               device="cpu")
    rng = np.random.default_rng(47)

    def window():
        return (rng.normal(size=(S, W, 54)).astype(np.float32),
                rng.normal(size=(S, W, 18)).astype(np.float32))

    for _ in range(P + K + 1):             # at capacity: emission + advance
        w = window()
        sess.step(*w)
        twin.step(*w)
    before_buffers = _copy_buffers(sess._buffers)
    before_states = state_leaves(sess._states)
    real, calls = sess._step_fn, []

    def failing(params3, ori, *rest):
        calls.append(ori.shape[1])
        # the advance pass is the call over W frames; with fused=True it
        # follows the emission pass inside one fused_pass
        if fail_in == "emission" or ori.shape[1] == W:
            raise RuntimeError("device step failed")
        return real(params3, ori, *rest)

    sess._step_fn = failing
    w = window()
    with pytest.raises(RuntimeError, match="device step failed"):
        sess.step(*w)
    assert calls == ([3 * W] if fail_in == "emission" else [3 * W, W])
    sess._step_fn = real
    _assert_buffers_equal(sess._buffers, before_buffers)
    for a, b in zip(state_leaves(sess._states), before_states):
        np.testing.assert_array_equal(a, b)
    got, want = sess.step(*w), twin.step(*w)       # the retry lands
    if S == 1:
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        assert got[1].all() and want[1].all()
    for a, b in zip(state_leaves(sess._states), state_leaves(twin._states)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_torch_port_buffered_flush_is_transactional():
    _, tcfg, params = cascades("ggru")
    sess = TS.StreamingCascade(
        cascade_params_from_jax(params, device="cpu"), tcfg,
        ParametricModel(), window=W, streams=2, lookahead=1, device="cpu")
    rng = np.random.default_rng(48)
    for _ in range(2):
        sess.step(rng.normal(size=(2, W, 54)).astype(np.float32),
                  rng.normal(size=(2, W, 18)).astype(np.float32))
    before_buffers = _copy_buffers(sess._buffers)
    before_states = state_leaves(sess._states)
    real = sess._step_fn

    def failing(*args):
        raise RuntimeError("device step failed")

    sess._step_fn = failing
    with pytest.raises(RuntimeError, match="device step failed"):
        sess.flush()
    sess._step_fn = real
    _assert_buffers_equal(sess._buffers, before_buffers)
    for a, b in zip(state_leaves(sess._states), before_states):
        np.testing.assert_array_equal(a, b)
    tails = sess.flush()
    assert [t.shape for t in tails] == [(W, 24, 3, 3)] * 2
    assert all(not b for b in sess._buffers)


def test_torch_port_sessions_run_without_grad_on_any_thread():
    """Grad mode is thread-local: a session stepped from a fresh thread
    (where gradients are enabled by default) must still run under
    no_grad, as the CUDA wrappers refuse to launch otherwise."""
    import threading

    _, tcfg, params = cascades("a3gc")
    sess = TS.StreamingCascade(
        cascade_params_from_jax(params, device="cpu"), tcfg,
        ParametricModel(), window=W, streams=2, lookahead=1, history=1,
        device="cpu")
    seen = []
    real = sess._step_fn

    def spy(*args):
        seen.append(torch.is_grad_enabled())
        return real(*args)

    sess._step_fn = spy
    zeros = (np.zeros((2, W, 54), np.float32),
             np.zeros((2, W, 18), np.float32))

    def work():
        assert torch.is_grad_enabled()
        for _ in range(4):
            sess.step(*zeros)
        sess.flush()

    t = threading.Thread(target=work)
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert len(seen) >= 6 and not any(seen)
