"""The port's single-net ``StreamingSession`` (graph nets and the
bi- and unidirectional DIP nets) and ``streaming_outputs*`` against the JAX
package on
the CPU: the script of windows, idle slots, resets and flushes of
test_torch_port_streaming_buffered.py through both; ``emitted``, the
emitted outputs, the flush tails and the carried state after every tick at
1e-5 absolute (fp32 on both sides, one net over ≤ 24-frame recurrences)."""

import functools

import numpy as np
import pytest
import torch

from a3gc_tpu.eval import streaming as JS
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu_torch.compat.from_jax import (dip_params_from_jax,
                                            graph_net_params_from_jax)
from a3gc_tpu_torch.eval import streaming as TS
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL

from test_torch_port_streaming_buffered import (TOL, W, _assert_traces_close,
                                                _drive)
from torch_port_oracle import jax_dip, jax_graph_net, state_leaves, to_jnp

torch.set_num_threads(1)        # as in test_torch_port_streaming_buffered.py


def _single_net(net):
    """(JAX PoseNetConfig, JAX params as numpy, port PoseNetConfig, port
    params, the feature shape of one frame)."""
    if net in ("dip", "dip_uni"):
        bi = net == "dip"
        jnet, params = jax_dip(60, 135, 8, seed=15, bidirectional=bi)
        tnet = TN.DIPConfig(n_hidden=8, bidirectional=bi)
        return (JPL.PoseNetConfig(net=jnet, rotsize=9), params,
                TPL.PoseNetConfig(net=tnet, rotsize=9),
                dip_params_from_jax(params, device="cpu"), (60,))
    jnet, params = jax_graph_net(net, 12, 9, 8, seed=16)
    tnet = TN.GraphNetConfig(cell=net, units_in=12, units_out=9,
                             units_hidden=8)
    return (JPL.PoseNetConfig(net=jnet, rotsize=9), params,
            TPL.PoseNetConfig(net=tnet, rotsize=9),
            graph_net_params_from_jax(params, device="cpu"), (15, 12))


def _net_step(sess, xs, active):
    return sess.step(xs[0][0] if sess.streams == 1 else xs[0], active=active)


@functools.lru_cache(maxsize=None)
def _jax_net_trace(net, K, P, S):
    jcfg, params, _, _, feat = _single_net(net)
    ref = JS.StreamingSession(to_jnp(params), jcfg, window=W, streams=S,
                              lookahead=K, history=P, fused=False)
    return _drive(ref, S, (feat,), 42, lambda s: s._state, _net_step)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("K,P", [(0, 0), (1, 0), (0, 1), (2, 1)])
@pytest.mark.parametrize("net", ["a3gc", "ggru", "dip"])
def test_torch_port_streaming_session_matches_jax(net, K, P, S, fused):
    _, _, tcfg, tparams, feat = _single_net(net)
    sess = TS.StreamingSession(tparams, tcfg, window=W, streams=S,
                               lookahead=K, history=P, fused=fused,
                               device="cpu")
    got = _drive(sess, S, (feat,), 42, lambda s: s._state, _net_step)
    _assert_traces_close(got, _jax_net_trace(net, K, P, S), TOL)


def test_torch_port_streaming_session_batch_alias_and_checks():
    _, _, tcfg, tparams, _ = _single_net("a3gc")
    sess = TS.StreamingSession(tparams, tcfg, window=W, batch=2, device="cpu")
    assert sess.streams == 2 and sess._slot_axis == 1
    assert sess.flush() == [None, None] and sess.flush(stream=1) is None
    with pytest.raises(ValueError, match="window size"):
        sess.step(np.zeros((2, W + 1, 15, 12), np.float32))
    with pytest.raises(ValueError, match="stream rows"):
        sess.step(np.zeros((3, W, 15, 12), np.float32))
    out = sess.step(np.zeros((2, W, 15, 12), np.float32))
    assert out.shape == (2, W, 15, 9)
    before = state_leaves(sess._state)
    sess.reset(stream=0)
    after = state_leaves(sess._state)
    for b, a in zip(before, after):
        assert not a[:, 0].any() and np.array_equal(a[:, 1], b[:, 1])
    # the unidirectional DIP net's states are [S, H]: slot axis 0
    _, _, ucfg, uparams, _ = _single_net("dip_uni")
    uni = TS.StreamingSession(uparams, ucfg, window=W, streams=2,
                              device="cpu")
    assert uni._slot_axis == 0
    uni.step(np.ones((2, W, 60), np.float32))
    before = state_leaves(uni._state)
    uni.reset(stream=0)
    for b, a in zip(before, state_leaves(uni._state)):
        assert a.shape == (2, 8) and b[0].any()
        assert not a[0].any() and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("K,P", [(0, 0), (1, 1)])
def test_torch_port_uni_dip_streaming_session_matches_jax(K, P):
    _, _, tcfg, tparams, feat = _single_net("dip_uni")
    sess = TS.StreamingSession(tparams, tcfg, window=W, streams=3,
                               lookahead=K, history=P, device="cpu")
    got = _drive(sess, 3, (feat,), 42, lambda s: s._state, _net_step)
    _assert_traces_close(got, _jax_net_trace("dip_uni", K, P, 3), TOL)


@pytest.mark.parametrize("net", ["a3gc", "dip"])
@pytest.mark.parametrize("K,P,S", [(0, 0, 1), (1, 1, 1), (1, 0, 3),
                                   (0, 1, 2)])
def test_torch_port_streaming_outputs_ragged_match_jax(net, K, P, S):
    jcfg, params, tcfg, tparams, feat = _single_net(net)
    kw = dict(window=W, streams=S, lookahead=K, history=P)
    ref = JS.StreamingSession(to_jnp(params), jcfg, **kw)
    sess = TS.StreamingSession(tparams, tcfg, device="cpu", **kw)
    rng = np.random.default_rng(46)
    lengths = (W + 1, 3 * W - 1, 2 * W, 5)
    seqs = [rng.normal(size=(T,) + feat).astype(np.float32) for T in lengths]
    want = JS.streaming_outputs_multi(ref, seqs)
    got = TS.streaming_outputs_multi(sess, seqs)
    assert [g.shape[0] for g in got] == list(lengths)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w_), atol=TOL)
    if S == 1:
        np.testing.assert_array_equal(TS.streaming_outputs(sess, seqs[1]),
                                      got[1])
    assert TS.streaming_outputs_multi(sess, []) == []
