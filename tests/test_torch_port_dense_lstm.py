"""The port's dense-LSTM family against the JAX package on the CPU: the
layer (a3gc_tpu_torch.ops.lstm), both directions and one, against the
Pallas ``bi_lstm_pallas`` / ``lstm_scan_pallas`` in interpret mode
(``_lstm_kernel``) and against ``torch.nn.LSTM``, the DIP net (bi- and
unidirectional) against the XLA stack with a per-row frame mask, the
TransPose cascade offline and online, and ``DipStreamingSession`` (the
unidirectional net too); and ``StreamingCascade.reset(stream=i)`` on every
state structure.

Against the Pallas kernel every frame is compared (both emit the carried h
past n_valid); against the XLA scan, valid frames and every carried state.
Tolerance 1e-5 absolute per module: fp32 on both sides, sums reordered by
the frameworks' matmul kernels over short recurrences; 1e-4 on poses
after three stages and IK."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.data import load_adjacency_template
from a3gc_tpu.eval.streaming import DipStreamingSession as JaxDipSession
from a3gc_tpu.eval.streaming import StreamingCascade as JaxStreamingCascade
from a3gc_tpu.models import nets as JN
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu.ops.pallas_gcn_lstm import bi_lstm_pallas, lstm_scan_pallas
from a3gc_tpu_torch.compat.from_jax import (cascade_params_from_jax,
                                            dip_params_from_jax,
                                            lstm_layer_params_from_jax)
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.data import load_adjacency_template as t_adjacency
from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                           StreamingCascade)
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL
from a3gc_tpu_torch.ops import lstm as LS
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import perturbed, to_jnp

TOL = 1e-5
POSE_TOL = 1e-4
H = 16


def jax_dip(n_input, n_output, hidden, seed, bidirectional=True):
    """(JAX DIPConfig on the XLA scan, perturbed numpy params)."""
    cfg = JN.DIPConfig(n_input=n_input, n_output=n_output, n_hidden=hidden,
                       bidirectional=bidirectional)
    params = JN.init_dip(jax.random.PRNGKey(seed), cfg)
    return cfg, perturbed(params, seed)


def _layer_inputs(S, T, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, T, F)).astype(np.float32)
    h = (0.5 * rng.normal(size=(2, S, H))).astype(np.float32)
    c = (0.5 * rng.normal(size=(2, S, H))).astype(np.float32)
    return x, h, c


def _port_layer(layer_np, x, h, c, n_valid):
    p = lstm_layer_params_from_jax(layer_np, device="cpu")
    with torch.no_grad():
        y, (hn, cn) = LS.bi_lstm_reference(
            p, torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)),
            n_valid)
    return y.numpy(), hn.numpy(), cn.numpy()


@pytest.mark.parametrize("n_valid", [None, 5])
def test_torch_port_lstm_layer_matches_pallas(n_valid):
    T = 9
    _, params = jax_dip(12, 6, H, seed=1)
    layer = params.lstm[1]                                  # F = 2H
    x, h, c = _layer_inputs(1, T, 2 * H, seed=2)
    ref_y, (ref_h, ref_c) = bi_lstm_pallas(
        to_jnp(layer), x, (h, c),
        n_valid=None if n_valid is None else np.int32(n_valid),
        interpret=True)
    y, hn, cn = _port_layer(layer, x, h, c, n_valid)
    assert y.shape == (1, T, 2 * H)
    np.testing.assert_allclose(y, np.asarray(ref_y), atol=TOL)
    np.testing.assert_allclose(hn, np.asarray(ref_h), atol=TOL)
    np.testing.assert_allclose(cn, np.asarray(ref_c), atol=TOL)


@pytest.mark.parametrize("n_valid", [None, 5])
def test_torch_port_uni_lstm_layer_matches_pallas(n_valid):
    """One direction: the Pallas kernel's own unit (``lstm_scan_pallas``,
    forward), against the port's unstacked layer."""
    T, S = 9, 2
    _, params = jax_dip(12, 6, H, seed=21, bidirectional=False)
    layer = params.lstm[1]                                  # F = H
    x, h2, c2 = _layer_inputs(S, T, H, seed=22)
    h, c = h2[0], c2[0]
    u = (np.einsum("btf,fg->tbg", x, layer.w_ih) + layer.b_ih
         + layer.b_hh).astype(np.float32)
    ref_y, (ref_h, ref_c) = lstm_scan_pallas(
        jnp.asarray(layer.w_hh), jnp.asarray(u), jnp.asarray(h),
        jnp.asarray(c), n_valid=None if n_valid is None else np.int32(n_valid),
        interpret=True)
    y, hn, cn = _port_layer(layer, x, h, c, n_valid)
    assert y.shape == (S, T, H) and hn.shape == (S, H)
    np.testing.assert_allclose(y, np.swapaxes(np.asarray(ref_y), 0, 1),
                               atol=TOL)
    np.testing.assert_allclose(hn, np.asarray(ref_h), atol=TOL)
    np.testing.assert_allclose(cn, np.asarray(ref_c), atol=TOL)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_torch_port_lstm_layer_matches_torch_lstm(bidirectional):
    """An oracle independent of JAX: cuDNN's function, on the CPU."""
    S, T, F = 3, 11, 12
    _, params = jax_dip(F, 6, H, seed=3, bidirectional=bidirectional)
    layer = params.lstm[0]
    x = np.random.default_rng(4).normal(size=(S, T, H)).astype(np.float32)
    _, h, c = _layer_inputs(S, T, H, seed=5)
    if not bidirectional:
        h, c = h[0], c[0]
    p = lstm_layer_params_from_jax(layer, device="cpu")
    ref = torch.nn.LSTM(H, H, bidirectional=bidirectional, batch_first=True)
    with torch.no_grad():
        for d, suffix in enumerate(("", "_reverse")[:1 + bidirectional]):
            pd = ({k: v[d] for k, v in p.named_parameters()}
                  if bidirectional else dict(p.named_parameters()))
            getattr(ref, "weight_ih_l0" + suffix).copy_(pd["w_ih"].T)
            getattr(ref, "weight_hh_l0" + suffix).copy_(pd["w_hh"].T)
            getattr(ref, "bias_ih_l0" + suffix).copy_(pd["b_ih"])
            getattr(ref, "bias_hh_l0" + suffix).copy_(pd["b_hh"])
        xt, ht, ct = (torch.from_numpy(a) for a in (x, h, c))
        if not bidirectional:           # torch.nn.LSTM's state is [D, B, H]
            ht, ct = ht[None], ct[None]
        want, (want_h, want_c) = ref(xt, (ht, ct))
        if not bidirectional:
            ht, ct, want_h, want_c = ht[0], ct[0], want_h[0], want_c[0]
        y, (hn, cn) = LS.bi_lstm_reference(p, xt, (ht, ct))
    torch.testing.assert_close(y, want, rtol=0, atol=TOL)
    torch.testing.assert_close(hn, want_h, rtol=0, atol=TOL)
    torch.testing.assert_close(cn, want_c, rtol=0, atol=TOL)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_torch_port_dip_apply_matches_xla_with_row_mask(bidirectional):
    S, T = 3, 10
    jcfg, params = jax_dip(60, 135, H, seed=6, bidirectional=bidirectional)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(S, T, 60)).astype(np.float32)
    shape = (2,) * bidirectional + (S, H)
    state = tuple((0.5 * rng.normal(size=shape).astype(np.float32),
                   0.5 * rng.normal(size=shape).astype(np.float32))
                  for _ in range(2))
    lengths = np.array([T, 5, 0])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    ref_y, ref_state = JN.dip_apply(to_jnp(params), jcfg, jnp.asarray(x),
                                    to_jnp(state),
                                    frame_mask=jnp.asarray(mask))
    cfg = TN.DIPConfig(n_input=60, n_output=135, n_hidden=H,
                       bidirectional=bidirectional)
    p = dip_params_from_jax(params, device="cpu")
    with torch.no_grad():
        y, new_state = TN.dip_apply(
            p, cfg, x, tuple(tuple(torch.from_numpy(a) for a in s)
                             for s in state),
            frame_mask=mask, device="cpu")
    assert y.shape == (S, T, 135)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(y[b, :n].numpy(), np.asarray(ref_y)[b, :n],
                                   atol=TOL)
    _assert_states_close(new_state, ref_state)


def test_torch_port_lstm_wrapper_on_cpu_takes_plain_path():
    _, params = jax_dip(12, 6, H, seed=8)
    p = lstm_layer_params_from_jax(params.lstm[0], device="cpu")
    x, h, c = (torch.from_numpy(a) for a in _layer_inputs(2, 5, H, seed=9))
    LS.bi_lstm.launches = 0
    with torch.no_grad():
        y, (hn, cn) = LS.bi_lstm(p, x, (h, c), torch.tensor([5, 2]))
        ref_y, (ref_h, ref_c) = LS.bi_lstm_reference(p, x, (h, c),
                                                     torch.tensor([5, 2]))
    assert LS.bi_lstm.launches == 0
    for a, b in ((y, ref_y), (hn, ref_h), (cn, ref_c)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_torch_port_init_dip_shapes_match_jax():
    jcfg, jparams = jax_dip(60, 135, H, seed=10)
    cfg = TN.DIPConfig(n_input=60, n_output=135, n_hidden=H)
    p = TN.init_dip(torch.Generator().manual_seed(0), cfg)
    for name, t in p.named_parameters():
        ref = jparams
        for part in name.split("."):
            ref = ref[int(part)] if part.isdigit() else getattr(ref, part)
        assert tuple(t.shape) == np.shape(ref), name
    assert p.lstm[0].w_hh.detach().abs().max() <= 1.0 / H ** 0.5
    zero = TN.dip_zero_state(cfg, 3, device="cpu")
    assert len(zero) == 2 and all(t.shape == (2, 3, H) for s in zero
                                  for t in s)
    # the unidirectional net: unstacked layers, linear2 over H, [B, H]
    # states
    _, juni = jax_dip(60, 135, H, seed=10, bidirectional=False)
    uni = TN.DIPConfig(n_input=60, n_output=135, n_hidden=H,
                       bidirectional=False)
    p = TN.init_dip(torch.Generator().manual_seed(0), uni)
    for name, t in p.named_parameters():
        ref = juni
        for part in name.split("."):
            ref = ref[int(part)] if part.isdigit() else getattr(ref, part)
        assert tuple(t.shape) == np.shape(ref), name
    jzero = JN.dip_zero_state(JN.DIPConfig(n_hidden=H, bidirectional=False),
                              3)
    zero = TN.dip_zero_state(uni, 3, device="cpu")
    assert [t.shape for s in zero for t in s] == [
        a.shape for s in jzero for a in s]


def _assert_states_close(ours, ref):
    ours = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), ours))
    ref = jax.tree_util.tree_leaves(ref)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


def _tp_cascades(hidden=H):
    dims = ((72, 15, 3), (87, 69, 3), (141, 135, 9))
    jcfg = JPL.CascadeConfig(*(JPL.PoseNetConfig(net=JN.DIPConfig(
        n_input=ni, n_output=no, n_hidden=hidden), rotsize=rot)
        for ni, no, rot in dims))
    tcfg = TPL.CascadeConfig(*(TPL.PoseNetConfig(net=TN.DIPConfig(
        n_input=ni, n_output=no, n_hidden=hidden), rotsize=rot)
        for ni, no, rot in dims))
    params = tuple(perturbed(JPL.init_pose_net(jax.random.PRNGKey(i), c),
                             seed=50 + i)
                   for i, c in enumerate((jcfg.stage1, jcfg.stage2,
                                          jcfg.stage3)))
    return jcfg, tcfg, params


@pytest.fixture(scope="module")
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


def test_torch_port_tp_cascade_apply_matches_jax(jax_model):
    jcfg, tcfg, params = _tp_cascades()
    assert not tcfg.is_graph
    B, T = 2, 8
    rng = np.random.default_rng(11)
    imu = rng.normal(size=(B, T, 72)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0.0
    ref = np.asarray(JPL.cascade_apply(to_jnp(params), jcfg, jax_model,
                                       jnp.asarray(imu),
                                       frame_mask=jnp.asarray(mask)))
    out = TPL.cascade_apply(cascade_params_from_jax(params, device="cpu"),
                            tcfg, ParametricModel(), imu, frame_mask=mask,
                            device="cpu").numpy()
    assert out.shape == (B * T, 24, 3, 3)
    valid = mask.reshape(-1) > 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=POSE_TOL)


def _serve_and_compare(ref, sess, S, W, seed):
    """Three windows, reset(stream=1) after the first, slot 1 idle in the
    second; active-slot poses and every carried state after each call."""
    rng = np.random.default_rng(seed)
    idle = np.ones(S, np.float32)
    idle[1] = 0.0
    for item in (None, "reset1", idle, None):
        if isinstance(item, str):
            ref.reset(stream=1)
            sess.reset(stream=1)
        else:
            ori = rng.normal(size=(S, W, 54)).astype(np.float32)
            acc = rng.normal(size=(S, W, 18)).astype(np.float32)
            want = ref.step(ori, acc, active=item)
            got = sess.step(ori, acc, active=item)
            assert got.shape == (S, W, 24, 3, 3)
            active = np.ones(S, bool) if item is None else item > 0
            np.testing.assert_allclose(got[active], want[active],
                                       atol=POSE_TOL)
        _assert_states_close(sess._states, ref._states)


def test_torch_port_tp_streaming_cascade_matches_jax(jax_model):
    jcfg, tcfg, params = _tp_cascades()
    S, W = 3, 6
    stats = load_stats()
    ref = JaxStreamingCascade(to_jnp(params), jcfg, jax_model, window=W,
                              stats=stats, normalize=True, streams=S)
    sess = StreamingCascade(cascade_params_from_jax(params, device="cpu"),
                            tcfg, ParametricModel(), window=W, stats=stats,
                            normalize=True, streams=S, device="cpu")
    _serve_and_compare(ref, sess, S, W, seed=12)


def test_torch_port_dip_streaming_session_matches_jax(jax_model):
    jcfg, params = jax_dip(60, 135, H, seed=13)
    S, W = 3, 6
    stats = load_stats()
    ref = JaxDipSession(to_jnp(params), JPL.PoseNetConfig(net=jcfg,
                                                          rotsize=9),
                        jax_model, window=W, stats=stats, streams=S)
    tcfg = TPL.PoseNetConfig(net=TN.DIPConfig(n_hidden=H), rotsize=9)
    sess = DipStreamingSession(dip_params_from_jax(params, device="cpu"),
                               tcfg, ParametricModel(), window=W,
                               stats=stats, streams=S, device="cpu")
    _serve_and_compare(ref, sess, S, W, seed=14)
    buffered = DipStreamingSession(sess.params3, tcfg, ParametricModel(),
                                   stats=stats, lookahead=1, fused=False,
                                   device="cpu")
    assert (buffered.lookahead, buffered.history, buffered.fused) == (
        1, 0, False)
    with pytest.raises(ValueError, match="stats"):
        DipStreamingSession(sess.params3, tcfg, ParametricModel(),
                            device="cpu")


@pytest.mark.parametrize("K,P", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_torch_port_uni_dip_streaming_session_matches_jax(jax_model, K, P):
    """``DipStreamingSession`` over the unidirectional net (plain windows
    and lookahead / history) against JAX's on the same windows, an idle
    slot included;
    then ``reset(stream=2)`` zeroes row 2 of every [S, H] state leaf (the
    slot axis 0 of unidirectional states) and nothing else."""
    jcfg, params = jax_dip(60, 135, H, seed=16, bidirectional=False)
    S, W = 3, 6
    stats = load_stats()
    ref = JaxDipSession(to_jnp(params), JPL.PoseNetConfig(net=jcfg,
                                                          rotsize=9),
                        jax_model, window=W, stats=stats, streams=S,
                        lookahead=K, history=P)
    tcfg = TPL.PoseNetConfig(net=TN.DIPConfig(n_hidden=H,
                                              bidirectional=False),
                             rotsize=9)
    sess = DipStreamingSession(dip_params_from_jax(params, device="cpu"),
                               tcfg, ParametricModel(), window=W,
                               stats=stats, streams=S, lookahead=K,
                               history=P, device="cpu")
    rng = np.random.default_rng(17)
    idle = np.ones(S, np.float32)
    idle[1] = 0.0
    for active in (None, idle, None):
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(size=(S, W, 18)).astype(np.float32)
        want, got = ref.step(ori, acc, active=active), sess.step(
            ori, acc, active=active)
        if K or P:
            (want, want_em), (got, got_em) = want, got
            np.testing.assert_array_equal(got_em, np.asarray(want_em))
            rows = np.asarray(got_em, bool)
        else:
            rows = np.ones(S, bool) if active is None else active > 0
        if rows.any():
            np.testing.assert_allclose(got[rows], np.asarray(want)[rows],
                                       atol=POSE_TOL)
        _assert_states_close(sess._states, ref._states)
    assert rows.any()
    before = [t.clone() for t in jax.tree_util.tree_leaves(sess._states)]
    sess.reset(stream=2)
    for b, a in zip(before, jax.tree_util.tree_leaves(sess._states)):
        assert a.shape == (S, H) and b[2].abs().sum() > 0
        assert not a[2].any()
        torch.testing.assert_close(a[:2], b[:2], rtol=0, atol=0)


def _port_session(kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "tp":
        _, cfg, _ = _tp_cascades(hidden=8)
    else:
        dims = ((12, 3, 3), (15, 3, 3), (15, 9, 9))
        cfg = TPL.CascadeConfig(*(TPL.PoseNetConfig(net=TN.GraphNetConfig(
            cell=kind, units_in=ui, units_out=uo, units_hidden=8),
            rotsize=rot) for ui, uo, rot in dims))
    params3 = tuple(TPL.init_pose_net(gen, c, t_adjacency())
                    for c in cfg.stages)
    return StreamingCascade(params3, cfg, ParametricModel(), window=4,
                            streams=3, device="cpu")


@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp"])
def test_torch_port_reset_zeroes_one_slot_of_every_leaf(kind):
    sess = _port_session(kind)
    gen = torch.Generator().manual_seed(1)
    sess._states = jax.tree_util.tree_map(
        lambda t: torch.randn(t.shape, generator=gen), sess._states)
    before = jax.tree_util.tree_leaves(sess._states)
    sess.reset(stream=1)
    after = jax.tree_util.tree_leaves(sess._states)
    assert len(after) == len(before) > 0
    for b, a in zip(before, after):
        assert a.shape == b.shape and a.shape[1] == 3
        assert not a[:, 1].any()
        keep = torch.ones(3, dtype=torch.bool)
        keep[1] = False
        torch.testing.assert_close(a[:, keep], b[:, keep], rtol=0, atol=0)
