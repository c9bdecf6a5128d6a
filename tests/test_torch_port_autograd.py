"""Gradients through the port's three kernel ops (``ops/library.py``'s
autograd formula: the backward reruns the op's plain version) against the
JAX package's ``jax.grad`` through ``backend="pallas"`` (its ``custom_jvp``
recomputes on the XLA scan; the Pallas forward runs in interpret mode on
the CPU), and against autograd through the port's plain versions
(``backend="eager"``: ``bi_*_reference``).

Gradients of a scalar loss (random weights on the outputs on valid frames
and on the final states) with respect to every parameter, the input and
the initial state, graph nets (a3gc, aagc, agc, ggru) and DIP nets (bi and
uni), with and without a ragged frame mask. Tolerance 1e-5 relative to
each leaf's max |g|: fp32 on both sides, sums reordered.

Inference records no autograd graph: the sessions, the evaluator,
``cascade_apply`` and ``forward_offline`` reach the kernel ops with grad
disabled, and return tensors that do not require grad."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.models import nets as JN
from a3gc_tpu_torch.compat.from_jax import (dip_params_from_jax,
                                            graph_net_params_from_jax)
from a3gc_tpu_torch.models import layers as TL
from a3gc_tpu_torch.models import nets as TN

from torch_port_oracle import jax_dip, jax_graph_net, state_leaves, to_jnp

torch.set_num_threads(1)

TOL = 1e-5
H = 8
B, T = 2, 6


def _leaf(tree, name):
    """The leaf of a JAX pytree at a torch parameter name."""
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else getattr(tree, part)
    return np.asarray(tree)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} relative"


def _inputs(rng, x_shape, state_shapes, y_shape, lengths):
    x = rng.normal(size=x_shape).astype(np.float32)
    state = [(0.5 * rng.normal(size=s)).astype(np.float32)
             for s in state_shapes]
    mask = (np.arange(T)[None] < np.asarray(lengths)[:, None])
    r_y = rng.normal(size=y_shape).astype(np.float32)
    r_y *= mask.reshape(mask.shape + (1,) * (len(y_shape) - 2))
    r_s = [rng.normal(size=s).astype(np.float32) for s in state_shapes]
    return x, state, mask.astype(np.float32), r_y, r_s


def _jax_loss(apply, r_y, r_s):
    def loss(params, x, state):
        y, st = apply(params, x, state)
        return (jnp.sum(y * r_y) + sum(jnp.sum(a * b) for a, b in
                                       zip(jax.tree_util.tree_leaves(st),
                                           r_s)))
    return loss


def _torch_grads(params, apply, x, state, r_y, r_s):
    x = torch.tensor(x, requires_grad=True)
    state = [torch.tensor(s, requires_grad=True) for s in state]
    y, st = apply(params, x, state)
    loss = (y * torch.from_numpy(r_y)).sum() + sum(
        (a * torch.from_numpy(b)).sum() for a, b in zip(_flat(st), r_s))
    loss.backward()
    return x.grad.numpy(), [s.grad.numpy() for s in state]


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _flat(t)]
    return [tree]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cell", ["a3gc", "aagc", "agc", "ggru"])
def test_torch_port_graph_net_grads_match_jax_pallas(cell, masked):
    jcfg, params = jax_graph_net(cell, 15, 9, H, seed=31)
    jcfg = jcfg.replace(backend="pallas")
    n_state = 1 if cell == "ggru" else 2
    lengths = [T, 4] if masked else [T, T]
    x, state, mask, r_y, r_s = _inputs(
        np.random.default_rng(32), (B, T, 15, 15),
        [(2, B, 15, H)] * n_state, (B, T, 15, 9), lengths)
    jmask = jnp.asarray(mask) if masked else None

    def japply(p, xx, st):
        return JN.graph_net_apply(p, jcfg, xx, st[0] if cell == "ggru"
                                  else tuple(st), frame_mask=jmask)

    loss = _jax_loss(japply, r_y, r_s)
    g_p, g_x, g_s = jax.grad(loss, argnums=(0, 1, 2))(
        to_jnp(params), jnp.asarray(x), [jnp.asarray(s) for s in state])

    tcfg = TN.GraphNetConfig(cell=cell, units_in=15, units_out=9,
                             units_hidden=H)
    grads = {}
    for backend in ("auto", "eager"):
        p = graph_net_params_from_jax(params, device="cpu")
        cfg = dataclasses.replace(tcfg, backend=backend)

        def tapply(pp, xx, st):
            return TN.graph_net_apply(
                pp, cfg, xx, st[0] if cell == "ggru" else tuple(st),
                frame_mask=mask if masked else None, device="cpu")

        gx, gs = _torch_grads(p, tapply, x, state, r_y, r_s)
        grads[backend] = (gx, gs, {n: t.grad.numpy().copy()
                                   for n, t in p.named_parameters()})
    for backend, (gx, gs, gp) in grads.items():
        _close(gx, np.asarray(g_x), f"{backend} x")
        for i, (a, b) in enumerate(zip(gs, g_s)):
            _close(a, np.asarray(b), f"{backend} state {i}")
        for name, g in gp.items():
            _close(g, _leaf(g_p, name), f"{backend} {name}")
    # the op's gradients are its plain version's
    for name, g in grads["auto"][2].items():
        _close(g, grads["eager"][2][name], f"op vs plain {name}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_torch_port_dip_grads_match_jax_pallas(bidirectional, masked):
    jcfg, params = jax_dip(12, 9, H, seed=33, bidirectional=bidirectional)
    jcfg = jcfg.replace(backend="pallas")
    D = 2 if bidirectional else 1
    st_shape = (2, B, H) if bidirectional else (B, H)
    lengths = [T, 3] if masked else [T, T]
    x, state, mask, r_y, r_s = _inputs(
        np.random.default_rng(34), (B, T, 12), [st_shape] * 4, (B, T, 9),
        lengths)
    jmask = jnp.asarray(mask) if masked else None

    def pairs(st):
        return ((st[0], st[1]), (st[2], st[3]))

    def japply(p, xx, st):
        return JN.dip_apply(p, jcfg, xx, pairs(st), frame_mask=jmask)

    loss = _jax_loss(japply, r_y, r_s)
    g_p, g_x, g_s = jax.grad(loss, argnums=(0, 1, 2))(
        to_jnp(params), jnp.asarray(x), [jnp.asarray(s) for s in state])

    tcfg = TN.DIPConfig(n_input=12, n_output=9, n_hidden=H,
                        bidirectional=bidirectional)
    for backend in ("auto", "eager"):
        cfg = dataclasses.replace(tcfg, backend=backend)
        p = _dip_params(params, D)

        def tapply(pp, xx, st):
            return TN.dip_apply(pp, cfg, xx, pairs(st),
                                frame_mask=mask if masked else None,
                                device="cpu")

        gx, gs = _torch_grads(p, tapply, x, state, r_y, r_s)
        _close(gx, np.asarray(g_x), f"{backend} x")
        for i, (a, b) in enumerate(zip(gs, g_s)):
            _close(a, np.asarray(b), f"{backend} state {i}")
        for name, t in p.named_parameters():
            _close(t.grad.numpy(), _leaf(g_p, name), f"{backend} {name}")


def _dip_params(params, D):
    if D == 2:
        return dip_params_from_jax(params, device="cpu")
    from a3gc_tpu_torch.compat.from_jax import lstm_layer_params_from_jax
    return TN.DIPParams(
        TN.DenseParams(params.linear1.kernel, params.linear1.bias),
        [lstm_layer_params_from_jax(t, "cpu") for t in params.lstm],
        TN.DenseParams(params.linear2.kernel, params.linear2.bias))


def test_torch_port_op_grads_need_only_what_is_asked():
    """The backward differentiates the inputs that need a gradient: a
    layer whose input alone requires grad leaves the parameters' .grad
    unset; n_valid (integer) never gets one."""
    _, params = jax_graph_net("a3gc", 15, 9, H, seed=35)
    p = graph_net_params_from_jax(params, device="cpu").requires_grad_(False)
    x = torch.randn(B, T, 15, 2 * H, requires_grad=True)
    st = tuple(torch.zeros(2, B, 15, H) for _ in range(2))
    from a3gc_tpu_torch.ops import gcn_lstm as G
    y, (h, c) = G.bi_gcn_lstm(p.rnn2, x, st, torch.tensor([T, 2]))
    (y.sum() + h.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(t.grad is None for t in p.parameters())


def _no_grad_spy(monkeypatch):
    """Wrap the three ops' wrappers so that every call records whether grad
    mode was on and whether its outputs require grad."""
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    seen = []
    for mod, name in ((G, "bi_gcn_lstm"), (GG, "bi_ggru"),
                      (LS, "bi_lstm")):
        real = getattr(mod, name)

        def spy(*args, _real=real):
            out = _real(*args)
            seen.append((torch.is_grad_enabled(),
                         any(t.requires_grad for t in state_tensors(out))))
            return out

        monkeypatch.setattr(mod, name, spy)
    return seen


def state_tensors(tree):
    return [t for t in _flat(tree) if isinstance(t, torch.Tensor)]


def test_torch_port_inference_records_no_graph(monkeypatch, tmp_path):
    """With the grad guards gone, every inference entry point still runs
    the kernel ops with grad disabled and returns no tensor that requires
    grad, though the params do."""
    from a3gc_tpu_torch.compat.from_jax import cascade_params_from_jax
    from a3gc_tpu_torch.data import load_stats
    from a3gc_tpu_torch.eval import CascadeEvaluator
    from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                               StreamingCascade)
    from a3gc_tpu_torch.models.pipeline import (PoseNetConfig,
                                                cascade_apply,
                                                forward_offline)
    from a3gc_tpu_torch.smpl import (ParametricModel, load_parametric_model,
                                     write_synthetic_smpl_pickle)

    from torch_port_oracle import cascades, eval_sequences

    seen = _no_grad_spy(monkeypatch)
    _, tcfg, params = cascades("a3gc")
    params3 = cascade_params_from_jax(params, device="cpu")
    assert all(t.requires_grad for p in params3 for t in p.parameters())
    model = ParametricModel()
    W = 6
    ori = np.tile(np.eye(3, dtype=np.float32).reshape(1, 1, 9),
                  (2, W, 6)).reshape(2, W, 54)
    acc = np.zeros((2, W, 18), np.float32)

    sess = StreamingCascade(params3, tcfg, model, window=W, streams=2,
                            device="cpu")
    sess.step(ori, acc)
    assert not any(t.requires_grad for t in state_tensors(sess._states))

    _, dparams = jax_dip(60, 135, H, seed=36)
    dsess = DipStreamingSession(
        dip_params_from_jax(dparams, device="cpu"),
        PoseNetConfig(net=TN.DIPConfig(n_hidden=H), rotsize=9), model,
        window=W, stats=load_stats(), streams=2, device="cpu")
    dsess.step(ori, acc)
    assert not any(t.requires_grad for t in state_tensors(dsess._states))

    imu = torch.randn(1, W, 15, 12)
    pose = cascade_apply(params3, tcfg, model, imu, device="cpu")
    assert not pose.requires_grad
    pose = forward_offline(params3[2], tcfg.stage3, model,
                           torch.randn(1, W, 15, 15))
    assert not pose.requires_grad

    smpl = load_parametric_model(write_synthetic_smpl_pickle(
        str(tmp_path / "smpl.pkl"), n_vertices=64), device="cpu")
    ev = CascadeEvaluator(params3, tcfg, smpl, None, False, device="cpu")
    mean = ev.evaluate(eval_sequences([W, W + 2], seed=3))[0]
    assert np.isfinite(np.asarray(mean)).all()

    assert len(seen) == 6 + 2 + 6 + 2 + 12     # one per layer call
    assert not any(grad or req for grad, req in seen)


def test_torch_port_bi_rnn_emits_the_carried_state_on_masked_frames():
    """The training scan's layer (``layers.bi_rnn``) carries the state
    through masked frames and emits the carried h there, like the plain
    hoisted scan the kernels are held to."""
    from a3gc_tpu_torch.models import cells as C
    _, params = jax_graph_net("a3gc", 15, 9, H, seed=37)
    p = graph_net_params_from_jax(params, device="cpu")
    x = torch.randn(B, T, 15, 2 * H)
    st = tuple(0.5 * torch.randn(2, B, 15, H) for _ in range(2))
    mask = torch.arange(T)[None] < torch.tensor([T, 3])[:, None]
    with torch.no_grad():
        y, (h, c) = TL.bi_rnn(C.gcn_lstm_step, p.rnn2, x, st,
                              frame_mask=mask)
        from a3gc_tpu_torch.ops import gcn_lstm as G
        ref_y, (ref_h, ref_c) = G.bi_gcn_lstm_reference(
            p.rnn2, x, st, mask.sum(1))
    np.testing.assert_allclose(torch.tanh(y).numpy(), ref_y.numpy(),
                               atol=TOL)
    for a, b in zip(state_leaves((h, c)), state_leaves((ref_h, ref_c))):
        np.testing.assert_allclose(a, b, atol=TOL)
