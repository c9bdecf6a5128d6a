"""The port's G-GRU family against the JAX package on the CPU: the layer
(a3gc_tpu_torch.ops.ggru) against the Pallas ``bi_ggru_pallas`` in
interpret mode (``_ggru_kernel``) and the net against the XLA scan, then
the ggru cascade offline (``cascade_apply``) and online
(``StreamingCascade`` over three windows with an idle slot and a per-slot
reset).

The Pallas kernel emits the carried h on frames >= n_valid, which is the
port's function too, so every frame is compared there; the XLA scan emits
the unmasked step, so against it only valid frames are compared, and every
carried state. Tolerance 1e-5 absolute per module: fp32 on both sides, the
same op order, sums reordered by the two frameworks' matmul kernels over
short recurrences; 1e-4 on poses after three stages and IK."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.data import load_adjacency_template
from a3gc_tpu.eval.streaming import StreamingCascade as JaxStreamingCascade
from a3gc_tpu.models import cells as JC
from a3gc_tpu.models import layers as JL
from a3gc_tpu.models import nets as JN
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu.ops.pallas_gcn_lstm import bi_ggru_pallas
from a3gc_tpu_torch.compat.from_jax import (cascade_params_from_jax,
                                            cell_params_from_jax,
                                            graph_net_params_from_jax)
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.eval.streaming import StreamingCascade
from a3gc_tpu_torch.models import cells as TC
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL
from a3gc_tpu_torch.ops import ggru as GG
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import jax_graph_net, perturbed, to_jnp

TOL = 1e-5
POSE_TOL = 1e-4
H, N = 8, 15


def jax_ggru_params2(units_in, hidden, seed):
    """Direction-stacked JAX G-GRU cell params (numpy leaves, perturbed)."""
    nira = load_adjacency_template()
    one = [JC.init_ggru_cell(jax.random.PRNGKey(seed + i), units_in, hidden,
                             nira) for i in range(2)]
    return perturbed(JL.stack_directions(*one), seed)


def _port_layer(params_np, x, h, n_valid):
    p = cell_params_from_jax(params_np, device="cpu")
    with torch.no_grad():
        y, hn = GG.bi_ggru_reference(p, torch.from_numpy(x),
                                     torch.from_numpy(h),
                                     None if n_valid is None
                                     else torch.as_tensor(n_valid))
    return y.numpy(), hn.numpy()


@pytest.mark.parametrize("S,n_valid", [(1, None), (3, [12, 5, 0])])
def test_torch_port_ggru_layer_matches_pallas(S, n_valid):
    T, F = 12, 2 * H
    params = jax_ggru_params2(F, H, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(S, T, N, F)).astype(np.float32)
    h = (0.5 * rng.normal(size=(2, S, N, H))).astype(np.float32)
    nv = None if n_valid is None else np.array(n_valid, np.int32)
    ref_y, ref_h = bi_ggru_pallas(to_jnp(params), x, h, n_valid=nv,
                                  interpret=True)
    y, hn = _port_layer(params, x, h, nv)
    assert y.shape == (S, T, N, 2 * H)
    np.testing.assert_allclose(y, np.asarray(ref_y), atol=TOL)
    np.testing.assert_allclose(hn, np.asarray(ref_h), atol=TOL)
    if S == 3:   # the idle stream's state passes through untouched
        np.testing.assert_array_equal(hn[:, 2], h[:, 2])


@pytest.mark.parametrize("masked", [False, True])
def test_torch_port_ggru_net_matches_xla(masked):
    B, T = 3, 10
    jcfg, params = jax_graph_net("ggru", 15, 9, H, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, N, 15)).astype(np.float32)
    h = (0.5 * rng.normal(size=(2, B, N, H))).astype(np.float32)
    lengths = np.array([T, 5, 0]) if masked else np.array([T] * B)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    ref_y, ref_h = JN.graph_net_apply(
        to_jnp(params), jcfg, jnp.asarray(x), jnp.asarray(h),
        frame_mask=jnp.asarray(mask) if masked else None)
    cfg = TN.GraphNetConfig(cell="ggru", units_in=15, units_out=9,
                            units_hidden=H)
    p = graph_net_params_from_jax(params, device="cpu")
    with torch.no_grad():
        y, hn = TN.graph_net_apply(p, cfg, x, torch.from_numpy(h),
                                   frame_mask=mask if masked else None,
                                   device="cpu")
    assert isinstance(hn, torch.Tensor) and y.shape == (B, T, N, 9)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(y[b, :n].numpy(), np.asarray(ref_y)[b, :n],
                                   atol=TOL)
    np.testing.assert_allclose(hn.numpy(), np.asarray(ref_h), atol=TOL)


def test_torch_port_ggru_wrapper_on_cpu_takes_plain_path():
    params = jax_ggru_params2(H, H, seed=5)
    p = cell_params_from_jax(params, device="cpu")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 5, N, H)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(2, 2, N, H)).astype(np.float32))
    GG.bi_ggru.launches = 0
    with torch.no_grad():
        y, hn = GG.bi_ggru(p, x, h, torch.tensor([5, 3]))
        ref_y, ref_h = GG.bi_ggru_reference(p, x, h, torch.tensor([5, 3]))
    assert GG.bi_ggru.launches == 0
    torch.testing.assert_close(y, ref_y, rtol=0, atol=0)
    torch.testing.assert_close(hn, ref_h, rtol=0, atol=0)


def test_torch_port_init_ggru_shapes_match_jax():
    """torch.Generator init: the JAX layouts, a xavier (not template)
    adjacency, nonzero input biases; other bits."""
    jcfg, jparams = jax_graph_net("ggru", 12, 3, H, seed=7)
    cfg = TN.GraphNetConfig(cell="ggru", units_in=12, units_out=3,
                            units_hidden=H)
    p = TN.init_graph_net(torch.Generator().manual_seed(0), cfg,
                          load_adjacency_template())
    assert isinstance(p.rnn1, TC.GGRUCellParams)
    for name, t in p.named_parameters():
        ref = jparams
        for part in name.split("."):
            ref = getattr(ref, part)
        assert tuple(t.shape) == np.shape(ref), name
    assert not np.allclose(p.rnn1.adj[0].detach().numpy(),
                           load_adjacency_template().T)
    assert p.rnn1.b_in.detach().abs().min() > 0
    bound = 1.0 / H ** 0.5
    assert p.rnn2.w_hid.detach().abs().max() <= bound
    zero = TN.graph_net_zero_state(cfg, 3, device="cpu")
    assert isinstance(zero, torch.Tensor) and zero.shape == (2, 3, N, H)


def _ggru_cascades():
    def j(ui, uo, rot):
        return JPL.PoseNetConfig(net=JN.GraphNetConfig(
            cell="ggru", units_in=ui, units_out=uo, units_hidden=H,
            backend="xla"), rotsize=rot)

    def t(ui, uo, rot):
        return TPL.PoseNetConfig(net=TN.GraphNetConfig(
            cell="ggru", units_in=ui, units_out=uo, units_hidden=H),
            rotsize=rot)

    dims = ((12, 3, 3), (15, 3, 3), (15, 9, 9))
    jcfg = JPL.CascadeConfig(*(j(*d) for d in dims))
    tcfg = TPL.CascadeConfig(*(t(*d) for d in dims))
    nira = load_adjacency_template()
    params = tuple(perturbed(JPL.init_pose_net(jax.random.PRNGKey(i), c,
                                               nira), seed=40 + i)
                   for i, c in enumerate((jcfg.stage1, jcfg.stage2,
                                          jcfg.stage3)))
    return jcfg, tcfg, params


@pytest.fixture(scope="module")
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


def test_torch_port_ggru_cascade_apply_matches_jax(jax_model):
    jcfg, tcfg, params = _ggru_cascades()
    B, T = 2, 8
    rng = np.random.default_rng(8)
    imu = rng.normal(size=(B, T, N, 12)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0.0
    ref = np.asarray(JPL.cascade_apply(to_jnp(params), jcfg, jax_model,
                                       jnp.asarray(imu),
                                       frame_mask=jnp.asarray(mask)))
    out = TPL.cascade_apply(cascade_params_from_jax(params, device="cpu"),
                            tcfg, ParametricModel(), imu, frame_mask=mask,
                            device="cpu").numpy()
    valid = mask.reshape(-1) > 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=POSE_TOL)


def test_torch_port_ggru_streaming_cascade_matches_jax(jax_model):
    jcfg, tcfg, params = _ggru_cascades()
    S, W = 3, 6
    stats = load_stats()
    ref = JaxStreamingCascade(to_jnp(params), jcfg, jax_model, window=W,
                              stats=stats, normalize=True, streams=S)
    sess = StreamingCascade(cascade_params_from_jax(params, device="cpu"),
                            tcfg, ParametricModel(), window=W, stats=stats,
                            normalize=True, streams=S, device="cpu")
    rng = np.random.default_rng(9)
    plan = [None, "reset1", np.array([1.0, 0.0, 1.0], np.float32), None]
    for item in plan:
        if isinstance(item, str):
            ref.reset(stream=1)
            sess.reset(stream=1)
        else:
            ori = rng.normal(size=(S, W, 54)).astype(np.float32)
            acc = rng.normal(size=(S, W, 18)).astype(np.float32)
            want = ref.step(ori, acc, active=item)
            got = sess.step(ori, acc, active=item)
            active = np.ones(S, bool) if item is None else item > 0
            np.testing.assert_allclose(got[active], want[active],
                                       atol=POSE_TOL)
        for h, rh in zip(sess._states, ref._states):
            np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=TOL)
