"""Tensor parallelism of the port on the CPU (a mesh's ``model`` axis over
repeated CPU devices) against the single-device port and the JAX package:
``param_sharding`` makes JAX's decision for every parameter of every family
at ``model`` 1, 2 and 4; ``shard_params`` blocks concatenate back to the
module; ``StageRunner`` on (1, 2) and (2, 2) meshes (A3GC, G-GRU,
TransPose at hidden 32, so the attention, the gate biases and the dense
kernels split) steps within 2e-6 of one device and, for A3GC, within 1e-5
of JAX's TP runner, validation likewise; the gradients of the replicated
parameters are not summed over the model axis; ``DIPRunner`` keeps
replicated parameters; a TP checkpoint resumes unsharded and back; the
serving entry points on a (2, 2) mesh against JAX's on the same layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu import config as JC
from a3gc_tpu.data import load_adjacency_template as jax_adjacency
from a3gc_tpu.eval import run as JR
from a3gc_tpu.eval.streaming import StreamingCascade as JaxStreamingCascade
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu.parallel import cascade_apply_sharded as jax_sharded
from a3gc_tpu.parallel import make_mesh as jax_make_mesh
from a3gc_tpu.parallel import param_sharding as jax_param_sharding
from a3gc_tpu.smpl import load_parametric_model as jax_load
from a3gc_tpu.smpl import write_synthetic_smpl_pickle
from a3gc_tpu_torch import config as TC
from a3gc_tpu_torch.compat.from_jax import (cascade_params_from_jax,
                                            dip_params_from_jax,
                                            graph_net_params_from_jax)
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.data import pipeline as TDP
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.eval import run as TR
from a3gc_tpu_torch.eval.streaming import StreamingCascade
from a3gc_tpu_torch.parallel import (cascade_apply_sharded, make_mesh,
                                     param_sharding, shard_params)
from a3gc_tpu_torch.parallel.mesh import split_names
from a3gc_tpu_torch.parallel.tensor import gather_module
from a3gc_tpu_torch.smpl import ParametricModel, load_parametric_model
from a3gc_tpu_torch.train import seeded_generator
from a3gc_tpu_torch.utils import restore_params, save_params

from torch_port_oracle import (GRAPH_DIMS, TP_DIMS, cascades, eval_sequences,
                               jax_leaf, perturbed, state_leaves, to_jnp,
                               train_runners)

torch.set_num_threads(1)

LOCAL_TOL = 2e-6        # the same math, the products' sums reordered
JAX_TOL = 1e-5
GRAD_TOL = 1e-5         # max |d| over max |g| of each leaf
TABLE_TOL = 1e-3
HIDDEN = 32             # 32 and 4·32 both split over 2 and 4 members
LAYOUTS = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def packed():
    return synthetic_packed_dataset(n_seqs=8, seq_len=12, seed=0)


def _mesh(data, model):
    return make_mesh(TC.MeshConfig(data=data, model=model),
                     devices=["cpu"] * (data * model))


def _jax_mesh(data, model):
    return jax_make_mesh(JC.MeshConfig(data=data, model=model),
                         devices=jax.devices()[:data * model])


def _family(kind, hidden):
    """(JAX params, the port's module) of one stage-1 net."""
    from a3gc_tpu.models import nets as JN
    if kind in ("tp", "dip"):
        ni, no, _ = TP_DIMS[0] if kind == "tp" else (60, 135, 9)
        cfg = JN.DIPConfig(n_input=ni, n_output=no, n_hidden=hidden)
        params = perturbed(JN.init_dip(jax.random.PRNGKey(0), cfg), 0)
        return params, dip_params_from_jax(params, "cpu")
    ui, uo, rot = GRAPH_DIMS[0]
    cfg = JPL.PoseNetConfig(net=JN.GraphNetConfig(
        cell=kind, units_in=ui, units_out=uo, units_hidden=hidden),
        rotsize=rot)
    params = perturbed(JPL.init_pose_net(jax.random.PRNGKey(0), cfg,
                                         jax_adjacency()), 0)
    return params, graph_net_params_from_jax(params, "cpu")


@pytest.mark.parametrize("kind", ["a3gc", "aagc", "ggru", "tp", "dip"])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_torch_port_param_sharding_matches_jax(kind, model):
    ours, ref = _mesh(4 // model, model), _jax_mesh(4 // model, model)
    for hidden in (8, HIDDEN):
        jparams, module = _family(kind, hidden)
        n_split = 0
        for name, p in module.named_parameters():
            want = "model" in str(jax_param_sharding(
                ref, jnp.asarray(jax_leaf(jparams, name))).spec)
            got = param_sharding(ours, p)
            assert got.split == want, (kind, hidden, name)
            assert (got.axis, got.parts) == ((-1, model) if want
                                             else (None, 1))
            n_split += want
        if hidden == HIDDEN:
            assert (n_split > 0) == (model > 1)


@pytest.mark.parametrize("data,model", LAYOUTS + [(1, 4)])
def test_torch_port_shard_params_blocks_concatenate_back(data, model):
    _, module = _family("a3gc", HIDDEN)
    mesh = _mesh(data, model)
    split = split_names(module, mesh)
    assert {"rnn1.kernel", "rnn1.bias", "rnn1.attention.w",
            "rnn1.attention.bs", "linear_in.kernel"} <= split
    assert not split & {"rnn1.adj", "rnn1.attention.u", "rnn1.attention.bu",
                        "linear_out.kernel", "linear_in.bias"}
    whole = dict(module.named_parameters())
    for shard in range(data):
        members = shard_params(module, mesh, shard)
        assert len(members) == model
        assert all(type(m) is type(module) for m in members)
        named = [dict(m.named_parameters()) for m in members]
        for name, p in whole.items():
            blocks = [n[name] for n in named]
            assert all(isinstance(b, torch.nn.Parameter) for b in blocks)
            if name in split:
                assert blocks[0].shape[-1] * model == p.shape[-1]
                assert torch.equal(torch.cat(blocks, dim=-1), p)
            else:
                assert all(torch.equal(b, p) for b in blocks)
        back = gather_module(members, split)
        for name, p in back.named_parameters():
            assert torch.equal(p, whole[name]), name


def _steps(jr, tr, single, packed, n=3):
    """n steps of one padded epoch on the TP runner, the single-device one
    and JAX's TP runner (when given): the TP loss within LOCAL_TOL of one
    device, and no further from JAX's than one device's is. (At hidden 32
    the single-device port's stage-1 loss itself leaves JAX's by up to
    1.3e-5 at the third step, where it has fallen from 18 to 3.6: the
    steep loss amplifies the parameters' fp32 rounding, which stays within
    4e-7.) Returns JAX's state."""
    sampler = TDP.Sampler(packed, 4, seed=1, pad_remainder=True)
    state = None if jr is None else jr.state
    for i, raw in enumerate((list(sampler) * 2)[:n]):
        loss = float(tr.train_step(raw, seeded_generator("cpu", i)))
        want = float(single.train_step({k: torch.as_tensor(v)
                                        for k, v in raw.items()},
                                       seeded_generator("cpu", i)))
        np.testing.assert_allclose(loss, want, rtol=LOCAL_TOL)
        _grads_close(tr, single)
        if jr is not None:
            state, jloss = jr.train_step(state, jr._put(raw),
                                         jax.random.PRNGKey(i))
            jloss = float(jloss)
            assert abs(loss - jloss) <= (abs(want - jloss)
                                         + LOCAL_TOL * abs(jloss)), i
    if jr is not None:
        jr.state = state
    return state


def _grads_close(tr, single):
    """The TP step's gradients (each split parameter's blocks
    concatenated, each replicated one the lead's) against one device's:
    max |d| within GRAD_TOL of the leaf's max |g|."""
    named = [dict(m.named_parameters()) for m in tr.state.master]
    for name, p in single.state.params.named_parameters():
        got = (torch.cat([n[name].grad for n in named], -1)
               if name in tr._split else named[0][name].grad)
        scale = float(p.grad.abs().max())
        assert float((got - p.grad).abs().max()) <= GRAD_TOL * scale, name


def _params_close(got, want, atol):
    want = dict(want.named_parameters())
    for name, p in got.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("data,model", LAYOUTS)
@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp"])
def test_torch_port_tp_stage_runner_matches_single_device(packed, kind,
                                                          data, model):
    """Stage 1 of each family, three steps: the loss at LOCAL_TOL, each
    step's gradients at GRAD_TOL, the parameters at LOCAL_TOL, validation
    at LOCAL_TOL; A3GC's parameters and validation at JAX_TOL of JAX's TP
    runner on the same layout."""
    kw = dict(hidden=HIDDEN, batch_size=4, eval_batch_size=4)
    jax_mesh = _jax_mesh(data, model) if kind == "a3gc" else None
    jr, tr = train_runners(kind, 1, mesh=_mesh(data, model),
                           jax_mesh=jax_mesh, **kw)
    _, single = train_runners(kind, 1, **kw)
    assert tr._split and len(tr.state.master) == model
    state = _steps(jr if jax_mesh is not None else None, tr, single, packed)
    _params_close(tr.state.params, single.state.params, LOCAL_TOL)
    valid = TDP.Sampler(packed, 4, shuffle=False, pad_remainder=True)
    np.testing.assert_allclose(tr.eval_epoch(valid),
                               single.eval_epoch(valid), rtol=LOCAL_TOL)
    if jax_mesh is None:
        return
    for name, t in tr.state.params.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(),
                                   jax_leaf(state.params, name),
                                   atol=JAX_TOL, err_msg=name)
    np.testing.assert_allclose(
        tr.eval_epoch(valid),
        jr.eval_epoch(TDP.Sampler(packed, 4, shuffle=False,
                                  pad_remainder=True)), rtol=JAX_TOL)


def test_torch_port_tp_gradients_sum_over_the_data_axis_only(packed):
    """After one step on a (2, 2) mesh: each block's gradient is its
    columns of the single-device gradient, and each replicated parameter's
    gradient (adjacencies, ``u``, ``bu``, the 1-D biases, the narrow
    output kernel) is the single-device one, not M times it; the other
    members' replicated copies take no gradient."""
    kw = dict(hidden=HIDDEN, batch_size=4, weight_decay=0.1)
    _, tr = train_runners("a3gc", 1, mesh=_mesh(2, 2), **kw)
    _, single = train_runners("a3gc", 1, **kw)
    raw = {k: v[:4] for k, v in packed.items()}
    tr.train_step(raw, seeded_generator("cpu", 0))
    single.train_step({k: torch.as_tensor(v) for k, v in raw.items()},
                      seeded_generator("cpu", 0))
    want = dict(single.state.params.named_parameters())
    named = [dict(m.named_parameters()) for m in tr.state.master]
    replicated = 0
    for name, p in want.items():
        g = p.grad.numpy()
        if name in tr._split:
            got = torch.cat([n[name].grad for n in named], -1).numpy()
        else:
            replicated += 1
            got = named[0][name].grad.numpy()
            assert all(n[name].grad is None for n in named[1:]), name
        np.testing.assert_allclose(got, g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max(), err_msg=name)
    assert replicated >= 6
    _params_close(tr.state.params, single.state.params, LOCAL_TOL)


@pytest.mark.parametrize("data", [1, 2])
def test_torch_port_tp_dip_runner_keeps_replicated_params(packed, data):
    kw = dict(batch_size=4)
    _, tr = train_runners("dip", 1, mesh=_mesh(data, 2), **kw)
    _, single = train_runners("dip", 1, **kw)
    assert tr._split is None and tr.mesh.devices == (torch.device("cpu"),) * data
    for i, raw in enumerate(list(TDP.Sampler(packed, 4, seed=2,
                                             pad_remainder=True))[:2]):
        loss = tr.train_step(raw, seeded_generator("cpu", i))
        want = single.train_step({k: torch.as_tensor(v)
                                  for k, v in raw.items()},
                                 seeded_generator("cpu", i))
        if data == 1:
            assert float(loss) == float(want)
    if data == 1:
        for (name, a), b in zip(tr.state.params.named_parameters(),
                                single.state.params.parameters()):
            assert torch.equal(a, b), name
    else:
        _params_close(tr.state.params, single.state.params, LOCAL_TOL)


def test_torch_port_tp_checkpoint_resumes_unsharded_and_back(packed,
                                                             tmp_path):
    """A TP runner's checkpoint is the port's ``params.pt`` of the gathered
    net: restored into an unsharded runner (and an unsharded one's into a
    TP runner), the next step agrees with the runner that wrote it."""
    kw = dict(hidden=HIDDEN, batch_size=4)
    _, tp = train_runners("a3gc", 2, mesh=_mesh(1, 2), **kw)
    _, single = train_runners("a3gc", 2, **kw)
    raws = [{k: v[4 * i:4 * i + 4] for k, v in packed.items()}
            for i in range(2)]
    tp.train_step(raws[0], seeded_generator("cpu", 0))
    single.train_step({k: torch.as_tensor(v) for k, v in raws[0].items()},
                      seeded_generator("cpu", 0))
    for src, dst_mesh, name in ((tp, None, "tp"), (single, _mesh(2, 2),
                                                   "single")):
        path = save_params(src.state.params, str(tmp_path / name), 2, 0)
        restored = restore_params(path, train_runners(
            "a3gc", 2, **kw)[1].state.params)
        _params_close(restored, src.state.params, 0.0)
        _, dst = train_runners("a3gc", 2, mesh=dst_mesh, **kw)
        dst = type(dst)(2, dst.stage_cfg, restored, dst.cfg, 1,
                        stats=load_stats(), graph=True, device="cpu",
                        mesh=dst_mesh)
        _params_close(dst.state.params, restored, 0.0)
        a = src.train_step(raws[1] if src.mesh is not None else
                           {k: torch.as_tensor(v) for k, v in
                            raws[1].items()}, seeded_generator("cpu", 1))
        b = dst.train_step(raws[1] if dst_mesh is not None else
                           {k: torch.as_tensor(v) for k, v in
                            raws[1].items()}, seeded_generator("cpu", 1))
        np.testing.assert_allclose(float(a), float(b), rtol=LOCAL_TOL)


def _merged(shard_states):
    """A mesh session's per-shard states as one nest, slots concatenated."""
    if isinstance(shard_states[0], (tuple, list)):
        return tuple(_merged([s[i] for s in shard_states])
                     for i in range(len(shard_states[0])))
    return torch.cat(shard_states, dim=1)


@pytest.fixture(scope="module")
def a3gc():
    jcfg, tcfg, params = cascades("a3gc")
    return jcfg, tcfg, params, cascade_params_from_jax(params, device="cpu")


def test_torch_port_tp_mesh_serving_matches_jax(a3gc, tmp_path):
    """``cascade_apply_sharded``, a ``StreamingCascade(mesh=)`` tick and
    ``evaluate_batched`` on a (2, 2) mesh shard over ``data`` and replicate
    over ``model``, as JAX's on a (2, 2) JAX mesh."""
    from __graft_entry__ import _body_model
    jcfg, tcfg, params, p3 = a3gc
    ours, ref = _mesh(2, 2), _jax_mesh(2, 2)
    rng = np.random.default_rng(61)
    imu = rng.normal(size=(4, 6, 15, 12)).astype(np.float32)
    mask = np.ones((4, 6), np.float32)
    mask[1, 4:] = 0.0
    got = cascade_apply_sharded(p3, tcfg, ParametricModel(), imu, ours,
                                frame_mask=mask).numpy()
    want = np.asarray(jax.jit(lambda p, x, m: jax_sharded(
        p, jcfg, _body_model(n_vertices=48), x, ref, frame_mask=m))(
            to_jnp(params), jnp.asarray(imu), jnp.asarray(mask)))
    valid = mask.reshape(-1) > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5)

    stats = load_stats()
    sess = StreamingCascade(p3, tcfg, ParametricModel(), window=4,
                            stats=stats, normalize=True, streams=4,
                            mesh=ours)
    jsess = JaxStreamingCascade(to_jnp(params), jcfg,
                                _body_model(n_vertices=48), window=4,
                                stats=stats, normalize=True, streams=4,
                                mesh=ref)
    ori = rng.normal(size=(4, 4, 54)).astype(np.float32)
    acc = rng.normal(size=(4, 4, 18)).astype(np.float32)
    np.testing.assert_allclose(sess.step(ori, acc),
                               np.asarray(jsess.step(ori, acc)), atol=1e-5)
    assert len(sess._states) == 2
    for a, b in zip(state_leaves(_merged(sess._states)),
                    state_leaves(jsess._states)):
        np.testing.assert_allclose(a, b, atol=1e-5)

    path = write_synthetic_smpl_pickle(str(tmp_path / "smpl.pkl"),
                                       n_vertices=64)
    seqs = eval_sequences([20, 30], seed=9)
    table = TR.CascadeEvaluator(
        p3, tcfg, load_parametric_model(path, device="cpu"), stats,
        normalize=True, mesh=ours).evaluate_batched(seqs, streams=2)[0]
    want = JR.CascadeEvaluator(
        to_jnp(params), jcfg, jax_load(path), stats, normalize=True,
        mesh=ref).evaluate_batched(seqs, streams=2)[0]
    assert np.isfinite(table).all()
    np.testing.assert_allclose(table, want, atol=TABLE_TOL)


def test_torch_port_make_mesh_refuses_layouts_that_fit_no_process():
    with pytest.raises(ValueError, match="needs 6 device"):
        make_mesh(TC.MeshConfig(data=3, model=2), devices=["cpu"] * 4)
    mesh = _mesh(1, 4)
    assert mesh.devices == (torch.device("cpu"),)
    assert len(mesh.model_devices[0]) == 4 and mesh.model_rank == 0
    assert mesh.model_group is None and mesh.data_group is None


@pytest.mark.parametrize("train_kw,rtol", [
    (dict(dtype="bfloat16"), 2.0 ** -8),     # bf16 products, reordered
    (dict(accum_steps=2), LOCAL_TOL)])
def test_torch_port_tp_mixed_precision_and_accumulation(packed, train_kw,
                                                        rtol):
    """bf16 casts each block (``_cast_module`` through ``blockwise``), and
    ``--accum`` builds a column view per microbatch: a TP step on (1, 2)
    against one device's."""
    kw = dict(hidden=HIDDEN, batch_size=4, **train_kw)
    _, tr = train_runners("a3gc", 1, mesh=_mesh(1, 2), **kw)
    _, single = train_runners("a3gc", 1, **kw)
    raw = {k: v[:4] for k, v in packed.items()}
    loss = tr.train_step(raw, seeded_generator("cpu", 0))
    want = single.train_step({k: torch.as_tensor(v) for k, v in raw.items()},
                             seeded_generator("cpu", 0))
    np.testing.assert_allclose(float(loss), float(want), rtol=rtol)
    if rtol == LOCAL_TOL:
        _grads_close(tr, single)
