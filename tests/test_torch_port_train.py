"""The port's stage trainer (``a3gc_tpu_torch.train.StageRunner``) against
the JAX package's on the graph nets, dropout and teacher-forcing noise off
(the two draw other bits): the loss and its gradients of one step
(``jax.value_and_grad`` of ``StageRunner._loss_fn``) for stages 1-3 of
A3GC and for AGC and G-GRU, rtol 1e-5 (gradients relative to each leaf's
max |g|); three optimizer steps (torch Adam against optax, weight decay,
the staircase decay fast-forwarded by start_epoch, a padded tail batch)
within 2e-5 on the parameters, the AGC adjacency frozen; chunked
validation and full-sequence validation within 1e-5."""

import jax
import numpy as np
import pytest
import torch

from a3gc_tpu_torch.data import pipeline as TDP
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.train import seeded_generator

from torch_port_oracle import jax_leaf, train_runners

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_PARAMS = 2e-5


@pytest.fixture(scope="module")
def packed():
    return synthetic_packed_dataset(n_seqs=10, seq_len=16, seed=0)


def _batches(packed, n=1, B=4):
    """The first n batches of a padded epoch: numpy dicts with _weight."""
    sampler = TDP.Sampler(packed, B, seed=1, pad_remainder=True)
    return [b for _, b in zip(range(n), sampler)]


def _torch(raw):
    return {k: torch.as_tensor(v) for k, v in raw.items()}


def check_one_step(kind, stage, packed):
    jr, tr = train_runners(kind, stage)
    raw = _batches(packed)[0]
    loss, grads = jax.jit(jax.value_and_grad(jr._loss_fn))(
        jr.state.params, raw, jax.random.PRNGKey(0))
    params = tr.state.params
    ours = tr.loss(params, _torch(raw), seeded_generator("cpu", 0))
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(loss), rtol=RTOL)
    for name, t in params.named_parameters():
        want = jax_leaf(grads, name)
        err = np.abs(t.grad.numpy() - want).max() / max(
            np.abs(want).max(), 1e-30)
        assert err <= RTOL, f"{kind} stage {stage} {name}: {err:.3e}"


@pytest.mark.parametrize("kind, stage", [
    ("a3gc", 1), ("a3gc", 2), ("a3gc", 3), ("agc", 1), ("ggru", 1)])
def test_torch_port_one_step_loss_and_grads_match_jax(kind, stage, packed):
    check_one_step(kind, stage, packed)


def check_three_steps(kind, stage, packed, **train_kw):
    jr, tr = train_runners(kind, stage, **train_kw)
    state = jr.state
    for i, raw in enumerate(_batches(packed, 3)):
        state, jloss = jr.train_step(state, raw, jax.random.PRNGKey(i))
        tloss = tr.train_step(_torch(raw), seeded_generator("cpu", i))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    assert tr.state.step == int(state.step) == 3
    for name, t in tr.state.params.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(),
                                   jax_leaf(state.params, name),
                                   atol=ATOL_PARAMS, err_msg=name)
    return tr


@pytest.mark.parametrize("kind, stage, train_kw", [
    ("a3gc", 2, dict(weight_decay=1e-2, start_epoch=2)),
    ("ggru", 3, dict(lr_decay=0.5)),
])
def test_torch_port_three_steps_match_jax(kind, stage, train_kw, packed):
    check_three_steps(kind, stage, packed, **train_kw)


def test_torch_port_agc_adjacency_frozen_as_in_jax(packed):
    before = train_runners("agc", 3)[1].state.params
    adj = [before.rnn1.adj.detach().clone(), before.rnn2.adj.detach().clone()]
    tr = check_three_steps("agc", 3, packed, weight_decay=1e-2)
    p = tr.state.params
    assert torch.equal(p.rnn1.adj, adj[0]) and torch.equal(p.rnn2.adj,
                                                           adj[1])
    assert p.rnn1.adj.grad is not None          # computed, not applied
    assert not any(q is p.rnn1.adj for g in tr.state.optimizer.param_groups
                   for q in g["params"])


def test_torch_port_eval_epoch_matches_jax(packed):
    """Chunks of 3 over padded batches of 4 (the padded tail's chunk
    weighted by its real rows), through the kernel ops' path."""
    jr, tr = train_runners("a3gc", 2, eval_batch_size=3)
    def sampler(mod):
        return mod.Sampler(packed, 4, shuffle=False, pad_remainder=True)
    from a3gc_tpu.data import pipeline as JDP
    ours, ref = tr.eval_epoch(sampler(TDP)), jr.eval_epoch(sampler(JDP))
    np.testing.assert_allclose(ours, ref, rtol=RTOL)


def test_torch_port_eval_full_sequences_matches_jax(packed):
    jr, tr = train_runners("a3gc", 3)
    seqs = [{k: v[i, :n] for k, v in packed.items()}
            for i, n in enumerate((16, 7, 11, 5, 16))]
    ours = tr.eval_full_sequences(seqs, batch=2)
    np.testing.assert_allclose(ours, jr.eval_full_sequences(seqs, batch=2),
                               rtol=RTOL)
    # batching changes nothing but sums' order
    np.testing.assert_allclose(tr.eval_full_sequences(seqs, batch=1), ours,
                               rtol=RTOL)
