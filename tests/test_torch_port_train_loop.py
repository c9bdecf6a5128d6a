"""The port's training loop on its own (``a3gc_tpu_torch.train``), on the
CPU at hidden 8-16: what the JAX package's ``tests/test_training.py``
holds of its loop, where the port cannot match the JAX draws bit for bit
(dropout and noise on) or needs no JAX oracle — gradient accumulation on a
padded tail, remat, bf16, seeds, the device-resident corpus, early
stopping, checkpoint retention, preemption; and that training learns."""

import dataclasses
import glob
import os
import signal

import numpy as np
import pytest
import torch

from a3gc_tpu_torch.config import TrainConfig
from a3gc_tpu_torch.data import load_adjacency_template, load_stats
from a3gc_tpu_torch.data import pipeline as DP
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
from a3gc_tpu_torch.train import (DIPRunner, GracefulInterrupt, StageRunner,
                                  make_optimizer, run_cascade_training,
                                  seeded_generator)
from a3gc_tpu_torch.utils import discover_latest, restore_params, save_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def packed():
    return synthetic_packed_dataset(n_seqs=8, seq_len=16, seed=0)


def make_stage(stage, cell="a3gc", hidden=8, dropout=0.0, **net_kw):
    units_in = {1: 12, 2: 15, 3: 15}[stage]
    units_out = {1: 3, 2: 3, 3: 9}[stage]
    net = N.GraphNetConfig(cell=cell, units_in=units_in, units_out=units_out,
                           units_hidden=hidden, linear_dropout=dropout,
                           dropout=dropout, recurrent_dropout=dropout,
                           **net_kw)
    cfg = PoseNetConfig(net=net, rotsize={1: 3, 2: 3, 3: 9}[stage])
    params = init_pose_net(torch.Generator().manual_seed(stage), cfg,
                           load_adjacency_template())
    return cfg, params


def runner(stage=1, tc=None, **kw):
    cfg, params = make_stage(stage, **kw)
    return StageRunner(stage, cfg, params, tc or TrainConfig(batch_size=4),
                       steps_per_epoch=2, device="cpu")


def _padded(packed):
    raw = {k: torch.as_tensor(v[[0, 1, 2, 0]]) for k, v in packed.items()}
    raw["_weight"] = torch.tensor([1.0, 1.0, 1.0, 0.0])
    return raw


def _params(r):
    return {n: t.detach().clone() for n, t in
            r.state.params.named_parameters()}


def _assert_params_close(a, b, atol):
    for n in a:
        np.testing.assert_allclose(a[n].numpy(), b[n].numpy(), atol=atol,
                                   err_msg=n)


def test_torch_port_padded_accum_equals_monolithic(packed):
    """The pads land in the second microbatch: the weighted combine still
    gives the monolithic weighted gradient, and a padded step equals the
    step on the native-size batch."""
    no_noise = dict(leaf_noise_std=0.0, full_noise_std=0.0)
    runs = [runner(tc=TrainConfig(batch_size=b, accum_steps=k, **no_noise))
            for b, k in ((4, 1), (4, 2), (3, 1))]
    raws = [_padded(packed), _padded(packed),
            {k: torch.as_tensor(v[:3]) for k, v in packed.items()}]
    losses = [float(r.train_step(raw, seeded_generator("cpu", 0)))
              for r, raw in zip(runs, raws)]
    np.testing.assert_allclose(losses[1:], [losses[0]] * 2, rtol=1e-6)
    for r in runs[1:]:
        _assert_params_close(_params(r), _params(runs[0]), atol=2e-6)


def test_torch_port_accum_must_divide_batch():
    with pytest.raises(ValueError, match="divide"):
        runner(tc=TrainConfig(batch_size=6, accum_steps=4))


def test_torch_port_remat_gives_the_same_step(packed):
    """Dropout on: the masks are drawn before the loop, so the recomputed
    steps of remat apply the same masks as the stored ones."""
    steps = []
    for remat in (False, True):
        r = runner(2, dropout=0.3, remat=remat)
        loss = r.train_epoch(DP.Sampler(packed, 4, seed=0), seed=(0, 5))
        steps.append((loss, _params(r)))
    assert steps[0][0] == steps[1][0]
    _assert_params_close(steps[0][1], steps[1][1], atol=1e-7)


def test_torch_port_same_seed_same_run(packed):
    """Seeded dropout and noise: the same seeds give bit-equal runs, other
    seeds another run."""
    def run(seed):
        r = runner(3, dropout=0.3)
        loss = r.train_epoch(DP.Sampler(packed, 4, seed=seed), seed=seed)
        return loss, _params(r)
    (l1, p1), (l2, p2), (l3, _) = run((0, 1)), run((0, 1)), run((0, 2))
    assert l1 == l2 and l1 != l3
    assert all(torch.equal(p1[n], p2[n]) for n in p1)


@pytest.mark.parametrize("dip", [False, True])
def test_torch_port_bf16_step_is_close_to_fp32(packed, dip):
    """bf16 compute on fp32 master params: the loss within 2 % of the fp32
    loss, the update finite, the masters fp32."""
    losses, updated = [], []
    for dtype in ("float32", "bfloat16"):
        tc = TrainConfig(batch_size=4, dtype=dtype, leaf_noise_std=0.0,
                         full_noise_std=0.0)
        if dip:
            cfg = PoseNetConfig(net=N.DIPConfig(n_hidden=8, dropout=0.0))
            params = init_pose_net(torch.Generator().manual_seed(0), cfg)
            r = DIPRunner(cfg, params, tc, 2, load_stats(), device="cpu")
        else:
            r = runner(3, tc=tc)
        before = _params(r)
        losses.append(float(r.train_step(
            {k: torch.as_tensor(v[:4]) for k, v in packed.items()},
            seeded_generator("cpu", 0))))
        after = _params(r)
        assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
                   for t in after.values())
        updated.append(any(not torch.equal(before[n], after[n])
                           for n in after))
    assert all(updated) and np.isfinite(losses).all()
    assert abs(losses[1] - losses[0]) <= 0.02 * abs(losses[0])
    assert losses[1] != losses[0]       # the cast is applied


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_torch_port_training_lowers_the_loss(stage, packed):
    """Dropout and noise on (the defaults): three epochs lower the
    validation loss."""
    r = runner(stage, tc=TrainConfig(batch_size=4, lr=2e-3), hidden=16,
               dropout=0.3)

    def sampler():
        return DP.Sampler(packed, 4, seed=0)
    first = r.eval_epoch(sampler())
    for e in range(3):
        r.train_epoch(sampler(), seed=(0, e))
    last = r.eval_epoch(sampler())
    assert np.isfinite(first) and np.isfinite(last) and last < first


def test_torch_port_adjacency_frozen_only_for_agc(packed):
    for cell, frozen in (("agc", True), ("a3gc", False)):
        r = runner(3, cell=cell)
        adj = r.state.params.rnn1.adj.detach().clone()
        kernel = r.state.params.rnn1.kernel.detach().clone()
        r.train_epoch(DP.Sampler(packed, 4, seed=0))
        p = r.state.params
        assert torch.equal(p.rnn1.adj, adj) == frozen, cell
        assert not torch.equal(p.rnn1.kernel, kernel)


def test_torch_port_lr_schedule_is_a_staircase():
    """lr · decay^((update + start_epoch·steps) // steps), stepped per
    update."""
    p = torch.nn.Linear(2, 2)
    opt, sched = make_optimizer(TrainConfig(lr=1.0, lr_decay=0.5,
                                            start_epoch=1), 2, p)
    lrs = []
    for _ in range(5):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert lrs == [0.5, 0.5, 0.25, 0.25, 0.125]


def test_torch_port_device_corpus_equals_host_feed(packed):
    """One step function, two feeds: gathering from a put_device corpus
    gives the host-fed epoch (and chunked validation) exactly."""
    results = []
    for device_data in (None, DP.put_device(packed, "cpu")):
        r = runner(2, dropout=0.3,
                   tc=TrainConfig(batch_size=4, eval_batch_size=3))
        sampler = DP.Sampler(packed, 4, seed=3, pad_remainder=True,
                             device_data=device_data)
        loss = r.train_epoch(sampler, seed=1)
        valid = r.eval_epoch(DP.Sampler(packed, 4, shuffle=False,
                                        device_data=device_data))
        results.append((loss, valid, _params(r)))
    assert results[0][:2] == results[1][:2]
    assert all(torch.equal(results[0][2][n], results[1][2][n])
               for n in results[0][2])


def test_torch_port_eval_epoch_weights_chunks_and_tails(packed):
    r = runner(tc=TrainConfig(batch_size=4, eval_batch_size=3))
    mono = runner(tc=TrainConfig(batch_size=5, eval_batch_size=5))
    five = {k: v[:5] for k, v in packed.items()}
    padded = r.eval_epoch(DP.Sampler(five, 4, shuffle=False,
                                     pad_remainder=True))
    exact = mono.eval_epoch(DP.Sampler(five, 5, shuffle=False))
    np.testing.assert_allclose(padded, exact, rtol=1e-6)
    assert runner(tc=TrainConfig(batch_size=256))._eval_b == 128


def _drive(runners, packed, tc, **kw):
    return run_cascade_training(
        runners, lambda salt: DP.Sampler(packed, 4, seed=(0, salt)),
        lambda: DP.Sampler(packed, 4, shuffle=False), tc, **kw)


def test_torch_port_early_stopping_and_checkpoints(packed, tmp_path):
    tc = TrainConfig(batch_size=4, max_epochs=4, patience=1)
    runners = {s: runner(s, tc=tc) for s in (1, 2, 3)}
    events, saved, salts = [], [], []

    def sampler(salt):
        salts.append(salt)
        return DP.Sampler(packed, 4, seed=(0, salt))
    run_cascade_training(
        runners, sampler, lambda: DP.Sampler(packed, 4, shuffle=False), tc,
        save_fn=lambda st, ep, p: saved.append(
            save_params(p, str(tmp_path), st, ep)),
        log_fn=events.append)
    assert {e["stage"] for e in events} == {1, 2, 3} and saved
    assert salts[:2] == [10000, 10001]       # a fresh order per epoch
    for stage in (1, 2, 3):
        path, epoch = discover_latest(str(tmp_path), stage)
        restored = restore_params(path, make_stage(stage)[1])
        if epoch == max(e["epoch"] for e in events if e["stage"] == stage):
            for n, t in restored.named_parameters():
                assert torch.equal(t, dict(
                    runners[stage].state.params.named_parameters())[n])


@pytest.mark.parametrize("keep, min_delta, losses, want", [
    (2, 0.0, [5.0, 4.0, 3.0, 2.0, 1.0], ["3", "4"]),
    (0, 0.5, [5.0, 4.9, 4.85, 3.0, 2.95], ["0", "3"]),
])
def test_torch_port_checkpoint_retention(packed, tmp_path, keep, min_delta,
                                         losses, want):
    tc = TrainConfig(batch_size=4, max_epochs=5, patience=0,
                     keep_checkpoints=keep, min_save_delta=min_delta)
    save_params(make_stage(1)[1], str(tmp_path), 1, 9)   # an earlier run's
    events = []
    it = iter(losses)
    _drive({1: runner(tc=tc)}, packed, tc,
           save_fn=lambda st, ep, p: save_params(p, str(tmp_path), st, ep),
           log_fn=events.append, valid_fn=lambda r: next(it))
    assert len(events) == 5                 # no early stop: all improve
    kept = sorted(glob.glob(str(tmp_path / "checkpoint_model1_*")))
    assert [p.rsplit("_", 1)[1] for p in kept] == sorted(want + ["9"])


def test_torch_port_interrupt_at_a_step_boundary(packed):
    tc = TrainConfig(batch_size=4, max_epochs=10, patience=100)
    r = runner(tc=tc)
    events, saves = [], []
    calls = {"n": 0}

    def interrupt():
        # epoch 0: 2 per-step checks + 1 boundary check stay False; the
        # 4th call (epoch 1, first step) flips True
        calls["n"] += 1
        return calls["n"] >= 4

    _drive({1: r}, packed, tc, save_fn=lambda st, ep, p: saves.append(
        (st, ep)), log_fn=events.append, interrupt=interrupt)
    assert events[-1].get("event") == "interrupted"
    assert events[-1]["epoch"] == 1 and r.state.step == 2
    assert saves == [(1, 0), (1, 1)]
    r2 = runner(tc=tc)
    events = []
    _drive({1: r2}, packed, tc, log_fn=events.append,
           interrupt=lambda: True)
    assert r2.state.step == 0
    assert [e.get("event") for e in events] == ["interrupted"]


def test_torch_port_graceful_interrupt_signals():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulInterrupt() as gi:
        assert not gi()
        os.kill(os.getpid(), signal.SIGTERM)
        assert gi()                          # first signal: cooperative
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)     # second: escape
    assert signal.getsignal(signal.SIGTERM) == before


def test_torch_port_training_scan_matches_inference_without_dropout():
    """With an rng but dropout 0, the training path (unhoisted steps in
    ``bi_rnn``, remat) computes the inference path's function."""
    cfg, params = make_stage(3)
    for cell in ("a3gc", "ggru"):
        cfg = dataclasses.replace(cfg, net=dataclasses.replace(cfg.net,
                                                               cell=cell))
        params = init_pose_net(torch.Generator().manual_seed(1), cfg,
                               load_adjacency_template())
        x = torch.randn(2, 7, 15, 15)
        mask = np.arange(7)[None] < np.array([[7], [4]])
        with torch.no_grad():
            ref, ref_st = N.graph_net_apply(params, cfg.net, x,
                                            frame_mask=mask, device="cpu")
            got, st = N.graph_net_apply(params, cfg.net, x, frame_mask=mask,
                                        device="cpu",
                                        rng=torch.Generator())
        for b, n in enumerate((7, 4)):
            np.testing.assert_allclose(got[b, :n].numpy(),
                                       ref[b, :n].numpy(), atol=1e-5)
        for a, b in zip(st if cell != "ggru" else (st,),
                        ref_st if cell != "ggru" else (ref_st,)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
