r"""The comparison that decides ``correct`` fails what it must: runs driven
end to end on the CPU at tiny sizes (the look for a card skipped), once
sound and once with each fault that the cell can have planted in the timed
path underneath; and the control, the reference one precision below the
configuration's in the program's place, fails the cell's limits."""

import numpy as np
import pytest
import torch

from portbench import check, traffic, weights
from portbench.reference.common import no_tf32
from portbench.tests import tiny

OFFLINE = ("a3gc_tp.offline_seq", "transpose.offline_seq")
SERVING = ("transpose.serve_http8", "a3gc_tp.serve_http8")


def _state_unchanged_in_the_scans(monkeypatch):
    r"""Every recurrent step returns the state it was given."""
    from a3gc_tpu_torch.models import layers as L

    def frozen(step_fn, params, seq, init_state, mask_tm=None, extras=()):
        state = tuple(init_state)
        outs = [step_fn(params, seq[:, t], state)[0]
                for t in range(seq.shape[1])]
        return torch.stack(outs, dim=1), tuple(s.clone() for s in state)

    monkeypatch.setattr(L, "_scan_rnn", frozen)


def _answer_altered_offline(monkeypatch):
    from portbench.drivers import offline_seq

    infer = offline_seq.Run._infer

    def altered(self, ori, acc):
        pose = infer(self, ori, acc)
        pose[len(pose) // 2, 1, 0, 0] += 0.5
        return pose

    monkeypatch.setattr(offline_seq.Run, "_infer", altered)


def _state_unchanged_across_windows(monkeypatch):
    from a3gc_tpu_torch.eval.streaming import StreamingCascade

    run = StreamingCascade._run

    def frozen(self, ori, acc, states, *masks):
        return run(self, ori, acc, states, *masks)[0], states

    monkeypatch.setattr(StreamingCascade, "_run", frozen)


def _half_the_batch_left_out(monkeypatch):
    from a3gc_tpu_torch.eval.streaming import StreamingCascade

    step = StreamingCascade.step

    def half(self, ori, acc, active=None):
        act = (np.ones(self.streams, np.float32) if active is None
               else np.asarray(active, np.float32).copy())
        act[self.streams // 2:] = 0.0
        return step(self, ori, acc, act)

    monkeypatch.setattr(StreamingCascade, "step", half)


def _answer_altered_serving(monkeypatch):
    from a3gc_tpu_torch.eval.streaming import StreamingCascade

    step = StreamingCascade.step

    def altered(self, ori, acc, active=None):
        pose = step(self, ori, acc, active)
        pose[:, 1, 1, 0, 0] += 0.5
        return pose

    monkeypatch.setattr(StreamingCascade, "step", altered)


@pytest.mark.parametrize("name", OFFLINE + SERVING)
def test_pb_sound_run_is_correct(name):
    m, result = tiny.measure(tiny.cell(name))
    assert result["correct"], result["compared"]
    assert m.failed == 0 and result["attempted"] > 0
    assert list(result)[-1] == "compared"


def test_pb_traced_serving_run_feeds_the_serving_readers():
    from portbench import harness
    m, result = tiny.measure(tiny.cell("transpose.serve_http8"), trace=True)
    assert result["correct"] and m.trace is not None
    for name in ("served_frames_per_s", "rtt_p50_ms", "rtt_p95_ms",
                 "serve.coalesced", "serve.tick_ms", "serve.outside_tick_ms",
                 "mfu_pct.serve", "device.idle_pct.serve"):
        assert harness.reader(name).read(m) > 0, name
    assert harness.reader("lstm_roofline.serve").read(m) is None  # no card


def test_pb_traced_offline_run_reports_its_per_layer_metrics():
    _, result = tiny.measure(tiny.cell("transpose.offline_seq"), trace=True)
    assert result["correct"]
    assert {"mfu_pct.transpose", "device.idle_pct.transpose"} == set(
        result["metrics"])      # no kernel on the CPU: no roofline
    assert "busy_s" in result["device"] and "breakdown" in result
    assert list(result)[-2:] == ["breakdown", "compared"]


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in OFFLINE
    for f in (_state_unchanged_in_the_scans, _answer_altered_offline)] + [
    (n, f) for n in SERVING
    for f in (_state_unchanged_across_windows, _half_the_batch_left_out,
              _answer_altered_serving)])
def test_pb_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    _, result = tiny.measure(tiny.cell(name))
    assert not result["correct"], result["compared"]


def _cascade(c, w, ori, acc, stats, fmt):
    r"""The reference over whole sequences (offline cells) or window by
    window with the states carried (serving cells, 60-frame windows)."""
    n = torch.tensor([ori.shape[1]] * ori.shape[0])
    if c.traffic["driver"] == "offline_seq":
        return c.reference.cascade(c.config, w, ori, acc, stats, n,
                                   fmt=fmt)[0]
    out, states, W = [], None, 60
    for k in range(ori.shape[1] // W):
        pose, states = c.reference.cascade(
            c.config, w, ori[:, k * W:(k + 1) * W],
            acc[:, k * W:(k + 1) * W], stats, torch.full_like(n, W),
            states, fmt=fmt)
        out.append(pose)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("name", OFFLINE + SERVING)
def test_pb_control_fails_the_limits(name):
    r"""The reference in bfloat16 in the program's place, at hidden width
    64 on three seeds, 2 sequences of 240 frames: each fails one of the
    cell's limits at least."""
    c = tiny.cell(name, hidden=64)
    stats_np = c.stats()
    stats = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in stats_np.items()}
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        w = weights.draw(c.family.param_spec(c.config), seed, "cpu")
        ori, acc = (torch.as_tensor(x) for x in traffic.imu_pool(
            seed, {"sequences": 2, "frames": 240}, stats_np))
        with no_tf32():
            ref = _cascade(c, w, ori, acc, stats, "fp32")
            low = _cascade(c, w, ori, acc, stats, "bf16")
        values = check.numbers(list(low.numpy()), list(ref.numpy()))
        assert not check.passes(values, c.limits), values
