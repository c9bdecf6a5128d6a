r"""The metric arithmetic: percentiles and rates over every request and the
whole window, the work counts against hand counts, the trace's union."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, work
from portbench.families import dense, graph
from portbench.trace import Trace


def _m(**kw):
    base = dict(frames=0, window_s=1.0, rtt_ms=None, ticks=None,
                stats0=None, stats1=None, calls=[], trace=None, setup_s=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_pb_a_stall_moves_the_tail_and_the_rate():
    rtt = np.full(1000, 20.0)
    steady = _m(rtt_ms=rtt, frames=1000 * 60, window_s=20.0)
    # the same requests, but 60 of them stalled by 400 ms, the window longer
    stalled = rtt.copy()
    stalled[500:560] += 400.0
    stall = _m(rtt_ms=stalled, frames=1000 * 60, window_s=20.4)
    p95, p50 = harness.reader("rtt_p95_ms"), harness.reader("rtt_p50_ms")
    fps = harness.reader("frames_per_s")
    assert p95.read(steady) == 20.0 and p95.read(stall) == 420.0
    assert p50.read(stall) == 20.0
    assert fps.read(steady) == 3000.0 and fps.read(stall) < 2950.0


def test_pb_percentile_is_over_every_value():
    m = _m(rtt_ms=np.arange(1.0, 101.0))
    assert harness.reader("rtt_p50_ms").read(m) == pytest.approx(50.5)
    assert harness.reader("rtt_p95_ms").read(m) == pytest.approx(95.05)
    assert harness.reader("rtt_p95_ms").read(_m(rtt_ms=np.zeros(0))) is None


def test_pb_serving_counters_and_spans():
    m = _m(stats0={"ticks": 100, "requests": 300},
           stats1={"ticks": 400, "requests": 1500},
           ticks=np.array([[0.0, 0.004, 8], [1.0, 1.006, 2]]),
           rtt_ms=np.array([10.0, 20.0]))
    assert harness.reader("serve.coalesced").read(m) == 4.0
    assert harness.reader("serve.tick_ms").read(m) == pytest.approx(5.0)
    assert harness.reader("serve.outside_tick_ms").read(m) == \
        pytest.approx(10.0)


def test_pb_layer_work_hand_counts():
    # graph-LSTM, S = 1, T = 1, N = 2, F = 2, H = 4, attention, scan alone
    N, F, H = 2, 2, 4
    rec = (2 * N * H * 4 * H          # h W_h
           + 2 * 4 * N * N * H        # the per-gate adjacency mix
           + 2 * N * H * H * 2        # h' W and h' Wh
           + 2 * H * H                # q Wq
           + 2 * N * H)               # s u
    flop, nbytes = work.layer_work(1, 1, F, H, True, False, N)
    assert flop == 2 * rec
    params = 2 * (4 * H * H + 4 * N * N + 4 * H + 3 * H * H + 2 * H + N)
    read = 2 * N * 4 * H + params + 2 * 2 * N * H
    write = N * 2 * H + 2 * 2 * N * H
    assert nbytes == 4 * (read + write) + 4
    # dense LSTM, S = 2, T = 3, F = 5, H = 4, the layer's whole function
    flop, _ = work.lstm_layer_work(2, 3, 5, 4, True)
    assert flop == 2 * 3 * 2 * (2 * 4 * 4 * 4 + 2 * 5 * 4 * 4)


def test_pb_flop_per_frame_hand_counts():
    N, H = 15, 4
    g = {"cell": "a3gc", "num_nodes": N, "stages": [
        {"units_in": 12, "units_out": 3, "units_hidden": H, "rotsize": 3}]}
    per_dir = {F: 2 * N * F * 4 * H + 2 * N * H * 4 * H + 2 * 4 * N * N * H
               + 4 * N * H * H + 2 * H * H + 2 * N * H for F in (H, 2 * H)}
    want = (2 * N * 12 * H + 2 * N * N * H + 2 * (per_dir[H] + per_dir[2 * H])
            + 2 * N * 2 * H * 3 + 2 * N * N * 3)
    assert graph.flop_per_frame(g) == want
    d = {"layers": 2, "stages": [{"n_input": 72, "n_output": 15,
                                  "n_hidden": H, "rotsize": 3}]}
    want = (2 * 72 * H + 2 * (2 * H * 4 * H + 2 * H * 4 * H)
            + 2 * (2 * 2 * H * 4 * H + 2 * H * 4 * H) + 2 * 2 * H * 15)
    assert dense.flop_per_frame(d) == want


def test_pb_roofline_and_mfu():
    cfg = {"cell": "a3gc", "num_nodes": 15, "stages": [
        {"units_in": 12, "units_out": 3, "units_hidden": 8, "rotsize": 3}]}
    calls = [(1, 100), (1, 50)]
    need = sum(work.bound_seconds(f, b) for S, T in calls
               for _, f, b in graph.scan_calls(cfg, S, T))
    trace = Trace(0, 10 ** 9,
                  (np.array([0, 10]), np.array([5, 10 + int(need * 1e9)]),
                   ["void gcn_lstm_kernel<true>(float*)",
                    "void gcn_lstm_kernel<true>(float*)"]),
                  (np.zeros(0, np.int64), np.zeros(0, np.int64), []))
    m = _m(calls=calls, trace=trace, config=cfg, family=graph,
           peak_flops=work.PEAK_TF32_FLOPS, frames=150, window_s=2.0)
    got = harness.reader("gcn_lstm_roofline").read(m)
    took = (5 + int(need * 1e9)) / 1e9
    assert got == pytest.approx(100.0 * need / took)
    assert harness.reader("lstm_roofline").read(m) is None
    assert harness.reader("mfu_pct").read(m) == pytest.approx(
        100 * graph.flop_per_frame(cfg) * 150 / 2.0 / 495e12)


def test_pb_trace_union_counts_overlap_once():
    dev = (np.array([100, 150, 400, 900]), np.array([300, 200, 500, 950]),
           ["a", "b", "lstm_kernel<1>", "gcn_lstm_kernel<1>"])
    host = (np.array([0, 500]), np.array([1000, 900]), ["outer", "inner"])
    t = Trace(0, 1000, dev, host)
    assert t.busy_s == pytest.approx(350e-9)
    assert t.kernel_seconds(r"\blstm_kernel") == pytest.approx(100e-9)
    assert t.kernel_seconds(r"\bgcn_lstm_kernel") == pytest.approx(50e-9)
    gaps = t.idle_gaps()
    assert gaps[0] == ["inner", pytest.approx(400e-9)]
    assert sum(s for _, s in gaps) == pytest.approx(650e-9)
    assert harness.reader("device.idle_pct").read(_m(trace=t)) == \
        pytest.approx(65.0)
