r"""The readers of the program's layer spans (``span_math``): the device's
idle time sorted into six parts by the innermost ``a3gc.*`` span, and the
host's launches inside the spans, on a trace built by hand; the spans of a
traced run of the program on the CPU; every new entry of
``BENCHMARK.json`` has its reader and a ``moves`` its cell reports."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, span_math
from portbench.tests import tiny
from portbench.trace import Trace

IDLE = [f"idle.{p}_pct" for p in span_math.PARTS]
LAUNCHES = ["launches_per_seq", "round.launches_per_seq"]
NEW = [n + sfx for n in IDLE + LAUNCHES for sfx in ("", ".transpose")]

# window 0-1000 ns; the device busy 250 ns of it
DEVICE = (np.array([100, 400, 700]), np.array([200, 450, 800]),
          ["k1", "k2", "k3"])
HOST = [("a3gc.prep", 20, 90),
        ("a3gc.cascade", 120, 900),
        ("a3gc.stage1", 130, 600),
        ("a3gc.rnn", 210, 500),
        ("a3gc.round", 250, 300),
        ("aten::mm", 300, 350),             # not a layer span
        ("a3gc.round", 520, 560),
        ("a3gc.ik", 620, 680),
        ("cuLaunchKernelEx", 140, 145),     # in a3gc.stage1
        ("cudaMemcpyAsync", 150, 160),      # not a launch
        ("cudaLaunchKernel", 260, 262),     # in a3gc.round
        ("cudaLaunchKernel", 330, 332),     # in a3gc.rnn
        ("cudaLaunchKernel", 530, 532),     # in a3gc.round
        ("cudaLaunchKernelExC", 650, 652),  # in a3gc.ik
        ("cudaLaunchKernel", 950, 952)]     # outside every span
# idle ns of each part, by hand from the gaps 0-100, 200-400, 450-700 and
# 800-1000: prep 20-90; round 250-300, 520-560; rnn 210-250, 300-400,
# 450-500; ik 620-680; cascade 200-210, 500-520, 560-620, 680-700,
# 800-900; outside 0-20, 90-100, 900-1000
WANT = {"prep": 7.0, "round": 9.0, "rnn": 19.0, "ik": 6.0, "cascade": 21.0,
        "outside": 13.0}


def _trace(host=HOST, device=DEVICE, start=0, stop=1000):
    names = [n for n, _, _ in host]
    return Trace(start, stop, device,
                 (np.array([s for _, s, _ in host], np.int64),
                  np.array([e for _, _, e in host], np.int64), names))


def _m(trace, calls=((1, 30), (1, 40))):
    return SimpleNamespace(trace=trace, calls=list(calls))


@pytest.mark.parametrize("part", span_math.PARTS)
def test_pb_idle_part_by_hand(part):
    m = _m(_trace())
    for sfx in ("", ".transpose"):
        got = harness.reader(f"idle.{part}_pct{sfx}").read(m)
        assert got == pytest.approx(WANT[part], abs=1e-12)


def test_pb_idle_parts_sum_to_idle_pct():
    m = _m(_trace())
    parts = [harness.reader(n).read(m) for n in IDLE]
    assert sum(parts) == pytest.approx(
        harness.reader("device.idle_pct").read(m), abs=1e-9)
    assert sum(parts) == pytest.approx(75.0)


def test_pb_span_cut_by_the_window_counts_inside_it():
    # the window 150-1000: a3gc.prep and the first device interval's start
    # fall before it
    m = _m(_trace(start=150))
    assert harness.reader("idle.prep_pct").read(m) == 0.0
    got = {p: harness.reader(f"idle.{p}_pct").read(m)
           for p in span_math.PARTS}
    assert got["cascade"] == pytest.approx(100 * 210 / 850)
    assert sum(got.values()) == pytest.approx(
        harness.reader("device.idle_pct").read(m))


def test_pb_launch_counts_by_hand():
    m = _m(_trace())
    for sfx in ("", ".transpose"):
        # 5 launches inside layer spans (the one outside every span and
        # the copy do not count), over 2 sequences
        assert harness.reader("launches_per_seq" + sfx).read(m) == 2.5
        assert harness.reader("round.launches_per_seq" + sfx).read(m) == 1.0


@pytest.mark.parametrize("name", NEW)
def test_pb_span_readers_none_without_anything_to_read(name):
    r = harness.reader(name)
    assert r.read(_m(None)) is None                        # untraced
    assert r.read(_m(_trace(), calls=())) is None          # no calls
    no_spans = [h for h in HOST if not h[0].startswith("a3gc.")]
    assert r.read(_m(_trace(host=no_spans))) is None       # the parent
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), [])
    assert r.read(_m(_trace(device=empty))) is None        # no card


def test_pb_program_spans_reach_the_readers():
    r"""A traced CPU run of the program: its spans, under a device interval
    put in by hand (the CPU has none), are read into every part that the
    CPU runs (fp32 there: no rounding, and no launch)."""
    m, result = tiny.measure(tiny.cell("transpose.offline_seq"), trace=True)
    assert result["correct"]
    t = m.trace
    assert not set(NEW) & set(result["metrics"])           # no card
    dev = (np.array([t.start_ns]), np.array([t.start_ns + 1000]), ["k"])
    m2 = _m(Trace(t.start_ns, t.stop_ns, dev,
                  (t.host_start, t.host_end, t.host_name)), m.calls)
    got = {p: harness.reader(f"idle.{p}_pct.transpose").read(m2)
           for p in span_math.PARTS}
    assert all(got[p] > 0 for p in ("prep", "rnn", "ik", "cascade",
                                     "outside")), got
    assert got["round"] == 0.0
    assert sum(got.values()) == pytest.approx(
        harness.reader("device.idle_pct.transpose").read(m2))
    assert harness.reader("launches_per_seq.transpose").read(m2) == 0.0


def test_pb_new_entries_have_readers_and_report_what_they_move():
    bench = tiny.bench()
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert set(NEW) <= set(entries)
    for name in NEW:
        e = entries[name]
        assert callable(harness.reader(name).read)
        assert e["source"] == "device_trace" and e["better"] == "lower"
        assert e["moves"] == ("frames_per_s.transpose"
                              if name.endswith(".transpose")
                              else "frames_per_s")
        for w in e["workloads"]:
            cell = harness.Cell(bench, w)
            assert e["moves"] in {m["name"] for m in cell.end_to_end}
            assert name in {m["name"] for m in cell.per_layer}
