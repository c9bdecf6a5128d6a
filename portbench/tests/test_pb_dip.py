r"""The DIP configuration (``configs/dip.json``) and its cell
``dip.offline_seq`` on the CPU at tiny widths: the plain reference equals
the port's path (``dip_batch``, then ``forward_offline``), a sound run is
correct and a planted fault or the bfloat16 control is not, the work counts
equal a hand count at the published widths, the configuration holds them,
and neither the driver nor the reference pulls in JAX (the reference
nothing of the program). The checks are those the other configurations
have (``test_pb_reference.py``, ``test_pb_faults.py``,
``test_pb_imports.py``), asked of this cell."""

import os

import numpy as np
import pytest
import torch

from portbench import check, harness, traffic, weights
from portbench.families import dip as DF
from portbench.reference.common import no_tf32
from portbench.tests import test_pb_faults as FAULTS
from portbench.tests import test_pb_imports as IMPORTS
from portbench.tests import tiny

CELL = "dip.offline_seq"
TOL = 1e-5      # fp32, the same operations summed in other orders


def _port_pose(c, w, stats, ori, acc):
    r"""The driver's timed path on one sequence, on the CPU."""
    from a3gc_tpu_torch.data import pipeline as DPipe
    from a3gc_tpu_torch.models.pipeline import forward_offline
    from a3gc_tpu_torch.smpl.model import ParametricModel

    cfg, params = c.family.port_cascade(c.config, w)
    imu, _ = DPipe.dip_batch({"ori": ori[None], "acc": acc[None],
                              "pose": None}, stats, no_root=True)
    return forward_offline(params, cfg, ParametricModel(device="cpu"), imu)


def test_pb_dip_reference_equals_port_offline():
    r"""Three sequences of 120, 75 and 31 frames, each through the port
    alone at its own length, against the reference on all three end-padded
    in one call (the padding masked by ``n_valid``)."""
    c = tiny.cell(CELL)
    seed = 11
    w = weights.draw(c.family.param_spec(c.config), seed, "cpu")
    stats_np = c.stats()
    stats = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in stats_np.items()}
    ori, acc = (torch.as_tensor(x) for x in traffic.imu_pool(
        seed, {"sequences": 3, "frames": 200}, stats_np))
    n_valid = [120, 75, 31]
    with no_tf32():
        ref, _ = c.reference.cascade(c.config, w, ori[:, :120],
                                     acc[:, :120], stats,
                                     torch.tensor(n_valid))
    for i, n in enumerate(n_valid):
        port = _port_pose(c, w, stats, ori[i, :n], acc[i, :n])
        assert (port.reshape(n, 24, 3, 3) - ref[i, :n]).abs().max() < TOL
    assert ref[:, :, 1].abs().max() > 0.01      # not a trivial output


def test_pb_dip_sound_run_is_correct():
    FAULTS.test_pb_sound_run_is_correct(CELL)


def _answer_altered(monkeypatch):
    from portbench.drivers import offline_dip

    infer = offline_dip.Run._infer

    def altered(self, ori, acc):
        pose = infer(self, ori, acc)
        pose[len(pose) // 2, 1, 0, 0] += 0.5
        return pose

    monkeypatch.setattr(offline_dip.Run, "_infer", altered)


def _root_sensor_kept_in_the_stats(monkeypatch):
    r"""The prep normalizes with the stats of the first 60 channels, not
    of the 60 kept: the five sensors' channels shifted by the root's."""
    from a3gc_tpu_torch.data import pipeline as DPipe

    prep = DPipe.dip_batch

    def shifted(raw, stats, no_root=True, rotsize=9):
        moved = {k: torch.roll(v, 9 if k.startswith("ori") else 3)
                 if k.endswith("_channel") and v.dim() == 1 else v
                 for k, v in stats.items()}
        return prep(raw, moved, no_root, rotsize)

    monkeypatch.setattr(DPipe, "dip_batch", shifted)


@pytest.mark.parametrize("fault", [FAULTS._state_unchanged_in_the_scans,
                                   _answer_altered,
                                   _root_sensor_kept_in_the_stats])
def test_pb_dip_fault_is_not_correct(fault, monkeypatch):
    FAULTS.test_pb_fault_is_not_correct(CELL, fault, monkeypatch)


def test_pb_dip_control_fails_the_limits():
    r"""The reference in bfloat16 in the program's place, at hidden width
    64 on three seeds, 2 sequences of 240 frames: each fails one of the
    cell's limits at least."""
    c = tiny.cell(CELL, hidden=64)
    stats_np = c.stats()
    stats = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in stats_np.items()}
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        w = weights.draw(c.family.param_spec(c.config), seed, "cpu")
        ori, acc = (torch.as_tensor(x) for x in traffic.imu_pool(
            seed, {"sequences": 2, "frames": 240}, stats_np))
        n = torch.tensor([240, 240])
        with no_tf32():
            ref = c.reference.cascade(c.config, w, ori, acc, stats, n)[0]
            low = c.reference.cascade(c.config, w, ori, acc, stats, n,
                                      fmt="bf16")[0]
        values = check.numbers(list(low.numpy()), list(ref.numpy()))
        assert not check.passes(values, c.limits), values


def test_pb_dip_work_equals_a_hand_count():
    cfg = harness._json(os.path.join(harness.HERE, "configs", "dip.json"))
    H = 512
    scan = 2 * 8 * H * H                    # h·W_hh, both directions
    calls = DF.scan_calls(cfg, 1, 7)
    assert [k for k, _, _ in calls] == ["lstm", "lstm"]
    assert [f for _, f, _ in calls] == [7 * scan, 7 * scan]
    # the scan reads u [2, T, 4H], W_hh, h0 and c0 and writes y [T, 2H],
    # h and c, all fp32, and n_valid
    assert calls[0][2] == 4 * (2 * 7 * 4 * H + 2 * 4 * H * H + 2 * 2 * H
                               + 7 * 2 * H + 2 * 2 * H) + 4
    assert DF.flop_per_frame(cfg) == (
        2 * 60 * H                          # linear1
        + 2 * 2 * H * 4 * H + scan          # layer 1: x·W_ih, F = H
        + 2 * 2 * 2 * H * 4 * H + scan      # layer 2: F = 2H
        + 2 * 2 * H * 135)                  # linear2
    assert DF.flop_per_frame(cfg) == 21_309_440     # ≈ 21.3 MFLOP


def test_pb_dip_config_holds_published_widths():
    cfg = harness._json(os.path.join(harness.HERE, "configs", "dip.json"))
    assert cfg["stages"] == [{"n_input": 60, "n_output": 135,
                              "n_hidden": 512, "rotsize": 9}]
    assert cfg["layers"] == 2
    assert (cfg["family"], cfg["reference"]) == ("dip", "dip")
    assert cfg["precision"] == "default" and cfg["normalize"]
    assert cfg["kernel"] == "ops/csrc/lstm.cu"
    entry = {c["name"]: c for c in tiny.bench()["configs"]}["dip"]
    assert entry["file"] == "portbench/configs/dip.json"
    assert entry["reduced"] == []
    port_cfg, params = DF.port_cascade(cfg, weights.draw(
        DF.param_spec(cfg), 1, "cpu"))
    net = port_cfg.net
    assert (net.n_input, net.n_output, net.n_hidden, net.n_layers,
            net.bidirectional, net.precision, port_cfg.rotsize) == (
        60, 135, 512, 2, True, "default", 9)
    assert tuple(params.lstm[1].w_ih.shape) == (2, 1024, 2048)


RUN_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
from portbench import harness
import portbench.families.dip, portbench.reference.dip
import portbench.drivers.offline_dip
for name in ("lstm_roofline.dip", "mfu_pct.dip", "device.idle_pct.dip",
             "idle.prep_pct.dip", "idle.round_pct.dip", "idle.rnn_pct.dip",
             "idle.cascade_pct.dip", "idle.ik_pct.dip",
             "idle.outside_pct.dip", "launches_per_seq.dip",
             "round.launches_per_seq.dip"):
    harness.reader(name)
import a3gc_tpu_torch.ops.lstm
from a3gc_tpu_torch.models.pipeline import forward_offline
from a3gc_tpu_torch.data.pipeline import dip_batch
print(",".join(harness.forbidden_modules()))
"""

REFERENCE_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference.dip
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"a3gc_tpu_torch", "a3gc_tpu", "jax", "flax"}})))
"""


@pytest.mark.parametrize("code", [RUN_IMPORTS, REFERENCE_IMPORTS],
                         ids=["run", "reference"])
def test_pb_dip_imports_no_jax(code):
    assert IMPORTS._run(code) == ""


def test_pb_dip_traced_run_reports_its_per_layer_metrics():
    r"""A traced run on the CPU: the readers of the host's clock and of the
    device's idle share report (no kernel: no roofline; no device
    activity: no span shares), and the result has its breakdown."""
    _, result = tiny.measure(tiny.cell(CELL), trace=True)
    assert result["correct"]
    assert {"mfu_pct.dip", "device.idle_pct.dip"} == set(result["metrics"])
    assert list(result)[-2:] == ["breakdown", "compared"]
    assert np.isfinite(result["metrics"]["mfu_pct.dip"]["value"])
