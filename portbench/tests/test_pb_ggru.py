r"""The G-GRU configuration (``configs/ggru_tp.json``) and its cell
``ggru_tp.offline_seq`` on the CPU at tiny widths: the plain reference
equals the port's eager path, a sound run is correct and a planted fault
or the bfloat16 control is not, the work counts equal a hand count, the
configuration holds the published widths, and neither the family nor the
reference pulls in JAX (the reference nothing of the program). The checks
are those the other configurations have (``test_pb_reference.py``,
``test_pb_faults.py``, ``test_pb_imports.py``), asked of this cell."""

import os

import pytest

from portbench import harness
from portbench.families import ggru as GF
from portbench.tests import test_pb_faults as FAULTS
from portbench.tests import test_pb_imports as IMPORTS
from portbench.tests import test_pb_reference as REF

CELL = "ggru_tp.offline_seq"


def test_pb_ggru_reference_equals_port_offline():
    REF.test_pb_reference_equals_port_offline(CELL)


def test_pb_ggru_reference_equals_port_streaming_with_reset():
    REF.test_pb_reference_equals_port_streaming_with_reset(CELL)


def test_pb_ggru_sound_run_is_correct():
    FAULTS.test_pb_sound_run_is_correct(CELL)


@pytest.mark.parametrize("fault", [FAULTS._state_unchanged_in_the_scans,
                                   FAULTS._answer_altered_offline])
def test_pb_ggru_fault_is_not_correct(fault, monkeypatch):
    FAULTS.test_pb_fault_is_not_correct(CELL, fault, monkeypatch)


def test_pb_ggru_control_fails_the_limits():
    FAULTS.test_pb_control_fails_the_limits(CELL)


def test_pb_ggru_work_equals_a_hand_count():
    # one stream, one frame, F = 4, H = 8, 15 nodes, the cell's order
    N, F, H = 15, 4, 8
    scan = 2 * (2 * N * H * H          # h·G
                + 2 * N * N * H        # adj·(h·G)
                + 2 * N * H * 3 * H)   # msg·W_hid
    assert GF.ggru_layer_work(1, 1, F, H, False, True) == (
        scan,
        4 * (2 * N * 3 * H                              # zi, read
             + 2 * (H * H + N * N + H * 3 * H)          # G, adj, W_hid
             + 2 * N * H                                # h0
             + N * 2 * H + 2 * N * H)                   # y, h
        + 4)                                            # n_valid
    assert GF.ggru_layer_work(1, 1, F, H, True, True)[0] == \
        scan + 2 * 2 * N * F * 3 * H                    # x·W_in
    # the fold adj·(h·G)·W_hid = (adj·h)·(G·W_hid) at fp32: 6·N·H²
    assert GF.ggru_layer_work(1, 1, F, H, False, False)[0] == \
        2 * (2 * N * N * H + 2 * N * H * 3 * H) + 2 * 2 * H * H * 3 * H
    cfg = {"num_nodes": N, "precision": "default", "stages": [
        {"units_in": 12, "units_out": 3, "units_hidden": H},
        {"units_in": 15, "units_out": 9, "units_hidden": H}]}
    per_stage = []
    for ui, uo in ((12, 3), (15, 9)):
        per_stage.append(
            2 * N * ui * H + 2 * N * N * H                  # linear_in
            + 2 * 2 * N * H * 3 * H + scan                  # rnn1, F = H
            + 2 * 2 * N * 2 * H * 3 * H + scan              # rnn2, F = 2H
            + 2 * N * 2 * H * uo + 2 * N * N * uo)          # linear_out
    assert GF.flop_per_frame(cfg) == sum(per_stage)
    assert [c[0] for c in GF.scan_calls(cfg, 1, 7)] == ["ggru"] * 4
    assert GF.scan_calls(cfg, 1, 7)[0][1] == 7 * scan


def test_pb_ggru_config_holds_published_widths():
    cfg = harness._json(os.path.join(harness.HERE, "configs",
                                     "ggru_tp.json"))
    assert [s["units_hidden"] for s in cfg["stages"]] == [256, 64, 128]
    assert [(s["units_in"], s["units_out"]) for s in cfg["stages"]] == [
        (12, 3), (15, 3), (15, 9)]
    assert cfg["cell"] == "ggru" and cfg["stages"][2]["rotsize"] == 9
    assert (cfg["family"], cfg["reference"]) == ("ggru", "ggru")
    assert cfg["precision"] == "default" and cfg["normalize"]
    assert cfg["num_nodes"] == 15


RUN_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
from portbench import harness
import portbench.families.ggru, portbench.reference.ggru
for name in ("ggru_roofline", "mfu_pct.ggru", "device.idle_pct.ggru",
             "idle.rnn_pct.ggru", "idle.round_pct.ggru",
             "launches_per_seq.ggru"):
    harness.reader(name)
import a3gc_tpu_torch.ops.ggru
from a3gc_tpu_torch.models.pipeline import cascade_apply
print(",".join(harness.forbidden_modules()))
"""

REFERENCE_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference.ggru
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"a3gc_tpu_torch", "a3gc_tpu", "jax", "flax"}})))
"""


def test_pb_ggru_imports_no_jax():
    assert IMPORTS._run(RUN_IMPORTS) == ""
    assert IMPORTS._run(REFERENCE_IMPORTS) == ""
