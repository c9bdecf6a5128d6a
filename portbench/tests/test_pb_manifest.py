r"""``BENCHMARK.json``: every cell resolves to its files by name, and the
manifest keeps to the benchmark contract's form."""

import importlib
import json
import os
import re

import pytest

from portbench import harness
from portbench.tests import tiny

BENCH = tiny.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_pb_cell_resolves_by_name(name):
    c = harness.Cell(BENCH, name)
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert c.traffic["driver"] == c.driver.__name__.rsplit(".", 1)[1]
    assert os.path.isfile(os.path.join(harness.HERE, "traffic",
                                       entry["traffic"] + ".json"))
    for fn in ("param_spec", "port_cascade", "scan_calls",
               "flop_per_frame"):
        assert callable(getattr(c.family, fn))
    assert callable(c.reference.cascade)
    assert set(c.limits) == {"pose_rms", "pose_max"}
    assert os.path.isfile(c.stats_path)
    names = [m["name"] for m in c.end_to_end + c.per_layer]
    assert "setup_s" in names and len(c.end_to_end) >= 2 and c.per_layer
    for metric in names:
        assert callable(harness.reader(metric).read)


def test_pb_manifest_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert c["reduced"] == []
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = set()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in names and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    every = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in every}) == len(every)
    for m in every:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_pb_config_files_hold_published_widths():
    a3gc = harness._json(os.path.join(harness.HERE, "configs",
                                      "a3gc_tp.json"))
    assert [s["units_hidden"] for s in a3gc["stages"]] == [256, 64, 128]
    assert a3gc["cell"] == "a3gc" and a3gc["stages"][2]["rotsize"] == 9
    tp = harness._json(os.path.join(harness.HERE, "configs",
                                    "transpose.json"))
    assert [(s["n_input"], s["n_output"], s["n_hidden"])
            for s in tp["stages"]] == [(72, 15, 256), (87, 69, 64),
                                       (141, 135, 128)]
    for cfg in (a3gc, tp):
        assert cfg["precision"] == "default" and cfg["normalize"]
        importlib.import_module("portbench.families." + cfg["family"])
