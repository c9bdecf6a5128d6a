r"""On the card: each cell runs through the command, briefly, and is
correct; a traced run reports the cell's per-layer metrics. Skips without
a card (run on one: ``python -m pytest portbench/tests -q -m cuda``)."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


def _run(name, seed, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(seed), "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_pb_cell_runs_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.Cell(tiny.bench(), name)
    for trace, metrics in ((0, cell.end_to_end), (1, cell.per_layer)):
        result = _run(name, 2 ** 31 + 17 + trace, trace)
        assert result["correct"], result["compared"]
        assert result["device"]["platform"] == "gpu"
        assert set(result["metrics"]) == {m["name"] for m in metrics}
