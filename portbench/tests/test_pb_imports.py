r"""What a run imports holds no JAX and no module of the JAX package
(whole top-level names: ``a3gc_tpu_torch`` is not ``a3gc_tpu``), and the
references import nothing of the program. Checked in fresh processes: the
test process itself may hold anything."""

import os
import subprocess
import sys

from portbench import harness

RUN_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import glob, os
from portbench import harness, check, traffic, weights, work, trace
from portbench import metric_math
import portbench.drivers.offline_seq, portbench.drivers.serve_http
import portbench.drivers.http_client
import portbench.families.graph, portbench.families.dense
import portbench.reference.graph, portbench.reference.dense
for f in glob.glob(os.path.join(harness.HERE, "metrics", "*.py")):
    harness.reader(os.path.basename(f)[:-3])
from a3gc_tpu_torch.models.pipeline import cascade_apply
from a3gc_tpu_torch.data import pipeline
from a3gc_tpu_torch.eval.streaming import StreamingCascade
from a3gc_tpu_torch.serve import PoseServer
from a3gc_tpu_torch.client import PoseClient
from a3gc_tpu_torch.smpl.model import ParametricModel
import a3gc_tpu_torch.ops.gcn_lstm, a3gc_tpu_torch.ops.lstm
print(",".join(harness.forbidden_modules()))
"""

REFERENCE_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference.graph, portbench.reference.dense
import portbench.check
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"a3gc_tpu_torch", "a3gc_tpu", "jax", "flax"}})))
"""


def _run(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=harness.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


def test_pb_run_imports_no_jax():
    assert _run(RUN_IMPORTS) == ""


def test_pb_reference_imports_nothing_of_the_program():
    assert _run(REFERENCE_IMPORTS) == ""


def test_pb_forbidden_names_are_compared_whole():
    f = harness.forbidden_modules
    assert f(["a3gc_tpu_torch", "a3gc_tpu_torch.ops.lstm", "numpy"]) == []
    assert f(["a3gc_tpu.models.nets", "jaxlib.xla_client", "flax"]) == [
        "a3gc_tpu", "flax", "jaxlib"]
    assert f(["jax_like", "jaxx"]) == []
