"""The port stands alone: importing a3gc_tpu_torch and serving tiny a3gc,
ggru and TransPose cascades through StreamingCascade and a DIP net through
DipStreamingSession on the CPU, and a served step through
a3gc_tpu_torch.serve, .client and .cli, loads no jax, flax or a3gc_tpu
module."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import a3gc_tpu_torch
from a3gc_tpu_torch.data import load_adjacency_template, load_stats
from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                           StreamingCascade)
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                            init_pose_net)
from a3gc_tpu_torch.smpl import ParametricModel

def graph(cell, ui, uo, rot):
    return PoseNetConfig(net=N.GraphNetConfig(
        cell=cell, units_in=ui, units_out=uo, units_hidden=8), rotsize=rot)

def dense(ni, no, rot):
    return PoseNetConfig(net=N.DIPConfig(n_input=ni, n_output=no,
                                         n_hidden=8), rotsize=rot)

gen = torch.Generator().manual_seed(0)
nira = load_adjacency_template()
rng = np.random.default_rng(0)
cascades = [CascadeConfig(*(graph(cell, *d) for d in
                            ((12, 3, 3), (15, 3, 3), (15, 9, 9))))
            for cell in ("a3gc", "ggru")]
cascades.append(CascadeConfig(dense(72, 15, 3), dense(87, 69, 3),
                              dense(141, 135, 9)))
sessions = [StreamingCascade(
    tuple(init_pose_net(gen, c, nira) for c in cfg.stages), cfg,
    ParametricModel(), window=4, stats=load_stats(), normalize=True,
    streams=2, device="cpu") for cfg in cascades]
dip = dense(60, 135, 9)
sessions.append(DipStreamingSession(init_pose_net(gen, dip), dip,
                                    ParametricModel(), window=4,
                                    stats=load_stats(), streams=2,
                                    device="cpu"))
for sess in sessions:
    pose = sess.step(rng.normal(size=(2, 4, 54)),
                     rng.normal(size=(2, 4, 18)))
    assert pose.shape == (2, 4, 24, 3, 3) and np.isfinite(pose).all()
# the serving stack: a buffered server on the CPU, one client over HTTP
import threading
import a3gc_tpu_torch.cli
from a3gc_tpu_torch.client import PoseClient
from a3gc_tpu_torch.serve import PoseServer
args = a3gc_tpu_torch.cli.build_parser().parse_args(
    ["serve", "--quality", "balanced"])
a3gc_tpu_torch.cli._apply_quality(args)
cfg = cascades[0]
srv = PoseServer(tuple(init_pose_net(gen, c, nira) for c in cfg.stages),
                 cfg, ParametricModel(), window=4, streams=2, port=0,
                 max_wait_ms=1.0, lookahead=args.lookahead,
                 history=args.history, device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
with PoseClient(*srv.address, timeout=30.0, retry_s=2.0) as c:
    served = [c.step(rng.normal(size=(4, 54)), rng.normal(size=(4, 18)))
              for _ in range(3)]
    assert served[0] is None and served[2].shape == (4, 24, 3, 3)
    assert c.flush().shape == (4, 24, 3, 3)
    assert c.stats()["errors"] == 0
srv.shutdown()
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "a3gc_tpu"))
print(json.dumps(banned))
"""


def test_torch_port_imports_no_jax_or_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
