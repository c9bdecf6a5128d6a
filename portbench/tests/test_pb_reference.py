r"""The plain references equal the port's eager CPU path at tiny widths, for
both configurations: offline (ragged sequences in one call) and window by
window with the state carried and one slot reset."""

import numpy as np
import pytest
import torch

from portbench import traffic, weights
from portbench.reference.common import no_tf32
from portbench.tests import tiny

CELLS = ("a3gc_tp.offline_seq", "transpose.offline_seq")
TOL = 1e-5      # fp32, the same operations summed in other orders


def _setup(name, seed):
    c = tiny.cell(name)
    w = weights.draw(c.family.param_spec(c.config), seed, "cpu")
    stats_np = c.stats()
    stats = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in stats_np.items()}
    ori, acc = traffic.imu_pool(seed, {"sequences": 3, "frames": 200},
                                stats_np)
    return c, w, stats, stats_np, torch.as_tensor(ori), torch.as_tensor(acc)


@pytest.mark.parametrize("name", CELLS)
def test_pb_reference_equals_port_offline(name):
    from a3gc_tpu_torch.data import pipeline as DPipe
    from a3gc_tpu_torch.models.pipeline import cascade_apply
    from a3gc_tpu_torch.smpl.model import ParametricModel

    c, w, stats, _, ori, acc = _setup(name, 11)
    cfg, params3 = c.family.port_cascade(c.config, w)
    n_valid = [120, 75, 31]
    o, a = DPipe.normalize_imu(ori[:, :120], acc[:, :120], stats)
    imu = (DPipe.scatter_graph_inputs(o, a) if cfg.is_graph
           else torch.cat((a, o), dim=-1))
    mask = (np.arange(120)[None] < np.asarray(n_valid)[:, None])
    port = cascade_apply(params3, cfg, ParametricModel(device="cpu"), imu,
                         frame_mask=mask.astype(np.float32), device="cpu")
    port = port.reshape(3, 120, 24, 3, 3)
    with no_tf32():
        ref, _ = c.reference.cascade(c.config, w, ori[:, :120],
                                     acc[:, :120], stats,
                                     torch.tensor(n_valid))
    for i, n in enumerate(n_valid):
        assert (port[i, :n] - ref[i, :n]).abs().max() < TOL
    assert ref[:, :, 1].abs().max() > 0.01      # not a trivial output


@pytest.mark.parametrize("name", CELLS)
def test_pb_reference_equals_port_streaming_with_reset(name):
    from a3gc_tpu_torch.eval.streaming import StreamingCascade
    from a3gc_tpu_torch.smpl.model import ParametricModel

    c, w, stats, stats_np, ori, acc = _setup(name, 12)
    cfg, params3 = c.family.port_cascade(c.config, w)
    W = 6
    sess = StreamingCascade(params3, cfg, ParametricModel(device="cpu"),
                            window=W, stats=stats_np, normalize=True,
                            streams=3, device="cpu")
    # slot 0 streams 4 windows; slot 1 two, is reset, then streams a new
    # sequence; slot 2 idles in the second and third ticks
    plan = [(1, 1, 1), (1, 1, 0), (1, 0, 0), (1, 1, 1)]
    got = {0: [], 1: [], 2: []}
    start = {0: 0, 1: 0, 2: 0}
    for k, act in enumerate(plan):
        if k == 2:
            sess.reset(stream=1)
            start[1] = 2
        o = np.stack([ori[i, k * W:(k + 1) * W].numpy() for i in range(3)])
        a = np.stack([acc[i, k * W:(k + 1) * W].numpy() for i in range(3)])
        pose = sess.step(o, a, active=np.asarray(act, np.float32))
        for i in range(3):
            if act[i]:
                got[i].append((k, pose[i]))
    with no_tf32():
        for i in range(3):
            states, fresh = None, False
            for k, p in got[i]:
                if k >= start[i] > 0 and not fresh:
                    states, fresh = None, True      # the reset slot
                ref, states = c.reference.cascade(
                    c.config, w, ori[i:i + 1, k * W:(k + 1) * W],
                    acc[i:i + 1, k * W:(k + 1) * W], stats,
                    torch.tensor([W]), states)
                assert (torch.as_tensor(p) - ref[0]).abs().max() < TOL
