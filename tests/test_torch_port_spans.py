"""The port's layer spans (``a3gc.*``, ``a3gc_tpu_torch._runtime``) on the
CPU at hidden 8: a tiny A3GC, TransPose and G-GRU cascade through
``cascade_apply``, and a tiny DIP net through ``dip_batch`` and
``forward_offline``, under ``torch.profiler``, their operand format patched
to "tf32" so that the TF32 rounding runs here as it does on a card:

  * every layer span opens where it belongs, nested as the layers are;
  * a call opens 1 cascade, 3 stages, 6 recurrent layers and 1 IK span (a
    DIP net: 1 cascade, 1 stage, 2 recurrent layers, 1 IK span);
  * the number of ``a3gc.round`` spans does not grow with the frames: no
    span opens inside a per-frame loop;
  * without a profiler a span is the shared null context, and the fp32
    branch of ``operand`` opens no span and does not even ask for one;
  * ``cli evaluate --profile`` writes the layer spans into its trace."""

import glob
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from a3gc_tpu_torch import _runtime as RT
from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.data import pipeline as DPipe
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import (PoseNetConfig, cascade_apply,
                                            forward_offline, init_pose_net)
from a3gc_tpu_torch.ops import _common as CM
from a3gc_tpu_torch.smpl.model import ParametricModel

torch.set_num_threads(1)

WIDTH = ["--hu1", "8", "--hu2", "8", "--hu3", "8"]
MODELS = ("a3gc", "tp", "ggru")
STAGES = ("a3gc.stage1", "a3gc.stage2", "a3gc.stage3")


@pytest.fixture(scope="module")
def cascades():
    """The cascade of each model at hidden 8, fresh weights on the CPU, and
    the body model for IK."""
    out = {}
    for model in MODELS:
        args = TCLI.build_parser().parse_args(
            ["evaluate", "--datasets", "x", "--model", model] + WIDTH)
        cfg, is_graph = TCLI._stage_configs(args)
        out[model] = (cfg, TCLI._init_cascade_params(cfg, is_graph, "cpu"))
    return out, ParametricModel(device="cpu")


@pytest.fixture
def tf32_operands(monkeypatch):
    """The nets' products on TF32 operands on the CPU, as on a card."""
    monkeypatch.setattr(N, "operand_format", lambda precision, dev: "tf32")


def _traced(cascades, model, T):
    """(spans, profiler events) of prep and one cascade call on T frames."""
    (by_model, body), rng = cascades, np.random.default_rng(T)
    cfg, params3 = by_model[model]
    ori = torch.as_tensor(rng.normal(size=(1, T, 54)), dtype=torch.float32)
    acc = torch.as_tensor(rng.normal(size=(1, T, 18)), dtype=torch.float32)
    stats = {k: torch.ones(1) for k in ("ori_mean_channel",
                                        "ori_std_channel",
                                        "acc_mean_channel",
                                        "acc_std_channel")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        o, a = DPipe.normalize_imu(ori, acc, stats)
        imu = (DPipe.scatter_graph_inputs(o, a) if cfg.is_graph
               else torch.cat((a, o), dim=-1))
        pose = cascade_apply(params3, cfg, body, imu, device="cpu")
    assert pose.shape == (T, 24, 3, 3)
    events = [e for e in prof.events() if e.name.startswith("a3gc.")]
    return events


def _a3gc_parent(event):
    """The name of the innermost ``a3gc.*`` span around ``event``."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("a3gc."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("model", MODELS)
def test_torch_port_spans_open_in_their_layers(model, cascades,
                                               tf32_operands):
    events = _traced(cascades, model, 12)
    parents = {}
    for e in events:
        parents.setdefault(e.name, set()).add(_a3gc_parent(e))
    assert parents["a3gc.prep"] == {None}
    assert parents["a3gc.cascade"] == {None}
    for stage in STAGES:
        assert parents[stage] == {"a3gc.cascade"}
    assert parents["a3gc.rnn"] == set(STAGES)
    assert parents["a3gc.ik"] == {"a3gc.cascade"}
    # the products around the layers (a stage's linear in and out) and the
    # hoisted input projections inside them
    assert {"a3gc.rnn"} < parents["a3gc.round"] <= {"a3gc.rnn", *STAGES}
    assert set(parents) == {"a3gc.prep", "a3gc.cascade", *STAGES,
                            "a3gc.rnn", "a3gc.ik", "a3gc.round"}


@pytest.mark.parametrize("model", MODELS)
def test_torch_port_spans_count_per_cascade_call(model, cascades,
                                                 tf32_operands):
    n = Counter(e.name for e in _traced(cascades, model, 12))
    assert n["a3gc.cascade"] == 1 and n["a3gc.ik"] == 1
    assert [n[s] for s in STAGES] == [1, 1, 1]
    assert n["a3gc.rnn"] == 6
    assert n["a3gc.prep"] == (1 if model == "tp" else 2)


@pytest.mark.parametrize("model", MODELS)
def test_torch_port_spans_round_count_does_not_grow_with_frames(
        model, cascades, tf32_operands):
    counts = [Counter(e.name for e in _traced(cascades, model, T))
              for T in (3, 21)]
    assert counts[0]["a3gc.round"] > 0
    assert counts[0] == counts[1]


@pytest.mark.parametrize("model", MODELS)
def test_torch_port_spans_no_round_at_fp32(model, cascades):
    n = Counter(e.name for e in _traced(cascades, model, 12))
    assert n["a3gc.round"] == 0 and n["a3gc.rnn"] == 6


def _traced_dip(bidirectional, T):
    """The spans of the single-net path on T frames: ``dip_batch`` (the
    root sensor dropped), then ``forward_offline`` (net and IK), as
    ``DipEvaluator.evaluate`` runs it."""
    cfg = PoseNetConfig(net=N.DIPConfig(n_hidden=8,
                                        bidirectional=bidirectional))
    params = init_pose_net(torch.Generator().manual_seed(5), cfg)
    rng = np.random.default_rng(T)
    raw = {k: torch.as_tensor(rng.normal(size=(1, T, n)),
                              dtype=torch.float32)
           for k, n in (("ori", 54), ("acc", 18))}
    raw["pose"] = None
    stats = {f"{k}_{m}_channel": (torch.zeros(n) if m == "mean"
                                  else torch.ones(n))
             for k, n in (("ori", 54), ("acc", 18)) for m in ("mean", "std")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        imu, _ = DPipe.dip_batch(raw, stats, no_root=True)
        pose = forward_offline(params, cfg, ParametricModel(device="cpu"),
                               imu)
    assert imu.shape == (1, T, 60) and pose.shape == (T, 24, 3, 3)
    return [e for e in prof.events() if e.name.startswith("a3gc.")]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_torch_port_spans_single_net_open_in_their_layers(bidirectional,
                                                          tf32_operands):
    parents = {}
    for e in _traced_dip(bidirectional, 12):
        parents.setdefault(e.name, set()).add(_a3gc_parent(e))
    assert parents["a3gc.prep"] == {None}
    assert parents["a3gc.cascade"] == {None}
    assert parents["a3gc.stage1"] == {"a3gc.cascade"}
    assert parents["a3gc.rnn"] == {"a3gc.stage1"}
    assert parents["a3gc.ik"] == {"a3gc.cascade"}
    assert {"a3gc.rnn"} < parents["a3gc.round"] <= {"a3gc.rnn",
                                                    "a3gc.stage1"}
    assert set(parents) == {"a3gc.prep", "a3gc.cascade", "a3gc.stage1",
                            "a3gc.rnn", "a3gc.ik", "a3gc.round"}


@pytest.mark.parametrize("bidirectional", [True, False])
def test_torch_port_spans_count_per_single_net_call(bidirectional,
                                                    tf32_operands):
    counts = [Counter(e.name for e in _traced_dip(bidirectional, T))
              for T in (3, 21)]
    n = counts[0]
    assert (n["a3gc.prep"], n["a3gc.cascade"], n["a3gc.stage1"],
            n["a3gc.rnn"], n["a3gc.ik"]) == (1, 1, 1, 2, 1)
    assert n["a3gc.round"] > 0 and counts[0] == counts[1]


def test_torch_port_spans_are_the_shared_null_context_when_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert RT.span("a3gc.rnn") is RT._NO_SPAN
    assert RT.span("a3gc.round") is RT.span("jit__run")


def test_torch_port_spans_fp32_operand_opens_none(monkeypatch):
    t = torch.randn(4, 4)
    b = t.to(torch.bfloat16)

    def no_span(name):
        raise AssertionError(f"the fp32 branch asked for span {name}")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with monkeypatch.context() as m:
            m.setattr(CM, "span", no_span)
            assert CM.operand(t, "fp32") is t
            assert CM.operand(b, "tf32") is b
        assert CM.step_operand(t, "tf32").dtype == torch.float32
        r = CM.operand(t, "tf32")
    torch.testing.assert_close(r, CM.round_tf32(t), rtol=0, atol=0)
    names = [e.name for e in prof.events() if e.name.startswith("a3gc.")]
    assert names == ["a3gc.round"]     # the tf32 operand alone


def test_torch_port_spans_in_cli_evaluate_profile(tmp_path):
    from a3gc_tpu_torch.smpl import write_synthetic_smpl_pickle
    packed = synthetic_packed_dataset(2, 20, seed=5)
    np.savez(tmp_path / "test.npz", **{
        f"seq{i}_{k}": packed[k][i] for i in range(2)
        for k in ("ori", "acc", "pose")})
    smpl = write_synthetic_smpl_pickle(str(tmp_path / "smpl.pkl"),
                                       n_vertices=96)
    trace_dir = tmp_path / "trace"
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        TCLI.main(["evaluate", "--device", "cpu", "--norm", "--smpl", smpl,
                   "--datasets", str(tmp_path / "test.npz"), "--profile",
                   str(trace_dir)] + WIDTH)
    finally:
        os.chdir(old)
    (path,) = glob.glob(str(trace_dir / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for span in ("jit__run", "a3gc.prep", "a3gc.cascade", "a3gc.rnn",
                 "a3gc.ik"):
        assert span in names, span
