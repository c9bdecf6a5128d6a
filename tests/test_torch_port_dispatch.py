"""The nets' choice of layer function under backend="auto"
(a3gc_tpu_torch.models.nets._pick): on a card the kernel where it has a
launch plan for the layer call's shape, else the plain version, as the
JAX package's ``use_pallas`` takes its XLA scan where its kernel does not
fit.

Each ops module's ``cached_plan`` holds its ``launch_plan``'s answer over
a sweep of widths, and the dispatch and the launch read the one cached
plan; the known refusals dispatch plain (decided here on a stand-in for a
CUDA tensor: the choice reads only its shape and device);
the export pins each net by the same answer; and nets at unplanned widths
hold within 1e-5 of JAX's ``graph_net_apply`` on the CPU (fp32, sums
reordered over a 6-frame recurrence and two graph convolutions)."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.models import nets as JN
from a3gc_tpu_torch.compat.from_jax import graph_net_params_from_jax
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.ops import gcn_lstm as G
from a3gc_tpu_torch.ops import ggru as GG
from a3gc_tpu_torch.ops import lstm as LS

from torch_port_oracle import jax_graph_net, to_jnp

TOL = 1e-5
SMS = 132                           # an H100 SXM's SMs
WIDTHS = list(range(4, 401, 4)) + [30, 66, 101, 250, 398]


def _plan_or_refusal(plan):
    try:
        return plan()
    except ValueError as e:
        return str(e)


def _refusal(plan):
    got = _plan_or_refusal(plan)
    return got if isinstance(got, str) else None


MODULES = {"gcn_lstm": G, "ggru": GG, "lstm": LS}


@pytest.mark.parametrize("module", ["gcn_lstm", "ggru", "lstm"])
def test_torch_port_plan_refusal_agrees_with_launch_plan(module):
    """Over every width of the sweep, ``cached_plan`` holds the plan
    ``launch_plan`` (asked as the op's CUDA implementation asks it)
    returns, and its refusal word for word where it raises."""
    cases = []
    for H in WIDTHS:
        for S in (1, 8):
            for tf32 in (False, True):
                if module == "gcn_lstm":
                    for att in (True, False):
                        cases.append((G.cached_plan(15, H, att, tf32, S),
                                      _plan_or_refusal(lambda: G.launch_plan(
                                          15, H, att, tf32=tf32, S=S))))
                elif module == "ggru":
                    cases.append((GG.cached_plan(S, 15, H, tf32, SMS),
                                  _plan_or_refusal(lambda: GG.launch_plan(
                                      S, 15, H, sms=SMS, tf32=tf32))))
                else:
                    for D in (1, 2):
                        cases.append((LS.cached_plan(S, H, SMS, D, tf32),
                                      _plan_or_refusal(lambda: LS.launch_plan(
                                          S, H, SMS, D=D, tf32=tf32))))
    assert all(got == want for got, want in cases)
    # the sweep reaches both answers
    assert {isinstance(got, str) for got, _ in cases} == {True, False}


def _scan_args(module, S, H, N=15, T=2):
    """Zero inputs of ``scan`` on the CPU, in the kernel's shapes."""
    z = torch.zeros
    nv = torch.full((S,), T, dtype=torch.int32)
    if module == "gcn_lstm":
        att = (z(2, H, H), z(2, H, H), z(2, H, H), z(2, H), z(2, H),
               z(2, N))
        return (z(2, S, T, N, 4 * H), z(2, H, 4 * H), z(2, 4, N, N),
                z(2, 4, H), att, z(2, S, N, H), z(2, S, N, H), nv)
    if module == "ggru":
        return (z(2, S, T, N, 3 * H), z(2, H, H), z(2, N, N),
                z(2, H, 3 * H), z(2, S, N, H), nv)
    return (z(2, S, T, 4 * H), z(2, H, 4 * H), z(2, S, H), z(2, S, H), nv)


def _scan_key(module, S, H, N=15):
    """The key ``scan`` reads a TF32 plan with, on a card of SMS SMs."""
    return {"gcn_lstm": (N, H, True, True, S),
            "ggru": (S, N, H, True, SMS),
            "lstm": (S, H, SMS, 2, True)}[module]


@pytest.mark.parametrize("module", ["gcn_lstm", "ggru", "lstm"])
def test_torch_port_dispatch_and_launch_share_one_plan(module, monkeypatch):
    """``nets.plan_refusal`` at S = 1 and S = 8 computes each plan once,
    and ``scan`` (its launch stubbed: CPU tensors stand in for the card's)
    then launches that very plan without computing one; the key the
    dispatch asks with at S = 1 holds gcn_lstm's one-stream plan (C = 16
    at H = 256 with TF32)."""
    mod = MODULES[module]
    monkeypatch.setattr(TN, "sm_count", lambda index: SMS)
    monkeypatch.setattr(mod, "sm_count", lambda index: SMS, raising=False)
    monkeypatch.setattr(mod, "device_index", lambda dev: 0, raising=False)
    computed, launched = [], []
    launch_plan = mod.launch_plan

    def counted(*args, **kwargs):
        computed.append((args, kwargs))
        return launch_plan(*args, **kwargs)

    monkeypatch.setattr(mod, "launch_plan", counted)
    monkeypatch.setattr(mod, "_library", lambda: None)
    monkeypatch.setattr(mod, "launch",
                        lambda name, lib, dev, *args: launched.append(args))
    wrapper = getattr(mod, {"gcn_lstm": "bi_gcn_lstm", "ggru": "bi_ggru",
                            "lstm": "bi_lstm"}[module])
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "tf32_launches", 0)
    monkeypatch.setattr(wrapper, "launches_by_cluster", {}, raising=False)
    mod.cached_plan.cache_clear()
    H = 256
    cfg = _dense(H) if module == "lstm" else _graph(
        "ggru" if module == "ggru" else "a3gc", H)
    card = torch.device("cuda", 0)
    for n, S in enumerate((1, 8), start=1):
        for _ in range(2):
            assert TN.plan_refusal(cfg, S, "tf32", card) is None
        assert len(computed) == n
        plan = mod.cached_plan(*_scan_key(module, S, H))
        args, kwargs = computed[-1]
        assert plan == launch_plan(*args, **kwargs)
        mod.scan(*_scan_args(module, S, H), tf32=True)
        assert len(computed) == n and len(launched) == n
        ints = (mod._plan_ints(plan) if hasattr(mod, "_plan_ints")
                else tuple(plan))
        assert launched[-1][-len(ints) - 1:] == ints + (1,)
        assert mod.cached_plan(*_scan_key(module, S, H)) is plan
    if module == "gcn_lstm":
        assert mod.cached_plan(*_scan_key(module, 1, H)).C == 16
        assert mod.cached_plan(*_scan_key(module, 8, H)).C == 8


@pytest.mark.parametrize("fmt", ["fp32", "tf32"])
def test_torch_port_dense_plan_refusal_keyed_by_format(fmt):
    """``nets.plan_refusal`` of a dense net (bi and uni) at each operand
    format is ``lstm.launch_plan``'s answer for that format: the TF32 plan
    (on the tensor cores where it fits) at "tf32", the fp32 plan at
    "fp32", over the sweep of widths."""
    card = torch.device("cuda", 0)
    for H in WIDTHS:
        for bi in (True, False):
            cfg = dataclasses.replace(_dense(H), bidirectional=bi)
            for S in (1, 8):
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(TN, "sm_count", lambda index: SMS)
                    got = TN.plan_refusal(cfg, S, fmt, card)
                assert got == _refusal(lambda: LS.launch_plan(
                    S, H, SMS, D=2 if bi else 1, tf32=fmt == "tf32"))


def _graph(cell, H, precision="default", backend="auto"):
    return TN.GraphNetConfig(cell=cell, units_in=15, units_out=9,
                             units_hidden=H, precision=precision,
                             backend=backend)


def _dense(H, backend="auto"):
    return TN.DIPConfig(n_input=72, n_output=15, n_hidden=H,
                        precision="default", backend=backend)


def _stub(name):
    def fn(params, inputs, state, n_valid, fmt):
        return name, fmt
    fn.plain_dispatches = 0
    fn.__name__ = f"bi_{name}"
    return fn


@pytest.fixture
def on_a_card(monkeypatch):
    """The dispatch as on card 0 of an H100 (132 SMs), taking a stand-in
    for a CUDA tensor of the layer input's shape."""
    monkeypatch.setattr(TN, "sm_count", lambda index: SMS)
    monkeypatch.setattr(TN, "_NOTED_PLAIN", set())
    card = torch.device("cuda", 0)

    def pick(cfg, S, fmt):
        x = SimpleNamespace(is_cuda=True, shape=(S, 60, 15),
                            device=card)
        kernel = _stub("kernel")
        layer = TN._pick(cfg, x, kernel, _stub("plain"), fmt)
        got = [layer(None, None, None, None) for _ in range(2)]
        assert got[0] == got[1]
        return got[0][0], kernel.plain_dispatches

    return pick


def _net(kind, H):
    if kind == "dip_uni":
        return dataclasses.replace(_dense(H), bidirectional=False)
    return _dense(H) if kind == "dense" else _graph(kind, H)


@pytest.mark.parametrize("kind,H,S,fmt,want", [
    ("a3gc", 80, 1, "tf32", "plain"),
    ("a3gc", 80, 8, "fp32", "plain"),
    ("aagc", 76, 8, "tf32", "plain"),
    ("agc", 76, 8, "fp32", "plain"),
    ("ggru", 152, 8, "tf32", "plain"),
    ("ggru", 152, 8, "fp32", "kernel"),
    ("ggru", 152, 1, "tf32", "plain"),
    ("dense", 268, 8, "tf32", "plain"),
    ("dense", 268, 1, "fp32", "plain"),
    ("a3gc", 30, 1, "fp32", "plain"),
    ("aagc", 30, 8, "tf32", "plain"),
    ("ggru", 30, 8, "fp32", "plain"),
    ("dense", 30, 8, "fp32", "plain"),
    ("a3gc", 256, 1, "tf32", "kernel"),
    ("a3gc", 64, 8, "tf32", "kernel"),
    ("a3gc", 128, 8, "fp32", "kernel"),
    ("ggru", 256, 8, "tf32", "kernel"),
    ("dense", 256, 1, "tf32", "kernel"),
    ("dense", 512, 8, "tf32", "kernel"),
    ("dip_uni", 512, 8, "tf32", "kernel"),
])
def test_torch_port_auto_dispatch_on_a_card(on_a_card, kind, H, S, fmt, want,
                                            capsys):
    """Known refusals go plain, each layer call counted, with one note on
    stderr naming the shape and the refusal; planned widths keep the
    kernel and count nothing."""
    cfg = _net(kind, H)
    got, plain = on_a_card(cfg, S, fmt)
    assert got == want
    assert plain == (2 if want == "plain" else 0)
    err = capsys.readouterr().err
    if want == "plain":
        why = TN.plan_refusal(cfg, S, fmt, torch.device("cuda", 0))
        assert f"H={H}" in why
        assert err.count("note: ") == 1 and why in err and fmt in err
    else:
        assert err == ""


def test_torch_port_dispatch_backends_beside_auto(on_a_card):
    """"cuda" takes the kernel whatever the plan (the op then raises);
    "eager" the plain version, uncounted: only "auto" chooses by plan."""
    assert on_a_card(_graph("a3gc", 80, backend="cuda"), 8, "tf32") == \
        ("kernel", 0)
    assert on_a_card(_graph("a3gc", 80, backend="eager"), 8, "tf32") == \
        ("plain", 0)
    assert on_a_card(_graph("a3gc", 80), 8, "tf32") == ("plain", 2)


def test_torch_port_auto_on_cpu_tensors_is_unchanged():
    """On CPU tensors "auto" calls the kernel wrapper (which computes the
    plain version there) at an unplanned width too, and counts no plain
    dispatch."""
    cfg = _graph("a3gc", 80)
    x = torch.zeros(1, 4, 15, 80)
    kernel = _stub("kernel")
    layer = TN._pick(cfg, x, kernel, _stub("plain"), "fp32")
    assert layer(None, None, None, None) == ("kernel", "fp32")
    assert kernel.plain_dispatches == 0


def test_torch_port_export_pins_each_net_by_plan(monkeypatch):
    """On a card the export pins "cuda" (the op in the program) where the
    net's kernel has a plan at the artifact's geometry and "eager" (the
    plain scan, traced) elsewhere, and the manifest's list says which; on
    the CPU every net stays "auto" (the op)."""
    from a3gc_tpu_torch import export as E
    from a3gc_tpu_torch.models.pipeline import CascadeConfig, PoseNetConfig
    monkeypatch.setattr(TN, "sm_count", lambda index: SMS)
    card = torch.device("cuda", 0)

    def cascade(h1, h2, h3, cell="a3gc"):
        return CascadeConfig(*(PoseNetConfig(net=_graph(cell, h), rotsize=9)
                               for h in (h1, h2, h3)))

    for cfg, streams, want in (
            (cascade(256, 64, 128), 8, ["op", "op", "op"]),
            (cascade(80, 64, 128), 8, ["plain", "op", "op"]),
            (cascade(256, 64, 152, "ggru"), 8, ["op", "op", "plain"])):
        pinned, recurrent = E._pin_backend(cfg, card, streams)
        assert recurrent == want
        assert [s.net.backend for s in pinned.stages] == [
            "cuda" if r == "op" else "eager" for r in want]
        pinned, recurrent = E._pin_backend(cfg, torch.device("cpu"), streams)
        assert recurrent == ["op"] * 3
        assert {s.net.backend for s in pinned.stages} == {"auto"}
    assert E._pin_backend(PoseNetConfig(net=_dense(268), rotsize=9), card,
                          8)[1] == ["plain"]
    assert E._pin_backend(PoseNetConfig(net=_dense(512), rotsize=9), card,
                          8)[1] == ["op"]


def _plain_op_args(case):
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(shape, generator=g) * 0.3
    nv = torch.tensor([5, 3], dtype=torch.int32)
    H = 8
    if case == "gcn_lstm":
        return (r(2, 2, 5, 15, 4 * H), r(2, H, 4 * H), r(2, 4, 15, 15),
                r(2, 4, H), r(2, H, H), r(2, H, H), r(2, H, H), r(2, H),
                r(2, H), r(2, 15), r(2, 2, 15, H), r(2, 2, 15, H), nv)
    if case == "ggru":
        return (r(2, 2, 5, 15, 3 * H), r(2, H, H), r(2, 15, 15),
                r(2, H, 3 * H), r(2, 2, 15, H), nv)
    return (r(2, 2, 5, 4 * H), r(2, H, 4 * H), r(2, 2, H), r(2, 2, H), nv)


@pytest.mark.parametrize("case", ["gcn_lstm", "ggru", "lstm"])
def test_torch_port_plain_ops_pass_opcheck(case):
    """The plain versions as ops (what a traced program holds where a
    kernel has no plan) pass ``opcheck`` and equal the kernel ops' CPU
    implementations, the same plain version, bit for bit."""
    from a3gc_tpu_torch.ops import library as LIB
    args = _plain_op_args(case)
    plain = getattr(LIB, f"{case}_scan_plain")
    torch.library.opcheck(plain, args)
    for tf32 in (False, True):
        got = plain(*args, tf32)
        want = getattr(LIB, f"{case}_scan")(*args, tf32)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_torch_port_traced_plain_layers_are_one_node_each():
    """A net on its plain version, traced by ``torch.export``, holds one
    ``gcn_lstm_scan_plain`` node a layer call (not the frame loop), runs
    the plain version bit for bit and counts a plain dispatch a layer."""
    from a3gc_tpu_torch.data import load_adjacency_template
    cfg = _graph("a3gc", 8, backend="eager")
    params = TN.init_graph_net(torch.Generator().manual_seed(0), cfg,
                               load_adjacency_template())
    x = torch.randn(2, 6, 15, 15, generator=torch.Generator().manual_seed(1))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.params = params

        def forward(self, x):
            return TN.graph_net_apply(self.params, cfg, x, device="cpu")

    with torch.no_grad():
        ep = torch.export.export(Net(), (x,), strict=False)
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert sum("gcn_lstm_scan_plain" in t for t in targets) == 2
        assert not any(t.endswith("gcn_lstm_scan.default") for t in targets)
        assert len(targets) < 200
        G.bi_gcn_lstm.plain_dispatches = 0
        got = ep.module()(x)
        assert G.bi_gcn_lstm.plain_dispatches == 2
        want = TN.graph_net_apply(params, cfg, x, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(got),
        torch.utils._pytree.tree_leaves(want)))


@pytest.mark.parametrize("cell,H", [("a3gc", 80), ("ggru", 152)])
def test_torch_port_unplanned_width_net_matches_jax(cell, H):
    """A net at a width the kernels have no plan for computes on the CPU
    what JAX's computes: within 1e-5 on every frame and the final state."""
    B, T = 2, 6
    jcfg, params = jax_graph_net(cell, 15, 9, H, seed=31)
    rng = np.random.default_rng(32)
    x = rng.normal(size=(B, T, 15, 15)).astype(np.float32)
    ref_y, ref_state = JN.graph_net_apply(to_jnp(params), jcfg,
                                          jnp.asarray(x))
    p = graph_net_params_from_jax(params, device="cpu")
    with torch.no_grad():
        y, state = TN.graph_net_apply(p, _graph(cell, H), x, device="cpu")
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=TOL)
    leaves = (state,) if cell == "ggru" else state
    ref_leaves = (ref_state,) if cell == "ggru" else ref_state
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
