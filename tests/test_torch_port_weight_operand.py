"""``ops/_common.py`` ``weight_operand``: the TF32 rounding of a net's
parameters, kept per weight version and served again on later calls.

  * its value is ``round_tf32``'s bit for bit (±inf, NaN, values past the
    largest TF32) over contiguous weights, slices, reshapes and transposes;
  * an in-place update of the weight, or of the flat base it views, gives
    a fresh result; a freed weight's entry is never served to another
    tensor;
  * autograd (its straight-through gradient), inference tensors and
    ``torch.export`` step aside; fp32 and non-fp32 operands pass through;
  * ``hits`` / ``misses`` / ``bypassed`` count exactly, the cache keeps
    within ``WEIGHT_CACHE_ENTRIES``, and threads sharing it lose no count;
  * a layer call twice at "tf32" (A3GC, G-GRU, TransPose at hidden 8):
    the second misses nothing, hits once a weight operand, and every
    pose is bit-equal to the first call's, to a call with the cache
    cleared and to every weight rounded on every call, as before the
    cache; the TP column blocks hit per block; a training step's
    gradients are those of rounding on every call."""

import sys
import threading
import weakref

import numpy as np
import pytest
import torch
from torch import nn

from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.models import cells as C
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import cascade_apply
from a3gc_tpu_torch.ops import _common as CM
from a3gc_tpu_torch.parallel import tensor as TP
from a3gc_tpu_torch.smpl.model import ParametricModel

WO = CM.weight_operand
LARGEST_TF32 = float(np.float32(2.0 ** 127 * (2.0 - 2.0 ** -10)))
SPECIAL = [float("inf"), -float("inf"), float("nan"), 3.4e38, -3.4e38,
           LARGEST_TF32, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1e-40,
           -0.0]


@pytest.fixture(autouse=True)
def _fresh_cache():
    """An empty cache and counters at 0 around each test; one thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    WO.cache.clear()
    WO.hits = WO.misses = WO.bypassed = 0
    yield
    WO.cache.clear()
    torch.set_num_threads(old)


def _counts():
    return WO.hits, WO.misses, WO.bypassed


def _weight(seed=0, shape=(6, 10)):
    t = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    t.view(-1)[:len(SPECIAL)] = torch.tensor(SPECIAL)
    return nn.Parameter(t)


def _bits(t):
    return t.contiguous().view(torch.int32)


VIEWS = {
    "whole": lambda w: w,
    "slice": lambda w: w[:, :4],
    "rows": lambda w: w[2:5],
    "reshape": lambda w: w.reshape(3, 2, 10),
    "transpose": lambda w: w.t(),
    "stacked": lambda w: w.reshape(2, 3, 10)[:, None],
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_torch_port_weight_operand_is_round_tf32_bit_for_bit(view):
    w = _weight()
    with torch.no_grad():
        first = WO(VIEWS[view](w), "tf32")
        again = WO(VIEWS[view](w), "tf32")     # a fresh view: a hit
    want = CM.round_tf32(VIEWS[view](w))
    assert again is first
    assert torch.equal(_bits(first), _bits(want))
    assert _counts() == (1, 1, 0)


def test_torch_port_weight_operand_views_are_distinct_entries():
    w = _weight()
    with torch.no_grad():
        outs = [WO(VIEWS[v](w), "tf32") for v in sorted(VIEWS)]
    assert _counts() == (0, len(VIEWS), 0) and len(WO.cache) == len(VIEWS)
    for v, got in zip(sorted(VIEWS), outs):
        assert torch.equal(_bits(got), _bits(CM.round_tf32(VIEWS[v](w))))


@pytest.mark.parametrize("update", ["weight", "view", "flat_base"])
def test_torch_port_weight_operand_in_place_update_gives_fresh(update):
    base = torch.randn(60, generator=torch.Generator().manual_seed(1))
    w = nn.Parameter(base.view(6, 10))
    with torch.no_grad():
        before = WO(w[:, :4], "tf32")
        {"weight": lambda: w.add_(0.5),
         "view": lambda: w[1:3].mul_(-3.0),
         "flat_base": lambda: base[7:40].add_(2.0)}[update]()
        after = WO(w[:, :4], "tf32")
    assert _counts() == (0, 2, 0)
    assert not torch.equal(before, after)
    assert torch.equal(_bits(after), _bits(CM.round_tf32(w[:, :4])))
    assert len(WO.cache) == 1      # the stale version replaced, not kept


def test_torch_port_weight_operand_freed_weight_is_never_served():
    """Each weight is dropped after its call, so the allocator may hand its
    memory to the next one; the entry keeps its source alive while it
    lives, and once evicted nothing of it remains: every result is its own
    weight's rounding."""
    refs = []
    with torch.no_grad():
        for i in range(3 * CM.WEIGHT_CACHE_ENTRIES):
            w = torch.full((32, 32), 1.0 + i * 2.0 ** -12)
            refs.append(weakref.ref(w))
            got = WO(w, "tf32")
            assert torch.equal(_bits(got), _bits(CM.round_tf32(w)))
            del w, got
    assert _counts() == (0, 3 * CM.WEIGHT_CACHE_ENTRIES, 0)
    alive = [r() is not None for r in refs]
    assert alive == ([False] * 2 * CM.WEIGHT_CACHE_ENTRIES
                     + [True] * CM.WEIGHT_CACHE_ENTRIES)


def test_torch_port_weight_operand_stays_within_its_bound(monkeypatch):
    monkeypatch.setattr(CM, "WEIGHT_CACHE_ENTRIES", 4)
    ws = [torch.randn(3, 3) for _ in range(6)]
    with torch.no_grad():
        for w in ws[:4]:
            WO(w, "tf32")
        WO(ws[0], "tf32")                       # ws[0] most recently used
        for w in ws[4:]:
            WO(w, "tf32")                       # evicts ws[1], then ws[2]
        assert len(WO.cache) == 4
        assert _counts() == (1, 6, 0)
        WO(ws[0], "tf32")
        WO(ws[1], "tf32")
    assert _counts() == (2, 7, 0) and len(WO.cache) == 4


def test_torch_port_weight_operand_grad_mode_bypasses_with_straight_through():
    g = torch.Generator().manual_seed(2)
    w = nn.Parameter(torch.randn(6, 10, generator=g))
    x = torch.randn(5, 6, generator=g).requires_grad_()
    grads = []
    for fn in (WO, CM.operand):
        w.grad = x.grad = None
        (torch.matmul(CM.operand(x, "tf32"), fn(w, "tf32")) ** 2).sum() \
            .backward()
        grads.append((w.grad.clone(), x.grad.clone()))
    assert _counts() == (0, 0, 1) and not WO.cache
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # no graph recorded (no_grad), or a weight that needs none: the cache
    with torch.no_grad():
        WO(w, "tf32")
    WO(w.detach(), "tf32")
    assert _counts() == (1, 1, 1)


def test_torch_port_weight_operand_inference_tensor_bypasses():
    with torch.inference_mode():
        w = torch.randn(4, 4)
        got = WO(w, "tf32")
    assert w.is_inference()
    assert torch.equal(got, CM.round_tf32(w))
    assert _counts() == (0, 0, 1) and not WO.cache


def test_torch_port_weight_operand_made_in_inference_mode_serves_autograd():
    """A copy rounded inside ``inference_mode`` from a normal weight is a
    normal tensor: a later product that autograd records may save it."""
    w = torch.randn(4, 3)
    with torch.inference_mode():
        WO(w, "tf32")
    x = torch.randn(2, 4, requires_grad=True)
    torch.matmul(x, WO(w, "tf32")).sum().backward()
    assert torch.equal(x.grad, CM.round_tf32(w).sum(1).expand(2, 4))
    assert _counts() == (1, 1, 0)


def test_torch_port_weight_operand_export_keeps_its_rounding():
    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.randn(8, 4))

        def forward(self, x):
            return TP.matmul(x, self.w, fmt="tf32")

    net, x = Net(), torch.randn(3, 8)
    with torch.no_grad():
        prog = torch.export.export(net, (x,), strict=False)
        assert _counts() == (0, 0, 1)
        shifts = [n for n in prog.graph.nodes
                  if str(n.target) == "aten.__rshift__.Scalar"]
        assert len(shifts) == 2         # x and w rounded inside the program
        want = TP.matmul(x, net.w, fmt="tf32")
        assert torch.equal(prog.module()(x), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_torch_port_weight_operand_passes_other_formats_through(dtype):
    w = torch.randn(4, 4)
    h = w.to(dtype)

    def no_span(name):
        raise AssertionError(f"asked for span {name}")

    with torch.no_grad():
        orig, CM.span = CM.span, no_span
        try:
            assert WO(w, "fp32") is w
            assert WO(h, "tf32") is h
        finally:
            CM.span = orig
        with pytest.raises(ValueError):
            WO(w, "bf16")
    assert _counts() == (0, 0, 0) and not WO.cache


def test_torch_port_weight_operand_threads_share_the_cache(monkeypatch):
    """More threads than cores, a short switch interval and a bound below
    the weights in use: no count is lost, every answer is its weight's."""
    monkeypatch.setattr(CM, "WEIGHT_CACHE_ENTRIES", 5)
    ws = [torch.randn(16, 16) for _ in range(8)]
    want = [CM.round_tf32(w) for w in ws]
    calls, errors = 400, []

    def work(k):
        try:
            with torch.no_grad():
                for i in range(calls):
                    j = (k + i) % len(ws)
                    if not torch.equal(WO(ws[j], "tf32"), want[j]):
                        errors.append((k, i))
        except Exception as e:      # noqa: BLE001 (reported below)
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert WO.hits + WO.misses == 12 * calls and WO.bypassed == 0
    assert len(WO.cache) <= 5


# ---------------------------------------------------------------------------
# layer calls at "tf32" on the CPU (operand format forced, as on a card)
# ---------------------------------------------------------------------------

WIDTH = ["--hu1", "8", "--hu2", "8", "--hu3", "8"]
# weight operands of a cascade call: a graph stage rounds linear_in's and
# linear_out's kernel and adjacency and each recurrent layer's input
# kernel (6), a TransPose stage linear1, linear2 and two w_ih (4)
WEIGHT_OPERANDS = {"a3gc": 18, "ggru": 18, "tp": 12}


@pytest.fixture(scope="module")
def cascades():
    out = {}
    for model in WEIGHT_OPERANDS:
        args = TCLI.build_parser().parse_args(
            ["evaluate", "--datasets", "x", "--model", model] + WIDTH)
        cfg, is_graph = TCLI._stage_configs(args)
        out[model] = (cfg, TCLI._init_cascade_params(cfg, is_graph, "cpu"))
    return out, ParametricModel(device="cpu")


@pytest.fixture
def tf32_operands(monkeypatch):
    """The nets' products on TF32 operands on the CPU, as on a card."""
    monkeypatch.setattr(N, "operand_format", lambda precision, dev: "tf32")


def _imu(cfg, T, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (1, T, 15, 12) if cfg.is_graph else (1, T, 72)
    return torch.randn(shape, generator=g)


@pytest.mark.parametrize("model", sorted(WEIGHT_OPERANDS))
def test_torch_port_weight_operand_layer_call_twice(model, cascades,
                                                    tf32_operands,
                                                    monkeypatch):
    (by_model, body) = cascades
    cfg, params3 = by_model[model]
    imu = _imu(cfg, 9, 3)
    first = cascade_apply(params3, cfg, body, imu, device="cpu")
    assert _counts() == (0, WEIGHT_OPERANDS[model], 0)
    WO.hits = WO.misses = 0
    second = cascade_apply(params3, cfg, body, imu, device="cpu")
    assert _counts() == (WEIGHT_OPERANDS[model], 0, 0)
    WO.cache.clear()
    cleared = cascade_apply(params3, cfg, body, imu, device="cpu")
    # every weight rounded on every call, as before the cache
    monkeypatch.setattr(TP, "weight_operand", CM.operand)
    monkeypatch.setattr(C, "weight_operand", CM.operand)
    WO.hits = WO.misses = 0
    each_call = cascade_apply(params3, cfg, body, imu, device="cpu")
    assert _counts() == (0, 0, 0)
    for other in (second, cleared, each_call):
        assert torch.equal(_bits(first), _bits(other))


def test_torch_port_weight_operand_column_blocks_hit_per_block():
    g = torch.Generator().manual_seed(4)
    blocks = [nn.Parameter(torch.randn(8, 3, generator=g)) for _ in range(2)]
    w = TP.Columns(blocks, torch.cat(blocks, -1).detach())
    x = torch.randn(5, 8, generator=g)
    with torch.no_grad():
        outs = [TP.matmul(x, w, fmt="tf32") for _ in range(2)]
    assert _counts() == (2, 2, 0)
    want = torch.matmul(CM.round_tf32(x), CM.round_tf32(w.full))
    for y in outs:
        assert torch.equal(y, want)


def test_torch_port_weight_operand_training_step_grads_unchanged(
        monkeypatch):
    """A graph conv and a hoisted product with grad on, twice, then with
    every weight through ``operand``: the same loss and gradients bit for
    bit, and the cache never consulted."""
    g = torch.Generator().manual_seed(5)
    p = C.GraphConvParams(torch.randn(6, 4, generator=g),
                          torch.randn(15, 15, generator=g),
                          torch.randn(4, generator=g))
    k = nn.Parameter(torch.randn(2, 4, 8, generator=g))
    x = torch.randn(2, 15, 6, generator=g)

    def step():
        for t in (*p.parameters(), k):
            t.grad = None
        y = C.graph_conv(p, x, fmt="tf32")
        loss = TP.matmul(y, k, stacked=True, fmt="tf32").square().sum()
        loss.backward()
        return [loss.detach()] + [t.grad.clone()
                                  for t in (*p.parameters(), k)]

    runs = [step(), step()]
    assert _counts() == (0, 0, 6) and not WO.cache
    monkeypatch.setattr(TP, "weight_operand", CM.operand)
    monkeypatch.setattr(C, "weight_operand", CM.operand)
    runs.append(step())
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
