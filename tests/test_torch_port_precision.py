"""The port's ``precision`` against the JAX package's: the operand format
("fp32" or "tf32") a net's precision gives on each device, the TF32
rounding bit for bit against ``jax.lax.reduce_precision``, each CLI
command's default against the JAX CLI's, the CPU cascades at "default"
against "highest" and against JAX, the plain version of each kernel with
TF32 operands forced on the CPU, and a training step through the rounding.

On the CPU "default" is fp32 in both packages (XLA's DEFAULT precision is
fp32 there), so the cascades at "default" must be the "highest" ones bit
for bit. The kernels' TF32 instantiations themselves run on the card only
(``tests/test_torch_port_card.py``, ``chip_smoke.py`` phase
``precision``)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu import cli as JCLI
from a3gc_tpu.models import nets as JN
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu.ops.pallas_gcn_lstm import (bi_gcn_lstm_pallas, bi_ggru_pallas,
                                          bi_lstm_pallas)
from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.compat.from_jax import (cascade_params_from_jax,
                                            cell_params_from_jax,
                                            lstm_layer_params_from_jax)
from a3gc_tpu_torch.models import cells as TC
from a3gc_tpu_torch.models import layers as TL
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL
from a3gc_tpu_torch.ops import _common as CM
from a3gc_tpu_torch.ops import gcn_lstm as G
from a3gc_tpu_torch.ops import ggru as GG
from a3gc_tpu_torch.ops import lstm as LS
from a3gc_tpu_torch.ops.library import _gcn_lstm_plain
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import (cascades, eval_sequences, jax_cell_params2,
                               jax_dip, to_jnp)

TOL = 1e-5            # port against JAX at fp32 (the existing tests' bound)
# The plain versions with TF32 operands against JAX's fp32 functions, at
# the widths and seeds below (H = 8 / 16, 8-12 frames). Measured on the CPU:
# gcn_lstm 5.1e-4 (A3GC) / 3.6e-4 (AAGC), ggru 7.1e-4, lstm 3.5e-4 (bi) /
# 3.0e-4 (uni), as far as from the fp32 plain versions. A TF32 operand is
# within 2^-11 (4.9e-4) of the fp32 one, relative; the bound is four such
# steps on values of order one, under the 8.05e-3 that the JAX package's own
# Pallas kernels at "default" hold against XLA.
TF32_TOL = 2e-3
N = 15


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- the operand format -------------------------------------------------------

def _specials():
    bits = np.array([0x3F801000, 0x3F803000, 0x3F800FFF, 0x3F802FFF,
                     0xBF801000, 0x00000001, 0x80000001, 0x00801000],
                    np.uint32)
    return np.concatenate([
        np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 3.4e38, -3.4e38,
                  np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                 np.float32), bits.view(np.float32)])


def test_torch_port_round_tf32_matches_reduce_precision():
    """100,000 seeded bit patterns over every exponent (NaNs with payloads
    included), the ties and the special values: bitwise equal."""
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 100_000,
                                             dtype=np.uint64)
    x = np.concatenate([bits.astype(np.uint32).view(np.float32), _specials()])
    ref = np.asarray(jax.lax.reduce_precision(jnp.asarray(x),
                                              exponent_bits=8,
                                              mantissa_bits=10))
    got = CM.round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_torch_port_operand_is_straight_through():
    """At "tf32" an operand that needs a gradient is the rounded value
    (NaNs stay NaN) with the identity's gradient; at "fp32" it is the
    tensor itself; a bf16 tensor is a TF32 value already."""
    x = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    x[:3] = (np.inf, -np.inf, np.nan)
    t = torch.from_numpy(x).clone().requires_grad_()
    op = CM.operand(t, "tf32")
    want = CM.round_tf32(torch.from_numpy(x)).numpy()
    got = op.detach().numpy()
    assert np.isnan(got[2])
    keep = ~np.isnan(x)
    np.testing.assert_array_equal(got[keep].view(np.uint32),
                                  want[keep].view(np.uint32))
    assert not np.array_equal(got[3:], x[3:])
    op[3:].sum().backward()
    np.testing.assert_array_equal(t.grad.numpy()[3:], 1.0)
    assert CM.operand(t, "fp32") is t
    b = torch.ones(4, dtype=torch.bfloat16)
    assert CM.operand(b, "tf32") is b
    with pytest.raises(ValueError, match="operand format"):
        CM.operand(t, "bf16")


@pytest.mark.parametrize("precision,device,fmt", [
    ("highest", "cpu", "fp32"), ("highest", "cuda", "fp32"),
    ("highest", "cuda:0", "fp32"), ("default", "cpu", "fp32"),
    ("default", "cuda", "tf32"), ("default", "cuda:1", "tf32"),
    ("default", torch.device("cuda", 0), "tf32"),
])
def test_torch_port_operand_format(precision, device, fmt):
    assert CM.operand_format(precision, device) == fmt


@pytest.mark.parametrize("bad", ["high", "fp32", "tf32", None])
def test_torch_port_precision_refuses_other_values(bad):
    with pytest.raises(ValueError, match="precision"):
        CM.operand_format(bad, "cpu")
    with pytest.raises(ValueError, match="precision"):
        TN.GraphNetConfig(precision=bad)
    with pytest.raises(ValueError, match="precision"):
        TN.DIPConfig(precision=bad)


def test_torch_port_config_precision_defaults_match_jax():
    assert TN.GraphNetConfig().precision == JN.GraphNetConfig().precision \
        == "highest"
    assert TN.DIPConfig().precision == JN.DIPConfig().precision == "highest"


# -- each command's precision against the JAX CLI's ---------------------------

class _Picked(Exception):
    r"""Raised by a net config's constructor: the precision a command
    asked for."""


def _picked_precision(monkeypatch, nets, cli_module, argv):
    def record(*args, **kwargs):
        raise _Picked(kwargs.get("precision", "highest"))

    with monkeypatch.context() as m:
        m.setattr(nets, "GraphNetConfig", record)
        m.setattr(nets, "DIPConfig", record)
        args = cli_module.build_parser().parse_args(argv)
        with pytest.raises(_Picked) as got:
            args.fn(args)
    return got.value.args[0]


@pytest.fixture(scope="module")
def command_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("precision_cli")
    from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
    from a3gc_tpu_torch.smpl import write_synthetic_smpl_pickle
    packed = synthetic_packed_dataset(4, 16)
    np.savez(d / "train.npz", **packed)
    np.savez(d / "test.npz", **{
        f"seq{i}_{k}": v for i, s in enumerate(eval_sequences([20], seed=3))
        for k, v in s.items()})
    smpl = write_synthetic_smpl_pickle(str(d / "smpl.pkl"), n_vertices=48)
    return d, smpl


COMMANDS = {
    "train": ["train", "-b", "2", "--train_data", "{d}/train.npz",
              "--valid_data", "{d}/train.npz", "--save_root", "{d}/runs"],
    "evaluate": ["evaluate", "--datasets", "{d}/test.npz"],
    "stream": ["stream", "--input", "{d}/test.npz", "--output",
               "{d}/out.npz"],
    "export": ["export", "--output", "{d}/art"],
    "serve": ["serve", "--port", "0"],
}
JAX_DEFAULT = {"train": "highest", "evaluate": "default",
               "stream": "default", "export": "default", "serve": "default"}


@pytest.mark.parametrize("given", [None, "highest", "default"])
@pytest.mark.parametrize("model", ["a3gc", "dip"])
@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_torch_port_cli_precision_matches_jax_cli(command, model, given,
                                                  command_files,
                                                  monkeypatch):
    r"""Each command, run in both CLIs until it builds a net config: the
    same precision, JAX's per-command default when ``--precision`` is not
    given (``a3gc_tpu/cli.py`` ``_stage_configs`` callers and
    ``_load_dip``), the flag when it is."""
    d, smpl = command_files
    argv = [a.format(d=d) for a in COMMANDS[command]]
    argv += ["--model", model, "--smpl", smpl, "--hu1", "8", "--hu2", "8",
             "--hu3", "8"]
    if model == "dip" and command != "train":
        argv += ["--torch_checkpoints", str(d / "missing.tar")]
    argv += [] if given is None else ["--precision", given]
    monkeypatch.delenv("A3GC_DATA_ROOT", raising=False)
    monkeypatch.chdir(d)
    from a3gc_tpu_torch.models import nets as TNETS
    want = _picked_precision(monkeypatch, JN, JCLI, argv)
    got = _picked_precision(monkeypatch, TNETS, TCLI,
                            argv + ["--device", "cpu"])
    assert got == want == (given or JAX_DEFAULT[command])


# -- the cascades on the CPU --------------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


def _at(tcfg, precision):
    import dataclasses
    return TPL.CascadeConfig(*(
        dataclasses.replace(s, net=dataclasses.replace(s.net,
                                                       precision=precision))
        for s in tcfg.stages))


@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp"])
def test_torch_port_cpu_default_is_highest_bit_for_bit(kind, jax_model):
    r"""On the CPU "default" is fp32: the cascade's poses at "default" are
    the "highest" ones bit for bit, and within the fp32 tolerance of JAX's
    cascade at "default" (fp32 on the CPU too)."""
    import dataclasses
    jcfg, tcfg, params = cascades(kind, hidden=8, seed=20)
    B, T = 2, 8
    rng = np.random.default_rng(30)
    shape = (B, T, 72) if kind == "tp" else (B, T, N, 12)
    imu = rng.normal(size=shape).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0.0
    p3 = cascade_params_from_jax(params, device="cpu")
    outs = {prec: TPL.cascade_apply(p3, _at(tcfg, prec), ParametricModel(),
                                    imu, frame_mask=mask,
                                    device="cpu").numpy()
            for prec in ("highest", "default")}
    np.testing.assert_array_equal(outs["default"], outs["highest"])
    jdef = JPL.CascadeConfig(*(
        dataclasses.replace(s, net=s.net.replace(precision="default"))
        for s in (jcfg.stage1, jcfg.stage2, jcfg.stage3)))
    ref = np.asarray(JPL.cascade_apply(to_jnp(params), jdef, jax_model,
                                       jnp.asarray(imu),
                                       frame_mask=jnp.asarray(mask)))
    valid = mask.reshape(-1) > 0
    np.testing.assert_allclose(outs["default"][valid], ref[valid], atol=TOL)


# -- the plain versions with TF32 operands ------------------------------------

def _delta(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _assert_tf32(tf32, fp32, ref):
    r"""The TF32 plain version differs from the fp32 one and stays within
    TF32_TOL of JAX's fp32 function; the fp32 one within TOL."""
    for t, f, r in zip(tf32, fp32, ref):
        assert _delta(f, r) <= TOL
        assert 0.0 < _delta(t, f)
        assert _delta(t, r) <= TF32_TOL, _delta(t, r)


@pytest.mark.parametrize("cell", ["a3gc", "aagc"])
def test_torch_port_gcn_lstm_plain_tf32_near_jax(cell):
    S, T, F, H = 3, 8, 12, 8
    params = jax_cell_params2(cell, F, H, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(S, T, N, F)).astype(np.float32)
    h = (0.5 * rng.normal(size=(2, S, N, H))).astype(np.float32)
    c = (0.5 * rng.normal(size=(2, S, N, H))).astype(np.float32)
    nv = np.array([T, T - 2, 0], np.int32)
    ref_y, (ref_h, ref_c) = bi_gcn_lstm_pallas(
        to_jnp(params), x, (h, c), n_valid=nv, interpret=True,
        precision=jax.lax.Precision.HIGHEST)
    p = cell_params_from_jax(params, device="cpu")
    args = (torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)),
            torch.as_tensor(nv))
    with torch.no_grad():
        outs = {fmt: G.bi_gcn_lstm_reference(p, *args, fmt=fmt)
                for fmt in ("fp32", "tf32")}
        wrapped = G.bi_gcn_lstm(p, *args, fmt="tf32")   # the op, on the CPU
    flat = {fmt: (y, hc[0], hc[1]) for fmt, (y, hc) in outs.items()}
    _assert_tf32(flat["tf32"], flat["fp32"], (ref_y, ref_h, ref_c))
    for a, b in zip((wrapped[0], *wrapped[1]), flat["tf32"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the idle stream's state passes through untouched at either format
    np.testing.assert_array_equal(flat["tf32"][1][:, 2].numpy(), h[:, 2])


def test_torch_port_ggru_plain_tf32_near_jax():
    from test_torch_port_ggru import jax_ggru_params2
    S, T, H = 3, 12, 8
    params = jax_ggru_params2(2 * H, H, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(S, T, N, 2 * H)).astype(np.float32)
    h = (0.5 * rng.normal(size=(2, S, N, H))).astype(np.float32)
    nv = np.array([12, 5, 0], np.int32)
    ref_y, ref_h = bi_ggru_pallas(to_jnp(params), x, h, n_valid=nv,
                                  interpret=True,
                                  precision=jax.lax.Precision.HIGHEST)
    p = cell_params_from_jax(params, device="cpu")
    with torch.no_grad():
        outs = {fmt: GG.bi_ggru_reference(p, torch.from_numpy(x),
                                          torch.from_numpy(h),
                                          torch.as_tensor(nv), fmt=fmt)
                for fmt in ("fp32", "tf32")}
    _assert_tf32(outs["tf32"], outs["fp32"], (ref_y, ref_h))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_torch_port_lstm_plain_tf32_near_jax(bidirectional):
    from a3gc_tpu.ops.pallas_gcn_lstm import lstm_scan_pallas
    S, T, H = 2, 9, 16
    _, params = jax_dip(12, 6, H, seed=1, bidirectional=bidirectional)
    layer = params.lstm[1]
    D = 2 if bidirectional else 1
    rng = np.random.default_rng(2)
    x = rng.normal(size=(S, T, D * H)).astype(np.float32)
    shape = (2, S, H) if bidirectional else (S, H)
    h, c = ((0.5 * rng.normal(size=shape)).astype(np.float32)
            for _ in range(2))
    hi = jax.lax.Precision.HIGHEST
    if bidirectional:
        ref_y, (ref_h, ref_c) = bi_lstm_pallas(
            to_jnp(layer), x, (h, c), n_valid=np.int32(6), interpret=True,
            precision=hi)
    else:
        u = (np.einsum("btf,fg->tbg", x, layer.w_ih) + layer.b_ih
             + layer.b_hh).astype(np.float32)
        ref_y, (ref_h, ref_c) = lstm_scan_pallas(
            jnp.asarray(layer.w_hh), jnp.asarray(u), jnp.asarray(h),
            jnp.asarray(c), n_valid=np.int32(6), interpret=True,
            precision=hi)
        ref_y = np.swapaxes(np.asarray(ref_y), 0, 1)
    p = lstm_layer_params_from_jax(layer, device="cpu")
    with torch.no_grad():
        outs = {fmt: LS.bi_lstm_reference(
            p, torch.from_numpy(x), (torch.from_numpy(h),
                                     torch.from_numpy(c)), 6, fmt=fmt)
            for fmt in ("fp32", "tf32")}
    flat = {fmt: (y, hc[0], hc[1]) for fmt, (y, hc) in outs.items()}
    _assert_tf32(flat["tf32"], flat["fp32"], (ref_y, ref_h, ref_c))


# -- training through the rounding --------------------------------------------

def _as_on_a_card(precision, device):
    r"""``operand_format`` with the CPU standing in for a card: "default"
    gives TF32 operands."""
    CM.check_precision(precision)
    return "tf32" if precision == "default" else "fp32"


@pytest.mark.parametrize("model", ["a3gc", "dip"])
def test_torch_port_cli_train_default_takes_a_tf32_step(model, tmp_path,
                                                        monkeypatch):
    r"""``cli train --precision default`` with TF32 operands (the CPU made
    to resolve "default" as a card does): every parameter's gradient of
    the first step is finite and the step moves the net, through the
    straight-through rounding; the same step at "highest" has other
    gradients (the rounding acts)."""
    from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
    monkeypatch.setattr(TN, "operand_format", _as_on_a_card)
    monkeypatch.delenv("A3GC_DATA_ROOT", raising=False)
    np.savez(tmp_path / "train.npz", **synthetic_packed_dataset(4, 16))
    grads = {}

    def recording(step):
        def wrapped(self, *args, **kwargs):
            if self not in grads:
                grads[self] = [p.grad.clone() for g in self.param_groups
                               for p in g["params"] if p.grad is not None]
            return step(self, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch.optim.Adam, "step",
                        recording(torch.optim.Adam.step))
    firsts = {}
    for precision in ("default", "highest"):
        grads.clear()
        TCLI.main(["train", "--device", "cpu", "--model", model, "-b", "4",
                   "--epochs", "1", "--hu1", "8", "--hu2", "8", "--hu3", "8",
                   "--precision", precision, "--train_data",
                   str(tmp_path / "train.npz"), "--valid_data",
                   str(tmp_path / "train.npz"), "--name", precision,
                   "--save_root", str(tmp_path / "runs")])
        first = next(iter(grads.values()))
        assert first and all(torch.isfinite(g).all() for g in first)
        assert sum(float(g.abs().sum()) for g in first) > 0.0
        firsts[precision] = first
    assert any(not torch.equal(a, b)
               for a, b in zip(firsts["default"], firsts["highest"]))


def test_torch_port_kernel_op_backward_at_tf32():
    r"""The ops' gradients rerun the plain version at the op's format: at
    "tf32" finite, and not the fp32 ones."""
    S, T, F, H = 2, 6, 12, 8
    params = jax_cell_params2("a3gc", F, H, seed=3)
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(S, T, N, F)).astype(np.float32)
    st = tuple(torch.from_numpy((0.5 * rng.normal(size=(2, S, N, H)))
                                .astype(np.float32)) for _ in range(2))
    got = {}
    for fmt in ("fp32", "tf32"):
        p = cell_params_from_jax(params, device="cpu")
        x = torch.from_numpy(x0).requires_grad_()
        y, (h, c) = G.bi_gcn_lstm(p, x, st, torch.tensor([T, 4]), fmt=fmt)
        (y.square().sum() + h.sum()).backward()
        got[fmt] = [x.grad] + [q.grad for q in p.parameters()]
        assert all(g is not None and torch.isfinite(g).all()
                   for g in got[fmt])
    assert any(not torch.equal(a, b) for a, b in zip(got["fp32"],
                                                     got["tf32"]))


# -- the card's check of a TF32 kernel, on the CPU ---------------------------

# chip_smoke.py PREC_SEP_FRAME / PREC_SEP_WINDOW: a kernel's TF32
# instantiation is held to its plain version at "tf32" by
# rms(kernel - plain) <= bound · rms(plain at "fp32" - plain at "tf32").
# Here the plain version with its products summed in another order (in
# float64, then rounded to fp32, as a kernel's FMA order differs from
# torch.matmul's) stands in for a right kernel; a wrong one must fail.
# Measured at these sizes (H = 32, S = 4): the right one 0.0003-0.0032 of
# the gap over one frame and 0.016-0.17 over 30 frames; the fp32 version
# 1.00, outputs from the rounded h 1.85 / 1.47, the folded G-GRU order 0.39
# over one frame (0.37-0.39 at H = 64-256, S = 8 and the card's seeds).
SEP_FRAME, SEP_WINDOW = 0.15, 0.5


@contextlib.contextmanager
def _sums_reordered():
    mm, es = torch.matmul, torch.einsum
    torch.matmul = lambda a, b: mm(a.double(), b.double()).float()
    torch.einsum = lambda eq, *ops: es(eq, *(o.double() for o in ops)).float()
    try:
        yield
    finally:
        torch.matmul, torch.einsum = mm, es


def _check_layer(name, T, H=32, S=4):
    r"""(plain version, args) of one layer call at the initial weights (the
    card's cases'), inputs from numpy seeds, an idle stream."""
    from a3gc_tpu_torch.data import load_adjacency_template
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(8)
    nira = load_adjacency_template()
    nv = torch.as_tensor([T, max(T - 7, 1), 0, T][:S], dtype=torch.int32)

    def state(*shape):
        return torch.from_numpy((0.5 * rng.normal(size=shape))
                                .astype(np.float32))

    if name == "lstm":
        b = 1.0 / H ** 0.5
        p = TL.stack_directions(*(TN.LSTMLayerParams(*(
            torch.rand(shape, generator=gen) * 2 * b - b
            for shape in ((H, 4 * H), (H, 4 * H), (4 * H,), (4 * H,))))
            for _ in range(2)))
        x = rng.normal(size=(S, T, H)).astype(np.float32)
        return LS.bi_lstm_reference, (p, torch.from_numpy(x),
                                      (state(2, S, H), state(2, S, H)), nv)
    if name == "ggru":
        p = TL.stack_directions(*(TC.init_ggru_cell(gen, H, H, nira)
                                  for _ in range(2)))
        st, fn = state(2, S, N, H), GG.bi_ggru_reference
    else:
        p = TL.stack_directions(*(TC.init_gcn_lstm_cell(
            gen, H, H, nira, attention=True) for _ in range(2)))
        st, fn = (state(2, S, N, H), state(2, S, N, H)), \
            G.bi_gcn_lstm_reference
    x = rng.normal(size=(S, T, N, H)).astype(np.float32)
    return fn, (p, torch.from_numpy(x), st, nv)


def _flat(out):
    y, st = out
    return [y] + (list(st) if isinstance(st, tuple) else [st])


def _rms(a, b):
    d = [(x.double() - y.double()) for x, y in zip(a, b)]
    return (sum(float(t.square().sum()) for t in d)
            / sum(t.numel() for t in d)) ** 0.5


def _folded_ggru(zi, gk, adj, w_hid, h0, n_valid):
    r"""The fp32 ``ggru.cu``'s order zh = (adj·h)·(G·W_hid) in plain
    PyTorch with TF32 operands (adj and h, G and W_hid, then adj·h and the
    folded W): (y, h)."""
    r = CM.round_tf32
    _, S, T, _, G3 = zi.shape
    H = G3 // 3
    w = torch.matmul(r(gk), r(w_hid))
    y = torch.zeros(S, T, N, 2 * H)
    hs = []
    for d in range(2):
        h = h0[d]
        for f in (range(T) if d == 0 else range(T - 1, -1, -1)):
            ah = torch.einsum("nm,smh->snh", r(adj[d]), r(h))
            zh = torch.matmul(r(ah), r(w[d]))
            z = zi[d, :, f]
            rg = torch.sigmoid(z[..., :H] + zh[..., :H])
            ug = torch.sigmoid(z[..., H:2 * H] + zh[..., H:2 * H])
            cand = torch.tanh(z[..., 2 * H:] + rg * zh[..., 2 * H:])
            live = (f < n_valid)[:, None, None]
            h = torch.where(live, ug * h + (1.0 - ug) * cand, h)
            y[:, f, :, d * H:(d + 1) * H] = h
        hs.append(h)
    return y, torch.stack(hs)


@pytest.mark.parametrize("T,bound", [(1, SEP_FRAME), (30, SEP_WINDOW)])
@pytest.mark.parametrize("name", ["gcn_lstm", "ggru", "lstm"])
def test_torch_port_tf32_check_passes_reordered_sums(name, T, bound):
    """Sums in another order, every operand rounded where the plain version
    rounds it: within the bound, over one frame and over a window."""
    fn, args = _check_layer(name, T)
    with torch.no_grad():
        want = _flat(fn(*args, fmt="tf32"))
        gap = _rms(_flat(fn(*args, fmt="fp32")), want)
        with _sums_reordered():
            got = _flat(fn(*args, fmt="tf32"))
    assert gap > 0.0
    assert _rms(got, want) <= bound * gap, _rms(got, want) / gap


@pytest.mark.parametrize("wrong,T,bound", [
    ("fp32", 1, SEP_FRAME), ("fp32", 30, SEP_WINDOW),
    ("outputs_rounded", 1, SEP_FRAME), ("outputs_rounded", 30, SEP_WINDOW),
    ("folded_ggru", 1, SEP_FRAME)])
def test_torch_port_tf32_check_refuses_wrong_kernels(wrong, T, bound):
    """What a wrong TF32 kernel computes fails the bound: the fp32 kernel in
    its place (the control of every card check), a kernel that writes y
    and its final state from the rounded h, and ``ggru.cu``'s fp32 order
    (adj·h)·(G·W_hid) with TF32 operands, which is why its TF32
    instantiation keeps the cell's order. Rounding points in the wrong
    places show over one frame: over 30 frames the recurrence draws the
    folded order to 0.26 of the gap, under SEP_WINDOW."""
    fn, args = _check_layer("ggru" if wrong == "folded_ggru" else "gcn_lstm",
                            T)
    with torch.no_grad():
        want = _flat(fn(*args, fmt="tf32"))
        gap = _rms(_flat(fn(*args, fmt="fp32")), want)
        with _sums_reordered():
            if wrong == "fp32":
                got = _flat(fn(*args, fmt="fp32"))
            elif wrong == "outputs_rounded":
                got = [CM.round_tf32(t) for t in _flat(fn(*args, fmt="tf32"))]
            else:
                got = list(_folded_ggru(*GG.scan_inputs(*args, "tf32")[:5],
                                        args[3]))
    assert _rms(got, want) > bound * gap, _rms(got, want) / gap


# -- the ops and the artifacts ----------------------------------------------

def _op_args(name):
    r = lambda *shape: torch.randn(*shape, generator=torch.Generator()
                                   .manual_seed(len(shape)))
    S, T, N_, H = 2, 3, 4, 8
    nv = torch.tensor([T, 1], dtype=torch.int32)
    if name == "gcn_lstm_scan":
        return (r(2, S, T, N_, 4 * H), r(2, H, 4 * H), r(2, 4, N_, N_),
                r(2, 4, H), r(2, H, H), r(2, H, H), r(2, H, H), r(2, H),
                r(2, H), r(2, N_), r(2, S, N_, H), r(2, S, N_, H), nv)
    if name == "ggru_scan":
        return (r(2, S, T, N_, 3 * H), r(2, H, H), r(2, N_, N_),
                r(2, H, 3 * H), r(2, S, N_, H), nv)
    return r(2, S, T, 4 * H), r(2, H, 4 * H), r(2, S, H), r(2, S, H), nv


@pytest.mark.parametrize("name", ["gcn_lstm_scan", "ggru_scan",
                                  "lstm_scan"])
def test_torch_port_ops_take_the_tf32_flag(name):
    r"""Each op with ``tf32=True`` passes ``opcheck`` (schema, fake, the
    autograd formula at the flag), computes the plain version with TF32
    operands, and without the flag keeps its fp32 meaning."""
    op = getattr(torch.ops.a3gc_tpu_torch, name).default
    args = _op_args(name)
    torch.library.opcheck(op, args + (True,))
    plain = {"gcn_lstm_scan": _gcn_lstm_plain,
             "ggru_scan": GG.scan_reference,
             "lstm_scan": LS.scan_reference}[name]
    for flag in (False, True):
        for a, b in zip(op(*args, flag), plain(*args, flag)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(op(*args), plain(*args, False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(not torch.equal(a, b)
               for a, b in zip(op(*args, True), op(*args, False)))


def _scan_flags(exported):
    return [node.args[-1] if len(node.args) == 14 else False
            for node in exported.graph.nodes
            if node.op == "call_function"
            and "gcn_lstm_scan" in str(node.target)]


def test_torch_port_artifact_bakes_the_format(monkeypatch, tmp_path):
    r"""A window step exported at "default" where it resolves to TF32 (the
    CPU standing in for a card) holds ``tf32=True`` in each of its six op
    nodes, and its loaded program steps as the live session does; at
    "highest" every node keeps ``tf32`` False."""
    from a3gc_tpu_torch import export as TX
    from a3gc_tpu_torch.data import load_stats
    from a3gc_tpu_torch.eval.streaming import StreamingCascade
    monkeypatch.setattr(TN, "operand_format", _as_on_a_card)
    _, tcfg, params = cascades("a3gc", hidden=8, seed=20)
    p3 = cascade_params_from_jax(params, device="cpu")
    S, W = 2, 6
    flags = {}
    for precision in ("highest", "default"):
        cfg = _at(tcfg, precision)
        ep, manifest = TX.export_streaming_cascade(
            p3, cfg, ParametricModel(), window=W, streams=S,
            stats=load_stats(), normalize=True)
        flags[precision] = _scan_flags(ep)
        if precision == "default":
            d = str(tmp_path / "art")
            TX.save_exported(d, ep, manifest)
            art = TX.ArtifactSession(TX.load_exported(d, device="cpu"))
            live = StreamingCascade(p3, cfg, ParametricModel(), window=W,
                                    stats=load_stats(), normalize=True,
                                    streams=S, device="cpu")
            rng = np.random.default_rng(9)
            for _ in range(2):
                ori = rng.normal(size=(S, W, 54)).astype(np.float32)
                acc = rng.normal(size=(S, W, 18)).astype(np.float32)
                np.testing.assert_allclose(art.step(ori, acc),
                                           live.step(ori, acc), atol=TOL)
    assert flags == {"highest": [False] * 6, "default": [True] * 6}
