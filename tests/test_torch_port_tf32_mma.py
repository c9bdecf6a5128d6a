"""The order of sums of the kernels' tensor-core TF32 paths, emulated in
float32 on the CPU and held to the plain versions at "tf32" by the check
the card applies (``chip_smoke.py`` ``compare_formats``).

``gcn_lstm.cu``, ``ggru.cu`` and ``lstm.cu`` at "tf32" compute their
products with
``mma.sync.m16n8k8`` on operands rounded exactly where the plain version
rounds them. A product of two TF32 values is exact in fp32, so what changes
against the FMA loops is the order of the fp32 sums: k in 16-deep blocks,
each block two 8-term steps (the lanes' k renumbered: 4t, 4t + 1 in step 0,
4t + 2, 4t + 3 in step 1) added into two accumulators that are summed at
the end; hy·Wh over ``att_split`` k parts added in order; the graph mix as
two 8-node steps into one accumulator; ``lstm.cu``'s h·W_hh over its plan's
KS k parts (one a group of warps), added in order, part 0 first. The emulation below runs those
frames (the 8 products of a step summed in float64, then added into the
fp32 accumulator) and must stay within PREC_SEP_FRAME / PREC_SEP_WINDOW of
the gap between the formats, over one frame and over a window; the same
emulation without the rounding (what an fp32 kernel on the same loop
order computes) is the control and must exceed the bound. Card runs of the
kernels themselves: ``tests/test_torch_port_card.py``."""

import numpy as np
import pytest
import torch

from a3gc_tpu_torch.data import load_adjacency_template
from a3gc_tpu_torch.models import cells as TC
from a3gc_tpu_torch.models import layers as TL
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.ops import _common as CM
from a3gc_tpu_torch.ops import gcn_lstm as G
from a3gc_tpu_torch.ops import ggru as GG
from a3gc_tpu_torch.ops import lstm as LS

SEP_FRAME, SEP_WINDOW = 0.15, 0.5      # chip_smoke.py PREC_SEP_*
N = 15


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _steps(k0):
    """The two 8-term steps of the 16-deep k-block at k0."""
    return ([k0 + 4 * t + j for t in range(4) for j in (0, 1)],
            [k0 + 4 * t + j for t in range(4) for j in (2, 3)])


def _add(acc, a, b, ks):
    """acc + Σ_{k ∈ ks} a[..., k]·b[k]: the step's products summed in
    float64 (one step of the tensor core), added into fp32."""
    return (acc.double() + a[..., ks].double() @ b[ks].double()).float()


def _mma(a, b, parts=1):
    r"""a [..., 16, K] · b [K, n] in the kernels' tensor-core order: the k
    range in ``parts`` consecutive parts, each over its 16-deep blocks into
    two accumulators (step 0, step 1), summed; the parts added in order."""
    K = a.shape[-1]
    per = K // 16 // parts
    total = torch.zeros(a.shape[:-1] + b.shape[1:])
    for p in range(parts):
        d = torch.zeros_like(total)
        e = torch.zeros_like(total)
        for blk in range(p * per, (p + 1) * per):
            s0, s1 = _steps(16 * blk)
            d = _add(d, a, b, s0)
            e = _add(e, a, b, s1)
        total = total + (d + e)
    return total


def _mix(adj, z):
    r"""adj [16, 16] (zero past N) · z [..., 16, n] as two 8-node steps into
    one accumulator."""
    out = torch.zeros(z.shape)
    for ks in (list(range(8)), list(range(8, 16))):
        out = (out.double() + adj[:, ks].double() @ z[..., ks, :].double()
               ).float()
    return out


def _pad16(t, dim):
    """Zero rows (dim -2) or columns (-1) up to 16."""
    pad = [0, 0, 0, 0]
    pad[1 if dim == -1 else 3] = 16 - t.shape[dim]
    return torch.nn.functional.pad(t, pad)


def _gcn_lstm_emulated(u, wh, adj, bias, att, h0, c0, n_valid, tf32=True):
    r"""``gcn_lstm.cu``'s tensor-core TF32 frames (A3GC cell) on the hoisted
    inputs, in the order of the plan the kernel takes at S streams: (y, h,
    c)."""
    r = CM.round_tf32 if tf32 else (lambda t: t)
    _, S, T, _, G4 = u.shape
    H = G4 // 4
    Hc = H // G.launch_plan(N, H, True, tf32=True, S=S).C
    parts = G.att_split(H, Hc)
    w, wq, wh_att, u_att, bs, bu = att
    y = torch.zeros(S, T, N, 2 * H)
    hs, cs = [], []
    for d in range(2):
        h, c = _pad16(h0[d], -2), c0[d]              # [S, 16, H]
        A = [_pad16(_pad16(r(adj[d, g]), -2), -1) for g in range(4)]
        for f in (range(T) if d == 0 else range(T - 1, -1, -1)):
            z = _mma(r(h), r(wh[d]))[:, :N] + u[d, :, f]
            z = _pad16(r(z), -2)
            pre = torch.cat([_mix(A[g], z[..., g * H:(g + 1) * H])
                             for g in range(4)], -1)[:, :N]
            pre = pre + bias[d].reshape(-1)
            i, fg, gg, o = (pre[..., k * H:(k + 1) * H] for k in range(4))
            cn = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(gg)
            hy = torch.sigmoid(o) * torch.tanh(cn)
            hsum = torch.zeros(S, H)
            for n in range(N):
                hsum = hsum + r(hy[:, n])
            q = r(torch.relu(hsum @ r(w[d])))
            hw = _mma(r(_pad16(hy, -2)), r(wh_att[d]), parts)[:, :N]
            s = r(torch.tanh(hw + (q @ r(wq[d]))[:, None] + bs[d]))
            a = s @ r(u_att[d]) + bu[d]
            hn = hy + hy * torch.sigmoid(a)[..., None]
            live = (f < n_valid)[:, None, None]
            h = torch.where(live, _pad16(hn, -2), h)
            c = torch.where(live, cn, c)
            y[:, f, :, d * H:(d + 1) * H] = torch.tanh(h[:, :N])
        hs.append(h[:, :N])
        cs.append(c)
    return y, torch.stack(hs), torch.stack(cs)


def _ggru_emulated(zi, gk, adj, w_hid, h0, n_valid, tf32=True):
    r"""``ggru.cu``'s tensor-core TF32 frames (hg = h·G, msg =
    round(adj)·round(hg), zh = msg·W_hid; the same sums whether G's columns
    are all resident or split over the cluster): (y, h)."""
    r = CM.round_tf32 if tf32 else (lambda t: t)
    _, S, T, _, G3 = zi.shape
    H = G3 // 3
    y = torch.zeros(S, T, N, 2 * H)
    hs = []
    for d in range(2):
        h = h0[d]
        A = _pad16(_pad16(r(adj[d]), -2), -1)
        for f in (range(T) if d == 0 else range(T - 1, -1, -1)):
            hg = _mma(r(_pad16(h, -2)), r(gk[d]))
            msg = r(_mix(A, r(hg)))
            zh = _mma(msg, r(w_hid[d]))[:, :N]
            z = zi[d, :, f]
            rg = torch.sigmoid(z[..., :H] + zh[..., :H])
            ug = torch.sigmoid(z[..., H:2 * H] + zh[..., H:2 * H])
            cand = torch.tanh(z[..., 2 * H:] + rg * zh[..., 2 * H:])
            live = (f < n_valid)[:, None, None]
            h = torch.where(live, ug * h + (1.0 - ug) * cand, h)
            y[:, f, :, d * H:(d + 1) * H] = h
        hs.append(h)
    return y, torch.stack(hs)


def _layer(name, H, T, S=2):
    r"""(module, (params, x, state, n_valid)) of one layer call at the
    initial weights (nonzero G-LSTM biases), inputs from numpy seeds, ragged
    n_valid."""
    gen = torch.Generator().manual_seed(H + T)
    rng = np.random.default_rng(H + T)
    nira = load_adjacency_template()
    nv = torch.as_tensor([T if i % 2 == 0 else max(T - 7, 1)
                          for i in range(S)], dtype=torch.int32)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32))

    x = normal(S, T, N, H)
    if name == "ggru":
        p = TL.stack_directions(*(TC.init_ggru_cell(gen, H, H, nira)
                                  for _ in range(2)))
        return GG, (p, x, normal(2, S, N, H, scale=0.5), nv)
    p = TL.stack_directions(*(TC.init_gcn_lstm_cell(gen, H, H, nira,
                                                    attention=True)
                              for _ in range(2)))
    with torch.no_grad():
        for t in (p.bias, p.attention.bs, p.attention.bu):
            t.add_(normal(*t.shape, scale=0.1))
    st = (normal(2, S, N, H, scale=0.5), normal(2, S, N, H, scale=0.5))
    return G, (p, x, st, nv)


def _outputs(out):
    y, st = out
    return [y] + (list(st) if isinstance(st, tuple) else [st])


def _rms(a, b):
    d = [(x.double() - y.double()) for x, y in zip(a, b)]
    return (sum(float(t.square().sum()) for t in d)
            / sum(t.numel() for t in d)) ** 0.5


@pytest.mark.parametrize("T,bound", [(1, SEP_FRAME), (60, SEP_WINDOW)])
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("name", ["gcn_lstm", "ggru"])
def test_torch_port_tf32_mma_order_within_bound(name, H, T, bound):
    """The tensor-core frame's order of sums at "tf32", behind the layer's
    hoisted input projection at "tf32": nearer the plain version at "tf32"
    than the bound, a fraction of the gap between the plain version at
    "fp32" and at "tf32" (``compare_formats``), over one frame and over a
    window; the same frames at "fp32" (hoist and products unrounded: the
    fp32 kernel in the TF32 one's place) exceed it."""
    mod, args = _layer(name, H, T)
    emulated = _gcn_lstm_emulated if name == "gcn_lstm" else _ggru_emulated
    plain = getattr(mod, f"bi_{name}_reference")
    with torch.no_grad():
        want = _outputs(plain(*args, fmt="tf32"))
        gap = _rms(_outputs(plain(*args, fmt="fp32")), want)
        got = list(emulated(*mod.scan_inputs(*args, "tf32")))
        control = list(emulated(*mod.scan_inputs(*args, "fp32"), tf32=False))
    assert gap > 0.0
    assert all(torch.isfinite(t).all() for t in got)
    assert _rms(got, want) <= bound * gap, _rms(got, want) / gap
    assert _rms(control, want) > bound * gap, _rms(control, want) / gap


@pytest.mark.parametrize("H", [64, 128, 256])
def test_torch_port_tf32_mma_blocks_cover_k(H):
    """The renumbered steps of every 16-deep block take each k once, and
    the hy·Wh parts of the serving plans split the blocks evenly, at most
    8 a warp (the registers that hold Wh's fragments)."""
    ks = sorted(k for blk in range(H // 16) for step in _steps(16 * blk)
                for k in step)
    assert ks == list(range(H))
    for S in (8, 1):                   # the serving and one-stream plans
        plan = G.launch_plan(N, H, True, tf32=True, S=S)
        Hc = H // plan.C
        parts = G.att_split(H, Hc)
        assert plan.mma == 1 and (H // 16) % parts == 0
        assert H // 16 // parts <= 8 and Hc // 8 * parts <= 8


@pytest.mark.parametrize("T,bound", [(1, SEP_FRAME), (60, SEP_WINDOW)])
@pytest.mark.parametrize("H", [128, 256])
def test_torch_port_tf32_mma_wide_plan_order_within_bound(H, T, bound):
    """The same check at one stream, whose plan spreads a direction over
    twice the CTAs (C = 8 at H = 128, 16 at 256): hy·Wh over more k parts
    (``att_split`` of the narrower slice)."""
    mod, args = _layer("gcn_lstm", H, T, S=1)
    assert G.att_split(H, H // G.launch_plan(N, H, True, tf32=True, S=1).C) \
        > G.att_split(H, H // G.launch_plan(N, H, True, tf32=True).C)
    with torch.no_grad():
        want = _outputs(mod.bi_gcn_lstm_reference(*args, fmt="tf32"))
        gap = _rms(_outputs(mod.bi_gcn_lstm_reference(*args, fmt="fp32")),
                   want)
        got = list(_gcn_lstm_emulated(*mod.scan_inputs(*args, "tf32")))
        control = list(_gcn_lstm_emulated(*mod.scan_inputs(*args, "fp32"),
                                          tf32=False))
    assert gap > 0.0
    assert all(torch.isfinite(t).all() for t in got)
    assert _rms(got, want) <= bound * gap, _rms(got, want) / gap
    assert _rms(control, want) > bound * gap, _rms(control, want) / gap


def _lstm_emulated(u, w_hh, h0, c0, n_valid, parts, tf32=True):
    r"""``lstm.cu``'s tensor-core TF32 frames on the hoisted inputs: z = u
    + h·W_hh in the kernel's order over ``parts`` k parts, the cell, h
    rounded where it is written for the next product: (y, h, c)."""
    r = CM.round_tf32 if tf32 else (lambda t: t)
    D, S, T, G4 = u.shape
    H = G4 // 4
    y = torch.zeros(S, T, D * H)
    hs, cs = [], []
    for d in range(D):
        h, c, w = h0[d], c0[d], r(w_hh[d])
        for f in (range(T) if d == 0 else range(T - 1, -1, -1)):
            z = u[d, :, f] + _mma(r(h), w, parts)
            i, fg, g, o = (z[:, k * H:(k + 1) * H] for k in range(4))
            cn = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(g)
            hn = torch.sigmoid(o) * torch.tanh(cn)
            live = (f < n_valid)[:, None]
            h = torch.where(live, hn, h)
            c = torch.where(live, cn, c)
            y[:, f, d * H:(d + 1) * H] = h
        hs.append(h)
        cs.append(c)
    return y, torch.stack(hs), torch.stack(cs)


def _lstm_layer(H, T, D, S=2):
    r"""(params, x, state, n_valid) of one dense layer call, F = H: the
    init's uniform weights (±1/√H), inputs from a numpy seed, ragged
    n_valid."""
    rng = np.random.default_rng(3 * H + T + D)

    def arr(a):
        return torch.from_numpy(a.astype(np.float32))

    def one():
        b = 1.0 / H ** 0.5
        return TN.LSTMLayerParams(*(arr(rng.uniform(-b, b, size=shape))
                                    for shape in ((H, 4 * H), (H, 4 * H),
                                                  (4 * H,), (4 * H,))))

    p = TL.stack_directions(one(), one()) if D == 2 else one()
    lead = (2,) if D == 2 else ()
    st = tuple(arr(0.5 * rng.normal(size=lead + (S, H))) for _ in range(2))
    nv = torch.as_tensor([T if i % 2 == 0 else max(T - 7, 1)
                          for i in range(S)], dtype=torch.int32)
    return p, arr(rng.normal(size=(S, T, H))), st, nv


@pytest.mark.parametrize("T,bound", [(1, SEP_FRAME), (60, SEP_WINDOW)])
@pytest.mark.parametrize("D", [2, 1])
@pytest.mark.parametrize("H", [64, 128, 256, 512])
def test_torch_port_tf32_mma_lstm_order_within_bound(H, D, T, bound):
    """``lstm.cu``'s tensor-core frame at the TF32 plan of each dense
    serving width (its k parts as the plan splits k over the warps),
    behind the hoisted input projection at "tf32": nearer the plain
    version at "tf32" than the bound, a fraction of the formats' gap; the
    same order at "fp32" (the control) exceeds it."""
    plan = LS.launch_plan(2, H, 132, D=D, tf32=True)
    assert plan.mma == 1
    args = _lstm_layer(H, T, D)
    with torch.no_grad():
        want = _outputs(LS.bi_lstm_reference(*args, fmt="tf32"))
        gap = _rms(_outputs(LS.bi_lstm_reference(*args, fmt="fp32")), want)
        got, control = ([t.reshape(w.shape) for t, w in zip(_lstm_emulated(
            *LS.scan_inputs(*args, fmt), plan.KS, tf32=fmt == "tf32"), want)]
            for fmt in ("tf32", "fp32"))
    assert gap > 0.0
    assert all(torch.isfinite(t).all() for t in got)
    assert _rms(got, want) <= bound * gap, _rms(got, want) / gap
    assert _rms(control, want) > bound * gap, _rms(control, want) / gap


@pytest.mark.parametrize("H", [64, 128, 256, 512])
def test_torch_port_tf32_mma_lstm_split_covers_k(H):
    """The TF32 plan's k parts split the 16-deep blocks evenly over the
    warps' A fragments (4 or 16 blocks a warp: at most 128 registers), and
    the warps of a part, one tile each, cover the CTA's gate columns."""
    plan = LS.launch_plan(8, H, 132, tf32=True)
    KS, NKB = LS.mma_split(H, plan.P)
    M = 4 * H // plan.P
    assert plan.KS == KS and KS * NKB == H // 16
    assert NKB in (4, 16)
    tiles = {w % (8 // KS) for w in range(8)}
    assert tiles >= set(range(M // 16))
