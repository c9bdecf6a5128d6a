"""Tests of the PyTorch port that need a CUDA card: each Hopper kernel
(gcn_lstm, ggru, lstm) against its plain version, and the serving paths
through the kernels against the plain path. They import neither jax nor the JAX package, so they run on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_port_card.py -q --noconftest

(``--noconftest``: the suite's conftest imports jax). Off the card each
test skips inside its body."""

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ragged(S, T=60):
    """Per-stream valid lengths with full, short and idle streams (the
    pattern repeats past 12 streams)."""
    return ([T, T, 37, T, 0, T, T, T, 11, T, 59, T] * 2)[:S]


# every launch plan regime of the weight-stationary kernels (gcn_lstm
# H = 64/128/256 -> clusters of C = 4/4/8; lstm H = 64/128 -> clusters of
# P = 4/8, H = 256/512 -> cooperative groups of P = 16/32; ggru: every
# cluster size that fits), and stream counts that fill 1, 3, 8 and 12 (two
# stream blocks) slots
PLAN_S = [1, 3, 8, 12]


def _cell(gen, cell, F, H):
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    nira = load_adjacency_template()

    def one():
        p = C.init_gcn_lstm_cell(gen, F, H, nira, attention=cell == "a3gc")
        with torch.no_grad():
            p.bias.add_(0.1 * torch.randn(p.bias.shape, generator=gen))
        return p

    return L.stack_directions(one(), one())


@pytest.mark.cuda
@pytest.mark.parametrize("S", PLAN_S)
@pytest.mark.parametrize("H", [64, 128, 256])
@pytest.mark.parametrize("cell", ["a3gc", "aagc"])
def test_torch_port_kernel_matches_plain_on_card(cell, H, S):
    """Every frame and the final state; 1e-5 absolute (fp32, sums reordered
    by the kernel over a 60-step recurrence; an H100 showed at most
    2.1e-7)."""
    _need_card()
    from a3gc_tpu_torch.ops import gcn_lstm as G
    gen = torch.Generator().manual_seed(0)
    T, N = 60, 15
    p = _cell(gen, cell, 2 * H, H).cuda()
    x = torch.randn((S, T, N, 2 * H), generator=gen).cuda()
    st = tuple((0.5 * torch.randn((2, S, N, H), generator=gen)).cuda()
               for _ in range(2))
    n_valid = torch.tensor(_ragged(S, T), device="cuda")
    G.bi_gcn_lstm.launches = 0
    with torch.no_grad():
        y, (h, c) = G.bi_gcn_lstm(p, x, st, n_valid)
        ref_y, (ref_h, ref_c) = G.bi_gcn_lstm_reference(p, x, st, n_valid)
    torch.cuda.synchronize()
    assert G.bi_gcn_lstm.launches == 1
    for a, b in ((y, ref_y), (h, ref_h), (c, ref_c)):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_torch_port_kernel_refuses_grad_on_card():
    """The kernel no longer refuses grad mode: under grad it launches (one
    launch, no plain forward) and the backward is the plain version's."""
    _need_card()
    from a3gc_tpu_torch.ops import gcn_lstm as G
    gen = torch.Generator().manual_seed(1)
    p = _cell(gen, "a3gc", 8, 8).cuda()
    x = torch.randn((1, 4, 15, 8), generator=gen).cuda().requires_grad_()
    st = tuple(torch.zeros((2, 1, 15, 8), device="cuda") for _ in range(2))
    G.bi_gcn_lstm.launches = 0
    y, (h, c) = G.bi_gcn_lstm(p, x, st)
    assert G.bi_gcn_lstm.launches == 1 and y.requires_grad
    (y.sum() + c.sum()).backward()
    assert G.bi_gcn_lstm.launches == 1
    ref = x.detach().requires_grad_()
    y, (h, c) = G.bi_gcn_lstm_reference(p, ref, st)
    (y.sum() + c.sum()).backward()
    assert (x.grad - ref.grad).abs().max().item() <= 1e-5 * max(
        ref.grad.abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_torch_port_streaming_kernel_path_matches_plain_on_card():
    """StreamingCascade through the kernel against the plain path over two
    windows with an idle slot; 1e-4 absolute on poses after three stages
    and IK."""
    _need_card()
    from a3gc_tpu_torch.data import load_adjacency_template, load_stats
    from a3gc_tpu_torch.eval.streaming import StreamingCascade
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import CascadeConfig, PoseNetConfig
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.smpl import ParametricModel

    def cfg(backend):
        return CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
            units_in=ui, units_out=uo, units_hidden=32, backend=backend),
            rotsize=rot) for ui, uo, rot in ((12, 3, 3), (15, 3, 3),
                                            (15, 9, 9))))

    gen = torch.Generator().manual_seed(2)
    nira = load_adjacency_template()
    params3 = tuple(N.init_graph_net(gen, c.net, nira).cuda()
                    for c in cfg("auto").stages)
    S, W = 3, 20
    sessions = [StreamingCascade(params3, cfg(b), ParametricModel(),
                                 window=W, stats=load_stats(),
                                 normalize=True, streams=S)
                for b in ("auto", "eager")]
    rng = np.random.default_rng(3)
    G.bi_gcn_lstm.launches = 0
    for active in (None, np.array([1.0, 0.0, 1.0], np.float32)):
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(size=(S, W, 18)).astype(np.float32)
        got, want = (s.step(ori, acc, active=active) for s in sessions)
        rows = np.ones(S, bool) if active is None else active > 0
        assert np.isfinite(got[rows]).all()
        np.testing.assert_allclose(got[rows], want[rows], atol=1e-4)
    assert G.bi_gcn_lstm.launches == 12


def _ggru_plans(S, H):
    """Every plan the planner can return for S streams at width H: every
    cluster size that fits."""
    from a3gc_tpu_torch.ops import ggru as GG
    plans = []
    for C in (1, 2, 4, 8):
        try:
            plans.append(GG.launch_plan(S, 15, H, C=C))
        except ValueError:
            continue
    assert GG.launch_plan(S, 15, H) in plans
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 1.5])
@pytest.mark.parametrize("S", PLAN_S)
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("H", [32, 64, 128, 256])
def test_torch_port_ggru_kernel_matches_plain_on_card(H, wide, S, scale):
    """Every frame and the final state, F = H and 2H, ragged and idle
    streams, the wrapper and every launch plan, at the initial recurrent
    weights and at ``scale`` times their size (the kernel multiplies G into
    W_hid first, the plain version h into G); 1e-5 absolute (fp32, sums
    reordered by the kernel over a 60-step recurrence). At twice the
    initial size the recurrence itself amplifies rounding differences past
    1e-5 over 60 frames, whatever the order of the sums; at three times it
    is chaotic."""
    _need_card()
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    from a3gc_tpu_torch.ops import ggru as GG
    gen = torch.Generator().manual_seed(4)
    T, N, F = 60, 15, 2 * H if wide else H
    nira = load_adjacency_template()
    p = L.stack_directions(*(C.init_ggru_cell(gen, F, H, nira)
                             for _ in range(2))).cuda()
    with torch.no_grad():
        p.gcn_kernel.mul_(scale)
        p.w_hid.mul_(scale)
    x = torch.randn((S, T, N, F), generator=gen).cuda()
    h = (0.5 * torch.randn((2, S, N, H), generator=gen)).cuda()
    nv = torch.tensor(_ragged(S, T), device="cuda")
    plans = _ggru_plans(S, H)
    assert len(plans) >= (1 if H == 256 else 3)
    GG.bi_ggru.launches = 0
    with torch.no_grad():
        ref_y, ref_h = GG.bi_ggru_reference(p, x, h, nv)
        outs = [GG.bi_ggru(p, x, h, nv)]
        args = GG.scan_inputs(p, x, h, nv)
        outs += [GG.scan(*args, plan=plan) for plan in plans]
    torch.cuda.synchronize()
    assert GG.bi_ggru.launches == 1 + len(plans)
    for plan, (y, hn) in zip([None] + plans, outs):
        for a, b in ((y, ref_y), (hn, ref_h)):
            assert (a - b).abs().max().item() <= 1e-5, plan


@pytest.mark.cuda
@pytest.mark.parametrize("S", PLAN_S)
@pytest.mark.parametrize("H", [64, 128, 256, 512])
def test_torch_port_lstm_kernel_matches_plain_on_card(H, S):
    """Every frame and the final state; 1e-5 absolute."""
    _need_card()
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.ops import lstm as LS
    gen = torch.Generator().manual_seed(5)
    T = 60
    p = N.init_dip(gen, N.DIPConfig(n_hidden=H)).lstm[1].cuda()
    x = torch.randn((S, T, 2 * H), generator=gen).cuda()
    st = tuple((0.5 * torch.randn((2, S, H), generator=gen)).cuda()
               for _ in range(2))
    nv = torch.tensor(_ragged(S, T), device="cuda")
    LS.bi_lstm.launches = 0
    with torch.no_grad():
        y, (h, c) = LS.bi_lstm(p, x, st, nv)
        ref_y, (ref_h, ref_c) = LS.bi_lstm_reference(p, x, st, nv)
    torch.cuda.synchronize()
    assert LS.bi_lstm.launches == 1
    for a, b in ((y, ref_y), (h, ref_h), (c, ref_c)):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gcn_lstm", "lstm", "ggru"])
def test_torch_port_refused_plan_raises_on_card(kernel):
    """A plan the kernel does not take (shared memory that disagrees with
    the kernel's own count) raises at the launch; nothing falls back."""
    _need_card()
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    gen = torch.Generator().manual_seed(8)
    S, T, H = 2, 4, 32
    if kernel == "ggru":
        from a3gc_tpu_torch.data import load_adjacency_template
        from a3gc_tpu_torch.models import cells as C
        from a3gc_tpu_torch.models import layers as L
        p = L.stack_directions(*(C.init_ggru_cell(
            gen, H, H, load_adjacency_template()) for _ in range(2))).cuda()
        args = GG.scan_inputs(p, torch.randn((S, T, 15, H)).cuda(),
                              torch.zeros((2, S, 15, H), device="cuda"))
        plan = GG.launch_plan(S, 15, H)
        mod = GG
    elif kernel == "lstm":
        from a3gc_tpu_torch.models import nets as N
        p = N.init_dip(gen, N.DIPConfig(n_hidden=H)).lstm[1].cuda()
        args = LS.scan_inputs(p, torch.randn((S, T, 2 * H)).cuda(),
                              tuple(torch.zeros((2, S, H), device="cuda")
                                    for _ in range(2)))
        plan = LS.launch_plan(S, H)
        mod = LS
    else:
        p = _cell(gen, "a3gc", H, H).cuda()
        args = G.scan_inputs(p, torch.randn((S, T, 15, H)).cuda(),
                             tuple(torch.zeros((2, S, 15, H), device="cuda")
                                   for _ in range(2)))
        plan = G.launch_plan(15, H, True)
        mod = G
    with torch.no_grad(), pytest.raises(RuntimeError, match="launch failed"):
        mod.scan(*args, plan=plan._replace(smem=plan.smem + 16))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ggru", "tp", "dip"])
def test_torch_port_new_family_serving_matches_plain_on_card(kind):
    """One serving window of the ggru cascade, the TransPose cascade or
    the DIP session through the kernels against the plain path, an idle
    slot included; 1e-4 absolute on poses after IK."""
    _need_card()
    from a3gc_tpu_torch.data import load_adjacency_template, load_stats
    from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                               StreamingCascade)
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import (CascadeConfig,
                                                PoseNetConfig, init_pose_net)
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    from a3gc_tpu_torch.smpl import ParametricModel

    def cfg(backend):
        if kind == "dip":
            return PoseNetConfig(net=N.DIPConfig(n_hidden=64,
                                                 backend=backend))
        if kind == "tp":
            return CascadeConfig(*(PoseNetConfig(net=N.DIPConfig(
                n_input=ni, n_output=no, n_hidden=32, backend=backend),
                rotsize=rot) for ni, no, rot in ((72, 15, 3), (87, 69, 3),
                                                 (141, 135, 9))))
        return CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
            cell="ggru", units_in=ui, units_out=uo, units_hidden=32,
            backend=backend), rotsize=rot)
            for ui, uo, rot in ((12, 3, 3), (15, 3, 3), (15, 9, 9))))

    gen = torch.Generator().manual_seed(6)
    nira = load_adjacency_template()
    S, W = 3, 20
    if kind == "dip":
        params = init_pose_net(gen, cfg("auto")).cuda()
        sessions = [DipStreamingSession(params, cfg(b), ParametricModel(),
                                        window=W, stats=load_stats(),
                                        streams=S) for b in ("auto", "eager")]
    else:
        params = tuple(init_pose_net(gen, c, nira).cuda()
                       for c in cfg("auto").stages)
        sessions = [StreamingCascade(params, cfg(b), ParametricModel(),
                                     window=W, stats=load_stats(),
                                     normalize=True, streams=S)
                    for b in ("auto", "eager")]
    counter = GG.bi_ggru if kind == "ggru" else LS.bi_lstm
    rng = np.random.default_rng(7)
    counter.launches = 0
    active = np.array([1.0, 0.0, 1.0], np.float32)
    ori = rng.normal(size=(S, W, 54)).astype(np.float32)
    acc = rng.normal(size=(S, W, 18)).astype(np.float32)
    got, want = (s.step(ori, acc, active=active) for s in sessions)
    rows = active > 0
    assert np.isfinite(got[rows]).all()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-4)
    assert counter.launches == (2 if kind == "dip" else 6)


# whole-window valid lengths of a buffered flush over a 180-frame context
LONG_N_VALID = [180, 120, 60, 0, 180, 180, 60, 120]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 1])
@pytest.mark.parametrize("T", [120, 180])
@pytest.mark.parametrize("H", [64, 128, 256, 512])
@pytest.mark.parametrize("kernel", ["gcn_lstm", "ggru", "lstm"])
def test_torch_port_kernels_at_buffered_lengths_on_card(kernel, H, T, S):
    """The shapes the buffered (lookahead/history) sessions launch: T =
    (P+K+1)·W frames with per-stream n_valid of whole windows. Every frame
    and the final state at 1e-5 absolute, and the launch leaves its initial
    state as it was (the emission and the advance pass start from one
    carried state)."""
    _need_card()
    if H == 512 and kernel != "lstm":
        pytest.skip("the graph cascades have no stage of 512 hidden units")
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    gen = torch.Generator().manual_seed(7)
    nodes = (15,) if kernel != "lstm" else ()
    if kernel == "gcn_lstm":
        p, fn, ref = _cell(gen, "a3gc", 2 * H, H), G.bi_gcn_lstm, \
            G.bi_gcn_lstm_reference
    elif kernel == "ggru":
        from a3gc_tpu_torch.data import load_adjacency_template
        nira = load_adjacency_template()
        p = L.stack_directions(C.init_ggru_cell(gen, 2 * H, H, nira),
                               C.init_ggru_cell(gen, 2 * H, H, nira))
        fn, ref = GG.bi_ggru, GG.bi_ggru_reference
    else:
        p = N.init_dip(gen, N.DIPConfig(n_hidden=H)).lstm[1]
        fn, ref = LS.bi_lstm, LS.bi_lstm_reference
    p = p.cuda()
    x = torch.randn((S, T) + nodes + (2 * H,), generator=gen).cuda()
    st = tuple((0.5 * torch.randn((2, S) + nodes + (H,), generator=gen))
               .cuda() for _ in range(2))
    if kernel == "ggru":
        st = st[0]
    nv = torch.tensor([min(v, T) for v in LONG_N_VALID[:S]] if S > 1
                      else [T - 60], device="cuda")
    before = [t.clone() for t in (st if isinstance(st, tuple) else (st,))]
    fn.launches = 0
    with torch.no_grad():
        y, fin = fn(p, x, st, nv)
        ref_y, ref_fin = ref(p, x, st, nv)
    torch.cuda.synchronize()
    assert fn.launches == 1
    assert (y - ref_y).abs().max().item() <= 1e-5
    for a, b in zip(fin if isinstance(fin, tuple) else (fin,),
                    ref_fin if isinstance(ref_fin, tuple) else (ref_fin,)):
        assert (a - b).abs().max().item() <= 1e-5
    for a, b in zip(st if isinstance(st, tuple) else (st,), before):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_torch_port_buffered_session_from_a_thread_on_card(fused):
    """A buffered session stepped and flushed from a second thread (where
    grad mode starts enabled) launches the kernels and matches the plain
    path at 1e-3 on poses after three stages and IK."""
    _need_card()
    import threading

    from a3gc_tpu_torch.data import load_adjacency_template, load_stats
    from a3gc_tpu_torch.eval.streaming import StreamingCascade
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                                init_pose_net)
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.smpl import ParametricModel

    def cfg(backend):
        return CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
            cell="a3gc", units_in=ui, units_out=uo, units_hidden=H,
            backend=backend), rotsize=rot)
            for H, ui, uo, rot in ((64, 12, 3, 3), (64, 15, 3, 3),
                                   (64, 15, 9, 9))))

    nira = load_adjacency_template()
    gen = torch.Generator().manual_seed(0)
    params3 = tuple(init_pose_net(gen, c, nira).cuda()
                    for c in cfg("auto").stages)
    S, W = 4, 60
    sessions = [StreamingCascade(params3, cfg(b), ParametricModel(),
                                 window=W, stats=load_stats(),
                                 normalize=True, streams=S, lookahead=1,
                                 history=1, fused=fused, device="cuda")
                for b in ("auto", "eager")]
    rng = np.random.default_rng(0)
    wins = [(rng.normal(size=(S, W, 54)).astype(np.float32),
             rng.normal(size=(S, W, 18)).astype(np.float32))
            for _ in range(4)]
    out = {}

    def work(name, sess):
        res = [sess.step(o, a) for o, a in wins]
        out[name] = res, sess.flush()

    G.bi_gcn_lstm.launches = 0
    for name, sess in zip(("kernel", "plain"), sessions):
        t = threading.Thread(target=work, args=(name, sess))
        t.start()
        t.join(300)
        assert not t.is_alive() and name in out
    assert G.bi_gcn_lstm.launches == 0 + 6 + 12 + 12 + 6
    for (pose, em), (ref_pose, ref_em) in zip(out["kernel"][0][1:],
                                              out["plain"][0][1:]):
        assert em.all() and ref_em.all()
        assert np.abs(pose - ref_pose).max() <= 1e-3
    for a, b in zip(out["kernel"][1], out["plain"][1]):
        assert a.shape == (W, 24, 3, 3) and np.abs(a - b).max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("T", [60, 120])
@pytest.mark.parametrize("S", PLAN_S)
@pytest.mark.parametrize("H", [64, 128, 256, 512])
def test_torch_port_uni_lstm_kernel_matches_plain_on_card(H, S, T):
    """``lstm.cu`` at D = 1 (the unidirectional DIP layer) against the
    plain version, every launch plan regime, ragged ``n_valid``: every
    frame and the final state at 1e-5 absolute; the initial state is not
    written."""
    _need_card()
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.ops import lstm as LS
    gen = torch.Generator().manual_seed(9)
    p = N.init_dip(gen, N.DIPConfig(n_hidden=H, bidirectional=False)
                   ).lstm[1].cuda()
    x = torch.randn((S, T, H), generator=gen).cuda()
    st = tuple((0.5 * torch.randn((S, H), generator=gen)).cuda()
               for _ in range(2))
    before = tuple(t.clone() for t in st)
    nv = torch.tensor(_ragged(S, T)[:S] if T == 60 else
                      [T, 60, 0, T, 120, 1, T, 59, T, 0, 61, T][:S],
                      device="cuda")
    LS.bi_lstm.launches = 0
    with torch.no_grad():
        y, (h, c) = LS.bi_lstm(p, x, st, nv)
        ref_y, (ref_h, ref_c) = LS.bi_lstm_reference(p, x, st, nv)
    torch.cuda.synchronize()
    assert LS.bi_lstm.launches == 1
    assert y.shape == (S, T, H) and h.shape == c.shape == (S, H)
    for a, b in ((y, ref_y), (h, ref_h), (c, ref_c)):
        assert (a - b).abs().max().item() <= 1e-5, LS.launch_plan(S, H, D=1)
    assert all(torch.equal(a, b) for a, b in zip(st, before))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 1])
def test_torch_port_uni_dip_session_matches_eager_on_card(K):
    """A ``DipStreamingSession`` over the unidirectional DIP net through
    ``lstm.cu`` against the same session on the plain path, an idle slot
    and a reset included; 1e-4 on poses after IK."""
    _need_card()
    from a3gc_tpu_torch.data import load_stats
    from a3gc_tpu_torch.eval.streaming import DipStreamingSession
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
    from a3gc_tpu_torch.ops import lstm as LS
    from a3gc_tpu_torch.smpl import ParametricModel

    def cfg(backend):
        return PoseNetConfig(net=N.DIPConfig(n_hidden=512,
                                             bidirectional=False,
                                             backend=backend))

    gen = torch.Generator().manual_seed(10)
    params = init_pose_net(gen, cfg("auto")).cuda()
    S, W = 3, 20
    sessions = [DipStreamingSession(params, cfg(b), ParametricModel(),
                                    window=W, stats=load_stats(), streams=S,
                                    lookahead=K) for b in ("auto", "eager")]
    rng = np.random.default_rng(11)
    idle = np.ones(S, np.float32)
    idle[1] = 0.0
    LS.bi_lstm.launches = 0
    for w, active in enumerate((None, idle, None, None)):
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(scale=0.5, size=(S, W, 18)).astype(np.float32)
        got, want = (s.step(ori, acc, active=active) for s in sessions)
        if K:
            (got, em), (want, _) = got, want
        else:
            em = np.ones(S, bool) if active is None else active > 0
        if em.any():
            assert np.abs(got[em] - want[em]).max() <= 1e-4
        if w == 1:
            for s in sessions:
                s.reset(stream=2)
    assert LS.bi_lstm.launches > 0
    for la, lb in zip(sessions[0]._states[0], sessions[1]._states[0]):
        for a, b in zip(la, lb):
            assert a.shape == (S, 512)
            assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["a3gc", "ggru", "dip", "dip_uni"])
def test_torch_port_checkpoint_round_trip_onto_card(family, tmp_path):
    """A net written with the port's exporter and read back with its
    importer onto the card, and through the port's checkpoint directory,
    is bit-equal to the original, and so is one window it computes."""
    _need_card()
    from a3gc_tpu_torch.compat import torch_export as TE
    from a3gc_tpu_torch.compat import torch_import as TI
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
    from a3gc_tpu_torch.utils import restore_params, save_params
    gen = torch.Generator().manual_seed(12)
    if family.startswith("dip"):
        net = N.DIPConfig(n_hidden=64, bidirectional=family == "dip")
        x = torch.randn((2, 30, 60), generator=gen).cuda()
    else:
        net = N.GraphNetConfig(cell=family, units_hidden=64)
        x = torch.randn((2, 30, 15, 12), generator=gen).cuda()
    cfg = PoseNetConfig(net=net, rotsize=3)
    nira = load_adjacency_template()
    params = init_pose_net(gen, cfg, nira).cuda()
    tar = str(tmp_path / "net.tar")
    if family.startswith("dip"):
        TE.save_torch_checkpoint(tar, TE.dip_state_dict(params))
        loaded = TI.dip_params_from_state_dict(
            TI.load_torch_checkpoint(tar), cfg=net)
    else:
        TE.save_torch_checkpoint(tar, TE.graph_net_state_dict(params,
                                                              family))
        loaded = TI.graph_net_params_from_state_dict(
            TI.load_torch_checkpoint(tar), family, cfg=net)
    path = save_params(params, str(tmp_path), 1, 2)
    restored = restore_params(path, init_pose_net(gen, cfg, nira).cuda())
    apply = N.dip_apply if family.startswith("dip") else N.graph_net_apply
    with torch.no_grad():
        want, want_state = apply(params, net, x)
        for other in (loaded, restored):
            for a, b in zip(other.parameters(), params.parameters()):
                assert a.is_cuda and torch.equal(a, b)
            got, got_state = apply(other, net, x)
            assert torch.equal(got, want)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(n, 3, 3).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("third", [0.3, 1e-4, -0.2, -1e-4])
def test_torch_port_project_to_rotation_on_card_equals_cpu(third):
    """cuSOLVER gives U and V other signs than LAPACK; U·Vᵀ with the
    determinant fix does not depend on them: 1e-5 on proper,
    near-singular and reflected matrices, 100k of them in one batch."""
    _need_card()
    from a3gc_tpu_torch.ops import rotations as R
    rng = np.random.default_rng(0)
    n = 100_000
    u, v = _rotations(rng, n), _rotations(rng, n)
    m = np.einsum("nij,j,nkj->nik", u, np.array([1.0, 0.5, third],
                                                np.float32), v)
    m = torch.as_tensor(m.astype(np.float32))
    cpu = R.project_to_rotation(m)
    card = R.project_to_rotation(m.cuda()).cpu()
    assert float((card - cpu).abs().max()) <= 1e-5
    ang_cpu = R.angle_between(m, torch.as_tensor(_rotations(rng, n)))
    assert torch.isfinite(ang_cpu).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [False, True])
def test_torch_port_metrics_on_card_equal_cpu(mesh, tmp_path):
    """FK, LBS and the [11, 2] table on the card against the CPU on the
    same near-rotation poses, 1e-4 relative."""
    _need_card()
    from a3gc_tpu_torch.metrics import full_motion_metrics
    from a3gc_tpu_torch.smpl import (load_parametric_model,
                                     write_synthetic_smpl_pickle)
    path = write_synthetic_smpl_pickle(str(tmp_path / "smpl.pkl"),
                                       n_vertices=6890)
    rng = np.random.default_rng(1)
    N = 600
    pt = _rotations(rng, N * 24).reshape(N, 24, 3, 3)
    pp = pt + 0.05 * rng.normal(size=pt.shape).astype(np.float32)
    got = full_motion_metrics(load_parametric_model(path), pp, pt,
                              n_valid=550, joint_mask=(1, 2, 16, 17),
                              with_mesh=mesh)
    want = full_motion_metrics(load_parametric_model(path, device="cpu"),
                               pp, pt, n_valid=550,
                               joint_mask=(1, 2, 16, 17), with_mesh=mesh)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp"])
def test_torch_port_cascade_evaluator_on_card_matches_eager(kind, tmp_path):
    """The three protocols through the kernels against the plain path on
    the card, hidden 16, stage 3's outputs near rotations (biased to the
    identity): 1e-3 on the [5, 2] table."""
    _need_card()
    from a3gc_tpu_torch.data import load_adjacency_template, load_stats
    from a3gc_tpu_torch.eval import CascadeEvaluator
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                                init_pose_net)
    from a3gc_tpu_torch.smpl import (load_parametric_model,
                                     write_synthetic_smpl_pickle)
    model = load_parametric_model(write_synthetic_smpl_pickle(
        str(tmp_path / "smpl.pkl"), n_vertices=192))

    def cfg(backend):
        if kind == "tp":
            return CascadeConfig(*(PoseNetConfig(net=N.DIPConfig(
                n_input=ni, n_output=no, n_hidden=16, backend=backend),
                rotsize=rot) for ni, no, rot in
                ((72, 15, 3), (87, 69, 3), (141, 135, 9))))
        return CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
            cell=kind, units_in=ui, units_out=uo, units_hidden=16,
            backend=backend), rotsize=rot) for ui, uo, rot in
            ((12, 3, 3), (15, 3, 3), (15, 9, 9))))

    gen = torch.Generator().manual_seed(0)
    params3 = tuple(init_pose_net(gen, c, load_adjacency_template()).cuda()
                    for c in cfg("auto").stages)
    out = (params3[2].linear2 if kind == "tp" else params3[2].linear_out)
    with torch.no_grad():
        out.kernel.mul_(0.1)
        out.bias.copy_(torch.eye(3).flatten().repeat(
            out.bias.numel() // 9).cuda())
    rng = np.random.default_rng(2)
    seqs = [{"ori": _rotations(rng, T * 6).reshape(T, 54),
             "acc": rng.normal(scale=0.5, size=(T, 18)).astype(np.float32),
             "pose": _rotations(rng, T * 15).reshape(T, 135)}
            for T in (70, 130, 200)]
    evs = {b: CascadeEvaluator(params3, cfg(b), model, load_stats(),
                               normalize=True) for b in ("auto", "eager")}
    for protocol, kw in (("evaluate", {}),
                         ("evaluate_batched", {"streams": 2}),
                         ("evaluate_streaming", {"window": 30,
                                                 "lookahead": 1,
                                                 "history": 1})):
        got, want = (getattr(evs[b], protocol)(seqs, **kw)[0]
                     for b in ("auto", "eager"))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3,
                                   err_msg=protocol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gcn_lstm", "gcn_lstm_aagc", "ggru",
                                  "lstm", "lstm_uni"])
def test_torch_port_ops_pass_opcheck_on_card(case):
    """The registered ops (``ops/library.py``) on CUDA tensors: schema,
    fake (output shapes) against the kernel's outputs, the autograd
    registration (the plain version's backward), dispatch under ``torch.compile``'s AOT tracing."""
    _need_card()
    from a3gc_tpu_torch.ops import library as LIB
    gen = torch.Generator().manual_seed(4)

    def r(*shape):
        return (0.3 * torch.randn(shape, generator=gen)).cuda()
    nv = torch.tensor([60, 37, 0], dtype=torch.int32, device="cuda")
    S, T, N, H = 3, 60, 15, 64
    if case.startswith("gcn_lstm"):
        att = ((r(2, H, H), r(2, H, H), r(2, H, H), r(2, H), r(2, H),
                r(2, N)) if case == "gcn_lstm" else (None,) * 6)
        op, args = LIB.gcn_lstm_scan, (r(2, S, T, N, 4 * H),
                                       r(2, H, 4 * H), r(2, 4, N, N),
                                       r(2, 4, H), *att, r(2, S, N, H),
                                       r(2, S, N, H), nv)
    elif case == "ggru":
        op, args = LIB.ggru_scan, (r(2, S, T, N, 3 * H), r(2, H, H),
                                   r(2, N, N), r(2, H, 3 * H),
                                   r(2, S, N, H), nv)
    else:
        D = 2 if case == "lstm" else 1
        op, args = LIB.lstm_scan, (r(D, S, T, 4 * H), r(D, H, 4 * H),
                                   r(D, S, H), r(D, S, H), nv)
    torch.library.opcheck(op, args)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["a3gc", "ggru", "tp", "dip_uni"])
def test_torch_port_artifact_matches_live_session_on_card(family, tmp_path):
    """An artifact exported on the card, loaded back, launches the kernels
    (as many launches per window as the live session) and is bit-equal to
    the live session over three windows with an idle slot and a reset."""
    _need_card()
    from a3gc_tpu_torch import export as X
    from a3gc_tpu_torch.data import load_adjacency_template, load_stats
    from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                               StreamingCascade)
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                                init_pose_net)
    from a3gc_tpu_torch.ops import gcn_lstm, ggru, lstm
    from a3gc_tpu_torch.smpl import ParametricModel
    gen = torch.Generator().manual_seed(5)
    S, W, H = 4, 30, 64
    model, stats = ParametricModel(), load_stats()
    if family == "dip_uni":
        cfg = PoseNetConfig(net=N.DIPConfig(n_hidden=H,
                                            bidirectional=False), rotsize=9)
        params = init_pose_net(gen, cfg).cuda()
        ep = X.export_streaming_dip(params, cfg, model, window=W, streams=S,
                                    stats=stats)
        live = DipStreamingSession(params, cfg, model, window=W,
                                   stats=stats, streams=S)
        wrapper, per_window = lstm.bi_lstm, 2
    else:
        def net(ui, uo, rot):
            return PoseNetConfig(net=N.DIPConfig(
                n_input=ui, n_output=uo, n_hidden=H) if family == "tp" else
                N.GraphNetConfig(cell=family, units_in=ui, units_out=uo,
                                 units_hidden=H), rotsize=rot)
        dims = (((72, 15, 3), (87, 69, 3), (141, 135, 9)) if family == "tp"
                else ((12, 3, 3), (15, 3, 3), (15, 9, 9)))
        cfg = CascadeConfig(*(net(*d) for d in dims))
        nira = load_adjacency_template()
        params = tuple(init_pose_net(gen, c, nira).cuda()
                       for c in cfg.stages)
        ep = X.export_streaming_cascade(params, cfg, model, window=W,
                                        streams=S, stats=stats,
                                        normalize=True)
        live = StreamingCascade(params, cfg, model, window=W, stats=stats,
                                normalize=True, streams=S)
        wrapper = {"a3gc": gcn_lstm.bi_gcn_lstm, "ggru": ggru.bi_ggru,
                   "tp": lstm.bi_lstm}[family]
        per_window = 6
    X.save_exported(str(tmp_path / "art"), *ep)
    sess = X.ArtifactSession(X.load_exported(str(tmp_path / "art")))
    assert sess.device.type == "cuda"
    rng = np.random.default_rng(0)
    idle = np.array([1, 1, 0, 1], np.float32)
    for w in range(3):
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(size=(S, W, 18)).astype(np.float32)
        active = idle if w == 1 else None
        before = wrapper.launches
        got = sess.step(ori, acc, active=active)
        assert wrapper.launches - before == per_window
        want = live.step(ori, acc, active=active)
        rows = np.ones(S, bool) if active is None else active > 0
        np.testing.assert_array_equal(got[rows], want[rows])
        if w == 0:
            sess.reset(stream=1)
            live.reset(stream=1)
    for a, b in zip(_leaves(sess._states), _leaves(live._states)):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _grad_case(kernel, H, S, gen):
    """(layer params, x, state, n_valid, op wrapper, plain version) of one
    layer call at F = 2H (H for a unidirectional LSTM)."""
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    T, Nn = 60, 15
    n_valid = torch.tensor(_ragged(S, T), device="cuda")
    if kernel == "gcn_lstm":
        p = _cell(gen, "a3gc", 2 * H, H).cuda()
        x = torch.randn((S, T, Nn, 2 * H), generator=gen)
        st = tuple(0.5 * torch.randn((2, S, Nn, H), generator=gen)
                   for _ in range(2))
        return p, x, st, n_valid, G.bi_gcn_lstm, G.bi_gcn_lstm_reference
    if kernel == "ggru":
        nira = load_adjacency_template()
        p = L.stack_directions(C.init_ggru_cell(gen, 2 * H, H, nira),
                               C.init_ggru_cell(gen, 2 * H, H, nira)).cuda()
        x = torch.randn((S, T, Nn, 2 * H), generator=gen)
        st = (0.5 * torch.randn((2, S, Nn, H), generator=gen),)
        return p, x, st, n_valid, GG.bi_ggru, GG.bi_ggru_reference
    D = 2 if kernel == "lstm" else 1
    F = 2 * H if D == 2 else H
    b = 1.0 / H ** 0.5

    def u(*shape):
        return torch.rand(shape, generator=gen) * (2 * b) - b

    def one():
        return N.LSTMLayerParams(w_ih=u(F, 4 * H), w_hh=u(H, 4 * H),
                                 b_ih=u(4 * H), b_hh=u(4 * H))
    p = (L.stack_directions(one(), one()) if D == 2 else one()).cuda()
    x = torch.randn((S, T, F), generator=gen)
    st = tuple(0.5 * torch.randn((2,) * (D - 1) + (S, H), generator=gen)
               for _ in range(2))
    return p, x, st, n_valid, LS.bi_lstm, LS.bi_lstm_reference


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("H", [64, 256])
@pytest.mark.parametrize("kernel", ["gcn_lstm", "ggru", "lstm", "lstm_uni"])
def test_torch_port_grad_through_ops_matches_plain_on_card(kernel, H, S):
    """Gradients of a random linear loss of every output with respect to
    x, the initial state and every parameter, through the op (the
    kernel's forward, the plain backward) and through the plain version;
    1e-5 relative to each leaf's max |g|."""
    _need_card()
    gen = torch.Generator().manual_seed(7)
    p, x, st, nv, op, plain = _grad_case(kernel, H, S, gen)
    weights, grads = None, []
    for fn in (op, plain):
        xx = x.cuda().requires_grad_()
        ss = [t.cuda().requires_grad_() for t in st]
        out = _leaves(fn(p, xx, ss[0] if kernel == "ggru" else tuple(ss),
                         nv))
        if weights is None:
            weights = [torch.randn(o.shape, generator=gen).cuda()
                       for o in out]
        loss = sum((o * w).sum() for o, w in zip(out, weights))
        grads.append(torch.autograd.grad(loss, [xx, *ss, *p.parameters()]))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-5 * max(
            b.abs().max().item(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["a3gc", "dip"])
def test_torch_port_train_step_on_card_matches_cpu(kind):
    """One full-width training step (A3GC stage 1 at H = 256, DIP at
    H = 512; B = 4, T = 60; dropout and noise off, whose draws differ by
    device) on the card and on the CPU: the loss within 1e-5, the
    gradients within 1e-5 of each leaf's max |g|. The first Adam update,
    lr·g / (|g| + eps), turns the rounding of a gradient near eps into up
    to 2·lr of difference, so each device's update is held to that formula
    on its own gradients (within 1e-7)."""
    _need_card()
    from a3gc_tpu_torch.config import TrainConfig
    from a3gc_tpu_torch.data import load_adjacency_template, load_stats
    from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
    from a3gc_tpu_torch.train import DIPRunner, StageRunner, seeded_generator
    tc = TrainConfig(batch_size=4, normalize=True, leaf_noise_std=0.0,
                     full_noise_std=0.0)
    if kind == "dip":
        cfg = PoseNetConfig(net=N.DIPConfig(n_hidden=512, dropout=0.0))
        params = init_pose_net(torch.Generator().manual_seed(0), cfg)
    else:
        cfg = PoseNetConfig(net=N.GraphNetConfig(
            units_in=12, units_out=3, units_hidden=256, linear_dropout=0.0,
            dropout=0.0, recurrent_dropout=0.0), rotsize=3)
        params = init_pose_net(torch.Generator().manual_seed(0), cfg,
                               load_adjacency_template())
    raw = synthetic_packed_dataset(4, 60, seed=3)
    results = []
    for dev in ("cpu", "cuda"):
        if kind == "dip":
            r = DIPRunner(cfg, params, tc, 1, load_stats(), device=dev)
        else:
            r = StageRunner(1, cfg, params, tc, 1, stats=load_stats(),
                            device=dev)
        loss = r.train_step({k: torch.as_tensor(v, device=dev)
                             for k, v in raw.items()},
                            seeded_generator(dev, 0))
        results.append((float(loss), {
            n: (t.detach().cpu(), t.grad.cpu())
            for n, t in r.state.params.named_parameters()}))
    (l_cpu, p_cpu), (l_card, p_card) = results
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu), (l_card, l_cpu)
    before = dict(params.named_parameters())
    errs = {}
    for n, (t, g) in p_cpu.items():
        t2, g2 = p_card[n]
        adam = [(b - tc.lr * gg / (gg.abs() + 1e-8) - tt).abs().max().item()
                for b, tt, gg in ((before[n].detach(), t, g),
                                  (before[n].detach(), t2, g2))]
        errs[n] = ((g2 - g).abs().max().item()
                   / max(g.abs().max().item(), 1e-30), max(adam))
    bad = {n: e for n, e in errs.items() if e[0] > 1e-5 or e[1] > 1e-7}
    assert not bad, bad


# ---------------------------------------------------------------------------
# data preparation: the factory's FK and skinning on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_corpora(tmp_path_factory):
    """A data root with one raw sequence per corpus (AMASS 120 fps, 1200
    raw frames; DIP-IMU s_01 of 600 frames with NaN bursts; TotalCapture of
    600 frames) and a synthetic SMPL pickle of SMPL's 6890 vertices."""
    from a3gc_tpu_torch.config import Paths
    from a3gc_tpu_torch.smpl import write_synthetic_smpl_pickle
    from torch_port_raw import (write_raw_amass, write_raw_dip,
                                write_raw_totalcapture)
    root = tmp_path_factory.mktemp("card_data")
    paths = Paths(data_root=str(root))
    write_raw_amass(paths.resolve(paths.raw_amass_dir),
                    (("CMU", "01", "walk", 1200, 120),))
    write_raw_dip(paths.resolve(paths.raw_dipimu_dir),
                  (("s_01", "01", 600, "burst"),))
    write_raw_totalcapture(paths.resolve(paths.raw_totalcapture_dir),
                           (("s1_acting1", 600, 602),))
    return paths, write_synthetic_smpl_pickle(str(root / "smpl.pkl"),
                                              n_vertices=6890)


@pytest.mark.cuda
@pytest.mark.parametrize("corpus", ["amass", "amass_sym", "dipimu",
                                    "dipimu_sym", "totalcapture"])
def test_torch_port_factory_on_card_matches_cpu(card_corpora, corpus):
    """Every field of the factory's output with the body model on the card
    against the same call on the CPU: rotations, positions and poses within
    1e-5, normalized accelerations within 1e-4 (the finite difference
    scales the positions' rounding by up to 3600 / 30)."""
    _need_card()
    from a3gc_tpu_torch.data.factory import amass, dipimu, totalcapture
    from a3gc_tpu_torch.smpl import load_parametric_model
    from torch_port_raw import assert_factory_close
    paths, smpl = card_corpora
    out = []
    for dev in ("cpu", "cuda"):
        model = load_parametric_model(smpl, device=dev)
        if corpus.startswith("amass"):
            out.append(amass.process_amass_split(
                model, "train", sym=corpus.endswith("sym"), paths=paths))
        elif corpus.startswith("dipimu"):
            out.append(dipimu.process_dipimu(
                model, "train", sym=corpus.endswith("sym"), paths=paths))
        else:
            out.append(totalcapture.process_totalcapture(model, paths=paths))
    assert len(out[1]) > 0
    assert_factory_close(out[1], out[0], corpus)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_port_chunked_skinning_on_card_equals_one_call(dtype):
    """FK and 6890-vertex skinning of a 3000-frame sequence in one call and
    in chunks of 2048 and 700 frames, in fp32 and in the fp64 of
    ``synthesize_sequence``: the sensor vertices, joints and rotations
    within the factory's 1e-5 (a chunk's batch may change the library's
    blocking of the sums), and the CPU's within the same."""
    _need_card()
    from a3gc_tpu_torch.data.factory import amass
    from a3gc_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    from a3gc_tpu_torch.ops import rotations as R
    data = synthetic_smpl_data(n_vertices=6890)
    arrays = dict(j_regressor=data["J_regressor"],
                  skinning_weights=data["weights"],
                  posedirs=data["posedirs"], shapedirs=data["shapedirs"],
                  v_template=data["v_template"], joints_template=data["J"],
                  faces=data["f"])
    rng = np.random.default_rng(0)
    T = 3000
    aa = rng.normal(scale=0.3, size=(T * 24, 3)).astype(np.float32)
    shape = rng.normal(size=10).astype(np.float32)
    trans = rng.normal(size=(T, 3)).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = ParametricModel(device=dev, **arrays)._astype(dtype)
        rot = R.axis_angle_to_rotation_matrix(
            model.as_tensor(aa)).reshape(T, 24, 3, 3)
        for chunk in (T, 2048, 700):
            outs[dev, chunk] = [t.cpu() for t in amass._skin_sensors(
                model, rot, shape, trans, amass.AMASS_VI_MASK, chunk)]
    whole = outs["cuda", T]
    for key, got in outs.items():
        for a, b in zip(got, whole):
            assert (a - b).abs().max().item() <= 1e-5, key


@pytest.mark.cuda
def test_torch_port_view_motion_fk_on_card_matches_cpu(card_corpora,
                                                       monkeypatch):
    """``view_motion``'s FK and skinning on the card: the vertices it hands
    to ``view_mesh`` (the rasterizer is host code, tested on the CPU)
    against the CPU model's, within 1e-5."""
    _need_card()
    from a3gc_tpu_torch.smpl import ParametricModel, load_parametric_model
    _, smpl = card_corpora
    rng = np.random.default_rng(1)
    T = 30
    poses = [np.tile(np.eye(3, dtype=np.float32), (T, 24, 1, 1))
             + 0.1 * rng.normal(size=(T, 24, 3, 3)).astype(np.float32)
             for _ in range(2)]
    trans = [np.cumsum(rng.normal(scale=0.05, size=(T, 3)), 0).astype(
        np.float32) for _ in range(2)]
    seen = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(
            ParametricModel, "view_mesh",
            lambda self, verts, *a, dev=dev, **k: seen.setdefault(dev,
                                                                  verts))
        model = load_parametric_model(smpl, device=dev)
        model.view_motion(poses, trans, out_path="unused.gif")
    assert [v.shape for v in seen["cuda"]] == [(T, 6890, 3)] * 2
    for a, b in zip(seen["cuda"], seen["cpu"]):
        assert isinstance(a, np.ndarray)
        assert np.abs(a - b).max() <= 1e-5


def _mesh_cascade(hidden=32):
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import CascadeConfig, PoseNetConfig
    cfg = CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
        units_in=ui, units_out=uo, units_hidden=hidden), rotsize=rot)
        for ui, uo, rot in ((12, 3, 3), (15, 3, 3), (15, 9, 9))))
    gen = torch.Generator().manual_seed(5)
    nira = load_adjacency_template()
    return cfg, tuple(N.init_graph_net(gen, c.net, nira).cuda()
                      for c in cfg.stages)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_torch_port_sharded_cascade_on_card(shards):
    """``cascade_apply_sharded`` on the card (one shard: ``make_mesh()``;
    two: the card listed twice) against ``cascade_apply``, S = 4, ragged:
    bit-equal on one shard, 1e-5 over valid frames on two; 6 launches a
    shard."""
    _need_card()
    from a3gc_tpu_torch.models.pipeline import cascade_apply
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.parallel import cascade_apply_sharded, make_mesh
    from a3gc_tpu_torch.smpl import ParametricModel
    cfg, params3 = _mesh_cascade()
    rng = np.random.default_rng(6)
    S, T = 4, 90
    imu = torch.as_tensor(rng.normal(size=(S, T, 15, 12)).astype(np.float32),
                          device="cuda")
    mask = (np.arange(T)[None] < np.array([T, 61, 0, 37])[:, None]).astype(
        np.float32)
    want = cascade_apply(params3, cfg, ParametricModel(), imu,
                         frame_mask=mask)
    mesh = make_mesh() if shards == 1 else make_mesh(devices=["cuda:0"] * 2)
    G.bi_gcn_lstm.launches = 0
    got = cascade_apply_sharded(params3, cfg, ParametricModel(), imu, mesh,
                                frame_mask=mask)
    assert G.bi_gcn_lstm.launches == 6 * shards
    valid = torch.as_tensor(mask.reshape(-1) > 0, device="cuda")
    if shards == 1:
        assert torch.equal(got, want)
    else:
        assert float((got - want)[valid].abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_torch_port_mesh_session_on_card(shards):
    """A ``StreamingCascade(mesh=, lookahead=1, history=1)`` on the card
    against the unsharded session over 5 ticks with an idle slot and a
    reset, then ``flush``: bit-equal on one shard, 1e-5 on two."""
    _need_card()
    from a3gc_tpu_torch.data import load_stats
    from a3gc_tpu_torch.eval.streaming import StreamingCascade
    from a3gc_tpu_torch.parallel import make_mesh
    from a3gc_tpu_torch.smpl import ParametricModel
    cfg, params3 = _mesh_cascade()
    S, W = 4, 20
    mesh = make_mesh() if shards == 1 else make_mesh(devices=["cuda:0"] * 2)

    def session(m):
        return StreamingCascade(params3, cfg, ParametricModel(), window=W,
                                stats=load_stats(), normalize=True,
                                streams=S, lookahead=1, history=1, mesh=m)
    meshed, single = session(mesh), session(None)
    rng = np.random.default_rng(7)
    idle = np.array([1, 0, 1, 1], np.float32)
    tol = 0.0 if shards == 1 else 1e-5
    for t in range(5):
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(size=(S, W, 18)).astype(np.float32)
        act = idle if t == 2 else None
        (got, em), (want, em_want) = (s.step(ori, acc, active=act)
                                      for s in (meshed, single))
        assert (em == em_want).all()
        if em.any():
            assert np.abs(got[em] - want[em]).max() <= tol
        if t == 1:
            meshed.reset(stream=3)
            single.reset(stream=3)
    for a, b in zip(meshed.flush(), single.flush()):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.abs(a - b).max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["a3gc", "ggru"])
def test_torch_port_tp_step_on_card(cell):
    """A tensor-parallel ``StageRunner`` on ``[cuda:0, cuda:0]`` (a model
    group of two, its members in turn) at hidden 64: one step with the
    default dropout and noise within 2e-6 of the unsharded runner, its
    parameters within 1e-5; validation through the kernel on the gathered
    weights within 1e-5, with 2 launches a chunk."""
    _need_card()
    from a3gc_tpu_torch.config import MeshConfig, TrainConfig
    from a3gc_tpu_torch.data import load_adjacency_template, load_stats
    from a3gc_tpu_torch.data import pipeline as DP
    from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.parallel import make_mesh
    from a3gc_tpu_torch.train import StageRunner, seeded_generator
    cfg = PoseNetConfig(net=N.GraphNetConfig(cell=cell, units_in=12,
                                             units_out=3, units_hidden=64),
                        rotsize=3)
    params = init_pose_net(torch.Generator().manual_seed(0), cfg,
                           load_adjacency_template())
    tc = TrainConfig(batch_size=4, eval_batch_size=4, normalize=True)
    mesh = make_mesh(MeshConfig(data=1, model=2), devices=["cuda:0"] * 2)
    tp, single = (StageRunner(1, cfg, params, tc, 1, stats=load_stats(),
                              device="cuda", mesh=m) for m in (mesh, None))
    data = synthetic_packed_dataset(8, 30, seed=1)
    raw = {k: v[:4] for k, v in data.items()}
    loss = tp.train_step(raw, seeded_generator("cuda", 0))
    want = single.train_step({k: torch.as_tensor(v, device="cuda")
                              for k, v in raw.items()},
                             seeded_generator("cuda", 0))
    assert abs(float(loss) - float(want)) <= 2e-6 * abs(float(want))
    for (name, a), b in zip(tp.state.params.named_parameters(),
                            single.state.params.parameters()):
        assert float((a - b).abs().max()) <= 1e-5, name
    wrapper = GG.bi_ggru if cell == "ggru" else G.bi_gcn_lstm
    wrapper.launches = 0
    got = tp.eval_epoch(DP.Sampler(data, 4, shuffle=False))
    assert wrapper.launches == 4
    ref = single.eval_epoch(DP.Sampler(data, 4, shuffle=False))
    assert abs(got - ref) <= 1e-5 * abs(ref)


# -- the TF32 instantiations (a net's precision="default" on the card) -------

# a kernel at "tf32" against its plain version at "tf32": the JAX package's
# own Pallas kernels at "default" against XLA (KERNEL_CHECK.json, A3GC
# stage 3, S = 1), as chip_smoke.py PREC_KERNEL_TOL; and by root mean
# square at most PREC_SEP_* of the plain version's gap between the formats,
# which the fp32 kernel in its place exceeds (chip_smoke.py
# compare_formats: over one frame and over a window)
PREC_KERNEL_TOL = 8.05e-3
PREC_SEP_FRAME, PREC_SEP_WINDOW = 0.15, 0.5


def _rms(a, b):
    d = [(x.double() - y.double()) for x, y in zip(a, b)]
    return (sum(float(t.square().sum()) for t in d)
            / sum(t.numel() for t in d)) ** 0.5


def _tf32_case(name, H, S, D=2, F=None, T=60, cell="a3gc"):
    r"""(wrapper, plain version, args) of one layer call at S streams of T
    frames with ragged n_valid (an idle stream from S = 5 on), F = 2H by
    default; ``cell`` picks the graph-LSTM cell."""
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    gen = torch.Generator().manual_seed(H + S + D + T)
    nodes = 15
    F = F or (2 * H if D == 2 else H)
    if name == "lstm":
        b = 1.0 / H ** 0.5

        def u(*shape):
            return torch.rand(shape, generator=gen) * (2 * b) - b

        def one():
            return N.LSTMLayerParams(w_ih=u(F, 4 * H), w_hh=u(H, 4 * H),
                                     b_ih=u(4 * H), b_hh=u(4 * H))

        p = L.stack_directions(one(), one()) if D == 2 else one()
        x = torch.randn((S, T, F), generator=gen)
        shape = (2, S, H) if D == 2 else (S, H)
        st = tuple(0.5 * torch.randn(shape, generator=gen) for _ in range(2))
        mod = LS
    else:
        nira = load_adjacency_template()
        if name == "ggru":
            p = L.stack_directions(*(C.init_ggru_cell(gen, F, H, nira)
                                     for _ in range(2)))
            st = 0.5 * torch.randn((2, S, nodes, H), generator=gen)
            mod = GG
        else:
            p = _cell(gen, cell, F, H)
            st = tuple(0.5 * torch.randn((2, S, nodes, H), generator=gen)
                       for _ in range(2))
            mod = G
        x = torch.randn((S, T, nodes, F), generator=gen)
    cuda = lambda t: tuple(cuda(s) for s in t) if isinstance(t, tuple) \
        else t.cuda()
    args = (p.cuda(), x.cuda(), cuda(st),
            torch.tensor([min(v, T) for v in _ragged(S, T)], device="cuda"))
    return (getattr(mod, f"bi_{name}"), getattr(mod, f"bi_{name}_reference"),
            args)


def _outputs(out):
    y, st = out
    return [y] + (list(st) if isinstance(st, tuple) else [st])


@pytest.mark.cuda
@pytest.mark.parametrize("name,H,S,D,cell,window", [
    ("gcn_lstm", H, S, 2, "a3gc", 60) for H in (64, 128, 256)
    for S in (1, 8, 12)
] + [("gcn_lstm", H, 8, 2, "aagc", 60) for H in (64, 128, 256)]
  + [("gcn_lstm", H, 1, 2, "aagc", 60) for H in (128, 256)]
  + [("gcn_lstm", 64, 16, 2, "a3gc", 1024)]
  + [("ggru", H, S, 2, "ggru", 60) for H in (64, 128, 256) for S in (1, 8)]
  + [("lstm", H, 8, D, "lstm", 60) for H in (64, 256, 512) for D in (2, 1)])
def test_torch_port_tf32_kernel_matches_plain_on_card(name, H, S, D, cell,
                                                      window):
    """Each kernel's TF32 instantiation against its plain version with TF32
    operands, every frame and the final state, ragged n_valid and an idle
    stream: within PREC_KERNEL_TOL; one launch, counted as a TF32 one; the
    idle stream's state passes through; and, over one frame and over a
    window (60 frames, and 1024 at batched evaluation's S = 16), nearer the
    plain version at "tf32" than the plain version at "fp32" is (the rms
    ratio), where the fp32 kernel is not. The graph kernels run their
    tensor-core paths (every width here has one)."""
    _need_card()
    for T, bound in ((1, PREC_SEP_FRAME), (window, PREC_SEP_WINDOW)):
        kernel, plain, args = _tf32_case(name, H, S, D, T=T, cell=cell)
        kernel.launches = kernel.tf32_launches = 0
        with torch.no_grad():
            got = _outputs(kernel(*args, "tf32"))
            want = _outputs(plain(*args, "tf32"))
            fp32 = _outputs(kernel(*args, "fp32"))
            gap = _rms(_outputs(plain(*args, "fp32")), want)
        torch.cuda.synchronize()
        assert (kernel.launches, kernel.tf32_launches) == (2, 1)
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            assert (a - b).abs().max().item() <= PREC_KERNEL_TOL
        assert _rms(got, want) <= bound * gap < _rms(fp32, want), T
    if S > 4:                                   # stream 4 is idle
        state = args[2] if isinstance(args[2], tuple) else (args[2],)
        for final, start in zip(got[1:], state):
            torch.testing.assert_close(final[..., 4, :, :] if name != "lstm"
                                       else final[..., 4, :],
                                       start[..., 4, :, :] if name != "lstm"
                                       else start[..., 4, :],
                                       rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,n_valid", [(1, 1), (60, 37), (60, 60)])
@pytest.mark.parametrize("H", [128, 256])
@pytest.mark.parametrize("cell", ["a3gc", "aagc"])
def test_torch_port_gcn_lstm_wide_plan_matches_plain_on_card(cell, H, T,
                                                             n_valid):
    """One stream's TF32 plan spreads each direction over twice the CTAs
    of the portable plan (C = 8 at H = 128, a non-portable 16 at 256): the
    card holds both clusters at once, the layer call launches that plan
    (``launches_by_cluster``), and on a frame and on a window, whole or
    ragged, it is within PREC_KERNEL_TOL of the plain version at "tf32" and
    nearer it than the plain version at "fp32" is (the rms ratio of
    compare_formats), as is the portable plan on the same inputs."""
    _need_card()
    from a3gc_tpu_torch.ops import gcn_lstm as G
    att = cell == "a3gc"
    wide = G.launch_plan(15, H, att, tf32=True, S=1)
    portable = G.launch_plan(15, H, att, tf32=True)
    assert (wide.C, wide.mma) == (2 * portable.C, 1)
    assert G.max_active(wide, 1, 15, H, att, tf32=True) >= 2
    kernel, plain, args = _tf32_case("gcn_lstm", H, 1, T=T, cell=cell)
    args = args[:3] + (torch.tensor([n_valid], device="cuda"),)
    bound = PREC_SEP_FRAME if T == 1 else PREC_SEP_WINDOW
    kernel.launches_by_cluster = {}
    with torch.no_grad():
        got = _outputs(kernel(*args, "tf32"))
        assert kernel.launches_by_cluster == {wide.C: 1}
        want = _outputs(plain(*args, "tf32"))
        gap = _rms(_outputs(plain(*args, "fp32")), want)
        sargs = G.scan_inputs(*args, "tf32")
        old = list(G.scan(*sargs, plan=portable, tf32=True))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= PREC_KERNEL_TOL
    assert _rms(got, want) <= bound * gap
    assert _rms(old, want) <= bound * gap
    if n_valid < T:          # frames past n_valid: y = tanh(the final h)
        torch.testing.assert_close(got[0][0, n_valid:, :, :H],
                                   torch.tanh(got[1][0, 0]).expand(
                                       T - n_valid, -1, -1),
                                   rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_torch_port_gcn_lstm_wide_plan_long_ragged_window_on_card():
    """The one-stream plan at the A3GC cell's longest windows (T = 2048, C =
    16 at H = 256), ragged: 2047 frames of two exchanges each (hy with the
    partial q, then s·u), where a frame's bytes landing in another frame's
    mbarrier phase or partial buffer would show. Within PREC_KERNEL_TOL of
    the plain version at "tf32" and nearer it than the plain version at
    "fp32" is by the window's bound (compare_formats); past n_valid y is
    tanh of the final h."""
    _need_card()
    from a3gc_tpu_torch.ops import gcn_lstm as G
    T, n_valid, H = 2048, 2047, 256
    kernel, plain, args = _tf32_case("gcn_lstm", H, 1, T=T)
    args = args[:3] + (torch.tensor([n_valid], device="cuda"),)
    kernel.launches_by_cluster = {}
    with torch.no_grad():
        got = _outputs(kernel(*args, "tf32"))
        want = _outputs(plain(*args, "tf32"))
        gap = _rms(_outputs(plain(*args, "fp32")), want)
    torch.cuda.synchronize()
    assert kernel.launches_by_cluster == {
        G.launch_plan(15, H, True, tf32=True, S=1).C: 1} == {16: 1}
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= PREC_KERNEL_TOL
    assert _rms(got, want) <= PREC_SEP_WINDOW * gap
    torch.testing.assert_close(got[0][0, n_valid:, :, :H],
                               torch.tanh(got[1][0, 0]).expand(
                                   T - n_valid, -1, -1), rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tf32,mma", [(False, False), (True, False),
                                      (True, True)])
def test_torch_port_gcn_lstm_attention_has_no_local_memory_on_card(tf32,
                                                                   mma):
    """Every instantiation with attention (fp32, the TF32 FMA form, the
    tensor-core form) keeps its window's weights and sums in registers:
    no local memory (spills or stack), by cudaFuncGetAttributes."""
    _need_card()
    from a3gc_tpu_torch.ops import gcn_lstm as G
    attrs = G.func_attributes(True, tf32, mma)
    assert attrs["local_bytes"] == 0, attrs
    assert attrs["regs"] <= 255


@pytest.mark.cuda
@pytest.mark.parametrize("H,S,D,P,mma", [
    (H, S, D, None, mma) for H in (64, 128, 256, 512) for S in (1, 8)
    for D in (2, 1) for mma in (True, False)
] + [(64, 8, 2, 4, True), (128, 8, 2, 16, True), (256, 8, 2, 16, True),
     (256, 12, 2, 8, True), (64, 12, 1, 2, True), (64, 3, 2, None, True)])
def test_torch_port_lstm_tf32_forms_match_plain_on_card(H, S, D, P, mma):
    """``lstm.cu``'s TF32 instantiation in each form at each dense serving
    width (the tensor-core form at its plan's P and at the other measured
    candidates, the FMA form at the fp32 plan's), on the hoisted inputs,
    ragged n_valid: within PREC_KERNEL_TOL of the plain scan at "tf32",
    nearer it than the plain scan at "fp32" by the window's bound, and the
    initial state untouched."""
    from a3gc_tpu_torch.ops import lstm as LS
    _need_card()
    _, _, args = _tf32_case("lstm", H, S, D, F=H)
    plan = LS.launch_plan(S, H, torch.cuda.get_device_properties(0)
                          .multi_processor_count, P=P, D=D, tf32=True,
                          mma=mma)
    assert plan.mma == int(mma)
    with torch.no_grad():
        sargs = LS.scan_inputs(*args, "tf32")
        before = [t.clone() for t in sargs[2:4]]
        got = LS.scan(*sargs, plan=plan, tf32=True)
        want = LS.scan_reference(*sargs, tf32=True)
        gap = _rms(LS.scan_reference(*sargs, tf32=False), want)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(before, sargs[2:4]))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= PREC_KERNEL_TOL
    assert _rms(got, want) <= PREC_SEP_WINDOW * gap


@pytest.mark.cuda
def test_torch_port_default_precision_serves_tf32_on_card():
    """A cascade at precision="default" on the card runs the kernels' TF32
    instantiation (every launch a TF32 one) and stays near the same
    cascade at "highest"; at "highest" no launch is a TF32 one."""
    _need_card()
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                                cascade_apply, init_pose_net)
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.smpl import ParametricModel
    nira = load_adjacency_template()

    def cfg(precision):
        return CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
            cell="a3gc", units_in=ui, units_out=uo, units_hidden=h,
            precision=precision), rotsize=rot)
            for h, ui, uo, rot in ((64, 12, 3, 3), (32, 15, 3, 3),
                                   (64, 15, 9, 9))))

    params3 = tuple(init_pose_net(torch.Generator().manual_seed(i), c,
                                  nira).cuda()
                    for i, c in enumerate(cfg("highest").stages))
    out3 = params3[2].linear_out            # near rotations, as trained
    with torch.no_grad():
        out3.kernel.mul_(0.1)
        out3.bias.copy_(torch.eye(3, device="cuda").flatten())
    imu = torch.randn((2, 90, 15, 12),
                      generator=torch.Generator().manual_seed(5)).cuda()
    out = {}
    for precision in ("highest", "default"):
        G.bi_gcn_lstm.launches = G.bi_gcn_lstm.tf32_launches = 0
        with torch.no_grad():
            out[precision] = cascade_apply(params3, cfg(precision),
                                           ParametricModel(), imu)
        torch.cuda.synchronize()
        assert G.bi_gcn_lstm.launches == 6
        assert G.bi_gcn_lstm.tf32_launches == (6 if precision == "default"
                                               else 0)
    delta = (out["default"] - out["highest"]).abs().max().item()
    assert 0.0 < delta <= 5e-2


@pytest.mark.cuda
def test_torch_port_ggru_cascade_launch_plan_on_card():
    """One offline G-GRU cascade call of one stream at the published widths
    256 / 64 / 128, precision "default" (TF32 operands): six TF32 ``ggru``
    launches, every one of them of the plan C = 8
    (``launches_by_cluster``), no plain dispatch, a finite pose."""
    _need_card()
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                                cascade_apply, init_pose_net)
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.smpl import ParametricModel
    nira = load_adjacency_template()
    cfg = CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
        cell="ggru", units_in=ui, units_out=uo, units_hidden=h,
        precision="default"), rotsize=rot)
        for h, ui, uo, rot in ((256, 12, 3, 3), (64, 15, 3, 3),
                               (128, 15, 9, 9))))
    params3 = tuple(init_pose_net(torch.Generator().manual_seed(i), c,
                                  nira).cuda()
                    for i, c in enumerate(cfg.stages))
    imu = torch.randn((1, 300, 15, 12),
                      generator=torch.Generator().manual_seed(6)).cuda()
    w = GG.bi_ggru
    w.launches = w.tf32_launches = w.plain_dispatches = 0
    w.launches_by_cluster = {}
    with torch.no_grad():
        pose = cascade_apply(params3, cfg, ParametricModel(), imu)
    torch.cuda.synchronize()
    assert pose.shape == (300, 24, 3, 3) and torch.isfinite(pose).all()
    assert w.launches == w.tf32_launches == 6
    assert w.plain_dispatches == 0
    assert w.launches_by_cluster == {8: 6}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp"])
def test_torch_port_cascade_plans_once_on_card(kind, monkeypatch):
    """Two offline sequences of one stream through ``cascade_apply`` at the
    published widths 256 / 64 / 128, precision "default": the first
    computes one launch plan a width (the dispatch's, which the launch
    reads from the same cache), the second none; six kernel launches
    each, no plain dispatch."""
    _need_card()
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                                cascade_apply, init_pose_net)
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    from a3gc_tpu_torch.smpl import ParametricModel
    widths = (256, 64, 128)
    if kind == "tp":
        mod, wrapper = LS, LS.bi_lstm
        cfg = CascadeConfig(*(PoseNetConfig(net=N.DIPConfig(
            n_input=ni, n_output=no, n_hidden=h, precision="default"),
            rotsize=rot) for h, (ni, no, rot) in zip(
                widths, ((72, 15, 3), (87, 69, 3), (141, 135, 9)))))
        shape = (72,)
    else:
        mod = GG if kind == "ggru" else G
        wrapper = GG.bi_ggru if kind == "ggru" else G.bi_gcn_lstm
        cfg = CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
            cell=kind, units_in=ui, units_out=uo, units_hidden=h,
            precision="default"), rotsize=rot)
            for h, (ui, uo, rot) in zip(
                widths, ((12, 3, 3), (15, 3, 3), (15, 9, 9)))))
        shape = (15, 12)
    nira = load_adjacency_template()
    params3 = tuple(init_pose_net(torch.Generator().manual_seed(i), c,
                                  nira).cuda()
                    for i, c in enumerate(cfg.stages))
    computed = []
    launch_plan = mod.launch_plan

    def counted(*args, **kwargs):
        computed.append(args)
        return launch_plan(*args, **kwargs)

    monkeypatch.setattr(mod, "launch_plan", counted)
    mod.cached_plan.cache_clear()
    gen = torch.Generator().manual_seed(9)
    for T, want in ((300, 3), (240, 0)):
        wrapper.launches = wrapper.plain_dispatches = 0
        imu = torch.randn((1, T) + shape, generator=gen).cuda()
        computed.clear()
        with torch.no_grad():
            pose = cascade_apply(params3, cfg, ParametricModel(), imu)
        torch.cuda.synchronize()
        assert pose.shape == (T, 24, 3, 3) and torch.isfinite(pose).all()
        assert len(computed) == want
        assert wrapper.launches == 6 and wrapper.plain_dispatches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind,H,S", [("a3gc", 80, 8), ("a3gc", 80, 1),
                                      ("ggru", 152, 8), ("tp", 268, 8)])
def test_torch_port_auto_runs_plain_where_no_plan_on_card(kind, H, S):
    """At a width the kernel has no launch plan for, backend="auto" at
    "default" runs the plain version on the card: bit-equal to "eager", no
    launch, two plain dispatches (one a layer call); backend="cuda" still
    raises there."""
    _need_card()
    import dataclasses
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import ggru as GG
    from a3gc_tpu_torch.ops import lstm as LS
    gen = torch.Generator().manual_seed(3)
    T = 60
    if kind == "tp":
        cfg = N.DIPConfig(n_input=72, n_output=15, n_hidden=H,
                          precision="default")
        params = N.init_dip(gen, cfg).cuda()
        x = torch.randn((S, T, 72), generator=gen).cuda()
        apply, wrapper = N.dip_apply, LS.bi_lstm
    else:
        cfg = N.GraphNetConfig(cell=kind, units_in=12, units_out=9,
                               units_hidden=H, precision="default")
        params = N.init_graph_net(gen, cfg, load_adjacency_template()).cuda()
        x = torch.randn((S, T, 15, 12), generator=gen).cuda()
        apply = N.graph_net_apply
        wrapper = GG.bi_ggru if kind == "ggru" else G.bi_gcn_lstm
    assert N.plan_refusal(cfg, S, "tf32", x.device) is not None
    out = {}
    for backend in ("auto", "eager"):
        for w in (G.bi_gcn_lstm, GG.bi_ggru, LS.bi_lstm):
            w.launches = w.tf32_launches = w.plain_dispatches = 0
        with torch.no_grad():
            out[backend] = apply(params, dataclasses.replace(
                cfg, backend=backend), x, device="cuda")
        torch.cuda.synchronize()
        assert wrapper.launches == 0
        assert wrapper.plain_dispatches == (2 if backend == "auto" else 0)
    got, want = out["auto"], out["eager"]
    assert torch.equal(got[0], want[0])
    leaves = [got[1]] if isinstance(got[1], torch.Tensor) else got[1]
    assert torch.isfinite(got[0]).all() and all(
        torch.isfinite(t).all() for t in torch.utils._pytree.tree_leaves(
            leaves))
    if kind == "a3gc":
        with pytest.raises(ValueError, match="no launch plan"):
            with torch.no_grad():
                apply(params, dataclasses.replace(cfg, backend="cuda"), x,
                      device="cuda")


@pytest.mark.cuda
def test_torch_port_graft_entry_on_card_matches_plain():
    """``entry()`` on the card: six TF32 ``gcn_lstm`` launches (the S = 1
    instantiation of the ``_dirfused_kernel`` counterpart), the poses
    within JAX's own Pallas-vs-XLA angle at "default" (0.034 deg mean,
    0.335 max) of the same cascade at backend="eager", stage 3 emitting
    near rotations (as a trained net does: on raw random outputs IK
    magnifies any rounding)."""
    _need_card()
    import dataclasses
    from a3gc_tpu_torch import graft_entry as GE
    from a3gc_tpu_torch.models.pipeline import cascade_apply
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops.rotations import angle_between
    cfg, _, model, _ = GE._flagship(device="cuda")
    fn, (p3, imu) = GE.entry(device="cuda")
    with torch.no_grad():
        p3[2].linear_out.kernel.mul_(0.1)
        p3[2].linear_out.bias.copy_(torch.eye(3, device="cuda").flatten())
    imu = torch.randn(imu.shape, generator=torch.Generator().manual_seed(4)
                      ).mul_(0.5).cuda()
    G.bi_gcn_lstm.launches = G.bi_gcn_lstm.tf32_launches = 0
    got = fn(p3, imu)
    torch.cuda.synchronize()
    assert G.bi_gcn_lstm.launches == G.bi_gcn_lstm.tf32_launches == 6
    eager = dataclasses.replace(cfg, **{
        f"stage{i + 1}": dataclasses.replace(
            s, net=dataclasses.replace(s.net, backend="eager"))
        for i, s in enumerate(cfg.stages)})
    want = cascade_apply(p3, eager, model, imu, device="cuda")
    deg = torch.rad2deg(angle_between(got.reshape(-1, 3, 3),
                                      want.reshape(-1, 3, 3)))
    assert got.shape == (300, 24, 3, 3) and torch.isfinite(got).all()
    assert float(deg.mean()) <= 0.034 and float(deg.max()) <= 0.335
