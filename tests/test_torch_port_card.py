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
    """Per-stream valid lengths with full, short and idle streams."""
    return [T, T, 37, T, 0, T, T, T, 11, T, 59, T][:S]


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
    _need_card()
    from a3gc_tpu_torch.ops import gcn_lstm as G
    gen = torch.Generator().manual_seed(1)
    p = _cell(gen, "a3gc", 8, 8).cuda()
    x = torch.zeros((1, 4, 15, 8), device="cuda")
    st = tuple(torch.zeros((2, 1, 15, 8), device="cuda") for _ in range(2))
    with pytest.raises(RuntimeError, match="forward-only"):
        G.bi_gcn_lstm(p, x, st)


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
    fake (output shapes) against the kernel's outputs, no autograd
    registration, dispatch under ``torch.compile``'s AOT tracing."""
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
