"""Launch plans of the port's weight-stationary scan kernels
(``ops/lstm.py``, ``ops/gcn_lstm.py`` and ``ops/ggru.py`` ``launch_plan``),
checked on the
CPU for every layer shape of the serving and offline paths and the small
widths of the card tests: the hidden split is even, shared memory fits a
CTA, clusters are portable, the thread mappings fit the block, and
``scan_inputs`` still produces the layouts the kernels read. The kernels
themselves run only on the card (``tests/test_torch_port_card.py``)."""

import os
import shutil

import numpy as np
import pytest
import torch

from a3gc_tpu_torch.ops import _build
from a3gc_tpu_torch.ops import gcn_lstm as G
from a3gc_tpu_torch.ops import ggru as GG
from a3gc_tpu_torch.ops import lstm as LS
from a3gc_tpu_torch.ops._common import (MAX_CLUSTER, SMEM_LIMIT, THREADS,
                                        k_slices)

H100_SMS = 132


def _check_slices(columns, K, slices):
    """Lanes ks·(32/slices) + column: a power of two ≤ 32, whole float4
    per slice, all columns × slices threads in the block."""
    assert slices in (1, 2, 4, 8, 16, 32)
    assert K % (4 * slices) == 0
    assert columns * slices <= THREADS


@pytest.mark.parametrize("S", [1, 8, 12])
@pytest.mark.parametrize("H", [8, 32, 64, 128, 256, 512])
def test_torch_port_lstm_launch_plan(H, S):
    plan = LS.launch_plan(S, H, H100_SMS)
    assert H % plan.P == 0 and (H // plan.P) % 4 == 0      # even split
    M = 4 * H // plan.P
    assert M <= 64                                          # gate columns
    _check_slices(M, H, plan.KS)
    assert plan.smem <= SMEM_LIMIT
    # the W_hh slice and the full h of R streams are resident
    assert plan.smem >= 4 * (H * M + plan.R * H)
    assert plan.smem == LS.smem_bytes(plan.R, H, plan.P, plan.cooperative)
    assert plan.R == min(8, 1 << (S - 1).bit_length())
    n_blocks = -(-S // plan.R)
    if plan.cooperative:
        assert plan.cluster == 1 and plan.P > MAX_CLUSTER
        assert 1 <= plan.groups <= n_blocks
        assert plan.ctas <= H100_SMS          # one resident CTA per SM
    else:
        assert plan.cluster == plan.P <= MAX_CLUSTER
        assert plan.groups == n_blocks


def test_torch_port_lstm_plan_regimes():
    """The serving widths land where the kernel's notes say: clusters of
    4/8 at H = 64/128, cooperative groups of 16/32 at H = 256/512 (more
    CTAs than a portable cluster holds)."""
    got = {H: LS.launch_plan(8, H, H100_SMS) for H in (64, 128, 256, 512)}
    assert [(got[H].P, got[H].cooperative) for H in (64, 128, 256, 512)] \
        == [(4, False), (8, False), (16, True), (32, True)]
    # more stream blocks than fit at once run in waves
    waves = LS.launch_plan(20, 512, H100_SMS)
    assert waves.groups == 2 and -(-20 // waves.R) == 3


@pytest.mark.parametrize("S", [1, 8, 12, 40])
@pytest.mark.parametrize("H", [8, 64, 128, 256, 512])
def test_torch_port_lstm_launch_plan_one_direction(H, S):
    """D = 1 (the unidirectional DIP net): the split and shared memory of
    D = 2, a grid of one layer; a cooperative grid holds up to sms // P
    stream blocks at once where two directions hold sms // (2P), which
    changes ``groups`` only past the serving shapes."""
    one, two = (LS.launch_plan(S, H, H100_SMS, D=d) for d in (1, 2))
    assert one.D == 1 and two.D == 2
    assert one._replace(groups=0, D=0) == two._replace(groups=0, D=0)
    n_blocks = -(-S // one.R)
    if one.cooperative:
        assert one.groups == min(n_blocks, H100_SMS // one.P)
        assert one.ctas == one.P * one.groups <= H100_SMS
    else:
        assert one.groups == two.groups == n_blocks
        assert one.ctas == two.ctas // 2
    if S <= 12:                     # every serving shape: the same groups
        assert one.groups == two.groups
    if (H, S) == (512, 40):         # 5 blocks: 4 at once, against 2
        assert (one.groups, two.groups) == (4, 2)
    with pytest.raises(ValueError, match="D in"):
        LS.launch_plan(S, H, H100_SMS, D=3)


def test_torch_port_lstm_scan_inputs_layout_one_direction():
    from a3gc_tpu_torch.models import nets as N
    rng = np.random.default_rng(0)
    S, H, T = 3, 32, 7
    p = N.init_dip(torch.Generator().manual_seed(0),
                   N.DIPConfig(n_hidden=H, bidirectional=False)).lstm[1]
    assert LS.directions(p) == 1
    x = torch.as_tensor(rng.normal(size=(S, T, H)).astype(np.float32))
    st = tuple(torch.as_tensor(rng.normal(size=(S, H)).astype(np.float32))
               for _ in range(2))
    u, w_hh, h0, c0, nv = LS.scan_inputs(p, x, st, [T] * S)
    for t, shape in ((u, (1, S, T, 4 * H)), (w_hh, (1, H, 4 * H)),
                     (h0, (1, S, H)), (c0, (1, S, H))):
        assert t.shape == shape and t.dtype == torch.float32
        assert t.is_contiguous()
    assert torch.equal(h0[0], st[0]) and torch.equal(w_hh[0], p.w_hh)
    want = x @ p.w_ih + p.b_ih + p.b_hh
    assert torch.allclose(u[0], want, atol=1e-5)


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("H", [8, 32, 64, 128, 256])
def test_torch_port_gcn_lstm_launch_plan(H, attention):
    N = 15
    plan = G.launch_plan(N, H, attention)
    assert H % plan.C == 0 and (H // plan.C) % 4 == 0      # even split
    Hc = H // plan.C
    assert plan.cluster == plan.C <= MAX_CLUSTER
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem >= 4 * (H * 4 * Hc + 2 * 16 * H)      # W_h slice, h
    assert plan.smem == G.smem_bytes(N, H, plan.C, plan.KSQ, attention)
    _check_slices(Hc, H, plan.KS)              # 4-column groups of W_h
    _check_slices(Hc // 2, H, plan.KSA)        # column pairs of Wh
    _check_slices(Hc, H, plan.KSQ)             # columns of W and Wq
    if attention:                              # W, Wh slices in registers
        assert 2 * (H // plan.KSA) <= G.MAX_KCA and H // plan.KSQ <= G.MAX_KW
    expected_c = {8: 1, 32: 2, 64: 4, 128: 4, 256: 8}[H]
    assert plan.C == expected_c


@pytest.mark.parametrize("S", [1, 3, 8, 12])
@pytest.mark.parametrize("H", [8, 32, 64, 128, 256])
def test_torch_port_ggru_launch_plan(H, S):
    N = 15
    plan = GG.launch_plan(S, N, H)
    assert H % plan.C == 0 and (H // plan.C) % 4 == 0      # even split
    Hc = H // plan.C
    assert plan.cluster == plan.C <= MAX_CLUSTER
    assert plan.threads == GG.THREADS
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem == GG.smem_bytes(N, H, plan.C)
    # the slice of G·W_hid and two [16, H] buffers of adj·h are resident
    assert plan.smem >= 4 * (H * 3 * Hc + 2 * 16 * H)
    _check_slices(Hc // 2, H, plan.KS)         # unit pairs of the gate matrix
    # one stream takes the widest cluster that leaves a CTA 8 columns
    if S == 1:
        assert plan.C == {8: 1, 32: 4, 64: 8, 128: 8, 256: 8}[H]
    # the serving widths at S = 8: H = 64 / 128 fit the wave every H100
    # holds (120 SMs' worth of clusters), H = 256 only fits in clusters of
    # 8 and needs no more CTAs than the card has SMs
    if S == 8 and H in (64, 128):
        assert 2 * S * plan.C <= 120
        assert 2 * S <= GG.one_wave(plan.C, H100_SMS)
    if S == 8 and H == 256:
        assert plan.C == 8 and 2 * S * plan.C <= H100_SMS


@pytest.mark.parametrize("H,C", [(256, 8), (128, 8), (128, 4), (128, 2),
                                 (64, 8), (64, 4), (64, 2), (64, 1),
                                 (32, 8), (32, 4), (32, 2), (32, 1),
                                 (8, 2), (8, 1)])
@pytest.mark.parametrize("S", [1, 8])
def test_torch_port_ggru_forced_plan_is_honoured(H, C, S):
    plan = GG.launch_plan(S, 15, H, C=C)
    assert plan.C == C
    assert plan.smem == GG.smem_bytes(15, H, C) <= SMEM_LIMIT
    _check_slices(H // C // 2, H, plan.KS)


def test_torch_port_ggru_smem_bytes():
    """The H = 256 slice fits a CTA of a cluster of 8 and not one of 4."""
    assert GG.smem_bytes(15, 256, 8) == 147136
    assert GG.smem_bytes(15, 256, 4) > SMEM_LIMIT
    for M in (12, 24, 48, 96, 192):            # banks 4 apart per 4 rows
        assert (4 * M + GG.gate_pad(M)) % 32 == 4 and GG.gate_pad(M) % 4 == 0


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("H", [32, 64, 128])
def test_torch_port_ggru_reassociated_frame_matches_cell(H, scale):
    """What ``ggru.cu`` computes a frame, (adj·h)·(G·W_hid), against the
    cell's own order adj·(h·G)·W_hid (``ggru_step_hoisted``) in fp32, at
    the initial weights and at twice their size; 1e-5 absolute."""
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    gen = torch.Generator().manual_seed(H)
    nira = load_adjacency_template()
    p = L.stack_directions(*(C.init_ggru_cell(gen, H, H, nira)
                             for _ in range(2)))
    S, N = 3, 15
    h = torch.tanh(torch.randn((2, S, N, H), generator=gen))
    zi = torch.randn((2, S, N, 3 * H), generator=gen)
    with torch.no_grad():
        p.gcn_kernel.mul_(scale)
        p.w_hid.mul_(scale)
        (want,) = C.ggru_step_hoisted(p, zi, (h,))
        zh = torch.matmul(torch.matmul(p.adj[:, None], h),
                          torch.matmul(p.gcn_kernel, p.w_hid)[:, None])
        r = torch.sigmoid(zi[..., :H] + zh[..., :H])
        u = torch.sigmoid(zi[..., H:2 * H] + zh[..., H:2 * H])
        cand = torch.tanh(zi[..., 2 * H:] + r * zh[..., 2 * H:])
        got = u * h + (1 - u) * cand
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("kernel,H", [("lstm", 64), ("lstm", 128),
                                      ("lstm", 256), ("gcn_lstm", 64),
                                      ("gcn_lstm", 128)])
def test_torch_port_doubled_split_is_a_valid_plan(kernel, H):
    """scripts/torch_kernel_ab.py times each default split against twice
    it."""
    if kernel == "lstm":
        base = LS.launch_plan(8, H, H100_SMS)
        wide = LS.launch_plan(8, H, H100_SMS, P=2 * base.P)
        assert wide.P == 2 * base.P and wide.smem < base.smem
    else:
        base = G.launch_plan(15, H, True)
        wide = G.launch_plan(15, H, True, C=2 * base.C)
        assert wide.C == 2 * base.C and wide.smem < base.smem


@pytest.mark.parametrize("call", [
    lambda: LS.launch_plan(8, 1024, H100_SMS),       # W_hh over > 132 SMs
    lambda: LS.launch_plan(8, 30, H100_SMS),         # H % 4
    lambda: LS.launch_plan(8, 256, H100_SMS, P=3),   # uneven split
    lambda: G.launch_plan(17, 64, True),             # more than 16 nodes
    lambda: G.launch_plan(15, 256, True, C=16),      # not a portable cluster
    lambda: G.launch_plan(15, 256, True, C=4),       # slice over 227 KB
    lambda: GG.launch_plan(8, 17, 64),               # more than 16 nodes
    lambda: GG.launch_plan(8, 15, 30),               # H % 4
    lambda: GG.launch_plan(0, 15, 64),               # no stream
    lambda: GG.launch_plan(8, 15, 256, C=16),        # not a portable cluster
    lambda: GG.launch_plan(8, 15, 256, C=4),         # slice over 227 KB
    lambda: GG.launch_plan(8, 15, 256, C=3),         # uneven split
    lambda: GG.launch_plan(8, 15, 512),              # 4 MiB fits no cluster
    lambda: GG.launch_plan(8, 15, 64, C=0),          # no CTA
    lambda: GG.launch_plan(8, 15, 128, C=1),         # slice over 227 KB
    lambda: GG.launch_plan(8, 15, 8, C=4),           # 2 columns a CTA
])
def test_torch_port_launch_plan_refuses(call):
    with pytest.raises(ValueError, match="needs|no launch plan"):
        call()


def test_torch_port_k_slices():
    assert k_slices(128, 256) == 2
    assert k_slices(64, 512) == 4
    assert k_slices(32, 8) == 2          # a slice is one float4 at H = 8
    assert k_slices(48, 12) == 1
    for columns in (16, 32, 64, 128, 256):
        for K in (8, 32, 64, 128, 256, 512):
            _check_slices(columns, K, k_slices(columns, K))


@pytest.mark.parametrize("S", [1, 3, 12])
def test_torch_port_lstm_scan_inputs_layout(S):
    from a3gc_tpu_torch.models import nets as N
    rng = np.random.default_rng(S)
    H, T = 32, 7
    p = N.init_dip(torch.Generator().manual_seed(0),
                   N.DIPConfig(n_hidden=H)).lstm[1]
    x = torch.as_tensor(rng.normal(size=(S, T, 2 * H)).astype(np.float32))
    st = tuple(torch.as_tensor(rng.normal(size=(2, S, H)).astype(np.float32))
               for _ in range(2))
    u, w_hh, h0, c0, nv = LS.scan_inputs(p, x, st, [T] * S)
    for t, shape in ((u, (2, S, T, 4 * H)), (w_hh, (2, H, 4 * H)),
                     (h0, (2, S, H)), (c0, (2, S, H))):
        assert t.shape == shape and t.dtype == torch.float32
        assert t.is_contiguous()
    assert nv.dtype == torch.int32 and nv.shape == (S,)
    # u is x·W_ih + b_ih + b_hh per direction, forward frame order
    want = x @ p.w_ih[1] + p.b_ih[1] + p.b_hh[1]
    assert torch.allclose(u[1], want, atol=1e-5)


@pytest.mark.parametrize("attention", [True, False])
def test_torch_port_gcn_lstm_scan_inputs_layout(attention):
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    gen = torch.Generator().manual_seed(1)
    S, T, N, F, H = 3, 5, 15, 16, 32
    nira = load_adjacency_template()
    p = L.stack_directions(*(C.init_gcn_lstm_cell(gen, F, H, nira,
                                                  attention=attention)
                             for _ in range(2)))
    x = torch.randn((S, T, N, F), generator=gen)
    st = tuple(torch.randn((2, S, N, H), generator=gen) for _ in range(2))
    u, wh, adj, bias, att, h0, c0, nv = G.scan_inputs(p, x, st, [T, 2, 0])
    shapes = [(u, (2, S, T, N, 4 * H)), (wh, (2, H, 4 * H)),
              (adj, (2, 4, N, N)), (bias, (2, 4, H)), (h0, (2, S, N, H)),
              (c0, (2, S, N, H))]
    if attention:
        shapes += list(zip(att, [(2, H, H)] * 3 + [(2, H)] * 2 + [(2, N)]))
    else:
        assert att is None
    for t, shape in shapes:
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert t.is_contiguous()
    assert nv.tolist() == [T, 2, 0] and nv.dtype == torch.int32


@pytest.mark.parametrize("n_valid", [None, 3, [5, 2, 0]])
def test_torch_port_ggru_scan_inputs_layout(n_valid):
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    gen = torch.Generator().manual_seed(2)
    S, T, N, F, H = 3, 5, 15, 16, 32
    nira = load_adjacency_template()
    p = L.stack_directions(*(C.init_ggru_cell(gen, F, H, nira)
                             for _ in range(2)))
    x = torch.randn((S, T, N, F), generator=gen)
    h = torch.randn((2, S, N, H), generator=gen)
    zi, gk, adj, w_hid, h0, nv = GG.scan_inputs(p, x, h, n_valid)
    for t, shape in ((zi, (2, S, T, N, 3 * H)), (gk, (2, H, H)),
                     (adj, (2, N, N)), (w_hid, (2, H, 3 * H)),
                     (h0, (2, S, N, H))):
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert t.is_contiguous()
    want = {None: [T] * S, 3: [3] * S}.get(n_valid if not isinstance(
        n_valid, list) else 0, n_valid)
    assert nv.tolist() == want and nv.dtype == torch.int32
    # zi is x·W_in + b_in per direction, forward frame order
    assert torch.allclose(zi[1], x @ p.w_in[1] + p.b_in[1], atol=1e-5)
    assert torch.equal(gk, p.gcn_kernel) and torch.equal(w_hid, p.w_hid)


def test_torch_port_library_digest_covers_headers(tmp_path):
    """An edited csrc/*.cuh renames every library, so no stale build of a
    kernel that includes it is reused."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    copy = tmp_path / "csrc"
    shutil.copytree(csrc, copy)
    before = {n: _build.library_digest(n, str(copy))
              for n in ("gcn_lstm", "ggru", "lstm")}
    with open(copy / "scan_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_digest(n, str(copy))
             for n in ("gcn_lstm", "ggru", "lstm")}
    assert all(before[n] != after[n] for n in before)
    assert before["lstm"] == _build.library_digest("lstm")
