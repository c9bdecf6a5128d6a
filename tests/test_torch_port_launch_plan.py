"""Launch plans of the port's weight-stationary scan kernels
(``ops/lstm.py``, ``ops/gcn_lstm.py`` and ``ops/ggru.py`` ``launch_plan``),
checked on the
CPU for every layer shape of the serving and offline paths and the small
widths of the card tests: the hidden split is even, shared memory fits a
CTA, clusters are portable (but for ``gcn_lstm``'s one-stream tensor-core
plan at H = 256), the thread mappings fit the block, and
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
                                        k_slices, mma_row_stride)

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


def _fp32_plan_pr16(S, H, sms, D):
    r"""The fp32 plan as it stood before the TF32 instantiation had a plan
    of its own (fields R … D), or the refusal's None."""
    R = LS.rows_per_group(S)
    n_blocks = -(-S // R)
    for widest in (64, 128, THREADS):
        for p in range(1, 65):
            Hc = H // p
            if H % p or Hc % 4 or 4 * Hc > widest:
                continue
            coop = p > MAX_CLUSTER
            smem = 64 + 4 * (H * (4 * Hc + 4) + (1 if coop else 2) * R * H
                             + 2 * R * 4 * Hc + 2 * R * Hc)
            groups = min(n_blocks, H100_SMS // (D * p)) if coop else n_blocks
            if smem > SMEM_LIMIT or groups < 1:
                continue
            return (R, p, k_slices(4 * Hc, H), groups, coop, THREADS, smem,
                    D)
    return None


def _plan_or_none(**kw):
    try:
        return LS.launch_plan(**kw)
    except ValueError:
        return None


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 32])
def test_torch_port_lstm_fp32_plan_unchanged(S, D):
    """The fp32 plan is the one before the TF32 plan existed, field for
    field (and FMA), at every H % 4 == 0 up to 800."""
    for H in range(4, 801, 4):
        got = _plan_or_none(S=S, H=H, sms=H100_SMS, D=D)
        want = _fp32_plan_pr16(S, H, H100_SMS, D)
        assert (got is None) == (want is None), H
        if got is not None:
            assert tuple(got[:8]) == want and got.mma == 0, H


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 32])
def test_torch_port_lstm_tf32_plan_covers_fp32(S, D):
    """Wherever the fp32 plan exists the TF32 plan does: on the tensor
    cores where a split fits (a plan the C side takes: even k parts, A in
    128 registers), else the fp32 plan itself in the FMA form; forced to
    the FMA form it is the fp32 plan."""
    for H in range(4, 801, 4):
        fp32 = _plan_or_none(S=S, H=H, sms=H100_SMS, D=D)
        if fp32 is None:
            continue
        tf32 = LS.launch_plan(S, H, H100_SMS, D=D, tf32=True)
        fma = LS.launch_plan(S, H, H100_SMS, D=D, tf32=True, mma=False)
        assert fma == fp32
        if not tf32.mma:
            assert tf32 == fp32, H
            continue
        KS, NKB = LS.mma_split(H, tf32.P)
        assert tf32.KS == KS and KS * NKB == H // 16 and KS in (1, 2)
        assert NKB in (4, 16) and KS * 4 * H // tf32.P <= 8 * 16
        assert tf32.smem == LS.smem_bytes(tf32.R, H, tf32.P,
                                          tf32.cooperative, True)
        assert tf32.smem <= SMEM_LIMIT and tf32.R == fp32.R
        assert tf32.cooperative == (tf32.P > MAX_CLUSTER)
        if tf32.cooperative:
            assert tf32.ctas <= H100_SMS


@pytest.mark.parametrize("D", [2, 1])
@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("H", [64, 128, 256, 512])
def test_torch_port_lstm_tf32_plan_serving_widths(H, S, D):
    """At the dense serving widths the TF32 plan is on the tensor cores at
    the smallest P whose ``mma_split`` exists (2 / 8 / 8 / 32 at H = 64 /
    128 / 256 / 512, the P measured best), whatever S and D."""
    plan = LS.launch_plan(S, H, H100_SMS, D=D, tf32=True)
    assert plan.mma == 1
    assert plan.P == min(p for p in range(1, 65)
                         if LS.mma_split(H, p) is not None)
    assert plan.P == {64: 2, 128: 8, 256: 8, 512: 32}[H]
    assert plan.cooperative == (plan.P > MAX_CLUSTER)


@pytest.mark.parametrize("H,P,coop", [(64, 2, False), (64, 4, False),
                                      (128, 8, False), (256, 8, False),
                                      (256, 16, True), (512, 32, True)])
def test_torch_port_lstm_mma_smem_bytes(H, P, coop):
    """The tensor-core form's shared memory: the W_hh slice staged as the
    FMA form stages it (rows padded by 4 floats), 8 rows of the full h
    padded to a stride ≡ 16 (mod 32) floats (double-buffered in a
    cluster), the k parts' z slices with rows padded by 4 floats, u, c and
    h."""
    KS = LS.mma_split(H, P)[0]
    Hc = H // P
    M = 4 * Hc
    HS = mma_row_stride(H)
    assert HS >= H and HS % 32 == 16
    for R in (1, 2, 4, 8):
        floats = (H * (M + 4) + (1 if coop else 2) * 8 * HS
                  + KS * R * (M + 4) + R * M + 2 * R * Hc)
        assert LS.smem_bytes(R, H, P, coop, True) == 64 + 4 * floats
        assert LS.smem_bytes(R, H, P, coop, True) <= SMEM_LIMIT
    assert LS.smem_bytes(8, 64, 2, False, True) == 49344
    assert LS.smem_bytes(8, 128, 8, False, True) == 51520
    assert LS.smem_bytes(8, 512, 32, True, True) == 163648


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


@pytest.mark.parametrize("S", [1, 3, 8, 12])
@pytest.mark.parametrize("H", [8, 32, 64, 128, 256])
def test_torch_port_ggru_tf32_launch_plan(H, S):
    """The TF32 instantiation (the cell's order: slices of G and W_hid,
    msg and h exchanged) fits the clusters the fp32 one takes."""
    N = 15
    plan = GG.launch_plan(S, N, H, tf32=True)
    Hc = H // plan.C
    assert plan.smem == GG.smem_bytes(N, H, plan.C, True,
                                      plan.mma) <= SMEM_LIMIT
    assert plan.smem >= 4 * (H * 4 * Hc + 4 * 16 * H)
    assert plan.smem > GG.smem_bytes(N, H, plan.C)
    assert plan[:3] == GG.launch_plan(S, N, H)[:3]
    _check_slices(Hc // 2, H, plan.KS)
    # on the tensor cores wherever the shape allows: all of G resident up to
    # H = 128 (one exchange a frame), G's own columns at 256
    assert plan.mma == ((2 if H <= 128 else 1) if GG.mma_ok(H, Hc) else 0)
    assert GG.launch_plan(S, N, H).mma == 0


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("H", [8, 32, 64, 128, 256])
def test_torch_port_gcn_lstm_tf32_launch_plan(H, attention):
    """The TF32 instantiation takes the fp32 split, on the tensor cores
    wherever the shape allows (every serving width): W_h's slice
    transposed, the full h's rows padded to a stride ≡ 16 (mod 32), the
    mixed gates' by 8 floats, within a CTA's shared memory."""
    N = 15
    base = G.launch_plan(N, H, attention)
    plan = G.launch_plan(N, H, attention, tf32=True)
    Hc = H // plan.C
    assert plan[:5] == base[:5] and base.mma == 0
    assert plan.mma == int(G.mma_ok(H, Hc, attention))
    assert plan.smem == G.smem_bytes(N, H, plan.C, plan.KSQ, attention,
                                     bool(plan.mma)) <= SMEM_LIMIT
    if H in (64, 128, 256):
        assert plan.mma == 1
    if plan.mma:
        HS = mma_row_stride(H)
        assert HS >= H and HS % 32 == 16
        M = 4 * Hc
        assert M in (64, 128)             # 1 or 2 n-tiles a warp
        assert Hc % (8 * (M // 64)) == 0  # a warp's n-tiles in one gate
        assert plan.smem >= 4 * (H * M + 2 * 16 * HS + 16 * (M + 8))
    forced = G.launch_plan(N, H, attention, tf32=True, mma=False)
    assert forced.mma == 0 and forced.smem == base.smem


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("H,wide", [(64, 4), (128, 8), (256, 16)])
def test_torch_port_gcn_lstm_one_stream_launch_plan(H, wide, attention):
    """At S = 1 the TF32 tensor-core plan spreads a (stream, direction)
    over twice the portable plan's CTAs where the doubled split keeps a
    tensor-core plan (64 gate columns a CTA): 8 at H = 128, 16 (a
    non-portable cluster) at 256; H = 64 keeps 4 (32 columns a CTA have no
    tensor-core plan). Shared memory, k-slices and registers as the C side
    recomputes them; the fp32 and FMA instantiations keep their plans."""
    N = 15
    plan = G.launch_plan(N, H, attention, tf32=True, S=1)
    Hc = H // plan.C
    assert (plan.C, plan.mma) == (wide, 1) and 4 * Hc == 64
    assert plan.C <= G.MAX_CLUSTER_WIDE
    assert (plan.C > MAX_CLUSTER) == (H == 256)
    assert G.mma_ok(H, Hc, attention)
    assert plan.smem == G.smem_bytes(N, H, plan.C, plan.KSQ, attention,
                                     True) <= SMEM_LIMIT
    assert plan == G.launch_plan(N, H, attention, C=wide, tf32=True,
                                 mma=True)
    _check_slices(Hc, H, plan.KS)
    _check_slices(Hc // 2, H, plan.KSA)
    _check_slices(Hc, H, plan.KSQ)
    if attention:
        assert 2 * (H // plan.KSA) <= G.MAX_KCA and H // plan.KSQ <= G.MAX_KW
    portable = G.launch_plan(N, H, attention, tf32=True)
    assert plan.C == portable.C * (1 if H == 64 else 2)
    assert plan.smem <= portable.smem
    for kw in ({}, {"tf32": True, "mma": False}):
        assert (G.launch_plan(N, H, attention, S=1, **kw)
                == G.launch_plan(N, H, attention, **kw))


@pytest.mark.parametrize("S", [None, 2, 3, 8, 12, 16])
@pytest.mark.parametrize("H", [64, 128, 256])
def test_torch_port_gcn_lstm_serving_plan_keeps_its_cluster(H, S):
    """At S ≥ 2 (the serving, streaming and batched paths) the grid fills
    the card and every instantiation keeps the portable plan."""
    for attention in (True, False):
        for kw in ({}, {"tf32": True}, {"tf32": True, "mma": False}):
            plan = G.launch_plan(15, H, attention, S=S, **kw)
            assert plan == G.launch_plan(15, H, attention, **kw)
            assert plan.C == {64: 4, 128: 4, 256: 8}[H] <= MAX_CLUSTER


@pytest.mark.parametrize("H", [32, 64, 128, 256])
def test_torch_port_tf32_mma_smem_bytes(H):
    """The tensor-core plans' shared memory: every plan fits 232,448 B;
    gcn_lstm's at H = 256 (the widest) is below the FMA path's (W_h's slice
    unpadded); ggru holds all of G up to H = 128 and only its own columns
    at 256, where all of G (256 KiB) cannot fit."""
    N = 15
    for attention in (True, False):
        p = G.launch_plan(N, H, attention, tf32=True)
        assert p.mma == 1 and p.smem <= SMEM_LIMIT
    for S in (1, 8):
        p = GG.launch_plan(S, N, H, tf32=True)
        whole = GG.smem_bytes(N, H, p.C, True, 2)
        assert whole >= 4 * H * H
        assert p.smem == (whole if H <= 128 else
                          GG.smem_bytes(N, H, p.C, True, 1)) <= SMEM_LIMIT
        assert (whole <= SMEM_LIMIT) == (H <= 128)
    assert G.smem_bytes(N, 256, 8, 8, True, True) == 230224
    assert G.smem_bytes(N, 256, 8, 8, True) == 231760
    assert GG.smem_bytes(N, 256, 8, True, 1) == 215744
    assert GG.smem_bytes(N, 128, 4, True, 2) == 157376


def test_torch_port_ggru_smem_bytes():
    """The H = 256 slice fits a CTA of a cluster of 8 and not one of 4."""
    assert GG.smem_bytes(15, 256, 8) == 147136
    assert GG.smem_bytes(15, 256, 8, tf32=True) == 213696
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
    # lstm's tensor-core plans: fp32 operands, A over 128 registers or a
    # tile a warp, a width without 16-deep k-blocks
    lambda: LS.launch_plan(8, 64, H100_SMS, mma=True),
    lambda: LS.launch_plan(8, 64, H100_SMS, P=1, tf32=True, mma=True),
    lambda: LS.launch_plan(8, 512, H100_SMS, P=16, tf32=True, mma=True),
    lambda: LS.launch_plan(8, 72, H100_SMS, tf32=True, mma=True),
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
    # tensor-core plans: a shape without them, fp32 operands, all of G
    # over 227 KB
    lambda: G.launch_plan(15, 8, True, tf32=True, mma=True),
    lambda: G.launch_plan(15, 64, True, mma=True),
    # a split the tensor cores cannot take: 32 gate columns a CTA, a
    # non-portable cluster on the FMA path or past 16 CTAs, no stream
    lambda: G.launch_plan(15, 64, True, C=8, tf32=True, mma=True),
    lambda: G.launch_plan(15, 128, True, C=16, tf32=True),
    lambda: G.launch_plan(15, 256, True, C=16, tf32=True, mma=False),
    lambda: G.launch_plan(15, 256, True, C=32, tf32=True, mma=True),
    lambda: G.launch_plan(15, 256, True, tf32=True, S=0),
    lambda: GG.launch_plan(8, 15, 8, tf32=True, mma=1),
    lambda: GG.launch_plan(8, 15, 64, mma=2),
    lambda: GG.launch_plan(8, 15, 256, tf32=True, mma=2),
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
