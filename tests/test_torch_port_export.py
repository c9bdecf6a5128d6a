"""The port's deployment artifacts (a3gc_tpu_torch.export) on the CPU: the
three kernel ops of ``ops/library.py`` (``torch.library.opcheck``), CPU
artifacts of every family against the JAX package's ``backend="xla"``
artifacts on the same numpy params and inputs and against the port's live
sessions, a K = P = 1 bundle through ``ArtifactLookaheadSession``, the
refusals, the unidirectional DIP net's per-slot reset, and a fresh process
that loads an artifact from its directory alone.

Tolerances: 1e-4 on poses and carried states against JAX (fp32 on both
sides, three stages and IK, as in the other cascade tests); 1e-6 against
the port's live sessions (the same ops on the same inputs)."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from a3gc_tpu import export as JX
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu_torch import export as TX
from a3gc_tpu_torch.compat.from_jax import (cascade_params_from_jax,
                                            dip_params_from_jax)
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.eval import streaming as TS
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.models import pipeline as TPL
from a3gc_tpu_torch.smpl import ParametricModel

from torch_port_oracle import cascades, jax_dip, state_leaves, to_jnp

# tiny tensors: intra-op threads would only contend with the other test
# workers'
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = 1e-4
LIVE_TOL = 1e-6
S, W = 2, 8
FAMILIES = ("a3gc", "ggru", "tp", "dip", "dip_uni")


@functools.lru_cache(maxsize=None)
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


@functools.lru_cache(maxsize=None)
def _family(family):
    """(JAX cfg, JAX params as jnp, port cfg, port params on the CPU)."""
    if family.startswith("dip"):
        bi = family == "dip"
        jnet, params = jax_dip(60, 135, 8, seed=13, bidirectional=bi)
        jcfg = JPL.PoseNetConfig(net=jnet, rotsize=9)
        tcfg = TPL.PoseNetConfig(net=TN.DIPConfig(n_hidden=8,
                                                  bidirectional=bi),
                                 rotsize=9)
        return jcfg, to_jnp(params), tcfg, dip_params_from_jax(
            params, device="cpu")
    jcfg, tcfg, params = cascades(family)
    return jcfg, to_jnp(params), tcfg, cascade_params_from_jax(
        params, device="cpu")


def _port_export(family, window=W, streams=S):
    _, _, tcfg, tparams = _family(family)
    if family.startswith("dip"):
        return TX.export_streaming_dip(tparams, tcfg, ParametricModel(),
                                       window=window, streams=streams,
                                       stats=load_stats())
    return TX.export_streaming_cascade(tparams, tcfg, ParametricModel(),
                                       window=window, streams=streams,
                                       stats=load_stats(), normalize=True)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """family -> the directory of the port's CPU artifact (S, W), made once
    per module."""
    made = {}

    def get(family):
        if family not in made:
            d = str(tmp_path_factory.mktemp("port") / family)
            TX.save_exported(d, *_port_export(family))
            made[family] = d
        return made[family]
    return get


def _jax_session(family, tmp_path):
    jcfg, jparams, _, _ = _family(family)
    if family.startswith("dip"):
        exp = JX.export_streaming_dip(jparams, jcfg, jax_model(), window=W,
                                      streams=S, stats=load_stats())
    else:
        exp = JX.export_streaming_cascade(jparams, jcfg, jax_model(),
                                          window=W, streams=S,
                                          stats=load_stats(), normalize=True)
    d = str(tmp_path / "jax")
    JX.save_exported(d, *exp)
    return JX.ArtifactSession(JX.load_exported(d))


def _live_session(family):
    _, _, tcfg, tparams = _family(family)
    kw = dict(window=W, stats=load_stats(), streams=S, device="cpu")
    if family.startswith("dip"):
        return TS.DipStreamingSession(tparams, tcfg, ParametricModel(), **kw)
    return TS.StreamingCascade(tparams, tcfg, ParametricModel(),
                               normalize=True, **kw)


def _drive(sess, seed, reset=True):
    """Four windows, slot 1 idle on the second, slot 0 reset after it (when
    ``reset``): [(active rows' poses, state leaves)] per window."""
    rng = np.random.default_rng(seed)
    trace = []
    for w in range(4):
        ori = rng.normal(size=(S, W, 54)).astype(np.float32)
        acc = rng.normal(size=(S, W, 18)).astype(np.float32)
        active = np.array([1.0, 0.0], np.float32) if w == 1 else None
        pose = np.asarray(sess.step(ori, acc, active=active))
        rows = np.ones(S, bool) if active is None else active > 0
        trace.append((pose[rows], state_leaves(sess._states)))
        if w == 1 and reset:
            sess.reset(stream=0)
    return trace


def _assert_close(got, want, tol):
    for w, ((pose, states), (rpose, rstates)) in enumerate(zip(got, want)):
        assert pose.shape == rpose.shape
        np.testing.assert_allclose(pose, rpose, atol=tol,
                                   err_msg=f"window {w} pose")
        assert len(states) == len(rstates) > 0
        for a, b in zip(states, rstates):
            np.testing.assert_allclose(a, b, atol=tol,
                                       err_msg=f"window {w} state")


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_port_artifact_matches_jax_artifact(family, artifacts,
                                                  tmp_path):
    """The port's CPU artifact against the JAX package's xla artifact. The
    JAX artifact's ``reset(stream=i)`` zeroes axis 1 of every state leaf,
    a hidden unit of the unidirectional DIP net's [S, H] states, so that
    net is compared without the reset (the reset is held against the live
    session below and in
    ``test_torch_port_artifact_reset_uses_the_manifest_slot_axis``)."""
    reset = family != "dip_uni"
    sess = TX.ArtifactSession(TX.load_exported(artifacts(family),
                                               device="cpu"))
    got = _drive(sess, 5, reset)
    _assert_close(got, _drive(_jax_session(family, tmp_path), 5, reset),
                  JAX_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_port_artifact_matches_live_session(family, artifacts):
    sess = TX.ArtifactSession(TX.load_exported(artifacts(family),
                                               device="cpu"))
    assert sess.device == torch.device("cpu")
    assert (sess.streams, sess.window) == (S, W)
    _assert_close(_drive(sess, 6), _drive(_live_session(family), 6),
                  LIVE_TOL)
    assert sess.flush() == [None] * S
    sess.reset()
    for t in state_leaves(sess._states):
        assert not t.any()


def test_torch_port_artifact_manifest(artifacts):
    from a3gc_tpu_torch.ops._build import library_digest
    d = artifacts("a3gc")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    jcfg, jparams, _, _ = _family("a3gc")
    _, _, jman = JX.export_streaming_cascade(
        jparams, jcfg, jax_model(), window=W, streams=S,
        stats=load_stats(), normalize=True)
    # the JAX manifest's keys, torch's version in place of JAX's
    assert set(jman) - {"jax_version"} <= set(man)
    for k in ("family", "window", "streams", "rotsize", "normalized",
              "inputs", "outputs"):
        assert man[k] == jman[k], k
    assert man["format"] == "torch.export" and man["device"] == "cpu"
    assert man["torch_version"] == torch.__version__
    assert man["kernel_digests"] == {k: library_digest(k)
                                     for k in ("gcn_lstm", "ggru", "lstm")}
    assert sorted(os.listdir(d)) == ["manifest.json", "step.pt2"]
    # per stage (h, c) [2, S, 15, H], slot axis 1
    assert man["states"] == [[{"shape": [2, S, 15, 8], "slot_axis": 1}] * 2
                             ] * 3


def test_torch_port_artifact_reset_uses_the_manifest_slot_axis(artifacts,
                                                               tmp_path):
    """The unidirectional DIP net's states are [S, H]: the port zeroes slot
    i (axis 0, from the manifest); the JAX artifact zeroes axis 1 of every
    leaf, hidden unit i of every slot (a fault of the reference, kept
    there)."""
    sess = TX.ArtifactSession(TX.load_exported(artifacts("dip_uni"),
                                               device="cpu"))
    ref = _jax_session("dip_uni", tmp_path)
    rng = np.random.default_rng(7)
    ori = rng.normal(size=(S, W, 54)).astype(np.float32)
    acc = rng.normal(size=(S, W, 18)).astype(np.float32)
    sess.step(ori, acc)
    ref.step(ori, acc)
    before = state_leaves(sess._states)
    sess.reset(stream=1)
    ref.reset(stream=1)
    for a, b, r in zip(state_leaves(sess._states), before,
                       state_leaves(ref._states)):
        assert a.shape == (S, 8)
        assert not a[1].any()
        np.testing.assert_array_equal(a[0], b[0])
        assert not r[:, 1].any() and r[1].any()     # the reference's axis


def _bundle_script():
    idle = np.array([1.0, 0.0], np.float32)
    return ([("step", None), ("step", None), ("step", idle),
             ("step", None), ("reset", 1), ("step", None), ("step", None),
             ("flush", 0), ("step", None), ("step", None),
             ("flush", None)])


def _drive_buffered(sess, seed):
    rng = np.random.default_rng(seed)
    trace = []
    for kind, arg in _bundle_script():
        if kind == "reset":
            sess.reset(stream=arg)
            emitted, values = None, []
        elif kind == "flush":
            out = sess.flush(stream=arg)
            tails = out if isinstance(out, list) else [out]
            emitted = [t is not None for t in tails]
            values = [np.asarray(t) for t in tails if t is not None]
        else:
            ori = rng.normal(size=(S, W, 54)).astype(np.float32)
            acc = rng.normal(size=(S, W, 18)).astype(np.float32)
            pose, em = sess.step(ori, acc, active=arg)
            emitted = list(np.asarray(em, bool))
            values = [np.asarray(pose[i]) for i in range(S) if em[i]]
        trace.append((kind, emitted, values, state_leaves(sess._states)))
    return trace


def _assert_buffered_close(got, want, tol):
    n = 0
    for t, ((kind, em, vals, st), (_, rem, rvals, rst)) in enumerate(
            zip(got, want)):
        assert em == rem, f"tick {t} ({kind}) emitted"
        assert len(vals) == len(rvals)
        for a, b in zip(vals, rvals):
            np.testing.assert_allclose(a, b, atol=tol,
                                       err_msg=f"tick {t} ({kind})")
            n += 1
        for a, b in zip(st, rst):
            np.testing.assert_allclose(a, b, atol=tol,
                                       err_msg=f"tick {t} ({kind}) state")
    assert len(got) == len(want) and n > 0


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    geoms = TX.lookahead_geometries([S], W, 1, 1)
    assert geoms == [(S, W), (S, 2 * W), (S, 3 * W)]
    _, _, tcfg, tparams = _family("a3gc")
    d = str(tmp_path_factory.mktemp("bundle") / "a3gc")
    TX.export_bundle(d, tparams, tcfg, ParametricModel(), geoms,
                     stats=load_stats(), normalize=True)
    return d, geoms


def test_torch_port_lookahead_bundle_matches_jax_and_live(bundle, tmp_path):
    d, geoms = bundle
    b = TX.ExportedBundle(d, device="cpu")
    assert b.geometries == geoms
    sess = TX.ArtifactLookaheadSession(b, lookahead=1, history=1)
    got = _drive_buffered(sess, 8)
    jcfg, jparams, tcfg, tparams = _family("a3gc")
    JX.export_bundle(str(tmp_path / "jax"), jparams, jcfg, jax_model(),
                     geoms, stats=load_stats(), normalize=True)
    ref = JX.ArtifactLookaheadSession(JX.ExportedBundle(
        str(tmp_path / "jax")), lookahead=1, history=1)
    _assert_buffered_close(got, _drive_buffered(ref, 8), JAX_TOL)
    live = TS.StreamingCascade(tparams, tcfg, ParametricModel(), window=W,
                               stats=load_stats(), normalize=True,
                               streams=S, lookahead=1, history=1,
                               device="cpu")
    _assert_buffered_close(got, _drive_buffered(live, 8), LIVE_TOL)


def test_torch_port_bundle_refuses_a_missing_geometry(bundle):
    d, _ = bundle
    b = TX.ExportedBundle(d, device="cpu")
    with pytest.raises(KeyError, match=r"needs bundle geometries \[\(2, "
                       r"32\)\] — re-export with `cli export --streams 2 "
                       r"--window 8 --lookahead 1 --history 2`"):
        TX.ArtifactLookaheadSession(b, lookahead=1, history=2)
    with pytest.raises(KeyError, match="no geometry"):
        b.select(streams=3)
    with pytest.raises(ValueError, match="lookahead or history"):
        TX.ArtifactLookaheadSession(b, lookahead=0, history=0)
    assert TX.load_exported(d, window=2 * W, device="cpu").window == 2 * W


def test_torch_port_artifact_refuses_a_corrupted_file(artifacts, tmp_path):
    import shutil
    d = str(tmp_path / "copy")
    shutil.copytree(artifacts("ggru"), d)
    with open(os.path.join(d, "step.pt2"), "r+b") as f:
        f.seek(1000)
        byte = f.read(1)
        f.seek(1000)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="integrity check failed for "
                       "step.pt2"):
        TX.load_exported(d, device="cpu")


def test_torch_port_artifact_refuses_another_geometry(artifacts):
    with pytest.raises(KeyError, match=r"artifact has geometry "
                       r"\(streams=2, window=8\), not \(streams=1"):
        TX.load_exported(artifacts("tp"), streams=1, device="cpu")
    with pytest.raises(KeyError, match="re-export or use a bundle"):
        TX.load_exported(artifacts("tp"), window=4, device="cpu")


def test_torch_port_export_refuses_rotsize_3():
    _, _, tcfg, tparams = _family("a3gc")
    cfg3 = TPL.CascadeConfig(tcfg.stage1, tcfg.stage2,
                             TPL.PoseNetConfig(net=tcfg.stage3.net,
                                               rotsize=3))
    with pytest.raises(ValueError, match="rotsize-3"):
        TX.export_streaming_cascade(tparams, cfg3, ParametricModel(),
                                    window=W, streams=S)


def test_torch_port_dip_export_refuses_missing_stats():
    _, _, tcfg, tparams = _family("dip")
    with pytest.raises(ValueError, match="dip export needs normalization "
                       "stats"):
        TX.export_streaming_dip(tparams, tcfg, ParametricModel(), window=W,
                                streams=S)


def test_torch_port_artifact_refuses_a_fractional_active(artifacts):
    sess = TX.ArtifactSession(TX.load_exported(artifacts("a3gc"),
                                               device="cpu"))
    zeros = (np.zeros((S, W, 54), np.float32),
             np.zeros((S, W, 18), np.float32))
    with pytest.raises(ValueError, match="0 or 1 per slot"):
        sess.step(*zeros, active=np.array([1.0, 0.5], np.float32))
    with pytest.raises(ValueError, match=r"active must be \[2\]"):
        sess.step(*zeros, active=np.ones((S, W), np.float32))


def test_torch_port_load_exported_needs_cuda_unless_asked_for_cpu(
        artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TX.load_exported(artifacts("a3gc"))


def _graph_op_args(attention, S_=2, T=5, N=15, H=8, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g) * 0.3
    att = ((r(2, H, H), r(2, H, H), r(2, H, H), r(2, H), r(2, H), r(2, N))
           if attention else (None,) * 6)
    return (r(2, S_, T, N, 4 * H), r(2, H, 4 * H), r(2, 4, N, N),
            r(2, 4, H), *att, r(2, S_, N, H), r(2, S_, N, H),
            torch.tensor([T, 2], dtype=torch.int32))


@pytest.mark.parametrize("case", ["gcn_lstm", "gcn_lstm_aagc", "ggru",
                                  "lstm", "lstm_uni"])
def test_torch_port_ops_pass_opcheck(case):
    from a3gc_tpu_torch.ops import library as LIB
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(shape, generator=g) * 0.3
    nv = torch.tensor([5, 3], dtype=torch.int32)
    if case.startswith("gcn_lstm"):
        op, args = LIB.gcn_lstm_scan, _graph_op_args(case == "gcn_lstm")
    elif case == "ggru":
        op, args = LIB.ggru_scan, (r(2, 2, 5, 15, 24), r(2, 8, 8),
                                   r(2, 15, 15), r(2, 8, 24),
                                   r(2, 2, 15, 8), nv)
    else:
        D = 2 if case == "lstm" else 1
        op, args = LIB.lstm_scan, (r(D, 2, 5, 32), r(D, 8, 32),
                                   r(D, 2, 8), r(D, 2, 8), nv)
    torch.library.opcheck(op, args)
    assert op._qualname.startswith("a3gc_tpu_torch::")


def test_torch_port_wrappers_call_the_registered_ops():
    """``bi_*`` reach the ops on the CPU, and equal their plain versions."""
    from a3gc_tpu_torch.ops import gcn_lstm as G
    from a3gc_tpu_torch.ops import library as LIB
    from a3gc_tpu_torch.models import cells as C
    from a3gc_tpu_torch.models import layers as L
    from a3gc_tpu_torch.data import load_adjacency_template
    gen = torch.Generator().manual_seed(3)
    nira = load_adjacency_template()
    p = L.stack_directions(*(C.init_gcn_lstm_cell(gen, 8, 8, nira,
                                                  attention=True)
                             for _ in range(2)))
    x = torch.randn(2, 5, 15, 8, generator=gen)
    st = (torch.randn(2, 2, 15, 8, generator=gen),) * 2
    calls = []
    real = LIB.gcn_lstm_scan

    def counting(*a):
        calls.append(len(a))
        return real(*a)
    LIB.gcn_lstm_scan = counting
    try:
        y, (h, c) = G.bi_gcn_lstm(p, x, st, [5, 2])
    finally:
        LIB.gcn_lstm_scan = real
    assert calls == [14]            # the 13 arrays and the tf32 flag
    ry, (rh, rc) = G.bi_gcn_lstm_reference(p, x, st, [5, 2])
    torch.testing.assert_close(y, ry, rtol=0, atol=0)
    torch.testing.assert_close(h, rh, rtol=0, atol=0)


_CHILD = r"""
import json, sys
import numpy as np
from a3gc_tpu_torch.export import ArtifactSession, load_exported
sess = ArtifactSession(load_exported(sys.argv[1], device="cpu"))
data = np.load(sys.argv[2])
out = np.stack([sess.step(o, a) for o, a in zip(data["ori"], data["acc"])])
np.save(sys.argv[3], out)
print(json.dumps({"banned": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "jaxlib",
                                                          "flax",
                                                          "a3gc_tpu"))}))
"""


def test_torch_port_artifact_loads_in_a_fresh_process(artifacts, tmp_path):
    """A process given only the artifact directory (no checkpoint, stats or
    SMPL file, no model code of its own) loads and steps it, imports
    neither jax nor a3gc_tpu, and emits the in-process session's poses."""
    rng = np.random.default_rng(9)
    ori = rng.normal(size=(3, S, W, 54)).astype(np.float32)
    acc = rng.normal(size=(3, S, W, 18)).astype(np.float32)
    np.savez(tmp_path / "in.npz", ori=ori, acc=acc)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, artifacts("a3gc"),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"banned": []}
    sess = TX.ArtifactSession(TX.load_exported(artifacts("a3gc"),
                                               device="cpu"))
    want = np.stack([sess.step(o, a) for o, a in zip(ori, acc)])
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


def test_torch_port_kernel_build_dir_is_settable(monkeypatch, tmp_path):
    """Kernels build into ``build/kernels`` of the checkout unless
    ``$A3GC_TORCH_BUILD_DIR`` names another directory (an installed
    package)."""
    from a3gc_tpu_torch.ops import _build as B
    monkeypatch.delenv(B.BUILD_DIR_ENV, raising=False)
    assert B.build_dir() == os.path.join(REPO, "build", "kernels")
    monkeypatch.setenv(B.BUILD_DIR_ENV, str(tmp_path / "k"))
    assert B.build_dir() == str(tmp_path / "k")
