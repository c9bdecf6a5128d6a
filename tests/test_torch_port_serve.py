"""The port's HTTP serving stack on the CPU (a3gc_tpu_torch.serve and
.client, ``device="cpu"``): concurrent clients through one multi-stream
session equal independent single-slot sessions however requests coalesce;
the protocol's guards (seq at-most-once, acquire/release tokens, recycling
gates, flush vs in-flight step); snapshot/restore on every state structure;
and the wire held against the JAX package both ways — its unchanged
PoseClient drives the port's server, the port's PoseClient drives its
PoseServer — at 1e-4 on poses after three stages and IK (fp32 on both
sides). Within the port the served poses equal a direct session's at 1e-6.

Every wait is bounded: short ``max_wait_ms``, socket timeouts, and
``retry_s`` of a few seconds."""

import contextlib
import http.client
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from a3gc_tpu_torch.client import PoseClient, ServerError
from a3gc_tpu_torch.data import load_adjacency_template, load_stats
from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                           StreamingCascade)
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import (CascadeConfig, PoseNetConfig,
                                            init_pose_net)
from a3gc_tpu_torch.serve import (PoseServer, session_restore,
                                  session_snapshot)
from a3gc_tpu_torch.smpl import ParametricModel

# tiny tensors: intra-op threads would only contend with the other test
# workers' (and the server's handler threads)
torch.set_num_threads(1)

SAME = 1e-6          # the port against itself: same kernels, other batching
POSE_TOL = 1e-4      # the port against the JAX package, poses after IK
MODEL = ParametricModel()
GRAPH_DIMS = ((12, 3, 3), (15, 3, 3), (15, 9, 9))
TP_DIMS = ((72, 15, 3), (87, 69, 3), (141, 135, 9))


def _cascade(kind="a3gc", seed=0):
    if kind == "tp":
        cfg = CascadeConfig(*(PoseNetConfig(net=N.DIPConfig(
            n_input=ni, n_output=no, n_hidden=8), rotsize=rot)
            for ni, no, rot in TP_DIMS))
    else:
        cfg = CascadeConfig(*(PoseNetConfig(net=N.GraphNetConfig(
            cell=kind, units_in=ui, units_out=uo, units_hidden=8),
            rotsize=rot) for ui, uo, rot in GRAPH_DIMS))
    nira = load_adjacency_template()
    params3 = tuple(init_pose_net(torch.Generator().manual_seed(seed + i), c,
                                  nira) for i, c in enumerate(cfg.stages))
    return cfg, params3


def _dip(seed=7):
    cfg = PoseNetConfig(net=N.DIPConfig(n_hidden=8), rotsize=9)
    return cfg, init_pose_net(torch.Generator().manual_seed(seed), cfg)


@pytest.fixture(scope="module")
def setup():
    return _cascade()


def _windows(n, W, seed=0):
    rng = np.random.default_rng(seed)
    ori = rng.normal(size=(n, W, 54)).astype(np.float32)
    acc = rng.normal(scale=0.5, size=(n, W, 18)).astype(np.float32)
    return list(zip(ori, acc))


@contextlib.contextmanager
def serving(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield srv
    finally:
        srv.shutdown()


def _server(setup, **kw):
    cfg, params3 = setup
    kw.setdefault("max_wait_ms", 2.0)
    return serving(PoseServer(params3, cfg, MODEL, port=0, device="cpu",
                              **kw))


def _session(setup, **kw):
    cfg, params3 = setup
    return StreamingCascade(params3, cfg, MODEL, device="cpu", **kw)


def _client(srv, **kw):
    kw.setdefault("timeout", 30.0)
    kw.setdefault("retry_s", 5.0)
    kw.setdefault("retry_interval", 0.05)
    return PoseClient(*srv.address, **kw)


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _step_body(slot, ori, acc, seq=None):
    body = {"slot": slot, "ori": ori.tolist(), "acc": acc.tolist()}
    if seq is not None:
        body["seq"] = seq
    return body


# -- clients against sessions -------------------------------------------------

def _sessions(kind):
    """``build(S, W, K, P)``: a session of S slots of this family, every
    call over the same seeded weights."""
    if kind == "dip":
        cfg, params = _dip()

        def build(S, W, K=0, P=0):
            return DipStreamingSession(params, cfg, MODEL, window=W,
                                       stats=load_stats(), streams=S,
                                       lookahead=K, history=P, device="cpu")
    else:
        cfg, params3 = _cascade(kind)

        def build(S, W, K=0, P=0):
            return StreamingCascade(params3, cfg, MODEL, window=W,
                                    stats=load_stats(), normalize=True,
                                    streams=S, lookahead=K, history=P,
                                    device="cpu")
    return build


@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp", "dip"])
def test_torch_port_serve_concurrent_clients_match_single_sessions(kind):
    build = _sessions(kind)
    W, n_clients, n_windows = 6, 3, 3
    srv = PoseServer(None, None, None, port=0, max_wait_ms=20.0,
                     session=build(4, W))
    with serving(srv):
        feeds = [_windows(n_windows, W, seed=10 + ci)
                 for ci in range(n_clients)]

        def client(ci):
            with _client(srv, binary=ci % 2 == 0) as c:
                return np.concatenate([c.step(o, a) for o, a in feeds[ci]])

        with ThreadPoolExecutor(n_clients) as ex:
            served = list(ex.map(client, range(n_clients)))
        for ci in range(n_clients):
            ref = build(1, W)
            want = np.concatenate([ref.step(o, a) for o, a in feeds[ci]])
            np.testing.assert_allclose(served[ci], want, atol=SAME,
                                       err_msg=f"client {ci}")
        stats = _client(srv).stats()
        assert stats["errors"] == 0 and stats["requests"] == 9
        assert stats["active_sessions"] == 0


@pytest.mark.parametrize("kind,K,P", [("a3gc", 1, 0), ("a3gc", 0, 1),
                                      ("a3gc", 2, 1), ("ggru", 1, 1),
                                      ("dip", 1, 1), ("dip", 1, 0)])
def test_torch_port_serve_buffered_matches_session(kind, K, P):
    """lookahead: the first K steps answer 202, later ones the lagged
    emission; history alone: no warm-up; flush drains K windows (0 frames
    with history alone) and the slot keeps serving in sync."""
    build = _sessions(kind)
    W, n_windows = 6, K + P + 3
    srv = PoseServer(None, None, None, port=0, max_wait_ms=2.0,
                     session=build(2, W, K, P), lookahead=K, history=P)
    with serving(srv):
        ref = build(1, W, K, P)
        wins = _windows(n_windows + 1, W, seed=20)
        with _client(srv) as c, _client(srv, binary=False) as other:
            for w, (ori, acc) in enumerate(wins[:-1]):
                got, want = c.step(ori, acc), ref.step(ori, acc)
                assert (got is None) == (want is None) == (w < K)
                if want is not None:
                    np.testing.assert_allclose(got, want, atol=SAME,
                                               err_msg=f"window {w}")
                if w == 0:       # a second slot warming in its own group
                    assert (other.step(ori, acc) is None) == (K > 0)
            tail, want_tail = c.flush(), ref.flush()
            if K == 0:
                assert tail is None and want_tail is None
            else:
                assert tail.shape == (K * W, 24, 3, 3)
                np.testing.assert_allclose(tail, want_tail, atol=SAME)
            assert c.flush() is None            # drained
            got, want = c.step(*wins[-1]), ref.step(*wins[-1])
            assert (got is None) == (want is None) == (K > 0)
            if want is not None:
                np.testing.assert_allclose(got, want, atol=SAME)
            st = c.stats()
            assert (st["lookahead"], st["history"]) == (K, P)
            assert st["errors"] == 0


def test_torch_port_serve_rejects_session_with_other_buffering(setup):
    with pytest.raises(ValueError, match="lookahead/history"):
        PoseServer(None, None, None, port=0,
                   session=_session(setup, window=4, lookahead=1),
                   lookahead=0)


def test_torch_port_serve_capacity_and_reset(setup):
    W = 4
    with _server(setup, window=W, streams=1) as srv:
        addr = srv.address
        st, s0 = _request(addr, "POST", "/v1/session")
        assert st == 200 and s0["window"] == W
        st, err = _request(addr, "POST", "/v1/session")
        assert st == 503 and "error" in err      # full
        (ori, acc), = _windows(1, W, seed=8)
        st, out1 = _request(addr, "POST", "/v1/step",
                            _step_body(s0["slot"], ori, acc))
        assert st == 200
        st, out2 = _request(addr, "POST", "/v1/step",
                            _step_body(s0["slot"], ori, acc))
        # carried state: the second window differs from the first
        assert np.abs(np.asarray(out1["pose"])
                      - np.asarray(out2["pose"])).max() > 1e-7
        st, _ = _request(addr, "DELETE", f"/v1/session/{s0['slot']}")
        assert st == 200
        st, s1 = _request(addr, "POST", "/v1/session")
        assert st == 200                          # slot recycled
        st, out3 = _request(addr, "POST", "/v1/step",
                            _step_body(s1["slot"], ori, acc))
        # reset on release: fresh state reproduces window 1
        np.testing.assert_allclose(np.asarray(out3["pose"]),
                                   np.asarray(out1["pose"]), atol=SAME)
        st, err = _request(addr, "POST", "/v1/step",
                           {"slot": s1["slot"], "ori": [[1.0]],
                            "acc": acc.tolist()})
        assert st == 400 and "error" in err       # shape validation
        st, err = _request(addr, "GET", "/v1/nothing")
        assert st == 404


@pytest.mark.parametrize("K,P", [(1, 0), (0, 1), (1, 1)])
def test_torch_port_serve_random_step_flush_release_interleavings(setup, K,
                                                                  P):
    """Threaded fuzz of the buffered batcher: clients randomly step / flush
    / release+reacquire their own slots. No response may hang, every 200
    step is a [W,24,3,3] pose and every flush 0 or K·W frames."""
    W = 4
    with _server(setup, window=W, streams=3, lookahead=K,
                 history=P) as srv:
        addr = srv.address

        def client(ci):
            rng = np.random.default_rng(ci)
            (ori, acc), = _windows(1, W, seed=ci)
            st, sess = _request(addr, "POST", "/v1/session")
            assert st == 200, sess
            slot = sess["slot"]
            ok = 0
            for _ in range(12):
                op = rng.choice(["step", "step", "step", "flush", "cycle"])
                if op == "step":
                    st, out = _request(addr, "POST", "/v1/step",
                                       _step_body(slot, ori, acc))
                    assert st in (200, 202), (st, out)
                    if st == 200:
                        pose = np.asarray(out["pose"], np.float32)
                        assert pose.shape == (W, 24, 3, 3), pose.shape
                        assert np.isfinite(pose).all()
                elif op == "flush":
                    st, out = _request(addr, "POST", "/v1/flush",
                                       {"slot": slot})
                    assert st == 200, (st, out)
                    assert out["frames"] in (0, K * W), out["frames"]
                    if out["frames"]:
                        assert np.asarray(out["pose"]).shape == (
                            K * W, 24, 3, 3)
                else:   # release + reacquire (slot may change)
                    st, _ = _request(addr, "DELETE", f"/v1/session/{slot}")
                    assert st == 200
                    st, sess = _request(addr, "POST", "/v1/session")
                    assert st == 200, sess
                    slot = sess["slot"]
                ok += 1
            _request(addr, "DELETE", f"/v1/session/{slot}")
            return ok

        with ThreadPoolExecutor(3) as ex:
            results = [f.result(120) for f in
                       [ex.submit(client, i) for i in range(3)]]
        assert results == [12, 12, 12]
        st, stats = _request(addr, "GET", "/v1/stats")
        assert st == 200 and stats["errors"] == 0


# -- the wire -----------------------------------------------------------------

def _binary(addr, path, payload):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("POST", path, body=payload,
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    out = resp.status, dict(resp.getheaders()), resp.read()
    conn.close()
    return out


def test_torch_port_serve_binary_step_matches_json(setup):
    W = 5
    with _server(setup, window=W, streams=2) as srv:
        addr = srv.address
        (ori, acc), = _windows(1, W, seed=23)
        _, s0 = _request(addr, "POST", "/v1/session")
        _, s1 = _request(addr, "POST", "/v1/session")
        st, out_j = _request(addr, "POST", "/v1/step",
                             _step_body(s0["slot"], ori, acc))
        assert st == 200
        # the same input on a fresh second slot → the same pose
        body = (np.asarray([s1["slot"]], "<u4").tobytes()
                + ori.astype("<f4").tobytes() + acc.astype("<f4").tobytes())
        st, _, raw = _binary(addr, "/v1/step", body)
        assert st == 200
        pose_b = np.frombuffer(raw, "<f4").reshape(W, 24, 3, 3)
        np.testing.assert_allclose(
            pose_b, np.asarray(out_j["pose"], np.float32), atol=SAME)
        assert _binary(addr, "/v1/step", b"\x00\x01")[0] == 400
        # binary flush on a plain server: 0 frames; a bad body: 400
        st, headers, raw = _binary(addr, "/v1/flush",
                                   np.asarray([s1["slot"]], "<u4").tobytes())
        assert st == 200 and headers["X-Frames"] == "0" and raw == b""
        assert _binary(addr, "/v1/flush", b"\x00")[0] == 400
        st, out = _request(addr, "POST", "/v1/flush", {"slot": 999})
        assert st == 400 and "error" in out


@pytest.mark.parametrize("binary", [True, False])
def test_torch_port_serve_retried_seq_returns_cache_without_restep(setup,
                                                                   binary):
    W = 5
    with _server(setup, window=W, streams=2) as srv:
        addr = srv.address
        wins = _windows(2, W, seed=40)
        _, info = _request(addr, "POST", "/v1/session")
        slot = info["slot"]

        def step(seq, ori, acc):
            if binary:
                st, _, raw = _binary(addr, "/v1/step", (
                    np.asarray([slot, seq], "<u4").tobytes()
                    + ori.astype("<f4").tobytes()
                    + acc.astype("<f4").tobytes()))
                assert st == 200
                return np.frombuffer(raw, "<f4").reshape(W, 24, 3, 3)
            st, out = _request(addr, "POST", "/v1/step",
                               _step_body(slot, ori, acc, seq))
            assert st == 200, out
            return np.asarray(out["pose"], np.float32)

        out0 = step(0, *wins[0])
        # a retry of the SAME seq (garbage payload: it must not be applied)
        retry = step(0, np.zeros((W, 54), np.float32),
                     np.zeros((W, 18), np.float32))
        np.testing.assert_array_equal(retry, out0)
        out1 = step(1, *wins[1])
        ref = _session(setup, window=W)
        np.testing.assert_allclose(out0, ref.step(*wins[0]), atol=SAME)
        np.testing.assert_allclose(out1, ref.step(*wins[1]), atol=SAME)
        st, out = _request(addr, "POST", "/v1/step",
                           _step_body(slot, *wins[0], seq=0))
        assert st == 400 and "stale seq" in out["error"]
        # release clears the seq cache: a new tenant reuses seq 0
        _request(addr, "DELETE", f"/v1/session/{slot}")
        _, info2 = _request(addr, "POST", "/v1/session")
        slot = info2["slot"]
        fresh = step(0, *wins[1])
        np.testing.assert_allclose(
            fresh, _session(setup, window=W).step(*wins[1]), atol=SAME)


class _SlowSess:
    """The session with a gate in front of ``step``."""

    def __init__(self, sess):
        self._sess = sess
        self.gate, self.entered = threading.Event(), threading.Event()

    def __getattr__(self, name):            # reset / flush / params3
        return getattr(self._sess, name)

    def step(self, *a, **k):
        self.entered.set()
        assert self.gate.wait(30)
        return self._sess.step(*a, **k)


def test_torch_port_serve_duplicate_of_in_flight_seq_applies_once(setup):
    W = 5
    with _server(setup, window=W, streams=2) as srv:
        addr = srv.address
        wins = _windows(2, W, seed=50)
        _, info = _request(addr, "POST", "/v1/session")
        slot = info["slot"]
        sess = srv.batcher.sess
        slow = srv.batcher.sess = _SlowSess(sess)
        try:
            payload = _step_body(slot, *wins[0], seq=0)
            with ThreadPoolExecutor(2) as ex:
                f1 = ex.submit(_request, addr, "POST", "/v1/step", payload)
                assert slow.entered.wait(30)  # the original is in the tick
                f2 = ex.submit(_request, addr, "POST", "/v1/step", payload)
                time.sleep(0.3)               # the duplicate reaches step()
                slow.gate.set()
                st1, out1 = f1.result(60)
                st2, out2 = f2.result(60)
        finally:
            srv.batcher.sess = sess
        assert st1 == 200 and st2 == 200
        np.testing.assert_array_equal(np.asarray(out1["pose"]),
                                      np.asarray(out2["pose"]))
        st, out3 = _request(addr, "POST", "/v1/step",
                            _step_body(slot, *wins[1], seq=1))
        assert st == 200
        ref = _session(setup, window=W)
        ref.step(*wins[0])
        np.testing.assert_allclose(np.asarray(out3["pose"], np.float32),
                                   ref.step(*wins[1]), atol=SAME)


def test_torch_port_serve_flush_rejected_while_step_in_tick(setup):
    W = 5
    with _server(setup, window=W, streams=1, lookahead=1) as srv:
        addr = srv.address
        (ori, acc), = _windows(1, W, seed=60)
        _, info = _request(addr, "POST", "/v1/session")
        slot = info["slot"]
        sess = srv.batcher.sess
        slow = srv.batcher.sess = _SlowSess(sess)
        try:
            with ThreadPoolExecutor(1) as ex:
                f1 = ex.submit(_request, addr, "POST", "/v1/step",
                               _step_body(slot, ori, acc, seq=0))
                assert slow.entered.wait(30)
                st, out = _request(addr, "POST", "/v1/flush", {"slot": slot})
                assert st == 400 and "in flight" in out["error"]
                slow.gate.set()
                assert f1.result(60)[0] == 202   # lookahead warm-up
        finally:
            srv.batcher.sess = sess
        st, out = _request(addr, "POST", "/v1/flush", {"slot": slot})
        assert st == 200 and out["frames"] == W


def test_torch_port_serve_failed_device_step_answers_500_and_recovers(setup):
    """The dispatcher catches a failed step, answers 500, counts it, leaves
    the buffered session as it was, and serves the retry."""
    W = 4
    with _server(setup, window=W, streams=1, history=1) as srv:
        sess = srv.batcher.sess
        ref = _session(setup, window=W, history=1)
        wins = _windows(2, W, seed=61)
        real = sess._step_fn
        with _client(srv) as c:
            np.testing.assert_allclose(c.step(*wins[0]), ref.step(*wins[0]),
                                       atol=SAME)
            sess._step_fn = lambda *a: (_ for _ in ()).throw(
                RuntimeError("kernel launch failed"))
            with pytest.raises(ServerError, match="device step failed"):
                c.step(*wins[1])
            sess._step_fn = real
            assert c.stats()["errors"] == 1
            np.testing.assert_allclose(c.step(*wins[1]), ref.step(*wins[1]),
                                       atol=SAME)


def test_torch_port_serve_invalid_slots_rejected_server_survives(setup):
    W = 4
    with _server(setup, window=W, streams=2) as srv:
        addr = srv.address
        (ori, acc), = _windows(1, W)
        for bad in (0, 999, -2):
            st, err = _request(addr, "POST", "/v1/step",
                               _step_body(bad, ori, acc))
            assert st == 400 and "error" in err, (bad, st, err)
        for bad in (1, 999, -2):
            st, err = _request(addr, "DELETE", f"/v1/session/{bad}")
            assert st in (400, 404), (bad, st)
        assert _request(addr, "DELETE", "/v1/session/x")[0] == 400
        st, s0 = _request(addr, "POST", "/v1/session")
        assert st == 200
        st, out = _request(addr, "POST", "/v1/step",
                           _step_body(s0["slot"], ori, acc))
        assert st == 200 and np.isfinite(np.asarray(out["pose"])).all()
        assert _request(addr, "DELETE",
                        f"/v1/session/{s0['slot']}")[0] == 200


# -- acquire / release tokens -------------------------------------------------

def test_torch_port_serve_failed_acquire_response_returns_slot(setup):
    with _server(setup, window=4, streams=2) as srv:
        handler_cls = srv.httpd.RequestHandlerClass

        class _FailingWfile(io.RawIOBase):
            def writable(self):
                return True

            def write(self, b):
                raise BrokenPipeError(32, "client gone")

            def flush(self):
                pass

        class _FakeSock:
            def __init__(self, raw):
                self._raw = raw

            def makefile(self, mode, *a, **k):
                return (io.BytesIO(self._raw) if "r" in mode
                        else _FailingWfile())

            def sendall(self, b):
                raise BrokenPipeError(32, "client gone")

            def close(self):
                pass

            def shutdown(self, how):
                pass

            def setsockopt(self, *a):
                pass

        free_before = set(srv.batcher.free)
        req = b"POST /v1/session HTTP/1.1\r\nHost: t\r\n\r\n"
        try:
            handler_cls(_FakeSock(req), ("127.0.0.1", 1), srv.httpd)
        except OSError:
            pass            # the broken pipe propagating out of the handler
        assert set(srv.batcher.free) == free_before


def test_torch_port_serve_token_retry_returns_same_slot(setup):
    with _server(setup, window=4, streams=2) as srv:
        addr = srv.address
        st, a = _request(addr, "POST", "/v1/session", {"token": "t-1"})
        assert st == 200
        st, b = _request(addr, "POST", "/v1/session", {"token": "t-1"})
        assert st == 200 and b["slot"] == a["slot"]
        assert _request(addr, "GET", "/v1/stats")[1]["active_sessions"] == 1
        st, c = _request(addr, "POST", "/v1/session", {"token": "t-2"})
        assert st == 200 and c["slot"] != a["slot"]
        _request(addr, "DELETE", f"/v1/session/{a['slot']}")
        st, d = _request(addr, "POST", "/v1/session", {"token": "t-1"})
        assert st == 200
        assert _request(addr, "GET", "/v1/stats")[1]["active_sessions"] == 2
        assert _request(addr, "POST", "/v1/session", {"token": 7})[0] == 400


@pytest.mark.parametrize("case", ["delivered_elsewhere", "all_failed",
                                  "restored"])
def test_torch_port_serve_acquire_delivery_races(setup, case):
    """acquire_outcome: a failed response write un-acquires the slot only
    when no concurrent handler for the same token delivered it; tokens
    restored across a recycle count as delivered."""
    with _server(setup, window=4, streams=2) as srv:
        b = srv.batcher
        s1 = b.acquire(token="T")
        if case == "delivered_elsewhere":
            s2 = b.acquire(token="T")
            assert s1 == s2 and s1 is not None
            b.acquire_outcome("T", s2, delivered=True)
            b.acquire_outcome("T", s1, delivered=False)
            assert s1 not in b.free and b.acquire_tokens.get("T") == s1
            s3 = b.acquire(token="T")
            assert s3 == s1
            b.acquire_outcome("T", s3, delivered=False)
            assert s1 not in b.free
        elif case == "all_failed":
            s2 = b.acquire(token="T")
            b.acquire_outcome("T", s1, delivered=False)
            assert s1 not in b.free      # a sibling is still in flight
            b.acquire_outcome("T", s2, delivered=False)
            assert s1 in b.free and "T" not in b.acquire_tokens
            s3 = b.acquire()
            b.acquire_outcome(None, s3, delivered=False)
            assert s3 in b.free
        else:
            b.acquire_outcome("T", s1, delivered=True)
            b.acquire_inflight.clear()
            b.acquire_delivered.clear()
            b.acquire_delivered.update({"T": s1})
            s2 = b.acquire(token="T")
            assert s2 == s1
            b.acquire_outcome("T", s2, delivered=False)
            assert s1 not in b.free


def test_torch_port_serve_stale_delete_cannot_release_next_tenant(setup):
    W = 4
    with _server(setup, window=W, streams=1) as srv:
        addr = srv.address
        st, a = _request(addr, "POST", "/v1/session", {"token": "t-A"})
        assert st == 200
        assert _request(addr, "DELETE", f"/v1/session/{a['slot']}",
                        {"token": "t-A"})[0] == 200
        st, c = _request(addr, "POST", "/v1/session", {"token": "t-B"})
        assert st == 200 and c["slot"] == a["slot"]
        # A's auto-retried DELETE arrives late: 404, the tenant unharmed
        assert _request(addr, "DELETE", f"/v1/session/{a['slot']}",
                        {"token": "t-A"})[0] == 404
        assert _request(addr, "GET", "/v1/stats")[1]["active_sessions"] == 1
        (ori, acc), = _windows(1, W, seed=62)
        assert _request(addr, "POST", "/v1/step",
                        _step_body(c["slot"], ori, acc, 0))[0] == 200
        assert _request(addr, "DELETE",
                        f"/v1/session/{c['slot']}")[0] == 200


# -- stats, reload, recycling -------------------------------------------------

def test_torch_port_serve_stats_and_hot_reload(setup):
    cfg, params3 = setup
    _, params3_b = _cascade(seed=100)
    W = 4
    with _server(setup, window=W, streams=2,
                 reload_fn=lambda: params3_b) as srv:
        (ori, acc), = _windows(1, W, seed=11)
        with _client(srv) as c:
            out_a = c.step(ori, acc)
            stats = c.stats()
            assert stats["ticks"] >= 1 and stats["requests"] >= 1
            assert stats["active_sessions"] == 1 and stats["errors"] == 0
            assert stats["tick_ms_mean"] > 0 and stats["tick_ms_p99"] > 0
            assert stats["mean_coalesced"] == 1.0
            assert (stats["streams"], stats["window"]) == (2, W)
            assert c.reload() == {"reloaded": True}
            out_b = c.step(ori, acc)
        ref_a = _session(setup, window=W)
        ref_b = StreamingCascade(params3_b, cfg, MODEL, window=W,
                                 device="cpu")
        np.testing.assert_allclose(out_a, ref_a.step(ori, acc), atol=SAME)
        # window 2: params B from the state params A left
        ref_b._states = ref_a._states
        np.testing.assert_allclose(out_b, ref_b.step(ori, acc), atol=SAME)


def test_torch_port_serve_reload_without_source_is_501(setup):
    with _server(setup, window=4, streams=1) as srv:
        st, out = _request(srv.address, "POST", "/v1/reload")
        assert st == 501 and "reload source" in out["error"]
        with pytest.raises(ServerError) as ei:
            _client(srv).reload()
        assert ei.value.status == 501


def test_torch_port_serve_reload_under_concurrent_load(setup):
    cfg, params3 = setup
    _, params3_b = _cascade(seed=50)
    W = 4
    flip = {"v": 0}

    def reload_fn():
        flip["v"] ^= 1
        return params3_b if flip["v"] else params3

    with _server(setup, window=W, streams=3, reload_fn=reload_fn) as srv:
        addr = srv.address
        (ori, acc), = _windows(1, W, seed=12)

        def client(_):
            with _client(srv) as c:
                for _ in range(6):
                    pose = c.step(ori, acc)
                    assert pose.shape == (W, 24, 3, 3)
                    assert np.isfinite(pose).all()
            return 6

        def reloader():
            for _ in range(8):
                st, r = _request(addr, "POST", "/v1/reload")
                assert st == 200 and r["reloaded"], r
            return True

        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(client, i) for i in range(3)]
            futs.append(ex.submit(reloader))
            assert [f.result(120) for f in futs] == [6, 6, 6, True]
        stats = _request(addr, "GET", "/v1/stats")[1]
        assert stats["errors"] == 0 and stats["requests"] == 18


def test_torch_port_serve_quiesce_rejects_new_work(setup):
    W = 6
    with _server(setup, window=W, streams=2) as srv:
        addr = srv.address
        _, info = _request(addr, "POST", "/v1/session")
        slot = info["slot"]
        assert srv.batcher.quiesce() == [slot]
        assert srv.batcher.acquire() is None
        with pytest.raises(RuntimeError, match="recycling"):
            srv.batcher.step(slot, np.zeros((W, 54), np.float32),
                             np.zeros((W, 18), np.float32))
        # an in-process (non-CLI) server has no argv to re-exec
        st, out = _request(addr, "POST", "/v1/recycle")
        assert st == 501 and "CLI-launched" in out["error"]


def test_torch_port_serve_release_and_reload_rejected_while_recycling(setup):
    _, params3 = setup
    with _server(setup, window=4, streams=1) as srv:
        b = srv.batcher
        slot = b.acquire()
        assert slot is not None
        with b.lock:
            b.recycling = True
        with pytest.raises(RuntimeError, match="recycling"):
            b.release(slot)
        with pytest.raises(RuntimeError, match="recycling"):
            b.swap_params(params3)
        assert b.acquire() is None
        srv._recycling = True
        assert _request(srv.address, "GET", "/v1/stats")[0] == 500
        srv._recycling = False
        with b.lock:
            b.recycling = False
        assert b.release(slot) is True


@pytest.mark.parametrize("kind", ["a3gc", "ggru", "tp", "dip"])
def test_torch_port_serve_snapshot_restore_roundtrip(kind):
    """snapshot → pickle → fresh session → restore == uninterrupted, with
    the buffered (K, P) window deques mid-stream, on every state
    structure."""
    import pickle

    build = _sessions(kind)
    W, K, P, S = 6, 1, 1, 2
    rng = np.random.default_rng(21)
    wins = [(rng.normal(size=(S, W, 54)).astype(np.float32),
             rng.normal(size=(S, W, 18)).astype(np.float32))
            for _ in range(5)]
    cont, first = build(S, W, K, P), build(S, W, K, P)
    for i in range(3):      # at capacity, buffers full
        cont.step(*wins[i])
        first.step(*wins[i])
    snap = pickle.loads(pickle.dumps(session_snapshot(first)))

    def leaves(tree):
        return ([a for t in tree for a in leaves(t)]
                if isinstance(tree, (tuple, list)) else [tree])

    assert all(isinstance(a, np.ndarray) for a in leaves(snap["states"]))
    second = build(S, W, K, P)
    session_restore(second, snap)
    assert all(isinstance(t, torch.Tensor) and t.device == second.device
               for t in leaves(second._states))
    for i in (3, 4):
        want, got = cont.step(*wins[i]), second.step(*wins[i])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=SAME)
    for a, b in zip(second.flush(), cont.flush()):
        np.testing.assert_allclose(a, b, atol=SAME)


# -- the client ---------------------------------------------------------------

def test_torch_port_client_retried_step_is_at_most_once(setup):
    W = 6
    with _server(setup, window=W, streams=1) as srv:
        ref = _session(setup, window=W)
        wins = _windows(3, W, seed=3)
        with _client(srv) as c:
            first = c.step(*wins[0])
            np.testing.assert_allclose(first, ref.step(*wins[0]), atol=SAME)
            c._seq -= 1                     # the retry: the SAME seq again
            np.testing.assert_array_equal(c.step(*wins[0]), first)
            for ori, acc in wins[1:]:
                np.testing.assert_allclose(c.step(ori, acc),
                                           ref.step(ori, acc), atol=SAME)


def test_torch_port_client_acquire_waits_for_free_slot(setup):
    with _server(setup, window=4, streams=1) as srv:
        holder = _client(srv)
        holder.acquire()
        assert holder.acquire() == holder.slot      # idempotent
        with pytest.raises(ServerError) as ei:
            _client(srv, retry_s=0.0).acquire(wait=False)
        assert ei.value.status == 503
        waiter = _client(srv, retry_s=10.0)
        t = threading.Timer(0.3, holder.release)
        t.start()
        try:
            assert waiter.acquire(wait=True) is not None
        finally:
            t.join()
        waiter.release()


def test_torch_port_client_input_validation(setup):
    W = 4
    with _server(setup, window=W, streams=1) as srv:
        c = _client(srv)
        zeros = np.zeros((W, 54), np.float32), np.zeros((W, 18), np.float32)
        with pytest.raises(RuntimeError, match="acquire"):
            c.step(*zeros)
        with pytest.raises(RuntimeError, match="acquire"):
            c.flush()
        c.acquire()
        with pytest.raises(ValueError, match="need ori"):
            c.step(np.zeros((W + 1, 54), np.float32), zeros[1])
        c.release()
        c.release()                         # idempotent no-op


def test_torch_port_client_unknown_fate_window_guard(setup):
    W = 6
    with _server(setup, window=W, streams=1) as srv:
        ref = _session(setup, window=W)
        wins = _windows(3, W, seed=5)
        c = _client(srv, retry_s=0.0)
        c.acquire()
        np.testing.assert_allclose(c.step(*wins[0]), ref.step(*wins[0]),
                                   atol=SAME)
        real = c._roundtrip
        c._roundtrip = lambda *a, **k: (_ for _ in ()).throw(
            ConnectionError("wire cut"))
        with pytest.raises(ConnectionError):
            c.step(*wins[1])
        c._roundtrip = real
        with pytest.raises(RuntimeError, match="unknown"):
            c.step(*wins[2])
        np.testing.assert_allclose(c.step(*wins[1]), ref.step(*wins[1]),
                                   atol=SAME)
        np.testing.assert_allclose(c.step(*wins[2]), ref.step(*wins[2]),
                                   atol=SAME)
        c.release()


def test_torch_port_client_keepalive_and_token_release(setup):
    W = 6
    with _server(setup, window=W, streams=1) as srv:
        wins = _windows(3, W, seed=9)
        c = _client(srv)
        c.acquire()
        assert c._token is not None
        assert c.step(*wins[0]) is not None
        conn = c._conn
        assert conn is not None              # kept alive after a step
        assert c.step(*wins[1]) is not None
        assert c._conn is conn               # the SAME connection reused
        c._conn.close()                      # a dropped one reconnects
        assert c.step(*wins[2]) is not None
        c.release()
        assert c._conn is None and c._token is None
        assert srv.batcher.acquire() is not None


# -- the wire against the JAX package, both ways ------------------------------

@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_torch_port_wire_cross_check_with_jax_package(direction):
    from a3gc_tpu.client import PoseClient as JaxPoseClient
    from a3gc_tpu.eval.streaming import StreamingCascade as JaxCascade
    from a3gc_tpu.serve import PoseServer as JaxPoseServer
    from a3gc_tpu_torch.compat.from_jax import cascade_params_from_jax

    from __graft_entry__ import _body_model
    from torch_port_oracle import cascades, to_jnp

    jcfg, tcfg, params = cascades("a3gc")
    W, K, P = 6, 1, 1
    kw = dict(window=W, stats=load_stats(), normalize=True, lookahead=K,
              history=P)
    jmodel = _body_model(n_vertices=48)
    tparams = cascade_params_from_jax(params, device="cpu")
    if direction == "jax_client_port_server":
        srv = PoseServer(tparams, tcfg, MODEL, streams=2, port=0,
                         max_wait_ms=2.0, device="cpu", **kw)
        client_cls = JaxPoseClient
        ref = JaxCascade(to_jnp(params), jcfg, jmodel, **kw)
    else:
        srv = JaxPoseServer(to_jnp(params), jcfg, jmodel, streams=2, port=0,
                            max_wait_ms=2.0, **kw)
        client_cls = PoseClient
        ref = StreamingCascade(tparams, tcfg, MODEL, device="cpu", **kw)
    with serving(srv):
        wins = _windows(4, W, seed=70)
        for binary in (True, False):
            ref.reset()
            with client_cls(*srv.address, binary=binary, timeout=60.0,
                            retry_s=5.0, retry_interval=0.05) as c:
                assert c.window == W
                for i, (ori, acc) in enumerate(wins):
                    got, want = c.step(ori, acc), ref.step(ori, acc)
                    assert (got is None) == (want is None) == (i < K)
                    if want is not None:
                        np.testing.assert_allclose(
                            got, np.asarray(want), atol=POSE_TOL,
                            err_msg=f"window {i} binary={binary}")
                tail = c.flush()
                np.testing.assert_allclose(tail, np.asarray(ref.flush()),
                                           atol=POSE_TOL)
                assert c.stats()["errors"] == 0
