r"""Python client for the pose-serving HTTP protocol.

:class:`PoseClient` is the client side of :mod:`a3gc_tpu_torch.serve`
(the port's own copy of ``a3gc_tpu/client.py``: the same protocol on the
wire, stdlib and numpy only). It wraps the protocol documented in
``serve.py`` so users do not hand-roll it:

* **binary wire by default** — JSON-encoding a 60-frame pose is
  megabytes and dominates the round trip;
* **at-most-once steps** — every step is tagged with a per-slot
  sequence number and, on a transport failure or a recycle pause, the
  SAME (seq, window) is retried. The server's seq cache answers a
  retried already-applied window from cache instead of advancing the
  carried state a second time, so retries are safe even when the
  response was lost AFTER the window was applied (the exec-recycle
  race);
* **recycle/ reload transparency** — requests that land in a recycle
  pause block on the inherited listening socket or fail with
  "recycling"; the client waits and retries within ``retry_s``.

Usage::

    with PoseClient("pose-server.local", 8765) as c:   # acquires a slot
        for ori, acc in windows:        # ori [W,54], acc [W,18] float32
            pose = c.step(ori, acc)     # [W,24,3,3]; None during warmup
        tail = c.flush()                # buffered-mode tail (else None)
    # the context exit releases the slot

Warmup (``serve --lookahead K``): the first K steps buffer and return
``None`` (HTTP 202); from then on every step emits. ``flush()`` drains
the final K-window tail as one continuous chunk — call it before
releasing or the tail is discarded.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import socket
import time
import uuid
from typing import Optional

import numpy as np

__all__ = ["PoseClient", "ServerError"]


class ServerError(RuntimeError):
    r"""The server answered with a non-retryable error (HTTP status +
    its ``error`` message)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


# transport-level failures worth retrying: the connection died mid-flight
# (server recycling / restarted) or never came up yet
_RETRYABLE = (ConnectionError, socket.timeout, http.client.HTTPException,
              OSError)


class PoseClient:
    r"""One slot on a :class:`~a3gc_tpu_torch.serve.PoseServer`.

    Parameters
    ----------
    host, port : server address.
    binary : use the binary wire for step/flush (default; the JSON mode
        exists for debugging and odd clients).
    timeout : per-request socket timeout in seconds. Keep it generous:
        requests arriving during an exec-recycle are QUEUED in the
        inherited listening socket and answered once the fresh process
        binds (a new CUDA context and the warm-up steps).
    retry_s : total time budget for retrying retryable failures
        (transport errors, "recycling" 500s, acquire-full 503s). 0
        disables retries.
    retry_interval : sleep between retries.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 binary: bool = True, timeout: float = 300.0,
                 retry_s: float = 120.0, retry_interval: float = 1.0):
        self.addr = (host, port)
        self.binary = binary
        self.timeout = timeout
        self.retry_s = retry_s
        self.retry_interval = retry_interval
        self.slot: Optional[int] = None
        self.window: Optional[int] = None
        self._seq = 0
        self._unacked: Optional[str] = None     # digest of a window whose
        #                                         fate is unknown (transport
        #                                         failure after retries)
        self._token: Optional[str] = None       # this slot's acquire token
        self._conn = None                       # kept-alive connection

    # -- wire ----------------------------------------------------------
    def _roundtrip(self, method: str, path: str, body: Optional[bytes],
                   content_type: str, reuse: bool = True):
        r"""One HTTP round trip. ``reuse=True`` rides a kept-alive
        connection when one is cached (saves a TCP handshake per step on
        the serving hot path); a request that must not be
        ambiguous on failure (``flush`` — see :meth:`flush`) passes
        ``reuse=False`` so a stale kept-alive socket cannot make
        "connection died" mean "maybe processed"."""
        conn, self._conn = self._conn, None
        if not reuse and conn is not None:
            conn.close()                # don't ride a stale socket
            conn = None
        if conn is not None:
            try:
                return self._once(conn, method, path, body, content_type)
            except Exception:
                # stale kept-alive socket (server idled/recycled it out):
                # every reuse=True request is idempotent by design (seq /
                # token protected — flush opts out), so retry ONCE on a
                # fresh connection before surfacing anything
                pass
        conn = http.client.HTTPConnection(*self.addr, timeout=self.timeout)
        return self._once(conn, method, path, body, content_type)

    def _once(self, conn, method: str, path: str, body: Optional[bytes],
              content_type: str):
        try:
            conn.request(method, path, body=body,
                         headers={} if body is None else
                         {"Content-Type": content_type})
            resp = conn.getresponse()
            out = resp.status, dict(resp.getheaders()), resp.read()
        except Exception:
            conn.close()
            raise
        # cache only after the response was fully read (HTTP/1.0 servers
        # close per-request: will_close reconnects next time)
        if resp.will_close:
            conn.close()
        else:
            self._conn = conn
        return out

    def close(self) -> None:
        r"""Drop the kept-alive connection (idempotent)."""
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 content_type: str = "application/json",
                 retry: bool = False, retry_503: bool = False,
                 reuse: bool = True):
        r"""One request, optionally retried within the ``retry_s``
        budget. Only ``retry=True`` calls may be re-sent after a
        transport failure — steps are safe (seq-deduplicated
        server-side); acquire is idempotent via its token, release via
        the 404-after-success rule, stats is read-only; flush is
        retried only on failures where the request cannot have been
        processed (connection refused)."""
        deadline = time.monotonic() + self.retry_s
        while True:
            try:
                status, headers, raw = self._roundtrip(
                    method, path, body, content_type, reuse=reuse)
            except _RETRYABLE as e:
                refused = isinstance(e, ConnectionRefusedError)
                if (retry or refused) and time.monotonic() < deadline:
                    time.sleep(self.retry_interval)
                    continue
                raise
            if status in (200, 202):
                return status, headers, raw
            try:
                msg = json.loads(raw).get("error", raw.decode(
                    "utf-8", "replace"))
            except (ValueError, AttributeError):
                msg = raw.decode("utf-8", "replace")
            retryable = ((status == 500 and "recycling" in msg)
                         or (status == 503 and retry_503))
            if retryable and time.monotonic() < deadline:
                time.sleep(self.retry_interval)
                continue
            raise ServerError(status, msg)

    # -- session lifecycle ---------------------------------------------
    def acquire(self, wait: bool = True) -> int:
        r"""Take a slot (``POST /v1/session``). ``wait=True`` keeps
        retrying a full server (503) within the ``retry_s`` budget.

        The request carries a fresh idempotency token: a retried acquire
        whose 200 response was lost (typical across a recycle pause) is
        answered with the ORIGINAL slot instead of consuming — and
        leaking — a second one."""
        if self.slot is not None:
            return self.slot
        token = uuid.uuid4().hex
        body = json.dumps({"token": token}).encode()
        _, _, raw = self._request("POST", "/v1/session", body,
                                  retry=True, retry_503=wait)
        out = json.loads(raw)
        self.slot, self.window = int(out["slot"]), int(out["window"])
        self._seq = 0
        self._unacked = None
        self._token = token
        return self.slot

    def release(self) -> None:
        r"""Reset + free the slot (``DELETE /v1/session/<slot>``). The
        request carries this slot's acquire token, so an auto-retried
        DELETE whose first attempt landed (response lost) cannot release
        the slot's NEXT tenant — the server answers 404 once the token
        no longer owns the slot, which (like a 404 after a lost
        response) means a previous attempt already landed — success."""
        if self.slot is None:
            return
        slot, self.slot, self.window = self.slot, None, None
        token, self._token = self._token, None
        self._unacked = None
        body = (json.dumps({"token": token}).encode()
                if token is not None else None)
        try:
            self._request("DELETE", f"/v1/session/{slot}", body,
                          retry=True)
        except ServerError as e:
            if e.status != 404:     # already released by a lost retry
                raise
        finally:
            self.close()

    def __enter__(self) -> "PoseClient":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- inference -----------------------------------------------------
    def step(self, ori: np.ndarray, acc: np.ndarray) -> Optional[np.ndarray]:
        r"""Submit one window (``ori [W,54]``, ``acc [W,18]`` float32);
        returns ``pose [W,24,3,3]`` — or ``None`` while a lookahead
        server is warming this slot up (the frames were accepted and
        buffered). Tagged with a per-slot seq and retried at-most-once
        on failure.

        The seq only advances when the server ANSWERED: a definitive
        error (``ServerError``) means the window was not applied, so the
        next window safely reuses the number. A transport failure that
        exhausts the retry budget leaves the window's fate UNKNOWN — the
        server may have applied it and lost the response — so the only
        safe continuations are re-calling :meth:`step` with the SAME
        window (same seq: an applied window is answered from the
        server's cache) or :meth:`release`; submitting a DIFFERENT
        window raises."""
        if self.slot is None:
            raise RuntimeError("no slot: call acquire() first")
        W = self.window
        ori = np.ascontiguousarray(ori, dtype="<f4")
        acc = np.ascontiguousarray(acc, dtype="<f4")
        if ori.shape != (W, 54) or acc.shape != (W, 18):
            raise ValueError(f"need ori [{W},54] and acc [{W},18], got "
                             f"{ori.shape} and {acc.shape}")
        digest = hashlib.sha1(ori.tobytes() + acc.tobytes()).hexdigest()
        if self._unacked is not None and digest != self._unacked:
            raise RuntimeError(
                "the previous window's fate is unknown (transport failure "
                "after retries): the server may have applied it. Retry "
                "step() with the SAME window, or release() the slot — a "
                "new window here could double-apply the old one's state")
        seq = self._seq
        try:
            if self.binary:
                body = (np.asarray([self.slot, seq], "<u4").tobytes()
                        + ori.tobytes() + acc.tobytes())
                status, _, raw = self._request(
                    "POST", "/v1/step", body,
                    content_type="application/octet-stream", retry=True)
            else:
                status, _, raw = self._request(
                    "POST", "/v1/step",
                    json.dumps({"slot": self.slot, "seq": seq,
                                "ori": ori.tolist(),
                                "acc": acc.tolist()}).encode(), retry=True)
        except ServerError:
            # definitive server answer: the window was NOT applied (the
            # seq cache was not advanced) — the next window may reuse seq
            self._unacked = None
            raise
        except Exception:
            # transport failure after the retry budget: fate unknown —
            # only the same window (same seq) may be submitted next
            self._unacked = digest
            raise
        self._seq, self._unacked = seq + 1, None
        if status == 202:
            return None
        if self.binary:
            return np.frombuffer(raw, "<f4").reshape(W, 24, 3, 3)
        return np.asarray(json.loads(raw)["pose"], np.float32)

    def flush(self) -> Optional[np.ndarray]:
        r"""Drain the slot's buffered tail (``POST /v1/flush``) as one
        ``[frames,24,3,3]`` chunk; ``None`` when nothing is buffered
        (plain-windowed server, or already drained). NOT seq-protected:
        a flush whose response is lost mid-flight is not re-sent (the
        drain may already have emptied the buffer — a blind retry would
        return an empty tail and look like success)."""
        if self.slot is None:
            raise RuntimeError("no slot: call acquire() first")
        if self.binary:
            body = np.asarray([self.slot], "<u4").tobytes()
            _, headers, raw = self._request(
                "POST", "/v1/flush", body,
                content_type="application/octet-stream", reuse=False)
            frames = int(headers.get("X-Frames", "0"))
            if frames == 0:
                return None
            return np.frombuffer(raw, "<f4").reshape(frames, 24, 3, 3)
        _, _, raw = self._request(
            "POST", "/v1/flush",
            json.dumps({"slot": self.slot}).encode(), reuse=False)
        out = json.loads(raw)
        if not out.get("frames"):
            return None
        return np.asarray(out["pose"], np.float32)

    # -- ops -----------------------------------------------------------
    def stats(self) -> dict:
        r"""``GET /v1/stats`` — tick/request counters, tick latency."""
        _, _, raw = self._request("GET", "/v1/stats", retry=True)
        return json.loads(raw)

    def reload(self) -> dict:
        r"""``POST /v1/reload`` — checkpoint hot-swap (sessions and their
        carried states persist)."""
        _, _, raw = self._request("POST", "/v1/reload", b"{}")
        return json.loads(raw)

    def recycle(self) -> None:
        r"""``POST /v1/recycle`` — operator-triggered state-preserving
        process recycle. Returns once the
        server acknowledged; the pause is observed by the NEXT request
        (which this client retries through)."""
        self._request("POST", "/v1/recycle", b"{}")
        # the server shuts this connection down as it execs — drop it so
        # the next request reconnects instead of failing once first
        self.close()
