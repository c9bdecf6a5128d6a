r"""Dynamic-batching pose-serving demo over HTTP (stdlib only).

The production pattern on top of :class:`~a3gc_tpu_torch.eval.streaming.
StreamingCascade` (counterpart of ``a3gc_tpu/serve.py``, the same protocol
on the wire): up to ``streams`` concurrent clients each hold a slot
with carried recurrent state; a dispatcher thread coalesces whatever
requests arrived within ``max_wait_ms`` into ONE multi-stream device step
(idle slots are masked, so their state is untouched — see
``StreamingCascade.step(active=...)``), then fans the poses back out.
One multi-stream step serves every tick regardless of which subset of
clients submitted. Only the dispatcher thread touches the device: it steps,
flushes, resets and swaps parameters, so the kernels' launch counters and
the session's state have one writer.

Protocol (JSON over HTTP):
  POST /v1/session                  → {"slot": i, "window": W}   (acquire)
  POST /v1/step {"slot", "ori" [W,54], "acc" [W,18]}
                                    → {"pose": [W,24,3,3]}
  POST /v1/flush {"slot": i}        → {"pose": [f·W,24,3,3], "frames": f·W}
                                      (lookahead mode: drain the slot's K
                                      buffered windows as one continuous
                                      chunk — call before DELETE or the
                                      tail is discarded; the slot stays
                                      active and re-warms from empty)
  DELETE /v1/session/<slot>         → {}                  (reset + release)
  GET  /v1/stats                    → tick/request counters, tick latency
  POST /v1/reload                   → re-discover + hot-swap checkpoints
                                      without dropping sessions (carried
                                      states persist; the swap runs on the
                                      dispatcher thread, serialized with
                                      device steps)

Binary mode (Content-Type: application/octet-stream on /v1/step): body is
``uint32 slot ‖ float32 ori[W,54] ‖ float32 acc[W,18]`` little-endian;
the response is raw ``float32 pose[W,24,3,3]`` bytes. JSON-encoding a
60-frame pose is megabytes and dominates the round-trip; production
clients should use binary.

Run: ``python -m a3gc_tpu_torch.cli serve --port 8765 --streams 8 ...``
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import socket
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from a3gc_tpu_torch._runtime import thread_checks
from a3gc_tpu_torch.eval.streaming import _tree_map

__all__ = ["PoseServer", "session_snapshot", "session_restore"]

# env handshake for the state-preserving exec recycle (see
# PoseServer._do_recycle): the re-exec'd process inherits the listening
# socket fd and restores slot states/buffers from the snapshot file
_FD_ENV = "A3GC_SERVE_FD"
_RESTORE_ENV = "A3GC_RESTORE_STATE"


def session_snapshot(sess) -> dict:
    r"""Serialize a serving session's mutable state to plain host data:
    the carried recurrent-state pytree and (buffered modes) the per-slot
    window deques. Works for StreamingCascade / DipStreamingSession, any
    state structure — they keep state in ``_states`` and buffers in
    ``_buffers``. Parameters are NOT included (the restored process
    re-resolves them from its own argv)."""
    snap = {"states": _tree_map(lambda t: t.cpu().numpy(), sess._states)}
    if hasattr(sess, "_buffers"):
        snap["buffers"] = [list(b) for b in sess._buffers]
    return snap


def session_restore(sess, snap: dict) -> None:
    r"""Inverse of :func:`session_snapshot` onto a freshly built session
    of the same geometry: the states go back onto the session's device."""
    sess._states = _tree_map(
        lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=sess.device), snap["states"])
    if "buffers" in snap and hasattr(sess, "_buffers"):
        for b, saved in zip(sess._buffers, snap["buffers"]):
            b.clear()
            b.extend(saved)


class _Batcher:
    """Coalesce per-slot requests into multi-stream steps."""

    def __init__(self, session, streams: int, window: int,
                 max_wait_ms: float = 5.0, lookahead: int = 0,
                 history: int = 0):
        self.sess = session
        self.S = streams
        self.W = window
        self.lookahead = lookahead
        self.history = history
        self.buffered = bool(lookahead or history)
        self.max_wait = max_wait_ms / 1e3
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.free = set(range(streams))
        self.pending = {}           # slot -> (ori, acc, seq | None)
        self.results = {}           # slot -> pose | ("error", msg)
        # at-most-once window application: clients may tag each step with
        # a per-slot sequence number; a retried already-applied window
        # (typical after an exec-recycle ate the response) is answered
        # from this cache instead of re-stepped — re-stepping would apply
        # the window to the carried state a SECOND time
        self.seq_applied = {}       # slot -> last applied seq
        self.seq_result = {}        # slot -> its (non-error) result
        self.tick_seqs = {}         # slot -> seq inside the EXECUTING tick
        self.tick_slots = frozenset()   # ALL slots inside the EXECUTING
        #                                 tick (tick_seqs only covers
        #                                 seq-tagged ones) — flush() must
        #                                 see a mid-tick step or the two
        #                                 waiters cross-wire the mailbox
        # acquire idempotency: POST /v1/session may carry a client token;
        # a retried acquire whose 200 response was lost (e.g. eaten by a
        # recycle pause) re-presents the token and gets its ORIGINAL slot
        # back instead of leaking it and consuming a second one
        self.acquire_tokens = {}    # token -> slot
        self.acquire_inflight = {}  # token -> handlers mid-response-write
        self.acquire_delivered = set()  # tokens whose 200 LANDED (or were
        #                                 restored across a recycle — see
        #                                 acquire_outcome)
        self.releasing = set()      # slots whose reset the dispatcher owes
        self.flushing = set()       # slots whose lookahead-tail drain the
                                    # dispatcher owes (see flush())
        self.flush_inflight = set()  # drains executing outside the lock
        self.reload_queue = []      # [(params3, applied_event)] FIFO: each
                                    # requester waits on ITS OWN event, so
                                    # concurrent reloads can't report a
                                    # false success for a swap that was
                                    # overwritten before being applied
        self.stop = False
        self.recycling = False      # refuse new work while quiescing
        self.ticking = False        # a device step is executing lock-free
        # serving counters (read under self.lock)
        self.n_ticks = 0
        self.n_requests = 0
        self.n_errors = 0
        self.tick_latencies = collections.deque(maxlen=1024)   # (secs, size)
        # the device steps run on this thread: under the NaN check of the
        # thread that builds the batcher (cli serve --debug_nans)
        checks = thread_checks()

        def run():
            with checks():
                self._run()
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def acquire(self, token: Optional[str] = None) -> Optional[int]:
        with self.lock:
            if token is not None:
                held = self.acquire_tokens.get(token)
                if held is not None and held not in self.free:
                    # idempotent retry of a lost response
                    self.acquire_inflight[token] = \
                        self.acquire_inflight.get(token, 0) + 1
                    return held
            if not self.free or self.recycling:
                return None
            slot = self.free.pop()
            self.results.pop(slot, None)   # drop any orphan of a dead waiter
            self.seq_applied.pop(slot, None)
            self.seq_result.pop(slot, None)
            # a stale token from a PREVIOUS tenancy of this slot must not
            # be able to claim it now that it has a new owner
            self._purge_tokens(slot)
            if token is not None:
                self.acquire_tokens[token] = slot
                self.acquire_inflight[token] = \
                    self.acquire_inflight.get(token, 0) + 1
            return slot

    def _purge_tokens(self, slot: int) -> None:
        r"""Drop every token record tied to ``slot`` (caller holds the
        lock): on release and on re-tenancy of a freed slot."""
        dead = [t for t, s in self.acquire_tokens.items() if s == slot]
        for t in dead:
            del self.acquire_tokens[t]
            self.acquire_delivered.discard(t)

    def acquire_outcome(self, token: Optional[str], slot: int,
                        delivered: bool) -> None:
        r"""Report whether an acquire's 200 response LANDED on the wire.
        A failed write may mean the client never learned the slot — but
        with a token, a CONCURRENT handler serving the same token (the
        retry racing its original through the listening-socket backlog)
        may have delivered it. Freeing the slot then would hand a
        client-owned session to the next acquirer, so the slot is only
        un-acquired when this was the LAST in-flight handler for the
        token and no handler ever delivered. A token restored across an
        exec-recycle counts as delivered (its pre-recycle fate is
        unknowable; leaking a slot whose client vanished beats
        corrupting one whose client didn't)."""
        with self.lock:
            if token is None:
                if not delivered:
                    # no idempotency available: the client can never
                    # learn this slot — un-acquire (its state is still
                    # the reset one; it was never stepped)
                    self.results.pop(slot, None)
                    self.free.add(slot)
                return
            n = self.acquire_inflight.get(token, 1) - 1
            if n > 0:
                self.acquire_inflight[token] = n
            else:
                self.acquire_inflight.pop(token, None)
            if delivered:
                self.acquire_delivered.add(token)
            elif (n == 0 and token not in self.acquire_delivered
                    and self.acquire_tokens.get(token) == slot
                    and slot not in self.free):
                self.results.pop(slot, None)
                del self.acquire_tokens[token]
                self.free.add(slot)

    def release(self, slot: int, token: Optional[str] = None) -> bool:
        r"""Schedule reset+release. The actual state reset runs ON the
        dispatcher thread (serialized with device steps, so an in-flight
        tick can neither lose the reset nor leak a stale result), and the
        slot only returns to the free pool afterwards.

        ``token``: the slot's acquire token, if the client has one. An
        auto-retried DELETE whose first attempt landed (response lost)
        could otherwise release the slot's NEXT tenant; with the token,
        a re-tenanted (or already-freed) slot answers 404 — which the
        client's 404-after-success rule treats as done."""
        with self.cond:
            if not (0 <= slot < self.S) or slot in self.free:
                return False
            if token is not None and self.acquire_tokens.get(token) != slot:
                return False    # freed+re-tenanted since this client's
                #                 acquire: its release already happened
            if self.recycling:
                # a release mutating slot/seq state between quiesce() and
                # the snapshot would tear the snapshot (or resurrect a
                # freed slot as occupied after the exec) — defer it
                raise RuntimeError("server recycling; retry shortly")
            self.releasing.add(slot)
            self.cond.notify_all()
            while slot not in self.free and not self.stop:
                self.cond.wait(timeout=0.1)
            return True

    def step(self, slot: int, ori: np.ndarray, acc: np.ndarray,
             seq: Optional[int] = None):
        with self.cond:
            if not (0 <= slot < self.S) or slot in self.free \
                    or slot in self.releasing:
                raise ValueError(f"slot {slot} is not an active session")
            if slot in self.flushing or slot in self.flush_inflight:
                # both waiters share the results[slot] mailbox — a step
                # racing a flush would cross-wire the two responses
                raise ValueError(f"slot {slot} has a flush in flight")
            if seq is not None:
                applied = self.seq_applied.get(slot)
                if applied == seq:
                    # retried already-applied window (the response was
                    # lost — e.g. across an exec-recycle): answer from the
                    # cache, do NOT advance the carried state a second time
                    return self.seq_result[slot]
                if applied is not None and seq < applied:
                    # a stale retry of an OLDER window: its cached result
                    # is gone; re-applying it would corrupt the state
                    raise ValueError(
                        f"stale seq {seq} for slot {slot} "
                        f"(last applied {applied})")
                pend = self.pending.get(slot)
                if ((pend is not None and pend[2] == seq)
                        or self.tick_seqs.get(slot) == seq):
                    # duplicate of an IN-FLIGHT window (the original sits
                    # in pending or inside the executing tick — typical
                    # when both the original and the retry were queued in
                    # the listening-socket backlog across a recycle
                    # pause): wait for the ORIGINAL's completion instead
                    # of re-enqueueing. Re-enqueueing would apply the
                    # window to the carried state twice (in-tick case) or
                    # leave one of two mailbox waiters spinning forever
                    # (pending case — results[slot] pops once).
                    while self.seq_applied.get(slot) != seq:
                        if self.stop:
                            raise RuntimeError("server shutting down")
                        if slot in self.free or slot in self.releasing:
                            raise ValueError(
                                f"slot {slot} is not an active session")
                        if (self.pending.get(slot, (0, 0, None))[2] != seq
                                and self.tick_seqs.get(slot) != seq):
                            # the original finished WITHOUT applying
                            # (device error) — its waiter got the error;
                            # tell this one to retry
                            raise RuntimeError(
                                "original request failed; retry")
                        self.cond.wait(timeout=0.1)
                    return self.seq_result[slot]
            if self.recycling:
                raise RuntimeError("server recycling; retry shortly")
            self.pending[slot] = (ori, acc, seq)
            self.cond.notify_all()
            while slot not in self.results:
                self.cond.wait(timeout=0.1)
                if self.stop:
                    raise RuntimeError("server shutting down")
            out = self.results.pop(slot)
            if isinstance(out, tuple) and out[0] == "error":
                raise RuntimeError(out[1])
            return out

    def flush(self, slot: int):
        r"""Drain slot's buffered lookahead tail: one offline-equivalent
        cascade pass over its un-emitted windows from the carried state
        (see ``StreamingCascade.flush``). Runs ON the dispatcher thread,
        serialized with device steps (but OUTSIDE the batcher lock, like
        ticks — a drain is a whole pass over (P+K+1)·W frames).
        Returns the tail pose array [u·W, 24, 3, 3] (u ≤ K windows) or
        None if nothing is un-emitted (plain-windowed servers, a slot
        still warming up after 0 windows, or a history-only server —
        whose buffered past windows were all already emitted; its
        buffer still clears and its state still advances). The slot
        stays active and re-warms from empty."""
        with self.cond:
            if not (0 <= slot < self.S) or slot in self.free \
                    or slot in self.releasing:
                raise ValueError(f"slot {slot} is not an active session")
            if not self.buffered:
                return None     # plain windowing buffers nothing
            if slot in self.pending or slot in self.tick_slots \
                    or slot in self.flushing or slot in self.flush_inflight:
                # tick_slots: a step popped into the EXECUTING tick is no
                # longer in pending, but its waiter still owns the
                # results[slot] mailbox — a flush accepted now would
                # cross-wire the two responses (the step waiter could
                # read the flush tail; the flush waiter would hang)
                raise ValueError(f"slot {slot} has a request in flight")
            if self.recycling:
                raise RuntimeError("server recycling; retry shortly")
            self.flushing.add(slot)
            self.cond.notify_all()
            while slot not in self.results:
                self.cond.wait(timeout=0.1)
                if self.stop:
                    raise RuntimeError("server shutting down")
            out = self.results.pop(slot)
            if isinstance(out, tuple) and out[0] == "error":
                raise RuntimeError(out[1])
            return out

    def swap_params(self, params3) -> bool:
        r"""Checkpoint hot-reload: hand the dispatcher new cascade params.
        The swap is applied ON the dispatcher thread, serialized with
        device steps, so no tick ever mixes old and new stages; carried
        client states persist across the swap (same shapes). Blocks until
        THIS request's params were applied (concurrent reloads queue and
        apply in order — success never means "someone else's params won");
        returns False if the batcher stopped before applying them."""
        applied = threading.Event()
        with self.cond:
            if self.recycling:
                # a param swap between quiesce() and the snapshot would
                # tear the snapshot (params swapping mid-pickle)
                raise RuntimeError("server recycling; retry shortly")
            self.reload_queue.append((params3, applied))
            self.cond.notify_all()
            while not applied.is_set() and not self.stop:
                self.cond.wait(timeout=0.1)
            return applied.is_set()

    def quiesce(self) -> list:
        r"""Recycle preparation: refuse new work, wait until every
        in-flight request (pending steps, executing tick, owed flushes,
        releases, reload swaps) has drained, and return the occupied
        slots. The caller snapshots the session afterwards -- the
        dispatcher is guaranteed idle and stays idle (``recycling``
        rejects new steps/flushes and ``acquire`` returns None)."""
        with self.cond:
            self.recycling = True
            self.cond.notify_all()
            while (self.pending or self.ticking or self.flushing
                   or self.flush_inflight or self.releasing
                   or self.reload_queue) and not self.stop:
                self.cond.wait(timeout=0.1)
            # also let waiter threads consume delivered results before the
            # snapshot (bounded: a result whose waiter died stays orphaned
            # forever — its client is gone and will never retry). Without
            # this, a recycle racing a just-finished tick could execve
            # before the responses were written; the clients would retry
            # windows the snapshotted state had already absorbed. The seq
            # cache (step(seq=)) makes such retries safe regardless; this
            # wait keeps even untagged clients out of the race in practice.
            deadline = time.monotonic() + 2.0
            while self.results and not self.stop \
                    and time.monotonic() < deadline:
                self.cond.wait(timeout=0.05)
            return sorted(set(range(self.S)) - self.free)

    def stats(self) -> dict:
        with self.lock:
            lat = [d for d, _ in self.tick_latencies]
            sizes = [s for _, s in self.tick_latencies]
            return {
                "streams": self.S,
                "window": self.W,
                "lookahead": self.lookahead,
                "history": self.history,
                "active_sessions": self.S - len(self.free),
                "ticks": self.n_ticks,
                "requests": self.n_requests,
                "errors": self.n_errors,
                "tick_ms_mean": (round(1e3 * sum(lat) / len(lat), 3)
                                 if lat else None),
                # nearest-rank p99: ceil(0.99·n)−1 — the MAX for n ≤ 100,
                # so low-traffic outliers stay visible
                "tick_ms_p99": (round(1e3 * sorted(lat)[
                    max(-(-len(lat) * 99 // 100) - 1, 0)], 3)
                    if lat else None),
                "mean_coalesced": (round(sum(sizes) / len(sizes), 2)
                                   if sizes else None),
            }

    def shutdown(self):
        with self.cond:
            self.stop = True
            self.cond.notify_all()
        self.thread.join(timeout=2)

    def _run(self):
        import sys

        zero_o = np.zeros((self.W, 54), np.float32)
        zero_a = np.zeros((self.W, 18), np.float32)
        while True:
            with self.cond:
                while (not self.pending and not self.releasing
                       and not self.flushing and not self.reload_queue
                       and not self.stop):
                    self.cond.wait(timeout=0.1)
                if self.stop:
                    return
                # apply owed checkpoint swaps here, in request order,
                # serialized with device steps (carried states survive:
                # same shapes); each requester's event fires only after
                # ITS params were actually applied
                if self.reload_queue:
                    for params3, applied in self.reload_queue:
                        self.sess.params3 = params3
                        applied.set()
                    self.reload_queue.clear()
                    self.cond.notify_all()
                # process owed releases first: reset happens here, on the
                # same thread as device steps — no state/result races
                _gone = object()
                for slot in sorted(self.releasing):
                    self.sess.reset(stream=slot)
                    had_req = self.pending.pop(slot, None) is not None
                    had_req |= slot in self.flushing
                    self.flushing.discard(slot)
                    # an un-consumed result (its waiter hasn't woken yet)
                    # must become an error, not vanish — else that waiter
                    # blocks forever on the emptied mailbox
                    had_req |= self.results.pop(slot, _gone) is not _gone
                    if had_req:  # un-hang a step/flush racing the release
                        self.results[slot] = ("error", "session released")
                    self.seq_applied.pop(slot, None)
                    self.seq_result.pop(slot, None)
                    self._purge_tokens(slot)
                    self.free.add(slot)
                if self.releasing:
                    self.releasing.clear()
                    self.cond.notify_all()
                # owed lookahead-tail drains run on this thread too
                # (serialized with ticks and param swaps — no state
                # races), but OUTSIDE the lock like ticks: a drain is
                # a whole device pass that must not block
                # acquire/stats/step registration
                flush_now = sorted(self.flushing)
                if flush_now:
                    self.flush_inflight.update(flush_now)
                    self.flushing.clear()
                if not self.pending and not flush_now:
                    continue
                if not flush_now:
                    # brief coalescing window: let concurrent clients
                    # join this tick (bounded for lone-client latency)
                    n_busy = self.S - len(self.free)
                    if len(self.pending) < n_busy:
                        self.cond.wait(timeout=self.max_wait)
                    batch, self.pending = self.pending, {}
                    # same locked section as the pending pop: a duplicate
                    # seq arriving mid-tick must always find its original
                    # in pending OR tick_seqs OR seq_applied (step() infers
                    # "original failed" from absence in all three)
                    self.tick_seqs = {i: s for i, (_, _, s) in batch.items()
                                      if s is not None}
                    self.tick_slots = frozenset(batch)
                    self.ticking = True
            if flush_now:
                # drains execute lock-free; the next loop iteration
                # serves any steps that queued meanwhile
                outs = {}
                for slot in flush_now:
                    try:
                        outs[slot] = self.sess.flush(stream=slot)
                    except Exception as e:  # transient device errors
                        outs[slot] = ("error", f"flush failed: {e!r}")
                with self.cond:
                    self.results.update(outs)
                    self.n_requests += len(outs)
                    self.flush_inflight.difference_update(flush_now)
                    self.cond.notify_all()
                continue
            ori = np.stack([batch.get(i, (zero_o, zero_a, None))[0]
                            for i in range(self.S)])
            acc = np.stack([batch.get(i, (zero_o, zero_a, None))[1]
                            for i in range(self.S)])
            active = np.asarray([1.0 if i in batch else 0.0
                                 for i in range(self.S)], np.float32)
            t0 = time.perf_counter()
            emitted = None
            try:
                if self.buffered:
                    # per-slot buffered emission: a slot still warming up
                    # (buffer not full, e.g. right after acquire/reset)
                    # gets a "warmup" result instead of a pose
                    out = self.sess.step(ori, acc, active=active)
                    if self.S > 1:
                        poses, emitted = out
                    else:
                        poses, emitted = out, np.asarray(
                            [out is not None])
                else:
                    poses = self.sess.step(ori, acc, active=active)
                err = None
            except Exception as e:          # transient device errors
                err = f"device step failed: {e!r}"
                print(f"[a3gc_tpu_torch.serve] {err}", file=sys.stderr)
            dt = time.perf_counter() - t0
            with self.cond:
                self.ticking = False
                self.n_ticks += 1
                self.n_requests += len(batch)
                if err:
                    self.n_errors += len(batch)
                self.tick_latencies.append((dt, len(batch)))
                for i in batch:
                    if err:
                        self.results[i] = ("error", err)
                    elif emitted is not None and not emitted[i if self.S > 1
                                                            else 0]:
                        self.results[i] = ("warmup", self.lookahead)
                    else:
                        self.results[i] = (poses[i] if self.S > 1
                                           else poses)
                    seq = batch[i][2]
                    if seq is not None and not err:
                        # the window is now applied to i's carried state;
                        # remember (seq, result) so a retry of THIS window
                        # is answered from cache instead of re-applied
                        self.seq_applied[i] = seq
                        self.seq_result[i] = self.results[i]
                self.tick_seqs = {}     # after seq_applied: atomic to
                self.tick_slots = frozenset()   # duplicate-seq waiters
                self.cond.notify_all()


class PoseServer:
    r"""HTTP wrapper around a multiplexed streaming cascade session."""

    def __init__(self, params3, cfg, model, window: int = 60,
                 streams: int = 8, stats=None, normalize: bool = False,
                 host: str = "127.0.0.1", port: int = 8765,
                 max_wait_ms: float = 5.0, session=None, reload_fn=None,
                 mesh=None, lookahead: int = 0, history: int = 0,
                 recycle_rss_mb: int = 0, allow_recycle: bool = False,
                 device="cuda"):
        if session is None:
            from a3gc_tpu_torch.eval.streaming import StreamingCascade

            session = StreamingCascade(params3, cfg, model, window=window,
                                       stats=stats, normalize=normalize,
                                       streams=streams, mesh=mesh,
                                       lookahead=lookahead, history=history,
                                       device=device)
        else:
            # e.g. a DipStreamingSession: the session names its own device
            window, streams = session.window, session.streams
            if (getattr(session, "lookahead", 0) != lookahead
                    or getattr(session, "history", 0) != history):
                raise ValueError(
                    f"session lookahead/history "
                    f"({getattr(session, 'lookahead', 0)}/"
                    f"{getattr(session, 'history', 0)}) != requested "
                    f"({lookahead}/{history})")
        sess = session
        # build and load the kernel libraries, and run every context
        # length once, here on the constructing thread and outside the
        # serving path (buffered modes reach the steady-state (P+K+1)·W
        # emission only on the (P+K+1)-th window)
        for _ in range(lookahead + history + 1):
            sess.step(np.zeros((streams, window, 54), np.float32),
                      np.zeros((streams, window, 18), np.float32))
        sess.reset()
        self.batcher = _Batcher(sess, streams, window, max_wait_ms,
                                lookahead=lookahead, history=history)
        self.window = window
        # exec-recycle handoff: restore slot states/buffers + occupancy
        # saved by the pre-exec process (see _do_recycle)
        restore = os.environ.pop(_RESTORE_ENV, None)
        if restore and os.path.exists(restore):
            with open(restore, "rb") as f:
                # unpickling is code execution: refuse a snapshot that is
                # not OURS and PRIVATE (mkstemp wrote it 0600 — a swapped
                # file in a shared /tmp fails one of these checks)
                st = os.fstat(f.fileno())
                if st.st_uid != os.getuid() or (st.st_mode & 0o077):
                    raise RuntimeError(
                        f"refusing recycle snapshot {restore}: owned by "
                        f"uid {st.st_uid} with mode {oct(st.st_mode)} "
                        f"(need our uid and no group/other access)")
                snap = pickle.load(f)
            session_restore(sess, snap["session"])
            with self.batcher.lock:
                for slot in snap["occupied"]:
                    self.batcher.free.discard(slot)
                for slot, (seq, res) in snap.get("seq", {}).items():
                    # carried so a window retried ACROSS the recycle is
                    # answered from cache, not re-applied to the state
                    self.batcher.seq_applied[slot] = seq
                    self.batcher.seq_result[slot] = res
                # carried so an acquire retried ACROSS the recycle gets
                # its original slot back instead of leaking it; restored
                # tokens count as DELIVERED — their pre-recycle fate is
                # unknowable, and a failed post-recycle retry write must
                # not un-acquire a slot the client may already own
                tokens = snap.get("tokens", {})
                self.batcher.acquire_tokens.update(tokens)
                self.batcher.acquire_delivered.update(tokens)
            os.unlink(restore)
            print(f"[a3gc_tpu_torch.serve] recycled: restored "
                  f"{len(snap['occupied'])} live session(s)",
                  file=sys.stderr, flush=True)
        batcher, W = self.batcher, window
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every response carries Content-Length,
            # so clients (PoseClient caches one connection) skip a TCP
            # handshake per step on the serving hot path. Each
            # kept-alive connection pins one ThreadingHTTPServer thread —
            # fine at session-slot client counts.
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):          # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _drain(self):
                # a body this endpoint does not use must still be read:
                # on a kept-alive connection its bytes would otherwise
                # head the next request line
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n:
                    self.rfile.read(n)

            def do_GET(self):
                if self.path == "/v1/stats":
                    if server._recycling:
                        # the pre-exec window (quiesce → snapshot →
                        # backend teardown) can last seconds: a 200
                        # here would let "poll stats until it answers"
                        # clients mistake the DYING generation for the
                        # restored one
                        return self._json(
                            500, {"error": "server recycling; "
                                           "retry shortly"})
                    return self._json(200, batcher.stats())
                return self._json(404, {"error": "unknown endpoint"})

            def do_POST(self):
                if self.path == "/v1/session":
                    # optional idempotency token: a retried acquire whose
                    # 200 was lost re-presents it and gets the SAME slot
                    token = None
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    if n:
                        try:
                            token = json.loads(self.rfile.read(n)
                                               ).get("token")
                        except (ValueError, AttributeError):
                            token = None
                        if token is not None and not (
                                isinstance(token, str)
                                and 0 < len(token) <= 64):
                            return self._json(
                                400, {"error": "token must be a "
                                               "non-empty string <=64"})
                    slot = batcher.acquire(token=token)
                    if slot is None:
                        return self._json(503, {"error": "no free slots"})
                    try:
                        self._json(200, {"slot": slot, "window": W})
                    except OSError:
                        # the client gave up before the response landed
                        # (typical for acquires queued in the listening
                        # socket's backlog across a recycle pause): it
                        # may never have learned the slot id, so keeping
                        # it would leak the slot forever. acquire_outcome
                        # un-acquires ONLY when no concurrent handler for
                        # the same token delivered (a retry racing its
                        # original can answer first — freeing then would
                        # corrupt a client-owned session).
                        batcher.acquire_outcome(token, slot,
                                                delivered=False)
                        raise
                    batcher.acquire_outcome(token, slot, delivered=True)
                    return
                if self.path == "/v1/reload":
                    self._drain()
                    # checkpoint hot-reload: re-discover + swap the cascade
                    # params without dropping sessions (their carried
                    # recurrent state persists through the swap)
                    if reload_fn is None:
                        return self._json(501, {
                            "error": "this server has no reload source "
                                     "(it was built without reload_fn)"})
                    try:
                        new_params3 = reload_fn()
                    except Exception as e:
                        return self._json(500,
                                          {"error": f"reload failed: {e!r}"})
                    try:
                        ok = batcher.swap_params(new_params3)
                    except RuntimeError as e:       # recycling
                        return self._json(500, {"error": str(e)})
                    if not ok:
                        return self._json(503, {
                            "error": "server shutting down; reload not "
                                     "applied"})
                    return self._json(200, {"reloaded": True})
                if self.path == "/v1/recycle":
                    self._drain()
                    # operator-triggered state-preserving process
                    # recycle: drain, snapshot, exec a fresh
                    # process that inherits the listening socket and
                    # restores every live session's carried state
                    if server._recycle_unsupported is not None:
                        return self._json(501, {
                            "error": server._recycle_unsupported})
                    self._json(200, {"recycling": True})
                    try:
                        self.wfile.flush()
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    server._do_recycle()     # does not return (execve)
                    return
                if self.path == "/v1/flush":
                    # drain a slot's buffered lookahead tail (the last K
                    # windows would otherwise be discarded by DELETE)
                    n = int(self.headers.get("Content-Length", 0))
                    binary = (self.headers.get("Content-Type", "")
                              == "application/octet-stream")
                    try:
                        raw = self.rfile.read(n)
                        if binary:
                            if len(raw) != 4:
                                raise ValueError("need 4 bytes: uint32 slot")
                            slot = int(np.frombuffer(raw, "<u4", 1)[0])
                        else:
                            slot = int(json.loads(raw)["slot"])
                        # validates the slot either way; plain-windowed
                        # servers return None without enqueueing
                        tail = batcher.flush(slot)
                    except (KeyError, ValueError, TypeError) as e:
                        return self._json(400, {"error": str(e)})
                    except RuntimeError as e:
                        return self._json(500, {"error": str(e)})
                    if binary:
                        body = (b"" if tail is None else
                                np.ascontiguousarray(
                                    tail, dtype="<f4").tobytes())
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("X-Frames", str(
                            0 if tail is None else len(tail)))
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    return self._json(200, {
                        "pose": [] if tail is None else tail.tolist(),
                        "frames": 0 if tail is None else len(tail)})
                if self.path == "/v1/step":
                    n = int(self.headers.get("Content-Length", 0))
                    binary = (self.headers.get("Content-Type", "")
                              == "application/octet-stream")
                    try:
                        raw = self.rfile.read(n)
                        seq = None
                        if binary:
                            need = 4 + 4 * W * (54 + 18)
                            if len(raw) == need + 4:
                                # extended header: uint32 slot + uint32 seq
                                # (per-slot window sequence number; a
                                # retried already-applied seq is answered
                                # from cache — see _Batcher.step)
                                head = np.frombuffer(raw, "<u4", 2)
                                slot, seq = int(head[0]), int(head[1])
                                off = 8
                            elif len(raw) == need:
                                slot = int(np.frombuffer(raw, "<u4", 1)[0])
                                off = 4
                            else:
                                raise ValueError(
                                    f"need {need} bytes: uint32 slot + "
                                    f"f32 ori[{W},54] + f32 acc[{W},18] "
                                    f"(or {need + 4} with a uint32 seq "
                                    f"after the slot)")
                            flat = np.frombuffer(raw, "<f4", offset=off)
                            ori = flat[:W * 54].reshape(W, 54)
                            acc = flat[W * 54:].reshape(W, 18)
                        else:
                            req = json.loads(raw)
                            slot = int(req["slot"])
                            if req.get("seq") is not None:
                                seq = int(req["seq"])
                            ori = np.asarray(req["ori"], np.float32)
                            acc = np.asarray(req["acc"], np.float32)
                        if ori.shape != (W, 54) or acc.shape != (W, 18):
                            raise ValueError(
                                f"need ori [{W},54] and acc [{W},18]")
                        pose = batcher.step(slot, ori, acc, seq=seq)
                    except (KeyError, ValueError, TypeError) as e:
                        return self._json(400, {"error": str(e)})
                    except RuntimeError as e:
                        return self._json(500, {"error": str(e)})
                    if isinstance(pose, tuple) and pose[0] == "warmup":
                        # lookahead mode: this slot's emission lags K
                        # windows; the frames were accepted and buffered
                        if binary:
                            self.send_response(202)
                            self.send_header("X-Warmup", "1")
                            self.send_header("X-Lag", str(pose[1]))
                            self.send_header("Content-Length", "0")
                            self.end_headers()
                            return
                        return self._json(202, {"warmup": True,
                                                "lag": pose[1]})
                    if binary:
                        body = np.ascontiguousarray(
                            pose, dtype="<f4").tobytes()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    return self._json(200, {"pose": pose.tolist()})
                self._drain()
                return self._json(404, {"error": "unknown endpoint"})

            def do_DELETE(self):
                if self.path.startswith("/v1/session/"):
                    try:
                        slot = int(self.path.rsplit("/", 1)[1])
                    except ValueError:
                        return self._json(400, {"error": "bad slot"})
                    # optional acquire token: an auto-retried DELETE whose
                    # first attempt landed (response lost) must not
                    # release the slot's NEXT tenant — with the token, a
                    # re-tenanted slot answers 404 (client treats
                    # 404-after-success as done)
                    token = None
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    if n:
                        try:
                            token = json.loads(self.rfile.read(n)
                                               ).get("token")
                        except (ValueError, AttributeError):
                            token = None
                        if token is not None and not isinstance(token, str):
                            token = None
                    try:
                        ok = batcher.release(slot, token=token)
                    except RuntimeError as e:       # recycling: retry
                        return self._json(500, {"error": str(e)})
                    if not ok:
                        return self._json(404,
                                          {"error": f"slot {slot} is not "
                                           "an active session"})
                    return self._json(200, {})
                return self._json(404, {"error": "unknown endpoint"})

        inherited = os.environ.pop(_FD_ENV, None)
        if inherited is not None:
            # recycled process: adopt the pre-exec listening socket, so
            # the address (and clients' connects) survive the handoff
            sock = socket.socket(fileno=int(inherited))
            self.httpd = ThreadingHTTPServer(
                sock.getsockname()[:2], Handler, bind_and_activate=False)
            self.httpd.socket.close()       # the unbound placeholder
            self.httpd.socket = sock        # already bound + listening
            self.httpd.server_address = sock.getsockname()[:2]
        else:
            self.httpd = ThreadingHTTPServer((host, port), Handler)
        # recycle support: a mesh session's states are sharded (scale
        # serving by replication instead), and a non-CLI (in-process)
        # server has no argv to re-exec
        if not allow_recycle:
            # recycle re-execs `python -m a3gc_tpu_torch.cli <argv[1:]>`;
            # only a CLI-launched server has an argv that reproduces itself
            self._recycle_unsupported = (
                "recycle requires a CLI-launched server "
                "(`python -m a3gc_tpu_torch.cli serve ...`)")
        elif mesh is not None:
            self._recycle_unsupported = (
                "recycle is not supported for --mesh serving (sharded "
                "states; scale by replication)")
        else:
            self._recycle_unsupported = None
        self._recycling = False
        self._recycle_lock = threading.Lock()
        if recycle_rss_mb and self._recycle_unsupported is None:
            t = threading.Thread(target=self._rss_watchdog,
                                 args=(recycle_rss_mb,), daemon=True)
            t.start()

    @staticmethod
    def _rss_mb() -> float:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) / 1024.0
        except OSError:
            pass
        return 0.0

    def _rss_watchdog(self, limit_mb: int):
        r"""Self-recycle when RSS crosses the limit — the guard of a
        long-lived server against host memory that grows without bound
        (a leak in a library below this code). The recycle
        drains in-flight work, snapshots every live session's carried
        state, and execs a fresh process that inherits the listening
        socket — clients keep their slots and state; they see a pause
        (a new CUDA context, the kernel libraries loaded again by their
        hashed names, the warm-up steps) and must retry requests that
        land in it."""
        while True:
            time.sleep(10.0)
            with self._recycle_lock:
                if self._recycling:
                    # a recycle is already draining (quiesce can take
                    # seconds waiting on an in-flight tick) — stop
                    # watching instead of re-logging every 10 s
                    return
            if self._rss_mb() > limit_mb:
                print(f"[a3gc_tpu_torch.serve] RSS {self._rss_mb():.0f} MB > "
                      f"{limit_mb} MB — recycling", file=sys.stderr,
                      flush=True)
                self._do_recycle()
                return          # only reached if a concurrent trigger won

    def _do_recycle(self):
        r"""Drain, snapshot, exec. Does not return."""
        with self._recycle_lock:
            if self._recycling:      # concurrent trigger: first one wins
                return
            self._recycling = True
        occupied = self.batcher.quiesce()
        # mkstemp: 0600 + unpredictable name, so another local user in a
        # shared /tmp can neither pre-create nor swap the snapshot between
        # dump and load (the restore side re-verifies ownership/mode
        # before unpickling — see PoseServer.__init__)
        tmp_fd, path = tempfile.mkstemp(
            prefix="a3gc_serve_recycle_", suffix=".pkl",
            dir=os.environ.get("TMPDIR", "/tmp"))
        with os.fdopen(tmp_fd, "wb") as f:
            # under the batcher lock: every mutator is recycling-gated by
            # now, but a consistent point-in-time snapshot should not
            # depend on that invariant alone
            with self.batcher.lock:
                snap = {"session": session_snapshot(self.batcher.sess),
                        "occupied": occupied,
                        "seq": {s: (self.batcher.seq_applied[s],
                                    self.batcher.seq_result.get(s))
                                for s in self.batcher.seq_applied},
                        "tokens": dict(self.batcher.acquire_tokens)}
            pickle.dump(snap, f)
        # release the device session before exec: the process image is
        # replaced with a live CUDA context in it, so drop the session's
        # tensors, wait for everything queued on the card and hand the
        # cached blocks back to CUDA first. The snapshot above is
        # plain host data, so nothing here is still needed.
        try:
            import gc

            self.batcher.sess = None
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        except Exception as e:     # never let teardown block the exec
            print(f"[a3gc_tpu_torch.serve] pre-exec device teardown failed "
                  f"(continuing): {e}", file=sys.stderr, flush=True)
        fd = self.httpd.fileno()
        os.set_inheritable(fd, True)
        env = dict(os.environ)
        env[_RESTORE_ENV] = path
        env[_FD_ENV] = str(fd)
        sys.stdout.flush()
        sys.stderr.flush()
        # re-exec through the CLI module, as `python -m
        # a3gc_tpu_torch.cli serve ...` was started
        os.execve(sys.executable,
                  [sys.executable, "-m", "a3gc_tpu_torch.cli"]
                  + sys.argv[1:],
                  env)

    @property
    def address(self):
        return self.httpd.server_address

    def serve_forever(self):
        try:
            self.httpd.serve_forever()
        finally:
            self.batcher.shutdown()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()
