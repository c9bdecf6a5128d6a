r"""Driver ``serve_http``: ``PoseServer`` over HTTP, built as ``cli serve``
builds it (a ``StreamingCascade`` of ``streams`` slots and ``window``
frames, the training stats' normalisation, no lookahead or history,
``max_wait_ms``), bound to an ephemeral port on the loopback, with
``clients`` closed-loop ``PoseClient``s, each in a process of its own
(:mod:`portbench.drivers.http_client`), started in set-up.

The session handed to the server is the port's ``StreamingCascade`` with
one addition: the benchmark's span around each ``step`` (the tick), with
the number of slots that submitted. A tick's work is those slots × the
window: idle slots count for nothing.

The window opens at a time sent to every client, closes when the last
request sent before the deadline has been answered. The batcher's
counters are read over HTTP before the opening and after the close.

Mix keys: ``clients``, ``client_cpus`` (the machine's last N cores hold
the client processes and the server keeps off them, as with remote
clients; 0: anywhere), ``streams``, ``window``,
``max_wait_ms``, ``windows_per_sequence`` {lo, hi, count} (stratified,
cycled in a seeded order per client), ``pool`` {sequences, frames},
``sample`` {drawn, among}: per client, the sequence positions whose poses
are compared with the reference, plus the longest sequence any client
finished.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import multiprocessing
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import traffic, weights
from portbench.drivers import http_client
from portbench.reference.common import no_tf32

READY_S = 120.0         # a client's start and warm-up
ANSWER_S = 120.0        # past the deadline, for the last answers


def _timed_session(base):
    r"""``base`` (the port's ``StreamingCascade``) with the benchmark's span
    around ``step``."""

    class TimedSession(base):
        recording = False
        ticks = None
        span = None

        def step(self, ori_window, acc_window, active=None):
            n = (self.streams if active is None
                 else int(np.count_nonzero(active)))
            t0 = time.monotonic()
            with self.span("portbench.tick"):
                out = super().step(ori_window, acc_window, active)
            if self.recording:
                self.ticks.append((t0, time.monotonic(), n))
            return out

    return TimedSession


def _stats(address) -> dict:
    conn = http.client.HTTPConnection(*address, timeout=30)
    try:
        conn.request("GET", "/v1/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


class Run:
    def __init__(self, cell, seed: int, device, tracer):
        from a3gc_tpu_torch.eval.streaming import StreamingCascade
        from a3gc_tpu_torch.serve import PoseServer
        from a3gc_tpu_torch.smpl.model import ParametricModel

        self.cell, self.seed, self.dev, self.tracer = cell, seed, device, \
            tracer
        cfg, mix = cell.config, cell.traffic
        self.W, S = int(mix["window"]), int(mix["streams"])
        self.cores = cores = sorted(os.sched_getaffinity(0))
        n = int(mix["client_cpus"])
        self.client_cores = cores[-n:] if n else cores
        if n:   # this thread, and the server's threads it starts, off them
            os.sched_setaffinity(0, cores[:-n])
        self.stats_np = cell.stats()
        self.server = self.thread = None
        self.clients = []
        w = weights.draw(cell.family.param_spec(cfg), seed, device)
        port_cfg, params3 = cell.family.port_cascade(cfg, w)
        session = _timed_session(StreamingCascade)(
            params3, port_cfg, ParametricModel(device=device),
            window=self.W, stats=self.stats_np,
            normalize=bool(cfg["normalize"]), streams=S, device=device)
        session.ticks = []
        session.span = (torch.profiler.record_function if tracer.on
                        else (lambda name: contextlib.nullcontext()))
        self.session = session
        try:
            self.server = PoseServer(None, None, None, session=session,
                                     host="127.0.0.1", port=0,
                                     max_wait_ms=float(mix["max_wait_ms"]))
            self.thread = threading.Thread(target=self.server.serve_forever,
                                           daemon=True)
            self.thread.start()
            self._start_clients(mix)
        except BaseException:
            self.close()
            raise

    def _start_clients(self, mix):
        ctx = multiprocessing.get_context("spawn")
        host, port = self.server.address[:2]
        for i in range(int(mix["clients"])):
            here, there = ctx.Pipe()
            proc = ctx.Process(target=http_client.main, daemon=True,
                               args=(there, host, port, i, self.seed, mix,
                                     self.cell.stats_path,
                                     self.client_cores))
            proc.start()
            there.close()
            self.clients.append((proc, here))
        for proc, conn in self.clients:
            if not conn.poll(READY_S) or conn.recv() != "ready":
                raise RuntimeError(f"client process {proc.pid} did not "
                                   "report ready")

    def window(self, seconds: float):
        address = self.server.address[:2]
        stats0 = _stats(address)
        sess = self.session
        sess.recording = True
        with self.tracer.window():
            t_open = time.monotonic() + 0.05
            deadline = t_open + seconds
            for _, conn in self.clients:
                conn.send(("go", t_open, deadline))
            reports = []
            for proc, conn in self.clients:
                if not conn.poll(seconds + ANSWER_S + 1.0):
                    raise RuntimeError(f"client process {proc.pid} sent no "
                                       "report")
                reports.append(conn.recv())
            sess.recording = False
            t_close = max(r["last"] for r in reports)
            self.tracer.bounds = (t_open, t_close)
        stats1 = _stats(address)
        ticks = np.asarray([t for t in sess.ticks if t[0] >= t_open],
                           np.float64).reshape(-1, 3)
        self.reports = reports
        rtt = np.concatenate([r["rtt"] for r in reports])
        errors = [e for r in reports for e in r["errors"]]
        return SimpleNamespace(
            frames=sum(r["frames"] for r in reports),
            window_s=t_close - t_open,
            attempted=sum(r["attempted"] for r in reports),
            failed=sum(r["failed"] for r in reports), errors=errors,
            rtt_ms=1e3 * (rtt[:, 1] - rtt[:, 0]),
            ticks=ticks, stats0=stats0, stats1=stats1,
            calls=[(int(n), self.W) for _, _, n in ticks if n])

    def close(self):
        r"""Stop the clients (each has sent its report, or is told to stop
        by its pipe closing), the server and its batcher; drop the
        session."""
        for proc, conn in self.clients:
            conn.close()
        for proc, _ in self.clients:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        self.clients = []
        if self.server is not None:
            self.server.shutdown()
            self.server = None
        if self.thread is not None:
            self.thread.join(timeout=10)
            self.thread = None
        self.session = None
        os.sched_setaffinity(0, self.cores)

    def _compared(self):
        r"""(client, position, (pool index, offset, frames), poses) of the
        compared sequences: every client's drawn ones and the longest that
        any client finished."""
        out = {}
        for c, r in enumerate(self.reports):
            for pos, desc, pose in r["kept"]:
                out[(c, pos)] = (desc, pose)
        best = max(((c, r["longest"]) for c, r in enumerate(self.reports)
                    if r["longest"] is not None),
                   key=lambda cl: cl[1][1][2], default=None)
        if best is not None:
            c, (pos, desc, pose) = best
            out[(c, pos)] = (desc, pose)
        return [out[k] for k in sorted(out)]

    def program_answers(self):
        return [pose for _, pose in self._compared()]

    def reference_answers(self, fmt: str = "fp32"):
        r"""The reference's poses of the compared sequences, each streamed
        window by window from zero states, all sequences in one call a
        window (a finished sequence's slot masked, its state kept)."""
        cfg, W, dev = self.cell.config, self.W, self.dev
        descs = [d for d, _ in self._compared()]
        if not descs:
            return []
        ori_p, acc_p = traffic.imu_pool(self.seed, self.cell.traffic["pool"],
                                     self.stats_np)
        B, K = len(descs), max(n for _, _, n in descs) // W
        w = weights.draw(self.cell.family.param_spec(cfg), self.seed, dev)
        stats = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in self.stats_np.items()}
        out = [[] for _ in descs]
        states = None
        with no_tf32():
            for k in range(K):
                ori = np.zeros((B, W, 54), np.float32)
                acc = np.zeros((B, W, 18), np.float32)
                n_valid = np.zeros(B, np.int64)
                for i, (p, off, n) in enumerate(descs):
                    if k < n // W:
                        lo = off + k * W
                        ori[i], acc[i] = ori_p[p, lo:lo + W], \
                            acc_p[p, lo:lo + W]
                        n_valid[i] = W
                pose, states = self.cell.reference.cascade(
                    cfg, w, torch.as_tensor(ori, device=dev),
                    torch.as_tensor(acc, device=dev), stats,
                    torch.as_tensor(n_valid, device=dev), states, fmt=fmt)
                pose = pose.cpu().numpy()
                for i in range(B):
                    if n_valid[i]:
                        out[i].append(pose[i])
        return [np.concatenate(o) for o in out]
