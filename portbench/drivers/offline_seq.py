r"""Driver ``offline_seq``: the per-sequence offline protocol of
``evaluate_a3gc_tp.py`` (``CascadeEvaluator.evaluate``), one sequence at a
time, S = 1.

The timed path takes a sequence's raw IMU frames from host arrays to its
local pose on the host: upload, the evaluator's preparation
(``data/pipeline.normalize_imu``, then the graph scatter or the flat
concatenation, as ``eval/run.py`` ``CascadeEvaluator._net_inputs``),
``models/pipeline.cascade_apply`` (three stages and IK) and the copy back.
The window runs sequences back to back until ``seconds`` have passed and
closes when the sequence running then has finished.

Mix keys: ``lengths`` {lo, hi, count} (stratified, cycled in a seeded
order), ``pool`` {sequences, frames}, ``sample`` {drawn, among}: the
positions whose poses are compared with the reference, plus the first
sequence of the longest length.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import traffic, weights
from portbench.reference.common import no_tf32


class Run:
    def __init__(self, cell, seed: int, device, tracer):
        from a3gc_tpu_torch.smpl.model import ParametricModel

        self.cell, self.seed, self.dev, self.tracer = cell, seed, device, \
            tracer
        cfg, mix = cell.config, cell.traffic
        self.stats_np = cell.stats()
        w = weights.draw(cell.family.param_spec(cfg), seed, device)
        self.port_cfg, self.params3 = cell.family.port_cascade(cfg, w)
        self.model = ParametricModel(device=device)   # SMPL's tree: IK
        self.stats = {k: torch.as_tensor(v, dtype=torch.float32,
                                         device=device)
                      for k, v in self.stats_np.items()}
        self.ori, self.acc = traffic.imu_pool(seed, mix["pool"],
                                              self.stats_np)
        lengths = traffic.stratified(**mix["lengths"])
        self.longest = int(lengths.max())
        self.requests = traffic.sequences(seed, 0, lengths, mix["pool"])
        self.keep = traffic.drawn_positions(seed, 0,
                                            mix["sample"]["among"],
                                            mix["sample"]["drawn"])
        self.kept = {}
        for n in sorted(set(int(v) for v in lengths)):   # every shape once
            self._infer(self.ori[0, :n], self.acc[0, :n])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _infer(self, ori: np.ndarray, acc: np.ndarray) -> np.ndarray:
        from a3gc_tpu_torch.data import pipeline as DPipe
        from a3gc_tpu_torch.models.pipeline import cascade_apply

        o = torch.as_tensor(ori, device=self.dev)[None]
        a = torch.as_tensor(acc, device=self.dev)[None]
        o, a = DPipe.normalize_imu(o, a, self.stats)
        imu = (DPipe.scatter_graph_inputs(o, a) if self.port_cfg.is_graph
               else torch.cat((a, o), dim=-1))
        return cascade_apply(self.params3, self.port_cfg, self.model, imu,
                             device=self.dev).cpu().numpy()

    def window(self, seconds: float):
        calls, frames, pos = [], 0, 0
        longest_seen = False
        span = (torch.profiler.record_function if self.tracer.on
                else (lambda name: contextlib.nullcontext()))
        with self.tracer.window():
            t_open = time.monotonic()
            deadline = t_open + seconds
            while True:
                p, off, n = next(self.requests)
                with span("portbench.sequence"):
                    pose = self._infer(self.ori[p, off:off + n],
                                       self.acc[p, off:off + n])
                if pos in self.keep or (n == self.longest
                                        and not longest_seen):
                    self.kept[pos] = ((p, off, n), pose)
                    longest_seen |= n == self.longest
                calls.append((1, n))
                frames += n
                pos += 1
                if time.monotonic() >= deadline:
                    break
            t_close = time.monotonic()
            self.tracer.bounds = (t_open, t_close)
        return SimpleNamespace(frames=frames, window_s=t_close - t_open,
                               attempted=pos, failed=0, calls=calls,
                               rtt_ms=None, ticks=None, stats0=None,
                               stats1=None)

    def close(self):
        self.params3 = self.model = None

    def program_answers(self):
        return [self.kept[k][1] for k in sorted(self.kept)]

    def reference_answers(self, fmt: str = "fp32"):
        r"""The reference's poses of the kept sequences, all in one call
        (end-padded, each at its own length), on weights drawn again from
        the seed."""
        cfg = self.cell.config
        descs = [self.kept[k][0] for k in sorted(self.kept)]
        if not descs:
            return []
        T = max(n for _, _, n in descs)
        ori = np.zeros((len(descs), T, 54), np.float32)
        acc = np.zeros((len(descs), T, 18), np.float32)
        for i, (p, off, n) in enumerate(descs):
            ori[i, :n] = self.ori[p, off:off + n]
            acc[i, :n] = self.acc[p, off:off + n]
        w = weights.draw(self.cell.family.param_spec(cfg), self.seed,
                         self.dev)
        to = (lambda x: torch.as_tensor(x, device=self.dev))
        with no_tf32():
            pose, _ = self.cell.reference.cascade(
                cfg, w, to(ori), to(acc), self.stats,
                to(np.asarray([n for _, _, n in descs])), fmt=fmt)
        pose = pose.cpu().numpy()
        return [pose[i, :n] for i, (_, _, n) in enumerate(descs)]
