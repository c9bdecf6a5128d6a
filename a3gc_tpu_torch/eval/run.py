r"""Cascade and DIP evaluation: variable-length sequences → the reference's
5-metric table (counterpart of ``a3gc_tpu/eval/run.py``).

Three protocols, as in the JAX package:

  * ``evaluate``: the reference's, one sequence at batch 1;
  * ``evaluate_batched``: sequences grouped by :func:`bucket_length`, up to
    ``streams`` of a bucket folded into one call of the cascade, whose
    kernels take a per-stream ``n_valid`` (with ``mesh=``, the streams
    split over the mesh's devices);
  * ``evaluate_streaming``: each sequence fed window by window through the
    serving sessions, the emissions scored with the same metrics.

The JAX package pads every sequence to its power-of-two bucket so that one
compiled program serves a bucket. The card compiles nothing per shape, so
here a single sequence runs at its own length and a group is padded only to
its longest member; the groups, and so the means, are the JAX package's.
Every sequence is scored at its own length, which the masked metrics make
equal to scoring it padded.

Timing (``seconds``) of the offline protocols runs from the upload of a
group's inputs to the host copy of its metrics, which fences the device; of
the streaming ones, over the streaming loop. Warm-up is excluded.
``split`` holds the cascade's and the metrics' shares of the last call: the
cascade is fenced by a device synchronisation before the metrics start.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from a3gc_tpu_torch._device import check_module_device, resolve_device
from a3gc_tpu_torch._runtime import span, spanned
from a3gc_tpu_torch.config import joint_set as JS
from a3gc_tpu_torch.data import pipeline as DPipe
from a3gc_tpu_torch.metrics import PoseEvaluator
from a3gc_tpu_torch.models.pipeline import (
    CascadeConfig, _stage_out, cascade_apply, pose_net_forward,
    reduced_global_to_full_local)
from a3gc_tpu_torch.smpl.model import ParametricModel

__all__ = ["bucket_length", "prepare_graph_inputs", "reduced_to_full",
           "CascadeEvaluator", "DipEvaluator", "evaluate_sequences"]


def bucket_length(n: int, minimum: int = 128) -> int:
    """Round a sequence length up to the next power-of-two bucket."""
    b = minimum
    while b < n:
        b *= 2
    return b


def prepare_graph_inputs(ori: np.ndarray, acc: np.ndarray,
                         stats: Optional[Dict[str, np.ndarray]] = None
                         ) -> np.ndarray:
    r"""Normalize and scatter one sequence on the host: [T, 54], [T, 18] →
    [T, 15, 12]."""
    ori = torch.as_tensor(np.asarray(ori, np.float32))
    acc = torch.as_tensor(np.asarray(acc, np.float32))
    if stats is not None:
        stats = {k: torch.as_tensor(v, dtype=torch.float32)
                 for k, v in stats.items()}
    ori, acc = DPipe.normalize_imu(ori, acc, stats)
    return DPipe.scatter_graph_inputs(ori, acc).numpy()


def reduced_to_full(reduced_pose: np.ndarray) -> np.ndarray:
    r"""Ground-truth expansion: 15 reduced rotation matrices → a 24-joint
    frame with the identity elsewhere. [T, 24, 3, 3]."""
    n = reduced_pose.shape[0]
    full = np.tile(np.eye(3, dtype=np.float32), (n, 24, 1, 1))
    full[:, np.asarray(JS.reduced)] = reduced_pose.reshape(n, 15, 3, 3)
    return full


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean(metrics) -> np.ndarray:
    return np.stack(metrics).mean(axis=0)


class _Scorer:
    r"""The metric half shared by the evaluators: the reporting evaluator on
    the model's device and the cascade / metrics time split."""

    def _init_scorer(self, model: ParametricModel, fps: int, device):
        self.model = model
        self.fps = fps
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"the body model lies on {model.device}, the evaluator runs "
                f"on {self.device}: load it with load_parametric_model(..., "
                f"device={str(self.device)!r})")
        self._metrics = PoseEvaluator(model, fps=fps)
        self._reset_split()

    def _score(self, poses, gts, t0) -> np.ndarray:
        r"""Score each [T_s, 24, 3, 3] prediction against its ground truth,
        one sequence at a time; book the time since ``t0`` as the cascade's
        (after a device synchronisation) and the rest as the metrics'.
        Returns [S, 5, 2] on the host."""
        _sync(self.device)
        t1 = time.perf_counter()
        out = torch.stack([self._metrics(p, g)
                           for p, g in zip(poses, gts)]).cpu().numpy()
        t2 = time.perf_counter()
        self.split["cascade_s"] += t1 - t0
        self.split["metrics_s"] += t2 - t1
        return out

    def _reset_split(self):
        self.split = {"cascade_s": 0.0, "metrics_s": 0.0}


class CascadeEvaluator(_Scorer):
    r"""Evaluates a 3-stage cascade over a set of variable-length sequences
    (each: ori [T, 54], acc [T, 18], pose [T, 135] reduced global rotation
    matrices) and reports the reference's 5-metric table. Runs on
    ``device`` ("cuda" unless the caller passes "cpu"), where ``params3``
    and the body model must lie. ``mesh``: :meth:`evaluate_batched` splits
    each group's streams over the mesh's ``data`` axis
    (:func:`~a3gc_tpu_torch.parallel.cascade_apply_sharded`; a group is
    padded with empty rows to a multiple of it); ``device`` is then the
    mesh's first device."""

    def __init__(self, params3: Tuple, cfg: CascadeConfig,
                 model: ParametricModel,
                 stats: Optional[Dict[str, np.ndarray]] = None,
                 normalize: bool = False, fps: int = 60, mesh=None,
                 device="cuda"):
        from a3gc_tpu_torch.parallel.mesh import replicate
        self.mesh = mesh
        self._init_scorer(model, fps,
                          device if mesh is None else mesh.devices[0])
        for p in params3:
            check_module_device(p, self.device)
        self.params3 = tuple(params3)
        self._replicas = (None if mesh is None
                          else replicate(self.params3, mesh))
        self.cfg = cfg
        self.stats = (None if not (normalize and stats is not None) else
                      {k: torch.as_tensor(v, dtype=torch.float32,
                                          device=self.device)
                       for k, v in stats.items()})

    def _net_inputs(self, ori: torch.Tensor, acc: torch.Tensor):
        o, a = DPipe.normalize_imu(ori, acc, self.stats)
        if self.cfg.is_graph:
            return DPipe.scatter_graph_inputs(o, a)         # [S, L, 15, 12]
        return torch.cat((a, o), dim=-1)                   # [S, L, 72]

    def _run(self, ori: np.ndarray, acc: np.ndarray, gts, n_valid):
        r"""One call of the cascade on S sequences end-padded to L frames
        (ori [S, L, 54], acc [S, L, 18]), each scored at its own length
        ``n_valid[s]`` against ``gts[s]`` [n_valid[s], 24, 3, 3].
        :return: (metrics [S, 5, 2] numpy, poses [S, L, 24, 3, 3] on the
        device, seconds)."""
        S, L = ori.shape[:2]
        rows = list(n_valid)
        if self.mesh is not None:   # empty rows up to the data axis
            pad = -S % self.mesh.shape["data"]
            ori, acc = (np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                                    np.float32)])
                        for a in (ori, acc))
            rows += [0] * pad
        t0 = time.perf_counter()
        dev = self.device
        imu = self._net_inputs(torch.as_tensor(ori, device=dev),
                               torch.as_tensor(acc, device=dev))
        mask = None
        if any(n != L for n in rows):
            mask = (np.arange(L)[None, :]
                    < np.asarray(rows)[:, None]).astype(np.float32)
        if self.mesh is None:
            pose = cascade_apply(self.params3, self.cfg, self.model, imu,
                                 frame_mask=mask, device=dev)
        else:
            from a3gc_tpu_torch.parallel.serving import (
                cascade_apply_replicas)
            pose = cascade_apply_replicas(self._replicas, self.cfg,
                                          self.model, imu, self.mesh,
                                          frame_mask=mask)
        pose = pose.reshape(len(rows), L, 24, 3, 3)
        out = self._score([pose[s, :n] for s, n in enumerate(n_valid)],
                          gts, t0)
        return out, pose, time.perf_counter() - t0

    @torch.no_grad()
    def evaluate(self, sequences: List[Dict[str, np.ndarray]],
                 return_preds: bool = False):
        r"""The reference's protocol: each sequence alone at batch 1, at its
        own length.

        :return: (mean metric [5, 2] over sequences, total seconds, total
            frames[, list of predicted poses [T, 24, 3, 3]])."""
        self._reset_split()
        metrics, preds = [], []
        total_time, total_frames = 0.0, 0
        for seq in sequences:
            T = seq["ori"].shape[0]
            gt = reduced_to_full(seq["pose"].reshape(T, 15, 3, 3))
            with span("jit__run"):
                m, pose, seconds = self._run(
                    np.asarray(seq["ori"], np.float32).reshape(1, T, 54),
                    np.asarray(seq["acc"], np.float32).reshape(1, T, 18),
                    [gt], [T])
            total_time += seconds
            total_frames += T
            metrics.append(m[0])
            if return_preds:
                preds.append(pose[0].cpu().numpy())
        out = (_mean(metrics), total_time, total_frames)
        return out + (preds,) if return_preds else out

    @torch.no_grad()
    def evaluate_batched(self, sequences: List[Dict[str, np.ndarray]],
                         streams: int = 8):
        r"""Batched evaluation: sequences grouped by :func:`bucket_length`,
        up to ``streams`` of a bucket in one call of the cascade, padded to
        the group's longest member (per-stream ``n_valid`` in the kernels).
        Equal to :meth:`evaluate` on every sequence.

        :return: (mean metric [5, 2], total seconds, total frames)."""
        if streams < 1:
            raise ValueError(f"streams must be >= 1, got {streams}")
        self._reset_split()
        buckets: Dict[int, List[int]] = {}
        for i, s in enumerate(sequences):
            buckets.setdefault(bucket_length(s["ori"].shape[0]), []).append(i)
        metrics: List[Optional[np.ndarray]] = [None] * len(sequences)
        total_time, total_frames = 0.0, 0
        for _, idxs in sorted(buckets.items()):
            for g0 in range(0, len(idxs), streams):
                group = idxs[g0:g0 + streams]
                lengths = [sequences[i]["ori"].shape[0] for i in group]
                S, L = len(group), max(lengths)
                ori = np.zeros((S, L, 54), np.float32)
                acc = np.zeros((S, L, 18), np.float32)
                gts = []
                for slot, (si, T) in enumerate(zip(group, lengths)):
                    seq = sequences[si]
                    ori[slot, :T] = seq["ori"].reshape(T, 54)
                    acc[slot, :T] = seq["acc"].reshape(T, 18)
                    gts.append(reduced_to_full(
                        seq["pose"].reshape(T, 15, 3, 3)))
                with span("jit__run_b"):
                    out, _, seconds = self._run(ori, acc, gts, lengths)
                total_time += seconds
                total_frames += sum(lengths)
                for slot, si in enumerate(group):
                    metrics[si] = out[slot]
        return _mean(metrics), total_time, total_frames

    @torch.no_grad()
    def evaluate_streaming(self, sequences: List[Dict[str, np.ndarray]],
                           window: int, lookahead: int = 0,
                           history: int = 0, return_preds: bool = False,
                           batch_streams: int = 1, mesh=None):
        r"""The metric table under streaming: every sequence fed window by
        window through :class:`~a3gc_tpu_torch.eval.streaming.
        StreamingCascade` (the code ``cli serve`` runs) with ``lookahead=K``
        future and ``history=P`` past windows of context, the emissions
        scored with the same metrics as the offline protocols.
        ``batch_streams=S`` multiplexes S sequences a tick over the session's
        slots, recycling a slot when its sequence ends. ``seconds`` counts
        the streaming loop only (its host copies fence it), as in the JAX
        package; ``split`` adds the metrics' share. One warm-up stream of
        (P+K+2) windows walks every buffer fill level first. ``mesh`` splits
        the session's slots over its ``data`` axis (S must divide).

        :return: (mean metric [5, 2], total seconds, total frames[, list of
            [T, 24, 3, 3] predictions])."""
        from a3gc_tpu_torch.eval.streaming import (
            StreamingCascade, streaming_predictions_multi)
        self._reset_split()
        sc = StreamingCascade(
            self.params3, self.cfg, self.model, window=window,
            stats=self.stats, normalize=self.stats is not None,
            lookahead=lookahead, history=history, streams=batch_streams,
            mesh=mesh, device=self.device)
        wT = (history + lookahead + 2) * window
        zero = (np.zeros((wT, 54), np.float32), np.zeros((wT, 18), np.float32))
        streaming_predictions_multi(sc, [zero] * batch_streams)

        pairs = [(s["ori"].reshape(-1, 54), s["acc"].reshape(-1, 18))
                 for s in sequences]
        gts = [reduced_to_full(s["pose"].reshape(-1, 15, 3, 3))
               for s in sequences]
        t0 = time.perf_counter()
        preds = streaming_predictions_multi(sc, pairs)
        metrics = self._score(preds, gts, t0)
        total_frames = sum(p.shape[0] for p in preds)
        out = (_mean(metrics), self.split["cascade_s"], total_frames)
        return out + (preds,) if return_preds else out

    @torch.no_grad()
    def warmup(self, lengths: Sequence[int]):
        r"""One zero sequence of the shortest length through the cascade and
        the metrics (excluded from timing): it loads the kernel libraries
        and the device libraries' handles. The card compiles nothing per
        shape, so one pass serves every length."""
        T = min(lengths)
        with span("jit__run"):
            self._run(np.zeros((1, T, 54), np.float32),
                      np.zeros((1, T, 18), np.float32),
                      [np.tile(np.eye(3, dtype=np.float32), (T, 24, 1, 1))],
                      [T])
        self._reset_split()


class DipEvaluator(_Scorer):
    r"""Single-net DIP evaluation: the input drops the root sensor's
    channels, is normalized with the train stats, runs through ONE net, and
    the reduced rotations become the full local pose by IK; the reference's
    5-metric table. Runs on ``device`` like :class:`CascadeEvaluator`."""

    def __init__(self, params, cfg, model: ParametricModel,
                 stats: Dict[str, np.ndarray], fps: int = 60, device="cuda"):
        self._init_scorer(model, fps, device)
        check_module_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.stats = {k: torch.as_tensor(v, dtype=torch.float32,
                                         device=self.device)
                      for k, v in stats.items()}

    @spanned("jit__prep")
    def _prep(self, seq) -> torch.Tensor:
        r"""One sequence's net input on the device: [1, T, 60]."""
        T = seq["ori"].shape[0]
        raw = {k: torch.as_tensor(np.asarray(seq[k], np.float32).reshape(
            1, T, -1), device=self.device) for k in ("ori", "acc")}
        raw["pose"] = None
        return DPipe.dip_batch(raw, self.stats, no_root=True)[0]

    @spanned("jit__to_pose")
    def _to_pose(self, out: torch.Tensor) -> torch.Tensor:
        return reduced_global_to_full_local(
            _stage_out(out, self.cfg.rotsize), self.model,
            rotsize=self.cfg.rotsize)

    @torch.no_grad()
    def evaluate(self, sequences: List[Dict[str, np.ndarray]]):
        r"""Each sequence alone at batch 1, at its own length.

        :return: (mean metric [5, 2], total seconds, total frames)."""
        self._reset_split()
        metrics = []
        total_time, total_frames = 0.0, 0
        for seq in sequences:
            T = seq["ori"].shape[0]
            gt = reduced_to_full(seq["pose"].reshape(T, 15, 3, 3))
            t0 = time.perf_counter()
            with span("jit__run"):
                out, _ = pose_net_forward(self.params, self.cfg,
                                          self._prep(seq))
                metrics.append(self._score([self._to_pose(out)], [gt],
                                           t0)[0])
            total_time += time.perf_counter() - t0
            total_frames += T
        return _mean(metrics), total_time, total_frames

    @torch.no_grad()
    def evaluate_streaming(self, sequences: List[Dict[str, np.ndarray]],
                           window: int, lookahead: int = 0,
                           history: int = 0, batch_streams: int = 1):
        r"""The 5-metric table through the net's online mode: the input
        prepared as offline (on the whole sequence), then fed window by
        window through :class:`~a3gc_tpu_torch.eval.streaming.
        StreamingSession` with carried state, ``lookahead=K`` /
        ``history=P`` context and ``batch_streams`` slots (recycled as
        sequences end); a partial last window is padded by repeating the
        last frame and its padding discarded. ``seconds`` counts the
        streaming loop and the IK after it, ``split`` adds the metrics'.

        :return: (mean metric [5, 2], total seconds, total frames)."""
        from a3gc_tpu_torch.eval.streaming import (StreamingSession,
                                                   streaming_outputs_multi)
        self._reset_split()
        S = max(1, batch_streams)
        sess = StreamingSession(self.params, self.cfg, window=window,
                                streams=S, lookahead=lookahead,
                                history=history, device=self.device)
        prepped = [self._prep(seq)[0].cpu().numpy() for seq in sequences]
        gts = [reduced_to_full(seq["pose"].reshape(-1, 15, 3, 3))
               for seq in sequences]
        wT = (history + lookahead + 2) * window
        streaming_outputs_multi(
            sess, [np.zeros((wT, self.cfg.net.n_input), np.float32)] * S)

        t0 = time.perf_counter()
        outs = streaming_outputs_multi(sess, prepped)
        poses = [self._to_pose(torch.as_tensor(o, device=self.device))
                 for o in outs]
        metrics = self._score(poses, gts, t0)
        return (_mean(metrics), self.split["cascade_s"],
                sum(x.shape[0] for x in prepped))


def evaluate_sequences(params3, cfg: CascadeConfig, model: ParametricModel,
                       sequences, stats=None, normalize=False,
                       report_path: Optional[str] = None,
                       dataset_name: str = "dataset", device="cuda"):
    r"""One-call evaluation (the reference's protocol, warm-up first) with
    the reference's text report appended to ``report_path``."""
    ev = CascadeEvaluator(params3, cfg, model, stats, normalize,
                          device=device)
    ev.warmup([s["ori"].shape[0] for s in sequences])
    mean, seconds, frames = ev.evaluate(sequences)
    if report_path:
        from a3gc_tpu_torch.utils import write_eval_report
        write_eval_report(report_path, dataset_name, seconds, mean,
                          PoseEvaluator.METRIC_NAMES)
    return mean, seconds, frames
