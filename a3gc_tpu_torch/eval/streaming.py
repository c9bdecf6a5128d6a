r"""Online / streaming inference with carried recurrent state (counterpart
of ``a3gc_tpu/eval/streaming.py`` ``make_window_step``,
``StreamingCascade``, ``make_dip_window_step`` and
``DipStreamingSession``), plain windows only.

One fixed-size window of raw IMU frames per client slot goes through
normalize → the graph scatter or the flat concatenation → the three stages
→ IK (or, for DIP, trim the root sensor → normalize → one net → IK), while
each net's recurrent state threads across windows. The nets are
bidirectional, so the backward direction sees only the current window — as
in the JAX package and the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from a3gc_tpu_torch._device import check_module_device, resolve_device
from a3gc_tpu_torch.data import pipeline as DPipe
from a3gc_tpu_torch.models import nets as N
from a3gc_tpu_torch.models.pipeline import (
    CascadeConfig, PoseNetConfig, _node_features, _stage_out,
    pose_net_forward, reduced_global_to_full_local,
)

__all__ = ["make_window_step", "StreamingCascade", "make_dip_window_step",
           "DipStreamingSession"]


def _tree_map(fn, tree):
    r"""Apply ``fn`` to every tensor leaf of a nest of tuples/lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tuple(_tree_map(fn, t) for t in tree)


def _zero_slot(t: torch.Tensor, slot: int) -> torch.Tensor:
    out = t.clone()
    out[:, slot] = 0.0
    return out


def _frame_mask(active: torch.Tensor, B: int, T: int, dtype):
    return (active if active.dim() == 2
            else active[:, None].expand(B, T)).to(dtype)


def make_window_step(cfg: CascadeConfig, model, stats=None):
    r"""Build the windowed-cascade step function.

    Returns ``step(params3, ori, acc, s1, s2, s3, active) -> (pose, s1, s2,
    s3)``: ori [S, T_w, 54], acc [S, T_w, 18] through normalize → scatter →
    the three stages → IK, with each stage's state threading across
    windows. ``active`` [S] 0/1 masks idle serving slots (their state
    carries through unchanged and their pose rows are undefined); it may
    also be a per-frame ones-prefix mask [S, T_w]. ``stats`` holds tensors
    on the inputs' device, or is None for no normalization. pose is
    [S·T_w, 24, 3, 3]."""
    if cfg.stage3.rotsize not in (6, 9):
        raise ValueError(
            "streaming emits full local poses via IK; a rotsize-3 stage 3 "
            "outputs raw positions with no rotation to stream — train stage "
            "3 with --rotsize 9 or 6")

    def _step(params3, ori, acc, s1, s2, s3, active):
        o, a = DPipe.normalize_imu(ori, acc, stats)
        if cfg.is_graph:
            imu = DPipe.scatter_graph_inputs(o, a)         # [S,T_w,15,12]
        else:
            imu = torch.cat((a, o), dim=-1)                # [S,T_w,72]
        B, T = imu.shape[0], imu.shape[1]
        mask = _frame_mask(active, B, T, imu.dtype)
        p1, p2, p3 = params3

        leaf, s1 = pose_net_forward(p1, cfg.stage1, imu, s1, frame_mask=mask)
        x2 = torch.cat((imu, _node_features(cfg, leaf, B, T)), dim=-1)
        full, s2 = pose_net_forward(p2, cfg.stage2, x2, s2, frame_mask=mask)
        x3 = torch.cat((imu, _node_features(cfg, full, B, T)), dim=-1)
        out, s3 = pose_net_forward(p3, cfg.stage3, x3, s3, frame_mask=mask)
        rotsize = cfg.stage3.rotsize
        pose = reduced_global_to_full_local(_stage_out(out, rotsize), model,
                                            rotsize=rotsize)
        return pose, s1, s2, s3

    return _step


class StreamingCascade:
    r"""Online full-cascade inference with carried per-stage state.

    >>> sess = StreamingCascade(params3, cfg, model, window=60)
    >>> for ori_w, acc_w in imu_stream:
    ...     pose = sess.step(ori_w, acc_w)       # [60, 24, 3, 3]
    >>> sess.reset()                             # next subject/sequence

    ``streams=S`` multiplexes S independent clients through one step per
    window, each with its own carried state: ``step`` takes ori [S, T_w,
    54] / acc [S, T_w, 18] and returns [S, T_w, 24, 3, 3];
    ``reset(stream=i)`` clears one client's state; ``active`` [S] marks the
    clients that submitted this tick.

    Runs on ``device`` ("cuda" unless the caller passes "cpu"), where
    ``params3`` must lie. The lookahead/history buffers, the mesh,
    ``run_windows``, ``step_async`` and ``flush`` come with a later slice
    (ROADMAP Queue 1 item 7)."""

    def __init__(self, params3: Tuple, cfg: CascadeConfig, model,
                 window: int = 60,
                 stats: Optional[Dict[str, np.ndarray]] = None,
                 normalize: bool = False, streams: int = 1,
                 lookahead: int = 0, history: int = 0, mesh=None,
                 device="cuda"):
        self.cfg = cfg
        self._init_session(tuple(params3), window, streams, lookahead,
                           history, mesh, device,
                           stats if normalize else None)
        self._step_fn = make_window_step(cfg, model, self.stats)

    def _init_session(self, params, window, streams, lookahead, history,
                      mesh, device, stats):
        r"""Wiring shared with :class:`DipStreamingSession`: ``params3``
        holds the three stages' params here, the one net's there."""
        if lookahead or history or mesh is not None:
            raise NotImplementedError(
                "lookahead/history buffering and mesh serving are not ported "
                "yet (ROADMAP Queue 1 item 7)")
        self.device = resolve_device(device)
        for p in (params if isinstance(params, tuple) else (params,)):
            check_module_device(p, self.device)
        self.params3 = params
        self.window = window
        self.streams = streams
        self.stats = (None if stats is None else
                      {k: torch.as_tensor(v, dtype=torch.float32,
                                          device=self.device)
                       for k, v in stats.items()})
        self._states = self._zero_states()

    def _zero_states(self):
        zero = (N.graph_net_zero_state if self.cfg.is_graph
                else N.dip_zero_state)
        return tuple(zero(c.net, self.streams, self.device)
                     for c in self.cfg.stages)

    def reset(self, stream: Optional[int] = None):
        r"""Clear carried states; ``stream=i`` zeroes only client i's slice:
        index i along axis 1 (the slot axis) of every tensor of every
        state, whatever its structure — (h, c) [2, S, N, H] for the
        graph-LSTM cells, h [2, S, N, H] for ggru, per-layer (h, c) [2, S,
        H] for the DIP nets."""
        if stream is None:
            self._states = self._zero_states()
        else:
            self._states = _tree_map(lambda t: _zero_slot(t, stream),
                                     self._states)

    @torch.no_grad()
    def _dispatch(self, ori_window, acc_window, active=None) -> torch.Tensor:
        S = self.streams
        ori = torch.as_tensor(ori_window, dtype=torch.float32,
                              device=self.device).reshape(S, -1, 54)
        acc = torch.as_tensor(acc_window, dtype=torch.float32,
                              device=self.device).reshape(S, -1, 18)
        if ori.shape[1] != self.window:
            raise ValueError(f"window size {ori.shape[1]} != configured "
                             f"{self.window}")
        act = (torch.ones((S,), dtype=torch.float32, device=self.device)
               if active is None else
               torch.as_tensor(active, dtype=torch.float32,
                               device=self.device).reshape(S))
        out = self._step_fn(self.params3, ori, acc, *self._states, act)
        pose, self._states = out[0], tuple(out[1:])
        if S > 1:
            pose = pose.reshape((S, -1) + pose.shape[1:])
        return pose

    def step(self, ori_window, acc_window, active=None) -> np.ndarray:
        r"""Process one window; returns the full local pose [T_w, 24, 3, 3]
        (streams=1) or [S, T_w, 24, 3, 3] as numpy. Idle slots' state is
        untouched and their pose rows are undefined."""
        return self._dispatch(ori_window, acc_window, active).cpu().numpy()

    def run_windows(self, *args, **kwargs):
        raise NotImplementedError("run_windows is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")

    def step_async(self, *args, **kwargs):
        raise NotImplementedError("step_async is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")

    def flush(self, *args, **kwargs):
        raise NotImplementedError("flush is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")


def make_dip_window_step(cfg: PoseNetConfig, model, stats):
    r"""Build the windowed single-net DIP step.

    Returns ``step(params, ori, acc, state, active) -> (pose, state)``: one
    raw IMU window (ori [S, T_w, 54], acc [S, T_w, 18]) has its root
    sensor's channels dropped, is normalized with the train stats (tensors
    on the inputs' device), runs through the net with carried state, and
    becomes the full local pose via IK — the output contract of
    :func:`make_window_step`, [S·T_w, 24, 3, 3]."""
    if cfg.rotsize not in (6, 9):
        raise ValueError("dip online serving emits full local poses via IK; "
                         "train the net with --rotsize 9 or 6")
    om = stats["ori_mean_channel"][..., :-9]
    os_ = stats["ori_std_channel"][..., :-9]
    am = stats["acc_mean_channel"][..., :-3]
    as_ = stats["acc_std_channel"][..., :-3]
    rotsize = cfg.rotsize

    def _step(params, ori, acc, state, active):
        o = (ori[..., :-9] - om) / os_
        a = (acc[..., :-3] - am) / as_
        x = torch.cat((a, o), dim=-1)                      # [S, T_w, 60]
        mask = _frame_mask(active, x.shape[0], x.shape[1], x.dtype)
        out, state = pose_net_forward(params, cfg, x, state, frame_mask=mask)
        pose = reduced_global_to_full_local(_stage_out(out, rotsize), model,
                                            rotsize=rotsize)
        return pose, state

    return _step


class DipStreamingSession(StreamingCascade):
    r"""Online single-net DIP serving with the serving contract of
    :class:`StreamingCascade` — ``step(ori, acc, active)`` on raw IMU
    windows returning full local poses, ``reset(stream=i)`` — over ONE net
    with one carried state. ``params3`` holds that net's params.

    Lookahead, history and the mesh raise ``NotImplementedError`` (ROADMAP
    Queue 1 item 7)."""

    def __init__(self, params, cfg: PoseNetConfig, model, window: int = 60,
                 stats: Dict[str, np.ndarray] = None, streams: int = 1,
                 lookahead: int = 0, history: int = 0, device="cuda"):
        if stats is None:
            raise ValueError("dip serving needs normalization stats")
        if cfg.is_graph:
            raise ValueError("DipStreamingSession drives the dense single "
                             "net; graph cascades stream through "
                             "StreamingCascade")
        self.cfg = cfg
        self._init_session(params, window, streams, lookahead, history,
                           None, device, stats)
        self._step_fn = make_dip_window_step(cfg, model, self.stats)

    def _zero_states(self):
        return (N.dip_zero_state(self.cfg.net, self.streams, self.device),)
