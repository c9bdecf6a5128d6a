r"""Online / streaming inference with carried recurrent state (counterpart
of ``a3gc_tpu/eval/streaming.py``).

One fixed-size window of raw IMU frames per client slot goes through
normalize → the graph scatter or the flat concatenation → the three stages
→ IK (or, for DIP, trim the root sensor → normalize → one net → IK), while
each net's recurrent state threads across windows. The nets are
bidirectional (but for the unidirectional DIP net), so the backward
direction sees only the current window — as
in the JAX package and the reference — unless the session buffers context:
``lookahead=K`` future windows (K windows of latency) and ``history=P``
already-emitted past windows (no latency) are run with every emission.

Every session runs under ``torch.no_grad()`` whatever thread calls it (grad
mode is thread-local, and the CUDA kernels are forward-only).
"""

from __future__ import annotations

import collections
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

__all__ = ["StreamingSession", "StreamingCascade", "DipStreamingSession",
           "make_window_step", "make_dip_window_step",
           "streaming_predictions", "streaming_predictions_multi",
           "streaming_outputs", "streaming_outputs_multi"]


def _tree_map(fn, tree):
    r"""Apply ``fn`` to every leaf (tensor or array) of a nest of
    tuples/lists."""
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _zero_slot(t: torch.Tensor, slot: int, axis: int = 1) -> torch.Tensor:
    out = t.clone()
    out.select(axis, slot).zero_()
    return out


def _slot_axis(cfg: PoseNetConfig) -> int:
    r"""The slot axis of every state leaf of a net (``reset(stream=i)``
    zeroes its slice): graph states are [2, S, N, H], dense bidirectional
    [2, S, H], dense unidirectional [S, H]."""
    return 1 if (cfg.is_graph or cfg.net.bidirectional) else 0


def _frame_mask(active: torch.Tensor, B: int, T: int, dtype):
    return (active if active.dim() == 2
            else active[:, None].expand(B, T)).to(dtype)


def _to_host(t) -> np.ndarray:
    r"""A device tensor as numpy. The copy waits for everything queued on
    the tensor's stream before it, so it is the fence of the transactional
    commits below."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _buffered_flush(buffers, states, W, K, P, stream, run):
    r"""The drain shared by :meth:`StreamingCascade.flush` and
    :meth:`StreamingSession.flush`: one pass over each selected slot's
    whole buffer from the carried state, with a ones-prefix per-frame mask
    (slot i's f·W buffered frames are real, the rest padding; masked steps
    carry the other slots unchanged). ``run(ctx, mask) -> (full [S, Tc,
    ...] numpy, states)`` must fetch ``full`` to the host — which fences the
    device — before it returns: the caller commits states and buffers only
    afterwards, so a failed pass leaves the session as it was. Returns
    ``(tails, states)``; ``tails`` is None when nothing is buffered, else
    the per-slot list of un-emitted frames (None where there are none)."""
    S = len(buffers)
    sel = [stream] if stream is not None else list(range(S))
    fills = [len(buffers[i]) if i in sel else 0 for i in range(S)]
    if not any(fills):
        return None, states
    Tc = (P + K + 1) * W
    ref = buffers[next(i for i in sel if fills[i])][0]
    ctx = tuple(np.zeros((S, Tc) + c.shape[1:], np.float32) for c in ref)
    mask = np.zeros((S, Tc), np.float32)
    for i in sel:
        if fills[i]:
            for j, comp in enumerate(zip(*buffers[i])):
                ctx[j][i, :fills[i] * W] = np.concatenate(comp)
            mask[i, :fills[i] * W] = 1.0
    full, states = run(ctx, mask)
    for i in sel:       # buffers drop only once the fetched pass succeeded
        if fills[i]:
            buffers[i].clear()
    # un-emitted tail: everything but the newest K windows was already
    # emitted (a slot that never reached K+1 windows emitted nothing, so
    # its whole fill is tail)
    tails = []
    for i in range(S):
        u = fills[i] if fills[i] <= K else K
        tails.append(full[i, (fills[i] - u) * W:fills[i] * W] if u else None)
    return tails, states


def _flush_result(tails, S, stream):
    if tails is None:
        return None if (S == 1 or stream is not None) else [None] * S
    if stream is not None:
        return tails[stream]
    return tails[0] if S == 1 else tails


def make_window_step(cfg: CascadeConfig, model, stats=None):
    r"""Build the windowed-cascade step function.

    Returns ``step(params3, ori, acc, s1, s2, s3, active) -> (pose, s1, s2,
    s3)``: ori [S, T_w, 54], acc [S, T_w, 18] through normalize → scatter →
    the three stages → IK, with each stage's state threading across
    windows. ``active`` [S] 0/1 masks idle serving slots (their state
    carries through unchanged and their pose rows are undefined); it may
    also be a per-frame ones-prefix mask [S, T_w] — used by the lookahead
    flush, where slots hold fewer buffered windows than the context length.
    ``stats`` holds tensors on the inputs' device, or is None for no
    normalization. pose is [S·T_w, 24, 3, 3]."""
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


class StreamingSession:
    r"""Stateful streaming wrapper over ONE pipeline net (a graph net or
    a DIP net, bi- or unidirectional), with the serving and quality
    machinery of
    :class:`StreamingCascade`:

      * ``streams=S`` multiplexes S independent clients through one step,
        each with its own carried state slot; ``active`` [S] masks idle
        slots (their state carries through untouched) and
        ``reset(stream=i)`` clears one client.
      * ``lookahead=K`` buffers K future windows per emission (+K windows
        of latency); ``history=P`` re-runs ≤ P already-emitted past windows
        as leading context at no added latency. The buffered emission is
        the shared transactional loop
        (:meth:`StreamingCascade.emit_buffered`), so state threading is
        identical to plain windowing — buffering changes emissions only.

    >>> sess = StreamingSession(params, cfg, window=60)
    >>> for x_window in stream:             # [window, ...feature dims]
    ...     out = sess.step(x_window)       # [window, ...output dims]
    >>> sess.reset()                        # next sequence

    Runs on ``device`` ("cuda" unless the caller passes "cpu"), where
    ``params`` must lie."""

    def __init__(self, params, cfg: PoseNetConfig, window: int = 60,
                 streams: int = 1, lookahead: int = 0, history: int = 0,
                 fused: bool = True, batch: Optional[int] = None,
                 device="cuda"):
        if batch is not None:               # legacy alias for streams
            streams = batch
        self.device = resolve_device(device)
        check_module_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.window = window
        self.streams = streams
        self.lookahead = int(lookahead)
        self.history = int(history)
        if self.history < 0 or self.lookahead < 0:
            raise ValueError("lookahead and history must be >= 0")
        self.fused = bool(fused) and bool(self.lookahead or self.history)
        self._buffers = [collections.deque() for _ in range(streams)]
        self._state = self._zero_state()
        self._slot_axis = _slot_axis(cfg)

    def _zero_state(self):
        zero = (N.graph_net_zero_state if self.cfg.is_graph
                else N.dip_zero_state)
        return zero(self.cfg.net, self.streams, self.device)

    def _fn(self, x, state, active):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        act = torch.as_tensor(active, dtype=torch.float32,
                              device=self.device)
        mask = _frame_mask(act, x.shape[0], x.shape[1], x.dtype)
        return pose_net_forward(self.params, self.cfg, x, state,
                                frame_mask=mask)

    def reset(self, stream: Optional[int] = None):
        r"""Clear the carried recurrent state. ``stream=i`` zeroes only
        client i's state slice and drops its buffered windows (one client
        ending its sequence)."""
        if stream is None:
            self._state = self._zero_state()
            for b in self._buffers:
                b.clear()
        else:
            self._state = _tree_map(
                lambda t: _zero_slot(t, stream, self._slot_axis),
                self._state)
            self._buffers[stream].clear()

    def _lift(self, x_window):
        x = np.asarray(x_window, np.float32)
        squeeze = x.ndim == (3 if self.cfg.is_graph else 2)
        if squeeze:                                     # no stream axis
            x = x[None]
        if x.shape[0] != self.streams:
            raise ValueError(f"got {x.shape[0]} stream rows != configured "
                             f"{self.streams}")
        if x.shape[1] != self.window:
            raise ValueError(f"window size {x.shape[1]} != configured "
                             f"{self.window}")
        return x, squeeze

    @torch.no_grad()
    def step(self, x_window: np.ndarray, active=None):
        r"""Process one window [T_w, ...] (or [S, T_w, ...]); returns the
        net output with the leading stream dim squeezed for streams=1.
        ``active`` [S] 0/1 marks which clients submitted this tick. With
        lookahead/history the emission contract matches
        :meth:`StreamingCascade.step`: streams=1 returns the (lagged)
        output or None while warming up; S > 1 returns ``(out, emitted
        [S] bool)``. Call :meth:`flush` after a stream's last window to
        drain its buffered tail (K ≥ 1 only)."""
        x, squeeze = self._lift(x_window)
        if self.lookahead or self.history:
            return self._step_buffered(x, active)
        S = self.streams
        act = (np.ones(S, np.float32) if active is None
               else np.asarray(active, np.float32).reshape(S))
        out, state = self._fn(x, self._state, act)
        out = _to_host(out)                 # fences; commit only after
        self._state = state
        return out[0] if squeeze else out

    def _step_buffered(self, x, active):
        r"""Buffered-context emission — :meth:`StreamingCascade.
        _step_buffered` over ONE net with one carried state (shared
        transactional loop, same grouped-emission/advance/commit
        semantics)."""
        S, W = self.streams, self.window
        K, P = self.lookahead, self.history
        act = (np.ones(S, bool) if active is None
               else np.asarray(active).astype(bool).reshape(S))
        appended = [i for i in range(S) if act[i]]
        for i in appended:
            self._buffers[i].append((x[i].copy(),))
        state = self._state     # state at the start of the oldest window

        def emission_pass(f, em, ctx):
            return self._fn(ctx[0], state, em)[0]

        def advance_pass(advf, adv_ctx):
            self._state = self._fn(adv_ctx[0], state, advf)[1]

        fused_pass = None
        if self.fused:
            def fused_pass(em, ctx, advf):
                x_dev = torch.as_tensor(ctx[0], device=self.device)
                out, _ = self._fn(x_dev, state, em)
                _, st = self._fn(x_dev[:, :W], state, advf)

                def commit():   # emit_buffered calls it AFTER the fetch
                    self._state = st
                return out, commit

        out, emitted = StreamingCascade.emit_buffered(
            self._buffers, act, W, K, P, appended, emission_pass,
            advance_pass, fused_pass)
        if S == 1:
            return out[0] if emitted[0] else None
        return out, emitted

    @torch.no_grad()
    def flush(self, stream: Optional[int] = None):
        r"""Drain buffered tails at end of stream — the chunk semantics of
        :meth:`StreamingCascade.flush`: one pass over each slot's whole
        buffer from the carried state, the newest ≤ K un-emitted windows
        returned, the state advanced to the stream's end. Plain-windowed
        sessions buffer nothing and return None."""
        S = self.streams
        if not (self.lookahead or self.history):
            return _flush_result(None, S, stream)

        def run(ctx, mask):
            out, st = self._fn(ctx[0], self._state, mask)
            return _to_host(out), st

        tails, self._state = _buffered_flush(
            self._buffers, self._state, self.window, self.lookahead,
            self.history, stream, run)
        return _flush_result(tails, S, stream)


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

    Streaming-quality context: ``lookahead=K`` buffers K windows of FUTURE
    context before emitting (adds K windows of latency); ``history=P``
    re-runs up to P already-emitted PAST windows as attention/self-context
    for every emission at no added latency. They compose: the emission for
    window k is computed over windows [k-P, k+K] from the carried state at
    window k-P. ``fused=True`` runs the steady-state emission and the state
    advance back to back with one host copy; ``fused=False`` fetches
    between them. Both give the same poses and states.

    Runs on ``device`` ("cuda" unless the caller passes "cpu"), where
    ``params3`` must lie. ``mesh`` (slots sharded over several cards) is
    not ported yet (ROADMAP Queue 1 item 14)."""

    def __init__(self, params3: Tuple, cfg: CascadeConfig, model,
                 window: int = 60,
                 stats: Optional[Dict[str, np.ndarray]] = None,
                 normalize: bool = False, streams: int = 1,
                 lookahead: int = 0, history: int = 0, mesh=None,
                 fused: bool = True, device="cuda"):
        self.cfg = cfg
        self._init_session(tuple(params3), window, streams, lookahead,
                           history, mesh, device,
                           stats if normalize else None, fused)
        self._step_fn = make_window_step(cfg, model, self.stats)

    def _init_session(self, params, window, streams, lookahead, history,
                      mesh, device, stats, fused=True):
        r"""Wiring shared with :class:`DipStreamingSession`: ``params3``
        holds the three stages' params here, the one net's there. The
        buffer, dispatch and flush machinery below is generic over the
        length of the state tuple."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving (slots sharded over several cards) is not "
                "ported yet (ROADMAP Queue 1 item 14)")
        self.device = resolve_device(device)
        for p in (params if isinstance(params, tuple) else (params,)):
            check_module_device(p, self.device)
        self.params3 = params
        self.window = window
        self.streams = streams
        self.lookahead = int(lookahead)     # bool True (old API) -> K=1
        self.history = int(history)
        if self.history < 0 or self.lookahead < 0:
            raise ValueError("lookahead and history must be >= 0")
        self.fused = bool(fused) and bool(self.lookahead or self.history)
        self.stats = (None if stats is None else
                      {k: torch.as_tensor(v, dtype=torch.float32,
                                          device=self.device)
                       for k, v in stats.items()})
        # per-slot deques of buffered (ori, acc) windows: the newest K
        # await emission (lookahead), up to P older ones are kept as past
        # context (history); slot i holds at most P+K+1 windows
        self._buffers = [collections.deque() for _ in range(streams)]
        self._states = self._zero_states()
        self._pending = None        # step_async's result in flight
        self._staging = None        # run_windows / step_async buffers

    def _slot_axes(self):
        r"""The slot axis of each stage's state (see :func:`_slot_axis`)."""
        return tuple(_slot_axis(c) for c in self.cfg.stages)

    def _zero_states(self):
        zero = (N.graph_net_zero_state if self.cfg.is_graph
                else N.dip_zero_state)
        return tuple(zero(c.net, self.streams, self.device)
                     for c in self.cfg.stages)

    def reset(self, stream: Optional[int] = None):
        r"""Clear carried states; ``stream=i`` zeroes only client i's slice:
        index i along the slot axis of every tensor of every state,
        whatever its structure — axis 1 of (h, c) [2, S, N, H] for the
        graph-LSTM cells, of h [2, S, N, H] for ggru, of per-layer (h, c)
        [2, S, H] for the bidirectional DIP nets; axis 0 of (h, c) [S, H]
        for the unidirectional DIP net. In lookahead/history mode the
        slot's buffered windows are dropped with it."""
        if stream is None:
            self._states = self._zero_states()
            for b in self._buffers:
                b.clear()
        else:
            self._states = tuple(
                _tree_map(lambda t, ax=ax: _zero_slot(t, stream, ax), st)
                for st, ax in zip(self._states, self._slot_axes()))
            self._buffers[stream].clear()
        self._pending = None

    def _to_dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _run(self, ori, acc, states, active):
        r"""One call of the step function on device tensors (or numpy, which
        is uploaded): ``(pose [S, T, 24, 3, 3], states)``."""
        ori, acc, active = (self._to_dev(a) for a in (ori, acc, active))
        out = self._step_fn(self.params3, ori, acc, *states, active)
        pose = out[0].reshape((ori.shape[0], ori.shape[1]) + out[0].shape[1:])
        return pose, tuple(out[1:])

    def _dispatch(self, ori_window, acc_window, active=None) -> torch.Tensor:
        S = self.streams
        ori = self._to_dev(ori_window).reshape(S, -1, 54)
        acc = self._to_dev(acc_window).reshape(S, -1, 18)
        if ori.shape[1] != self.window:
            raise ValueError(f"window size {ori.shape[1]} != configured "
                             f"{self.window}")
        act = (torch.ones((S,), dtype=torch.float32, device=self.device)
               if active is None else self._to_dev(active).reshape(S))
        pose, self._states = self._run(ori, acc, self._states, act)
        return pose if S > 1 else pose[0]

    @torch.no_grad()
    def step(self, ori_window, acc_window, active=None):
        r"""Process one window; returns the full local pose [T_w, 24, 3, 3]
        (streams=1) or [S, T_w, 24, 3, 3] as numpy. ``active`` [S] 0/1
        marks which clients submitted this tick — idle slots' state is
        untouched and their pose rows are undefined.

        With ``lookahead=K`` (K ≥ 1) the emission lags K windows: step(k)
        returns window k-K's pose computed with windows k-K..k as
        backward-direction context — see :meth:`_step_buffered`. With
        ``history=P`` (P ≥ 1) every emission additionally re-runs up to P
        already-emitted past windows as leading context (no added
        latency). In either buffered mode, for ``streams=1`` the return is
        the (possibly lagged) pose (None while warming up); for S > 1 it is
        ``(pose [S, T_w, ...] | None, emitted [S] bool)`` — slot i's row is
        valid iff ``emitted[i]`` (slots warm up independently, e.g. after a
        per-stream reset). Call :meth:`flush` after a stream's last window
        to drain its buffered tail (K ≥ 1 only; history alone buffers
        nothing un-emitted)."""
        if self.lookahead or self.history:
            return self._step_buffered(ori_window, acc_window, active)
        return _to_host(self._dispatch(ori_window, acc_window, active))

    # -- shared history/lookahead buffer mechanics (numpy and stdlib) --

    @staticmethod
    def assemble_buffered(buffers, act, W, K, P):
        r"""Peek-assemble the emission/advance inputs WITHOUT mutating the
        buffers: ``(emitted [S] bool, groups {fill: (mask [S] f32, ctx)},
        adv [S] bool, adv_ctx)``. Buffers hold per-window TUPLES of arrays
        (the cascade buffers ``(ori [W,54], acc [W,18])``; the single-net
        session ``(x [W,F],)``) and ``ctx`` / ``adv_ctx`` are matching
        tuples of ``[S, fill·W, ...]`` / ``[S, W, ...]`` context arrays
        (``adv_ctx`` is None when no slot advances). A slot emits once it
        holds K+1 windows (the K newest are future context); its whole
        buffer — up to P additional PAST windows — is the emission context,
        so slots are grouped by fill count (one device pass per distinct
        context length; in steady state all active slots sit at the P+K+1
        capacity → one group). ``adv`` marks at-capacity slots whose state
        advances through their oldest window this tick. Mutation happens in
        :meth:`commit_buffered` only after the device passes succeed, so a
        transient device error (which serving catches and survives) cannot
        leave the buffer and the carried state desynced — a retry of the
        same window recomputes identically."""
        S = len(buffers)
        fills = [len(b) for b in buffers]
        emitted = np.array([bool(act[i]) and fills[i] >= K + 1
                            for i in range(S)])
        slots_by_fill: Dict[int, list] = {}
        for i in range(S):
            if emitted[i]:
                slots_by_fill.setdefault(fills[i], []).append(i)

        def _zeros(T_ctx, ref_slot):
            # component count/shapes from a non-empty buffer's first window
            return tuple(np.zeros((S, T_ctx) + c.shape[1:], np.float32)
                         for c in buffers[ref_slot][0])

        groups = {}
        for f, slots in slots_by_fill.items():
            ctx = _zeros(f * W, slots[0])
            em = np.zeros(S, np.float32)
            for i in slots:
                for j, comp in enumerate(zip(*buffers[i])):
                    ctx[j][i] = np.concatenate(comp)
                em[i] = 1.0
            groups[f] = (em, ctx)
        cap = P + K + 1
        adv = np.array([bool(emitted[i]) and fills[i] == cap
                        for i in range(S)])
        adv_slots = [i for i in range(S) if adv[i]]
        adv_ctx = _zeros(W, adv_slots[0]) if adv_slots else None
        for i in adv_slots:
            for j in range(len(adv_ctx)):
                adv_ctx[j][i] = buffers[i][0][j]
        return emitted, groups, adv, adv_ctx

    @staticmethod
    def commit_buffered(buffers, adv):
        r"""Drop each advanced slot's oldest window (the carried state just
        moved through it; below capacity the buffer keeps growing as
        history)."""
        for i, e in enumerate(adv):
            if e:
                buffers[i].popleft()

    @staticmethod
    def emit_buffered(buffers, act, W, K, P, appended, emission_pass,
                      advance_pass, fused_pass=None):
        r"""The grouped-emission loop: assemble per-fill groups, run
        ``emission_pass(f, em, ctx) -> [S, f·W, ...]`` for each (``ctx`` is
        the per-component context tuple — see :meth:`assemble_buffered`;
        this loop copies the emitted window's slice to the host, which
        fences device execution), then ``advance_pass(adv_mask_f32,
        adv_ctx)`` for at-capacity slots (the callback commits the advanced
        state in the caller).

        ``fused_pass(em, ctx, advf) -> (full, commit)``, if given, replaces
        emission_pass + advance_pass for the AT-CAPACITY group — whose
        emitting slots are by construction exactly the advancing slots
        (``adv``); the loop calls ``commit()`` (state assignment) only
        after the host copy of the emission slice, which fences both
        passes, preserving the transactional contract. In steady state
        every active slot sits at capacity, so the whole tick has one host
        fence.

        Transactional: a raise from any callback un-buffers this tick's
        appended windows so a caller that catches (e.g. serving) can retry
        the same window without buffer/state skew; the buffer pops commit
        only after every pass landed. Returns ``(pose [S, W, ...] | None,
        emitted [S] bool)``."""
        emitted, groups, adv, adv_ctx = \
            StreamingCascade.assemble_buffered(buffers, act, W, K, P)
        pose = None
        if emitted.any():
            advanced = False
            try:
                for f in sorted(groups):
                    em, ctx = groups[f]
                    commit = None
                    if fused_pass is not None and f == P + K + 1:
                        full, commit = fused_pass(
                            em, ctx, adv.astype(np.float32))
                    else:
                        full = emission_pass(f, em, ctx)
                    lo = (f - K - 1) * W    # the emitted window's offset
                    sl = _to_host(full[:, lo:lo + W])     # fetch fences
                    if pose is None:
                        pose = np.zeros_like(sl)
                    rows = em.astype(bool)
                    pose[rows] = sl[rows]
                    if commit is not None:
                        commit()
                        advanced = True
                if adv.any() and not advanced:
                    advance_pass(adv.astype(np.float32), adv_ctx)
            except Exception:
                for i in appended:
                    buffers[i].pop()
                raise
            StreamingCascade.commit_buffered(buffers, adv)
        return pose, emitted

    def _step_buffered(self, ori_window, acc_window, active=None):
        r"""Buffered-context emission (lookahead K and/or history P): each
        slot buffers its last ≤ P+K+1 windows; once it holds K+1, the
        window K-from-newest is emitted by running the cascade over the
        ENTIRE buffer from the carried state (kept at the start of the
        oldest buffered window) and slicing that window's T_w outputs — the
        backward direction of every bidirectional layer sees K extra
        windows of future context, and the attention / self-context layers
        see up to P extra windows of past context, cutting
        streaming-vs-offline divergence. The carried state advances through
        the OLDEST window alone (a second, plain pass) only once the buffer
        is at capacity, so state threading is IDENTICAL to plain windowing
        — buffering changes emissions only. Cost: one (P+K+1)·W emission
        pass + one W advance pass per W frames emitted in steady state;
        latency: +K windows (history alone adds none). Buffers are PER
        SLOT, so ``active`` masking (dynamic batching) and per-stream reset
        compose: an idle slot's buffer and state are untouched; a reset
        slot re-warms from empty."""
        S, W = self.streams, self.window
        K, P = self.lookahead, self.history
        ori = np.asarray(ori_window, np.float32).reshape(S, -1, 54)
        acc = np.asarray(acc_window, np.float32).reshape(S, -1, 18)
        if ori.shape[1] != W:
            raise ValueError(f"window size {ori.shape[1]} != configured {W}")
        act = (np.ones(S, bool) if active is None
               else np.asarray(active).astype(bool).reshape(S))
        appended = [i for i in range(S) if act[i]]
        for i in appended:
            # copies: np.asarray is a no-op view for float32 input, and
            # the buffer must survive the caller reusing arrays
            self._buffers[i].append((ori[i].copy(), acc[i].copy()))
        states = self._states           # state at start of oldest window

        def emission_pass(f, em, ctx):
            # over the f buffered windows; read-only on the state
            return self._run(ctx[0], ctx[1], states, em)[0]

        def advance_pass(advf, adv_ctx):
            # over at-capacity slots' oldest window: emit_buffered's emission
            # fetches already fenced; a failure before the assignment
            # leaves self._states untouched
            self._states = self._run(adv_ctx[0], adv_ctx[1], states,
                                     advf)[1]

        fused_pass = None
        if self.fused:
            def fused_pass(em, ctx, advf):
                # at-capacity emission + oldest-window state advance from
                # the same carried states, no host fence between them; the
                # advance input is ctx[:, :W] sliced on the device (no
                # second upload)
                ctx_o, ctx_a = self._to_dev(ctx[0]), self._to_dev(ctx[1])
                full, _ = self._run(ctx_o, ctx_a, states, em)
                _, adv_states = self._run(ctx_o[:, :W], ctx_a[:, :W],
                                          states, advf)

                def commit():   # emit_buffered calls it AFTER the fetch
                    self._states = adv_states
                return full, commit

        pose, emitted = self.emit_buffered(
            self._buffers, act, W, K, P, appended, emission_pass,
            advance_pass, fused_pass)
        if S == 1:
            return pose[0] if emitted[0] else None
        return pose, emitted

    def _plain_pipeline_check(self, what):
        if self.streams != 1 or self.lookahead or self.history \
                or self._pending is not None:
            raise ValueError(f"{what} drives a plain streams=1 session "
                             "with no step_async result pending")

    def _stage(self):
        r"""Device and pinned host buffers of the pipelined paths, made at
        first use on a CUDA session: two input slots (the copy of window
        k+1 lands in one while the step of window k reads the other) and
        two pinned pose slots for :meth:`step_async`. They live as long as
        the session, so a copy on the side stream never writes memory the
        allocator handed to work still queued on the main stream."""
        if self._staging is None:
            S, W = self.streams, self.window
            dev = self.device

            def dev_buf(c):
                return [torch.empty((S, W, c), dtype=torch.float32,
                                    device=dev) for _ in range(2)]

            def pinned(shape):
                return [torch.empty(shape, dtype=torch.float32,
                                    pin_memory=True) for _ in range(2)]

            self._staging = {
                "ori": dev_buf(54), "acc": dev_buf(18),
                "ori_host": pinned((S, W, 54)),
                "acc_host": pinned((S, W, 18)),
                "pose_host": None, "turn": 0,
                "copy_stream": torch.cuda.Stream(device=dev)}
        return self._staging

    def _upload_ahead(self, k, ori_w, acc_w):
        r"""Start the host→device copy of window k into input slot k % 2 on
        the side stream; returns ``(ori, acc, event)``. The caller makes
        the main stream wait for ``event`` before the step that reads
        them."""
        st = self._stage()
        slot = k % 2
        st["ori_host"][slot].copy_(torch.from_numpy(
            np.ascontiguousarray(ori_w, np.float32)).reshape(1, -1, 54))
        st["acc_host"][slot].copy_(torch.from_numpy(
            np.ascontiguousarray(acc_w, np.float32)).reshape(1, -1, 18))
        with torch.cuda.stream(st["copy_stream"]):
            st["ori"][slot].copy_(st["ori_host"][slot], non_blocking=True)
            st["acc"][slot].copy_(st["acc_host"][slot], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return st["ori"][slot], st["acc"][slot], event

    @torch.no_grad()
    def run_windows(self, ori, acc):
        r"""Feed consecutive windows with UPLOAD-AHEAD overlap: window
        k+1's host→device copy (a pinned host buffer, a ``non_blocking``
        copy on a side stream) runs while window k executes; the fetch of
        k's pose stays synchronous, so results and state threading are
        identical to a :meth:`step` loop. Use when the CLIENT already holds
        the next window (sequence replay, file streaming, batched
        evaluation); a live client that produces windows in real time has
        nothing to upload ahead. On a CPU session the windows are stepped
        in turn.

        ``ori``/``acc``: [n, W, ...] stacked windows (plain streams=1
        session only — buffered K/P modes own their dispatch shape).
        Returns the [n, W, ...] poses; state advances exactly as with
        per-window step() calls."""
        self._plain_pipeline_check("run_windows")
        ori = np.asarray(ori, np.float32)
        acc = np.asarray(acc, np.float32)
        n = ori.shape[0]
        if ori.shape[1] != self.window:
            raise ValueError(f"window size {ori.shape[1]} != configured "
                             f"{self.window}")
        if self.device.type != "cuda":
            return np.stack([_to_host(self._dispatch(ori[k], acc[k]))
                             for k in range(n)])
        act = torch.ones((1,), dtype=torch.float32, device=self.device)
        main = torch.cuda.current_stream(self.device)
        nxt = self._upload_ahead(0, ori[0], acc[0])
        poses = []
        for k in range(n):
            o, a, ready = nxt
            main.wait_event(ready)
            pose, states = self._run(o, a, self._states, act)
            if k + 1 < n:
                # the copy of k+1 overlaps the step of k in flight; its
                # slot was last read by the step of k-1, whose pose the
                # host has already fetched
                nxt = self._upload_ahead(k + 1, ori[k + 1], acc[k + 1])
            poses.append(_to_host(pose[0]))     # fetch fences k
            self._states = states
        return np.stack(poses)

    @torch.no_grad()
    def step_async(self, ori_window, acc_window) -> Optional[np.ndarray]:
        r"""Pipelined streaming: dispatch this window and return the
        PREVIOUS window's pose (None right after reset). The device runs
        window k and copies its pose into pinned host memory while the
        host returns to its caller; the result is read at the next call,
        after that copy's event — at the cost of ONE WINDOW of result
        latency. Prefer the latency-neutral upload-ahead
        :meth:`run_windows` when the next window is already known. Call
        :meth:`flush` after the last window."""
        if self.lookahead or self.history:
            raise ValueError(
                "step_async (pipelined) does not compose with buffered "
                "lookahead/history emission; use step()")
        pose = self._dispatch(ori_window, acc_window)
        prev = self._take_pending()
        if self.device.type == "cuda":
            st = self._stage()
            if st["pose_host"] is None:
                st["pose_host"] = [torch.empty(pose.shape, dtype=pose.dtype,
                                               pin_memory=True)
                                   for _ in range(2)]
            host = st["pose_host"][st["turn"]]
            st["turn"] ^= 1
            host.copy_(pose, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._pending = (host, event)
        else:
            self._pending = (pose, None)
        return prev

    def _take_pending(self) -> Optional[np.ndarray]:
        r"""The pose of the window dispatched last, once its copy has
        landed, as an array of the caller's own (the pinned slot it came
        through is written again two windows later)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        host, event = pending
        if event is not None:
            event.synchronize()
        return host.numpy().copy()

    @torch.no_grad()
    def flush(self, stream: Optional[int] = None):
        r"""Drain buffered results at end of stream. Pipelined mode: the
        last dispatched result. Lookahead/history mode: emit each slot's
        un-emitted tail (the newest ≤ K windows) as ONE continuous chunk —
        exactly an offline cascade pass over the slot's whole buffer from
        the carried state, so every tail window sees all remaining future
        context AND the buffered past context (for P=0, K=1 this equals
        plain windowing's final window). The carried state advances to the
        end of the stream either way — with history but no lookahead the
        tail is empty (everything already emitted) and flush only
        re-synchronizes the state, so a caller may keep stepping
        afterwards. ``stream=i`` flushes only slot i (its tail frames
        returned, other slots untouched); otherwise all slots flush:
        returns the single slot's [u·W, ...] tail frames (or None) for
        streams=1, else a per-slot list (None for empty tails)."""
        if self.lookahead or self.history:
            return self._flush_buffered(stream)
        return self._take_pending()

    def _flush_buffered(self, stream: Optional[int]):
        def run(ctx, mask):
            # one pass over each slot's whole buffer: emits the un-emitted
            # tail (with its history context leading it) AND advances the
            # state through every buffered window — including history
            # windows the state had not yet moved through
            pose, states = self._run(ctx[0], ctx[1], self._states, mask)
            return _to_host(pose), states

        tails, self._states = _buffered_flush(
            self._buffers, self._states, self.window, self.lookahead,
            self.history, stream, run)
        return _flush_result(tails, self.streams, stream)


def make_dip_window_step(cfg: PoseNetConfig, model, stats):
    r"""Build the windowed single-net DIP step.

    Returns ``step(params, ori, acc, state, active) -> (pose, state)``: one
    raw IMU window (ori [S, T_w, 54], acc [S, T_w, 18]) has its root
    sensor's channels dropped, is normalized with the train stats (tensors
    on the inputs' device), runs through the net with carried state, and
    becomes the full local pose via IK — the output contract of
    :func:`make_window_step`, [S·T_w, 24, 3, 3], so the whole serving stack
    (batcher, buffered emission, flush) runs unchanged on top."""
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
    r"""Online single-net DIP serving with the FULL serving contract of
    :class:`StreamingCascade` — ``step(ori, acc, active)`` on raw IMU
    windows returning full local poses, ``reset(stream=i)``,
    ``lookahead``/``history`` buffered emission, ``flush``, pipelined
    ``step_async`` and ``run_windows`` — over ONE net with one carried
    state. ``params3`` is inherited as the hot-swappable parameter slot
    (the serve reload path assigns it); here it holds that net's params."""

    def __init__(self, params, cfg: PoseNetConfig, model, window: int = 60,
                 stats: Dict[str, np.ndarray] = None, streams: int = 1,
                 lookahead: int = 0, history: int = 0, fused: bool = True,
                 device="cuda"):
        if stats is None:
            raise ValueError("dip serving needs normalization stats")
        if cfg.is_graph:
            raise ValueError("DipStreamingSession drives the dense single "
                             "net; graph cascades stream through "
                             "StreamingCascade")
        self.cfg = cfg
        self._init_session(params, window, streams, lookahead, history,
                           None, device, stats, fused)
        self._step_fn = make_dip_window_step(cfg, model, self.stats)

    def _slot_axes(self):
        return (_slot_axis(self.cfg),)

    def _zero_states(self):
        return (N.dip_zero_state(self.cfg.net, self.streams, self.device),)


def _hold_pad(x: np.ndarray, W: int):
    r"""Sensor-hold tail padding: repeat the last frame up to a multiple of
    W. Returns (padded, pad length)."""
    rem = (-x.shape[0]) % W
    if rem:
        x = np.concatenate([x, np.repeat(x[-1:], rem, axis=0)])
    return x, rem


def streaming_predictions(session: StreamingCascade, ori: np.ndarray,
                          acc: np.ndarray) -> np.ndarray:
    r"""Run ONE full sequence through a ``streams=1`` session exactly as a
    live client would — window-by-window :meth:`StreamingCascade.step`
    calls plus a final :meth:`StreamingCascade.flush` — and reassemble the
    emissions into the full-length prediction [T, 24, 3, 3].

    Tail policy (a deployment has one too): a final partial window is
    padded by repeating the last frame (sensor-hold — what a client whose
    stream ends mid-window effectively submits), and the padded frames'
    emissions are discarded. The session is reset before and left reset
    after, so one session serves many sequences."""
    if session.streams != 1:
        raise ValueError("streaming_predictions drives one slot")
    W = session.window
    ori, rem = _hold_pad(np.asarray(ori, np.float32).reshape(-1, 54), W)
    acc, _ = _hold_pad(np.asarray(acc, np.float32).reshape(-1, 18), W)
    T = ori.shape[0] - rem
    session.reset()
    out = []
    if not (session.lookahead or session.history):
        # plain windowing: the whole sequence is known, so upload-ahead
        # overlap applies (results identical to the step loop)
        n = (T + rem) // W
        out = list(session.run_windows(ori.reshape(n, W, 54),
                                       acc.reshape(n, W, 18)))
    else:
        for t in range(0, T + rem, W):
            pose = session.step(ori[t:t + W], acc[t:t + W])
            if pose is not None:
                out.append(np.asarray(pose))
        if session.lookahead:
            tail = session.flush()
            if tail is not None:
                out.append(np.asarray(tail))
    session.reset()
    pred = np.concatenate(out)
    assert pred.shape[0] == T + rem
    return pred[:T]


def _multiplex(session, prepped, windows_of, step):
    r"""The slot-recycling loop shared by
    :func:`streaming_predictions_multi` and :func:`streaming_outputs_multi`.
    ``prepped[s]`` is sequence s's padded data with its true length and
    window count last (``(..., T, n_windows)``); ``windows_of(data, t0)``
    returns the per-component window of a sequence at frame t0;
    ``step(batch, act)`` runs one tick on the per-component ``[S, W, ...]``
    batch. Each tick serves up to S sequences' next windows; ragged
    lengths are handled by per-slot ``active`` masking, finished slots are
    flushed, reset and recycled onto the next pending sequence."""
    S, W = session.streams, session.window
    n = len(prepped)
    preds: list = [None] * n
    outs = [[] for _ in range(n)]
    session.reset()
    buffered = bool(session.lookahead or session.history)
    shapes = [c.shape[1:] for c in windows_of(prepped[0], 0)]
    slot_seq = [-1] * S            # sequence a slot is running (-1 free)
    cursor = [0] * S               # that sequence's next window index
    next_seq, live = 0, 0
    while next_seq < n or live:
        for i in range(S):         # recycle freed slots onto pending work
            if slot_seq[i] < 0 and next_seq < n:
                slot_seq[i], cursor[i] = next_seq, 0
                next_seq += 1
                live += 1
        act = np.zeros((S,), np.float32)
        batch = [np.zeros((S, W) + sh, np.float32) for sh in shapes]
        for i in range(S):
            si = slot_seq[i]
            if si >= 0 and cursor[i] < prepped[si][-1]:
                for b, c in zip(batch, windows_of(prepped[si],
                                                  cursor[i] * W)):
                    b[i] = c
                act[i] = 1.0
        if act.any():
            out = step(batch, act)
            if buffered:
                pose, emitted = out
            else:
                pose, emitted = np.asarray(out), act.astype(bool)
            for i in range(S):
                if emitted[i]:
                    outs[slot_seq[i]].append(np.asarray(pose[i]))
                if act[i]:
                    cursor[i] += 1
        for i in range(S):         # retire slots whose feed is exhausted
            si = slot_seq[i]
            if si >= 0 and cursor[i] >= prepped[si][-1]:
                if session.lookahead:
                    tail = session.flush(stream=i)
                    if tail is not None:
                        outs[si].append(np.asarray(tail))
                T, nw = prepped[si][-2:]
                pred = np.concatenate(outs[si])
                assert pred.shape[0] == nw * W
                preds[si] = pred[:T]
                outs[si] = []
                session.reset(stream=i)
                slot_seq[i] = -1
                live -= 1
    session.reset()
    return preds


def streaming_predictions_multi(session: StreamingCascade,
                                sequences) -> list:
    r"""Multiplex MANY sequences over one ``streams=S`` session — the
    batched counterpart of :func:`streaming_predictions`, with identical
    per-sequence semantics (window-by-window feed, sensor-hold tail
    padding, per-slot lookahead flush). Each device tick serves up to S
    sequences' next windows in one step, while the per-sequence outputs
    stay equal to the single-slot path.

    :param sequences: list of ``(ori [T,54], acc [T,18])`` pairs (any
        reshapeable layout); lengths may differ.
    :return: list of [T, 24, 3, 3] predictions, same order.
    """
    S, W = session.streams, session.window
    if S == 1:
        return [streaming_predictions(session, o, a) for o, a in sequences]
    if not sequences:
        return []
    prepped = []
    for ori, acc in sequences:
        ori, rem = _hold_pad(np.asarray(ori, np.float32).reshape(-1, 54), W)
        acc, _ = _hold_pad(np.asarray(acc, np.float32).reshape(-1, 18), W)
        prepped.append((ori, acc, ori.shape[0] - rem, ori.shape[0] // W))
    return _multiplex(
        session, prepped,
        lambda p, t0: (p[0][t0:t0 + W], p[1][t0:t0 + W]),
        lambda batch, act: session.step(batch[0], batch[1], active=act))


def streaming_outputs(session: StreamingSession, x: np.ndarray) -> np.ndarray:
    r"""Run ONE full sequence through a ``streams=1``
    :class:`StreamingSession` exactly as a live client would — the
    single-net counterpart of :func:`streaming_predictions`, with the
    identical sensor-hold tail policy: a final partial window is padded by
    repeating the last frame and the padded frames' outputs discarded. The
    session is reset before and after.

    :param x: the net's input sequence [T, ...feature dims] (already
        prepped — e.g. the DIP no-root normalized 60-channel vector).
    :return: the net's output sequence [T, ...output dims].
    """
    if session.streams != 1:
        raise ValueError("streaming_outputs drives one slot")
    W = session.window
    x, rem = _hold_pad(np.asarray(x, np.float32), W)
    T = x.shape[0] - rem
    session.reset()
    out = []
    for t in range(0, T + rem, W):
        o = session.step(x[t:t + W])
        if o is not None:
            out.append(np.asarray(o))
    if session.lookahead:
        tail = session.flush()
        if tail is not None:
            out.append(np.asarray(tail))
    session.reset()
    pred = np.concatenate(out)
    assert pred.shape[0] == T + rem
    return pred[:T]


def streaming_outputs_multi(session: StreamingSession, sequences) -> list:
    r"""Multiplex MANY sequences over one ``streams=S`` single-net session
    — the single-net counterpart of :func:`streaming_predictions_multi`,
    with identical per-sequence semantics: window-by-window feed,
    sensor-hold tail padding, per-slot lookahead flush, and slot RECYCLING
    — ragged lengths are handled by per-slot ``active`` masking, and a
    finished slot is reset and immediately re-used for the next pending
    sequence.

    :param sequences: list of input sequences [T, ...]; lengths may
        differ.
    :return: list of [T, ...output dims] outputs, same order.
    """
    S, W = session.streams, session.window
    if S == 1:
        return [streaming_outputs(session, x) for x in sequences]
    if not sequences:
        return []
    prepped = []
    for x in sequences:
        x, rem = _hold_pad(np.asarray(x, np.float32), W)
        prepped.append((x, x.shape[0] - rem, x.shape[0] // W))
    return _multiplex(
        session, prepped, lambda p, t0: (p[0][t0:t0 + W],),
        lambda batch, act: session.step(batch[0], active=act))
