r"""Deployment artifacts of the streaming cascade (counterpart of
``a3gc_tpu/export.py``).

The whole windowed inference program — normalize → graph scatter → the
three stages → IK, with carried recurrent state and per-slot activity
masking (or, for DIP, the one net) — goes through ``torch.export`` at
static shapes, one program per (streams, window), with the parameters, the
normalization statistics and the body model's tree baked in. A process
with torch and this package, and no checkpoint, stats or SMPL file, loads
and serves it:

    >>> art = load_exported("exported/a3gc")        # on the card
    >>> states = art.zero_states()
    >>> pose, states = art.step(ori, acc, states)   # [S, W, 24, 3, 3]

The artifact is a directory:

    manifest.json   geometry, the shape and slot axis of every state leaf,
                    provenance (torch version, the device it was exported
                    on, the kernel libraries' source digests), a sha256 of
                    the program that a load verifies
    step.pt2        the ``torch.export`` program: (ori, acc, states,
                    active) -> (pose, states)

The recurrent layers are the registered ops of
:mod:`a3gc_tpu_torch.ops.library`, one node per layer call: a program
exported on the card launches the Hopper kernels where it runs, with the
same checks, launch plans and launch counters as the eager path; one
exported on the CPU computes their plain versions there. A program moves
to another device only when :func:`load_exported` is asked to.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from a3gc_tpu_torch._device import resolve_device
from a3gc_tpu_torch.eval.streaming import (StreamingCascade, _slot_axis,
                                           _to_host, make_dip_window_step,
                                           make_window_step)
from a3gc_tpu_torch.models import nets as N

__all__ = ["export_streaming_cascade", "export_streaming_dip",
           "save_exported", "load_exported",
           "ExportedCascade", "export_bundle", "ExportedBundle",
           "ArtifactSession", "ArtifactLookaheadSession",
           "lookahead_geometries"]

_MANIFEST = "manifest.json"
_STEP = "step.pt2"
_BUNDLE = "bundle.json"
_FORMAT_VERSION = 1
_FORMAT = "torch.export"
_KERNELS = ("gcn_lstm", "ggru", "lstm")


def _pin_backend(cfg, backend: str):
    r"""Pin the scan backend of every net so the exported program does not
    depend on what the exporting process would pick: ``cuda`` on the card
    (the kernels or a raise, never the plain version), ``auto`` on the CPU
    (the ops' plain versions). Accepts a 3-stage ``CascadeConfig`` or a
    single-net ``PoseNetConfig`` (the dip export)."""
    def pin(stage):
        return dataclasses.replace(
            stage, net=dataclasses.replace(stage.net, backend=backend))

    if not hasattr(cfg, "stage1"):
        return pin(cfg)
    return dataclasses.replace(cfg, stage1=pin(cfg.stage1),
                               stage2=pin(cfg.stage2),
                               stage3=pin(cfg.stage3))


def _params_device(nets) -> torch.device:
    devices = {p.device for net in nets for p in net.parameters()}
    if len(devices) != 1:
        raise ValueError(f"the params lie on {sorted(map(str, devices))}; "
                         "export needs them on one device")
    return devices.pop()


class _WindowProgram(nn.Module):
    r"""The window step as a module holding the nets, so that
    ``torch.export`` bakes their parameters into the program."""

    def __init__(self, step, nets, single: bool, streams: int, window: int):
        super().__init__()
        self.nets = nn.ModuleList(nets)
        self._step = step
        self._single = single
        self._geometry = (streams, window)

    def forward(self, ori, acc, states, active):
        params = self.nets[0] if self._single else tuple(self.nets)
        out = self._step(params, ori, acc, *states, active)
        pose = out[0].reshape(self._geometry + tuple(out[0].shape[1:]))
        return pose, tuple(out[1:])


def _state_spec(state, axis: int):
    r"""JSON description of a state nest: a list for a tuple, a dict of
    shape and slot axis for a tensor."""
    if isinstance(state, (tuple, list)):
        return [_state_spec(s, axis) for s in state]
    return {"shape": list(state.shape), "slot_axis": axis}


def _map_spec(fn, spec, *trees):
    r"""``fn(leaf_spec, *leaves)`` over a state nest and its spec, as
    tuples."""
    if isinstance(spec, list):
        return tuple(_map_spec(fn, s, *(t[i] for t in trees))
                     for i, s in enumerate(spec))
    return fn(spec, *trees)


def _export_program(step, nets, single, zero, cfgs, window, streams,
                    device):
    r"""``torch.export`` the window step at (streams, window) under
    ``torch.no_grad()``; returns the program and the state specs."""
    prog = _WindowProgram(step, nets, single, streams, window)
    f32 = dict(dtype=torch.float32, device=device)
    args = (torch.zeros((streams, window, 54), **f32),
            torch.zeros((streams, window, 18), **f32), zero,
            torch.ones((streams,), **f32))
    with torch.no_grad():
        ep = torch.export.export(prog, args, strict=False)
    spec = [_state_spec(z, _slot_axis(c)) for z, c in zip(zero, cfgs)]
    return ep, spec


def _base_manifest(family: str, window: int, streams: int, rotsize: int,
                   backend: str, device: torch.device, normalized: bool,
                   states) -> dict:
    from a3gc_tpu_torch.ops._build import library_digest
    return {
        "format_version": _FORMAT_VERSION,
        "format": _FORMAT,
        "family": family,
        "window": window,
        "streams": streams,
        "rotsize": rotsize,
        "backend": backend,
        "platforms": [device.type],
        "normalized": normalized,
        "inputs": {
            "ori": [streams, window, 54], "acc": [streams, window, 18],
            "active": [streams],
        },
        "outputs": {"pose": [streams, window, 24, 3, 3]},
        "states": states,
        "torch_version": torch.__version__,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else device.type),
        "kernel_digests": {k: library_digest(k) for k in _KERNELS},
    }


def export_streaming_cascade(
        params3: Tuple, cfg, model, window: int = 60, streams: int = 1,
        stats: Optional[Dict[str, np.ndarray]] = None,
        normalize: bool = False):
    r"""Export the windowed cascade step on the device the params lie on.

    Returns ``(exported_step, manifest_dict)``: a
    ``torch.export.ExportedProgram`` (write both with
    :func:`save_exported`). Parameters, stats and the body model's tree are
    baked into the program."""
    device = _params_device(params3)
    backend = "cuda" if device.type == "cuda" else "auto"
    cfg = _pin_backend(cfg, backend)
    stats_t = ({k: torch.as_tensor(v, dtype=torch.float32, device=device)
                for k, v in stats.items()}
               if (normalize and stats is not None) else None)
    step = make_window_step(cfg, model, stats_t)
    zero = tuple((N.graph_net_zero_state if cfg.is_graph
                  else N.dip_zero_state)(c.net, streams, device)
                 for c in cfg.stages)
    ep, spec = _export_program(step, params3, False, zero, cfg.stages,
                               window, streams, device)
    manifest = _base_manifest(
        family=(cfg.stage1.net.cell if cfg.is_graph else "tp"),
        window=window, streams=streams, rotsize=cfg.stage3.rotsize,
        backend=backend, device=device, normalized=stats_t is not None,
        states=spec)
    return ep, manifest


def export_streaming_dip(params, cfg, model, window: int = 60,
                         streams: int = 1,
                         stats: Optional[Dict[str, np.ndarray]] = None):
    r"""Export the single-net DIP online program (no-root trim → normalize
    → net → IK, carried state, per-slot masking) on the device the params
    lie on, bi- or unidirectional. The artifact layout and the runtime are
    those of the cascade export, ``family='dip'``. ``stats`` is mandatory:
    the DIP input always normalizes."""
    if stats is None:
        raise ValueError("dip export needs normalization stats (the DIP "
                         "input is always normalized)")
    device = _params_device((params,))
    backend = "cuda" if device.type == "cuda" else "auto"
    cfg = _pin_backend(cfg, backend)
    stats_t = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
               for k, v in stats.items()}
    step = make_dip_window_step(cfg, model, stats_t)
    zero = (N.dip_zero_state(cfg.net, streams, device),)
    ep, spec = _export_program(step, (params,), True, zero, (cfg,), window,
                               streams, device)
    manifest = _base_manifest(
        family="dip", window=window, streams=streams, rotsize=cfg.rotsize,
        backend=backend, device=device, normalized=True, states=spec)
    return ep, manifest


def save_exported(directory: str, exported, manifest: dict) -> str:
    r"""Write the artifact directory. The manifest records the sha256 of
    the serialized program, which a load verifies."""
    os.makedirs(directory, exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    with open(os.path.join(directory, _STEP), "wb") as f:
        f.write(blob)
    manifest = dict(manifest, sha256={_STEP: hashlib.sha256(blob).hexdigest()})
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return directory


def export_bundle(directory: str, params3, cfg, model,
                  geometries: Sequence[Tuple[int, int]],
                  stats: Optional[Dict[str, np.ndarray]] = None,
                  normalize: bool = False) -> str:
    r"""Export ONE deployment bundle covering several serving geometries:
    one program per (streams, window), each in its own subdirectory, and an
    index. ``cfg`` may be a 3-stage ``CascadeConfig`` or a single-net
    ``PoseNetConfig`` (``params3`` then holds the one DIP net's params and
    ``stats`` is mandatory). Layout::

        bundle.json              index: geometries -> subdirectory
        s{S}_w{W}/manifest.json  ordinary single-geometry artifacts
        s{S}_w{W}/step.pt2
    """
    single_net = not hasattr(cfg, "stage1")
    index = {"format_version": _FORMAT_VERSION, "geometries": []}
    for streams, window in geometries:
        if single_net:
            ep, manifest = export_streaming_dip(
                params3, cfg, model, window=window, streams=streams,
                stats=stats)
        else:
            ep, manifest = export_streaming_cascade(
                params3, cfg, model, window=window, streams=streams,
                stats=stats, normalize=normalize)
        sub = f"s{streams}_w{window}"
        save_exported(os.path.join(directory, sub), ep, manifest)
        index["geometries"].append(
            {"streams": streams, "window": window, "dir": sub})
    with open(os.path.join(directory, _BUNDLE), "w") as f:
        json.dump(index, f, indent=1)
    return directory


class ExportedBundle:
    r"""Runtime view of a multi-geometry bundle directory: ``select`` a
    (streams, window) sub-artifact; each loads lazily and is cached."""

    def __init__(self, directory: str, device="cuda"):
        self.directory = directory
        self.device = resolve_device(device)
        with open(os.path.join(directory, _BUNDLE)) as f:
            self.index = json.load(f)
        if self.index["format_version"] != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported bundle format "
                f"{self.index['format_version']}")
        self._cache = {}

    @property
    def geometries(self):
        return [(g["streams"], g["window"])
                for g in self.index["geometries"]]

    def select(self, streams: Optional[int] = None,
               window: Optional[int] = None) -> "ExportedCascade":
        r"""The sub-artifact of the requested geometry. Unspecified axes
        match the bundle's first entry."""
        for g in self.index["geometries"]:
            if ((streams is None or g["streams"] == streams)
                    and (window is None or g["window"] == window)):
                key = (g["streams"], g["window"])
                if key not in self._cache:
                    self._cache[key] = ExportedCascade(
                        os.path.join(self.directory, g["dir"]), self.device)
                return self._cache[key]
        raise KeyError(
            f"no geometry (streams={streams}, window={window}) in this "
            f"bundle; available: {self.geometries}")


def _check_active(active, S: int) -> np.ndarray:
    r"""The activity mask as float32 [S] of 0s and 1s; anything else
    raises before it reaches the program (which takes whole-window slots
    only)."""
    act = np.asarray(active, np.float32)
    if act.size != S:
        raise ValueError(f"active must be [{S}] (one 0/1 per slot), got "
                         f"shape {act.shape}")
    act = act.reshape(S)
    if not np.isin(act, (0.0, 1.0)).all():
        raise ValueError(f"active must hold 0 or 1 per slot, got {act}")
    return act


class ExportedCascade:
    r"""Runtime wrapper over a loaded artifact directory.

    Needs torch and this package only — no checkpoint, stats or SMPL file
    (all baked into the program). Thread the returned states back in; pass
    ``active`` [S] 0/1 to mask idle serving slots (their state is
    untouched, their output slice is undefined)."""

    def __init__(self, directory: str, device="cuda"):
        with open(os.path.join(directory, _MANIFEST)) as f:
            self.manifest = json.load(f)
        # real exceptions, not asserts: these validate external files
        if self.manifest.get("format_version") != _FORMAT_VERSION \
                or self.manifest.get("format") != _FORMAT:
            raise ValueError(
                f"unsupported artifact format "
                f"{self.manifest.get('format')!r} "
                f"{self.manifest.get('format_version')} (this runtime "
                f"reads {_FORMAT!r} {_FORMAT_VERSION}; a3gc_tpu's "
                "StableHLO artifacts load with a3gc_tpu.export)")
        with open(os.path.join(directory, _STEP), "rb") as f:
            blob = f.read()
        want = self.manifest.get("sha256", {}).get(_STEP)
        got = hashlib.sha256(blob).hexdigest()
        if want is not None and got != want:
            raise ValueError(
                f"artifact integrity check failed for {_STEP}: sha256 "
                f"{got} != manifest {want} (truncated or corrupted "
                "artifact?)")
        self.device = resolve_device(device)
        # the program calls the kernels' ops: register them before the
        # program is deserialized
        import a3gc_tpu_torch.ops.library  # noqa: F401
        ep = torch.export.load(io.BytesIO(blob))
        if torch.device(self.manifest["device"]) != self.device:
            from torch.export.passes import move_to_device_pass
            ep = move_to_device_pass(ep, self.device)
        self._program = ep.module()
        self.window = self.manifest["window"]
        self.streams = self.manifest["streams"]
        self.state_spec = self.manifest["states"]

    def zero_states(self):
        return _map_spec(lambda s: torch.zeros(
            s["shape"], dtype=torch.float32, device=self.device),
            self.state_spec)

    def zero_slot(self, states, stream: int):
        r"""``states`` with slot ``stream`` zeroed along each leaf's slot
        axis (from the manifest)."""
        def zero(spec, t):
            t = t.clone()
            t.select(spec["slot_axis"], stream).zero_()
            return t
        return _map_spec(zero, self.state_spec, states)

    def step(self, ori, acc, states, active=None):
        r"""ori [S, W, 54], acc [S, W, 18] → (pose [S, W, 24, 3, 3],
        states), tensors on the artifact's device."""
        S, W = self.streams, self.window
        ori = torch.as_tensor(ori, dtype=torch.float32,
                              device=self.device).reshape(S, W, 54)
        acc = torch.as_tensor(acc, dtype=torch.float32,
                              device=self.device).reshape(S, W, 18)
        act = (np.ones(S, np.float32) if active is None
               else _check_active(active, S))
        with torch.no_grad():
            return self._program(ori, acc, states,
                                 torch.as_tensor(act, device=self.device))


def load_exported(directory: str, streams: Optional[int] = None,
                  window: Optional[int] = None,
                  device="cuda") -> ExportedCascade:
    r"""Load a single-geometry artifact OR a bundle onto ``device`` (the
    card unless the caller asks for the CPU; no card raises). For a
    bundle, ``streams``/``window`` pick the geometry (first entry when
    omitted); for a plain artifact a non-matching request raises."""
    if os.path.exists(os.path.join(directory, _BUNDLE)):
        return ExportedBundle(directory, device).select(streams, window)
    art = ExportedCascade(directory, device)
    if ((streams is not None and art.streams != streams)
            or (window is not None and art.window != window)):
        raise KeyError(
            f"artifact has geometry (streams={art.streams}, "
            f"window={art.window}), not (streams={streams}, "
            f"window={window}); re-export or use a bundle")
    return art


class ArtifactSession:
    r"""The :class:`~a3gc_tpu_torch.eval.streaming.StreamingCascade`
    interface (``step``/``reset``/``flush``) over a loaded artifact. It
    keeps the carried state in ``_states`` and names its ``device``, as the
    live sessions do, so that the HTTP server (``cli serve --artifact
    DIR``) serves it and carries it across an exec-recycle."""

    def __init__(self, artifact: ExportedCascade):
        self.art = artifact
        self.window = artifact.window
        self.streams = artifact.streams
        self.device = artifact.device
        # nothing writes a state in place (the ops mutate no input), so
        # the zero nest is re-bound on every full reset
        self._zero_states = artifact.zero_states()
        self._states = self._zero_states

    def reset(self, stream: Optional[int] = None):
        r"""Clear the carried state; ``stream=i`` zeroes slot i along the
        slot axis the manifest records for each state leaf."""
        if stream is None:
            self._states = self._zero_states
        else:
            self._states = self.art.zero_slot(self._states, stream)

    def step(self, ori, acc, active=None) -> np.ndarray:
        pose, states = self.art.step(ori, acc, self._states, active)
        pose = _to_host(pose)           # fences; commit only after
        self._states = states
        return pose if self.streams > 1 else pose[0]

    def flush(self, stream: Optional[int] = None):
        r"""Plain windows buffer nothing: None (a list of None for all
        slots of a multi-stream session)."""
        return None if (self.streams == 1 or stream is not None) \
            else [None] * self.streams


def lookahead_geometries(streams: Sequence[int], window: int,
                         lookahead: int, history: int = 0):
    r"""The (streams, window) set a lookahead-K / history-P deployment
    bundle needs: for each stream count, programs at windows {W, 2W, ...,
    (P+K+1)·W} — the W program advances state (and flushes 1-window
    tails), the (P+K+1)·W program runs steady-state buffered emissions, and
    the f·W programs between run warm-up emissions and flush partial
    tails. ``cli export --lookahead K --history P`` expands the geometry
    list with this."""
    return [(s, f * window) for s in streams
            for f in range(1, lookahead + history + 2)]


class ArtifactLookaheadSession:
    r"""Buffered-context (lookahead-K / history-P) serving from a bundle —
    the artifact counterpart of ``StreamingCascade(lookahead=K,
    history=P)``, with its ``step``/``flush``/``reset`` contract.

    Each slot buffers its last ≤ P+K+1 windows. Once it holds K+1, the
    window K-from-newest is computed by the fill·W program over the whole
    buffer from the carried state (the returned state is dropped: a
    read-only pass); at capacity the W program then advances the carried
    state through the oldest window alone. The grouped emission is the
    live session's own (:meth:`StreamingCascade.emit_buffered`). ``flush``
    drains each slot's un-emitted tail as one continuous chunk via the
    fill·W program, grouping slots by fill count.

    Needs the bundle geometries of :func:`lookahead_geometries`; a missing
    window raises naming the re-export command."""

    def __init__(self, bundle: ExportedBundle,
                 streams: Optional[int] = None,
                 window: Optional[int] = None, lookahead: int = 1,
                 history: int = 0):
        if lookahead < 1 and history < 1:
            raise ValueError("lookahead or history must be >= 1 (use "
                             "ArtifactSession for plain windowing)")
        base = bundle.select(streams, window)
        S, W, K, P = base.streams, base.window, lookahead, history
        self.streams, self.window = S, W
        self.lookahead, self.history = K, P
        self.device = base.device
        self._base = base
        self._mods, missing = {}, []
        for f in range(1, K + P + 2):
            try:
                self._mods[f] = bundle.select(S, f * W)
            except KeyError:
                missing.append((S, f * W))
        if missing:
            raise KeyError(
                f"lookahead={K} history={P} needs bundle geometries "
                f"{missing} — re-export with `cli export --streams {S} "
                f"--window {W} --lookahead {K} --history {P}`")
        self._zero_states = base.zero_states()
        self._states = self._zero_states
        self._buffers = [collections.deque() for _ in range(S)]

    def reset(self, stream: Optional[int] = None):
        if stream is None:
            self._states = self._zero_states
            for b in self._buffers:
                b.clear()
        else:
            self._states = self._base.zero_slot(self._states, stream)
            self._buffers[stream].clear()

    def step(self, ori, acc, active=None):
        r"""The contract of ``StreamingCascade.step`` with lookahead /
        history: streams=1 returns the (possibly lagged) pose (None while
        warming up); S > 1 returns ``(pose [S, W, ...] | None, emitted [S]
        bool)``."""
        S, W = self.streams, self.window
        K, P = self.lookahead, self.history
        ori = np.asarray(ori, np.float32).reshape(S, -1, 54)
        acc = np.asarray(acc, np.float32).reshape(S, -1, 18)
        if ori.shape[1] != W:
            raise ValueError(
                f"window size {ori.shape[1]} != configured {W}")
        act = (np.ones(S, bool) if active is None
               else _check_active(active, S).astype(bool))
        appended = [i for i in range(S) if act[i]]
        for i in appended:
            # copies: the buffer must survive the caller reusing arrays
            self._buffers[i].append((ori[i].copy(), acc[i].copy()))
        states = self._states           # state at start of oldest window

        def emission_pass(f, em, ctx):
            # read-only on the state: the returned state is dropped
            return self._mods[f].step(ctx[0], ctx[1], states, em)[0]

        def advance_pass(advf, adv_ctx):
            # at-capacity slots' carried state moves through their oldest
            # window; emit_buffered's emission fetches already fenced
            self._states = self._mods[1].step(adv_ctx[0], adv_ctx[1],
                                              states, advf)[1]

        pose, emitted = StreamingCascade.emit_buffered(
            self._buffers, act, W, K, P, appended, emission_pass,
            advance_pass)
        if S == 1:
            return pose[0] if emitted[0] else None
        return pose, emitted

    def flush(self, stream: Optional[int] = None):
        r"""Drain buffered tails as continuous chunks (the live session's
        flush semantics): slot i's whole f·W-frame buffer runs as ONE pass
        from the carried state via the f·W program, its un-emitted tail
        (the newest ≤ K windows) returned; slots are grouped by fill count
        and flushed group by group with activity masks (disjoint groups —
        the other slots carried)."""
        S, W, K = self.streams, self.window, self.lookahead
        sel = [stream] if stream is not None else list(range(S))
        fills = [len(self._buffers[i]) if i in sel else 0
                 for i in range(S)]
        if not any(fills):
            return None if (S == 1 or stream is not None) else [None] * S
        tails = [None] * S
        for f in sorted({x for x in fills if x}):
            group = [i for i in range(S) if fills[i] == f]
            o = np.zeros((S, f * W, 54), np.float32)
            a = np.zeros((S, f * W, 18), np.float32)
            for i in group:
                o[i] = np.concatenate([x for x, _ in self._buffers[i]])
                a[i] = np.concatenate([y for _, y in self._buffers[i]])
            act = np.zeros(S, np.float32)
            act[group] = 1.0
            full, states = self._mods[f].step(o, a, self._states, act)
            full = _to_host(full)       # fetch before committing state
            self._states = states
            u = f if f <= K else K      # un-emitted tail windows
            for i in group:     # buffers drop only after the pass landed
                self._buffers[i].clear()
                tails[i] = full[i, (f - u) * W:] if u else None
        if stream is not None:
            return tails[stream]
        return tails[0] if S == 1 else tails
