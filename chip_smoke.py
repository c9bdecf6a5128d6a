#!/usr/bin/env python3
r"""Smoke run of the PyTorch/CUDA port (``a3gc_tpu_torch``) on one NVIDIA
card: builds the Hopper kernels from this checkout, holds each against its
plain PyTorch version, drives the serving paths through the entry points a
user calls, and times them.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device       — the card (nvidia-smi name and power limit); the three
                    kernel libraries (gcn_lstm, ggru, lstm) built by three
                    nvcc processes at once, with their ptxas reports;
  2. kernel       — ``gcn_lstm.cu`` against ``bi_gcn_lstm_reference`` at
                    the three stage widths of the A3GC cascade (clusters of
                    8 / 4 / 4), a3gc and aagc cells, S = 1, 3, 8 and 12
                    streams, T = 60, per-stream n_valid;
     kernel_ggru  — ``ggru.cu`` against ``bi_ggru_reference``, the same
                    widths, F ∈ {H, 2H}, the same streams and n_valid, each
                    with its launch plan and the clusters the card holds
                    at once;
     kernel_lstm  — ``lstm.cu`` against ``bi_lstm_reference`` at H = 256,
                    64, 128, 512 (cooperative groups of 16 and 32, clusters
                    of 4 and 8), F ∈ {H, 2H} and the nets' input widths,
                    S = 1, 3, 8 and 12;
     kernel_lstm_uni — ``lstm.cu`` at one direction (D = 1, the
                    unidirectional DIP layer) against the same plain
                    version, H = 512, 256, 64, 128, S = 1, 3, 8, 12,
                    T = 60 and 120, ragged n_valid;
  3. serving      — ``StreamingCascade`` at full width (8 streams, 60-frame
                    windows, shipped normalization stats, random weights
                    from torch.Generator seed 0) for 5 windows with a
                    per-slot reset and an idle slot: launch counts,
                    finiteness, one window against the plain path;
                    ms/window. The A3GC cascade (hidden 256/64/128);
     serving_ggru — the G-GRU cascade (hidden 256/64/128);
     serving_tp   — the TransPose cascade of dense biLSTMs (hidden
                    256/64/128);
     serving_dip  — ``DipStreamingSession``, the DIP net (hidden 512);
     serving_dip_uni — the same over the unidirectional DIP net, then its
                    K = 1 buffered session as ``buffered`` drives one
                    (``buffered_dip_uni``);
     kernel_long  — the three kernels at the shapes of the buffered
                    sessions: T = 180 and 120, S = 8 and 1, n_valid of
                    whole windows, and no kernel writes its initial state;
     buffered     — ``StreamingCascade(lookahead=1, history=1)``, A3GC, for
                    6 ticks with an idle slot and a reset: launches per
                    tick, ``emitted``, poses against the plain path,
                    ``fused`` against the two-pass path, ``flush``,
                    ``run_windows`` and ``step_async`` against a ``step``
                    loop; ms per steady tick;
     buffered_dip — the same for ``DipStreamingSession(lookahead=1)``;
     http         — an in-process ``PoseServer`` (A3GC, K = P = 1) on the
                    card, 8 ``PoseClient`` threads over HTTP in binary mode
                    streaming 12 windows each, one releasing and another
                    acquiring midway: every client's poses against a
                    single-slot session, a retried seq answered from the
                    cache with no launch, JSON against binary, /v1/stats;
                    the round trip as the clients see it;
     http_dip     — the same over the DIP session on plain windows;
     cli_serve    — ``python -m a3gc_tpu_torch.cli serve --quality
                    balanced`` as a subprocess, two clients, a
                    state-preserving exec-recycle under them: the poses
                    after it against an uninterrupted session, the pause;
     checkpoints  — every family (a3gc, aagc, agc, ggru, tp, dip, dip uni)
                    written by the port's exporter as a reference ``.tar``
                    and as a checkpoint directory, read back onto the card:
                    params, an S = 8 window's poses and states bit-equal;
     cli_serve_checkpoints — ``cli serve --torch_checkpoints`` (three A3GC
                    stage ``.tar``s, K = P = 1), ``--path`` (a directory of
                    two epochs written by ``cli convert-checkpoint``,
                    ``--mid1/2`` pins) and ``--model dip --hu1 512`` as
                    three subprocesses started at once, two clients each,
                    against in-process sessions on the same params; then a
                    newer epoch and ``POST /v1/reload``; cold starts and
                    the reload's time (their launches are the
                    subprocesses', not counted here);
     export       — deployment artifacts (``a3gc_tpu_torch.export``) of
                    every family at full width (S = 8, W = 60: A3GC, G-GRU,
                    TransPose, DIP bi and uni) exported on the card, then
                    loaded and stepped by a fresh process given only their
                    directories (5 windows with a reset and an idle slot):
                    launches per window counted there by the ops, poses and
                    final states against the live sessions, ms per window
                    of both, export seconds, bytes, load seconds;
     export_bundle — A3GC and G-GRU bundles of (1, 60), (8, 60), (8, 120),
                    (8, 180) through ``ArtifactLookaheadSession(lookahead=1,
                    history=1)`` for 6 ticks with an idle slot and a reset
                    plus ``flush``, and the S = 1 geometry through
                    ``ArtifactSession``, against live sessions; ms per
                    steady tick of both, in turns;
     cli_export   — ``cli export`` of an A3GC K = P = 1 bundle (S = 1 and
                    8), ``cli serve --artifact`` on it as ``cli_serve`` does
                    (two clients, a recycle; ``cli_serve_artifact``), ``cli
                    stream --artifact`` on a synthetic test npz against an
                    in-process session; cold start, recycle pause;
  4. offline      — ``cascade_apply`` at batch 1, T = 300: launch counts
                    (6, the S = 1 contract of the kernel), timed, and
                    against the plain path; offline_tp the same for the
                    TransPose cascade, offline_ggru for the G-GRU cascade;
     evaluate     — ``CascadeEvaluator`` at A3GC full width on a synthetic
                    test set (16 sequences, lengths from seed 0 in
                    240-2400 frames, shipped stats, a synthetic SMPL pickle
                    of 6890 vertices; stage 3's output layer biased to
                    emit near rotations): per sequence (S = 1), batched at
                    8 and 16 streams, streaming (W = 60, K = P = 1, 8
                    slots); per protocol frames/s, the cascade / metrics
                    split, launches, peak memory, the device's busy share;
                    batched against per-sequence and, on two sequences cut
                    to 300 frames, the kernel path against the plain path,
                    within 1e-3 on the [5, 2] table;
     evaluate_families — the G-GRU and TransPose cascades batched at S = 8
                    on four of the sequences, against per-sequence;
     evaluate_dip — ``DipEvaluator`` (hidden 512) offline and streaming
                    (K = 1, 8 slots), against the plain path;
     kernel_eval  — each kernel against its plain version at S = 1,
                    T = 2048 and S = 8, T = 1024 with ragged n_valid, then
                    timed at S = 1, T = 2048 and S = 16, T = 1024 (``lstm``
                    beside cuDNN);
     cli_evaluate — ``python -m a3gc_tpu_torch.cli evaluate --model a3gc
                    --norm --smpl <pickle> --batch_streams 8 --datasets
                    <npz>`` as a subprocess on the evaluate phase's params
                    as ``.tar`` checkpoints; its report against the
                    in-process table;
  5. kernels      — the ``{"kernels": [...]}`` line: launches on each
                    kernel's serving and evaluation paths, max |d| of the
                    kernel phases, and per
                    layer shape of those paths (S = 8 and 1, T = 60; S = 8
                    at the buffered ticks' T = 180 and 120, ``gcn_lstm``
                    and ``ggru``) the
                    launch plan (split, cluster or cooperative, CTAs,
                    shared memory, groups the card holds at once), the
                    wrapper's, the kernel's and the plain version's times
                    (CUDA events) beside their bounds, and for ``lstm``
                    cuDNN's ``torch.nn.LSTM`` on the same weights, timed in
                    turns with the kernel (kernel, cuDNN, cuDNN, kernel).
A line of the seconds each phase took precedes the kernels line. The line
before the last is the card's name and power limit; the last is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that line; so does a machine without CUDA or a directory without the
package. Imports nothing of JAX or of the JAX package.
"""

import importlib
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores, 700 W
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3
KERNEL_TOL = 1e-5           # fp32, sums reordered over a 60-step recurrence
                            # (an H100 showed at most 2.1e-7 for gcn_lstm)
PATH_TOL = 1e-3             # poses after three stages and IK
# stage widths: (H, units in, units out, rotsize) of the graph cascades,
# (H, n_input, n_output, rotsize) of the TransPose cascade and of DIP
STAGES = ((256, 12, 3, 3), (64, 15, 3, 3), (128, 15, 9, 9))
TP_STAGES = ((256, 72, 15, 3), (64, 87, 69, 3), (128, 141, 135, 9))
DIP = (512, 60, 135, 9)
S_SERVE, WINDOW, N_NODES = 8, 60, 15
LIBRARIES = ("gcn_lstm", "ggru", "lstm")
# whole-window valid lengths of a flush over a (P+K+1)·W = 180-frame context
LONG_N_VALID = (180, 120, 60, 0, 180, 180, 60, 120)
# launch-counted paths: the eight of the plain windows and the offline
# calls, the five buffered and HTTP ones, the checkpoint round trips, the
# three evaluation phases and the two of the deployment artifacts (export:
# counted by the fresh process that steps them)
N_PATHS = 19
# evaluation: a synthetic test set of EVAL_N sequences, lengths from seed 0
# in [EVAL_MIN_T, EVAL_MAX_T], a synthetic SMPL body of SMPL's vertex count
EVAL_N, EVAL_MIN_T, EVAL_MAX_T, EVAL_VERTICES = 16, 240, 2400, 6890
EVAL_STREAMS = (8, 16)      # --batch_streams of the batched protocol
EVAL_SHORT_T = 300          # the sequences held against the plain path
TABLE_TOL = 1e-3            # the [5, 2] table: deg, cm, km/s^3, 100 m/s^3
REPORT_TOL = 0.005 + TABLE_TOL      # the text report rounds to 2 decimals
# (S, T) of the kernels held against their plain versions at evaluation
# lengths (ragged n_valid), and of the timed rows (n_valid = T)
EVAL_KERNEL_SHAPES = ((1, 2048), (8, 1024))
EVAL_TIMED_SHAPES = ((1, 2048), (16, 1024))

# the export phase's fresh process: given the artifacts' parent directory
# (holding in.npz: 5 windows of ori / acc) and the family names, load each
# artifact onto the card, step it through the serving script of
# ``Smoke.serve`` (a reset of slot 3 after window 1, slot 5 idle in window
# 3) counting the ops' launches per window, write its poses and final
# states to <family>_out.npz, time 30 more windows; one JSON line.
EXPORT_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
cuda_init_s = time.perf_counter() - t0
from a3gc_tpu_torch.export import ArtifactSession, load_exported
from a3gc_tpu_torch.ops import gcn_lstm, ggru, lstm
wrappers = {"gcn_lstm": gcn_lstm.bi_gcn_lstm, "ggru": ggru.bi_ggru,
            "lstm": lstm.bi_lstm}
root = sys.argv[1]
data = np.load(os.path.join(root, "in.npz"))
wins = list(zip(data["ori"], data["acc"]))
S = wins[0][0].shape[0]
idle = np.ones(S, np.float32)
idle[5] = 0.0
out = {}
for name in sys.argv[2:]:
    t0 = time.perf_counter()
    sess = ArtifactSession(load_exported(os.path.join(root, name)))
    load_s = time.perf_counter() - t0
    for w in wrappers.values():
        w.launches = 0
    per_window, poses = [], []
    for i, (o, a) in enumerate(wins):
        before = sum(w.launches for w in wrappers.values())
        poses.append(sess.step(o, a, active=idle if i == 3 else None))
        per_window.append(sum(w.launches for w in wrappers.values())
                          - before)
        if i == 1:
            sess.reset(stream=3)
    launches = {k: w.launches for k, w in wrappers.items()}
    states = []

    def flat(t):
        if isinstance(t, (tuple, list)):
            for x in t:
                flat(x)
        else:
            states.append(t.cpu().numpy())
    flat(sess._states)
    np.savez(os.path.join(root, name + "_out.npz"), pose=np.stack(poses),
             **{f"state{i}": a for i, a in enumerate(states)})
    times = []
    for k in range(33):
        t0 = time.perf_counter()
        sess.step(*wins[k % len(wins)])
        times.append((time.perf_counter() - t0) * 1e3)
    out[name] = {"load_s": load_s, "launches_per_window": per_window,
                 "launches": launches,
                 "ms_median": float(np.median(times[3:])),
                 "ms_p90": float(np.percentile(times[3:], 90))}
print(json.dumps({"cuda_init_s": cuda_init_s, "families": out,
                  "banned": sorted(m for m in sys.modules
                                   if m.split(".")[0] in (
                                       "jax", "jaxlib", "flax",
                                       "a3gc_tpu"))}))
"""


def whole_windows(S, T):
    """Per-stream valid lengths of whole windows, as a buffered flush gives
    them; one stream: one window short of the context."""
    return [min(v, T) for v in LONG_N_VALID[:S]] if S > 1 else [T - WINDOW]


def ragged(S, T=WINDOW):
    """Per-stream valid lengths with full, short and idle streams."""
    return [T, T, 37, T, 0, T, T, T, 11, T, 59, T][:S]


KERNEL_S = (1, 3, 8, 12)    # streams of the kernel phases: one and two
                            # stream blocks, a part-filled block


def ragged_long(S, T):
    """Per-stream valid lengths of an evaluation group: full, short and
    empty streams; one stream: a little short of T."""
    return [T, T - 24, T // 2, T, 0, 3 * T // 4, T, min(37, T)][:S] \
        if S > 1 else [T - 48]


def eval_sequences(seed=0):
    """The synthetic test set in the schema of ``load_test_sequences``:
    EVAL_N sequences with lengths from ``seed`` in [EVAL_MIN_T, EVAL_MAX_T],
    random rotations in ori [T, 54] and pose [T, 135], acc [T, 18]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(EVAL_MIN_T, EVAL_MAX_T + 1, EVAL_N)
    return [{"ori": random_rotations(rng, (T, 6)).reshape(T, 54),
             "acc": rng.normal(scale=0.5, size=(T, 18)).astype(np.float32),
             "pose": random_rotations(rng, (T, 15)).reshape(T, 135)}
            for T in lengths]


def near_rotation_outputs(net):
    """Scale the output layer of a net that emits 3x3 rotations by 0.1 and
    bias it by the identity, so that its random outputs lie near rotations
    as a trained net's do. The raw 9D outputs of random weights are far
    from rotations, and the metric table's global-angle rows compose them
    down the kinematic tree: there a 1e-7 change of the poses moves the
    SIP error by 0.1 deg, and no two paths could be held to 1e-3."""
    import torch
    out = net.linear_out if hasattr(net, "linear_out") else net.linear2
    with torch.no_grad():
        out.kernel.mul_(0.1)
        eye = torch.eye(3, dtype=out.bias.dtype, device=out.bias.device)
        out.bias.copy_(eye.flatten().repeat(out.bias.numel() // 9))
    return net


def n_groups_sizes(lengths):
    """Sequences per length bucket of the batched protocol."""
    from a3gc_tpu_torch.eval import bucket_length
    buckets = {}
    for T in lengths:
        buckets[bucket_length(T)] = buckets.get(bucket_length(T), 0) + 1
    return list(buckets.values())


def n_groups(lengths, S):
    """Calls of the batched protocol: groups of <= S per length bucket."""
    return sum(-(-n // S) for n in n_groups_sizes(lengths))


def report_table(path):
    """The [5, 2] table of the last report in an evaluation report file."""
    with open(path) as f:
        lines = f.read().splitlines()[-5:]
    return [[float(line.split(": ")[1].split(" (+/- ")[0]),
             float(line.split("(+/- ")[1].rstrip(")"))] for line in lines]


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() in ms over reps calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_work(S, T, F, H, attention, hoist):
    """(FLOP, bytes) one bidirectional graph-LSTM layer call needs: each
    input read once, each output written once. hoist=True counts the
    wrapper's whole function (x → y, state), hoist=False the kernel alone
    (u → y, state)."""
    N = N_NODES
    rec = 2 * N * H * 4 * H + 2 * 4 * N * N * H
    if attention:
        rec += 2 * 2 * N * H * H + 2 * H * H + 2 * N * H
    flop = 2 * T * S * rec
    params = 2 * (4 * H * H + 4 * N * N + 4 * H)
    if attention:
        params += 2 * (3 * H * H + 2 * H + N)
    state = 2 * 2 * S * N * H
    if hoist:
        flop += 2 * 2 * S * T * N * F * 4 * H
        params += 2 * F * 4 * H
        read = S * T * N * F + params + state
    else:
        read = 2 * S * T * N * 4 * H + params + state
    write = S * T * N * 2 * H + state
    return flop, 4 * (read + write) + 4 * S


def gcn_layer_work(S, T, F, H, hoist):
    """layer_work of the a3gc cell, the one the serving path runs."""
    return layer_work(S, T, F, H, True, hoist)


def ggru_layer_work(S, T, F, H, hoist):
    """(FLOP, bytes) of one bidirectional G-GRU layer call, as layer_work.
    The least the function needs: adj·(h·G)·W_hid = (adj·h)·(G·W_hid), so
    6·N·H² + 2·N²·H FLOP per (stream, direction, frame) in the scan and one
    G·W_hid (2·H·H·3H) per direction."""
    N = N_NODES
    flop = 2 * T * S * (6 * N * H * H + 2 * N * N * H) + 2 * 2 * H * H * 3 * H
    params = 2 * (H * H + N * N + 3 * H * H)
    state = 2 * S * N * H
    if hoist:
        flop += 2 * 2 * S * T * N * F * 3 * H
        params += 2 * (F * 3 * H + 3 * H)
        read = S * T * N * F + params + state
    else:
        read = 2 * S * T * N * 3 * H + params + state
    write = S * T * N * 2 * H + state
    return flop, 4 * (read + write) + 4 * S


def lstm_layer_work(S, T, F, H, hoist, D=2):
    """(FLOP, bytes) of one dense LSTM layer call of D directions (2: the
    biLSTM, 1: the unidirectional DIP layer), as layer_work: 8·H² FLOP per
    (stream, direction, frame) in the scan."""
    flop = D * T * S * 8 * H * H
    params = D * 4 * H * H
    state = D * 2 * S * H
    if hoist:
        flop += D * 2 * S * T * F * 4 * H
        params += D * (F * 4 * H + 2 * 4 * H)
        read = S * T * F + params + state
    else:
        read = D * S * T * 4 * H + params + state
    write = S * T * D * H + state
    return flop, 4 * (read + write) + 4 * S


def uni_lstm_layer_work(S, T, F, H, hoist):
    """lstm_layer_work of one direction."""
    return lstm_layer_work(S, T, F, H, hoist, D=1)


def bound(flop, nbytes):
    t_ops = flop / PEAK_FP32_FLOPS * 1e3
    t_mem = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def random_rotations(rng, shape):
    import numpy as np
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=-1).astype(np.float32)


def leaves(tree):
    """The tensors of a nest of tuples/lists, in order."""
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in leaves(sub)]
    return [tree]


def clone_tree(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(clone_tree(t) for t in tree)
    return tree.clone()


def tree_err(a, b):
    """max |a - b| over two nests of tensors of one structure."""
    return max(float((x - y).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def percentile(values, q):
    import numpy as np
    return float(np.percentile(values, q))


class Smoke:
    def __init__(self):
        import torch
        from a3gc_tpu_torch.ops import gcn_lstm, ggru, lstm
        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.wrappers = {"gcn_lstm": gcn_lstm.bi_gcn_lstm,
                         "ggru": ggru.bi_ggru, "lstm": lstm.bi_lstm}
        self.failures = []
        self.max_err = {}
        self.shapes = {name: [] for name in LIBRARIES}
        self.launches = {}          # path -> {kernel: launches}
        self._eval = None           # the evaluation phases' data

    def check(self, ok, what):
        if not ok:
            self.failures.append(what)

    def zero_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    def counts(self):
        return {name: w.launches for name, w in self.wrappers.items()}

    # -- 1 ---------------------------------------------------------------
    def phase_device(self):
        from concurrent.futures import ThreadPoolExecutor
        from a3gc_tpu_torch.ops._build import load_library
        torch = self.torch
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(LIBRARIES)) as pool:
            built = dict(zip(LIBRARIES, pool.map(load_library, LIBRARIES)))
        wall = time.perf_counter() - t0
        emit({"phase": "device", "nvidia_smi": nvidia_smi(),
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0],
              "build_s": {n: round(b.build_seconds, 3)
                          for n, b in built.items()},
              "load_s": round(wall, 3),
              "ptxas": {n: [l.strip() for l in b.log.splitlines()
                            if "registers" in l or "spill" in l
                            or "smem" in l]
                        for n, b in built.items()}})

    # -- helpers -----------------------------------------------------------
    def cell(self, gen, cell, F, H):
        from a3gc_tpu_torch.data import load_adjacency_template
        from a3gc_tpu_torch.models import cells as C
        from a3gc_tpu_torch.models import layers as L
        torch = self.torch
        nira = load_adjacency_template()

        def one():
            if cell == "ggru":       # its init draws nonzero biases
                return C.init_ggru_cell(gen, F, H, nira)
            p = C.init_gcn_lstm_cell(gen, F, H, nira,
                                     attention=cell == "a3gc")
            with torch.no_grad():      # nonzero biases exercise every term
                biases = [p.bias]
                if p.attention is not None:
                    biases += [p.attention.bs, p.attention.bu]
                for t in biases:
                    t.add_(0.1 * torch.randn(t.shape, generator=gen))
            return p

        return L.stack_directions(one(), one()).to(self.dev)

    def lstm_layer(self, gen, F, H, D=2):
        from a3gc_tpu_torch.models import layers as L
        from a3gc_tpu_torch.models import nets as N
        torch = self.torch
        b = 1.0 / H ** 0.5

        def u(*shape):
            return torch.rand(shape, generator=gen) * (2 * b) - b

        def one():
            return N.LSTMLayerParams(w_ih=u(F, 4 * H), w_hh=u(H, 4 * H),
                                     b_ih=u(4 * H), b_hh=u(4 * H))

        layer = L.stack_directions(one(), one()) if D == 2 else one()
        return layer.to(self.dev)

    def layer_inputs(self, gen, S, T, F, H, n_valid, nodes=True, n_state=2,
                     D=2):
        torch = self.torch
        lead = (S, T, N_NODES) if nodes else (S, T)
        st_shape = (2, S, N_NODES, H) if nodes else (2,) * (D - 1) + (S, H)
        x = torch.randn(lead + (F,), generator=gen).to(self.dev)
        st = tuple((0.5 * torch.randn(st_shape, generator=gen)).to(self.dev)
                   for _ in range(n_state))
        nv = torch.tensor(n_valid, dtype=torch.int32, device=self.dev)
        return x, (st if n_state > 1 else st[0]), nv

    # -- 2 ---------------------------------------------------------------
    def compare_layer(self, name, label, kernel_fn, plain_fn, args):
        torch = self.torch
        state_before = clone_tree(args[2])
        with torch.no_grad():
            out = kernel_fn(*args)
            torch.cuda.synchronize()
            ref = plain_fn(*args)
        # the buffered sessions start two passes from one carried state
        self.check(all(torch.equal(a, b) for a, b in zip(
            leaves(args[2]), leaves(state_before))),
            f"{name} {label}: the launch wrote its initial state")
        errs = [float((a - b).abs().max())
                for a, b in zip(leaves(out), leaves(ref))]
        err = max(errs)
        self.max_err[name] = max(self.max_err.get(name, 0.0), err)
        ok = err <= KERNEL_TOL and bool(torch.isfinite(leaves(out)[0]).all())
        self.check(ok, f"{name} {label}: max|d|={err:.3e}")
        return errs, ok

    def phase_kernel(self):
        from a3gc_tpu_torch.ops import gcn_lstm as G
        torch = self.torch
        gen = torch.Generator().manual_seed(1)
        T = WINDOW
        rows = []
        for H, _, _, _ in STAGES:
            for F in (H, 2 * H):
                for cell in ("a3gc", "aagc"):
                    p = self.cell(gen, cell, F, H)
                    for S in KERNEL_S:
                        x, st, nvt = self.layer_inputs(gen, S, T, F, H,
                                                       ragged(S))
                        errs, ok = self.compare_layer(
                            "gcn_lstm", f"H={H} F={F} {cell} S={S}",
                            G.bi_gcn_lstm, G.bi_gcn_lstm_reference,
                            (p, x, st, nvt))
                        rows.append({"H": H, "F": F, "cell": cell, "S": S,
                                     "y": errs[0], "h": errs[1],
                                     "c": errs[2], "ok": ok})
        emit({"phase": "kernel", "tol": KERNEL_TOL, "max_abs_err":
              self.max_err["gcn_lstm"], "cases": rows})

    def phase_kernel_ggru(self):
        from a3gc_tpu_torch.ops import ggru as GG
        torch = self.torch
        gen = torch.Generator().manual_seed(3)
        T = WINDOW
        rows = []
        for H, _, _, _ in STAGES:
            for F in (H, 2 * H):
                p = self.cell(gen, "ggru", F, H)
                for S in KERNEL_S:
                    x, h, nvt = self.layer_inputs(gen, S, T, F, H, ragged(S),
                                                  n_state=1)
                    errs, ok = self.compare_layer(
                        "ggru", f"H={H} F={F} S={S}", GG.bi_ggru,
                        GG.bi_ggru_reference, (p, x, h, nvt))
                    rows.append({"H": H, "F": F, "S": S, "y": errs[0],
                                 "h": errs[1], "ok": ok,
                                 "plan": self.plan_record("ggru", S, H)})
        emit({"phase": "kernel_ggru", "tol": KERNEL_TOL, "max_abs_err":
              self.max_err["ggru"], "cases": rows})

    def phase_kernel_lstm(self):
        from a3gc_tpu_torch.ops import lstm as LS
        torch = self.torch
        gen = torch.Generator().manual_seed(4)
        T = WINDOW
        rows = []
        widths = [(H, F) for H in (256, 64, 128, 512) for F in (H, 2 * H)]
        widths += [(256, TP_STAGES[0][1]), (512, DIP[1])]   # F = 72, 60
        for H, F in widths:
            p = self.lstm_layer(gen, F, H)
            for S in KERNEL_S:
                x, st, nvt = self.layer_inputs(gen, S, T, F, H, ragged(S),
                                               nodes=False)
                errs, ok = self.compare_layer(
                    "lstm", f"H={H} F={F} S={S}", LS.bi_lstm,
                    LS.bi_lstm_reference, (p, x, st, nvt))
                rows.append({"H": H, "F": F, "S": S, "y": errs[0],
                             "h": errs[1], "c": errs[2], "ok": ok})
        emit({"phase": "kernel_lstm", "tol": KERNEL_TOL, "max_abs_err":
              self.max_err["lstm"], "cases": rows})

    def phase_kernel_lstm_uni(self):
        """``lstm.cu`` at D = 1 (the unidirectional DIP net's layer: F = H
        in both layers) against its plain version at the DIP width and the
        TransPose widths, one and several stream blocks, a serving window
        and a K = 1 emission pass."""
        from a3gc_tpu_torch.ops import lstm as LS
        torch = self.torch
        gen = torch.Generator().manual_seed(7)
        rows, worst = [], 0.0
        for H in (512, 256, 64, 128):
            p = self.lstm_layer(gen, H, H, D=1)
            for T in (WINDOW, 2 * WINDOW):
                for S in KERNEL_S:
                    x, st, nvt = self.layer_inputs(gen, S, T, H, H,
                                                   ragged(S, T), nodes=False,
                                                   D=1)
                    errs, ok = self.compare_layer(
                        "lstm", f"uni H={H} S={S} T={T}", LS.bi_lstm,
                        LS.bi_lstm_reference, (p, x, st, nvt))
                    worst = max(worst, *errs)
                    rows.append({"H": H, "F": H, "S": S, "T": T,
                                 "y": errs[0], "h": errs[1], "c": errs[2],
                                 "ok": ok,
                                 "plan": self.plan_record("lstm", S, H, 1)})
        emit({"phase": "kernel_lstm_uni", "tol": KERNEL_TOL,
              "max_abs_err": worst, "cases": rows})

    # -- 3 ---------------------------------------------------------------
    def cascade(self, kind, backend):
        from a3gc_tpu_torch.models import nets as N
        from a3gc_tpu_torch.models.pipeline import (CascadeConfig,
                                                    PoseNetConfig)
        if kind == "tp":
            return CascadeConfig(*(
                PoseNetConfig(net=N.DIPConfig(
                    n_input=ni, n_output=no, n_hidden=H, backend=backend),
                    rotsize=rot)
                for H, ni, no, rot in TP_STAGES))
        return CascadeConfig(*(
            PoseNetConfig(net=N.GraphNetConfig(
                cell=kind, units_in=ui, units_out=uo, units_hidden=H,
                backend=backend), rotsize=rot)
            for H, ui, uo, rot in STAGES))

    def dip_cfg(self, backend, bidirectional=True):
        from a3gc_tpu_torch.models import nets as N
        from a3gc_tpu_torch.models.pipeline import PoseNetConfig
        H, ni, no, rot = DIP
        return PoseNetConfig(net=N.DIPConfig(
            n_input=ni, n_output=no, n_hidden=H, backend=backend,
            bidirectional=bidirectional), rotsize=rot)

    def params3(self, cfg):
        from a3gc_tpu_torch.data import load_adjacency_template
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        gen = self.torch.Generator().manual_seed(0)
        nira = load_adjacency_template()
        return tuple(init_pose_net(gen, c, nira).to(self.dev)
                     for c in cfg.stages)

    def serve(self, path, sess, step_for, kernel, per_window_launches,
              hidden):
        """Drive ``sess`` (the path's entry point) for 5 windows with a
        per-slot reset and an idle slot, counting every kernel's launches;
        then hold one window to the plain path from the same carried state
        and time 30 windows."""
        import numpy as np
        torch = self.torch
        S, W = S_SERVE, WINDOW
        rng = np.random.default_rng(0)

        def window():
            ori = random_rotations(rng, (S, W, 6)).reshape(S, W, 54)
            acc = rng.normal(scale=0.5, size=(S, W, 18)).astype(np.float32)
            return ori, acc

        per_window, finite = [], True
        idle = np.ones(S, np.float32)
        idle[5] = 0.0
        wrapper = self.wrappers[kernel]
        self.zero_counts()                            # the main path starts
        for w in range(5):
            before = wrapper.launches
            active = idle if w == 3 else None
            pose = sess.step(*window(), active=active)
            per_window.append(wrapper.launches - before)
            rows = np.ones(S, bool) if active is None else active > 0
            finite &= bool(np.isfinite(pose[rows]).all())
            self.check(pose.shape == (S, W, 24, 3, 3), f"{path} pose shape")
            if w == 1:
                sess.reset(stream=3)
        counts = self.counts()                        # the main path ended
        self.launches[path] = counts
        self.check(finite, f"{path} poses not finite")
        self.check(per_window == [per_window_launches] * 5,
                   f"{path} launches per window {per_window} != "
                   f"{per_window_launches}")
        self.check(all(n == 0 for k, n in counts.items() if k != kernel),
                   f"{path} launched other kernels: {counts}")

        # one more window on the kernel path and on the plain path, from
        # the same carried state
        ori, acc = (torch.as_tensor(a, device=self.dev) for a in window())
        act = torch.as_tensor(idle, device=self.dev)
        outs = {}
        with torch.no_grad():
            for backend in ("auto", "eager"):
                outs[backend] = step_for(backend)(
                    sess.params3, ori, acc, *clone_tree(sess._states), act)
        torch.cuda.synchronize()
        rows = torch.as_tensor(idle > 0, device=self.dev).repeat_interleave(W)
        pose_err = float((outs["auto"][0] - outs["eager"][0])[rows].abs()
                         .max())
        state_err = max(float((a - b).abs().max()) for a, b in zip(
            leaves(outs["auto"][1:]), leaves(outs["eager"][1:])))
        self.check(pose_err <= PATH_TOL,
                   f"{path} window vs plain path: {pose_err:.3e}")
        self.check(state_err <= PATH_TOL,
                   f"{path} state vs plain path: {state_err:.3e}")

        # timing: host clock around step(), which ends in the host copy
        for _ in range(3):
            sess.step(*window())
        inputs = [window() for _ in range(30)]
        torch.cuda.synchronize()
        times = []
        for ori_w, acc_w in inputs:
            t0 = time.perf_counter()
            sess.step(ori_w, acc_w)
            times.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(times))
        try:
            profile = self.profile_window(sess, inputs[:3])
        except Exception as e:     # a measurement aid, not a check
            profile = f"not measured: the profiler raised {e!r}"
        emit({"phase": path, "streams": S, "window": W, "hidden": hidden,
              "launches_per_window": per_window, "launches": counts,
              "finite": finite, "pose_max_abs_err_vs_plain": pose_err,
              "state_max_abs_err_vs_plain": state_err,
              "ms_per_window_median": med,
              "ms_per_window_p90": float(np.percentile(times, 90)),
              "frames_per_s": S * W / (med / 1e3), "timed_windows":
              len(times), "profile": profile, "card": nvidia_smi()})

    def serve_cascade(self, path, kind, kernel):
        from a3gc_tpu_torch.data import load_stats
        from a3gc_tpu_torch.eval.streaming import (StreamingCascade,
                                                   make_window_step)
        from a3gc_tpu_torch.smpl import ParametricModel
        cfg = self.cascade(kind, "auto")
        model = ParametricModel()
        sess = StreamingCascade(self.params3(cfg), cfg, model,
                                window=WINDOW, stats=load_stats(),
                                normalize=True, streams=S_SERVE,
                                device=self.dev)
        self.serve(path, sess,
                   lambda b: make_window_step(self.cascade(kind, b), model,
                                              sess.stats),
                   kernel, 6, [s[0] for s in
                               (TP_STAGES if kind == "tp" else STAGES)])

    def phase_serving(self):
        self.serve_cascade("serving", "a3gc", "gcn_lstm")

    def phase_serving_ggru(self):
        self.serve_cascade("serving_ggru", "ggru", "ggru")

    def phase_serving_tp(self):
        self.serve_cascade("serving_tp", "tp", "lstm")

    def serve_dip(self, path, bidirectional):
        from a3gc_tpu_torch.data import load_stats
        from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                                   make_dip_window_step)
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        from a3gc_tpu_torch.smpl import ParametricModel
        cfg = self.dip_cfg("auto", bidirectional)
        model = ParametricModel()
        params = init_pose_net(self.torch.Generator().manual_seed(0),
                               cfg).to(self.dev)
        sess = DipStreamingSession(params, cfg, model, window=WINDOW,
                                   stats=load_stats(), streams=S_SERVE,
                                   device=self.dev)
        self.serve(path, sess,
                   lambda b: make_dip_window_step(
                       self.dip_cfg(b, bidirectional), model, sess.stats),
                   "lstm", 2, [DIP[0]])

    def phase_serving_dip(self):
        self.serve_dip("serving_dip", True)

    def phase_serving_dip_uni(self):
        """The unidirectional DIP net: lstm.cu at D = 1, plain windows and
        K = 1."""
        self.serve_dip("serving_dip_uni", False)
        self.buffered("buffered_dip_uni", self.dip_sessions(1, 0, False),
                      "lstm", 1, 0, 2, [DIP[0]])

    def profile_window(self, sess, inputs):
        """Device time by kernel over a few serving windows, and the
        device's busy share of the wall time."""
        def run():
            for ori_w, acc_w in inputs:
                sess.step(ori_w, acc_w)
        wall_us, rows = self.profile_device(run)
        busy = sum(r[0] for r in rows)
        if busy == 0:
            return "not measured: the profiler recorded no device time"
        n = len(inputs)
        return {"windows": n, "wall_ms_per_window": wall_us / n / 1e3,
                "device_ms_per_window": busy / n / 1e3,
                "device_busy_share": busy / wall_us,
                "top": [{"kernel": k[:80], "ms_per_window": us / n / 1e3,
                         "calls_per_window": c / n}
                        for us, k, c in rows[:8]]}

    def profile_device(self, run):
        """``run()`` under torch.profiler: (wall µs, [(device µs, kernel,
        calls)] of the device-side kernel events, largest first)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        from torch.autograd import DeviceType
        rows = []
        for ev in prof.key_averages():
            # device-side kernel events only: an operator's own row repeats
            # the device time of the kernels it launched
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us, ev.key, ev.count))
        rows.sort(reverse=True)
        return wall_us, rows

    # -- 3b: the buffered sessions and the HTTP front end -----------------
    def phase_kernel_long(self):
        """Each kernel at the buffered ticks' lengths, at the widths of its
        serving paths, with n_valid of whole windows."""
        from a3gc_tpu_torch.ops import gcn_lstm as G
        from a3gc_tpu_torch.ops import ggru as GG
        from a3gc_tpu_torch.ops import lstm as LS
        torch = self.torch
        gen = torch.Generator().manual_seed(5)
        rows = []
        graph = [(H, F) for H, _, _, _ in STAGES for F in (H, 2 * H)]
        dense = [(H, F) for H in (256, 64, 128, 512) for F in (H, 2 * H)]
        cases = [("gcn_lstm", G.bi_gcn_lstm, G.bi_gcn_lstm_reference, graph,
                  lambda F, H: self.cell(gen, "a3gc", F, H), True, 2),
                 ("ggru", GG.bi_ggru, GG.bi_ggru_reference, graph,
                  lambda F, H: self.cell(gen, "ggru", F, H), True, 1),
                 ("lstm", LS.bi_lstm, LS.bi_lstm_reference, dense,
                  lambda F, H: self.lstm_layer(gen, F, H), False, 2)]
        for name, kernel_fn, plain_fn, widths, make, nodes, n_state in cases:
            for H, F in widths:
                p = make(F, H)
                for T in (180, 120):
                    for S in (S_SERVE, 1):
                        nv = whole_windows(S, T)
                        args = self.layer_inputs(gen, S, T, F, H, nv,
                                                 nodes=nodes, n_state=n_state)
                        errs, ok = self.compare_layer(
                            name, f"long H={H} F={F} S={S} T={T}",
                            kernel_fn, plain_fn, (p,) + args)
                        rows.append({"kernel": name, "H": H, "F": F, "S": S,
                                     "T": T, "n_valid": nv, "y": errs[0],
                                     "state": max(errs[1:]), "ok": ok})
        emit({"phase": "kernel_long", "tol": KERNEL_TOL,
              "max_abs_err": max(r["y"] for r in rows),
              "max_abs_err_state": max(r["state"] for r in rows),
              "n_cases": len(rows), "all_ok": all(r["ok"] for r in rows),
              "cases": [r for r in rows if not r["ok"]] or "all within tol"})

    def windows(self, rng, S):
        import numpy as np
        ori = random_rotations(rng, (S, WINDOW, 6)).reshape(S, WINDOW, 54)
        acc = rng.normal(scale=0.5, size=(S, WINDOW, 18)).astype(np.float32)
        return (ori, acc) if S > 1 else (ori[0], acc[0])

    def buffered(self, path, make, kernel, K, P, per_pass, hidden):
        """Drive ``make(backend, fused, S)``'s buffered session for 6 ticks
        with an idle slot and a reset beside the same session on the plain
        path and on the two-pass path; flush; the pipelined entry points at
        S = 1; then time steady ticks."""
        import numpy as np
        torch = self.torch
        S, W, cap = S_SERVE, WINDOW, P + K + 1
        rng = np.random.default_rng(2)
        sess = make("auto", True, S)
        plain = make("eager", True, S)
        twopass = make("auto", False, S)
        wrapper = self.wrappers[kernel]
        idle = np.ones(S, np.float32)
        idle[5] = 0.0
        fills = [0] * S
        per_tick, want_per_tick, pose_err, fused_err = [], [], 0.0, 0.0
        emitted_ok, finite = True, True
        self.zero_counts()                            # the main path starts
        for tick in range(6):
            ori, acc = self.windows(rng, S)
            active = idle if tick == 3 else None
            act = np.ones(S, bool) if active is None else active > 0
            before = wrapper.launches
            pose, emitted = sess.step(ori, acc, active=active)
            per_tick.append(wrapper.launches - before)
            # what the fill counts say: a slot emits from K+1 windows on,
            # one emission pass per distinct fill, the advance at capacity
            fills = [f + 1 if a else f for f, a in zip(fills, act)]
            want = np.array([a and f >= K + 1 for f, a in zip(fills, act)])
            groups = {f for f, e in zip(fills, want) if e}
            want_per_tick.append(per_pass * (len(groups) + (cap in groups)))
            fills = [f - 1 if (e and f == cap) else f
                     for f, e in zip(fills, want)]
            emitted_ok &= bool((emitted == want).all())
            counts = self.counts()
            ref_pose, ref_emitted = plain.step(ori, acc, active=active)
            two_pose, two_emitted = twopass.step(ori, acc, active=active)
            for k, n in counts.items():               # the twins' launches
                self.wrappers[k].launches = n         # do not count
            emitted_ok &= bool((ref_emitted == want).all()
                               and (two_emitted == want).all())
            if want.any():
                finite &= bool(np.isfinite(pose[want]).all())
                pose_err = max(pose_err, float(
                    np.abs(pose[want] - ref_pose[want]).max()))
                fused_err = max(fused_err, float(
                    np.abs(pose[want] - two_pose[want]).max()))
            fused_err = max(fused_err, tree_err(sess._states,
                                                twopass._states))
            if tick == 2:
                for s_ in (sess, plain, twopass):
                    s_.reset(stream=3)
                fills[3] = 0
        state_err = tree_err(sess._states, plain._states)
        before = wrapper.launches
        tails = sess.flush()
        flush_launches = wrapper.launches - before
        counts = self.counts()                        # the main path ended
        self.launches[path] = counts
        ref_tails = plain.flush()
        warm = [i for i in range(S) if fills[i]]
        tails_ok = all(
            (tails[i] is not None and tails[i].shape[0] == min(fills[i], K)
             * W) if (i in warm and K) else tails[i] is None
            for i in range(S))
        tail_err = max([float(np.abs(a - b).max())
                        for a, b in zip(tails, ref_tails) if a is not None]
                       or [0.0])
        self.check(per_tick == want_per_tick,
                   f"{path} launches per tick {per_tick} != {want_per_tick}")
        self.check(emitted_ok, f"{path} emitted differs from the fill counts")
        self.check(finite, f"{path} poses not finite")
        self.check(pose_err <= PATH_TOL and state_err <= PATH_TOL
                   and tail_err <= PATH_TOL,
                   f"{path} vs plain path: pose {pose_err:.3e} state "
                   f"{state_err:.3e} flush {tail_err:.3e}")
        self.check(fused_err <= 1e-6,
                   f"{path} fused vs two-pass: {fused_err:.3e}")
        self.check(tails_ok and flush_launches == per_pass
                   and all(not b for b in sess._buffers),
                   f"{path} flush: tails ok={tails_ok}, {flush_launches} "
                   f"launches, buffers {[len(b) for b in sess._buffers]}")
        self.check(all(n == 0 for k, n in counts.items() if k != kernel),
                   f"{path} launched other kernels: {counts}")

        # the pipelined entry points at one stream against a step loop
        loop, ahead, deferred = (make("auto", True, 1, plain_windows=True)
                                 for _ in range(3))
        wins = [self.windows(rng, 1) for _ in range(5)]
        want = np.stack([loop.step(o, a) for o, a in wins])
        got = ahead.run_windows(np.stack([o for o, _ in wins]),
                                np.stack([a for _, a in wins]))
        late = [deferred.step_async(o, a) for o, a in wins]
        late.append(deferred.flush())
        pipe_err = max(float(np.abs(got - want).max()),
                       float(np.abs(np.stack(late[1:]) - want).max()),
                       tree_err(ahead._states, loop._states),
                       tree_err(deferred._states, loop._states))
        self.check(late[0] is None and deferred.flush() is None
                   and pipe_err == 0.0,
                   f"{path} run_windows / step_async vs step loop: "
                   f"{pipe_err:.3e}")

        # steady ticks: every slot at capacity, one fused tick per window
        for _ in range(cap + 2):
            sess.step(*self.windows(rng, S))
        inputs = [self.windows(rng, S) for _ in range(20)]
        torch.cuda.synchronize()
        times = []
        for ori_w, acc_w in inputs:
            t0 = time.perf_counter()
            sess.step(ori_w, acc_w)
            times.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(times))
        try:
            profile = self.profile_window(sess, inputs[:3])
        except Exception as e:     # a measurement aid, not a check
            profile = f"not measured: the profiler raised {e!r}"
        emit({"phase": path, "streams": S, "window": W, "lookahead": K,
              "history": P, "hidden": hidden, "launches_per_tick": per_tick,
              "flush_launches": flush_launches, "launches": counts,
              "pose_max_abs_err_vs_plain": pose_err,
              "state_max_abs_err_vs_plain": state_err,
              "flush_max_abs_err_vs_plain": tail_err,
              "fused_vs_two_pass_max_abs_err": fused_err,
              "pipelined_vs_step_loop_max_abs_err": pipe_err,
              "ms_per_tick_median": med,
              "ms_per_tick_p90": percentile(times, 90),
              "frames_per_s_emitted": S * W / (med / 1e3),
              "timed_ticks": len(times), "profile": profile,
              "card": nvidia_smi()})

    def cascade_session(self, kind, model, params3_of, K, P):
        from a3gc_tpu_torch.data import load_stats
        from a3gc_tpu_torch.eval.streaming import StreamingCascade

        def make(backend, fused, S, plain_windows=False):
            cfg = self.cascade(kind, backend)
            k, p = (0, 0) if plain_windows else (K, P)
            return StreamingCascade(params3_of(cfg), cfg, model,
                                    window=WINDOW, stats=load_stats(),
                                    normalize=True, streams=S, lookahead=k,
                                    history=p, fused=fused, device=self.dev)
        return make

    def dip_session(self, model, params, K, P, bidirectional=True):
        from a3gc_tpu_torch.data import load_stats
        from a3gc_tpu_torch.eval.streaming import DipStreamingSession

        def make(backend, fused, S, plain_windows=False):
            k, p = (0, 0) if plain_windows else (K, P)
            return DipStreamingSession(params,
                                       self.dip_cfg(backend, bidirectional),
                                       model,
                                       window=WINDOW, stats=load_stats(),
                                       streams=S, lookahead=k, history=p,
                                       fused=fused, device=self.dev)
        return make

    def a3gc_sessions(self, K, P):
        from a3gc_tpu_torch.smpl import ParametricModel
        params3 = self.params3(self.cascade("a3gc", "auto"))
        return self.cascade_session("a3gc", ParametricModel(),
                                    lambda cfg: params3, K, P)

    def dip_sessions(self, K, P, bidirectional=True):
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        from a3gc_tpu_torch.smpl import ParametricModel
        params = init_pose_net(self.torch.Generator().manual_seed(0),
                               self.dip_cfg("auto", bidirectional)
                               ).to(self.dev)
        return self.dip_session(ParametricModel(), params, K, P,
                                bidirectional)

    def phase_buffered(self):
        self.buffered("buffered", self.a3gc_sessions(1, 1), "gcn_lstm", 1, 1,
                      6, [s[0] for s in STAGES])

    def phase_buffered_dip(self):
        self.buffered("buffered_dip", self.dip_sessions(1, 0), "lstm", 1, 0,
                      2, [DIP[0]])

    def http(self, path, make, kernel, K, P):
        """An in-process PoseServer on the card over ``make``'s session,
        eight PoseClient threads in binary mode; every stream is held
        against a single-slot session fed the same windows."""
        import threading
        from concurrent.futures import ThreadPoolExecutor
        import numpy as np
        from a3gc_tpu_torch.client import PoseClient
        from a3gc_tpu_torch.serve import PoseServer
        S, W, n_windows = S_SERVE, WINDOW, 12
        rng = np.random.default_rng(3)
        # stream 7 ends midway and releases; stream 8 takes its slot
        lengths = [n_windows] * 7 + [n_windows // 2, n_windows // 2]
        feeds = [[self.windows(rng, 1) for _ in range(n)] for n in lengths]
        srv = PoseServer(None, None, None, host="127.0.0.1", port=0,
                         session=make("auto", True, S), lookahead=K,
                         history=P, max_wait_ms=5.0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        clients, trips, served = {}, [], {}
        lock = threading.Lock()

        def client():
            return PoseClient(*srv.address[:2], binary=True, timeout=60.0,
                              retry_s=10.0, retry_interval=0.05)

        def stream(i, c, finish):
            out, mine = [], []
            for ori, acc in feeds[i]:
                t0 = time.perf_counter()
                pose = c.step(ori, acc)
                mine.append((time.perf_counter() - t0) * 1e3)
                if pose is not None:
                    out.append(pose)
            if finish:
                tail = c.flush()
                if tail is not None:
                    out.append(tail)
                c.release()
            with lock:
                trips.extend(mine)
                served[i], clients[i] = out, c
            return i

        def worker(i):
            for j in ((7, 8) if i == 7 else (i,)):  # 8: the slot's next tenant
                c = client()
                c.acquire()
                stream(j, c, finish=j == 7)

        try:
            self.zero_counts()                        # the main path starts
            t0 = time.perf_counter()
            with ThreadPoolExecutor(S) as pool:
                list(pool.map(worker, range(S)))
            wall = time.perf_counter() - t0
            counts = self.counts()                    # the main path ended
            self.launches[path] = counts
            stats = clients[0].stats()

            # a retried seq: the cached answer, no tick, no launch
            c0 = clients[0]
            c0._seq -= 1
            again = c0.step(*feeds[0][-1])
            after = c0.stats()
            self.check(np.array_equal(again, served[0][-1])
                       and self.counts() == counts
                       and after["ticks"] == stats["ticks"],
                       f"{path} a retried seq was stepped again")
            for i, c in clients.items():
                if i != 7:
                    tail = c.flush()
                    if tail is not None:
                        served[i].append(tail)
                    c.release()

            # JSON against binary on two fresh slots, the same windows
            cb, cj = client(), client()
            cj.binary = False
            with cb, cj:
                json_err = 0.0
                for ori, acc in feeds[0][:K + P + 2]:
                    b, j = cb.step(ori, acc), cj.step(ori, acc)
                    self.check((b is None) == (j is None),
                               f"{path} JSON and binary warm up apart")
                    if b is not None:
                        json_err = max(json_err,
                                       float(np.abs(b - j).max()))
                final = cb.stats()
        finally:
            srv.shutdown()
        self.check(json_err <= 1e-6, f"{path} JSON vs binary {json_err:.3e}")
        self.check(final["errors"] == 0 and stats["errors"] == 0,
                   f"{path} /v1/stats reports errors: {final}")
        self.check(stats["mean_coalesced"] is not None
                   and final["active_sessions"] == 2,
                   f"{path} /v1/stats: {final}")
        self.check(all(n == 0 for k, n in counts.items() if k != kernel)
                   and counts[kernel] > 0,
                   f"{path} launches {counts}")

        # every stream against a single-slot session on the card
        pose_err, frames = 0.0, 0
        for i, feed in enumerate(feeds):
            ref = make("auto", True, 1)
            want = [p for p in (ref.step(o, a) for o, a in feed)
                    if p is not None]
            tail = ref.flush()
            if tail is not None:
                want.append(tail)
            got, want = np.concatenate(served[i]), np.concatenate(want)
            ok = got.shape == want.shape == (len(feed) * W, 24, 3, 3)
            self.check(ok, f"{path} stream {i}: {got.shape} vs {want.shape}")
            if ok:
                pose_err = max(pose_err, float(np.abs(got - want).max()))
                frames += got.shape[0]
        self.check(pose_err <= PATH_TOL and bool(np.isfinite(pose_err)),
                   f"{path} streams vs single-slot sessions: {pose_err:.3e}")
        emit({"phase": path, "streams": S, "window": W, "lookahead": K,
              "history": P, "clients": len(feeds), "windows_per_client":
              lengths, "launches": counts,
              "pose_max_abs_err_vs_single_slot": pose_err,
              "json_vs_binary_max_abs_err": json_err,
              "round_trip_ms_median": percentile(trips, 50),
              "round_trip_ms_p99": percentile(trips, 99),
              "tick_ms_mean": stats["tick_ms_mean"],
              "tick_ms_p99": stats["tick_ms_p99"],
              "mean_coalesced": stats["mean_coalesced"],
              "ticks": stats["ticks"], "requests": stats["requests"],
              "errors": final["errors"], "exchange_s": wall,
              "frames_per_s": sum(lengths) * W / wall,
              "card": nvidia_smi()})

    def phase_http(self):
        self.http("http", self.a3gc_sessions(1, 1), "gcn_lstm", 1, 1)

    def phase_http_dip(self):
        self.http("http_dip", self.dip_sessions(0, 0), "lstm", 0, 0)

    def spawn_server(self, argv):
        """Start ``python -m a3gc_tpu_torch.cli`` with ``argv``; returns the
        process and a function that waits for its serving line and returns
        (the line, seconds since the start, host, port)."""
        import queue
        import threading
        t_start = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "a3gc_tpu_torch.cli"] + argv, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        lines = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                         daemon=True).start()

        def ready():
            try:
                info = json.loads(lines.get(timeout=180))
            except (queue.Empty, ValueError):
                proc.kill()
                raise RuntimeError(f"cli {' '.join(argv)} printed no serving "
                                   "line:\n" + proc.stderr.read()[-4000:])
            host, port = info["serving"].rsplit("//", 1)[1].rsplit(":", 1)
            return info, time.perf_counter() - t_start, host, int(port)
        return proc, ready

    def phase_cli_serve(self):
        self.cli_serve("cli_serve", ["serve", "--port", "0", "--streams",
                                     str(S_SERVE), "--norm", "--quality",
                                     "balanced"])

    def cli_serve(self, path, argv):
        """The server as a user starts it (``argv``: a fresh init with
        --norm and --quality balanced, or an artifact exported from one),
        recycled under two clients, against in-process K = P = 1 sessions
        on the fresh init's params."""
        import numpy as np
        from a3gc_tpu_torch import cli
        from a3gc_tpu_torch.client import PoseClient
        from a3gc_tpu_torch.eval.streaming import StreamingCascade
        from a3gc_tpu_torch.smpl import ParametricModel
        proc, ready = self.spawn_server(argv)
        try:
            info, start_s, host, port = ready()
            args = cli.build_parser().parse_args(argv)
            cli._apply_quality(args)
            cascade, is_graph = cli._stage_configs(args)
            params3 = cli._init_cascade_params(cascade, is_graph, self.dev)
            rng = np.random.default_rng(4)
            feeds = [[self.windows(rng, 1) for _ in range(6)]
                     for _ in range(2)]
            refs = [StreamingCascade(
                params3, cascade, ParametricModel(), window=args.window,
                stats=cli._load_stats(args), normalize=True,
                lookahead=args.lookahead, history=args.history,
                device=self.dev) for _ in feeds]
            clients = [PoseClient(host, int(port), timeout=120.0,
                                  retry_s=300.0, retry_interval=0.25)
                       for _ in feeds]
            for c in clients:
                c.acquire()
            pose_err, n_poses, answered = 0.0, 0, []

            def step_all(w):
                nonlocal pose_err, n_poses
                for c, ref, feed in zip(clients, refs, feeds):
                    got = c.step(*feed[w])
                    answered.append(time.perf_counter())
                    want = ref.step(*feed[w])
                    self.check((got is None) == (want is None),
                               f"{path} window {w}: warm-up differs")
                    if got is not None and want is not None:
                        pose_err = max(pose_err,
                                       float(np.abs(got - want).max()))
                        n_poses += 1

            for w in range(3):
                step_all(w)
            before = clients[0].stats()
            t_last, n_before = time.perf_counter(), len(answered)
            clients[0].recycle()
            step_all(3)             # the clients retry through the pause
            pause_s = answered[n_before] - t_last
            step_all(4)
            step_all(5)
            after = clients[1].stats()
            for c, ref in zip(clients, refs):
                tail, want = c.flush(), ref.flush()
                pose_err = max(pose_err, float(np.abs(tail - want).max()))
                c.release()
            alive = proc.poll() is None
        finally:
            proc.kill()
            proc.wait()
        err = proc.stderr.read()
        self.check(alive, f"{path}: the server exited:\n" + err[-2000:])
        self.check("recycled: restored 2 live session(s)" in err,
                   f"{path}: no restored generation:\n" + err[-2000:])
        self.check(n_poses == 10 and pose_err <= PATH_TOL,
                   f"{path}: {n_poses} poses, max|d| {pose_err:.3e} vs an "
                   "uninterrupted session")
        self.check(after["errors"] == 0 and after["active_sessions"] == 2
                   and after["ticks"] < before["ticks"] + 3,
                   f"{path}: /v1/stats after the recycle: {after}")
        emit({"phase": path, "argv": argv, "serving": info,
              "start_s": start_s, "recycle_pause_s": pause_s,
              "pose_max_abs_err_vs_uninterrupted": pose_err,
              "poses_compared": n_poses, "stats_before": before,
              "stats_after": after, "card": nvidia_smi()})

    # -- 3c: trained checkpoints -------------------------------------------
    def phase_checkpoints(self):
        """Every family's random params written as a reference ``.tar`` by
        the port's exporter and as a checkpoint directory of its own
        format, read back onto the card, and one S = 8 window of a session
        on each against the session on the original params: parameters,
        poses and carried states bit-equal."""
        import tempfile
        import numpy as np
        from a3gc_tpu_torch.compat import torch_export as TE
        from a3gc_tpu_torch.compat import torch_import as TI
        from a3gc_tpu_torch.data import load_adjacency_template, load_stats
        from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                                   StreamingCascade)
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        from a3gc_tpu_torch.smpl import ParametricModel
        from a3gc_tpu_torch.utils import restore_params, save_params
        torch = self.torch
        model, nira = ParametricModel(), load_adjacency_template()
        ori, acc = self.windows(np.random.default_rng(6), S_SERVE)
        rows = []

        def to_tar(path, p, cfg, family):
            TE.save_torch_checkpoint(path, TE.graph_net_state_dict(p, family)
                                     if cfg.is_graph else TE.dip_state_dict(p))
            sd = TI.load_torch_checkpoint(path)
            if cfg.is_graph:
                return TI.graph_net_params_from_state_dict(
                    sd, family, cfg=cfg.net, device=self.dev)
            return TI.dip_params_from_state_dict(sd, cfg=cfg.net,
                                                 device=self.dev)

        self.zero_counts()                            # the main path starts
        with tempfile.TemporaryDirectory() as tmp:
            for family in ("a3gc", "aagc", "agc", "ggru", "tp", "dip",
                           "dip_uni"):
                if family.startswith("dip"):
                    cfg = self.dip_cfg("auto", family == "dip")
                    cfgs = (cfg,)
                    params = (init_pose_net(torch.Generator().manual_seed(0),
                                            cfg).to(self.dev),)

                    def session(ps, cfg=cfg):
                        return DipStreamingSession(
                            ps[0], cfg, model, window=WINDOW,
                            stats=load_stats(), streams=S_SERVE,
                            device=self.dev)
                else:
                    cascade = self.cascade(family, "auto")
                    cfgs, params = cascade.stages, self.params3(cascade)

                    def session(ps, cascade=cascade):
                        return StreamingCascade(
                            tuple(ps), cascade, model, window=WINDOW,
                            stats=load_stats(), normalize=True,
                            streams=S_SERVE, device=self.dev)
                loaded = {"tar": [], "dir": []}
                for i, (p, c) in enumerate(zip(params, cfgs)):
                    loaded["tar"].append(to_tar(
                        os.path.join(tmp, f"{family}{i}.tar"), p, c, family))
                    path = save_params(p, os.path.join(tmp, family), i + 1, 1)
                    template = init_pose_net(
                        torch.Generator().manual_seed(99), c, nira)
                    loaded["dir"].append(restore_params(
                        path, template.to(self.dev)))
                ref = session(params)
                want = ref.step(ori, acc)
                row = {"family": family}
                for how, ps in loaded.items():
                    same = all(a.device == self.dev and torch.equal(a, b)
                               for x, y in zip(ps, params)
                               for a, b in zip(x.parameters(),
                                               y.parameters()))
                    sess = session(ps)
                    got = sess.step(ori, acc)
                    pose_err = float(np.abs(got - want).max())
                    state_err = tree_err(sess._states, ref._states)
                    self.check(same and pose_err == 0.0 and state_err == 0.0
                               and bool(np.isfinite(got).all()),
                               f"checkpoints {family} via {how}: params "
                               f"equal {same}, pose {pose_err:.3e}, state "
                               f"{state_err:.3e}")
                    row[how] = {"params_equal": same, "pose_max_abs_err":
                                pose_err, "state_max_abs_err": state_err}
                rows.append(row)
        counts = self.counts()                        # the main path ended
        self.launches["checkpoints"] = counts
        self.check(all(n > 0 for n in counts.values()),
                   f"checkpoints launches {counts}")
        emit({"phase": "checkpoints", "streams": S_SERVE, "window": WINDOW,
              "launches": counts, "families": rows})

    def phase_cli_serve_checkpoints(self):
        """Checkpoints served the way a user starts them: three A3GC stage
        ``.tar``s, a ``--path`` directory of two epochs written by ``cli
        convert-checkpoint``, and the DIP net from a ``.tar``, each behind
        a ``cli serve`` subprocess (the three start at once) with two
        clients, against in-process sessions on the same params; then a
        newer epoch written into the directory and ``POST /v1/reload``."""
        import shutil
        import tempfile
        import numpy as np
        from a3gc_tpu_torch import cli
        from a3gc_tpu_torch.client import PoseClient
        from a3gc_tpu_torch.compat import torch_export as TE
        from a3gc_tpu_torch.data import load_adjacency_template
        from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                                   StreamingCascade)
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        from a3gc_tpu_torch.smpl import ParametricModel
        from a3gc_tpu_torch.utils import save_params
        torch = self.torch
        model, nira = ParametricModel(), load_adjacency_template()
        base = ["serve", "--port", "0", "--streams", str(S_SERVE), "--norm",
                "--window", str(WINDOW)]
        for i, (H, _, _, _) in enumerate(STAGES):    # the defaults
            base += [f"--hu{i + 1}", str(H)]
        cascade, _ = cli._stage_configs(cli.build_parser().parse_args(base))

        def params3(seed):
            return tuple(init_pose_net(torch.Generator().manual_seed(seed + i),
                                       c, nira).to(self.dev)
                         for i, c in enumerate(cascade.stages))

        epochs = {1: params3(0), 2: params3(10), 3: params3(20)}
        dip_cfg = self.dip_cfg("auto")
        dip = init_pose_net(torch.Generator().manual_seed(30),
                            dip_cfg).to(self.dev)
        tmp = tempfile.mkdtemp()
        runs = os.path.join(tmp, "runs")
        tars = {}
        for ep in (1, 2):
            for i, p in enumerate(epochs[ep]):
                tars[ep, i] = os.path.join(tmp, f"e{ep}s{i + 1}.tar")
                TE.save_torch_checkpoint(tars[ep, i],
                                         TE.graph_net_state_dict(p, "a3gc"))
        dip_tar = os.path.join(tmp, "dip.tar")
        TE.save_torch_checkpoint(dip_tar, TE.dip_state_dict(dip))
        procs = {}
        try:
            t0 = time.perf_counter()
            converts = [subprocess.Popen(
                [sys.executable, "-m", "a3gc_tpu_torch.cli",
                 "convert-checkpoint", "--torch", tars[ep, i], "--model",
                 "a3gc", "--output", os.path.join(
                     runs, f"checkpoint_model{i + 1}_finetuning_{ep}"),
                 "--epoch", str(ep)], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
                for ep in (1, 2) for i in range(3)]
            for c in converts:
                out, err = c.communicate(timeout=300)
                self.check(c.returncode == 0 and "converted" in out,
                           f"cli convert-checkpoint: {err[-2000:]}")
            convert_s = time.perf_counter() - t0
            argvs = {
                "torch_checkpoints": base + [
                    "--quality", "balanced", "--torch_checkpoints"]
                + [tars[1, i] for i in range(3)],
                # stages 1 and 2 pinned to epochs 1 and 2, stage 3 the
                # latest: the reload below moves it alone
                "path": base + ["--path", runs, "--mid1", "1", "--mid2", "2"],
                "dip": base[:-6] + ["--model", "dip", "--hu1", str(DIP[0]),
                                    "--torch_checkpoints", dip_tar],
            }
            served = {"torch_checkpoints": epochs[1],
                      "path": (epochs[1][0], epochs[2][1], epochs[2][2]),
                      "dip": dip}
            t0 = time.perf_counter()
            procs = {k: self.spawn_server(v) for k, v in argvs.items()}
            up = {k: wait() for k, (_, wait) in procs.items()}
            all_up_s = time.perf_counter() - t0
            rng = np.random.default_rng(8)
            report = {}
            for name, argv in argvs.items():
                args = cli.build_parser().parse_args(argv)
                cli._apply_quality(args)
                stats = cli._load_stats(args)
                kw = dict(window=args.window or WINDOW, stats=stats,
                          lookahead=args.lookahead, history=args.history,
                          device=self.dev)
                refs = [DipStreamingSession(served[name], dip_cfg, model,
                                            **kw) if name == "dip" else
                        StreamingCascade(served[name], cascade, model,
                                         normalize=True, **kw)
                        for _ in range(2)]
                _, start_s, host, port = up[name]
                clients = [PoseClient(host, port, timeout=120.0, retry_s=30.0,
                                      retry_interval=0.1) for _ in refs]
                feeds = [[self.windows(rng, 1) for _ in range(5)]
                         for _ in refs]
                err, n = 0.0, 0

                def drive(windows):
                    nonlocal err, n
                    for w in windows:
                        for c, ref, feed in zip(clients, refs, feeds):
                            got, want = c.step(*feed[w]), ref.step(*feed[w])
                            self.check((got is None) == (want is None),
                                       f"cli_serve_checkpoints {name} "
                                       f"window {w}: warm-up differs")
                            if got is not None and want is not None:
                                err = max(err, float(np.abs(got - want)
                                                     .max()))
                                n += 1

                for c in clients:
                    c.acquire()
                drive(range(3))
                report[name] = {"argv": argv, "serving": up[name][0],
                                "start_s": start_s, "pose_max_abs_err": err,
                                "poses_compared": n}
                self.check(n >= 4 and err <= PATH_TOL,
                           f"cli_serve_checkpoints {name}: {n} poses, "
                           f"max|d| {err:.3e} vs in-process")
                if name == "path":
                    for i, p in enumerate(epochs[3]):
                        save_params(p, runs, i + 1, 3, finetuning=True)
                    t1 = time.perf_counter()
                    answer = clients[0].reload()
                    reload_s = time.perf_counter() - t1
                    newer = (epochs[1][0], epochs[2][1], epochs[3][2])
                    for ref in refs:
                        ref.params3 = newer
                    err, n = 0.0, 0
                    t1 = time.perf_counter()
                    drive(range(3, 5))
                    report[name].update(
                        reload=answer, reload_s=reload_s,
                        after_reload_two_windows_s=time.perf_counter() - t1,
                        pose_max_abs_err_after_reload=err)
                    self.check(answer == {"reloaded": True} and n == 4
                               and err <= PATH_TOL,
                               f"cli_serve_checkpoints reload: {answer}, "
                               f"{n} poses, max|d| {err:.3e}")
                stats_now = clients[0].stats()
                self.check(stats_now["errors"] == 0,
                           f"cli_serve_checkpoints {name}: {stats_now}")
                for c in clients:
                    c.release()
            alive = {k: p.poll() is None for k, (p, _) in procs.items()}
        finally:
            for proc, _ in procs.values():
                proc.kill()
                proc.wait()
            shutil.rmtree(tmp, ignore_errors=True)
        self.check(all(alive.values()), f"cli_serve_checkpoints: a server "
                   f"exited: {alive}")
        emit({"phase": "cli_serve_checkpoints", "convert_s": convert_s,
              "servers_up_s": all_up_s, "servers": report,
              "card": nvidia_smi()})

    # -- 3d: deployment artifacts ------------------------------------------
    def export_families(self):
        """(name, build) of every family the artifacts cover: ``build()``
        -> (export(directory) -> seconds, live session, kernel, launches
        per window, hidden), on params from torch.Generator seed 0."""
        from a3gc_tpu_torch import export as X
        from a3gc_tpu_torch.data import load_stats
        from a3gc_tpu_torch.eval.streaming import (DipStreamingSession,
                                                   StreamingCascade)
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        from a3gc_tpu_torch.smpl import ParametricModel
        model = ParametricModel()

        def cascade(kind, kernel):
            def build():
                cfg = self.cascade(kind, "auto")
                params3 = self.params3(cfg)

                def export(d):
                    t0 = time.perf_counter()
                    X.save_exported(d, *X.export_streaming_cascade(
                        params3, cfg, model, window=WINDOW, streams=S_SERVE,
                        stats=load_stats(), normalize=True))
                    return time.perf_counter() - t0
                live = StreamingCascade(params3, cfg, model, window=WINDOW,
                                        stats=load_stats(), normalize=True,
                                        streams=S_SERVE, device=self.dev)
                return export, live, kernel, 6, [
                    s[0] for s in (TP_STAGES if kind == "tp" else STAGES)]
            return build

        def dip(bidirectional):
            def build():
                cfg = self.dip_cfg("auto", bidirectional)
                params = init_pose_net(self.torch.Generator().manual_seed(0),
                                       cfg).to(self.dev)

                def export(d):
                    t0 = time.perf_counter()
                    X.save_exported(d, *X.export_streaming_dip(
                        params, cfg, model, window=WINDOW, streams=S_SERVE,
                        stats=load_stats()))
                    return time.perf_counter() - t0
                live = DipStreamingSession(params, cfg, model, window=WINDOW,
                                           stats=load_stats(),
                                           streams=S_SERVE, device=self.dev)
                return export, live, "lstm", 2, [DIP[0]]
            return build

        return (("a3gc", cascade("a3gc", "gcn_lstm")),
                ("ggru", cascade("ggru", "ggru")),
                ("tp", cascade("tp", "lstm")), ("dip", dip(True)),
                ("dip_uni", dip(False)))

    def phase_export(self):
        """Every family's artifact at full width (S = 8, W = 60) exported on
        the card, then loaded and stepped by a fresh process given only the
        directories (``EXPORT_CHILD``): 5 windows with a reset and an idle
        slot, launches per window counted there by the ops, its poses and
        final states against the live session on the same params and
        windows, its ms per window beside the live session's; then loaded
        in this process and timed in turns with the live session (the A3GC
        artifact profiled as ``serving`` profiles the live one)."""
        import shutil
        import tempfile
        import numpy as np
        from a3gc_tpu_torch import export as X
        torch = self.torch
        S, W = S_SERVE, WINDOW
        tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        rng = np.random.default_rng(11)
        wins = [self.windows(rng, S) for _ in range(5)]
        np.savez(os.path.join(tmp, "in.npz"),
                 ori=np.stack([o for o, _ in wins]),
                 acc=np.stack([a for _, a in wins]))
        idle = np.ones(S, np.float32)
        idle[5] = 0.0
        report, lives = {}, {}
        try:
            for name, build in self.export_families():
                export, live, kernel, per_window, hidden = build()
                d = os.path.join(tmp, name)
                export_s = export(d)
                poses = []
                for w, (o, a) in enumerate(wins):
                    active = idle if w == 3 else None
                    poses.append(live.step(o, a, active=active))
                    if w == 1:
                        live.reset(stream=3)
                # no step writes a state in place: this is the state after
                # the 5 windows
                lives[name] = (np.stack(poses), live._states, live)
                torch.cuda.synchronize()
                times = []
                for k in range(33):
                    t0 = time.perf_counter()
                    live.step(*wins[k % 5])
                    times.append((time.perf_counter() - t0) * 1e3)
                report[name] = {
                    "hidden": hidden, "kernel": kernel,
                    "export_s": export_s,
                    "bytes": sum(os.path.getsize(os.path.join(d, f))
                                 for f in os.listdir(d)),
                    "live_ms_per_window_median": float(np.median(times[3:])),
                    "want_launches_per_window": per_window}
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", EXPORT_CHILD, tmp]
                + [name for name, _ in self.export_families()], cwd=ROOT,
                capture_output=True, text=True, timeout=600)
            child_s = time.perf_counter() - t0
            self.check(proc.returncode == 0,
                       f"export child failed:\n{proc.stderr[-3000:]}")
            child = json.loads(proc.stdout.strip().splitlines()[-1])
            self.check(child["banned"] == [],
                       f"export child imported {child['banned']}")
            total = {k: 0 for k in LIBRARIES}
            for name, rec in report.items():
                got = child["families"][name]
                out = np.load(os.path.join(tmp, f"{name}_out.npz"))
                want_poses, want_states, live = lives[name]
                rows = np.ones((5, S), bool)
                rows[3] = idle > 0
                pose_err = float(np.abs(out["pose"][rows]
                                        - want_poses[rows]).max())
                state_err = max(float(np.abs(out[f"state{i}"]
                                             - t.cpu().numpy()).max())
                                for i, t in enumerate(leaves(want_states)))
                finite = bool(np.isfinite(out["pose"][rows]).all())
                rec.update(load_s=got["load_s"],
                           launches_per_window=got["launches_per_window"],
                           launches=got["launches"],
                           ms_per_window_median=got["ms_median"],
                           ms_per_window_p90=got["ms_p90"],
                           pose_max_abs_err_vs_live=pose_err,
                           state_max_abs_err_vs_live=state_err)
                k = rec["kernel"]
                self.check(finite and pose_err <= KERNEL_TOL
                           and state_err <= KERNEL_TOL,
                           f"export {name}: pose {pose_err:.3e} state "
                           f"{state_err:.3e} vs the live session")
                self.check(got["launches_per_window"]
                           == [rec["want_launches_per_window"]] * 5
                           and all(n == 0 for kk, n in got["launches"].items()
                                   if kk != k),
                           f"export {name}: launches {got['launches']}, per "
                           f"window {got['launches_per_window']}")
                for kk, n in got["launches"].items():
                    total[kk] += n
                # in this process too, in turns with the live session
                # (live, artifact, artifact, live): the same card, clock
                # and neighbours for both
                sess = X.ArtifactSession(X.load_exported(
                    os.path.join(tmp, name), device=self.dev))
                times = {"artifact": [], "live": []}
                for who in ("live", "artifact", "artifact", "live"):
                    s_ = sess if who == "artifact" else live
                    for k in range(12):
                        t0 = time.perf_counter()
                        s_.step(*wins[k % 5])
                        times[who].append((time.perf_counter() - t0) * 1e3)
                rec.update(
                    in_process_ms_per_window_median=float(np.median(
                        times["artifact"])),
                    in_process_live_ms_per_window_median=float(np.median(
                        times["live"])))
                if name == "a3gc":
                    try:
                        rec["profile"] = self.profile_window(sess, wins[:3])
                    except Exception as e:  # a measurement aid
                        rec["profile"] = ("not measured: the profiler "
                                          f"raised {e!r}")
            self.launches["export"] = total
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        emit({"phase": "export", "streams": S, "window": W,
              "cuda_init_s": child["cuda_init_s"], "child_s": child_s,
              "families": report, "launches": self.launches["export"],
              "card": nvidia_smi()})

    def phase_export_bundle(self):
        """A3GC and G-GRU bundles of (1, 60), (8, 60), (8, 120) and
        (8, 180) through ``ArtifactLookaheadSession(lookahead=1,
        history=1)`` for 6 ticks with an idle slot and a reset, plus
        ``flush``, against ``StreamingCascade(lookahead=1, history=1)``;
        the S = 1 geometry through ``ArtifactSession`` against a live
        single-slot session; ms per steady tick of both."""
        import shutil
        import tempfile
        import numpy as np
        from a3gc_tpu_torch import export as X
        from a3gc_tpu_torch.data import load_stats
        from a3gc_tpu_torch.eval.streaming import StreamingCascade
        from a3gc_tpu_torch.smpl import ParametricModel
        torch = self.torch
        S, W, K, P = S_SERVE, WINDOW, 1, 1
        cap = K + P + 1
        geoms = [(1, W), (S, W), (S, 2 * W), (S, 3 * W)]
        model = ParametricModel()
        tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        report = {}
        self.zero_counts()                            # the main path starts
        counted = {k: 0 for k in LIBRARIES}
        try:
            for kind, kernel in (("a3gc", "gcn_lstm"), ("ggru", "ggru")):
                cfg = self.cascade(kind, "auto")
                params3 = self.params3(cfg)
                d = os.path.join(tmp, kind)
                t0 = time.perf_counter()
                X.export_bundle(d, params3, cfg, model, geoms,
                                stats=load_stats(), normalize=True)
                export_s = time.perf_counter() - t0
                nbytes = sum(os.path.getsize(os.path.join(dp, f))
                             for dp, _, fs in os.walk(d) for f in fs)
                t0 = time.perf_counter()
                bundle = X.ExportedBundle(d, self.dev)
                sess = X.ArtifactLookaheadSession(bundle, streams=S,
                                                  window=W, lookahead=K,
                                                  history=P)
                load_s = time.perf_counter() - t0

                def live_session(S_, k, p):
                    return StreamingCascade(params3, cfg, model, window=W,
                                            stats=load_stats(),
                                            normalize=True, streams=S_,
                                            lookahead=k, history=p,
                                            device=self.dev)
                live = live_session(S, K, P)
                rng = np.random.default_rng(12)
                idle = np.ones(S, np.float32)
                idle[5] = 0.0
                wrapper = self.wrappers[kernel]
                fills = [0] * S
                per_tick, want_per_tick, err = [], [], 0.0
                emitted_ok = True
                for tick in range(6):
                    ori, acc = self.windows(rng, S)
                    active = idle if tick == 3 else None
                    act = np.ones(S, bool) if active is None else active > 0
                    before = wrapper.launches
                    pose, emitted = sess.step(ori, acc, active=active)
                    per_tick.append(wrapper.launches - before)
                    fills = [f + 1 if a else f for f, a in zip(fills, act)]
                    want = np.array([a and f >= K + 1
                                     for f, a in zip(fills, act)])
                    groups = {f for f, e in zip(fills, want) if e}
                    want_per_tick.append(6 * (len(groups) + (cap in groups)))
                    fills = [f - 1 if (e and f == cap) else f
                             for f, e in zip(fills, want)]
                    counts = self.counts()
                    ref_pose, ref_emitted = live.step(ori, acc,
                                                      active=active)
                    for k_, n in counts.items():      # the live twin's
                        self.wrappers[k_].launches = n    # do not count
                    emitted_ok &= bool((emitted == want).all()
                                       and (ref_emitted == want).all())
                    if want.any():
                        err = max(err, float(np.abs(pose[want]
                                                    - ref_pose[want]).max()))
                    if tick == 2:
                        sess.reset(stream=3)
                        live.reset(stream=3)
                        fills[3] = 0
                state_err = tree_err(sess._states, live._states)
                before = wrapper.launches
                tails = sess.flush()
                flush_launches = wrapper.launches - before
                counts = self.counts()
                ref_tails = live.flush()
                for k_, n in counts.items():
                    self.wrappers[k_].launches = n
                tail_err = max([float(np.abs(a - b).max()) for a, b in
                                zip(tails, ref_tails) if a is not None]
                               or [0.0])
                tails_ok = all((a is None) == (b is None)
                               for a, b in zip(tails, ref_tails))
                # the S = 1 geometry: plain windows, the kernels at S = 1
                one = X.ArtifactSession(bundle.select(1, W))
                ref1 = live_session(1, 0, 0)
                before = wrapper.launches
                one_err = 0.0
                for _ in range(3):
                    o, a = self.windows(rng, 1)
                    got = one.step(o, a)
                    counts = self.counts()
                    want1 = ref1.step(o, a)
                    for k_, n in counts.items():
                        self.wrappers[k_].launches = n
                    one_err = max(one_err, float(np.abs(got - want1).max()))
                one_launches = wrapper.launches - before
                for k_, n in self.counts().items():
                    counted[k_] += n
                self.zero_counts()
                # steady ticks of both, in turns (artifact, live, live,
                # artifact): every slot at capacity
                for _ in range(cap + 1):
                    o, a = self.windows(rng, S)
                    sess.step(o, a)
                    live.step(o, a)
                inputs = [self.windows(rng, S) for _ in range(10)]
                times = {"artifact": [], "live": []}
                for who in ("artifact", "live", "live", "artifact"):
                    s_ = sess if who == "artifact" else live
                    torch.cuda.synchronize()
                    for o, a in inputs:
                        t0 = time.perf_counter()
                        s_.step(o, a)
                        times[who].append((time.perf_counter() - t0) * 1e3)
                self.zero_counts()
                self.check(per_tick == want_per_tick,
                           f"export_bundle {kind}: launches per tick "
                           f"{per_tick} != {want_per_tick}")
                self.check(emitted_ok and tails_ok,
                           f"export_bundle {kind}: emitted / tails differ")
                self.check(max(err, state_err, tail_err, one_err)
                           <= KERNEL_TOL,
                           f"export_bundle {kind} vs live: pose {err:.3e} "
                           f"state {state_err:.3e} flush {tail_err:.3e} "
                           f"S=1 {one_err:.3e}")
                self.check(flush_launches == 6 and one_launches == 18,
                           f"export_bundle {kind}: flush {flush_launches}, "
                           f"S=1 {one_launches} launches")
                report[kind] = {
                    "geometries": geoms, "export_s": export_s,
                    "bytes": nbytes, "load_s": load_s,
                    "launches_per_tick": per_tick,
                    "flush_launches": flush_launches,
                    "s1_launches_3_windows": one_launches,
                    "pose_max_abs_err_vs_live": err,
                    "state_max_abs_err_vs_live": state_err,
                    "flush_max_abs_err_vs_live": tail_err,
                    "s1_max_abs_err_vs_live": one_err,
                    "ms_per_tick_median": float(np.median(
                        times["artifact"])),
                    "live_ms_per_tick_median": float(np.median(
                        times["live"])),
                    "timed_ticks": len(times["artifact"])}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.launches["export_bundle"] = counted      # the main path ended
        emit({"phase": "export_bundle", "streams": S, "window": W,
              "lookahead": K, "history": P, "bundles": report,
              "launches": counted, "card": nvidia_smi()})

    def phase_cli_export(self):
        """``cli export`` of an A3GC bundle (S = 1 and 8, W = 60, K = P = 1)
        as a user runs it; ``cli serve --artifact`` on it with two clients
        and a recycle (as ``cli_serve``); ``cli stream --artifact`` on a
        synthetic test npz against in-process K = P = 1 sessions."""
        import shutil
        import tempfile
        import numpy as np
        from a3gc_tpu_torch import cli
        from a3gc_tpu_torch.eval.streaming import StreamingCascade
        from a3gc_tpu_torch.smpl import ParametricModel
        tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        art = os.path.join(tmp, "a3gc")
        try:
            argv = ["export", "--norm", "--streams", "1", str(S_SERVE),
                    "--window", str(WINDOW), "--lookahead", "1",
                    "--history", "1", "--output", art]
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "a3gc_tpu_torch.cli"] + argv,
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            export_wall_s = time.perf_counter() - t0
            self.check(proc.returncode == 0 and "exported bundle of 6"
                       in proc.stdout, f"cli export: {proc.stderr[-3000:]}")
            nbytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(art) for f in fs)
            self.cli_serve("cli_serve_artifact",
                           ["serve", "--artifact", art, "--port", "0",
                            "--streams", str(S_SERVE), "--quality",
                            "balanced"])
            rng = np.random.default_rng(13)
            seqs = [{"ori": random_rotations(rng, (T, 6)).reshape(T, 54),
                     "acc": rng.normal(scale=0.5, size=(T, 18))
                     .astype(np.float32),
                     "pose": random_rotations(rng, (T, 15)).reshape(T, 135)}
                    for T in (300, 420, 610)]
            npz = os.path.join(tmp, "test.npz")
            np.savez(npz, **{f"seq{i}_{k}": s[k] for i, s in enumerate(seqs)
                             for k in ("ori", "acc", "pose")})
            out = os.path.join(tmp, "out.npz")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "a3gc_tpu_torch.cli", "stream",
                 "--artifact", art, "--streams", "1", "--quality",
                 "balanced", "--input", npz, "--output", out], cwd=ROOT,
                capture_output=True, text=True, timeout=600)
            stream_wall_s = time.perf_counter() - t0
            self.check(proc.returncode == 0,
                       f"cli stream --artifact: {proc.stderr[-3000:]}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            args = cli.build_parser().parse_args(["serve"])
            cascade, is_graph = cli._stage_configs(args)
            ref = StreamingCascade(
                cli._init_cascade_params(cascade, is_graph, self.dev),
                cascade, ParametricModel(), window=WINDOW,
                stats=cli._load_stats(args), normalize=True, lookahead=1,
                history=1, device=self.dev)
            got = np.load(out)
            err, n = 0.0, 0
            for i, s in enumerate(seqs):
                ref.reset()
                T = s["ori"].shape[0] // WINDOW * WINDOW
                poses = [ref.step(s["ori"][t:t + WINDOW],
                                  s["acc"][t:t + WINDOW])
                         for t in range(0, T, WINDOW)]
                poses = [p for p in poses if p is not None] + [ref.flush()]
                want = np.concatenate(poses)
                g = got[f"pose_{i:03d}"]
                self.check(g.shape == want.shape,
                           f"cli stream pose_{i:03d}: {g.shape} != "
                           f"{want.shape}")
                if g.shape == want.shape:
                    err = max(err, float(np.abs(g - want).max()))
                    n += g.shape[0]
            self.check(n == 1320 and err <= KERNEL_TOL,
                       f"cli stream --artifact: {n} frames, max|d| "
                       f"{err:.3e} vs in-process")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        emit({"phase": "cli_export", "argv": argv,
              "export_wall_s": export_wall_s, "bytes": nbytes,
              "stream_wall_s": stream_wall_s, "stream_line": line,
              "stream_pose_max_abs_err_vs_in_process": err,
              "stream_frames_compared": n, "card": nvidia_smi()})

    # -- 4 ---------------------------------------------------------------
    def offline(self, path, kind, kernel, feature_shape):
        import numpy as np
        from a3gc_tpu_torch.models.pipeline import cascade_apply
        from a3gc_tpu_torch.smpl import ParametricModel
        torch = self.torch
        cfg = self.cascade(kind, "auto")
        params3 = self.params3(cfg)
        model = ParametricModel()
        rng = np.random.default_rng(1)
        imu = torch.as_tensor(rng.normal(size=(1, 300) + feature_shape)
                              .astype(np.float32), device=self.dev)
        self.zero_counts()                            # the batch-1 path
        pose = cascade_apply(params3, cfg, model, imu, device=self.dev)
        counts = self.counts()
        self.launches[path] = counts
        self.check(counts == {k: (6 if k == kernel else 0)
                              for k in LIBRARIES},
                   f"{path} launches {counts} != 6 of {kernel}")
        plain = cascade_apply(params3, self.cascade(kind, "eager"), model,
                              imu, device=self.dev)
        err = float((pose - plain).abs().max())
        finite = bool(torch.isfinite(pose).all())
        self.check(finite and err <= PATH_TOL,
                   f"{path} vs plain path: {err:.3e}, finite={finite}")
        times = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cascade_apply(params3, cfg, model, imu, device=self.dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(times[2:]))
        emit({"phase": path, "batch": 1, "frames": 300, "launches": counts,
              "pose_max_abs_err_vs_plain": err, "ms_median": med,
              "frames_per_s": 300 / (med / 1e3), "card": nvidia_smi()})

    def phase_offline(self):
        self.offline("offline", "a3gc", "gcn_lstm", (N_NODES, 12))

    def phase_offline_tp(self):
        self.offline("offline_tp", "tp", "lstm", (TP_STAGES[0][1],))

    def phase_offline_ggru(self):
        self.offline("offline_ggru", "ggru", "ggru", (N_NODES, 12))

    # -- 4b: evaluation ------------------------------------------------------
    def eval_data(self):
        """The synthetic test set (also as the npz ``cli evaluate`` reads),
        a synthetic SMPL pickle of EVAL_VERTICES vertices loaded onto the
        card, the shipped stats; made once, in a temporary directory."""
        if self._eval is None:
            import tempfile
            import numpy as np
            from a3gc_tpu_torch.data import load_stats
            from a3gc_tpu_torch.smpl import (load_parametric_model,
                                             write_synthetic_smpl_pickle)
            tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
            smpl = write_synthetic_smpl_pickle(
                os.path.join(tmp, "smpl.pkl"), n_vertices=EVAL_VERTICES)
            seqs = eval_sequences()
            npz = os.path.join(tmp, "synthetic_test.npz")
            np.savez(npz, **{f"seq{i}_{k}": v for i, s in enumerate(seqs)
                             for k, v in s.items()})
            self._eval = {"tmp": tmp, "smpl": smpl, "npz": npz,
                          "seqs": seqs, "stats": load_stats(), "tables": {},
                          "model": load_parametric_model(smpl,
                                                         device=self.dev)}
        return self._eval

    def eval_cascade(self, kind, backend="auto"):
        """A cascade of ``kind`` at full width from torch.Generator seed 0,
        its stage 3 emitting near rotations; and its CascadeEvaluator."""
        from a3gc_tpu_torch.eval import CascadeEvaluator
        data = self.eval_data()
        cfg = self.cascade(kind, backend)
        params3 = self.params3(cfg)
        near_rotation_outputs(params3[2])
        return params3, CascadeEvaluator(
            params3, cfg, data["model"], data["stats"], normalize=True,
            device=self.dev)

    def eval_mode(self, ev, run):
        """One protocol, timed: (its [5, 2] table, a record of frames/s,
        the cascade/metrics split, launches by kernel and peak memory)."""
        import numpy as np
        torch = self.torch
        before = self.counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(self.dev)
        mean, seconds, frames = run()[:3]
        peak = torch.cuda.max_memory_allocated(self.dev)
        after = self.counts()
        return mean, {
            "frames": frames, "seconds": seconds,
            "frames_per_s": frames / seconds,
            "cascade_s": ev.split["cascade_s"],
            "metrics_s": ev.split["metrics_s"],
            "launches": {k: after[k] - before[k] for k in after},
            "peak_memory_gib": peak / 2 ** 30,
            "finite": bool(np.isfinite(mean).all()), "table": mean.tolist()}

    def eval_profile(self, run, n_seqs):
        """Device busy share and the top device kernels of ``run()``."""
        try:
            wall_us, rows = self.profile_device(run)
        except Exception as e:     # a measurement aid, not a check
            return f"not measured: the profiler raised {e!r}"
        busy = sum(r[0] for r in rows)
        if busy == 0:
            return "not measured: the profiler recorded no device time"
        return {"sequences": n_seqs, "wall_ms": wall_us / 1e3,
                "device_ms": busy / 1e3, "device_busy_share": busy / wall_us,
                "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                        for us, k, c in rows[:10]]}

    def short_sequences(self):
        """The first two sequences cut to EVAL_SHORT_T frames."""
        return [{k: v[:EVAL_SHORT_T] for k, v in s.items()}
                for s in self.eval_data()["seqs"][:2]]

    def check_launches(self, path, modes, want, kernel):
        for name, n in want.items():
            got = modes[name]["launches"]
            self.check(got == {k: (n if k == kernel else 0) for k in got},
                       f"{path} {name}: launches {got}, want {n} of {kernel}")

    def phase_evaluate(self):
        """CascadeEvaluator at A3GC full width on the synthetic test set:
        per sequence (S = 1, each at its own length), batched at
        --batch_streams 8 and 16 (groups of a length bucket padded to their
        longest), and streaming (W = 60, K = P = 1, 8 slots)."""
        import numpy as np
        torch = self.torch
        data = self.eval_data()
        seqs = data["seqs"]
        lengths = [int(s["ori"].shape[0]) for s in seqs]
        t_phase = time.perf_counter()
        _, ev = self.eval_cascade("a3gc")
        ev.warmup(lengths)
        phase_s = {"setup": time.perf_counter() - t_phase}
        runs = {"per_sequence": lambda: ev.evaluate(seqs)}
        for S in EVAL_STREAMS:
            runs[f"batched_{S}"] = (
                lambda S=S: ev.evaluate_batched(seqs, streams=S))
        runs["streaming"] = lambda: ev.evaluate_streaming(
            seqs, window=WINDOW, lookahead=1, history=1,
            batch_streams=S_SERVE)
        tables, modes = {}, {}
        t0 = time.perf_counter()
        self.zero_counts()                            # the main path starts
        for name, run in runs.items():
            tables[name], modes[name] = self.eval_mode(ev, run)
        counts = self.counts()                        # the main path ended
        self.launches["evaluate"] = counts
        data["tables"].update(tables)
        phase_s["protocols"] = time.perf_counter() - t0

        want = {"per_sequence": 6 * len(seqs)}
        want.update({f"batched_{S}": 6 * n_groups(lengths, S)
                     for S in EVAL_STREAMS})
        self.check_launches("evaluate", modes, want, "gcn_lstm")
        self.check(modes["streaming"]["launches"]["gcn_lstm"] > 0
                   and counts["ggru"] == counts["lstm"] == 0,
                   f"evaluate launches {counts}")
        self.check(all(m["finite"] for m in modes.values()),
                   "evaluate: a table is not finite")
        batched_err = {S: float(np.abs(tables[f"batched_{S}"]
                                       - tables["per_sequence"]).max())
                       for S in EVAL_STREAMS}
        self.check(max(batched_err.values()) <= TABLE_TOL,
                   f"evaluate batched vs per-sequence: {batched_err}")
        # the kernel path against the plain path on two short sequences
        t0 = time.perf_counter()
        short = self.short_sequences()
        _, plain = self.eval_cascade("a3gc", "eager")
        plain_err = float(np.abs(ev.evaluate(short)[0]
                                 - plain.evaluate(short)[0]).max())
        self.check(plain_err <= TABLE_TOL,
                   f"evaluate vs the plain path: {plain_err:.3e}")
        phase_s["plain_path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sub = seqs[:2]          # the profiler's host time grows with events
        profiles = {
            "per_sequence": lambda: ev.evaluate(sub),
            f"batched_{EVAL_STREAMS[0]}": lambda: ev.evaluate_batched(
                sub, streams=EVAL_STREAMS[0]),
            "streaming": lambda: ev.evaluate_streaming(
                sub, window=WINDOW, lookahead=1, history=1,
                batch_streams=S_SERVE)}
        for name, run in profiles.items():
            modes[name]["profile"] = self.eval_profile(run, len(sub))
        phase_s["profiles"] = time.perf_counter() - t0
        emit({"phase": "evaluate", "sequences": len(seqs),
              "lengths": lengths, "frames": sum(lengths),
              "vertices": EVAL_VERTICES, "hidden": [s[0] for s in STAGES],
              "modes": modes, "launches": counts,
              "batched_vs_per_sequence_max_abs_err": batched_err,
              "plain_path_sequences": [EVAL_SHORT_T] * len(short),
              "vs_plain_path_max_abs_err": plain_err, "tol": TABLE_TOL,
              "largest_group": max(n_groups_sizes(lengths)),
              "phase_s": phase_s, "card": nvidia_smi()})

    def phase_evaluate_families(self):
        """The G-GRU and TransPose cascades at full width, batched at S = 8
        on four of the sequences, against their per-sequence tables."""
        import numpy as np
        seqs = self.eval_data()["seqs"][:4]
        lengths = [int(s["ori"].shape[0]) for s in seqs]
        families = {"ggru": "ggru", "tp": "lstm"}
        evs, tables, modes = {}, {}, {}
        for kind in families:
            evs[kind] = self.eval_cascade(kind)[1]
            evs[kind].warmup(lengths)
        self.zero_counts()                            # the main path starts
        for kind, ev in evs.items():
            tables[kind], modes[kind] = self.eval_mode(
                ev, lambda ev=ev: ev.evaluate_batched(seqs, streams=S_SERVE))
        counts = self.counts()                        # the main path ended
        self.launches["evaluate_families"] = counts
        errs = {}
        for kind, kernel in families.items():
            self.check_launches(f"evaluate_families {kind}",
                                {kind: modes[kind]},
                                {kind: 6 * n_groups(lengths, S_SERVE)},
                                kernel)
            errs[kind] = float(np.abs(evs[kind].evaluate(seqs)[0]
                                      - tables[kind]).max())
            self.check(modes[kind]["finite"] and errs[kind] <= TABLE_TOL,
                       f"evaluate_families {kind}: batched vs per-sequence "
                       f"{errs[kind]:.3e}")
        emit({"phase": "evaluate_families", "streams": S_SERVE,
              "lengths": lengths, "modes": modes, "launches": counts,
              "batched_vs_per_sequence_max_abs_err": errs, "tol": TABLE_TOL,
              "card": nvidia_smi()})

    def phase_evaluate_dip(self):
        """DipEvaluator (hidden 512) on the synthetic test set, offline per
        sequence and streaming (W = 60, K = 1, 8 slots)."""
        import numpy as np
        from a3gc_tpu_torch.eval import DipEvaluator
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        data = self.eval_data()
        seqs = data["seqs"]

        def evaluator(backend):
            cfg = self.dip_cfg(backend)
            params = init_pose_net(self.torch.Generator().manual_seed(0),
                                   cfg).to(self.dev)
            return DipEvaluator(near_rotation_outputs(params), cfg,
                                data["model"], data["stats"],
                                device=self.dev)

        ev = evaluator("auto")
        short = self.short_sequences()
        ev.evaluate(short[:1])                        # warm-up
        runs = {"offline": lambda: ev.evaluate(seqs),
                "streaming": lambda: ev.evaluate_streaming(
                    seqs, window=WINDOW, lookahead=1, batch_streams=S_SERVE)}
        tables, modes = {}, {}
        self.zero_counts()                            # the main path starts
        for name, run in runs.items():
            tables[name], modes[name] = self.eval_mode(ev, run)
        counts = self.counts()                        # the main path ended
        self.launches["evaluate_dip"] = counts
        self.check_launches("evaluate_dip", modes,
                            {"offline": 2 * len(seqs)}, "lstm")
        self.check(modes["streaming"]["launches"]["lstm"] > 0
                   and all(m["finite"] for m in modes.values()),
                   f"evaluate_dip: {counts}")
        plain_err = float(np.abs(ev.evaluate(short)[0]
                                 - evaluator("eager").evaluate(short)[0])
                          .max())
        self.check(plain_err <= TABLE_TOL,
                   f"evaluate_dip vs the plain path: {plain_err:.3e}")
        modes["offline"]["profile"] = self.eval_profile(
            lambda: ev.evaluate(seqs[:2]), 2)
        emit({"phase": "evaluate_dip", "hidden": DIP[0], "modes": modes,
              "launches": counts, "vs_plain_path_max_abs_err": plain_err,
              "tol": TABLE_TOL, "card": nvidia_smi()})

    def phase_kernel_eval(self):
        """Each kernel at evaluation lengths against its plain version
        (S = 1, T = 2048 and S = 8, T = 1024, ragged n_valid), then timed at
        S = 1, T = 2048 and S = 16, T = 1024 for the kernels line (the
        plain version, ≈ 1-2 s a call there, is not timed again)."""
        from a3gc_tpu_torch.ops import gcn_lstm as G
        from a3gc_tpu_torch.ops import ggru as GG
        from a3gc_tpu_torch.ops import lstm as LS
        torch = self.torch
        gen = torch.Generator().manual_seed(9)
        graph = [s[0] for s in STAGES]
        cases = [("gcn_lstm", G.bi_gcn_lstm, G.bi_gcn_lstm_reference, graph,
                  lambda H: self.cell(gen, "a3gc", H, H), True, 2,
                  gcn_layer_work, "evaluate"),
                 ("ggru", GG.bi_ggru, GG.bi_ggru_reference, graph,
                  lambda H: self.cell(gen, "ggru", H, H), True, 1,
                  ggru_layer_work, "evaluate_families"),
                 ("lstm", LS.bi_lstm, LS.bi_lstm_reference,
                  [s[0] for s in TP_STAGES] + [DIP[0]],
                  lambda H: self.lstm_layer(gen, H, H), False, 2,
                  lstm_layer_work, None)]
        rows = []
        for (name, kernel_fn, plain_fn, widths, make, nodes, n_state, work,
             path) in cases:
            for H in widths:
                p = make(H)
                for S, T in EVAL_KERNEL_SHAPES:
                    nv = ragged_long(S, T)
                    args = self.layer_inputs(gen, S, T, H, H, nv,
                                             nodes=nodes, n_state=n_state)
                    errs, ok = self.compare_layer(
                        name, f"eval H={H} S={S} T={T}", kernel_fn,
                        plain_fn, (p,) + args)
                    rows.append({"kernel": name, "H": H, "F": H, "S": S,
                                 "T": T, "n_valid": nv, "y": errs[0],
                                 "state": max(errs[1:]), "ok": ok})
                for S, T in EVAL_TIMED_SHAPES:
                    x, st, nv = self.layer_inputs(gen, S, T, H, H, [T] * S,
                                                  nodes=nodes,
                                                  n_state=n_state)
                    library = None
                    if name == "lstm":
                        with torch.no_grad():
                            out = LS.bi_lstm(p, x, st)
                        library = self.cudnn_lstm(p, x, st, kernel_out=out)
                    self.time_layer(
                        name, path or ("evaluate_dip" if H == DIP[0]
                                       else "evaluate_families"),
                        S, H, H, p, (x, st, nv), work, library=library,
                        reps=3, plain_reps=0)
        emit({"phase": "kernel_eval", "tol": KERNEL_TOL,
              "max_abs_err": max(r["y"] for r in rows),
              "max_abs_err_state": max(r["state"] for r in rows),
              "n_cases": len(rows), "all_ok": all(r["ok"] for r in rows),
              "cases": rows})

    def phase_cli_evaluate(self):
        """``python -m a3gc_tpu_torch.cli evaluate --model a3gc --norm --smpl
        <pickle> --batch_streams 8 --datasets <npz>`` as a subprocess, on
        the evaluate phase's params written as reference ``.tar``
        checkpoints; its report against the in-process batched table."""
        import shutil
        import tempfile
        import numpy as np
        from a3gc_tpu_torch.compat import torch_export as TE
        data = self.eval_data()
        params3, _ = self.eval_cascade("a3gc")
        cwd = tempfile.mkdtemp(prefix="chip_smoke_cli_eval_")
        try:
            tars = []
            for i, p in enumerate(params3):
                tars.append(os.path.join(cwd, f"s{i + 1}.tar"))
                TE.save_torch_checkpoint(tars[-1],
                                         TE.graph_net_state_dict(p, "a3gc"))
            argv = ["evaluate", "--model", "a3gc", "--norm", "--smpl",
                    data["smpl"], "--batch_streams", str(S_SERVE),
                    "--datasets", data["npz"], "--torch_checkpoints"] + tars
            env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "a3gc_tpu_torch.cli"] + argv, cwd=cwd,
                env=env, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            report = os.path.join(
                cwd, "evaluation_results",
                f"a3gc_{os.path.basename(data['npz'])}.txt")
            ok = proc.returncode == 0 and os.path.isfile(report)
            self.check(ok, f"cli evaluate exited {proc.returncode}:\n"
                       + proc.stderr[-3000:])
            if not ok:
                return
            got = np.asarray(report_table(report))
        finally:
            shutil.rmtree(cwd, ignore_errors=True)
        want = data["tables"][f"batched_{S_SERVE}"]
        err = float(np.abs(got - want).max())
        self.check(err <= REPORT_TOL,
                   f"cli evaluate report vs in-process: {err:.3e}")
        line = [l for l in proc.stdout.splitlines() if l.startswith("== ")]
        emit({"phase": "cli_evaluate", "argv": argv[:6] + ["..."],
              "wall_s": wall, "summary": line, "report_table": got.tolist(),
              "report_max_abs_err_vs_in_process": err, "tol": REPORT_TOL,
              "card": nvidia_smi()})

    def cleanup(self):
        if self._eval is not None:
            import shutil
            shutil.rmtree(self._eval["tmp"], ignore_errors=True)

    # -- 5 ---------------------------------------------------------------
    def plan_record(self, name, S, H, D=2):
        """The launch plan of a weight-stationary kernel at this shape, with
        how many of its groups the card holds at once (``lstm``: of D
        directions)."""
        if name == "lstm":
            from a3gc_tpu_torch.ops import lstm as LS
            from a3gc_tpu_torch.ops._common import sm_count
            plan = LS.launch_plan(S, H, sm_count(0), D=D)
            rec = {"D": D, "P": plan.P, "R": plan.R, "KS": plan.KS,
                   "groups": plan.groups, "cooperative": plan.cooperative,
                   "max_active": LS.max_active(plan, S, H)}
        elif name == "gcn_lstm":
            from a3gc_tpu_torch.ops import gcn_lstm as G
            plan = G.launch_plan(N_NODES, H, True)
            rec = {"C": plan.C, "KS": plan.KS, "KSA": plan.KSA,
                   "KSQ": plan.KSQ, "groups": 2 * S,
                   "max_active": G.max_active(plan, S, N_NODES, H, True)}
        else:
            from a3gc_tpu_torch.ops import ggru as GG
            plan = GG.launch_plan(S, N_NODES, H)
            rec = {"C": plan.C, "KS": plan.KS, "groups": 2 * S,
                   "max_active": GG.max_active(plan, S, N_NODES, H)}
        rec.update(cluster=plan.cluster, smem=plan.smem,
                   ctas=(plan.ctas if name == "lstm" else 2 * S * plan.C))
        return rec

    def time_layer(self, name, path, S, F, H, layer, args, work,
                   library=None, reps=20, plain_reps=3):
        mod = importlib.import_module(f"a3gc_tpu_torch.ops.{name}")
        torch = self.torch
        T = args[0].shape[1]
        with torch.no_grad():
            scan_args = mod.scan_inputs(layer, *args)
            # in turns (kernel, library, library, kernel): the card's clock
            # and its neighbours move every timed call alike
            calls = {"ms": lambda: self.wrappers[name](layer, *args),
                     "scan_ms": lambda: mod.scan(*scan_args)}
            if library is not None:
                calls["library_ms"] = library
            order = list(calls) + list(reversed(calls))
            times = {k: 0.0 for k in calls}
            for k in order:
                times[k] += cuda_ms(calls[k], reps) / 2
            plain = getattr(mod, f"bi_{name}_reference")
            plain_ms = (cuda_ms(lambda: plain(layer, *args), plain_reps,
                                warmup=int(plain_reps > 1))
                        if plain_reps else None)
        D = 2
        if name == "lstm":
            from a3gc_tpu_torch.ops import lstm as LS
            D = LS.directions(layer)
        b_ms, b_by = bound(*work(S, T, F, H, True))
        sb_ms, sb_by = bound(*work(S, T, F, H, False))
        self.shapes[name].append({
            "path": path, "S": S, "T": T, "H": H, "F": F, "ms": times["ms"],
            "scan_ms": times["scan_ms"], "plain_ms": plain_ms,
            "library_ms": times.get("library_ms"),
            "bound_ms": b_ms, "bound_by": b_by, "scan_bound_ms": sb_ms,
            "scan_bound_by": sb_by, "plan": self.plan_record(name, S, H, D)})

    def cudnn_lstm(self, p, x, st, kernel_out=None):
        """cuDNN's torch.nn.LSTM on the layer's weights (one direction or
        two, as the layer has), checked against the plain version at
        n_valid = T (or against ``kernel_out``, the kernel's output there,
        where the plain version is too slow to run again); returns the call
        to time."""
        from a3gc_tpu_torch.ops import lstm as LS
        torch = self.torch
        D = LS.directions(p)
        H = p.w_hh.shape[-2]
        F = p.w_ih.shape[-2]
        mod = torch.nn.LSTM(F, H, bidirectional=D == 2,
                            batch_first=True).to(self.dev)
        with torch.no_grad():
            for d, suffix in enumerate(("", "_reverse")[:D]):
                w = {k: (v[d] if D == 2 else v)
                     for k, v in p.named_parameters()}
                getattr(mod, "weight_ih_l0" + suffix).copy_(w["w_ih"].T)
                getattr(mod, "weight_hh_l0" + suffix).copy_(w["w_hh"].T)
                getattr(mod, "bias_ih_l0" + suffix).copy_(w["b_ih"])
                getattr(mod, "bias_hh_l0" + suffix).copy_(w["b_hh"])
            # torch.nn.LSTM's state is [D, S, H] either way
            cst = st if D == 2 else tuple(t[None] for t in st)
            got = mod(x, cst)
            want = (LS.bi_lstm_reference(p, x, st) if kernel_out is None
                    else kernel_out)
        torch.cuda.synchronize()
        err = max(float((a.reshape(b.shape) - b).abs().max())
                  for a, b in zip(leaves(got), leaves(want)))
        self.check(err <= KERNEL_TOL,
                   f"cuDNN LSTM vs {'plain' if kernel_out is None else 'kernel'}"
                   f" H={H} F={F} D={D} T={x.shape[1]}: {err:.3e}")
        return lambda: mod(x, cst)

    def phase_times(self):
        torch = self.torch
        gen = torch.Generator().manual_seed(2)
        T = WINDOW
        for S in (S_SERVE, 1):
            full = [T] * S
            for H, _, _, _ in STAGES:
                for F in (H, 2 * H):
                    p = self.cell(gen, "a3gc", F, H)
                    x, st, nv = self.layer_inputs(gen, S, T, F, H, full)
                    self.time_layer("gcn_lstm", "serving", S, F, H, p,
                                    (x, st, nv), gcn_layer_work)
                    p = self.cell(gen, "ggru", F, H)
                    x, h, nv = self.layer_inputs(gen, S, T, F, H, full,
                                                 n_state=1)
                    self.time_layer("ggru", "serving_ggru", S, F, H, p,
                                    (x, h, nv), ggru_layer_work)
            lstm_paths = [("serving_tp", H) for H, _, _, _ in TP_STAGES]
            lstm_paths.append(("serving_dip", DIP[0]))
            for path, H in lstm_paths:
                for F in (H, 2 * H):
                    p = self.lstm_layer(gen, F, H)
                    x, st, nv = self.layer_inputs(gen, S, T, F, H, full,
                                                  nodes=False)
                    self.time_layer("lstm", path, S, F, H, p, (x, st, nv),
                                    lstm_layer_work,
                                    library=self.cudnn_lstm(p, x, st))
        # the emission passes of the buffered ticks: (P+K+1)·W frames
        S = S_SERVE
        for H, _, _, _ in STAGES:
            for F in (H, 2 * H):
                p = self.cell(gen, "a3gc", F, H)
                x, st, nv = self.layer_inputs(gen, S, 180, F, H, [180] * S)
                self.time_layer("gcn_lstm", "buffered", S, F, H, p,
                                (x, st, nv), gcn_layer_work)
        # the G-GRU bundle's K = P = 1 emission passes (T = 180 steady,
        # 120 warming up)
        for T in (180, 120):
            for H, _, _, _ in STAGES:
                for F in (H, 2 * H):
                    p = self.cell(gen, "ggru", F, H)
                    x, h, nv = self.layer_inputs(gen, S, T, F, H, [T] * S,
                                                 n_state=1)
                    self.time_layer("ggru", "export_bundle", S, F, H, p,
                                    (x, h, nv), ggru_layer_work)
        H = DIP[0]
        for F in (H, 2 * H):
            p = self.lstm_layer(gen, F, H)
            x, st, nv = self.layer_inputs(gen, S, 120, F, H, [120] * S,
                                          nodes=False)
            self.time_layer("lstm", "buffered_dip", S, F, H, p, (x, st, nv),
                            lstm_layer_work,
                            library=self.cudnn_lstm(p, x, st))
        # the unidirectional DIP net: two layers of F = H, one direction,
        # against cuDNN's torch.nn.LSTM(bidirectional=False)
        for S in (S_SERVE, 1):
            for _ in range(2):
                p = self.lstm_layer(gen, H, H, D=1)
                x, st, nv = self.layer_inputs(gen, S, WINDOW, H, H,
                                              [WINDOW] * S, nodes=False, D=1)
                self.time_layer("lstm", "serving_dip_uni", S, H, H, p,
                                (x, st, nv), uni_lstm_layer_work,
                                library=self.cudnn_lstm(p, x, st))

    def kernels_line(self):
        meta = {
            "gcn_lstm": ("a3gc_tpu/ops/pallas_gcn_lstm.py:92 (_kernel), "
                         "a3gc_tpu/ops/pallas_gcn_lstm.py:705 "
                         "(_dirfused_kernel)",
                         ("serving", "buffered", "http", "checkpoints",
                          "evaluate", "export", "export_bundle"),
                         gcn_layer_work,
                         "the six layer calls of one A3GC serving window "
                         "(3 stages x rnn1/rnn2, S=8, T=60), bi_gcn_lstm "
                         "including its hoisted input projection",
                         "no PyTorch call mixes a per-gate graph adjacency "
                         "and joint attention into an LSTM recurrence"),
            "ggru": ("a3gc_tpu/ops/pallas_gcn_lstm.py:412 (_ggru_kernel)",
                     ("serving_ggru", "checkpoints", "evaluate_families",
                      "export", "export_bundle"),
                     ggru_layer_work,
                     "the six layer calls of one G-GRU serving window "
                     "(3 stages x rnn1/rnn2, S=8, T=60), bi_ggru including "
                     "its hoisted input projection",
                     "no PyTorch call mixes a graph message into a GRU "
                     "recurrence"),
            "lstm": ("a3gc_tpu/ops/pallas_gcn_lstm.py:580 (_lstm_kernel)",
                     ("serving_tp", "serving_dip", "buffered_dip",
                      "http_dip", "serving_dip_uni", "buffered_dip_uni",
                      "checkpoints", "evaluate_families", "evaluate_dip",
                      "export"),
                     lstm_layer_work,
                     "the six layer calls of one TransPose serving window "
                     "plus the two of one DIP serving window plus the two "
                     "of one unidirectional DIP serving window (D=1) (S=8, "
                     "T=60), bi_lstm including its hoisted input "
                     "projection; library: cuDNN torch.nn.LSTM on the same "
                     "weights, as many directions",
                     None),
        }
        entries = []
        for name, (replaces, paths, work, timed, no_lib) in meta.items():
            main = [r for r in self.shapes[name]
                    if r["S"] == S_SERVE and r["T"] == WINDOW]
            works = [(uni_lstm_layer_work if r["plan"].get("D") == 1
                      else work)(r["S"], r["T"], r["F"], r["H"], True)
                     for r in main]
            flop = sum(w[0] for w in works)
            nbytes = sum(w[1] for w in works)
            lib = [r["library_ms"] for r in main]
            entry = {
                "name": name, "route": "cuda",
                "source": f"a3gc_tpu_torch/ops/csrc/{name}.cu",
                "replaces": replaces,
                "launches": sum(self.launches[p][name] for p in paths),
                "launches_by_path": {p: self.launches[p][name]
                                     for p in paths},
                "max_abs_err": self.max_err[name],
                "ms": sum(r["ms"] for r in main),
                "plain_ms": sum(r["plain_ms"] for r in main),
                "bound_ms": sum(r["bound_ms"] for r in main),
                "bound_by": bound(flop, nbytes)[1],
                "library_ms": (sum(lib) if lib and None not in lib
                               else None),
                "timed": timed, "per_shape": self.shapes[name],
                "card": nvidia_smi()}
            if no_lib:
                entry["library_note"] = no_lib
            entries.append(entry)
        emit({"kernels": entries})


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "a card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "a3gc_tpu_torch", "ops", "csrc")):
        print("chip_smoke: run from a checkout of the repository (the "
              "a3gc_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smoke = Smoke()
    phases = (smoke.phase_device, smoke.phase_kernel,
              smoke.phase_kernel_ggru, smoke.phase_kernel_lstm,
              smoke.phase_kernel_lstm_uni, smoke.phase_kernel_long,
              smoke.phase_serving, smoke.phase_serving_ggru,
              smoke.phase_serving_tp, smoke.phase_serving_dip,
              smoke.phase_serving_dip_uni,
              smoke.phase_buffered, smoke.phase_buffered_dip,
              smoke.phase_http, smoke.phase_http_dip, smoke.phase_cli_serve,
              smoke.phase_checkpoints, smoke.phase_cli_serve_checkpoints,
              smoke.phase_export, smoke.phase_export_bundle,
              smoke.phase_cli_export,
              smoke.phase_offline, smoke.phase_offline_tp,
              smoke.phase_offline_ggru, smoke.phase_evaluate,
              smoke.phase_evaluate_families, smoke.phase_evaluate_dip,
              smoke.phase_kernel_eval, smoke.phase_cli_evaluate,
              smoke.phase_times)
    try:
        seconds = {}
        for phase in phases:
            t1 = time.perf_counter()
            try:
                phase()
            except Exception:
                smoke.failures.append(f"{phase.__name__} raised:\n"
                                      + traceback.format_exc())
                if phase is smoke.phase_device:
                    break
            finally:
                seconds[phase.__name__[6:]] = time.perf_counter() - t1
    finally:
        smoke.cleanup()
    emit({"phase_seconds": seconds})
    if all(smoke.shapes.values()) and len(smoke.launches) == N_PATHS:
        smoke.kernels_line()
    banned = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "a3gc_tpu"))
    if banned:
        smoke.failures.append(f"imported {banned}")
    if smoke.failures:
        for f in smoke.failures:
            print("FAILED: " + f, file=sys.stderr)
        return 1
    print(f"total_s {time.perf_counter() - t0:.1f}")
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
