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
                    ms/window. The A3GC cascade (hidden 256/64/128), then
                    one of its windows under the NaN check of
                    ``--debug_nans`` (``serving_debug_nans``): bit-equal to
                    the window without it, and with a NaN in stage 1's
                    recurrent weight ``FloatingPointError`` naming the
                    kernel op ``a3gc_tpu_torch::gcn_lstm_scan``;
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
     precision    — a net's precision="default" on the card (TF32
                    operands, fp32 sums): each kernel's TF32 instantiation
                    against its plain version at "tf32" (``gcn_lstm`` at
                    S = 8 and 1, H = 256 / 64 / 128 with attention;
                    ``ggru`` at S = 8; ``lstm`` at H = 256 and 512, D = 2
                    and 1; ragged n_valid, an idle stream) within 8.05e-3,
                    the delta to the fp32 kernel, both kernels' times in
                    turns; the A3GC cascade at S = 1, T = 2048 (random
                    weights, stage 3 near rotations): kernel against plain
                    at "default" in degrees within JAX's own Pallas-vs-XLA
                    0.034 mean / 0.335 max, "default" against "highest"
                    within 0.1 on the mean; each command's format from its
                    parsed argv (train fp32, evaluate / stream / export /
                    serve TF32, ``--precision`` either way); ``cli
                    _build_server`` at its default for A3GC, G-GRU and
                    TransPose and the export command's DIP loader, one
                    window each, every launch a TF32 one (the main path of
                    the TF32 rows); the TF32 rows' times at the serving
                    window's shapes;
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
                    balanced --precision highest`` as a subprocess (the
                    CLI children held to fp32 results in process take
                    ``--precision highest``: their own inference default
                    is TF32 on the card, the precision phase's), two clients, a
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
     mesh         — the data-parallel entry points (``a3gc_tpu_torch.
                    parallel``) at A3GC full width on a one-card mesh and
                    on the card listed twice (two shards in turn):
                    ``cascade_apply_sharded`` at S = 8, T = 300 (bit-equal
                    on one card, within 1e-3 on two, 6 launches a shard),
                    a 2-shard ``StreamingCascade(lookahead=1, history=1)``
                    (6 ticks, an idle slot, a reset, ``flush``) and
                    ``CascadeEvaluator.evaluate_batched`` at 8 streams
                    against unsharded twins, ``PoseServer(mesh=)`` with two
                    clients and ``/v1/recycle`` refused; ms per steady
                    tick sharded and unsharded, in turns; three ``cli
                    train`` children at once (8 x 300 frames, B = 8): no
                    mesh, ``--mesh``, ``--coordinator`` (NCCL, one
                    process), their losses and checkpoints bit-equal;
     kernel_eval  — each kernel against its plain version at S = 1,
                    T = 2048 and S = 8, T = 1024 with ragged n_valid, then
                    timed at S = 1, T = 2048 and S = 16, T = 1024 (``lstm``
                    beside cuDNN);
     cli_evaluate — ``python -m a3gc_tpu_torch.cli evaluate --model a3gc
                    --norm --smpl <pickle> --batch_streams 8 --datasets
                    <npz> --profile <dir> --compilation_cache <fresh dir>``
                    in a child counting the launches, on the evaluate
                    phase's params as ``.tar`` checkpoints; its report
                    against the in-process table; the trace's ``gcn_lstm``
                    kernel events against the launches, the kernel op and
                    the spans in it; the library built into the fresh
                    directory;
     preprocess   — the data factory on the card (``process_amass_split``
                    with the mirror, ``process_dipimu`` train / valid /
                    test, ``process_totalcapture``) on raw corpora written
                    in their on-disk layouts at recording sizes (AMASS:
                    four 120 fps sequences of 2,400-9,600 raw frames, one
                    at 60 fps, one at 100 fps that is skipped; DIP-IMU: two
                    subjects, 2,000-4,000 frames, NaN bursts; TotalCapture:
                    three of 3,000-6,000 frames and one of the faulty
                    3,560), a synthetic SMPL body of 6890 vertices with the
                    real sensor masks: chunk counts and shapes, the packed
                    AMASS chunks through ``StageRunner(1).eval_epoch``
                    (A3GC H = 256, B = 16; 2 launches a batch) against the
                    same pass on the plain path (the loss, the stage's
                    outputs on one batch), one sequence per corpus cut to
                    600 frames against the CPU,
                    frames/s, the device part's frames/s, peak memory, the
                    device's busy share over one AMASS sequence;
     cli_data     — ``cli preprocess --dataset dipimu --split test`` as a
                    subprocess against the factory in process; ``cli
                    evaluate --save_preds`` on its npz with two parameter
                    sets (children counting the launches), the first
                    set's dumped poses against the plain path in process;
                    ``cli worst-frames`` on their dumps against
                    ``compare_models`` in process (the 18-pickle layout,
                    the printed selections); ``cli convert-data`` on both
                    reference layouts against ``np.load``;
  5. kernel_grad  — gradients through each kernel op (the kernel's forward,
                    the plain version's backward) against autograd through
                    its plain version, S = 8, T = 60, ragged n_valid:
                    ``gcn_lstm`` and ``ggru`` at H = 256, 64, 128,
                    ``lstm`` at H = 256 and 512, D = 2 and 1; max |d| over
                    max |g| per leaf within 1e-5;
     train        — ``python -m a3gc_tpu_torch.cli train --model a3gc -b 16
                    --epochs 1 --hu1 256 --hu2 64 --hu3 128 --norm`` on a
                    synthetic packed set (16 × 300 frames train, 16
                    valid) in a child process that counts the kernel
                    launches (validation, 2 a stage), and at once ``--model
                    dip --hu1 512`` (``train_dip``): three stages (one)
                    with finite losses in ``train_log.jsonl``, their
                    checkpoints discoverable;
     train_times  — training frames/s (B·T·steps over the seconds of the
                    steps, fenced by ``torch.cuda.synchronize()``) of
                    stages 1-3 of A3GC and stage 1 of G-GRU and TransPose,
                    and of DIP at H = 512, at B = 16, T = 150, fp32 (and
                    bf16 for A3GC stage 1 and DIP), with peak memory and
                    one validation chunk's time through the kernels; one
                    step of A3GC stage 1 at
                    B = 16 under torch.profiler (device busy, kernels);
     tp           — tensor parallelism (``a3gc_tpu_torch.parallel``
                    ``param_sharding`` / ``shard_params``): TP
                    ``StageRunner``s on a model group of two (the card
                    listed twice, the members in turn) and on a (2, 2)
                    mesh against unsharded twins, A3GC stage 1 at H = 256,
                    B = 8, T = 300, default dropout and noise: losses and
                    parameters within 1e-4, gradients within 1e-5, ms per
                    step in turns; G-GRU and TransPose stage 1 a step
                    each; DIP on the model = 2 mesh bit-equal; validation
                    (16 x 300) through the kernels on the gathered weights
                    against the unsharded and plain paths; a 60-frame step
                    of each under torch.profiler; ``cli train --tp 2``
                    exits with JAX's message on one card;
     graft_entry  — the driver entry points (``a3gc_tpu_torch.
                    graft_entry``): ``entry()`` (A3GC 256 / 64 / 128,
                    S = 1, T = 300, "default": six TF32 ``gcn_lstm``
                    launches) against the same cascade at backend="eager"
                    within 0.034 / 0.335 deg, its ``torch.export`` check,
                    ``dryrun_multichip(8)`` over the card listed 8 times;
                    then widths with no launch plan (A3GC H = 80, G-GRU
                    H = 152, the TransPose LSTM H = 268 at S = 8, all at
                    "default"): backend="auto" bit-equal to "eager" with
                    no launch and the layer calls counted as plain
                    dispatches, backend="cuda" raising, one ``cli
                    _build_server`` window at ``--hu1 80`` and a ``cli
                    export --hu1 80 --precision highest`` artifact (its
                    stage 1 the plain scan's op) stepped against the live
                    session;
  6. kernels      — the ``{"kernels": [...]}`` line: launches on each
                    kernel's serving, evaluation and training paths, max
                    |d| of the kernel phases and of the gradient checks,
                    and per
                    layer shape of those paths (S = 8 and 1, T = 60; S = 8
                    at the buffered ticks' T = 180 and 120, ``gcn_lstm``
                    and ``ggru``) the
                    launch plan (split, cluster or cooperative, CTAs,
                    shared memory, groups the card holds at once), the
                    wrapper's, the kernel's and the plain version's times
                    (CUDA events) beside their bounds, and for ``lstm``
                    cuDNN's ``torch.nn.LSTM`` on the same weights, timed in
                    turns with the kernel (kernel, cuDNN, cuDNN, kernel);
                    then the same for each TF32 instantiation
                    (``<name>_tf32``): its launches on the precision
                    phase's serving at "default", its max |d| there, its
                    rows at the serving window's shapes, bound by the TF32
                    tensor cores' 495 TFLOP/s.
A line of the seconds each phase took precedes the kernels line. The line
before the last is the card's name and power limit; the last is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that line; so does a machine without CUDA or a directory without the
package. Imports nothing of JAX or of the JAX package.
"""

import contextlib
import glob
import importlib
import json
import os
import subprocess
import sys
import time
import traceback

from portbench.families.ggru import ggru_layer_work
from portbench.work import (PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, bound_seconds,
                            layer_work, lstm_layer_work)

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNEL_TOL = 1e-5           # fp32, sums reordered over a 60-step recurrence
                            # (an H100 showed at most 2.1e-7 for gcn_lstm)
PATH_TOL = 1e-3             # poses after three stages and IK
# the precision phase: a net's precision="default" on the card, TF32
# operands with fp32 sums in the kernels' TF32 instantiations and in the
# plain versions. A kernel there against its plain version on the same
# inputs: PREC_KERNEL_TOL, the JAX package's own Pallas kernels at
# "default" against XLA (KERNEL_CHECK.json, A3GC stage 3, S = 1, 512
# frames; a TF32 operand is 8x finer than the TPU's bf16 one). The A3GC
# cascade at S = 1, PREC_T frames: the kernel path against the plain path
# at "default" within JAX's own Pallas-vs-XLA pose angle there (mean, max
# in degrees, KERNEL_CHECK.json), "default" against "highest" within the
# 0.1 deg parity budget of the JAX CLI's inference default (a3gc_tpu/cli.py
# _stage_configs) on the mean. PREC_KERNEL_TOL alone would pass a kernel
# that ignored its TF32 flag (the formats are 3-7e-4 apart), so each kernel
# is also held near the plain version at "tf32" by the measure that tells
# the formats apart: rms(kernel - plain at "tf32") at most PREC_SEP_* times
# rms(plain at "fp32" - plain at "tf32"), which the fp32 kernel in its place
# must exceed. Root mean square, not max: reordered fp32 sums flip a few
# TF32 roundings, each a whole TF32 step of one operand, which a max
# shows (0.4-0.55 of the formats' max gap in a CPU emulation at these
# shapes) and a mean dilutes. Over one frame (PREC_SEP_FRAME) a flip has
# no recurrence to grow in: the emulation gave at most 0.06 there and 0.27
# over a window (PREC_SEP_WINDOW), the fp32 kernel 1.0 in both, and
# operands rounded at other points than the plain version's (ggru.cu's
# folded fp32 order) 0.37-0.39 over one frame but 0.29-0.33 over four
# (tests/test_torch_port_precision.py): the frame is the sharp check
PREC_KERNEL_TOL = 8.05e-3
PREC_SEP_FRAME, PREC_SEP_WINDOW = 0.15, 0.5
PREC_ANGLE_MEAN, PREC_ANGLE_MAX = 0.034, 0.335
PREC_PARITY_MEAN = 0.1
PREC_T = 2048
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
# three evaluation phases, the two of the deployment artifacts (export:
# counted by the fresh process that steps them), the two of data
# preparation (cli_data: counted by the cli evaluate child processes), the
# two of training (counted by the cli train child process), the mesh and
# tensor parallelism, the TF32 serving of the precision phase, and the
# driver entry points (graft_entry)
N_PATHS = 27
# the graft_entry phase: hidden widths the kernels have no launch plan for
# (backend="auto" runs the plain version there): the A3GC cell, the G-GRU
# cell at "default" (TF32; fp32 plans it) and the TransPose LSTM at S = 8;
# dryrun_multichip's mesh of the card listed GRAFT_DEVICES times
GRAFT_UNPLANNED = (("a3gc", 80), ("ggru", 152), ("tp", 268))
GRAFT_DEVICES = 8
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
# training: a synthetic packed corpus of TRAIN_SEQS (valid: VALID_SEQS)
# sequences of TRAIN_T frames (the reference's chunk length), the
# reference protocol's batch; timed at TRAIN_TIMED_B, TRAIN_TIMED_STEPS
# steps (a warm-up step first at each net's first row)
TRAIN_SEQS, VALID_SEQS, TRAIN_T, TRAIN_B = 16, 16, 300, 16
TRAIN_TIMED_B = (16,)       # one batch size: a depth cut for the time
TRAIN_TIMED_T = 150         # frames of the timed steps (a depth cut for the
                            # precision phase's time: 300 until it came;
                            # the steps are host-bound frame by frame)
# the nets timed in bf16 too (the others in fp32 only: a depth cut)
TRAIN_BF16_NETS = (("a3gc", 1), ("dip", 1))
TRAIN_TIMED_STEPS = 1
GRAD_TOL = 1e-5             # gradient max |d| over max |g| of each leaf
# the tp phase: tensor-parallel runners on a model group of two (the card
# listed twice) against unsharded ones, TPAR_SEQS x TRAIN_T frames (two
# validation chunks of TPAR_B), steps at B = TPAR_B; one step profiled at
# TPAR_PROFILE_T frames
TPAR_SEQS, TPAR_B, TPAR_PROFILE_T = 16, 8, 60
# the mesh phase's three cli train children: one epoch of MESH_TRAIN_SEQS
# (valid: MESH_VALID_SEQS, one validation chunk a stage) at MESH_TRAIN_B
# (8: one step a stage; 16 until the tp phase came, a cut for the time)
MESH_TRAIN_SEQS, MESH_VALID_SEQS, MESH_TRAIN_B = 8, 8, 8

# data preparation: raw corpora in their on-disk layouts at the sizes of
# recordings, processed on the card with a synthetic SMPL body of SMPL's
# vertex count and the real sensor masks. AMASS: (dataset, subject, name,
# raw frames, frame rate; 100 fps is skipped); DIP-IMU: (subject, motion,
# frames, NaN bursts; s_01_05 is the valid split, s_09 a test subject);
# TotalCapture: (name, frames; 3560 is the faulty length, dropped)
PREP_AMASS = (("CMU", "01", "01_01", 2400, 120),
              ("CMU", "02", "02_04", 4800, 120),
              ("KIT", "3", "walking_run01", 7200, 120),
              ("KIT", "5", "dance02", 9600, 120),
              ("CMU", "07", "07_05", 3000, 60),
              ("KIT", "9", "jump03", 3000, 100))
PREP_DIP = (("s_01", "01", 3000, True), ("s_01", "05", 2000, True),
            ("s_09", "01", 4000, True), ("s_09", "02", 2500, False))
PREP_TC = (("s1_acting1", 3000), ("s2_freestyle1", 4500),
           ("s3_walking2", 6000), ("s4_rom3", 3560))
PREP_CUT = 600              # frames of the sequences held against the CPU
PREP_B = 16                 # eval_epoch batch over the packed AMASS chunks
# the factory's tolerances, card against CPU: normalized accelerations
# (the finite difference scales the positions' rounding by up to
# 3600 / 30); rotations, positions, poses
PREP_TOL = {"acc": 1e-4}
PREP_POS_TOL = 1e-5
# stage 1 on the factory's chunks, the kernels against the plain path: its
# outputs (two 300-frame graph layers and the readout) and the loss
# (relative)
STAGE_TOL = 1e-4

# the train phase's child: ``python -m a3gc_tpu_torch.cli <argv>`` through
# runpy, then one JSON line of the kernel launches it made (validation)
TRAIN_CHILD = r"""
import json, runpy, sys
from a3gc_tpu_torch.ops import gcn_lstm, ggru, lstm
sys.argv = ["a3gc_tpu_torch.cli"] + sys.argv[1:]
try:
    runpy.run_module("a3gc_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    if e.code not in (0, None):
        raise
print(json.dumps({"launches": {"gcn_lstm": gcn_lstm.bi_gcn_lstm.launches,
                               "ggru": ggru.bi_ggru.launches,
                               "lstm": lstm.bi_lstm.launches},
                  "banned": sorted(m for m in sys.modules
                                   if m.split(".")[0] in (
                                       "jax", "jaxlib", "flax",
                                       "a3gc_tpu"))}))
"""

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


def gcn_layer_work(S, T, F, H, hoist):
    """layer_work of the a3gc cell, the one the serving path runs."""
    return layer_work(S, T, F, H, True, hoist)


def uni_lstm_layer_work(S, T, F, H, hoist):
    """lstm_layer_work of one direction."""
    return lstm_layer_work(S, T, F, H, hoist, D=1)


def bound(flop, nbytes, peak=PEAK_FP32_FLOPS):
    ms = bound_seconds(flop, nbytes, peak) * 1e3
    return ms, ("operations" if flop / peak * 1e3 >= ms else "bytes")


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


def write_prep_corpora(paths, seed=0):
    """The raw corpora of PREP_AMASS, PREP_DIP and PREP_TC under the data
    root of ``paths`` (an ``a3gc_tpu_torch.config.Paths``), in their
    layouts: AMASS ``<ds>/<ds>/<subject>/<name>_poses.npz`` (poses [T, 156]
    of smooth motion: each angle a 0.3-1.5 Hz sinusoid about a random pose;
    trans a random walk; betas [16]; mocap_framerate), DIP-IMU
    ``<subject>/<motion>.pkl`` (imu_acc [T, 17, 3], imu_ori [T, 17, 3, 3],
    gt [T, 72]), TotalCapture ``<name>.pkl`` (ori [T, 6, 3, 3], acc
    [T + 2, 6, 3], gt [T, 72])."""
    import pickle
    import numpy as np
    rng = np.random.default_rng(seed)
    amass = paths.resolve(paths.raw_amass_dir)
    for ds, subject, name, T, fps in PREP_AMASS:
        d = os.path.join(amass, ds, ds, subject)
        os.makedirs(d, exist_ok=True)
        base = rng.normal(scale=0.3, size=156)
        freq = rng.uniform(0.3, 1.5, size=156)
        phase = rng.uniform(0, 2 * np.pi, size=156)
        t = np.arange(T)[:, None] / float(fps)
        np.savez(os.path.join(d, f"{name}_poses.npz"),
                 poses=base + 0.3 * np.sin(2 * np.pi * freq * t + phase),
                 trans=np.cumsum(rng.normal(scale=0.005, size=(T, 3)), 0),
                 betas=rng.normal(scale=0.5, size=16),
                 mocap_framerate=np.array(float(fps)))

    def gt(T):
        return rng.normal(scale=0.3, size=(T, 72))

    dip = paths.resolve(paths.raw_dipimu_dir)
    for subject, motion, T, nans in PREP_DIP:
        os.makedirs(os.path.join(dip, subject), exist_ok=True)
        acc = rng.normal(size=(T, 17, 3))
        ori = random_rotations(rng, (T, 17)).reshape(T, 17, 3, 3)
        if nans:
            acc[100:104, 7] = np.nan
            ori[T // 2:T // 2 + 3, 11] = np.nan
            acc[-9:-7, 2] = np.nan
        with open(os.path.join(dip, subject, f"{motion}.pkl"), "wb") as f:
            pickle.dump({"imu_acc": acc, "imu_ori": ori, "gt": gt(T)}, f)
    tc = paths.resolve(paths.raw_totalcapture_dir)
    os.makedirs(tc, exist_ok=True)
    for name, T in PREP_TC:
        with open(os.path.join(tc, f"{name}.pkl"), "wb") as f:
            pickle.dump({"ori": random_rotations(rng, (T + 2, 6)).reshape(
                T + 2, 6, 3, 3), "acc": rng.normal(size=(T + 2, 6, 3)),
                "gt": gt(T)}, f)


def factory_err(got, want):
    """Per field the max |d| of two factory outputs (lists of dicts), and
    whether every field is within PREP_TOL (else PREP_POS_TOL)."""
    import numpy as np
    if len(got) != len(want) or not want:
        return {"items": [len(got), len(want)]}, False
    errs = {}
    for g, w in zip(got, want):
        if sorted(g) != sorted(w):
            return {"fields": [sorted(g), sorted(w)]}, False
        for k in w:
            if np.shape(g[k]) != np.shape(w[k]):
                return {k: [np.shape(g[k]), np.shape(w[k])]}, False
            errs[k] = max(errs.get(k, 0.0), float(np.abs(
                np.asarray(g[k], np.float64) - w[k]).max()))
    return errs, all(e <= PREP_TOL.get(k, PREP_POS_TOL)
                     for k, e in errs.items())


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


def tree_rms(a, b):
    """Root mean square of a - b over all elements of two nests of tensors
    of one structure."""
    d = [(x.double() - y.double()) for x, y in zip(leaves(a), leaves(b))]
    return (sum(float(t.square().sum()) for t in d)
            / sum(t.numel() for t in d)) ** 0.5


def merged_states(shards, axis=1):
    """The per-shard carried states of a mesh session as one nest, each
    leaf concatenated over the shards along the slot axis."""
    import torch
    if isinstance(shards[0], (tuple, list)):
        return tuple(merged_states([s[i] for s in shards], axis)
                     for i in range(len(shards[0])))
    return torch.cat(shards, dim=axis)


def flat_tensors(tree):
    """The tensors of a checkpoint's nested dicts, in key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat_tensors(tree[k])]
    return [tree] if hasattr(tree, "shape") else []


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
        self.max_grad_err = {}
        # the kernels' rows: fp32 (the library's name) and their TF32
        # instantiations (<name>_tf32)
        self.shapes = {name: [] for lib in LIBRARIES
                       for name in (lib, lib + "_tf32")}
        self.launches = {}          # path -> {kernel: launches}
        self._eval = None           # the evaluation phases' data
        self._prep = None           # the data preparation phases' data

    def check(self, ok, what):
        if not ok:
            self.failures.append(what)

    def zero_counts(self):
        for w in self.wrappers.values():
            w.launches = 0
            w.tf32_launches = 0
            w.plain_dispatches = 0

    def counts(self):
        return {name: w.launches for name, w in self.wrappers.items()}

    def tf32_counts(self):
        return {name + "_tf32": w.tf32_launches
                for name, w in self.wrappers.items()}

    def plain_counts(self):
        return {name: w.plain_dispatches for name, w in self.wrappers.items()}

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
                            or "smem" in l or "Function properties" in l]
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
    def compare_layer(self, name, label, kernel_fn, plain_fn, args,
                      tol=KERNEL_TOL):
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
        ok = err <= tol and bool(torch.isfinite(leaves(out)[0]).all())
        self.check(ok, f"{name} {label}: max|d|={err:.3e}")
        return errs, ok

    def compare_formats(self, name, label, kernel_fn, plain_fn, args,
                        bound):
        """A kernel's TF32 instantiation against its plain version at
        "tf32": max|d| within PREC_KERNEL_TOL, finite, the initial state
        untouched, and near the plain version at "tf32" by the measure that
        tells the formats apart: rms(kernel - plain) at most ``bound``
        times rms(plain at "fp32" - plain at "tf32"), where the fp32
        kernel in its place (the control) must exceed it."""
        torch = self.torch
        state_before = clone_tree(args[2])
        with torch.no_grad():
            out = {(k, fmt): fn(*args, fmt)
                   for k, fn in (("kernel", kernel_fn), ("plain", plain_fn))
                   for fmt in ("tf32", "fp32")}
        torch.cuda.synchronize()
        self.check(all(torch.equal(a, b) for a, b in zip(
            leaves(args[2]), leaves(state_before))),
            f"{name}_tf32 {label}: the launch wrote its initial state")
        got, want = out["kernel", "tf32"], out["plain", "tf32"]
        err = tree_err(got, want)
        self.max_err[name + "_tf32"] = max(
            self.max_err.get(name + "_tf32", 0.0), err)
        gap = tree_rms(out["plain", "fp32"], want)
        ratio = tree_rms(got, want) / gap
        control = tree_rms(out["kernel", "fp32"], want) / gap
        ok = (err <= PREC_KERNEL_TOL and ratio <= bound < control
              and bool(torch.isfinite(leaves(got)[0]).all()))
        self.check(ok, f"{name}_tf32 {label}: max|d|={err:.3e}, rms ratio "
                       f"{ratio:.3f} (bound {bound}), control {control:.3f}")
        return {"max_abs_err": err, "rms_gap": gap, "rms_ratio": ratio,
                "control_ratio": control, "ok": ok,
                "tf32_vs_fp32": tree_err(got, out["kernel", "fp32"])}

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
        step_for = lambda b: make_window_step(self.cascade(kind, b), model,
                                              sess.stats)
        self.serve(path, sess, step_for, kernel, 6,
                   [s[0] for s in (TP_STAGES if kind == "tp" else STAGES)])
        return sess, step_for

    def phase_serving(self):
        self.debug_nans_window(*self.serve_cascade("serving", "a3gc",
                                                   "gcn_lstm"))

    def debug_nans_window(self, sess, step_for):
        """``--debug_nans`` on the card (``_runtime.nan_check``): one A3GC
        window of the serving session's step under the NaN check, bit-equal
        to the window without it; with a NaN in stage 1's ``rnn1``
        recurrent weight, ``FloatingPointError`` naming the kernel op
        ``a3gc_tpu_torch::gcn_lstm_scan``, which launched the kernel."""
        import copy
        import numpy as np
        from a3gc_tpu_torch._runtime import nan_check
        torch = self.torch
        S, W, H = S_SERVE, WINDOW, STAGES[0][0]
        rng = np.random.default_rng(11)
        ori = torch.as_tensor(random_rotations(rng, (S, W, 6)).reshape(
            S, W, 54), device=self.dev)
        acc = torch.as_tensor(rng.normal(scale=0.5, size=(S, W, 18)).astype(
            np.float32), device=self.dev)
        act = torch.ones(S, device=self.dev)
        step = step_for("auto")
        seconds = {}
        outs = {}
        with torch.no_grad():
            for checked in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with nan_check() if checked else contextlib.nullcontext():
                    outs[checked] = step(sess.params3, ori, acc,
                                         *clone_tree(sess._states), act)
                torch.cuda.synchronize()
                seconds[checked] = time.perf_counter() - t0
        equal = all(torch.equal(a, b) for a, b in zip(leaves(outs[False]),
                                                       leaves(outs[True])))
        self.check(equal, "serving: the window under the NaN check differs "
                          "from the window without it")
        params3 = copy.deepcopy(sess.params3)
        with torch.no_grad():       # [2, F + H, 4H]: the last H rows
            params3[0].rnn1.kernel[0, -H, 0] = float("nan")
        message, before = None, self.wrappers["gcn_lstm"].launches
        t0 = time.perf_counter()
        try:
            with torch.no_grad(), nan_check():
                step(params3, ori, acc, *clone_tree(sess._states), act)
        except FloatingPointError as e:       # the outcome checked below
            message = str(e)
        nan_s = time.perf_counter() - t0
        launched = self.wrappers["gcn_lstm"].launches - before
        self.check(message is not None
                   and "a3gc_tpu_torch::gcn_lstm_scan" in message
                   and launched == 1,
                   f"serving: a NaN recurrent weight under the NaN check "
                   f"raised {message!r} after {launched} launches")
        emit({"phase": "serving_debug_nans", "bit_equal": equal,
              "window_s": seconds[False], "window_checked_s": seconds[True],
              "nan_weight_raised": message, "nan_weight_launches": launched,
              "nan_weight_s": nan_s, "card": nvidia_smi()})

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
            # the device time of the kernels it launched, and a span's
            # device-side annotation (``jit_*``) spans them again
            if (getattr(ev, "device_type", None) != DeviceType.CUDA
                    or getattr(ev, "is_user_annotation", False)):
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

    def phase_precision(self):
        """A net's precision="default" on the card: each kernel's TF32
        instantiation against its plain version at "tf32" over one frame
        and over a window (ragged n_valid, an idle stream; max|d| and the
        rms ratio to the formats' gap, with the fp32 kernel as the
        control, :meth:`compare_formats`), the delta between the two
        formats and their times in turns (with the TF32 instantiation's FMA
        path, forced by plan, beside its tensor-core path); the
        registers and local memory of every instantiation (a tensor-core
        TF32 one that spills fails); the A3GC cascade at S = 1,
        PREC_T frames, kernel against plain at "default" (and its mean
        angle against the fp32 kernels') and "default" against "highest"
        in degrees; each command's format from its parsed argv; then the
        serve command at its default (A3GC, G-GRU, TransPose through
        ``cli._build_server`` and a client, DIP through the export
        command's loader), counting the TF32 launches, and the TF32 rows
        of the kernels line at the serving window's shapes (and at S = 1,
        and cuDNN's LSTM with TF32 allowed as ``lstm``'s yardstick)."""
        import dataclasses
        import functools
        import threading
        import numpy as np
        from a3gc_tpu_torch import cli
        from a3gc_tpu_torch.client import PoseClient
        from a3gc_tpu_torch.eval.streaming import DipStreamingSession
        from a3gc_tpu_torch.models.pipeline import cascade_apply
        from a3gc_tpu_torch.ops import gcn_lstm as G
        from a3gc_tpu_torch.ops import ggru as GG
        from a3gc_tpu_torch.ops import lstm as LS
        from a3gc_tpu_torch.ops._common import operand_format, sm_count
        from a3gc_tpu_torch.ops.rotations import angle_between
        from a3gc_tpu_torch.smpl import ParametricModel
        torch = self.torch
        gen = torch.Generator().manual_seed(11)
        T = WINDOW
        mods = {"gcn_lstm": G, "ggru": GG, "lstm": LS}
        cases = ([("gcn_lstm", "a3gc", H, S, 2) for S in (S_SERVE, 1)
                  for H, _, _, _ in STAGES]
                 + [("gcn_lstm", "aagc", H, S_SERVE, 2)
                    for H, _, _, _ in STAGES]
                 + [("ggru", "ggru", H, S, 2) for S in (S_SERVE, 1)
                    for H, _, _, _ in STAGES]
                 + [("lstm", "lstm", H, S, D) for S in (S_SERVE, 1)
                    for D in (2, 1)
                    for H in [h for h, _, _, _ in TP_STAGES] + [DIP[0]]])
        rows, lstm_plans = [], []
        for name, cell, H, S, D in cases:
            mod, F = mods[name], H
            p = (self.cell(gen, cell, F, H)
                 if name != "lstm" else self.lstm_layer(gen, F, H, D=D))
            row = {"kernel": name, "cell": cell, "H": H, "S": S, "D": D}
            for T in (1, WINDOW):
                args = (p,) + self.layer_inputs(
                    gen, S, T, F, H, [min(v, T) for v in ragged(S)],
                    nodes=name != "lstm", n_state=1 if name == "ggru" else 2,
                    D=D)
                row[f"T={T}"] = self.compare_formats(
                    name, f"{cell} H={H} S={S} D={D} T={T}",
                    getattr(mod, f"bi_{name}"),
                    getattr(mod, f"bi_{name}_reference"), args,
                    PREC_SEP_FRAME if T == 1 else PREC_SEP_WINDOW)
            # the kernel alone at "fp32", at "tf32", and (gcn_lstm, ggru) at
            # "tf32" on the FMA path, forced by plan: in turns
            plans = {"fp32": (None, False), "tf32": (None, True)}
            if name == "gcn_lstm":
                plans["tf32_fma"] = (G.launch_plan(
                    N_NODES, H, cell == "a3gc", tf32=True, mma=False), True)
            elif name == "ggru":
                plans["tf32_fma"] = (GG.launch_plan(
                    S, N_NODES, H, tf32=True, mma=0), True)
            else:
                plans["tf32_fma"] = (LS.launch_plan(
                    S, H, sm_count(0), D=D, tf32=True, mma=False), True)
            with torch.no_grad():
                scan_args = mod.scan_inputs(*args, "tf32")
                ms = dict.fromkeys(plans, 0.0)
                for k in list(plans) + list(reversed(plans)):
                    plan, tf32 = plans[k]
                    ms[k] += cuda_ms(lambda: mod.scan(
                        *scan_args, plan=plan, tf32=tf32), 10) / 2
            row.update(T=T, n_valid=ragged(S), scan_ms_fp32=ms["fp32"],
                       scan_ms_tf32=ms["tf32"],
                       tf32_over_fp32=ms["tf32"] / ms["fp32"])
            if "tf32_fma" in ms:
                row.update(scan_ms_tf32_fma=ms["tf32_fma"],
                           tf32_fma_over_fp32=ms["tf32_fma"] / ms["fp32"])
            row["plan_tf32"] = (G.launch_plan(N_NODES, H, cell == "a3gc",
                                              tf32=True, S=S)
                                if name == "gcn_lstm" else
                                GG.launch_plan(S, N_NODES, H, tf32=True)
                                if name == "ggru" else
                                LS.launch_plan(S, H, sm_count(0), D=D,
                                               tf32=True))._asdict()
            if name == "lstm":
                lstm_plans += [(H, LS.launch_plan(S, H, sm_count(0), D=D),
                                False), (H, plans["tf32_fma"][0], True),
                               (H, LS.launch_plan(S, H, sm_count(0), D=D,
                                                  tf32=True), True)]
            rows.append(row)

        # registers and local memory (spills, stack) of each instantiation;
        # the TF32 instantiations the serving widths' plans launch (on the
        # tensor cores) must keep everything in registers
        attrs, tensor_core = {}, []
        for att in (True, False):
            for tf32, mma in ((False, False), (True, False), (True, True)):
                key = (f"gcn_lstm attention={int(att)} tf32={int(tf32)} "
                       f"mma={int(mma)}")
                attrs[key] = G.func_attributes(att, tf32, mma)
                if mma:
                    tensor_core.append(key)
        for tf32, mma in ((False, 0), (True, 0), (True, 1), (True, 2)):
            key = f"ggru tf32={int(tf32)} mma={mma}"
            attrs[key] = GG.func_attributes(tf32, mma)
            if mma:
                tensor_core.append(key)
        # lstm: every instantiation the dense widths' plans launch (fp32,
        # the TF32 FMA form, the tensor-core form), none with local memory
        for H, pl, tf32 in lstm_plans:
            key = (f"lstm cooperative={int(pl.cooperative)} "
                   + (f"tf32=1 mma=1 NKB={LS.mma_split(H, pl.P)[1]}"
                      if pl.mma else f"R={pl.R} tf32={int(tf32)} mma=0"))
            if key not in attrs:
                attrs[key] = LS.func_attributes(pl, H, tf32)
                tensor_core.append(key)
        for H, _, _, _ in STAGES:
            self.check(G.launch_plan(N_NODES, H, True, tf32=True).mma == 1
                       and all(GG.launch_plan(S, N_NODES, H, tf32=True).mma
                               for S in (S_SERVE, 1)),
                       f"precision: H={H} plans off the tensor cores")
        for H in [h for h, _, _, _ in TP_STAGES] + [DIP[0]]:
            self.check(all(LS.launch_plan(S, H, sm_count(0), D=D,
                                          tf32=True).mma == 1
                           for S in (S_SERVE, 1) for D in (2, 1)),
                       f"precision: lstm H={H} plans off the tensor cores")
        self.check(all(attrs[k]["local_bytes"] == 0 for k in tensor_core),
                   f"precision: a tensor-core TF32 instantiation (or an "
                   f"lstm one) uses local memory: {attrs}")
        print(json.dumps({"instantiations": attrs}), flush=True)

        # the A3GC cascade at batch 1: stage 3 emitting near rotations, as a
        # trained net does (near_rotation_outputs)
        def at(cfg, precision, backend):
            net = functools.partial(dataclasses.replace, precision=precision,
                                    backend=backend)
            return dataclasses.replace(cfg, **{
                f"stage{i + 1}": dataclasses.replace(s, net=net(s.net))
                for i, s in enumerate(cfg.stages)})

        base = self.cascade("a3gc", "auto")
        params3 = self.params3(base)
        near_rotation_outputs(params3[2])
        imu = torch.as_tensor(np.random.default_rng(12).normal(
            scale=0.5, size=(1, PREC_T, N_NODES, 12)).astype(np.float32),
            device=self.dev)
        model = ParametricModel()
        poses = {}
        with torch.no_grad():
            for key, prec, backend in (("kernel_default", "default", "cuda"),
                                       ("plain_default", "default", "eager"),
                                       ("kernel_highest", "highest", "cuda")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                poses[key] = cascade_apply(params3, at(base, prec, backend),
                                           model, imu, device=self.dev)
                torch.cuda.synchronize()
                poses[key + "_s"] = time.perf_counter() - t0

            def degrees(a, b):
                return torch.rad2deg(angle_between(
                    poses[a].reshape(-1, 3, 3), poses[b].reshape(-1, 3, 3)))

            kp = degrees("kernel_default", "plain_default")
            dh = degrees("kernel_default", "kernel_highest")
            gap = degrees("kernel_highest", "plain_default")
        angles = {"kernel_vs_plain_default": {
                      "mean": float(kp.mean()), "max": float(kp.max())},
                  "default_vs_highest": {
                      "mean": float(dh.mean()), "max": float(dh.max())},
                  "highest_kernels_vs_plain_default": {
                      "mean": float(gap.mean()), "max": float(gap.max())}}
        # the cascade of TF32 kernels nearer the plain one at "default" than
        # the cascade of fp32 kernels is
        sep = (angles["kernel_vs_plain_default"]["mean"]
               / angles["highest_kernels_vs_plain_default"]["mean"])
        angles["mean_ratio"] = sep
        self.check(sep <= PREC_SEP_WINDOW,
                   f"precision: cascade kernel vs plain at default is "
                   f"{sep:.3f} of the fp32 kernels' angle (bound "
                   f"{PREC_SEP_WINDOW})")
        self.check(bool(torch.isfinite(poses["kernel_default"]).all())
                   and angles["kernel_vs_plain_default"]["mean"]
                   <= PREC_ANGLE_MEAN
                   and angles["kernel_vs_plain_default"]["max"]
                   <= PREC_ANGLE_MAX,
                   f"precision: cascade kernel vs plain at default "
                   f"{angles['kernel_vs_plain_default']} deg")
        self.check(angles["default_vs_highest"]["mean"] <= PREC_PARITY_MEAN,
                   f"precision: cascade default vs highest "
                   f"{angles['default_vs_highest']} deg")

        # each command's format on the card, from its parsed argv
        formats, fmt_ok = {}, True
        commands = {"train": ["train", "-b", "16", "--train_data", "t.npz",
                              "--valid_data", "v.npz"],
                    "evaluate": ["evaluate", "--datasets", "t.npz"],
                    "stream": ["stream", "--input", "t.npz"],
                    "export": ["export", "--output", "art"],
                    "serve": ["serve"]}
        for command, argv in commands.items():
            for given in (None, "highest", "default"):
                for model_flag in ("a3gc", "tp", "dip"):
                    args = cli.build_parser().parse_args(
                        argv + ["--model", model_flag] + (
                            [] if given is None else ["--precision", given]))
                    prec = cli._precision(args, train=command == "train")
                    if model_flag == "dip":
                        net = cli._dip_config(args, prec).net
                    else:
                        net = cli._stage_configs(args, prec)[0].stage1.net
                    fmt = operand_format(net.precision, self.dev)
                    want = ("fp32" if (given or ("highest" if command ==
                                                 "train" else "default"))
                            == "highest" else "tf32")
                    fmt_ok &= fmt == want
                    formats[f"{command} {model_flag} "
                            f"{given or '(no flag)'}"] = fmt
        self.check(fmt_ok, f"precision: command formats {formats}")

        # the serve command at its default precision, one window a family
        rng = np.random.default_rng(13)
        self.zero_counts()                            # the main path starts
        served = {}
        for model_flag in ("a3gc", "ggru", "tp"):
            args = cli.build_parser().parse_args(
                ["serve", "--port", "0", "--norm", "--model", model_flag,
                 "--streams", str(S_SERVE)])
            cli._apply_quality(args)                  # as cmd_serve does
            srv, _, _ = cli._build_server(args)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                before = self.tf32_counts()
                with PoseClient(*srv.address[:2], timeout=120.0,
                                retry_s=30.0) as c:
                    pose = c.step(*self.windows(rng, 1))
                after = self.tf32_counts()
                served[model_flag] = {
                    "finite": bool(np.isfinite(pose).all()),
                    "tf32_launches": {k: after[k] - before[k]
                                      for k in after}}
            finally:
                srv.shutdown()
                thread.join(timeout=10)
        args = cli.build_parser().parse_args(
            ["export", "--model", "dip", "--hu1", str(DIP[0]), "--output",
             "art"])
        dip_cfg, dip = cli._load_dip(args, self.dev, allow_init=True)
        sess = DipStreamingSession(dip, dip_cfg, model, window=WINDOW,
                                   stats=cli._load_stats(args),
                                   streams=S_SERVE, device=self.dev)
        before = self.tf32_counts()
        pose = sess.step(*self.windows(rng, S_SERVE))
        after = self.tf32_counts()
        served["dip"] = {"finite": bool(np.isfinite(pose).all()),
                         "tf32_launches": {k: after[k] - before[k]
                                           for k in after}}
        counts = self.tf32_counts()                   # the main path ended
        self.launches["precision"] = counts
        want = {"a3gc": ("gcn_lstm_tf32", 6), "ggru": ("ggru_tf32", 6),
                "tp": ("lstm_tf32", 6), "dip": ("lstm_tf32", 2)}
        for model_flag, (kernel, n) in want.items():
            got = served[model_flag]
            self.check(got["finite"] and got["tf32_launches"][kernel] == n
                       and sum(got["tf32_launches"].values()) == n,
                       f"precision: serve --model {model_flag} at its "
                       f"default: {got}")
        # every fp32 launch of those windows was a TF32 one
        self.check(self.counts() == {k[:-5]: v for k, v in counts.items()},
                   f"precision: fp32 launches at default {self.counts()}")

        # the TF32 rows of the kernels line: the serving window's layer
        # calls (S = 8, T = 60), and the graph kernels at S = 1 (per-sequence
        # evaluation), rows of their own
        for S in (S_SERVE, 1):
            full = [T] * S
            for H, _, _, _ in STAGES:
                for F in (H, 2 * H):
                    for name, work in (("gcn_lstm", gcn_layer_work),
                                       ("ggru", functools.partial(
                                           ggru_layer_work, tf32=True))):
                        p = self.cell(gen, "a3gc" if name == "gcn_lstm"
                                      else name, F, H)
                        args = self.layer_inputs(
                            gen, S, T, F, H, full,
                            n_state=2 if name == "gcn_lstm" else 1)
                        self.time_layer(name, "precision", S, F, H, p,
                                        args, work,
                                        plain_reps=2 if S > 1 else 1,
                                        fmt="tf32")
        full = [T] * S_SERVE
        dense = [(H, F, 2) for H, _, _, _ in TP_STAGES for F in (H, 2 * H)]
        dense += [(DIP[0], F, 2) for F in (DIP[0], 2 * DIP[0])]
        dense += [(DIP[0], DIP[0], 1)] * 2
        for H, F, D in dense:
            p = self.lstm_layer(gen, F, H, D=D)
            args = self.layer_inputs(gen, S_SERVE, T, F, H, full,
                                     nodes=False, D=D)
            self.time_layer("lstm", "precision", S_SERVE, F, H, p, args,
                            lstm_layer_work if D == 2
                            else uni_lstm_layer_work,
                            library=self.cudnn_lstm(p, *args[:2], tf32=True),
                            plain_reps=2, fmt="tf32")
        # lstm's other shapes at the inference commands' default: offline
        # TransPose and DIP (S = 1) and a DIP K = 1 emission pass (T = 120),
        # F = H, rows of their own
        extra = [(H, 1, T) for H, _, _, _ in TP_STAGES] + [(DIP[0], 1, T)]
        extra.append((DIP[0], S_SERVE, 120))
        for H, S, Tx in extra:
            p = self.lstm_layer(gen, H, H)
            args = self.layer_inputs(gen, S, Tx, H, H, [Tx] * S, nodes=False)
            self.time_layer("lstm", "precision", S, H, H, p, args,
                            lstm_layer_work,
                            library=self.cudnn_lstm(p, *args[:2], tf32=True),
                            plain_reps=1, fmt="tf32")
        emit({"phase": "precision", "tol": PREC_KERNEL_TOL,
              "rms_ratio_bounds": {"frame": PREC_SEP_FRAME,
                                   "window": PREC_SEP_WINDOW},
              "max_abs_err": {k: self.max_err[k + "_tf32"]
                              for k in LIBRARIES},
              "cases": rows, "cascade_T": PREC_T,
              "cascade_angle_deg": angles,
              "cascade_s": {k[:-2]: v for k, v in poses.items()
                            if k.endswith("_s")},
              "angle_bounds_deg": {"kernel_vs_plain": [PREC_ANGLE_MEAN,
                                                       PREC_ANGLE_MAX],
                                   "default_vs_highest_mean":
                                       PREC_PARITY_MEAN},
              "formats": formats, "served_at_default": served,
              "instantiations": attrs, "card": nvidia_smi()})

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
        # --precision highest: the server is held to in-process sessions
        # at the library's precision (its own default, "default", is TF32
        # on the card: the precision phase)
        self.cli_serve("cli_serve", ["serve", "--port", "0", "--streams",
                                     str(S_SERVE), "--norm", "--quality",
                                     "balanced", "--precision", "highest"])

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
                "--window", str(WINDOW), "--precision", "highest"]
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
                    "--history", "1", "--precision", "highest",
                    "--output", art]
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

    # -- the mesh ----------------------------------------------------------
    def mesh_train_start(self, tmp):
        """The three ``cli train`` children of the mesh phase, started at
        once: A3GC at full width, B = MESH_TRAIN_B, one epoch of
        MESH_TRAIN_SEQS x TRAIN_T frames, without a mesh, with ``--mesh``
        and with ``--coordinator`` (NCCL, one process)."""
        import socket
        import numpy as np
        from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
        train = os.path.join(tmp, "train.npz")
        valid = os.path.join(tmp, "valid.npz")
        np.savez(train, **synthetic_packed_dataset(MESH_TRAIN_SEQS, TRAIN_T,
                                                   seed=0))
        np.savez(valid, **synthetic_packed_dataset(MESH_VALID_SEQS, TRAIN_T,
                                                   seed=1))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        runs = {"single": [], "mesh": ["--mesh"],
                "coordinator": ["--coordinator", f"127.0.0.1:{port}",
                                "--num_processes", "1", "--process_id",
                                "0"]}
        procs = {}
        for name, extra in runs.items():
            argv = (["train", "--model", "a3gc", "-b", str(MESH_TRAIN_B),
                     "--epochs", "1", "--norm", "--name", name,
                     "--save_root", tmp, "--train_data", train,
                     "--valid_data", valid]
                    + [f"--hu{i + 1}={s[0]}" for i, s in enumerate(STAGES)]
                    + extra)
            procs[name] = (extra, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-c", TRAIN_CHILD] + argv, cwd=tmp,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        return procs

    def mesh_train_finish(self, tmp, procs):
        """Wait for the children; their logs' losses and their final
        checkpoints must be bit-equal. Returns the phase's training record
        and the mesh children's launches."""
        import numpy as np
        from a3gc_tpu_torch.utils import discover_latest
        torch = self.torch
        record, logs, launches = {}, {}, []
        for name, (extra, t0, proc) in procs.items():
            try:
                out, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            wall = time.perf_counter() - t0
            self.check(proc.returncode == 0,
                       f"mesh train {name} exited {proc.returncode}:\n"
                       + err[-3000:])
            if proc.returncode != 0:
                continue
            child = json.loads(out.strip().splitlines()[-1])
            self.check(not child["banned"],
                       f"mesh train {name} imported {child['banned']}")
            self.check(child["launches"] == {k: (6 if k == "gcn_lstm" else 0)
                                             for k in LIBRARIES},
                       f"mesh train {name} launches {child['launches']}, "
                       "want 6 of gcn_lstm (one validation chunk a stage)")
            if name != "single":
                launches.append(child["launches"])
            with open(os.path.join(tmp, name, "train_log.jsonl")) as f:
                logs[name] = [(e["stage"], e["epoch"], e["train_loss"],
                               e["valid_loss"]) for e in map(json.loads, f)]
            record[name] = {"flags": extra, "collected_after_s": wall,
                            "losses": logs[name]}
        if len(logs) == 3:
            same_logs = logs["mesh"] == logs["single"] == logs["coordinator"]
            self.check(same_logs and len(logs["single"]) == 3 and bool(
                np.isfinite([l[2:] for l in logs["single"]]).all()),
                f"mesh train logs differ or are not finite: {logs}")
            same_ckpt = True
            for stage in (1, 2, 3):
                found = [discover_latest(os.path.join(tmp, n), stage)
                         for n in ("single", "mesh", "coordinator")]
                self.check(all(found), f"mesh train stage {stage}: {found}")
                if all(found):
                    ps = [torch.load(os.path.join(f[0], "params.pt"),
                                     map_location="cpu") for f in found]
                    same_ckpt &= all(
                        all(torch.equal(x, y) for x, y in zip(
                            flat_tensors(ps[0]), flat_tensors(p)))
                        for p in ps[1:])
            self.check(same_ckpt, "mesh train checkpoints differ")
            record["bit_equal"] = {"logs": same_logs,
                                   "checkpoints": same_ckpt}
        return record, launches

    def phase_mesh(self):
        """The data-parallel entry points on the card at A3GC full width:
        ``cascade_apply_sharded`` at S = 8, T = 300 (ragged) on a one-card
        mesh (bit-equal to ``cascade_apply``) and on the card listed twice
        (two shards in turn, within PATH_TOL), 6 launches a shard; a
        2-shard ``StreamingCascade(lookahead=1, history=1)`` for 6 ticks
        with an idle slot and a reset, then ``flush``, against the
        unsharded session, ms per steady tick of both in turns; a 2-shard
        ``CascadeEvaluator.evaluate_batched`` at 8 streams on four of the
        test sequences against the unsharded table; an in-process
        ``PoseServer(mesh=)`` with two clients against single-slot
        sessions, ``/v1/recycle`` refused; three ``cli train`` children
        (no mesh, ``--mesh``, ``--coordinator``) bit-equal."""
        import shutil
        import tempfile
        import threading
        import numpy as np
        from a3gc_tpu_torch.client import PoseClient, ServerError
        from a3gc_tpu_torch.data import load_stats
        from a3gc_tpu_torch.eval import CascadeEvaluator
        from a3gc_tpu_torch.eval.streaming import StreamingCascade
        from a3gc_tpu_torch.models.pipeline import cascade_apply
        from a3gc_tpu_torch.parallel import cascade_apply_sharded, make_mesh
        from a3gc_tpu_torch.serve import PoseServer
        from a3gc_tpu_torch.smpl import ParametricModel
        torch = self.torch
        S, W, K, P = S_SERVE, WINDOW, 1, 1
        one, two = make_mesh(), make_mesh(devices=[self.dev, self.dev])
        tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        procs = self.mesh_train_start(tmp)
        try:
            cfg = self.cascade("a3gc", "auto")
            params3 = self.params3(cfg)
            model = ParametricModel()
            rng = np.random.default_rng(7)
            T = 300
            imu = torch.as_tensor(rng.normal(size=(S, T, N_NODES, 12))
                                  .astype(np.float32), device=self.dev)
            n_valid = np.array(ragged_long(S, T))
            mask = (np.arange(T)[None] < n_valid[:, None]).astype(np.float32)
            valid = torch.as_tensor(mask.reshape(-1) > 0, device=self.dev)
            ref = cascade_apply(params3, cfg, model, imu, frame_mask=mask,
                                device=self.dev)

            def stats_session(mesh, streams=S):
                return StreamingCascade(
                    params3, cfg, model, window=W, stats=load_stats(),
                    normalize=True, streams=streams, lookahead=K, history=P,
                    mesh=mesh, device=self.dev)

            sharded, single = stats_session(two), stats_session(None)
            seqs = self.eval_data()["seqs"][:4]
            lengths = [int(s["ori"].shape[0]) for s in seqs]
            ev_params, ev = self.eval_cascade("a3gc")
            data = self.eval_data()
            ev_two = CascadeEvaluator(ev_params, cfg, data["model"],
                                      data["stats"], normalize=True,
                                      mesh=two)
            for e in (ev, ev_two):
                e.warmup(lengths)

            self.zero_counts()                        # the main path starts
            got_one = cascade_apply_sharded(params3, cfg, model, imu, one,
                                            frame_mask=mask)
            offline_one = self.counts()["gcn_lstm"]
            got_two = cascade_apply_sharded(params3, cfg, model, imu, two,
                                            frame_mask=mask)
            offline_two = self.counts()["gcn_lstm"] - offline_one
            idle = np.ones(S, np.float32)
            idle[5] = 0.0
            ticks, before = [], self.counts()["gcn_lstm"]
            wins = [self.windows(rng, S) for _ in range(6)]
            for t, (o, a) in enumerate(wins):
                ticks.append(sharded.step(o, a, active=idle if t == 3
                                          else None))
                if t == 2:
                    sharded.reset(stream=3)
            tails = sharded.flush()
            session_launches = self.counts()["gcn_lstm"] - before
            before = self.counts()["gcn_lstm"]
            table_two = ev_two.evaluate_batched(seqs, streams=S)[0]
            eval_launches = self.counts()["gcn_lstm"] - before
            before = self.counts()["gcn_lstm"]
            srv = PoseServer(params3, cfg, model, window=W, streams=S,
                             stats=load_stats(), normalize=True, port=0,
                             mesh=two, lookahead=K, history=P,
                             max_wait_ms=5.0, allow_recycle=True)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            feeds = [[self.windows(rng, 1) for _ in range(6)]
                     for _ in range(2)]
            served, refusal = {}, None
            try:
                def client(i):
                    out = []
                    with PoseClient(*srv.address[:2], binary=True,
                                    timeout=60.0, retry_s=10.0) as c:
                        for o, a in feeds[i]:
                            pose = c.step(o, a)
                            if pose is not None:
                                out.append(pose)
                        tail = c.flush()
                        if tail is not None:
                            out.append(tail)
                    served[i] = np.concatenate(out)
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(2)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                try:
                    PoseClient(*srv.address[:2], timeout=60.0).recycle()
                except ServerError as e:
                    refusal = (e.status, str(e))
            finally:
                srv.shutdown()
            http_launches = self.counts()["gcn_lstm"] - before
            counts = self.counts()                    # the main path ended

            # the comparisons: the unsharded twins' launches do not count
            err_two = float((got_two - ref).abs().reshape(S * T, -1)[valid]
                            .max())
            one_equal = bool(torch.equal(got_one, ref))
            ref_ticks, ref_launches = [], self.counts()["gcn_lstm"]
            for t, (o, a) in enumerate(wins):
                ref_ticks.append(single.step(o, a, active=idle if t == 3
                                             else None))
                if t == 2:
                    single.reset(stream=3)
            ref_tails = single.flush()
            single_launches = self.counts()["gcn_lstm"] - ref_launches
            pose_err, emitted_ok = 0.0, True
            for (p2, e2), (p1, e1) in zip(ticks, ref_ticks):
                emitted_ok &= bool((e2 == e1).all())
                if e1.any():
                    pose_err = max(pose_err,
                                   float(np.abs(p2[e1] - p1[e1]).max()))
            for a, b in zip(tails, ref_tails):
                emitted_ok &= (a is None) == (b is None)
                if a is not None and b is not None:
                    pose_err = max(pose_err, float(np.abs(a - b).max()))
            state_err = tree_err(merged_states(sharded._states),
                                 single._states)
            table_one = ev.evaluate_batched(seqs, streams=S)[0]
            table_err = float(np.abs(table_two - table_one).max())
            http_err = 0.0
            for i, feed in enumerate(feeds):
                ref_sess = stats_session(None, streams=1)
                want = [p for p in (ref_sess.step(o, a) for o, a in feed)
                        if p is not None]
                tail = ref_sess.flush()
                if tail is not None:
                    want.append(tail)
                want = np.concatenate(want)
                ok = i in served and served[i].shape == want.shape
                self.check(ok, f"mesh http client {i}: "
                           f"{served.get(i, np.zeros(0)).shape} vs "
                           f"{want.shape}")
                if ok:
                    http_err = max(http_err,
                                   float(np.abs(served[i] - want).max()))
            for k, n in counts.items():               # the twins' launches
                self.wrappers[k].launches = n         # do not count

            # steady ticks of both sessions, in turns
            for sess in (sharded, single):
                for _ in range(K + P + 2):
                    sess.step(*self.windows(rng, S))
            times = {"two_shards": [], "unsharded": []}
            order = [("two_shards", sharded), ("unsharded", single),
                     ("unsharded", single), ("two_shards", sharded)]
            inputs = [self.windows(rng, S) for _ in range(5)]
            torch.cuda.synchronize()
            for o, a in inputs:
                for name, sess in order:
                    t0 = time.perf_counter()
                    sess.step(o, a)
                    times[name].append((time.perf_counter() - t0) * 1e3)
            for k, n in counts.items():
                self.wrappers[k].launches = n
        finally:
            train, child_launches = self.mesh_train_finish(tmp, procs)
            shutil.rmtree(tmp, ignore_errors=True)
        for c in child_launches:
            counts = {k: counts[k] + c[k] for k in counts}
        self.launches["mesh"] = counts
        groups = n_groups(lengths, S)
        self.check(one_equal, "mesh: one-card cascade_apply_sharded is not "
                   "bit-equal to cascade_apply")
        self.check(err_two <= PATH_TOL and bool(torch.isfinite(got_two)
                                                .all()),
                   f"mesh: 2-shard cascade vs unsharded {err_two:.3e}")
        self.check(offline_one == 6 and offline_two == 12,
                   f"mesh: offline launches {offline_one} / {offline_two}, "
                   "want 6 a shard")
        self.check(emitted_ok and pose_err <= PATH_TOL
                   and state_err <= PATH_TOL,
                   f"mesh session vs unsharded: pose {pose_err:.3e}, state "
                   f"{state_err:.3e}, emitted ok={emitted_ok}")
        self.check(session_launches == 2 * single_launches,
                   f"mesh session launches {session_launches}, want twice "
                   f"the unsharded session's {single_launches}")
        self.check(table_err <= TABLE_TOL and eval_launches == 12 * groups,
                   f"mesh evaluation: table {table_err:.3e}, launches "
                   f"{eval_launches} (want {12 * groups})")
        self.check(http_err <= PATH_TOL and http_launches > 0,
                   f"mesh http: {http_err:.3e}, {http_launches} launches")
        self.check(refusal is not None and refusal[0] == 501
                   and "--mesh" in refusal[1],
                   f"mesh: /v1/recycle not refused: {refusal}")
        self.check(all(n == 0 for k, n in counts.items() if k != "gcn_lstm"),
                   f"mesh launched other kernels: {counts}")
        emit({"phase": "mesh", "devices": [str(d) for d in two.devices],
              "offline": {"streams": S, "frames": T,
                          "n_valid": n_valid.tolist(),
                          "one_card_bit_equal": one_equal,
                          "two_shards_max_abs_err": err_two,
                          "two_shards_exactly_equal": err_two == 0.0,
                          "launches_one_card": offline_one,
                          "launches_two_shards": offline_two},
              "session": {"lookahead": K, "history": P,
                          "pose_max_abs_err": pose_err,
                          "state_max_abs_err": state_err,
                          "launches": session_launches,
                          "unsharded_launches": single_launches,
                          "ms_per_steady_tick_median": {
                              k: float(np.median(v))
                              for k, v in times.items()},
                          "timed_ticks": len(times["unsharded"])},
              "evaluation": {"streams": S, "lengths": lengths,
                             "table_max_abs_err": table_err,
                             "launches": eval_launches, "groups": groups},
              "http": {"clients": 2, "pose_max_abs_err": http_err,
                       "launches": http_launches, "recycle": refusal},
              "train": train, "launches": counts, "tol": PATH_TOL,
              "card": nvidia_smi()})

    def phase_kernel_eval(self):
        """Each kernel at evaluation lengths against its plain version
        (S = 1, T = 2048 and S = 8, T = 1024, ragged n_valid; ``lstm`` also
        at "tf32", the evaluate command's default, by compare_formats over
        the whole sequence), then timed at S = 1, T = 2048 and S = 16, T =
        1024 for the kernels line (the plain version, ≈ 1-2 s a call
        there, is not timed again); ``lstm`` there also at "tf32", against
        cuDNN with TF32 allowed."""
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
                    if name == "lstm":
                        # the TF32 instantiation (the evaluate command's
                        # default) on the same ragged inputs, against the
                        # plain version at "tf32", the fp32 kernel the
                        # control
                        rows[-1]["tf32"] = self.compare_formats(
                            name, f"eval H={H} S={S} T={T}", kernel_fn,
                            plain_fn, (p,) + args, PREC_SEP_WINDOW)
                        rows[-1]["ok"] = ok and rows[-1]["tf32"]["ok"]
                for S, T in EVAL_TIMED_SHAPES:
                    x, st, nv = self.layer_inputs(gen, S, T, H, H, [T] * S,
                                                  nodes=nodes,
                                                  n_state=n_state)
                    library = None
                    if name == "lstm":
                        with torch.no_grad():
                            out = LS.bi_lstm(p, x, st)
                        library = self.cudnn_lstm(p, x, st, kernel_out=out)
                    where = path or ("evaluate_dip" if H == DIP[0]
                                     else "evaluate_families")
                    self.time_layer(name, where, S, H, H, p, (x, st, nv),
                                    work, library=library, reps=3,
                                    plain_reps=0)
                    if name == "lstm":
                        # the TF32 instantiation, the evaluate command's
                        # default, against cuDNN with TF32 allowed
                        with torch.no_grad():
                            out = LS.bi_lstm(p, x, st, fmt="tf32")
                        self.time_layer(
                            name, where, S, H, H, p, (x, st, nv), work,
                            library=self.cudnn_lstm(p, x, st, kernel_out=out,
                                                    tf32=True),
                            reps=3, plain_reps=0, fmt="tf32")
        emit({"phase": "kernel_eval", "tol": KERNEL_TOL,
              "tf32_tol": PREC_KERNEL_TOL, "tf32_bound": PREC_SEP_WINDOW,
              "max_abs_err": max(r["y"] for r in rows),
              "max_abs_err_state": max(r["state"] for r in rows),
              "n_cases": len(rows), "all_ok": all(r["ok"] for r in rows),
              "cases": rows})

    def phase_cli_evaluate(self):
        """``python -m a3gc_tpu_torch.cli evaluate --model a3gc --norm --smpl
        <pickle> --batch_streams 8 --datasets <npz> --profile <dir>
        --compilation_cache <fresh dir>`` in a child that counts the
        launches (``TRAIN_CHILD``), on the evaluate phase's params written
        as reference ``.tar`` checkpoints: its report against the
        in-process batched table; the trace holds the ``gcn_lstm``
        kernel's CUDA events, as many as the child's launches, the op
        ``a3gc_tpu_torch::gcn_lstm_scan`` and the ``jit__run_b`` spans;
        the ``gcn_lstm`` library was built into the fresh directory."""
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
            trace_dir = os.path.join(cwd, "trace")
            cache = os.path.join(cwd, "kernels")
            argv = ["evaluate", "--model", "a3gc", "--norm", "--smpl",
                    data["smpl"], "--batch_streams", str(S_SERVE),
                    "--datasets", data["npz"], "--precision", "highest",
                    "--torch_checkpoints"] + tars \
                + ["--profile", trace_dir, "--compilation_cache", cache]
            env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", TRAIN_CHILD] + argv, cwd=cwd,
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
            child = json.loads(proc.stdout.strip().splitlines()[-1])
            t1 = time.perf_counter()
            traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
            self.check(len(traces) == 1, f"cli evaluate --profile wrote "
                                         f"{traces}")
            events = []
            for path in traces:
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            trace_bytes = sum(os.path.getsize(t) for t in traces)
            names = [e.get("name", "") for e in events]
            kernel_events = sum(1 for e in events
                                if e.get("cat") == "kernel"
                                and "gcn_lstm_kernel" in e.get("name", ""))
            parse_s = time.perf_counter() - t1
            built = glob.glob(os.path.join(cache, "gcn_lstm_*.so"))
        finally:
            shutil.rmtree(cwd, ignore_errors=True)
        launches = child["launches"]["gcn_lstm"]
        op_events = names.count("a3gc_tpu_torch::gcn_lstm_scan")
        spans = {n: names.count(n) for n in ("jit__run", "jit__run_b",
                                             "jit___call__",
                                             "jit_full_motion_metrics")}
        self.check(launches > 0 and kernel_events == launches,
                   f"cli evaluate --profile: {kernel_events} gcn_lstm "
                   f"kernel events in the trace, {launches} launches")
        self.check(op_events > 0 and spans["jit__run_b"] > 0,
                   f"cli evaluate --profile: op events {op_events}, spans "
                   f"{spans}")
        self.check(len(built) == 1, f"cli evaluate --compilation_cache "
                                    f"built {built}")
        self.check(not child["banned"], f"cli evaluate imported "
                                        f"{child['banned']}")
        want = data["tables"][f"batched_{S_SERVE}"]
        err = float(np.abs(got - want).max())
        self.check(err <= REPORT_TOL,
                   f"cli evaluate report vs in-process: {err:.3e}")
        line = [l for l in proc.stdout.splitlines() if l.startswith("== ")]
        emit({"phase": "cli_evaluate", "argv": argv[:6] + ["..."],
              "wall_s": wall, "summary": line, "report_table": got.tolist(),
              "report_max_abs_err_vs_in_process": err, "tol": REPORT_TOL,
              "launches": child["launches"],
              "trace": {"files": len(traces), "bytes": trace_bytes,
                        "events": len(events),
                        "gcn_lstm_kernel_events": kernel_events,
                        "gcn_lstm_scan_op_events": op_events,
                        "spans": spans, "parse_s": parse_s},
              "compilation_cache": [os.path.basename(b) for b in built],
              "card": nvidia_smi()})

    # -- 4c: data preparation -----------------------------------------------
    def prep_data(self):
        """The raw corpora (``write_prep_corpora``) under a temporary data
        root, a synthetic SMPL pickle of EVAL_VERTICES vertices, the body
        model on the card and on the CPU; made once."""
        if self._prep is None:
            import tempfile
            from a3gc_tpu_torch.config import Paths
            from a3gc_tpu_torch.smpl import (load_parametric_model,
                                             write_synthetic_smpl_pickle)
            tmp = tempfile.mkdtemp(prefix="chip_smoke_prep_")
            paths = Paths(data_root=tmp)
            t0 = time.perf_counter()
            write_prep_corpora(paths)
            smpl = write_synthetic_smpl_pickle(
                os.path.join(tmp, "smpl.pkl"), n_vertices=EVAL_VERTICES)
            self._prep = {"tmp": tmp, "paths": paths, "smpl": smpl,
                          "write_s": time.perf_counter() - t0,
                          "model": load_parametric_model(smpl,
                                                         device=self.dev),
                          "cpu_model": load_parametric_model(smpl,
                                                             device="cpu")}
        return self._prep

    def phase_preprocess(self):
        """The port's data factory on the card at the sizes of recordings:
        ``process_amass_split(mode="train", sym=True)``, ``process_dipimu``
        (train with the mirror, valid, test), ``process_totalcapture``;
        the chunk counts and field shapes against the raw lengths; the
        packed AMASS chunks through ``StageRunner(1).eval_epoch`` (A3GC
        stage 1, H = 256, B = PREP_B; gcn_lstm launches counted, 2 a chunk
        of PREP_B) against the same pass on the plain path (the loss, and
        the stage's outputs on the first batch); one sequence per corpus
        cut to PREP_CUT frames against the same call with the body model on
        the CPU; per corpus frames/s, the device part's frames/s, peak
        memory; the device's busy share over one AMASS sequence."""
        import numpy as np
        from a3gc_tpu_torch.config import TrainConfig
        from a3gc_tpu_torch.data import (load_adjacency_template, load_stats,
                                         pipeline as DP)
        from a3gc_tpu_torch.data.factory import amass as FA
        from a3gc_tpu_torch.data.factory import dipimu as FD
        from a3gc_tpu_torch.data.factory import totalcapture as FT
        from a3gc_tpu_torch.models.pipeline import (init_pose_net,
                                                    pose_net_forward)
        from a3gc_tpu_torch.ops import rotations as R
        from a3gc_tpu_torch.train import StageRunner
        torch = self.torch
        data = self.prep_data()
        paths, model, tmp = data["paths"], data["model"], data["tmp"]
        rows = {}

        def timed(name, run, raw_frames, frames):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(self.dev)
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rows[name] = {"seconds": sec, "raw_frames": raw_frames,
                          "frames": frames,
                          "raw_frames_per_s": raw_frames / sec,
                          "frames_per_s": frames / sec,
                          "peak_memory_gib":
                              torch.cuda.max_memory_allocated(self.dev)
                              / 2 ** 30}
            return out

        used = [(T, fps) for _, _, _, T, fps in PREP_AMASS
                if fps in (120, 60, 59)]
        amass_T = [T // 2 if fps == 120 else T for T, fps in used]
        dip = {(s, m): T for s, m, T, _ in PREP_DIP}
        out = {k: os.path.join(tmp, f"{k}.npz")
               for k in ("amass", "dip_train", "dip_valid", "dip_test",
                         "tc")}
        self.zero_counts()                            # the main path starts
        amass = timed("amass", lambda: FA.process_amass_split(
            model, "train", sym=True, out_path=out["amass"], paths=paths),
            sum(T for T, _ in used), 2 * sum(amass_T))
        dip_train = timed("dipimu_train", lambda: FD.process_dipimu(
            model, "train", sym=True, out_path=out["dip_train"],
            paths=paths), dip["s_01", "01"], 2 * (dip["s_01", "01"] - 12))
        dip_valid = timed("dipimu_valid", lambda: FD.process_dipimu(
            model, "valid", out_path=out["dip_valid"], paths=paths),
            dip["s_01", "05"], dip["s_01", "05"] - 12)
        test_T = [dip["s_09", "01"], dip["s_09", "02"]]
        dip_test = timed("dipimu_test", lambda: FD.process_dipimu(
            model, "test", out_path=out["dip_test"], paths=paths),
            sum(test_T), sum(T - 12 for T in test_T))
        tc_T = [T for _, T in PREP_TC if T != FT.FAULTY_LENGTH]
        tc = timed("totalcapture", lambda: FT.process_totalcapture(
            model, out_path=out["tc"], paths=paths),
            sum(T for _, T in PREP_TC), sum(tc_T))
        # the packed AMASS chunks through the validation pass (the kernels)
        packed = DP.load_packed(out["amass"])
        cfg = self.cascade("a3gc", "auto").stage1
        runner = StageRunner(1, cfg, init_pose_net(
            torch.Generator().manual_seed(1), cfg,
            load_adjacency_template()), TrainConfig(
                batch_size=PREP_B, normalize=True), 1, stats=load_stats(),
            device=self.dev)
        sampler = DP.Sampler(packed, PREP_B, shuffle=False)
        t0 = time.perf_counter()
        valid_loss = runner.eval_epoch(sampler)
        valid_s = time.perf_counter() - t0
        counts = self.counts()                        # the main path ended
        self.launches["preprocess"] = counts
        n_chunks = len(packed["ori"])
        want = 2 * (n_chunks // PREP_B)
        self.check(counts == {k: (want if k == "gcn_lstm" else 0)
                              for k in LIBRARIES},
                   f"preprocess launches {counts}, want {want} gcn_lstm")
        self.check(bool(np.isfinite(valid_loss)),
                   f"preprocess eval_epoch loss {valid_loss}")
        # the same pass on the plain path, and the stage's outputs on the
        # first batch of PREP_B chunks through both
        t0 = time.perf_counter()
        plain = StageRunner(1, self.cascade("a3gc", "eager").stage1,
                            runner.state.params, runner.cfg, 1,
                            stats=load_stats(), device=self.dev)
        plain_loss = plain.eval_epoch(sampler)
        inputs, _ = runner._batch(runner.batch_at(
            sampler, np.arange(PREP_B)), None, False)
        with torch.no_grad():
            outs = [pose_net_forward(r.state.params, r.stage_cfg, inputs)[0]
                    for r in (runner, plain)]
        vs_plain = {"outputs": float((outs[0] - outs[1]).abs().max()),
                    "loss_rel": abs(valid_loss - plain_loss)
                    / abs(plain_loss),
                    "seconds": time.perf_counter() - t0}
        self.check(vs_plain["outputs"] <= STAGE_TOL
                   and vs_plain["loss_rel"] <= STAGE_TOL,
                   f"preprocess stage 1 vs the plain path: {vs_plain}")

        # counts and shapes against the raw lengths
        shapes = {"ori": (54,), "acc": (18,), "pose": (135,),
                  "full_pos": (24, 3), "leaf_pos": (5, 3)}
        expect = {"amass": 2 * sum(T // 300 for T in amass_T),
                  "dip_train": 2 * ((dip["s_01", "01"] - 12) // 300),
                  "dip_valid": (dip["s_01", "05"] - 12) // 300}
        for name, chunks in (("amass", amass), ("dip_train", dip_train),
                             ("dip_valid", dip_valid)):
            self.check(len(chunks) == expect[name],
                       f"preprocess {name}: {len(chunks)} chunks, want "
                       f"{expect[name]}")
            with np.load(out[name]) as z:
                got = {k: z[k].shape for k in z.files}
            self.check(got == {k: (expect[name], 300) + v
                               for k, v in shapes.items()},
                       f"preprocess {name} npz shapes {got}")
        for name, seqs, lengths in (("dip_test", dip_test,
                                     [T - 12 for T in test_T]),
                                    ("tc", tc, tc_T)):
            got = [{k: v.shape for k, v in s.items()} for s in seqs]
            self.check(got == [{k: (T,) + shapes[k]
                                for k in ("ori", "acc", "pose")}
                               for T in lengths],
                       f"preprocess {name} shapes {got}")
        finite = all(np.isfinite(v).all() for seqs in
                     (amass, dip_train, dip_valid, dip_test, tc)
                     for s in seqs for v in s.values())
        self.check(finite, "preprocess: an output is not finite")

        # the device part alone: AMASS FK + LBS at the sensor vertices,
        # DIP-IMU FK of the joints, TotalCapture's rotation conversion
        raws = list(FA.iter_amass_raw(paths.resolve(paths.raw_amass_dir),
                                      FA.TRAIN_SPLIT))

        model64 = model._astype(torch.float64)

        def skin_all():
            for r in raws:
                pose = FA._body_pose_24(r["poses"])
                p = R.axis_angle_to_rotation_matrix(model64.as_tensor(
                    pose.reshape(-1, 3))).reshape(-1, 24, 3, 3)
                FA._skin_sensors(model64, p, r["betas"], r["trans"],
                                 FA.AMASS_VI_MASK)
        dip_raw = next(FD.iter_dipimu_raw(paths.resolve(
            paths.raw_dipimu_dir), "train"))
        dip_p = R.axis_angle_to_rotation_matrix(model.as_tensor(
            dip_raw["pose"].reshape(-1, 3))).reshape(-1, 24, 3, 3)
        tc_raws = list(FT.iter_totalcapture_raw(paths.resolve(
            paths.raw_totalcapture_dir)))
        device_parts = (
            ("amass", "FK + LBS at the sensor vertices, fp64", skin_all,
             sum(amass_T)),
            ("dipimu_train", "FK of the joints",
             lambda: model.forward_kinematics(dip_p), dip_p.shape[0]),
            ("totalcapture", "axis-angle to rotation matrix",
             lambda: [R.axis_angle_to_rotation_matrix(model.as_tensor(
                 r["pose"].reshape(-1, 3))) for r in tc_raws],
             sum(r["pose"].shape[0] for r in tc_raws)))
        for name, what, run, frames in device_parts:
            run()                                     # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rows[name]["device_part"] = what
            rows[name]["device_part_frames_per_s"] = frames / sec

        # one sequence per corpus cut to PREP_CUT frames: the card against
        # the CPU, every output field
        cpu = data["cpu_model"]
        cut_amass = [{k: (v[:PREP_CUT] if k in ("poses", "trans")
                          else v) for k, v in raws[0].items()}]
        cut_dip = [{k: (v[:PREP_CUT] if k != "id" else v)
                    for k, v in dip_raw.items()}]
        cut_tc = [{k: (v[:PREP_CUT] if k != "id" else v)
                   for k, v in tc_raws[0].items()}]
        vs_cpu = {}
        for name, run in (
                ("amass", lambda m: FA.process_amass_split(
                    m, raw_iter=iter(cut_amass), sym=True)),
                ("dipimu", lambda m: FD.process_dipimu(
                    m, "train", sym=True, raw_iter=iter(cut_dip))),
                ("totalcapture", lambda m: FT.process_totalcapture(
                    m, raw_iter=iter(cut_tc)))):
            err, ok = factory_err(run(model), run(cpu))
            vs_cpu[name] = err
            self.check(ok, f"preprocess {name} card vs CPU: {err}")

        profile = self.eval_profile(lambda: FA.process_amass_split(
            model, raw_iter=iter(raws[:1])), 1)
        emit({"phase": "preprocess", "vertices": EVAL_VERTICES,
              "vi_mask": list(FA.AMASS_VI_MASK),
              "ji_mask": list(FA.AMASS_JI_MASK),
              "write_raw_s": data["write_s"], "rows": rows,
              "chunks": {k: len(v) for k, v in (
                  ("amass", amass), ("dip_train", dip_train),
                  ("dip_valid", dip_valid))},
              "test_sequences": {"dip_test": len(dip_test),
                                 "tc": len(tc)},
              "eval_epoch": {"chunks": n_chunks, "batch": PREP_B,
                             "hidden": STAGES[0][0], "loss": valid_loss,
                             "seconds": valid_s},
              "eval_epoch_vs_plain_path": vs_plain, "stage_tol": STAGE_TOL,
              "launches": counts,
              "vs_cpu_frames": PREP_CUT, "vs_cpu_max_abs_err": vs_cpu,
              "tol": dict(PREP_TOL, other=PREP_POS_TOL),
              "amass_profile": profile, "card": nvidia_smi()})

    def phase_cli_data(self):
        """The data subcommands as subprocesses on the card: ``cli
        preprocess --dataset dipimu --split test`` against the factory in
        process; ``cli evaluate --save_preds`` on its npz with two
        parameter sets (``.tar`` checkpoints), in children that count the
        kernel launches, while this process evaluates the first set on the
        plain path, against which its dumped poses are held; ``cli
        worst-frames`` on their dumps against
        ``compare_models`` in process (the 18-pickle layout, the printed
        selections); ``cli convert-data`` on both reference layouts against
        ``np.load``. No phase renders (the card's machine has no Pillow)."""
        import pickle
        import numpy as np
        from a3gc_tpu_torch.compat import torch_export as TE
        from a3gc_tpu_torch.data import load_adjacency_template, load_stats
        from a3gc_tpu_torch.data.factory import dipimu as FD
        from a3gc_tpu_torch.eval import CascadeEvaluator, compare_models
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        torch = self.torch
        data = self.prep_data()
        tmp = data["tmp"]
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        cli = [sys.executable, "-m", "a3gc_tpu_torch.cli"]
        walls = {}

        def run_all(jobs, meanwhile=None):
            """Start every (name, argv, cwd) at once, run ``meanwhile()``
            here, wait for all."""
            t0 = time.perf_counter()
            procs = [(name, subprocess.Popen(
                argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
                for name, argv, cwd in jobs]
            done = {}
            try:
                if meanwhile is not None:
                    meanwhile()
            finally:
                for name, proc in procs:
                    try:
                        out, err = proc.communicate(timeout=600)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        out, err = proc.communicate()
                    done[name] = (proc.returncode, out, err)
            for name, (rc, _, err) in done.items():
                self.check(rc == 0, f"cli_data {name} exited {rc}:\n"
                           + err[-3000:])
            walls[" + ".join(n for n, _, _ in jobs)] = \
                time.perf_counter() - t0
            return done

        test_npz = os.path.join(tmp, "cli_dip_test.npz")
        done = run_all([("preprocess", cli + [
            "preprocess", "--dataset", "dipimu", "--split", "test",
            "--data_root", tmp, "--smpl", data["smpl"], "--output",
            test_npz], tmp)])
        if done["preprocess"][0] != 0:
            return
        want = FD.process_dipimu(data["model"], "test",
                                 paths=data["paths"])
        err, ok = factory_err(FD.load_test_sequences(test_npz), want)
        self.check(ok, f"cli preprocess vs in-process: {err}")

        # two parameter sets: seeds 0 and 7, stage 3 near rotations
        cfg = self.cascade("a3gc", "auto")
        runs, params = {}, {}
        for tag, seed in (("a", 0), ("b", 7)):
            gen = torch.Generator().manual_seed(seed)
            params3 = [init_pose_net(gen, c, load_adjacency_template())
                       for c in cfg.stages]
            near_rotation_outputs(params3[2])
            params[tag] = params3
            cwd = os.path.join(tmp, f"eval_{tag}")
            os.makedirs(cwd)
            tars = []
            for i, p in enumerate(params3):
                tars.append(os.path.join(cwd, f"s{i + 1}.tar"))
                TE.save_torch_checkpoint(tars[-1],
                                         TE.graph_net_state_dict(p, "a3gc"))
            runs[tag] = ([sys.executable, "-c", TRAIN_CHILD, "evaluate",
                          "--model", "a3gc", "--norm", "--smpl",
                          data["smpl"], "--save_preds", "--datasets",
                          test_npz, "--precision", "highest",
                          "--torch_checkpoints"] + tars, cwd)
        # the reference's packed layouts for convert-data
        rng = np.random.default_rng(3)
        N, T = 4, 300
        stacked = {"ori": torch.as_tensor(random_rotations(
                       rng, (N, T, 6))).reshape(N, T, 6, 3, 3),
                   "acc": torch.as_tensor(rng.normal(size=(N, T, 6, 3))),
                   "pose": torch.as_tensor(random_rotations(
                       rng, (N, T, 15))).reshape(N, T, 15, 3, 3),
                   "full_pos": torch.as_tensor(rng.normal(
                       size=(N, T, 24, 3))),
                   "leaf_pos": torch.as_tensor(rng.normal(
                       size=(N, T, 5, 3)))}
        lengths = (1200, 777)
        lists = {"ori": [torch.as_tensor(random_rotations(rng, (n, 6)))
                         for n in lengths],
                 "acc": [torch.as_tensor(rng.normal(size=(n, 18)))
                         for n in lengths],
                 "pose": [torch.as_tensor(random_rotations(rng, (n, 15)))
                          for n in lengths]}
        jobs = [(f"evaluate_{t}", argv, cwd) for t, (argv, cwd)
                in runs.items()]
        for name, obj in (("stacked", stacked), ("lists", lists)):
            pt = os.path.join(tmp, f"{name}.pt")
            torch.save(obj, pt)
            jobs.append((f"convert_{name}", cli + [
                "convert-data", "--torch", pt, "--output",
                os.path.join(tmp, f"{name}_converted.npz")], tmp))
        # while the children run: model A's per-sequence predictions on the
        # plain path, for its dumps
        plain = {}

        def plain_preds():
            t0 = time.perf_counter()
            ev = CascadeEvaluator(
                tuple(p.to(self.dev) for p in params["a"]),
                self.cascade("a3gc", "eager"), data["model"], load_stats(),
                normalize=True, device=self.dev)
            plain["preds"] = ev.evaluate(FD.load_test_sequences(test_npz),
                                         return_preds=True)[3]
            plain["seconds"] = time.perf_counter() - t0
        done = run_all(jobs, plain_preds)
        launches = {k: 0 for k in LIBRARIES}
        n_seqs = len(want)
        for tag in runs:
            rc, out, _ = done[f"evaluate_{tag}"]
            if rc != 0:
                return
            child = json.loads(out.strip().splitlines()[-1])
            self.check(not child["banned"],
                       f"cli evaluate imported {child['banned']}")
            for k, v in child["launches"].items():
                launches[k] += v
        self.launches["cli_data"] = launches
        # a warm-up sequence and each test sequence, 6 layer calls each
        want_launches = 2 * 6 * (n_seqs + 1)
        self.check(launches == {k: (want_launches if k == "gcn_lstm" else 0)
                                for k in LIBRARIES},
                   f"cli_data launches {launches}, want {want_launches}")
        for name, obj in (("stacked", stacked), ("lists", lists)):
            with np.load(os.path.join(tmp, f"{name}_converted.npz")) as z:
                got = {k: z[k] for k in z.files}
            if name == "stacked":
                ref = {"ori": obj["ori"].reshape(N, T, 54),
                       "acc": obj["acc"].reshape(N, T, 18),
                       "pose": obj["pose"].reshape(N, T, 135),
                       "full_pos": obj["full_pos"],
                       "leaf_pos": obj["leaf_pos"]}
            else:
                ref = {f"seq{i}_{k}": v[i].reshape(n, -1)
                       for k, v in obj.items()
                       for i, n in enumerate(lengths)}
            ok = (sorted(got) == sorted(ref) and all(
                got[k].dtype == np.float32 and np.array_equal(
                    got[k], ref[k].numpy().astype(np.float32))
                for k in ref))
            self.check(ok, f"cli convert-data {name}: "
                       f"{sorted(got)} vs {sorted(ref)}")

        # worst frames of model B against model A
        dumps = {t: os.path.join(tmp, f"eval_{t}", "evaluation_results",
                                 "sequences", "dip", "a3gc")
                 for t in runs}
        out_dir = os.path.join(tmp, "best_worst")
        done = run_all([("worst_frames", cli + [
            "worst-frames", "--smpl", data["smpl"], "--gt",
            os.path.join(dumps["a"], "gt"), "--pred_a",
            os.path.join(dumps["a"], "pred"), "--pred_b",
            os.path.join(dumps["b"], "pred"), "--output", out_dir], tmp)])
        if done["worst_frames"][0] != 0:
            return
        printed = {line.split(" ", 1)[0]: json.loads(line.split(" ", 1)[1])
                   for line in done["worst_frames"][1].splitlines()
                   if line.split(" ", 1)[0] in (
                       "b_improves_most", "b_regresses_most", "a_worst",
                       "a_best", "b_worst", "b_best")}

        def load(d):
            files = sorted(f for f in os.listdir(d) if f.endswith(".p"))
            self.check(len(files) == n_seqs, f"dumps in {d}: {files}")
            out = []
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    out.append(pickle.load(fh))
            return out

        gts = load(os.path.join(dumps["a"], "gt"))
        preds_a = load(os.path.join(dumps["a"], "pred"))
        vs_plain = float(max(np.abs(g - w).max() for g, w in
                             zip(preds_a, plain["preds"])))
        self.check(len(preds_a) == len(plain["preds"])
                   and vs_plain <= PATH_TOL,
                   f"cli evaluate --save_preds vs the plain path: "
                   f"{vs_plain:.3e}")
        result = compare_models(data["model"], gts, preds_a,
                                load(os.path.join(dumps["b"], "pred")))
        self.check(printed == result,
                   f"cli worst-frames {printed} vs in-process {result}")
        layout = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                        for d, _, fs in os.walk(out_dir) for f in fs)
        nested = [p for p in layout if os.sep in p]
        self.check(len(layout) == 6 + 18 and len(nested) == 18,
                   f"cli worst-frames layout {layout}")
        emit({"phase": "cli_data", "test_sequences": n_seqs,
              "test_frames": [int(s["ori"].shape[0]) for s in want],
              "preprocess_vs_in_process_max_abs_err": err,
              "evaluate_launches": launches,
              "preds_a_vs_plain_path_max_abs_err": vs_plain,
              "plain_path_s": plain["seconds"], "tol": PATH_TOL,
              "worst_frames": result,
              "worst_frames_files": len(layout), "wall_s": walls,
              "card": nvidia_smi()})

    # -- 5: training ---------------------------------------------------------
    def phase_kernel_grad(self):
        """Gradients of a scalar loss (random weights on every output) with
        respect to the input, the initial state and every parameter,
        through each kernel op (the kernel's forward, the plain version's
        backward: ``ops/library.py``) against autograd through the plain
        version, on the card at full width."""
        from a3gc_tpu_torch.ops import gcn_lstm as G
        from a3gc_tpu_torch.ops import ggru as GG
        from a3gc_tpu_torch.ops import lstm as LS
        torch = self.torch
        gen = torch.Generator().manual_seed(5)
        S, T = S_SERVE, WINDOW
        cases = ([("gcn_lstm", H, 2) for H, _, _, _ in STAGES]
                 + [("ggru", H, 2) for H, _, _, _ in STAGES]
                 + [("lstm", H, D) for H in (TP_STAGES[0][0], DIP[0])
                    for D in (2, 1)])
        rows = []
        for name, H, D in cases:
            F = 2 * H if D == 2 else H
            if name == "lstm":
                p = self.lstm_layer(gen, F, H, D)
                x, st, nv = self.layer_inputs(gen, S, T, F, H, ragged(S),
                                              nodes=False, D=D)
                fns = (LS.bi_lstm, LS.bi_lstm_reference)
            else:
                p = self.cell(gen, "a3gc" if name == "gcn_lstm" else "ggru",
                              F, H)
                x, st, nv = self.layer_inputs(
                    gen, S, T, F, H, ragged(S),
                    n_state=2 if name == "gcn_lstm" else 1)
                fns = ((G.bi_gcn_lstm, G.bi_gcn_lstm_reference)
                       if name == "gcn_lstm"
                       else (GG.bi_ggru, GG.bi_ggru_reference))
            grads, ms, weights = [], [], None
            for fn in fns:
                xx = x.detach().requires_grad_()
                ss = tuple(t.detach().requires_grad_() for t in leaves(st))
                state = ss if name != "ggru" else ss[0]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.enable_grad():
                    out = leaves(fn(p, xx, state, nv))
                    if weights is None:
                        weights = [torch.randn(o.shape, generator=gen)
                                   .to(self.dev) for o in out]
                    loss = sum((o * w).sum() for o, w in zip(out, weights))
                    grads.append(torch.autograd.grad(
                        loss, [xx, *ss, *p.parameters()]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            err = max(float((a - b).abs().max())
                      / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(*grads))
            finite = all(bool(torch.isfinite(g).all()) for g in grads[0])
            self.max_grad_err[name] = max(self.max_grad_err.get(name, 0.0),
                                          err)
            self.check(err <= GRAD_TOL and finite,
                       f"kernel_grad {name} H={H} D={D}: {err:.3e} "
                       f"relative, finite={finite}")
            rows.append({"kernel": name, "H": H, "F": F, "D": D, "S": S,
                         "T": T, "max_rel_err": err, "finite": finite,
                         "op_fwd_bwd_ms": ms[0], "plain_fwd_bwd_ms": ms[1]})
        emit({"phase": "kernel_grad", "tol": GRAD_TOL, "cases": rows,
              "card": nvidia_smi()})

    def phase_train(self):
        """``cli train`` of the A3GC cascade at full width and of DIP, each
        in a child process that reports the kernel launches of its
        validation passes; the two children run at once."""
        import shutil
        import tempfile
        from concurrent.futures import ThreadPoolExecutor
        import numpy as np
        from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
        from a3gc_tpu_torch.utils import discover_latest
        tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            train = os.path.join(tmp, "train.npz")
            valid = os.path.join(tmp, "valid.npz")
            np.savez(train, **synthetic_packed_dataset(TRAIN_SEQS, TRAIN_T,
                                                       seed=0))
            np.savez(valid, **synthetic_packed_dataset(VALID_SEQS, TRAIN_T,
                                                       seed=1))
            env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            # validation: one chunk of VALID_SEQS a stage, one launch a
            # layer call (two a net)
            runs = (("train", ["--model", "a3gc"]
                     + [f"--hu{i + 1}={s[0]}" for i, s in enumerate(STAGES)]
                     + ["--norm"], 3, "gcn_lstm", 2),
                    ("train_dip", ["--model", "dip", f"--hu1={DIP[0]}"], 1,
                     "lstm", 2))
            # both children at once (a cut for the script's time: they
            # used to run one after the other)
            procs = []
            for path, argv, n_stages, kernel, per_stage in runs:
                argv = (["train", "-b", str(TRAIN_B), "--epochs", "1",
                         "--name", path, "--save_root", tmp, "--train_data",
                         train, "--valid_data", valid] + argv)
                procs.append((argv, time.perf_counter(), subprocess.Popen(
                    [sys.executable, "-c", TRAIN_CHILD] + argv, cwd=tmp,
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))

            def collect(item):
                _, t0, proc = item
                try:
                    out, err = proc.communicate(timeout=900)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, err = proc.communicate()
                return out, err, time.perf_counter() - t0

            with ThreadPoolExecutor(len(procs)) as pool:
                done = list(pool.map(collect, procs))
            for (path, _, n_stages, kernel, per_stage), (argv, _, proc), \
                    (out, err, wall) in zip(runs, procs, done):
                self.check(proc.returncode == 0,
                           f"{path}: cli train exited {proc.returncode}:\n"
                           + err[-3000:])
                if proc.returncode != 0:
                    continue
                child = json.loads(out.strip().splitlines()[-1])
                counts = child["launches"]
                self.launches[path] = counts
                self.check(not child["banned"],
                           f"{path} imported {child['banned']}")
                self.check(counts == {k: (per_stage * n_stages
                                          if k == kernel else 0)
                                      for k in LIBRARIES},
                           f"{path} launches {counts}, want "
                           f"{per_stage * n_stages} of {kernel}")
                with open(os.path.join(tmp, path, "train_log.jsonl")) as f:
                    log = [json.loads(line) for line in f]
                self.check([e["stage"] for e in log]
                           == list(range(1, n_stages + 1)),
                           f"{path} log stages {[e['stage'] for e in log]}")
                finite = bool(np.isfinite([[e["train_loss"],
                                            e["valid_loss"]]
                                           for e in log]).all())
                self.check(finite, f"{path} losses not finite: {log}")
                found = [discover_latest(os.path.join(tmp, path), s)
                         for s in range(1, n_stages + 1)]
                self.check(all(found), f"{path} checkpoints {found}")
                emit({"phase": path, "argv": argv[:5] + argv[13:],
                      "batch": TRAIN_B, "frames": TRAIN_T,
                      "train_sequences": TRAIN_SEQS,
                      "valid_sequences": VALID_SEQS, "wall_s": wall,
                      "launches": counts,
                      "log": [{k: e[k] for k in ("stage", "epoch",
                                                 "train_loss", "valid_loss",
                                                 "seconds")} for e in log],
                      "checkpoints": [os.path.basename(f[0]) for f in found
                                      if f],
                      "card": nvidia_smi()})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def train_runner(self, kind, stage, tc):
        from a3gc_tpu_torch.data import load_stats
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        from a3gc_tpu_torch.train import DIPRunner, StageRunner
        gen = self.torch.Generator().manual_seed(stage)
        if kind == "dip":
            cfg = self.dip_cfg("auto")
            return DIPRunner(cfg, init_pose_net(gen, cfg), tc, 1,
                             load_stats(), device=self.dev)
        from a3gc_tpu_torch.data import load_adjacency_template
        cfg = self.cascade(kind, "auto").stages[stage - 1]
        return StageRunner(stage, cfg,
                           init_pose_net(gen, cfg, load_adjacency_template()),
                           tc, 1, stats=load_stats(), graph=kind != "tp",
                           device=self.dev)

    def step_profile(self, runner, raw):
        """One training step under torch.profiler (device activity only):
        its wall time, the device's busy time and share, and the number of
        device kernels it ran."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from a3gc_tpu_torch.train import seeded_generator
        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.train_step(raw, seeded_generator(self.dev, 9))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, kernels = 0.0, 0
        for ev in prof.key_averages():
            if (getattr(ev, "device_type", None) != DeviceType.CUDA
                    or getattr(ev, "is_user_annotation", False)):
                continue
            busy_us += getattr(ev, "self_device_time_total",
                               getattr(ev, "self_cuda_time_total", 0))
            kernels += ev.count
        if busy_us == 0:
            return "not measured: the profiler recorded no device time"
        return {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
                "device_busy_share": busy_us / wall_us,
                "device_kernels": kernels}

    def phase_train_times(self):
        """Training frames/s at full width: TRAIN_TIMED_STEPS steps fenced
        by synchronize() (after one warm-up step at each net's first row);
        peak memory; one validation chunk of the same batch through the
        kernels."""
        import numpy as np
        from a3gc_tpu_torch.config import TrainConfig
        from a3gc_tpu_torch.data import pipeline as DP
        from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
        from a3gc_tpu_torch.train import seeded_generator
        torch = self.torch
        data = DP.put_device(synthetic_packed_dataset(
            max(TRAIN_TIMED_B), TRAIN_TIMED_T, seed=2), self.dev)
        rows = []
        for kind, stage in (("a3gc", 1), ("a3gc", 2), ("a3gc", 3),
                            ("ggru", 1), ("tp", 1), ("dip", 1)):
            for dtype in (("float32", "bfloat16") if (kind, stage) in
                          TRAIN_BF16_NETS else ("float32",)):
                for B in TRAIN_TIMED_B:
                    tc = TrainConfig(batch_size=B, dtype=dtype,
                                     normalize=True)
                    runner = self.train_runner(kind, stage, tc)
                    raw = DP.gather(data, torch.arange(B, device=self.dev))
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(self.dev)
                    warm_s = None
                    if dtype == "float32" and B == TRAIN_TIMED_B[0]:
                        # the first step at a net's shapes (allocations,
                        # library heuristics), untimed
                        t0 = time.perf_counter()
                        runner.train_step(raw, seeded_generator(self.dev, 0))
                        torch.cuda.synchronize()
                        warm_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    losses = [runner.train_step(
                        raw, seeded_generator(self.dev, i + 1))
                        for i in range(TRAIN_TIMED_STEPS)]
                    torch.cuda.synchronize()
                    step_s = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
                    peak = torch.cuda.max_memory_allocated(self.dev)
                    losses = [float(v) for v in losses]
                    self.check(bool(np.isfinite(losses).all()),
                               f"train_times {kind} {stage} {dtype} B={B}: "
                               f"losses {losses}")
                    with torch.no_grad():
                        params = runner.state.params
                        valid_ms = cuda_ms(
                            lambda: runner.loss(params, raw, None), 3,
                            warmup=1)
                    profile = None
                    if (kind, stage, dtype, B) == ("a3gc", 1, "float32",
                                                   TRAIN_B):
                        try:
                            profile = self.step_profile(runner, raw)
                        except Exception as e:   # a measurement aid
                            profile = (f"not measured: the profiler raised "
                                       f"{e!r}")
                    rows.append({
                        "net": kind, "stage": stage, "dtype": dtype,
                        "batch": B, "frames": TRAIN_TIMED_T,
                        "hidden": (DIP[0] if kind == "dip" else
                                   (TP_STAGES if kind == "tp"
                                    else STAGES)[stage - 1][0]),
                        "step_s": step_s, "warmup_step_s": warm_s,
                        "frames_per_s": B * TRAIN_TIMED_T / step_s,
                        "valid_chunk_ms": valid_ms,
                        "peak_memory_gib": peak / 2 ** 30,
                        "losses": losses, "profile": profile})
                    del runner, raw
        emit({"phase": "train_times", "steps": TRAIN_TIMED_STEPS,
              "rows": rows, "card": nvidia_smi()})

    def phase_tp(self):
        """Tensor parallelism on the card: a model group of two
        (``make_mesh(MeshConfig(data=1, model=2), devices=[dev, dev])``, its
        members in turn) and a (2, 2) mesh over the card listed four times.
        A3GC stage 1 at H = 256, B = TPAR_B, T = TRAIN_T, the default
        dropout and noise: two steps of a TP ``StageRunner`` against an
        unsharded one on the same parameters and per-step generators, in
        turns (TP, unsharded, unsharded, TP), the loss and every parameter
        within STAGE_TOL (relative; a leaf's norm, its largest element
        reported), the first step's gradients within GRAD_TOL (largest
        element); one step on (2, 2) likewise, first and untimed; ``eval_epoch`` over
        TPAR_SEQS sequences through ``gcn_lstm.cu`` on the gathered weights
        against the unsharded runner's kernel path (after the (1, 2)
        runner's two steps) and the plain path on the same weights (both
        runners), timed in turns. G-GRU and TransPose stage 1
        (``ggru.cu``, ``lstm.cu``): a step and a validation each, held the
        same way. DIP on the ``model = 2`` mesh (replicated parameters,
        data = 1): a step bit-equal to the unsharded runner, and its
        validation. The device kernels of a TPAR_PROFILE_T-frame A3GC step
        from torch.profiler, TP and unsharded. ``cli train --tp 2`` on one
        card exits with JAX's message (on several: ``--mesh --tp 2``
        runs an epoch)."""
        import numpy as np
        from a3gc_tpu_torch import cli
        from a3gc_tpu_torch.config import MeshConfig, TrainConfig
        from a3gc_tpu_torch.data import (load_adjacency_template,
                                         load_stats)
        from a3gc_tpu_torch.data import pipeline as DP
        from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset
        from a3gc_tpu_torch.models.pipeline import init_pose_net
        from a3gc_tpu_torch.parallel import make_mesh
        from a3gc_tpu_torch.train import (DIPRunner, StageRunner,
                                          seeded_generator)
        torch = self.torch
        m12 = make_mesh(MeshConfig(data=1, model=2), devices=[self.dev] * 2)
        m22 = make_mesh(MeshConfig(data=2, model=2), devices=[self.dev] * 4)
        tc = TrainConfig(batch_size=TPAR_B, normalize=True)
        host = synthetic_packed_dataset(TPAR_SEQS, TRAIN_T, seed=4)
        data = DP.put_device(host, self.dev)
        batches = [DP.gather(data, torch.arange(i * TPAR_B, (i + 1) * TPAR_B,
                                                device=self.dev))
                   for i in range(2)]

        def runner(kind, mesh=None, backend="auto", params=None):
            gen = torch.Generator().manual_seed(1)
            if kind == "dip":
                cfg = self.dip_cfg(backend)
                if params is None:
                    params = init_pose_net(gen, cfg)
                return DIPRunner(cfg, params, tc, 1, load_stats(),
                                 device=self.dev, mesh=mesh)
            cfg = self.cascade(kind, backend).stages[0]
            if params is None:
                params = init_pose_net(gen, cfg, load_adjacency_template())
            return StageRunner(1, cfg, params, tc, 1, stats=load_stats(),
                               graph=kind != "tp", device=self.dev,
                               mesh=mesh)

        def step(r, i, times=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(r.train_step(batches[i],
                                      seeded_generator(self.dev, 4, i)))
            torch.cuda.synchronize()
            if times is not None:
                times.append((time.perf_counter() - t0) * 1e3)
            return loss

        def rel(a, b):
            return float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)

        def param_err(tp, single, norm=True):
            # norm: each leaf's |a - b| / |b| (Frobenius); else its largest
            # element's. One Adam step moves an entry whose gradient is
            # near eps by lr·dg/eps, so a 1e-7 gradient difference can move
            # single entries by 1e-4 of the leaf's largest while the leaf
            # as a whole agrees to 1e-7.
            want = dict(single.state.params.named_parameters())
            return max((float(torch.linalg.vector_norm(p - want[n]))
                        / float(torch.linalg.vector_norm(want[n]))) if norm
                       else rel(p.detach(), want[n].detach())
                       for n, p in tp.state.params.named_parameters())

        def grad_err(tp, single):
            named = [dict(m.named_parameters()) for m in tp.state.master]
            err = 0.0
            for n, p in single.state.params.named_parameters():
                g = (torch.cat([m[n].grad for m in named], -1)
                     if n in tp._split else named[0][n].grad)
                err = max(err, rel(g, p.grad))
            return err

        report, evals, times = {}, {}, {"tp": [], "unsharded": []}
        self.zero_counts()                            # the main path starts
        # A3GC stage 1: steps in turns, then (2, 2), then validation
        tp, single, tp22 = (runner("a3gc", m) for m in (m12, None, m22))
        loss22 = step(tp22, 0)                # untimed: the first TP step
        losses = {"tp": [step(tp, 0, times["tp"])],
                  "unsharded": [step(single, 0, times["unsharded"])]}
        grad0 = grad_err(tp, single)
        err22 = (abs(loss22 - losses["unsharded"][0])
                 / abs(losses["unsharded"][0]), param_err(tp22, single),
                 param_err(tp22, single, norm=False))
        losses["unsharded"].append(step(single, 1, times["unsharded"]))
        losses["tp"].append(step(tp, 1, times["tp"]))
        valid = DP.Sampler(host, TPAR_B, shuffle=False)
        evals["a3gc"] = tp.eval_epoch(valid)
        evals["a3gc_2x2"] = tp22.eval_epoch(valid)
        family = {}
        for kind in ("ggru", "tp"):
            t, u = runner(kind, m12), runner(kind)
            lt, lu = step(t, 0), step(u, 0)
            family[kind] = (t, u, lt, lu, grad_err(t, u))
            evals[kind] = t.eval_epoch(valid)
        dip_tp, dip = runner("dip", m12), runner("dip")
        dip_losses = (step(dip_tp, 0), step(dip, 0))
        evals["dip"] = dip_tp.eval_epoch(valid)
        counts = self.counts()                        # the main path ended

        # the comparisons: the unsharded runners' launches do not count
        want = {"a3gc": single.eval_epoch(valid)}
        plain = runner("a3gc", backend="eager", params=tp.state.params)
        want_plain = {"a3gc": plain.eval_epoch(valid), "a3gc_2x2": runner(
            "a3gc", backend="eager",
            params=tp22.state.params).eval_epoch(valid)}
        eval_ms = {"tp": [], "unsharded": []}
        for name, r in (("tp", tp), ("unsharded", single),
                        ("unsharded", single), ("tp", tp)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.eval_epoch(valid)
            torch.cuda.synchronize()
            eval_ms[name].append((time.perf_counter() - t0) * 1e3)
        for kind, (t, u, lt, lu, g) in family.items():
            want[kind] = u.eval_epoch(valid)
            want_plain[kind] = runner(kind, backend="eager",
                                      params=t.state.params).eval_epoch(valid)
            rep = {"loss_rel_err": abs(lt - lu) / abs(lu),
                   "param_rel_err": param_err(t, u),
                   "param_max_element_rel_err": param_err(t, u, norm=False),
                   "grad_rel_err": g, "split": len(t._split)}
            report[kind] = rep
            self.check(rep["loss_rel_err"] <= STAGE_TOL
                       and rep["param_rel_err"] <= STAGE_TOL
                       and g <= GRAD_TOL,
                       f"tp {kind}: {rep}")
        want["dip"] = dip.eval_epoch(valid)
        for k, n in counts.items():                   # the twins' launches
            self.wrappers[k].launches = n             # do not count

        prof = {}
        for name, r in (("tp", tp), ("unsharded", single)):
            raw = {k: v[:, :TPAR_PROFILE_T] for k, v in batches[0].items()}
            try:
                prof[name] = self.step_profile(r, raw)
            except Exception as e:                    # a measurement aid
                prof[name] = f"not measured: the profiler raised {e!r}"
        # the command line: --tp 2 on this machine's cards
        n_cards = torch.cuda.device_count()
        argv = ["train", "--tp", "2", "-b", str(TPAR_B), "--train_data",
                "missing.npz", "--valid_data", "missing.npz"]
        cli_out = None
        if n_cards % 2:
            try:
                cli.main(argv)
            except SystemExit as e:
                cli_out = str(e)
            self.check(cli_out is not None and
                       f"--tp 2 must divide {n_cards} devices" in cli_out,
                       f"tp: cli train --tp 2 on {n_cards} card(s): "
                       f"{cli_out}")
        else:
            import shutil
            import tempfile
            tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
            try:
                paths = []
                for name, n in (("train", 2 * TPAR_B), ("valid", TPAR_B)):
                    paths.append(os.path.join(tmp, name + ".npz"))
                    np.savez(paths[-1], **synthetic_packed_dataset(
                        n, TRAIN_T, seed=5))
                cli.main(["train", "--mesh", "--tp", "2", "-b",
                          str(2 * TPAR_B), "--epochs", "1", "--norm",
                          "--train_data", paths[0], "--valid_data", paths[1],
                          "--save_root", tmp, "--name", "tp"])
                with open(os.path.join(tmp, "tp", "train_log.jsonl")) as f:
                    cli_out = [json.loads(line) for line in f]
                self.check(len(cli_out) == 3 and all(
                    np.isfinite(e["valid_loss"]) for e in cli_out),
                    f"tp: cli train --mesh --tp 2: {cli_out}")
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            for k, n in counts.items():
                self.wrappers[k].launches = n
        self.launches["tp"] = counts

        loss_err = max(abs(a - b) / abs(b) for a, b in zip(
            losses["tp"], losses["unsharded"]))
        a3gc_err = param_err(tp, single)
        self.check(loss_err <= STAGE_TOL and a3gc_err <= STAGE_TOL
                   and grad0 <= GRAD_TOL,
                   f"tp a3gc: loss {loss_err:.3e}, params {a3gc_err:.3e}, "
                   f"gradients {grad0:.3e}")
        self.check(max(err22[:2]) <= STAGE_TOL,
                   f"tp a3gc (2, 2): loss / params {err22}")
        dip_equal = dip_losses[0] == dip_losses[1] and all(
            torch.equal(a, b) for a, b in zip(dip_tp.state.params.parameters(),
                                              dip.state.params.parameters()))
        self.check(dip_tp._split is None and dip_equal,
                   "tp dip: the model = 2 step is not bit-equal to the "
                   "unsharded one")
        eval_err = {k: abs(v - want[k]) / abs(want[k]) for k, v in
                    evals.items() if k in want}
        plain_err = {k: abs(evals[k] - v) / abs(v)
                     for k, v in want_plain.items()}
        self.check(all(np.isfinite(v) for v in evals.values())
                   and max(eval_err.values()) <= STAGE_TOL
                   and max(plain_err.values()) <= STAGE_TOL,
                   f"tp validation: vs unsharded {eval_err}, vs plain "
                   f"{plain_err}")
        # a two-layer net's validation pass: 2 launches a chunk of TPAR_B
        # (on (2, 2) a chunk splits over two shards: twice that)
        per_pass = 2 * (TPAR_SEQS // TPAR_B)
        want_counts = {"gcn_lstm": 3 * per_pass, "ggru": per_pass,
                       "lstm": 2 * per_pass}
        self.check(counts == want_counts,
                   f"tp launches {counts}, want {want_counts}")
        emit({"phase": "tp", "mesh": repr(m12), "mesh_2x2": repr(m22),
              "batch": TPAR_B, "frames": TRAIN_T, "sequences": TPAR_SEQS,
              "a3gc": {"hidden": STAGES[0][0], "split": len(tp._split),
                       "losses": losses, "loss_rel_err": loss_err,
                       "param_rel_err": a3gc_err,
                       "param_max_element_rel_err": param_err(
                           tp, single, norm=False),
                       "grad_rel_err": grad0,
                       "mesh_2x2_loss_param_rel_err": err22,
                       "ms_per_step": times,
                       "ms_per_step_ratio": float(np.mean(times["tp"])
                                                  / np.mean(times[
                                                      "unsharded"])),
                       "eval_ms": eval_ms,
                       "eval_ms_ratio": float(np.mean(eval_ms["tp"])
                                              / np.mean(eval_ms[
                                                  "unsharded"])),
                       "profile_frames": TPAR_PROFILE_T, "profile": prof},
              "families": report, "dip_bit_equal": dip_equal,
              "valid_loss": evals, "valid_rel_err_vs_unsharded": eval_err,
              "valid_rel_err_vs_plain": plain_err, "cli": cli_out,
              "launches": counts, "tol": STAGE_TOL, "card": nvidia_smi()})

    # -- the driver entry points ---------------------------------------------
    def unplanned_net(self, kind, H, backend):
        """A net at hidden width ``H`` (``GRAFT_UNPLANNED``), precision
        "default", random weights from seed 3: (apply, params, cfg, x) at
        S = 8, T = 60."""
        from a3gc_tpu_torch.data import load_adjacency_template
        from a3gc_tpu_torch.models import nets as N
        torch = self.torch
        gen = torch.Generator().manual_seed(3)
        if kind == "tp":
            cfg = N.DIPConfig(n_input=TP_STAGES[0][1],
                              n_output=TP_STAGES[0][2], n_hidden=H,
                              precision="default", backend=backend)
            params = N.init_dip(gen, cfg).to(self.dev)
            x = torch.randn((S_SERVE, WINDOW, cfg.n_input), generator=gen)
            return N.dip_apply, params, cfg, x.to(self.dev)
        cfg = N.GraphNetConfig(cell=kind, units_in=12, units_out=9,
                               units_hidden=H, precision="default",
                               backend=backend)
        params = N.init_graph_net(gen, cfg, load_adjacency_template())
        x = torch.randn((S_SERVE, WINDOW, N_NODES, 12), generator=gen)
        return N.graph_net_apply, params.to(self.dev), cfg, x.to(self.dev)

    def phase_graft_entry(self):
        """The driver entry points of ``a3gc_tpu_torch.graft_entry`` and
        the dispatch at widths with no launch plan. ``entry()`` on the card
        (A3GC 256 / 64 / 128, S = 1, T = 300, "default": six TF32
        ``gcn_lstm`` launches) against the same cascade at backend="eager"
        in degrees (stage 3 near rotations), its ``torch.export`` check,
        ``dryrun_multichip(8)`` over the card listed 8 times: the path's
        launches. Then at each ``GRAFT_UNPLANNED`` width a net at
        backend="auto" bit-equal to "eager" with no launch and its layer
        calls counted as plain dispatches, backend="cuda" raising at
        H = 80, one ``cli._build_server`` window at ``--hu1 80`` and a ``cli
        export --hu1 80 --precision highest`` artifact stepped against the
        live session."""
        import dataclasses
        import io
        import shutil
        import tempfile
        import threading
        import numpy as np
        from a3gc_tpu_torch import cli, graft_entry
        from a3gc_tpu_torch import export as X
        from a3gc_tpu_torch.client import PoseClient
        from a3gc_tpu_torch.eval.streaming import StreamingCascade
        from a3gc_tpu_torch.models.pipeline import cascade_apply
        from a3gc_tpu_torch.ops.rotations import angle_between
        from a3gc_tpu_torch.smpl import ParametricModel
        torch = self.torch
        seconds = {}
        t0 = time.perf_counter()
        cfg, _, body, _ = graft_entry._flagship(device=self.dev)
        fn, (params3, imu) = graft_entry.entry(device=self.dev)
        near_rotation_outputs(params3[2])
        imu = torch.as_tensor(np.random.default_rng(19).normal(
            scale=0.5, size=tuple(imu.shape)).astype(np.float32),
            device=self.dev)
        with torch.no_grad():
            self.zero_counts()                        # the main path starts
            pose = fn(params3, imu)
            torch.cuda.synchronize()
            entry_counts = {**self.counts(), **self.tf32_counts()}
            eager = dataclasses.replace(cfg, **{
                f"stage{i + 1}": dataclasses.replace(
                    s, net=dataclasses.replace(s.net, backend="eager"))
                for i, s in enumerate(cfg.stages)})
            plain = cascade_apply(params3, eager, body, imu, device=self.dev)
            deg = torch.rad2deg(angle_between(pose.reshape(-1, 3, 3),
                                              plain.reshape(-1, 3, 3)))
        angle = {"mean": float(deg.mean()), "max": float(deg.max())}
        self.check(pose.shape == (300, 24, 3, 3)
                   and bool(torch.isfinite(pose).all())
                   and angle["mean"] <= PREC_ANGLE_MEAN
                   and angle["max"] <= PREC_ANGLE_MAX,
                   f"graft_entry: entry() vs plain {angle} deg")
        self.check(entry_counts["gcn_lstm"] == 6
                   and entry_counts["gcn_lstm_tf32"] == 6
                   and sum(entry_counts.values()) == 12,
                   f"graft_entry: entry() launches {entry_counts}")
        seconds["entry"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = graft_entry.compile_check(fn, params3, imu)
        self.check(compiled, "graft_entry: compile check")
        seconds["compile_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graft_entry.dryrun_multichip(GRAFT_DEVICES,
                                     devices=[self.dev] * GRAFT_DEVICES)
        torch.cuda.synchronize()
        counts = {**self.counts(), **self.tf32_counts()}
        self.launches["graft_entry"] = counts         # the main path ended
        dry = {k: counts[k] - entry_counts[k] for k in counts}
        self.check(dry["gcn_lstm"] > 0
                   and dry["gcn_lstm_tf32"] == dry["gcn_lstm"]
                   and sum(dry.values()) == 2 * dry["gcn_lstm"],
                   f"graft_entry: dryrun_multichip launches {dry}")
        seconds["dryrun_multichip"] = time.perf_counter() - t0

        # backend="auto" at widths with no launch plan: the plain version,
        # no launch, every layer call counted; "cuda" still raises
        t0 = time.perf_counter()
        unplanned = {}
        for kind, H in GRAFT_UNPLANNED:
            apply, params, cfg_u, x = self.unplanned_net(kind, H, "auto")
            name = {"a3gc": "gcn_lstm", "ggru": "ggru", "tp": "lstm"}[kind]
            out = {}
            for backend in ("auto", "eager"):
                self.zero_counts()
                with torch.no_grad():
                    out[backend] = apply(params, dataclasses.replace(
                        cfg_u, backend=backend), x, device=self.dev)
                torch.cuda.synchronize()
                out[backend + "_counts"] = (self.counts(),
                                            self.plain_counts())
            err = tree_err(out["auto"], out["eager"])
            launches, plain_n = out["auto_counts"]
            unplanned[f"{kind} H={H}"] = {
                "max_abs_err_vs_eager": err, "launches": launches,
                "plain_dispatches": plain_n}
            self.check(err == 0.0 and sum(launches.values()) == 0
                       and plain_n == {k: (2 if k == name else 0)
                                       for k in LIBRARIES}
                       and bool(torch.isfinite(out["auto"][0]).all()),
                       f"graft_entry: {kind} H={H} at auto "
                       f"{unplanned[f'{kind} H={H}']}")
            if kind == "a3gc":
                try:
                    with torch.no_grad():
                        apply(params, dataclasses.replace(
                            cfg_u, backend="cuda"), x, device=self.dev)
                    raised = None
                except ValueError as e:
                    raised = str(e)
                unplanned[f"{kind} H={H}"]["cuda_raises"] = raised
                self.check(raised is not None and "no launch plan" in raised,
                           f"graft_entry: backend='cuda' at H={H} did not "
                           "raise")
        seconds["unplanned"] = time.perf_counter() - t0

        # one window of the serve command at --hu1 80 (its default
        # precision): stages 2 and 3 launch, stage 1 runs plain
        t0 = time.perf_counter()
        H = GRAFT_UNPLANNED[0][1]
        args = cli.build_parser().parse_args(
            ["serve", "--port", "0", "--norm", "--model", "a3gc",
             "--streams", str(S_SERVE), "--hu1", str(H)])
        cli._apply_quality(args)                      # as cmd_serve does
        srv, _, _ = cli._build_server(args)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            self.zero_counts()
            with PoseClient(*srv.address[:2], timeout=120.0,
                            retry_s=30.0) as c:
                served = c.step(*self.windows(np.random.default_rng(13), 1))
            server = {"finite": bool(np.isfinite(served).all()),
                      "launches": self.counts(),
                      "tf32_launches": self.tf32_counts(),
                      "plain_dispatches": self.plain_counts()}
        finally:
            srv.shutdown()
            thread.join(timeout=10)
        self.check(server["finite"]
                   and server["launches"] == {"gcn_lstm": 4, "ggru": 0,
                                              "lstm": 0}
                   and server["tf32_launches"]["gcn_lstm_tf32"] == 4
                   and server["plain_dispatches"] == {"gcn_lstm": 2,
                                                      "ggru": 0, "lstm": 0},
                   f"graft_entry: serve --hu1 {H} window {server}")
        seconds["serve"] = time.perf_counter() - t0

        # the --hu1 80 artifact (`cli export` in process: stage 1 is the
        # plain scan's op in the program), loaded and stepped against the
        # live session on the same params: 5 windows, a reset of slot 3
        # after window 1, slot 5 idle in window 3. At --precision highest,
        # as the cli_export phase holds its artifact: at "default" the
        # products traced into a program can sum in another order than the
        # eager ones at some shapes, and IK on random weights magnifies that
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        argv = ["export", "--norm", "--hu1", str(H), "--precision",
                "highest", "--streams", str(S_SERVE), "--window",
                str(WINDOW), "--output", os.path.join(tmp, "a3gc")]
        try:
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                cli.main(argv)
            export_s = time.perf_counter() - t1
            sess = X.ArtifactSession(X.load_exported(argv[-1],
                                                     device=self.dev))
            nbytes = sum(os.path.getsize(os.path.join(argv[-1], f))
                         for f in os.listdir(argv[-1]))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        eargs = cli.build_parser().parse_args(argv)
        cascade, is_graph = cli._stage_configs(
            eargs, precision=cli._precision(eargs))
        live = StreamingCascade(
            cli._load_cascade_params(eargs, cascade, is_graph, self.dev),
            cascade, ParametricModel(), window=WINDOW,
            stats=cli._load_stats(eargs), normalize=True, streams=S_SERVE,
            device=self.dev)
        rng = np.random.default_rng(17)
        idle = np.ones(S_SERVE, np.float32)
        idle[5] = 0.0
        poses = {"artifact": [], "live": []}
        per_window = {"artifact": [], "live": []}
        for w in range(5):
            ori, acc = self.windows(rng, S_SERVE)
            for who, sess_ in (("artifact", sess), ("live", live)):
                self.zero_counts()
                poses[who].append(sess_.step(
                    ori, acc, active=idle if w == 3 else None))
                per_window[who].append(
                    [self.counts()["gcn_lstm"],
                     self.plain_counts()["gcn_lstm"]])
                if w == 1:
                    sess_.reset(stream=3)
        rows = np.ones((5, S_SERVE), bool)
        rows[3] = idle > 0
        pose_err = float(np.abs(np.stack(poses["artifact"])[rows]
                                - np.stack(poses["live"])[rows]).max())
        state_err = tree_err(sess._states, live._states)
        artifact = {
            "argv": argv[:-2], "said": said.getvalue().strip(),
            "recurrent": sess.art.manifest["recurrent"],
            "export_s": export_s, "bytes": nbytes,
            "launches_plain_per_window": per_window,
            "pose_max_abs_err_vs_live": pose_err,
            "state_max_abs_err_vs_live": state_err}
        self.check(artifact["recurrent"] == ["plain", "op", "op"]
                   and per_window["artifact"] == [[4, 2]] * 5
                   and per_window["live"] == [[4, 2]] * 5
                   and pose_err <= KERNEL_TOL and state_err <= KERNEL_TOL,
                   f"graft_entry: --hu1 {H} artifact {artifact}")
        seconds["export"] = time.perf_counter() - t0
        emit({"phase": "graft_entry", "entry_launches": entry_counts,
              "entry_angle_deg_vs_plain": angle,
              "angle_bounds_deg": [PREC_ANGLE_MEAN, PREC_ANGLE_MAX],
              "compile_check": compiled,
              "dryrun_multichip": {"n_devices": GRAFT_DEVICES,
                                   "launches": dry},
              "launches": counts, "unplanned": unplanned,
              "serve_window": server, "artifact": artifact,
              "seconds": seconds, "card": nvidia_smi()})

    def cleanup(self):
        import shutil
        for data in (self._eval, self._prep):
            if data is not None:
                shutil.rmtree(data["tmp"], ignore_errors=True)

    # -- 5 ---------------------------------------------------------------
    def plan_record(self, name, S, H, D=2, tf32=False):
        """The launch plan of a weight-stationary kernel at this shape, with
        how many of its groups the card holds at once (``lstm``: of D
        directions; of the TF32 instantiation when ``tf32``)."""
        if name == "lstm":
            from a3gc_tpu_torch.ops import lstm as LS
            from a3gc_tpu_torch.ops._common import sm_count
            plan = LS.launch_plan(S, H, sm_count(0), D=D, tf32=tf32)
            rec = {"D": D, "P": plan.P, "R": plan.R, "KS": plan.KS,
                   "groups": plan.groups, "cooperative": plan.cooperative,
                   "mma": plan.mma,
                   "max_active": LS.max_active(plan, S, H, tf32)}
        elif name == "gcn_lstm":
            from a3gc_tpu_torch.ops import gcn_lstm as G
            plan = G.launch_plan(N_NODES, H, True, tf32=tf32, S=S)
            rec = {"C": plan.C, "KS": plan.KS, "KSA": plan.KSA,
                   "KSQ": plan.KSQ, "mma": plan.mma, "groups": 2 * S,
                   "max_active": G.max_active(plan, S, N_NODES, H, True,
                                               tf32)}
        else:
            from a3gc_tpu_torch.ops import ggru as GG
            plan = GG.launch_plan(S, N_NODES, H, tf32=tf32)
            rec = {"C": plan.C, "KS": plan.KS, "mma": plan.mma,
                   "groups": 2 * S,
                   "max_active": GG.max_active(plan, S, N_NODES, H, tf32)}
        rec.update(cluster=plan.cluster, smem=plan.smem,
                   ctas=(plan.ctas if name == "lstm" else 2 * S * plan.C))
        return rec

    def time_layer(self, name, path, S, F, H, layer, args, work,
                   library=None, reps=20, plain_reps=3, fmt="fp32"):
        r"""Time a layer call (the wrapper, the kernel alone, the plain
        version, a library call) into the kernel's rows: ``name``'s, or at
        ``fmt`` "tf32" its TF32 instantiation's (``<name>_tf32``, bound by
        the TF32 tensor cores' rate: the least time for TF32 products)."""
        mod = importlib.import_module(f"a3gc_tpu_torch.ops.{name}")
        torch = self.torch
        T = args[0].shape[1]
        tf32 = fmt == "tf32"
        with torch.no_grad():
            scan_args = mod.scan_inputs(layer, *args, fmt)
            # in turns (kernel, library, library, kernel): the card's clock
            # and its neighbours move every timed call alike
            calls = {"ms": lambda: self.wrappers[name](layer, *args, fmt),
                     "scan_ms": lambda: mod.scan(*scan_args, tf32=tf32)}
            if library is not None:
                calls["library_ms"] = library
            order = list(calls) + list(reversed(calls))
            times = {k: 0.0 for k in calls}
            for k in order:
                times[k] += cuda_ms(calls[k], reps) / 2
            plain = getattr(mod, f"bi_{name}_reference")
            plain_ms = (cuda_ms(lambda: plain(layer, *args, fmt), plain_reps,
                                warmup=int(plain_reps > 1))
                        if plain_reps else None)
        D = 2
        if name == "lstm":
            from a3gc_tpu_torch.ops import lstm as LS
            D = LS.directions(layer)
        peak = PEAK_TF32_FLOPS if tf32 else PEAK_FP32_FLOPS
        b_ms, b_by = bound(*work(S, T, F, H, True), peak)
        sb_ms, sb_by = bound(*work(S, T, F, H, False), peak)
        self.shapes[name + "_tf32" if tf32 else name].append({
            "path": path, "S": S, "T": T, "H": H, "F": F, "ms": times["ms"],
            "scan_ms": times["scan_ms"], "plain_ms": plain_ms,
            "library_ms": times.get("library_ms"),
            "bound_ms": b_ms, "bound_by": b_by, "scan_bound_ms": sb_ms,
            "scan_bound_by": sb_by,
            "plan": self.plan_record(name, S, H, D, tf32)})

    def cudnn_lstm(self, p, x, st, kernel_out=None, tf32=False):
        """cuDNN's torch.nn.LSTM on the layer's weights (one direction or
        two, as the layer has), checked against the plain version at
        n_valid = T (or against ``kernel_out``, the kernel's output there,
        where the plain version is too slow to run again); returns the call
        to time. ``tf32``: with ``torch.backends.cudnn.allow_tf32`` set for
        the call (cuDNN's TF32 math, rounding at its own points), checked
        against the plain version at "tf32" within PREC_KERNEL_TOL."""
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

            def call():
                if not tf32:
                    return mod(x, cst)
                torch.backends.cudnn.allow_tf32 = True
                try:
                    return mod(x, cst)
                finally:
                    torch.backends.cudnn.allow_tf32 = False

            got = call()
            want = (LS.bi_lstm_reference(p, x, st, fmt="tf32" if tf32
                                         else "fp32")
                    if kernel_out is None else kernel_out)
        torch.cuda.synchronize()
        err = max(float((a.reshape(b.shape) - b).abs().max())
                  for a, b in zip(leaves(got), leaves(want)))
        self.check(err <= (PREC_KERNEL_TOL if tf32 else KERNEL_TOL),
                   f"cuDNN LSTM{' (TF32)' if tf32 else ''} vs "
                   f"{'plain' if kernel_out is None else 'kernel'}"
                   f" H={H} F={F} D={D} T={x.shape[1]}: {err:.3e}")
        return call

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
                          "evaluate", "export", "export_bundle",
                          "preprocess", "cli_data", "train", "mesh",
                          "tp"),
                         gcn_layer_work,
                         "the six layer calls of one A3GC serving window "
                         "(3 stages x rnn1/rnn2, S=8, T=60), bi_gcn_lstm "
                         "including its hoisted input projection",
                         "no PyTorch call mixes a per-gate graph adjacency "
                         "and joint attention into an LSTM recurrence"),
            "ggru": ("a3gc_tpu/ops/pallas_gcn_lstm.py:412 (_ggru_kernel)",
                     ("serving_ggru", "checkpoints", "evaluate_families",
                      "export", "export_bundle", "tp"),
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
                      "export", "train_dip", "tp"),
                     lstm_layer_work,
                     "the six layer calls of one TransPose serving window "
                     "plus the two of one DIP serving window plus the two "
                     "of one unidirectional DIP serving window (D=1) (S=8, "
                     "T=60), bi_lstm including its hoisted input "
                     "projection; library: cuDNN torch.nn.LSTM on the same "
                     "weights, as many directions",
                     None),
        }
        # the TF32 instantiations: their launches on the serve command at
        # its default precision and on the driver entry points (entry() and
        # dryrun_multichip run "default"), their rows at the serving
        # window's shapes
        for name in LIBRARIES:
            replaces, _, work, timed, _ = meta[name]
            meta[name + "_tf32"] = (
                replaces, ("precision", "graft_entry"), work,
                timed + ", at precision='default' (TF32 operands, fp32 "
                "sums: the TF32 instantiation)"
                + ("; library: cuDNN torch.nn.LSTM with "
                   "torch.backends.cudnn.allow_tf32 set" if name == "lstm"
                   else ""),
                "cuDNN's TF32 LSTM rounds at its own points, not the JAX "
                "cell's: a yardstick of time only" if name == "lstm" else
                "no PyTorch call rounds the operands of this recurrence to "
                "TF32 at the JAX cell's points")
        entries = []
        for name, (replaces, paths, work, timed, no_lib) in meta.items():
            tf32 = name.endswith("_tf32")
            lib_name = name[:-5] if tf32 else name
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
                "source": f"a3gc_tpu_torch/ops/csrc/{lib_name}.cu",
                "replaces": replaces,
                "launches": sum(self.launches[p][name] for p in paths),
                "launches_by_path": {p: self.launches[p][name]
                                     for p in paths},
                "max_abs_err": self.max_err[name],
                "grad_max_rel_err": self.max_grad_err.get(name),
                "ms": sum(r["ms"] for r in main),
                "plain_ms": sum(r["plain_ms"] for r in main),
                "bound_ms": sum(r["bound_ms"] for r in main),
                "bound_by": bound(flop, nbytes, PEAK_TF32_FLOPS if tf32
                                  else PEAK_FP32_FLOPS)[1],
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
              smoke.phase_precision,
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
              smoke.phase_mesh, smoke.phase_kernel_eval, smoke.phase_cli_evaluate,
              smoke.phase_preprocess, smoke.phase_cli_data,
              smoke.phase_kernel_grad, smoke.phase_train,
              smoke.phase_train_times, smoke.phase_tp,
              smoke.phase_graft_entry, smoke.phase_times)
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
