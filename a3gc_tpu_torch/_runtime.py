r"""The run-wide settings of one command of the port's CLI, the counterpart
of what ``a3gc_tpu.cli.main`` does with ``--profile``, ``--debug_nans`` and
``--compilation_cache``, and the named spans that give a trace of the port
the structure of a JAX trace.

:func:`command_scope` holds them for the length of a command and restores
every process-wide setting it changed when the command returns or raises:

  * ``--profile DIR``: a ``torch.profiler`` trace of the whole command (the
    CPU, and the card when the command runs on one; every thread of the
    process), written under ``DIR`` as Chrome-trace JSON when the command
    ends, the process's rank in the file name under ``--coordinator``;
  * ``--debug_nans``: :class:`NanCheck` raises ``FloatingPointError`` at the
    first op that yields a NaN, naming it (``jax_debug_nans`` there), and
    autograd's anomaly mode names the forward op of a NaN born in the
    backward;
  * ``--compilation_cache DIR``: the kernel libraries are built into, or
    reused from, ``DIR`` (``$A3GC_TORCH_BUILD_DIR``, read by
    :func:`a3gc_tpu_torch.ops._build.build_dir` at each build).

:func:`span` / :func:`spanned` name a region of a trace. Two families of
names, both fixed (tests and the benchmark's readers look for them):

  * step spans, ``jit_<function>``: a whole step, named after the JAX
    function that the JAX package compiles with ``jax.jit`` there, as XLA
    names the computation in a JAX trace (``jit__run`` in ``eval/run.py``,
    ``jit__step`` / ``jit_fused_step`` / ``jit__raw`` in
    ``eval/streaming.py``, ``jit_step`` / ``jit_eval_step`` in
    ``train/loop.py``);
  * layer spans, ``a3gc.<layer>``, inside a step: ``a3gc.prep`` (each
    call of ``data/pipeline.py`` ``normalize_imu``,
    ``scatter_graph_inputs`` and ``dip_batch``), ``a3gc.cascade``
    (``models/pipeline.py`` ``cascade_apply``, and ``forward_offline``, a
    single net's step), ``a3gc.stage1`` … ``a3gc.stage3`` (in it, each
    stage's net with the concatenation that feeds it; a single net's is
    ``a3gc.stage1``), ``a3gc.rnn``
    (``models/nets.py``: each recurrent layer call, kernel or plain),
    ``a3gc.ik`` (``reduced_global_to_full_local``) and ``a3gc.round``
    (``ops/_common.py`` ``operand`` and ``weight_operand``: one operand
    rounded to TF32, a weight's served from its cache on a hit; the
    per-frame steps round through ``step_operand`` and open none, so that
    no span opens once a frame).

A span is recorded only while a profiler runs, as a
``torch.profiler.record_function`` on the profiler's clock, beside the
card's activity. Off, it costs a flag test and a shared null context
(≈ 0.5 µs; an offline sequence opens 36 layer spans in a TransPose
cascade and 49 in an A3GC one at TF32); on, ≈ 10-15 µs of host time each.
"""

from __future__ import annotations

import contextlib
import functools
import os
import signal
import socket
import threading

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

__all__ = ["NanCheck", "nan_check", "thread_checks", "profile_trace",
           "build_dir_scope", "command_scope", "span", "spanned"]

_NO_SPAN = contextlib.nullcontext()


def _profiling() -> bool:
    # the flag torch.profiler sets for the whole process while it runs; a
    # span traced by torch.export would become an op of the program
    return (_autograd_profiler._is_profiler_enabled
            and not torch.compiler.is_compiling())


def span(name: str):
    r"""``torch.profiler.record_function(name)`` while a profiler runs,
    else a context that does nothing."""
    return torch.profiler.record_function(name) if _profiling() else _NO_SPAN


def spanned(name: str):
    r"""Decorator: every call of the function is a :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# ops whose output holds only values of their inputs, rearranged or copied
# (the views aside, which OpOverload.is_view names): a NaN there was made by
# an earlier op or given in an input, and the op that first computes with
# it is the one to name (a NaN weight: the layer's kernel op, not the
# contiguous copy of the weight made on the way to it)
_MOVES = frozenset(f"aten::{n}" for n in (
    "clone", "copy_", "_to_copy", "cat", "stack", "flip", "index",
    "index_select", "gather", "repeat", "constant_pad_nd", "lift_fresh_copy",
    "_unsafe_view", "set_"))


class NanCheck(TorchDispatchMode):
    r"""Raise ``FloatingPointError`` at the first op whose floating output
    holds a NaN, naming the op (``aten::…`` or ``a3gc_tpu_torch::…_scan``):
    the behaviour of ``jax_debug_nans``. Infinities pass, as there (JAX's
    ``jax_debug_infs`` is a flag of its own). A registered op is checked as
    one op: the ops of its implementation run below the mode. Ops that only
    move or copy values, and the allocations of uninitialised memory, are
    not checked; nor is anything while ``torch.export`` traces (fake
    tensors hold no values). Each check reads one flag back from the
    device, so every checked op waits for the card."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        # aten::empty* / new_empty*: memory as the allocator left it
        if (func.is_view or name in _MOVES or "empty" in name
                or torch.compiler.is_compiling()):
            return out
        for t in _pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.device.type != "meta" and bool(t.isnan().any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {name}")
        return out


@contextlib.contextmanager
def nan_check():
    r""":class:`NanCheck` on this thread, and autograd's anomaly mode with
    its NaN check, for the length of the block; both as they were after
    it."""
    with torch.autograd.set_detect_anomaly(True, check_nan=True), \
            NanCheck():
        yield


def thread_checks():
    r"""For a worker thread that steps the devices on behalf of this one (a
    server's batcher): a context manager factory that turns on the checks
    active on this thread there too (a dispatch mode is per thread), or
    does nothing when none is."""
    if any(isinstance(m, NanCheck)
           for m in _get_current_dispatch_mode_stack()):
        return NanCheck
    return contextlib.nullcontext


@contextlib.contextmanager
def build_dir_scope(path: str):
    r"""The kernel libraries built into, or reused from, ``path`` for the
    length of the block; the environment as it was after it."""
    from a3gc_tpu_torch.ops._build import BUILD_DIR_ENV
    before = os.environ.get(BUILD_DIR_ENV)
    os.environ[BUILD_DIR_ENV] = os.path.abspath(path)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(BUILD_DIR_ENV, None)
        else:
            os.environ[BUILD_DIR_ENV] = before


def _sigterm_exits(signum, frame):
    raise SystemExit(128 + signum)


@contextlib.contextmanager
def profile_trace(directory: str, cuda: bool, rank=None):
    r"""A ``torch.profiler`` trace of the block, every thread of the
    process: CPU ops and spans, and with ``cuda`` the card's kernels and
    copies. When the block ends (also by an exception, or by SIGTERM on
    the main thread, which then exits as SIGINT would) it is written under
    ``directory`` (made if missing) as ``<host>_<pid>[_rank<r>].<n>.pt.
    trace.json``, which TensorBoard's profiler plugin and Perfetto open."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(directory, exist_ok=True)
    worker = f"{socket.gethostname()}_{os.getpid()}" + (
        "" if rank is None else f"_rank{rank}")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    main = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, _sigterm_exits) if main else None
    try:
        with profile(activities=activities,
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True),
                     on_trace_ready=tensorboard_trace_handler(
                         directory, worker_name=worker)):
            yield
    finally:
        if main:
            signal.signal(signal.SIGTERM, previous)


@contextlib.contextmanager
def command_scope(args):
    r"""The run-wide flags of a parsed command line, for the length of the
    block. The profiler is outermost, so a trace of a run that
    ``--debug_nans`` stops still holds the op that raised."""
    with contextlib.ExitStack() as stack:
        if getattr(args, "profile", None):
            stack.enter_context(profile_trace(
                args.profile, torch.device(args.device).type == "cuda",
                rank=(args.process_id if getattr(args, "coordinator", None)
                      else None)))
        if getattr(args, "compilation_cache", None):
            stack.enter_context(build_dir_scope(args.compilation_cache))
        if getattr(args, "debug_nans", False):
            stack.enter_context(nan_check())
        yield
