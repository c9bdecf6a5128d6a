r"""Dense LSTM layer over a whole window in one kernel launch
(counterpart of ``a3gc_tpu/ops/pallas_gcn_lstm.py`` ``bi_lstm_pallas`` and,
one direction, ``lstm_scan_pallas``), the recurrent layer of the DIP net
and of the TransPose cascade.

:func:`bi_lstm` hoists the input projection ``u = x·W_ih + b_ih + b_hh``
out of the scan with one ``torch.matmul`` (as the JAX package leaves it to
XLA outside its kernel) and launches ``csrc/lstm.cu``, every direction in
one launch: per (direction, block of up to 8 streams) a group of P CTAs
that split the hidden units and keep their slice of W_hh in shared memory
for the whole window, exchanging h each frame — a thread-block cluster
through distributed shared memory, or, where a cluster cannot hold W_hh,
a cooperative launch through L2. :func:`launch_plan` chooses the group;
:func:`cached_plan` keeps its answer per key.
The launch is the CUDA implementation of the registered op
``a3gc_tpu_torch::lstm_scan`` (:mod:`a3gc_tpu_torch.ops.library`), whose
CPU implementation is :func:`scan_reference`, the plain PyTorch version of
the same function: on a CPU tensor :func:`bi_lstm` computes it, on a CUDA
tensor it launches the kernel or raises.

The number of directions D is read from the parameters: direction-
stacked ones (``w_hh`` [2, H, 4H], the biLSTM) give D = 2, unstacked ones
(``w_hh`` [H, 4H], the unidirectional DIP net) give D = 1 — one wrapper
and one launch counter for both, as one kernel serves both. The function,
for x [S, T, F], state (h, c) each [2, S, H] (D = 2) or [S, H] (D = 1)
and per-stream ``n_valid`` [S] (the Pallas kernel takes one scalar for all
rows; the port keeps the per-row contract of the JAX XLA path):

  * direction 0 walks frames 0 … T-1, direction 1 walks T-1 … 0;
  * gate order i, f, g, o (torch.nn.LSTM's);
  * frames < n_valid[s] update stream s's state, later frames carry it;
  * y [S, T, D·H] is the carried h after each frame, forward ‖ backward;
  * returns (y, (h, c)) with the final states in the shape of the state.

The kernel has no backward: the op's autograd formula reruns
:func:`scan_reference` on the saved inputs. The plain path reads the
weights through :mod:`a3gc_tpu_torch.parallel.tensor`, so that TransPose
training under tensor parallelism runs its products column-parallel. The kernel is fp32 inside;
the outputs come back in the dtypes of x and of the state. ``fmt`` (the
net's operand format) at "tf32" rounds the products' operands to TF32:
the hoisted x·W_ih here, h·W_hh inside the scan (the kernel's TF32
instantiation, the ``tf32`` flag of :func:`scan`).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from a3gc_tpu_torch.models import layers as L
from a3gc_tpu_torch.ops._common import (MAX_CLUSTER, SMEM_HEADER, SMEM_LIMIT,
                                        THREADS, attributes_query,
                                        check_aligned, check_f32,
                                        check_n_valid, device_index, f32,
                                        k_slices, kernel_library, launch,
                                        like, max_active_query,
                                        mma_row_stride, n_valid_tensor,
                                        plan_or_refusal, planned, sm_count)
from a3gc_tpu_torch.parallel import tensor as TP

__all__ = ["LaunchPlan", "bi_lstm", "bi_lstm_reference", "cached_plan",
           "directions", "func_attributes", "launch_plan",
           "lstm_step_hoisted", "max_active", "mma_split", "scan",
           "scan_inputs", "scan_reference", "smem_bytes"]

WARPS = THREADS // 32
MMA_NKB = (4, 16)           # k-blocks of 16 a warp holds A's fragments of
                            # (16: 128 registers a thread): the serving
                            # widths' instantiations, no others to build
ROWS = 8                    # the tensor-core form's h rows (n = 8 streams)


class LaunchPlan(NamedTuple):
    r"""How ``csrc/lstm.cu`` runs one layer call."""
    R: int                 # streams per group (1, 2, 4 or 8)
    P: int                 # CTAs per group; CTA p owns hidden units p·H/P …
    KS: int                # k-slices per gate column of h·W_hh (mma: the
                           # k parts over the warps, mma_split)
    groups: int            # groups per direction on the card at once
    cooperative: bool      # False: a cluster of P CTAs exchanging through
                           # DSMEM; True: a cooperative grid, through L2
    threads: int
    smem: int              # dynamic shared memory per CTA, bytes
    D: int = 2             # directions, one grid layer each
    mma: int = 0           # 1: the TF32 instantiation's product on the
                           # tensor cores (mma.sync m16n8k8), 0: FMA loop

    @property
    def cluster(self) -> int:
        return 1 if self.cooperative else self.P

    @property
    def ctas(self) -> int:
        return self.D * self.P * self.groups


def rows_per_group(S: int) -> int:
    r"""Streams per group: the least power of two ≥ min(S, 8)."""
    return 1 if S <= 1 else 2 if S <= 2 else 4 if S <= 4 else 8


def mma_split(H: int, P: int) -> Optional[Tuple[int, int]]:
    r"""The tensor-core form's split of a CTA's h·W_hh over its 8 warps at
    hidden width H and P CTAs a group (``MmaSplit`` in C), or None where
    it has none: (KS, NKB), KS k parts of the H / 16 k-blocks, each warp
    holding the A fragments (W_hh^T) of one tile of 16 gate columns × NKB
    k-blocks in registers (NKB 4 or 16: at most 128 registers a thread). KS is 2 where the tiles leave half the warps idle (2 · M / 16
    ≤ 8) and that split exists, else 1; the tiles of a k part fill at most
    its warps."""
    if H <= 0 or H % 16 or P <= 0 or H % P:
        return None
    MT, KB = 4 * (H // P) // 16, H // 16
    if 4 * (H // P) % 16:
        return None
    for ks in (2, 1):
        if ks * MT <= WARPS and KB % ks == 0 and KB // ks in MMA_NKB:
            return ks, KB // ks
    return None


def smem_bytes(R: int, H: int, P: int, cooperative: bool,
               mma: bool = False) -> int:
    r"""Dynamic shared memory of one CTA (C: ``smem_floats``): the
    W_hh slice [H, 4H/P] with rows padded by 4 floats, the full h
    (double-buffered in a cluster), the z and u slices [R, 4H/P] and the
    c and h slices [R, H/P]. The tensor-core form (``mma``) stages the
    W_hh slice the same way (its A fragments go from there to registers),
    then 8 rows of the full h padded to :func:`mma_row_stride` and the z
    slices of its KS k parts with rows padded by 4 floats."""
    Hc = H // P
    M = 4 * Hc
    nbuf = 1 if cooperative else 2
    if mma:
        KS = mma_split(H, P)[0]
        floats = (H * (M + 4) + nbuf * ROWS * mma_row_stride(H)
                  + KS * R * (M + 4) + R * M + 2 * R * Hc)
    else:
        floats = H * (M + 4) + nbuf * R * H + 2 * R * M + 2 * R * Hc
    return SMEM_HEADER + 4 * floats


def launch_plan(S: int, H: int, sms: int = 132, P: Optional[int] = None,
                D: int = 2, tf32: bool = False,
                mma: Optional[bool] = None) -> LaunchPlan:
    r"""The group for S streams of D directions at hidden width H on a card
    of ``sms`` SMs: the smallest P whose CTAs own at most 64 gate columns
    each (wider only where no P gives that) and whose W_hh slice fits in
    shared memory; a cluster up to P = 8, a cooperative grid beyond
    (H = 256: P = 16, H = 512: P = 32). The 64-column width is measured
    (``scripts/torch_kernel_ab.py``: on an H100 it beats 128 columns at
    every serving width). ``P`` forces the split, for measuring P against
    2P. Raises if nothing fits.

    The split does not depend on D; a cooperative grid's ``groups`` does,
    as every CTA must be resident: up to ``sms // (D·P)`` stream blocks at
    once, so one direction holds twice the blocks (132 SMs: H = 512 4
    against 2, H = 256 8 against 4). That changes ``groups`` only beyond
    S = 16 at H = 512 (S = 32 at H = 256); every serving shape (S ≤ 12)
    has the same plan at D = 1 as at D = 2 but for D.

    The TF32 instantiation (``tf32``) has a plan of its own: the product
    on the tensor cores (``mma`` = 1) at the smallest P whose
    :func:`mma_split` exists (its A fragments in at most 128 registers a
    thread) and whose shared memory fits; a split exists only where H / 16
    is 4, 8, 16 or 32 (H = 64, 128, 256, 512). Elsewhere the fp32 plan in
    the FMA form. ``mma`` forces the form (False: the FMA form at
    the fp32 plan's P, for measuring one against the other; True: raises
    where the tensor cores have no plan), ``P`` the split. At the dense
    serving widths that rule gives the P that won against the other
    candidates (``scripts/torch_kernel_ab.py --tf32``, device ms a launch
    at S = 8 / 1, T = 60, D = 2, on an H100; PERF.md §6):

      H = 64: P = 2 (0.0666 / 0.0612; P = 4 0.0650 / 0.0636 and P = 8
      0.0676 / 0.0670 with two k parts of 2 k-blocks; P = 1, two tiles a
      warp, 0.0932 / 0.0653: the cell of two units a thread outweighed
      the exchange, which st.async makes cheap);
      H = 128: P = 8 (0.0699 / 0.0697; P = 4, 8 k-blocks a warp, 0.0772
      / 0.0716; P = 2, two tiles a warp, 0.1127 / 0.0810);
      H = 256: P = 8 (a cluster: 0.0978 / 0.0890; the cooperative 16, two
      k parts of 8 k-blocks, 0.1655 / 0.1503);
      H = 512: P = 32 (cooperative: 0.1807 / 0.1674; P = 16's A would be
      256 registers a thread).

    The FMA form at the fp32 plan's P took 0.139 / 0.092, 0.174 / 0.106,
    0.286 / 0.170 and 0.396 / 0.219 ms in the same run. The forms the
    plans do not take (two tiles a warp, 2 or 8 k-blocks) were dropped
    from the kernel's instantiations."""
    if S <= 0 or H <= 0 or H % 4 or D not in (1, 2):
        raise ValueError(f"lstm: needs S >= 1, H % 4 == 0 and D in (1, 2), "
                         f"got S={S}, H={H}, D={D}")
    if mma and not tf32:
        raise ValueError("lstm: the tensor-core form needs the TF32 "
                         "instantiation (tf32=True)")
    R = rows_per_group(S)
    n_blocks = -(-S // R)

    def fits(p, mma_form):
        """(KS, cooperative, groups, smem) of split p, or None."""
        Hc = H // p
        if H % p or Hc % 4:
            return None
        if mma_form:
            split = mma_split(H, p)
            if split is None:
                return None
            ks = split[0]
        else:
            ks = k_slices(4 * Hc, H)
        coop = p > MAX_CLUSTER
        smem = smem_bytes(R, H, p, coop, mma_form)
        groups = min(n_blocks, sms // (D * p)) if coop else n_blocks
        if smem > SMEM_LIMIT or groups < 1:
            return None
        return ks, coop, groups, smem

    if tf32 and mma is not False:
        for p in ([P] if P is not None else range(1, 65)):
            got = p > 0 and fits(p, True)
            if got:
                ks, coop, groups, smem = got
                return LaunchPlan(R, p, ks, groups, coop, THREADS, smem, D,
                                  1)
        if mma:
            raise ValueError(f"lstm: no launch plan on the tensor cores for "
                             f"S={S}, H={H}"
                             + (f", P={P}" if P is not None else ""))
    widths = (THREADS,) if P is not None else (64, 128, THREADS)
    for widest in widths:
        for p in ([P] if P is not None else range(1, 65)):
            Hc = H // p
            if H % p or Hc % 4 or 4 * Hc > widest:
                continue
            got = fits(p, False)
            if got:
                ks, coop, groups, smem = got
                return LaunchPlan(R, p, ks, groups, coop, THREADS, smem, D)
    raise ValueError(f"lstm: no launch plan for S={S}, H={H}"
                     + (f", P={P}" if P is not None else ""))


@functools.lru_cache(maxsize=None)
def cached_plan(S: int, H: int, sms: int, D: int,
                tf32: bool) -> Union[LaunchPlan, str]:
    r""":func:`launch_plan`'s plan for a layer call of D directions on a
    card of ``sms`` SMs, for the fp32 or the TF32 instantiation, or its
    refusal message, computed once per key. The launch (:func:`scan`) and
    the nets' dispatch (``models/nets.py`` ``plan_refusal``) both read
    it."""
    return plan_or_refusal(launch_plan, S, H, sms, D=D, tf32=tf32)


def directions(params: nn.Module) -> int:
    r"""D of a layer's parameters: 2 when direction-stacked (``w_hh``
    [2, H, 4H]), 1 when not (``w_hh`` [H, 4H])."""
    return 2 if TP.full(params.w_hh).dim() == 3 else 1


def _hoist(params: nn.Module, x: torch.Tensor,
           fmt: str = "fp32") -> torch.Tensor:
    r"""u = x·W_ih + b_ih + b_hh for every direction, forward frame order:
    [D, S, T, 4H]."""
    S, T, F = x.shape
    D = directions(params)
    w_ih = TP.blockwise(params.w_ih, lambda w: f32(w).reshape(D, F, -1))
    bias = (f32(TP.full(params.b_ih))
            + f32(TP.full(params.b_hh))).reshape(D, 1, -1)
    u = TP.matmul(x.reshape(1, S * T, F), w_ih, fmt=fmt) + bias
    return u.reshape(D, S, T, -1)


def lstm_step_hoisted(p: nn.Module, u_t: torch.Tensor, state,
                      fmt: str = "fp32"):
    r"""Dense LSTM step on direction-stacked parameters, the input half
    hoisted: u_t [D, B, 4H], state (h, c) each [D, B, H]. z = u_t + h·W_hh
    (operands in format ``fmt``), gates i, f, g, o. Returns the new state
    (h', c')."""
    h, c = state
    H = h.shape[-1]
    z = u_t + TP.matmul(h, p.w_hh, fmt=fmt, step=True)
    i = torch.sigmoid(z[..., 0:H])
    f = torch.sigmoid(z[..., H:2 * H])
    g = torch.tanh(z[..., 2 * H:3 * H])
    o = torch.sigmoid(z[..., 3 * H:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def bi_lstm_reference(params: nn.Module, x: torch.Tensor, state,
                      n_valid=None, fmt: str = "fp32"):
    r"""The plain PyTorch version of :func:`bi_lstm` — the same function on
    any device: :func:`scan_inputs`, then :func:`scan_reference`. ``params``
    holds direction-stacked ``w_ih`` [2, F, 4H], ``w_hh`` [2, H, 4H],
    ``b_ih`` and ``b_hh`` [2, 4H] (the bidirectional scan), or the same
    without the leading 2 (the unidirectional scan). While
    ``torch.export`` traces, :func:`scan_reference` is the one node of the
    op ``a3gc_tpu_torch::lstm_scan_plain``. The tests use it; on the card it
    is what the kernel is held to."""
    args = scan_inputs(params, x, state, n_valid, fmt)
    if torch.compiler.is_compiling():
        from a3gc_tpu_torch.ops.library import lstm_scan_plain
        y, h, c = lstm_scan_plain(*args, fmt == "tf32")
    else:
        y, h, c = scan_reference(*args, tf32=fmt == "tf32")
    if directions(params) == 1:
        h, c = h[0], c[0]
    return like(y, x), like((h, c), state[0])


def scan_reference(u: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor, n_valid: torch.Tensor,
                   tf32: bool = False):
    r"""The plain PyTorch version of :func:`scan`, on the same hoisted
    inputs and any device: the hoisted step in the masked scan, one
    direction (D = 1) or two, h·W_hh on TF32 operands when ``tf32``. The
    CPU implementation of the registered op
    (:mod:`a3gc_tpu_torch.ops.library`). Returns (y [S, T, D·H],
    h [D, S, H], c [D, S, H])."""
    D, T = u.shape[0], u.shape[2]
    frame_mask = torch.arange(T, device=u.device)[None] < n_valid[:, None]
    step = functools.partial(lstm_step_hoisted,
                             fmt="tf32" if tf32 else "fp32")
    if D == 1:
        y, (h, c) = L.uni_rnn(step,
                              SimpleNamespace(w_hh=TP.blockwise(
                                  w_hh, lambda w: w[0])), u[0],
                              (h0[0], c0[0]), frame_mask=frame_mask)
        return y, h[None], c[None]
    ut = u.transpose(1, 2)                                    # [2,T,S,4H]
    seq_stack = torch.stack((ut[0], ut[1].flip(0)))
    hs, (h, c) = L.bi_rnn_precomputed(
        step, SimpleNamespace(w_hh=w_hh), seq_stack, (h0, c0),
        frame_mask=frame_mask)
    y = torch.cat((hs[0], hs[1].flip(0)), dim=-1).transpose(0, 1)
    return y, h, c


def _library():
    return kernel_library("lstm", 10, 13, 12, 4)


def _plan_ints(plan: LaunchPlan):
    return (plan.D, plan.R, plan.P, plan.KS, plan.groups,
            int(plan.cooperative), plan.threads, plan.smem, plan.mma)


def max_active(plan: LaunchPlan, S: int, H: int, tf32: bool = False) -> int:
    r"""Groups of ``plan`` the current card holds at once: clusters
    (``cudaOccupancyMaxActiveClusters``) or, cooperative, resident CTAs;
    for the fp32 or the TF32 instantiation. Raises on a plan the kernel
    refuses."""
    return max_active_query("lstm", _library(), S, H, *_plan_ints(plan),
                            int(tf32))


def func_attributes(plan: LaunchPlan, H: int, tf32: bool = False) -> dict:
    r"""Registers a thread and local-memory bytes (spills) of the
    instantiation a launch of ``plan`` at hidden width H runs
    (``cudaFuncGetAttributes``): {"regs": …, "local_bytes": …}."""
    nkb = mma_split(H, plan.P)[1] if plan.mma else 0
    return attributes_query("lstm", _library(), plan.R,
                            int(plan.cooperative), int(tf32), nkb)


def scan(u: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
         c0: torch.Tensor, n_valid: torch.Tensor,
         plan: Optional[LaunchPlan] = None, tf32: bool = False):
    r"""Launch the kernel on hoisted inputs. u [D, S, T, 4H] (every
    direction in forward frame order), w_hh [D, H, 4H], h0/c0 [D, S, H],
    n_valid [S] int32 — all contiguous fp32 on one card, D = 1 or 2.
    ``plan`` defaults to :func:`cached_plan`'s (the TF32 plan when
    ``tf32``; ``ValueError`` where it refuses); ``tf32`` launches the TF32
    instantiation (h and W_hh rounded to TF32; on the tensor cores where
    the plan's ``mma`` says so). Returns (y [S, T, D·H], h [D, S, H],
    c [D, S, H])."""
    D, S, T, G = u.shape
    H = G // 4
    dev = u.device
    check_f32("lstm", dev, [(u, (D, S, T, 4 * H)), (w_hh, (D, H, 4 * H)),
                            (h0, (D, S, H)), (c0, (D, S, H))])
    check_n_valid("lstm", dev, n_valid, S)
    check_aligned("lstm", u, w_hh)
    if plan is None:
        plan = planned(cached_plan(S, H, sm_count(device_index(dev)), D,
                                   tf32))
    if plan.D != D:
        raise ValueError(f"lstm: a plan for D={plan.D} given {D} "
                         "directions")
    lib = _library()
    y = torch.empty((S, T, D * H), dtype=torch.float32, device=dev)
    h_out = torch.empty((D, S, H), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    xchg = counter = None
    if plan.cooperative:
        xchg = torch.empty((D, plan.groups, 2, plan.R, H),
                           dtype=torch.float32, device=dev)
        counter = torch.zeros((D, plan.groups), dtype=torch.int32,
                              device=dev)
    launch("lstm", lib, dev, u.data_ptr(), w_hh.data_ptr(), h0.data_ptr(),
           c0.data_ptr(), n_valid.data_ptr(), y.data_ptr(), h_out.data_ptr(),
           c_out.data_ptr(), None if xchg is None else xchg.data_ptr(),
           None if counter is None else counter.data_ptr(), S, T, H,
           *_plan_ints(plan), int(tf32))
    bi_lstm.launches += 1
    bi_lstm.tf32_launches += int(tf32)
    key = ("coop" if plan.cooperative else "cluster", plan.P)
    by_plan = bi_lstm.launches_by_plan
    by_plan[key] = by_plan.get(key, 0) + 1
    return y, h_out, c_out


def bi_lstm(params: nn.Module, x: torch.Tensor, state, n_valid=None,
            fmt: str = "fp32"):
    r"""Dense LSTM layer, D directions read from ``params``: x [S, T, F],
    state (h, c) each [2, S, H] (D = 2) or [S, H] (D = 1), ``n_valid`` None
    | int | [S] → (y [S, T, D·H], (h, c)), the products' operands in
    format ``fmt``. Hoists the input projection
    (:func:`scan_inputs`) and calls the registered op
    ``a3gc_tpu_torch::lstm_scan`` (:mod:`a3gc_tpu_torch.ops.library`): on
    CUDA tensors it launches the kernel (one launch, every direction) or
    raises, on CPU tensors it computes :func:`scan_reference`."""
    from a3gc_tpu_torch.ops.library import lstm_scan
    y, h, c = lstm_scan(*scan_inputs(params, x, state, n_valid, fmt),
                        fmt == "tf32")
    if directions(params) == 1:
        h, c = h[0], c[0]
    return like(y, x), like((h, c), state[0])


def scan_inputs(params: nn.Module, x: torch.Tensor, state,
                n_valid=None, fmt: str = "fp32") -> tuple:
    r"""The arguments of :func:`scan` for one layer call: the hoisted input
    projection for every direction (one ``torch.matmul`` on operands in
    format ``fmt``, forward frame order) and the parameters and state in
    the kernel's layouts (a unidirectional layer's gain a leading axis of
    1)."""
    x = f32(x)
    S, T = x.shape[0], x.shape[1]
    D = directions(params)
    H = TP.full(params.w_hh).shape[-2]
    h0, c0 = (f32(s).reshape(D, S, H).contiguous() for s in state)
    w_hh = TP.blockwise(params.w_hh,
                        lambda w: f32(w).reshape(D, H, -1).contiguous())
    return (_hoist(params, x, fmt), w_hh, h0, c0,
            n_valid_tensor(n_valid, S, T, x.device))


bi_lstm.launches = 0    # kernel launches since the last reset to 0
bi_lstm.tf32_launches = 0   # of them, of the TF32 instantiation
bi_lstm.launches_by_plan = {}   # of them, by ("cluster" | "coop", P)
bi_lstm.plain_dispatches = 0    # layer calls on a card that backend="auto"
                                # gave the plain version (no plan)
