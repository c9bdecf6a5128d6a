r"""Training: the per-batch step, the per-stage epoch driver, early stopping
(counterpart of ``a3gc_tpu/train/loop.py``).

  * One step: assemble the batch on its device (normalization, graph
    scatter, teacher-forcing noise), the forward pass with dropout, the
    loss, backward, and the Adam update. The same step serves a host-fed
    epoch and a device-resident corpus (``--device_data``: the batch is
    gathered on the card by ``index_select``).
  * Optimizer semantics of the reference's trainers: Adam with L2 weight
    decay folded into the gradient (torch ``Adam``, not ``AdamW``) and a
    per-epoch exponential decay of the learning rate, stepped per update
    as a staircase; the AGC cells' shared adjacency is left out of the
    optimizer (no update, no decay).
  * Mixed precision: bf16 forward and backward on fp32 master parameters,
    the loss in fp32.
  * Randomness: one ``torch.Generator`` per step, on the step's device,
    seeded from (seed, stage/epoch salt, step) through
    ``np.random.SeedSequence``, so a resumed run repeats its draws. The
    noise and the dropout masks are the JAX package's distributions, not
    its bits.
  * Data parallelism (``mesh=``): the batch splits into one contiguous
    block of rows a shard of the mesh's ``data`` axis; shard d runs the
    loss on its device with its copy of the parameters and draws its noise
    and masks at the global batch's size, keeping its rows
    (:class:`~a3gc_tpu_torch._device.RowDraws`), so a mesh step follows the
    single-device trajectory up to summation order. Each shard's loss is
    weighted by its share of the batch's real samples (the padded tail
    batch gives shards unequal weights), the gradients sum over the shards
    and, in a multi-process run, over the processes in one all-reduce, and
    every replica takes the same Adam step.
  * Tensor parallelism (a mesh with ``model > 1``, a :class:`StageRunner`):
    the master parameters are the blocks of
    :func:`~a3gc_tpu_torch.parallel.mesh.shard_params` on the first model
    group, so Adam keeps per-block moments (exact: Adam and the folded L2
    decay are elementwise); a step runs each shard's loss on the lead with
    the products column-parallel over its group
    (:mod:`a3gc_tpu_torch.parallel.tensor`), draws the lead's masks and
    noise, and sums the gradients over the ``data`` axis only. Validation
    gathers the blocks once a pass and runs the kernels on whole weights;
    ``state.params`` is the gathered module. A :class:`DIPRunner` keeps
    replicated parameters, as JAX does, and runs data-parallel over the
    groups' leads.

Stage input wiring:
  stage 1: inputs = imu,                        target = leaf positions
  stage 2: inputs = imu ‖ noisy leaf positions, target = all positions
  stage 3: inputs = imu ‖ noisy all positions,  target = rotations
Validation feeds clean positions, through the Hopper kernels on the card.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from a3gc_tpu_torch._device import RowDraws, resolve_device
from a3gc_tpu_torch._runtime import span, spanned
from a3gc_tpu_torch.config import TrainConfig
from a3gc_tpu_torch.data import pipeline as DP
from a3gc_tpu_torch.models.pipeline import (PoseNetConfig, pose_loss,
                                            pose_net_forward)
from a3gc_tpu_torch.parallel import tensor as TP

__all__ = [
    "TrainState", "make_optimizer", "StageRunner", "DIPRunner",
    "run_cascade_training", "stage_inputs_graph", "stage_inputs_flat",
    "GracefulInterrupt", "CheckpointRetention", "seeded_generator",
]


class GracefulInterrupt:
    r"""Cooperative SIGTERM/SIGINT stop for preemption-safe training.

    Wrap training in this context manager and pass it to
    :func:`run_cascade_training`: the first signal makes training stop at
    the next step boundary, write a checkpoint of the CURRENT params
    through the normal save path, log an ``"interrupted"`` event, and
    return cleanly — ``--resume`` picks the run back up. A second signal
    restores the previous handler and re-raises (escape hatch for a stuck
    save).

    Handlers only install in the main thread (signal-module rule);
    elsewhere the instance is inert and ``triggered`` stays False.
    """

    def __init__(self, signums=None):
        import signal
        self.signums = tuple(signums or (signal.SIGTERM, signal.SIGINT))
        self.triggered = False
        self._prev = {}

    def __call__(self) -> bool:
        return self.triggered

    def __enter__(self):
        import signal
        import threading
        if threading.current_thread() is threading.main_thread():
            for s in self.signums:
                self._prev[s] = signal.signal(s, self._handle)
        return self

    def _handle(self, signum, frame):
        import signal
        if self.triggered:              # second signal: hard escape
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            raise KeyboardInterrupt
        self.triggered = True

    def __exit__(self, *exc):
        import signal
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False


@dataclasses.dataclass
class TrainState:
    r"""A stage's training state: the fp32 master parameters (the net, or
    under tensor parallelism the list of its blocks, one module a member of
    the first model group), the optimizer and learning-rate schedule, the
    updates taken, and ``gather`` (tensor parallelism: the whole net from
    the blocks). ``params`` is the net, gathered at each read under tensor
    parallelism (a collective when the group spans processes)."""
    master: object
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    gather: Optional[Callable[[], nn.Module]] = None

    @property
    def params(self) -> nn.Module:
        return self.master if self.gather is None else self.gather()


def seeded_generator(device, *entropy) -> torch.Generator:
    r"""A ``torch.Generator`` on ``device`` seeded from integers (or tuples
    of them) through ``np.random.SeedSequence``: the training loops draw a
    step's noise and dropout masks from ``seeded_generator(dev, seed, salt,
    step)``."""
    flat = []
    for e in entropy:
        flat.extend(e if isinstance(e, (tuple, list)) else (e,))
    state = np.random.SeedSequence([int(e) for e in flat]).generate_state(
        1, np.uint64)
    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(int(state[0]) >> 1)


def _generator_like(gen: torch.Generator, device) -> torch.Generator:
    r"""A generator on ``device`` in ``gen``'s state (a shard's copy of a
    step's generator; the devices of one mesh are of one type)."""
    out = torch.Generator(device=device)
    out.set_state(gen.get_state())
    return out


def _mesh_eval_chunk(eval_b: int, mesh) -> int:
    r"""The validation chunk rounded down to a multiple of the mesh's data
    axis (at least one row a shard), so that every chunk splits evenly."""
    if mesh is None:
        return eval_b
    d = mesh.shape["data"]
    return max(d, eval_b // d * d)


def _adjacency_frozen(params: nn.Module, cfg: Optional[PoseNetConfig]):
    r"""The parameters left out of the optimizer: the AGC cells' shared
    adjacency (``requires_grad=False`` in the reference)."""
    if cfg is None or not (cfg.is_graph and cfg.net.cell == "agc"):
        return []
    return [params.rnn1.adj, params.rnn2.adj]


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int, params,
                   stage_cfg: Optional[PoseNetConfig] = None):
    r"""torch Adam (L2 weight decay into the gradient) over ``params`` (a
    module, or a list of modules: the blocks of a model group) but the
    frozen adjacency, and a ``LambdaLR`` stepped once per update: ``lr ·
    lr_decay ** ((step + start_epoch·steps) // steps)``, the staircase
    exponential decay per epoch, fast-forwarded by ``start_epoch`` like the
    reference's resume path. Returns (optimizer, scheduler)."""
    modules = params if isinstance(params, (list, tuple)) else [params]
    frozen = {id(p) for m in modules for p in _adjacency_frozen(m, stage_cfg)}
    optimizer = torch.optim.Adam(
        [p for m in modules for p in m.parameters() if id(p) not in frozen],
        lr=cfg.lr, weight_decay=cfg.weight_decay)
    steps = max(steps_per_epoch, 1)
    offset = cfg.start_epoch * steps
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: cfg.lr_decay ** ((step + offset) // steps))
    return optimizer, scheduler


def _cast_module(module: nn.Module, cast) -> nn.Module:
    r"""A structural copy of ``module`` whose parameters are ``cast(p)``
    (each block of a tensor-parallel view's split parameter): tensors
    computed from the originals, so gradients reach them. A copy, not a
    temporary substitution, because a step rematerialized in the backward
    pass reads the parameters again then."""
    return TP.map_parameters(module, lambda _, v: TP.blockwise(v, cast))


def _make_caster(train_cfg: TrainConfig):
    r"""``cast(tree)`` for the forward: identity in fp32; for bf16, bf16
    casts of the fp32 leaves of a module (the master parameters stay fp32
    and receive the gradients) or of a tensor. The optimizer update stays
    fp32."""
    if train_cfg.dtype != "bfloat16":
        return lambda tree: tree

    def bf16(t):
        return t.to(torch.bfloat16) if t.dtype == torch.float32 else t

    def cast(tree):
        if isinstance(tree, nn.Module):
            return _cast_module(tree, bf16)
        return bf16(tree)
    return cast


# ---------------------------------------------------------------------------
# stage input wiring
# ---------------------------------------------------------------------------

def stage_inputs_graph(batch: DP.GraphBatch, stage: int, train: bool):
    r"""Graph-model wiring: (inputs, target) of a stage."""
    imu, leaf_in, full_in, leaf, full, smpl = batch
    B, T = imu.shape[:2]
    if stage == 1:
        return imu, leaf
    if stage == 2:
        pos = leaf_in if train else leaf.reshape(B, T, 15, 3)
        return torch.cat((imu, pos), dim=-1), full
    pos = full_in if train else full.reshape(B, T, 15, 3)
    return torch.cat((imu, pos), dim=-1), smpl


def stage_inputs_flat(batch, stage: int, train: bool):
    r"""Flat TransPose wiring: (inputs, target) of a stage."""
    imu, leaf_in, full_in, leaf, full, smpl = batch
    if stage == 1:
        return imu, leaf
    if stage == 2:
        pos = leaf_in if train else leaf
        return torch.cat((imu, pos), dim=-1), full
    pos = full_in if train else full
    return torch.cat((imu, pos), dim=-1), smpl


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

class _Runner:
    r"""The step, epoch and validation loops shared by :class:`StageRunner`
    and :class:`DIPRunner`; a subclass gives ``_batch(raw, rng, train) ->
    (inputs, target)``. With a ``mesh`` the runner's device is the mesh's
    first; it holds the master parameters and the optimizer, and every
    other device of the mesh a copy refreshed after each update. With
    ``shard`` and a mesh whose ``model`` axis is above 1, the parameters
    are split over each model group (tensor parallelism)."""

    def __init__(self, stage_cfg: PoseNetConfig, params: nn.Module,
                 train_cfg: TrainConfig, steps_per_epoch: int,
                 stats, device, freeze_cfg: Optional[PoseNetConfig],
                 mesh=None, shard: bool = False):
        if train_cfg.accum_steps < 1 or \
                train_cfg.batch_size % train_cfg.accum_steps:
            raise ValueError(f"accum_steps={train_cfg.accum_steps} must "
                             f"divide batch_size={train_cfg.batch_size}")
        self.mesh = mesh
        if mesh is not None:
            d = mesh.shape["data"]
            if train_cfg.batch_size % d:
                raise ValueError(
                    f"batch_size={train_cfg.batch_size} must divide evenly "
                    f"over the mesh data axis ({d} devices)")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.stage_cfg = stage_cfg
        self.cfg = train_cfg
        self.stats = (None if stats is None else
                      {k: torch.as_tensor(np.asarray(v, np.float32),
                                          device=self.device)
                       for k, v in stats.items()})
        self._stats_moved = {}
        params = copy.deepcopy(params).to(self.device)     # private copy
        self._split = None      # the names of the split parameters (TP)
        master = [params]
        if shard and mesh is not None and mesh.shape["model"] > 1:
            from a3gc_tpu_torch.parallel.mesh import shard_params, split_names
            self._split = split_names(params, mesh)
            master = shard_params(params, mesh)
        optimizer, scheduler = make_optimizer(train_cfg, steps_per_epoch,
                                              master, freeze_cfg)
        if self._split is None:
            self.state = TrainState(params, optimizer, scheduler)
        else:
            self.state = TrainState(master, optimizer, scheduler,
                                    gather=self._gather)
        self._members, self._copies = (None, []) if mesh is None \
            else self._place(master)
        self._cast = _make_caster(train_cfg)
        self._eval_b = _mesh_eval_chunk(
            train_cfg.eval_batch_size or min(train_cfg.batch_size, 128),
            mesh)
        self.interrupt = None

    def _stats_on(self, device: torch.device):
        r"""The normalization stats on ``device`` (a shard's)."""
        if self.stats is None or device == self.device:
            return self.stats
        if device not in self._stats_moved:
            self._stats_moved[device] = {k: v.to(device)
                                         for k, v in self.stats.items()}
        return self._stats_moved[device]

    def loss(self, params: nn.Module, raw: Dict[str, torch.Tensor],
             rng: Optional[torch.Generator]) -> torch.Tensor:
        r"""The stage's loss on a raw batch (tensors on the runner's
        device): training with ``rng`` (noise and dropout drawn from it),
        validation without (clean inputs, the kernels)."""
        raw = dict(raw)
        weight = raw.pop("_weight", None)   # padded tail batch (Sampler)
        inputs, target = self._batch(raw, rng, rng is not None)
        pred, _ = pose_net_forward(self._cast(params), self.stage_cfg,
                                   self._cast(inputs), rng=rng)
        return pose_loss(pred.reshape(target.shape).float(), target,
                         sample_weight=weight)

    def batch_at(self, sampler: DP.Sampler, take, weight=None
                 ) -> Dict[str, torch.Tensor]:
        r"""Rows ``take`` of the sampler's corpus on the runner's device:
        gathered on the device from ``sampler.device_data``, else sliced on
        the host and copied."""
        dev = self.device
        w = None if weight is None else torch.as_tensor(weight, device=dev)
        if sampler.device_data is not None:
            return DP.gather(sampler.device_data,
                             torch.as_tensor(take, device=dev), w)
        raw = {k: torch.as_tensor(v[take], device=dev)
               for k, v in sampler.data.items()}
        if w is not None:
            raw["_weight"] = w
        return raw

    @spanned("jit_train_step")
    def train_step(self, raw: Dict[str, torch.Tensor],
                   rng: torch.Generator) -> torch.Tensor:
        r"""One optimizer update on a raw batch; returns its loss (a device
        scalar). With ``accum_steps = k`` the batch splits into k
        sequential microbatches whose gradients combine weighted by their
        real samples: the weighted-mean gradient of the whole batch, at
        the peak activation memory of one microbatch. Under a mesh ``raw``
        is the global batch (host arrays or tensors): each microbatch splits
        over the shards (:meth:`_mesh_update`), and ``rng`` lies on the
        mesh's first device."""
        if self.mesh is not None:
            return self._mesh_update(self._micro(raw), rng)
        st = self.state
        st.params.zero_grad(set_to_none=True)
        k = self.cfg.accum_steps
        if k == 1:
            loss = self.loss(st.params, raw, rng)
            loss.backward()
        else:
            B = len(next(iter(raw.values())))
            weights = raw.get("_weight")
            total = float(k) if weights is None else weights.sum()
            loss = 0.0
            for i in range(k):
                mb = {key: v[i * B // k:(i + 1) * B // k]
                      for key, v in raw.items()}
                w = 1.0 if weights is None else mb["_weight"].sum()
                mb_loss = self.loss(st.params, mb, rng)
                (mb_loss * (w / total)).backward()
                loss = loss + mb_loss.detach() * w
            loss = loss / total
        st.optimizer.step()
        st.scheduler.step()
        st.step += 1
        return loss.detach()

    # -- data parallelism over a mesh ------------------------------------

    def _check_corpus(self, sampler: DP.Sampler) -> bool:
        r"""Whether the sampler's corpus is a :func:`~a3gc_tpu_torch.data.
        pipeline.put_device_sharded` one; a mesh runner takes it or a host
        corpus, a runner without a mesh takes no sharded one."""
        sharded = isinstance(sampler.device_data, DP.ShardedCorpus)
        if self.mesh is not None and sampler.device_data is not None \
                and not sharded:
            raise ValueError(
                "a mesh runner needs a put_device_sharded(...) corpus "
                "(row-sharded over the 'data' axis), or none")
        if self.mesh is None and sharded:
            raise ValueError("a put_device_sharded(...) corpus needs a mesh "
                             "runner")
        return sharded

    def _micro(self, raw, k: Optional[int] = None) -> list:
        r"""A global batch (host arrays or tensors, ``_weight`` optional) as
        its ``k`` (default ``accum_steps``) microbatches, each ``(shards,
        weight)``: one raw batch a shard of this process on its device, and
        the microbatch's global weights (host, or None)."""
        from a3gc_tpu_torch.parallel.mesh import shard_batch
        k = k or self.cfg.accum_steps
        B = len(next(iter(raw.values())))
        w = raw.get("_weight")
        if isinstance(w, torch.Tensor):
            w = w.cpu().numpy()
        out = []
        for i in range(k):
            rows = slice(i * B // k, (i + 1) * B // k)
            out.append((shard_batch({key: v[rows] for key, v in raw.items()},
                                    self.mesh),
                        None if w is None else np.asarray(w[rows],
                                                          np.float32)))
        return out

    def _micro_corpus(self, corpus, idx: np.ndarray,
                      weight: Optional[np.ndarray], k: int) -> list:
        r"""Microbatches of one step of a sharded corpus: ``idx`` / ``weight``
        [D, b] from :meth:`~a3gc_tpu_torch.data.pipeline.Sampler.
        iter_indices_sharded`; microbatch m takes columns [m·b/k,
        (m+1)·b/k) of every shard (shard-major), each shard gathering from
        its own block on its device."""
        b = idx.shape[1]
        first = self.mesh.first_shard
        out = []
        for m in range(k):
            cols = slice(m * b // k, (m + 1) * b // k)
            shards = []
            for i, (block, dev) in enumerate(zip(corpus.shards,
                                                 self.mesh.devices)):
                w = (None if weight is None else torch.as_tensor(
                    weight[first + i, cols], device=dev))
                shards.append(DP.gather(block, torch.as_tensor(
                    idx[first + i, cols], device=dev), w))
            out.append((shards, None if weight is None
                        else np.ascontiguousarray(weight[:, cols]).reshape(
                            -1)))
        return out

    def _place(self, master: list):
        r"""The members of each local data shard's model group on their
        devices (one module a member; without tensor parallelism one
        replica, on the shard's device), and the copies other than the
        master's as (member index, module): one a member index and device,
        shared by the shards on that device."""
        groups = (self.mesh.model_devices if self._split is not None
                  else [(dev,) for dev in self.mesh.devices])
        home = {(k, dev): m for k, (dev, m) in enumerate(zip(groups[0],
                                                             master))}
        members, copies = [], []
        for group in groups:
            row = []
            for k, dev in enumerate(group):
                if (k, dev) not in home:
                    home[(k, dev)] = copy.deepcopy(master[k]).to(dev)
                    copies.append((k, home[(k, dev)]))
                row.append(home[(k, dev)])
            members.append(row)
        return members, copies

    def _train_params(self, i: int):
        r"""What local shard ``i``'s training loss reads: its replica, or
        under tensor parallelism the column view of its group's blocks
        (made anew for each backward pass: the view's gathers are part of
        the graph)."""
        members = self._members[i]
        if self._split is None:
            return members[0]
        return TP.column_view(members, self._split, self.mesh.model_group)

    def _gather(self) -> nn.Module:
        r"""The whole net from the master blocks, on the runner's device."""
        return TP.gather_module(self.state.master, self._split,
                                self.mesh.model_group)

    def _eval_params(self) -> list:
        r"""One whole net a local shard, on its device, for validation: the
        replicas, or under tensor parallelism the blocks gathered once and
        copied to each shard's device (the kernels take whole weights)."""
        if self._split is None:
            return [m[0] for m in self._members]
        from a3gc_tpu_torch.parallel.mesh import replicate
        return replicate(self._gather(), self.mesh)

    def _shard_terms(self, shards, weight: Optional[np.ndarray],
                     params: list, gens=None) -> list:
        r"""Each local shard's loss times its share of the global batch's
        real samples (``weight`` [B] host, or None: rows count equally):
        their sum over every shard is the loss of the whole batch.
        ``params``: what each shard reads; ``gens``: one generator a shard
        (training), or None."""
        D = self.mesh.shape["data"]
        b = len(next(iter(shards[0].values())))
        B = b * D
        total = None if weight is None else np.float32(weight.sum())
        terms = []
        for i, raw in enumerate(shards):
            g = self.mesh.first_shard + i
            if weight is None:
                share = np.float32(b) / np.float32(B)
            else:
                part = np.float32(weight[g * b:(g + 1) * b].sum())
                share = part / total if total else np.float32(0.0)
            rng = None if gens is None else RowDraws(gens[i], B, g * b, b)
            terms.append(self.loss(params[i], raw, rng) * float(share))
        return terms

    def _local_sum(self, terms) -> torch.Tensor:
        r"""The detached sum of per-shard terms on the runner's device."""
        out = terms[0].detach().to(self.device)
        for t in terms[1:]:
            out = out + t.detach().to(self.device)
        return out

    def _mesh_update(self, micro, rng: torch.Generator) -> torch.Tensor:
        r"""One optimizer update over microbatches split into shards
        (:meth:`_micro`, :meth:`_micro_corpus`): the shards' weighted
        losses back-propagate into their replicas (or blocks), the
        gradients sum onto the master parameters and over the processes of
        the data axis (one all-reduce, with the loss), then the Adam step
        and the refresh of the copies. Returns the global batch's loss."""
        from a3gc_tpu_torch.parallel.multihost import all_reduce_sum
        st = self.state
        gens = [_generator_like(rng, dev) for dev in self.mesh.devices]
        master = self._members[0]
        for m in master + [c for _, c in self._copies]:
            m.zero_grad(set_to_none=True)
        k = len(micro)
        wm = [None if w is None else np.float32(w.sum()) for _, w in micro]
        total = (np.float32(k) if wm[0] is None
                 else np.float32(sum(wm, np.float32(0.0))))
        loss = None
        for (shards, w), w_mb in zip(micro, wm):
            params = [self._train_params(i)
                      for i in range(len(self.mesh.devices))]
            terms = self._shard_terms(shards, w, params, gens)
            if k > 1:
                scale = float((np.float32(1.0) if w_mb is None else w_mb)
                              / total)
                torch.autograd.backward([t * scale for t in terms])
                mb = self._local_sum(terms) * float(
                    1.0 if w_mb is None else w_mb)
            else:
                torch.autograd.backward(terms)
                mb = self._local_sum(terms)
            loss = mb if loss is None else loss + mb
        if k > 1:
            loss = loss / float(total)
        for j, rep in self._copies:
            for p, q in zip(master[j].parameters(), rep.parameters()):
                if q.grad is not None:
                    g = q.grad.to(p.device)
                    p.grad = g if p.grad is None else p.grad.add_(g)
        all_reduce_sum([p.grad for m in master for p in m.parameters()
                        if p.grad is not None] + [loss],
                       group=self.mesh.data_group)
        st.optimizer.step()
        st.scheduler.step()
        st.step += 1
        with torch.no_grad():
            for j, rep in self._copies:
                for q, p in zip(rep.parameters(), master[j].parameters()):
                    q.copy_(p)
        return loss

    def _host_batch(self, sampler: DP.Sampler, take, weight=None):
        r"""Rows ``take`` of the sampler's host corpus as host arrays (a
        mesh step copies each shard's rows straight to its device)."""
        raw = {k: v[take] for k, v in sampler.data.items()}
        if weight is not None:
            raw["_weight"] = weight
        return raw

    def _mesh_steps(self, sampler: DP.Sampler):
        r"""The epoch's microbatched steps under a mesh."""
        if not self._check_corpus(sampler):
            for take, w in sampler.iter_indices():
                yield self._micro(self._host_batch(sampler, take, w))
            return
        d, k = self.mesh.shape["data"], self.cfg.accum_steps
        if self.cfg.batch_size % (d * k):
            raise ValueError(
                f"batch_size={self.cfg.batch_size} must divide evenly over "
                f"data axis x accum_steps ({d} x {k})")
        for idx, w in sampler.iter_indices_sharded(d):
            yield self._micro_corpus(sampler.device_data, idx, w, k)

    def _mesh_eval_chunks(self, sampler: DP.Sampler):
        r"""Validation chunks under a mesh: ``(shards, weight, n)``, n the
        chunk's real samples (all-pad chunks skipped)."""
        if not self._check_corpus(sampler):
            for take, w_all in sampler.iter_indices():
                for s in range(0, len(take), self._eval_b):
                    tk = take[s:s + self._eval_b]
                    wc = None if w_all is None else w_all[s:s + self._eval_b]
                    n = float(wc.sum()) if wc is not None else len(tk)
                    if n:
                        (shards, w), = self._micro(
                            self._host_batch(sampler, tk, wc), 1)
                        yield shards, w, n
            return
        d = self.mesh.shape["data"]
        ebl = max(1, self._eval_b // d)        # rows a shard a chunk
        for idx, w_all in sampler.iter_indices_sharded(d):
            for s in range(0, idx.shape[1], ebl):
                tk = idx[:, s:s + ebl]
                wc = None if w_all is None else w_all[:, s:s + ebl]
                n = float(wc.sum()) if wc is not None else tk.size
                if n:
                    (shards, w), = self._micro_corpus(
                        sampler.device_data, tk, wc, 1)
                    yield shards, w, n

    # -- epochs ----------------------------------------------------------

    def train_epoch(self, sampler: DP.Sampler, seed=0) -> float:
        r"""One epoch of steps; step i draws from ``seeded_generator(device,
        seed, i)``. Losses stay on the device until the epoch ends. Stops
        at a step boundary when ``self.interrupt()`` turns true."""
        losses = []
        if self.mesh is not None:
            steps = ((micro, self._mesh_update)
                     for micro in self._mesh_steps(sampler))
        else:
            self._check_corpus(sampler)
            steps = ((self.batch_at(sampler, take, w), self.train_step)
                     for take, w in sampler.iter_indices())
        for i, (batch, update) in enumerate(steps):
            if self.interrupt is not None and self.interrupt():
                break
            losses.append(update(batch,
                                 seeded_generator(self.device, seed, i)))
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())

    @torch.no_grad()
    def eval_epoch(self, sampler: DP.Sampler) -> float:
        r"""Validation pass in chunks of ``eval_batch_size`` (0: min(batch,
        128)): the size-weighted mean of the chunks' losses. Padded tail
        batches weight each chunk by its REAL sample count, so the result
        is the mean over the dataset's native size. Under a mesh each
        chunk splits over the shards, and the chunks' losses sum over the
        processes, so every process sees the same loss."""
        if self.mesh is not None:
            return self._mesh_eval_epoch(sampler)
        self._check_corpus(sampler)
        losses, weights = [], []
        for take, w_all in sampler.iter_indices():
            B = len(take)
            for s in range(0, B, self._eval_b):
                wc = None if w_all is None else w_all[s:s + self._eval_b]
                n = (float(wc.sum()) if wc is not None
                     else min(self._eval_b, B - s))
                if n == 0:
                    continue    # all-pad chunk: nothing real to score
                with span("jit_eval_step"):
                    losses.append(self.loss(
                        self.state.params,
                        self.batch_at(sampler, take[s:s + self._eval_b], wc),
                        None))
                weights.append(n)
        if not losses:
            return 0.0
        w = torch.tensor(weights, dtype=torch.float32)
        return float(torch.stack(losses).cpu() @ w / w.sum())

    def _mesh_eval_epoch(self, sampler: DP.Sampler) -> float:
        from a3gc_tpu_torch.parallel.multihost import all_reduce_sum
        losses, weights = [], []
        params = self._eval_params()
        for shards, wc, n in self._mesh_eval_chunks(sampler):
            with span("jit_eval_step"):
                losses.append(self._local_sum(self._shard_terms(shards, wc,
                                                                params)))
            weights.append(n)
        if not losses:
            return 0.0
        stacked = torch.stack(losses)
        all_reduce_sum([stacked], group=self.mesh.data_group)
        w = torch.tensor(weights, dtype=torch.float32)
        return float(stacked.cpu() @ w / w.sum())


class StageRunner(_Runner):
    r"""Trains one cascade stage (graph or flat TransPose); on a mesh with
    ``model > 1``, tensor-parallel (the parameters ``param_sharding`` splits
    held as blocks over each model group)."""

    def __init__(self, stage: int, stage_cfg: PoseNetConfig,
                 params: nn.Module, train_cfg: TrainConfig,
                 steps_per_epoch: int, stats=None, graph: bool = True,
                 device="cuda", mesh=None):
        super().__init__(stage_cfg, params, train_cfg, steps_per_epoch,
                         stats if train_cfg.normalize else None, device,
                         stage_cfg, mesh, shard=True)
        self.stage = stage
        self.graph = graph
        self._assemble = DP.graph_batch if graph else DP.flat_batch
        self._wire = stage_inputs_graph if graph else stage_inputs_flat
        self._noise_kw = ({"noise_std": train_cfg.full_noise_std} if graph
                          else {"leaf_noise_std": train_cfg.leaf_noise_std,
                                "full_noise_std": train_cfg.full_noise_std})
        self._rotsize = stage_cfg.rotsize if stage == 3 else 9

    def _batch(self, raw, rng, train):
        batch = self._assemble(raw, self._stats_on(raw["ori"].device), rng,
                               rotsize=self._rotsize, **self._noise_kw)
        return self._wire(batch, self.stage, train=train)

    @torch.no_grad()
    def eval_full_sequences(self, sequences, batch: int = None) -> float:
        r"""Full-sequence validation (the reference's ``--fse``): each
        variable-length sequence scored at its native length, the plain
        mean over sequences. Sequences group by power-of-two bucket
        length, ``batch`` rows a pass (default: the eval chunk size), each
        group end-padded to its longest member with a frame mask; per
        sequence the masked loss is exactly the native-length one. Under a
        mesh (one process) a pass takes a multiple of the data axis of
        rows, padded with empty ones, and splits over the shards."""
        from a3gc_tpu_torch.eval.run import bucket_length
        from a3gc_tpu_torch.parallel.mesh import batch_sharding

        dev = self.device
        d = 1 if self.mesh is None else self.mesh.shape["data"]
        if self.mesh is not None and self.mesh.process_count > 1:
            raise ValueError("full-sequence validation runs in one process")
        groups = {}
        for seq in sequences:
            T = len(next(iter(seq.values())))
            groups.setdefault(bucket_length(T), []).append((seq, T))
        fb = batch or self._eval_b
        fb = max(d, fb // d * d)            # mesh-divisible pass rows
        eval_params = None if self.mesh is None else self._eval_params()
        total, count = 0.0, 0
        for _, group in sorted(groups.items()):
            for g0 in range(0, len(group), fb):
                chunk = group[g0:g0 + fb]
                n_valid = np.array([T for _, T in chunk]
                                   + [0] * (-len(chunk) % d))
                L = int(n_valid.max())
                raw = {}
                for k, v in chunk[0][0].items():
                    v = np.asarray(v)
                    raw[k] = np.zeros((len(n_valid), L) + v.shape[1:],
                                      v.dtype)
                for i, (seq, T) in enumerate(chunk):
                    for k, v in seq.items():
                        raw[k][i, :T] = v
                mask = np.arange(L)[None] < n_valid[:, None]
                with span("jit_step"):
                    if self.mesh is None:
                        per_seq = self._per_sequence_loss(
                            {k: torch.as_tensor(v, device=dev)
                             for k, v in raw.items()}, mask)
                    else:
                        per_seq = torch.cat([
                            self._per_sequence_loss(
                                {k: torch.as_tensor(v[rows], device=sd)
                                 for k, v in raw.items()}, mask[rows],
                                params).to(dev)
                            for rows, sd, params in zip(
                                batch_sharding(self.mesh, len(n_valid)),
                                self.mesh.devices, eval_params)])
                total += float(per_seq[:len(chunk)].sum())
                count += len(chunk)
        return total / max(count, 1)

    def _per_sequence_loss(self, raw, mask: np.ndarray,
                           params: Optional[nn.Module] = None
                           ) -> torch.Tensor:
        r"""Per-row frame-masked loss [B]: pose_loss's masked mean, un-pooled
        over the batch, on the fp32 master parameters (or ``params``, a
        shard's copy)."""
        inputs, target = self._batch(raw, None, False)
        pred, _ = pose_net_forward(
            self.state.params if params is None else params, self.stage_cfg,
            inputs, frame_mask=mask)
        err = torch.square(target - pred.reshape(target.shape)).sum(-1)
        m = torch.as_tensor(mask, dtype=err.dtype, device=err.device)
        w = m.reshape(m.shape + (1,) * (err.dim() - 2))
        per_frame = err[0, 0].numel() if err.dim() > 2 else 1
        denom = m.sum(dim=1) * per_frame
        return ((err * w).sum(dim=tuple(range(1, err.dim())))
                / torch.clamp(denom, min=1.0))


class DIPRunner(_Runner):
    r"""Single-stage DIP trainer: input the normalized 60-channel no-root
    IMU vector, target the reduced pose. On a mesh with ``model > 1`` its
    parameters stay replicated (JAX's DIP runner does not shard them):
    data-parallel over the model groups' leads."""

    def __init__(self, stage_cfg: PoseNetConfig, params: nn.Module,
                 train_cfg: TrainConfig, steps_per_epoch: int, stats,
                 device="cuda", mesh=None):
        super().__init__(stage_cfg, params, train_cfg, steps_per_epoch,
                         stats, device, None, mesh)

    def _batch(self, raw, rng, train):
        return DP.dip_batch(raw, self._stats_on(raw["ori"].device),
                            rotsize=self.stage_cfg.rotsize)


def _accepts_salt(fn) -> bool:
    r"""Whether ``fn`` binds ONE positional argument (a ``lambda **kw`` or
    keyword-only signature takes the zero-argument call)."""
    try:
        inspect.signature(fn).bind(0)
        return True
    except (TypeError, ValueError):
        return False


def run_cascade_training(
        runners: Dict[int, StageRunner],
        train_sampler_fn: Callable[..., DP.Sampler],
        valid_sampler_fn: Callable[[], DP.Sampler],
        cfg: TrainConfig,
        save_fn: Optional[Callable[[int, int, nn.Module], object]] = None,
        log_fn: Optional[Callable[[dict], None]] = None,
        valid_fn: Optional[Callable[[StageRunner], float]] = None,
        interrupt: Optional[Callable[[], bool]] = None):
    r"""The 3-stage sequential driver with per-stage early stopping: stages
    run in order from ``cfg.start_stage``; a stage stops after
    ``cfg.patience`` epochs without validation improvement; a checkpoint is
    written on every improvement (bounded by :class:`CheckpointRetention`).

    ``train_sampler_fn`` is called with a per-(stage, epoch) salt so every
    epoch gets a fresh shuffle order, deterministic given ``cfg.seed``
    (zero-argument factories are accepted too); the epoch's steps draw
    from ``(cfg.seed, salt, step)``. ``valid_fn`` replaces the chunked
    validation (``--fse``). ``interrupt`` (a :class:`GracefulInterrupt` or
    any nullary bool) stops at the next step boundary: the CURRENT params
    are saved as a normal checkpoint, an ``"interrupted"`` event logged,
    and the function returns. In a multi-process run the flag is read at
    epoch boundaries only, OR-ed over the processes
    (:func:`~a3gc_tpu_torch.parallel.multihost.interrupt_checker`), so
    every process stops at the same one; its runners need a mesh."""
    from a3gc_tpu_torch.parallel.multihost import (interrupt_checker,
                                                   process_count)
    takes_salt = _accepts_salt(train_sampler_fn)
    multihost = process_count() > 1
    # validated up front: a mesh-less runner cannot sync the stop flag
    stopped = {stage: interrupt_checker(interrupt, r.mesh)
               for stage, r in runners.items()}
    for stage in sorted(runners):
        if stage < cfg.start_stage:
            continue
        runner = runners[stage]
        runner.interrupt = None if multihost else interrupt
        best, tol = float("inf"), 0
        retention = CheckpointRetention(cfg)
        for epoch in range(cfg.start_epoch, cfg.max_epochs):
            t0 = time.time()
            salt = stage * 10000 + epoch
            train_loss = runner.train_epoch(
                train_sampler_fn(salt) if takes_salt else train_sampler_fn(),
                (cfg.seed, salt))
            if stopped[stage]():
                if save_fn:
                    save_fn(stage, epoch, runner.state.params)
                if log_fn:
                    log_fn({"stage": stage, "epoch": epoch,
                            "event": "interrupted",
                            "train_loss": train_loss,
                            "seconds": time.time() - t0})
                return runners
            if valid_fn is not None:
                valid_loss = valid_fn(runner)
            else:
                valid_loss = runner.eval_epoch(valid_sampler_fn())
            if log_fn:
                log_fn({"stage": stage, "epoch": epoch,
                        "train_loss": train_loss, "valid_loss": valid_loss,
                        "seconds": time.time() - t0})
            if valid_loss < best:
                best, tol = valid_loss, 0
                if save_fn:
                    retention.save(valid_loss, lambda: save_fn(
                        stage, epoch, runner.state.params))
            else:
                tol += 1
            if tol > cfg.patience:
                break
    return runners


def _remove_checkpoint(path: str) -> None:
    r"""Prune one checkpoint directory (retention policy). Only ever called
    on paths the CURRENT run's save_fn returned."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)


class CheckpointRetention:
    r"""Save-on-improvement disk bounding (``--keep N`` / ``--min_delta
    D``): skip checkpoints whose improvement over the LAST SAVED loss is
    below ``min_save_delta``, and prune improvement checkpoints THIS run
    wrote beyond the newest ``keep_checkpoints``. Early stopping is
    untouched, and interrupt checkpoints never pass through here. At the
    defaults (min_delta 0, keep 0) every improvement is saved and kept."""

    def __init__(self, cfg: TrainConfig):
        self.min_delta = cfg.min_save_delta
        self.keep = cfg.keep_checkpoints
        self.last_saved = float("inf")
        self.written = []

    def save(self, valid_loss: float, do_save) -> bool:
        r"""``do_save: () -> path | None`` runs only when the min-delta gate
        passes; returns whether a write happened."""
        if not (valid_loss < self.last_saved - self.min_delta):
            return False
        path = do_save()
        self.last_saved = valid_loss
        if self.keep > 0 and isinstance(path, str):
            self.written.append(path)
            while len(self.written) > self.keep:
                _remove_checkpoint(self.written.pop(0))
        return True
