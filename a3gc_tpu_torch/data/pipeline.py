r"""Input pipeline: packed arrays → net inputs (counterpart of
``a3gc_tpu/data/pipeline.py``).

The packed arrays stay numpy on the host; :class:`Sampler` yields index
slices (or the batches they take); the per-sample math — (x − μ)/σ, the
scatter onto the 15-node graph, the teacher-forcing noise — runs on the
batch's device (:func:`graph_batch`, :func:`flat_batch`,
:func:`dip_batch`). :func:`put_device` uploads a corpus once so that a
training step gathers its batch on the card by index.

Layout of a packed dataset (npz or dict of arrays):
  acc [N, T, 18]  ori [N, T, 54]  pose [N, T, 135]
  leaf_pos [N, T, 5, 3]  full_pos [N, T, 24, 3]

For mesh training, :func:`put_device_sharded` splits a corpus into one
block of rows a device of the mesh, and :meth:`Sampler.iter_indices_sharded`
draws each shard's batch rows from its own block.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from a3gc_tpu_torch._device import index_tensor, random_rows
from a3gc_tpu_torch.config import joint_set as JS
from a3gc_tpu_torch.ops import rotations as R

__all__ = ["normalize_imu", "scatter_graph_inputs", "pose_to_r6d",
           "graph_batch", "flat_batch", "dip_batch", "GraphBatch",
           "Sampler", "load_packed", "put_device", "put_device_sharded",
           "ShardedCorpus", "gather"]

GraphBatch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor, torch.Tensor]


def normalize_imu(ori: torch.Tensor, acc: torch.Tensor,
                  stats: Optional[Dict[str, torch.Tensor]]):
    r"""Per-channel (x − μ)/σ. ``stats`` holds tensors on the inputs'
    device, or is None for no normalization."""
    if stats is None:
        return ori, acc
    ori = (ori - stats["ori_mean_channel"]) / stats["ori_std_channel"]
    acc = (acc - stats["acc_mean_channel"]) / stats["acc_std_channel"]
    return ori, acc


def scatter_graph_inputs(ori: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    r"""Scatter the 5 non-root sensors' (acc3 + ori9) onto the 15-node graph.
    ori [..., 54], acc [..., 18] → [..., 15, 12]; the other nodes are 0."""
    lead = ori.shape[:-1]
    acc5 = acc.reshape(lead + (6, 3))[..., :5, :]
    ori5 = ori.reshape(lead + (6, 9))[..., :5, :]
    feats = torch.cat((acc5, ori5), dim=-1)                   # [..., 5, 12]
    out = ori.new_zeros(lead + (15, 12))
    out[..., index_tensor(JS.input_joints, ori.device), :] = feats
    return out


def _scatter_leaf(full_pos: torch.Tensor) -> torch.Tensor:
    r"""Scatter the 5 leaf-joint positions onto their reduced-graph nodes.
    full_pos [..., 24, 3] → [..., 15, 3]; the other nodes are 0."""
    dev = full_pos.device
    out = full_pos.new_zeros(full_pos.shape[:-2] + (15, 3))
    out[..., index_tensor(JS.leaf_nodes_reduced, dev), :] = \
        full_pos[..., index_tensor(JS.leaf_nodes, dev), :]
    return out


def _noisy(x: torch.Tensor, std: float, rng) -> torch.Tensor:
    r"""x + std·N(0, 1) drawn from the generator ``rng`` (or a shard's
    :class:`~a3gc_tpu_torch._device.RowDraws` of it); x without one."""
    if rng is None:
        return x
    return x + std * random_rows(torch.randn, rng, x.shape, x.device,
                                 dtype=x.dtype)


def pose_to_r6d(pose135: torch.Tensor) -> torch.Tensor:
    r"""Reduced global rotation matrices [..., 135] → 6D [..., 90]."""
    lead = pose135.shape[:-1]
    return R.rotation_matrix_to_r6d(pose135.reshape(-1, 3, 3)).reshape(
        lead + (90,))


def graph_batch(raw: Dict[str, torch.Tensor],
                stats: Optional[Dict[str, torch.Tensor]] = None,
                rng: Optional[torch.Generator] = None,
                noise_std: float = 0.025, rotsize: int = 9) -> GraphBatch:
    r"""A graph model's batch.

    :param raw: acc [B, T, 18], ori [B, T, 54], pose [B, T, 135], full_pos
        [B, T, 24, 3] (root-relative), tensors on one device.
    :param rng: the teacher-forcing noise's generator, on that device; None
        ⇒ no noise (validation feeds clean positions).
    :return: (inputs [B, T, 15, 12], leaf_pos_input [B, T, 15, 3],
        full_pos_input [B, T, 15, 3], leaf_pos [B, T, 45], full_pos
        [B, T, 45], smpl [B, T, 135 | 90]).
    """
    ori, acc = normalize_imu(raw["ori"], raw["acc"], stats)
    full_pos = raw["full_pos"]
    noisy = _noisy(full_pos, noise_std, rng)
    inputs = scatter_graph_inputs(ori, acc)
    reduced = index_tensor(JS.reduced, full_pos.device)
    B, T = inputs.shape[:2]
    smpl = pose_to_r6d(raw["pose"]) if rotsize == 6 else raw["pose"]
    return (inputs, _scatter_leaf(noisy), noisy[..., reduced, :],
            _scatter_leaf(full_pos).reshape(B, T, 45),
            full_pos[..., reduced, :].reshape(B, T, 45), smpl)


def flat_batch(raw: Dict[str, torch.Tensor],
               stats: Optional[Dict[str, torch.Tensor]] = None,
               rng: Optional[torch.Generator] = None,
               leaf_noise_std: float = 0.04, full_noise_std: float = 0.025,
               rotsize: int = 9):
    r"""A flat TransPose batch.

    :return: (inputs [B, T, 72], leaf_pos_input [B, T, 15], full_pos_input
        [B, T, 69], leaf_pos [B, T, 15], full_pos [B, T, 69], smpl
        [B, T, 135 | 90]).
    """
    ori, acc = normalize_imu(raw["ori"], raw["acc"], stats)
    leaf = raw["leaf_pos"]                       # [B, T, 5, 3]
    full = raw["full_pos"][..., 1:, :]           # the root dropped
    leaf_in = _noisy(leaf, leaf_noise_std, rng)
    full_in = _noisy(full, full_noise_std, rng)
    B, T = ori.shape[:2]
    smpl = pose_to_r6d(raw["pose"]) if rotsize == 6 else raw["pose"]
    return (torch.cat((acc, ori), dim=-1), leaf_in.reshape(B, T, 15),
            full_in.reshape(B, T, 69), leaf.reshape(B, T, 15),
            full.reshape(B, T, 69), smpl)


def dip_batch(raw: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
              no_root: bool = True, rotsize: int = 9):
    r"""A DIP net's batch: drop the root sensor's channels (``no_root``),
    normalize with the train stats, concatenate acc ‖ ori; the targets as
    stored, or as 6D for ``rotsize=6``. ``raw`` holds ori [B, T, 54], acc
    [B, T, 18], pose [B, T, 135]; ``stats`` tensors on their device.

    :return: (inputs [B, T, 60], smpl [B, T, 135 | 90])."""
    ori, acc = raw["ori"], raw["acc"]
    om, os_ = stats["ori_mean_channel"], stats["ori_std_channel"]
    am, as_ = stats["acc_mean_channel"], stats["acc_std_channel"]
    if no_root:
        ori, om, os_ = ori[..., :-9], om[..., :-9], os_[..., :-9]
        acc, am, as_ = acc[..., :-3], am[..., :-3], as_[..., :-3]
    ori = (ori - om) / os_
    acc = (acc - am) / as_
    smpl = pose_to_r6d(raw["pose"]) if rotsize == 6 else raw["pose"]
    return torch.cat((acc, ori), dim=-1), smpl


# ---------------------------------------------------------------------------
# host-side sampling
# ---------------------------------------------------------------------------

def load_packed(path: str) -> Dict[str, np.ndarray]:
    """Load a packed npz dataset into host numpy."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def put_device(data: Dict[str, np.ndarray], device="cuda"
               ) -> Dict[str, torch.Tensor]:
    r"""Upload a packed corpus to ``device`` once, for device-resident
    training (``Sampler(device_data=...)``, ``cli train --device_data``):
    a step then gathers its batch by index on the device (:func:`gather`),
    and the per-step host → device traffic is a [B] index vector. Tensors
    already there pass through, so one upload can serve several samplers."""
    from a3gc_tpu_torch._device import resolve_device
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v)
                               if isinstance(v, np.ndarray) else v,
                               device=dev)
            for k, v in data.items()}


def gather(data: Dict[str, torch.Tensor], take: torch.Tensor,
           weight: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    r"""A raw batch from a device-resident corpus: rows ``take`` [B] of every
    array (``index_select`` on their device), with the padded tail's
    ``"_weight"`` when given."""
    raw = {k: v.index_select(0, take) for k, v in data.items()}
    if weight is not None:
        raw["_weight"] = weight
    return raw


@dataclasses.dataclass
class ShardedCorpus:
    r"""A packed corpus split over a mesh's ``data`` axis
    (:func:`put_device_sharded`): ``shards[d]`` holds the ``rows`` rows of
    this process's shard d on its device; the global corpus is ``n_data``
    such blocks (the last ones end in padding)."""

    shards: List[Dict[str, torch.Tensor]]
    rows: int
    n_data: int

    def keys(self):
        return self.shards[0].keys()


def put_device_sharded(data: Dict[str, np.ndarray], mesh) -> ShardedCorpus:
    r"""Split a packed corpus over the mesh's ``data`` axis for
    device-resident mesh training: shard d's device holds rows
    ``[d·R, (d+1)·R)`` with ``R = ceil(N/D)`` (so the corpus memory scales
    with the mesh too), and a step gathers each shard's batch rows from its
    own block (:meth:`Sampler.iter_indices_sharded`). The rows pad up to a
    multiple of the axis by repeating row 0; pad rows are never drawn. A
    process uploads only its own shards. Pair with ``Sampler(device_data=
    <this>)`` under a mesh runner."""
    d = mesh.shape["data"]
    n = len(next(iter(data.values())))
    rows = -(-n // d)
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard + i) * rows
        block = {}
        for k, v in data.items():
            v = np.asarray(v)
            part = v[lo:lo + rows]
            if len(part) < rows:
                part = np.concatenate(
                    [part, np.repeat(v[:1], rows - len(part), 0)])
            block[k] = torch.as_tensor(np.ascontiguousarray(part),
                                       device=dev)
        shards.append(block)
    return ShardedCorpus(shards, rows, d)


class Sampler:
    r"""Epoch sampler over a packed dataset: shuffles sequence indices and
    yields raw [B, T, ...] numpy slices (``__iter__``) or the index stream
    (:meth:`iter_indices`). The permutations come from
    ``np.random.default_rng(seed)``, the JAX package's, so the two samplers
    yield the same batches.

    ``pad_remainder``: keep the partial tail batch (the reference's
    ``drop_last=False``), padded to ``batch_size`` by cycling the epoch's
    sequences, every batch carrying a ``"_weight"`` [B] (1 real / 0 pad)
    that the loss uses to reproduce the native-size mean.

    With ``device_data`` (a :func:`put_device` upload of the same packed
    dict) the training loops draw :meth:`iter_indices` and gather on the
    device; the host arrays here are never sliced into batches. A
    :func:`put_device_sharded` corpus goes with :meth:`iter_indices_sharded`
    under a mesh runner.
    """

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, drop_remainder: bool = True,
                 seed=0, pad_remainder: bool = False, device_data=None):
        # ``seed`` is anything np.random.default_rng accepts; the training
        # driver passes (base_seed, epoch_salt), a fresh order per epoch
        self.data = data
        self.device_data = device_data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_remainder = pad_remainder
        self.drop_remainder = drop_remainder and not pad_remainder
        self._rng = np.random.default_rng(seed)
        self.n = len(next(iter(data.values())))
        if device_data is not None and (
                set(device_data.keys()) != set(data)
                or (device_data.rows * device_data.n_data < self.n
                    if isinstance(device_data, ShardedCorpus) else
                    len(next(iter(device_data.values()))) != self.n)):
            raise ValueError("device_data must be put_device() or "
                             "put_device_sharded() of the same packed dict")
        if self.drop_remainder and self.n < batch_size:
            raise ValueError(
                f"batch_size {batch_size} exceeds the dataset's "
                f"{self.n} sequences — every epoch would be empty "
                f"(loss 0.0). Lower --batch_size, or pass "
                f"pad_remainder=True (the reference's drop_last=False "
                f"semantics).")

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def iter_indices(self) -> Iterator[Tuple[np.ndarray,
                                             Optional[np.ndarray]]]:
        r"""The epoch's batch index stream: ``(take [B] int, weight [B] f32
        | None)``, the permutation and padding ``__iter__`` slices by."""
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = (self.n - self.n % self.batch_size
                if self.drop_remainder else self.n)
        for s in range(0, stop, self.batch_size):
            take = idx[s:s + self.batch_size]
            if not self.pad_remainder:
                yield take, None
                continue
            n_real = len(take)
            if n_real < self.batch_size:
                take = np.concatenate(
                    [take, np.resize(idx, self.batch_size - n_real)])
            w = np.zeros(self.batch_size, np.float32)
            w[:n_real] = 1.0
            yield take, w

    def iter_indices_sharded(self, n_shards: int
                             ) -> Iterator[Tuple[np.ndarray,
                                                 Optional[np.ndarray]]]:
        r"""The per-shard epoch index stream of a :func:`put_device_sharded`
        corpus, the JAX package's bit for bit: each shard shuffles its own
        rows and gives B/D rows to every batch (the distributed-sampler
        pattern; not the batches of :meth:`iter_indices`). Yields
        ``(local_idx [D, B/D]`` — row d holds row numbers within shard d —
        ``, weight [D, B/D] | None)``; the batch is shard-major. With
        ``pad_remainder`` every real row appears once an epoch with weight
        1 and a short shard cycles its rows with weight 0; with
        ``drop_remainder`` the epoch stops at the shortest shard's last full
        contribution."""
        d = n_shards
        if self.batch_size % d:
            raise ValueError(f"batch_size={self.batch_size} must divide "
                             f"over {d} shards")
        if not (self.pad_remainder or self.drop_remainder):
            raise ValueError(
                "sharded sampling needs pad_remainder (weighted tail) or "
                "drop_remainder: a bare variable-size tail cannot shard")
        b = self.batch_size // d
        cap = -(-self.n // d)                  # shard row capacity
        real = [min(cap, max(0, self.n - s * cap)) for s in range(d)]
        perms = []
        for s in range(d):
            p = np.arange(real[s])
            if self.shuffle:
                self._rng.shuffle(p)
            perms.append(p)
        if self.drop_remainder:
            steps = min(r // b for r in real)
            if steps == 0:
                raise ValueError(
                    f"sharded epoch is empty: the shortest shard holds "
                    f"fewer than batch_size/{d}={b} rows (shard rows "
                    f"{real}); lower the batch size or use "
                    f"pad_remainder=True")
        else:
            steps = max(-(-r // b) for r in real)
        for t in range(steps):
            idx = np.zeros((d, b), np.int64)
            w = None if not self.pad_remainder else np.zeros((d, b),
                                                             np.float32)
            for s in range(d):
                sl = perms[s][t * b:(t + 1) * b]
                idx[s, :len(sl)] = sl
                if w is None:
                    continue       # drop_remainder: sl is always full
                if len(sl) < b:    # cycle this shard's rows, weight 0
                    idx[s, len(sl):] = (np.resize(perms[s], b - len(sl))
                                        if len(perms[s]) else 0)
                w[s, :len(sl)] = 1.0
            yield idx, w

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for take, w in self.iter_indices():
            out = {k: v[take] for k, v in self.data.items()}
            if w is not None:
                out["_weight"] = w
            yield out
