r"""The inputs of every cell, drawn from the run's seed (numpy only: the
client processes of the serving driver import this module without torch).

Sizes are stratified: a mix names a range and a count, the range is cut into
that many evenly spaced values, and each seed plays the same set of values
in its own order, one fresh permutation per cycle. So every seed asks for the
same work, and the seed changes only its order and the IMU frames.

IMU frames come from a pool made at set-up: per sequence and sensor, an
axis-angle that drifts as a sum of slow sinusoids (turned into a rotation
matrix by Rodrigues' formula), and accelerations that are slow sinusoids
about the training stats' channel means, scaled by their standard
deviations. A request takes a slice of a pool sequence at a drawn offset.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

FPS = 60.0
_MASK64 = (1 << 64) - 1


def rng(seed: int, *salt: int) -> np.random.Generator:
    r"""The generator of one stream of draws of a run: ``seed`` (any whole
    number) and the stream's ``salt``."""
    return np.random.default_rng([seed & _MASK64, *salt])


def stratified(lo: int, hi: int, count: int) -> np.ndarray:
    r"""``count`` evenly spaced whole numbers from ``lo`` to ``hi``."""
    return np.rint(np.linspace(lo, hi, count)).astype(np.int64)


def cycled(gen: np.random.Generator, values: np.ndarray) -> Iterator[int]:
    r"""``values`` in a fresh random order each cycle, forever."""
    while True:
        yield from (int(v) for v in gen.permutation(values))


def _rodrigues(aa: np.ndarray) -> np.ndarray:
    r"""Axis-angle [..., 3] → rotation matrices [..., 9]."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    k = aa / np.maximum(theta, 1e-12)
    x, y, z = np.moveaxis(k, -1, 0)
    zero = np.zeros_like(x)
    kx = np.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    kk = np.einsum("...i,...j->...ij", k, k).reshape(k.shape[:-1] + (9,))
    eye = np.eye(3).reshape(9)
    s, c = np.sin(theta), np.cos(theta)
    return c * eye + s * kx + (1.0 - c) * kk


def _slow_waves(gen, shape, frames: int, waves: int = 2) -> np.ndarray:
    r"""[n, frames, *shape[1:]]: per channel a sum of ``waves`` sinusoids of
    0.2-1.5 Hz with random phases and unit total amplitude."""
    n = shape[0]
    t = np.arange(frames) / FPS
    out = np.zeros((n, frames) + tuple(shape[1:]))
    for _ in range(waves):
        f = gen.uniform(0.2, 1.5, size=(n, 1) + tuple(shape[1:]))
        ph = gen.uniform(0, 2 * np.pi, size=(n, 1) + tuple(shape[1:]))
        tt = t.reshape((1, frames) + (1,) * (len(shape) - 1))
        out += np.sin(2 * np.pi * f * tt + ph) / waves
    return out


def imu_pool(seed: int, spec: Dict, stats: Dict[str, np.ndarray]
             ) -> Tuple[np.ndarray, np.ndarray]:
    r"""The pool of a run: (ori [P, F, 54], acc [P, F, 18]) float32, P =
    ``spec["sequences"]``, F = ``spec["frames"]``."""
    gen = rng(seed, 1)
    P, F = int(spec["sequences"]), int(spec["frames"])
    base = gen.normal(scale=0.6, size=(P, 1, 6, 3))
    aa = base + 0.5 * _slow_waves(gen, (P, 6, 3), F)
    ori = _rodrigues(aa).reshape(P, F, 54)
    acc = (stats["acc_mean_channel"]
           + stats["acc_std_channel"] * (_slow_waves(gen, (P, 18), F)
                                         + gen.normal(scale=0.1,
                                                      size=(P, F, 18))))
    return ori.astype(np.float32), acc.astype(np.float32)


def sequences(seed: int, salt: int, lengths: np.ndarray, pool_spec: Dict
              ) -> Iterator[Tuple[int, int, int]]:
    r"""The requests of one stream (a driver, or one client), forever:
    ``(pool index, offset, length)``, the lengths cycled from ``lengths``,
    pool index and offset uniform."""
    gen = rng(seed, 2, salt)
    P, F = int(pool_spec["sequences"]), int(pool_spec["frames"])
    for length in cycled(gen, lengths):
        if length > F:
            raise ValueError(f"a request of {length} frames does not fit a "
                             f"pool sequence of {F}")
        yield (int(gen.integers(P)), int(gen.integers(F - length + 1)),
               length)


def drawn_positions(seed: int, salt: int, among: int, count: int) -> set:
    r"""``count`` request positions of a stream drawn without replacement
    from the first ``among``: the requests whose answers are kept for the
    comparison with the reference."""
    gen = rng(seed, 3, salt)
    return {int(i) for i in gen.choice(among, size=min(count, among),
                                       replace=False)}
