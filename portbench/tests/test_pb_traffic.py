r"""The traffic: the same for a seed, different across seeds, and the same
set of sizes for every seed."""

import itertools

import numpy as np

from portbench import traffic
from portbench.tests import tiny

STATS = tiny.harness.Cell(tiny.bench(), "a3gc_tp.offline_seq").stats()
POOL = {"sequences": 3, "frames": 300}
SEED = 2 ** 31 + 99


def test_pb_pool_is_the_seeds():
    a = traffic.imu_pool(SEED, POOL, STATS)
    b = traffic.imu_pool(SEED, POOL, STATS)
    c = traffic.imu_pool(SEED + 1, POOL, STATS)
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x, y) and not np.array_equal(x, z)
        assert x.dtype == np.float32 and np.isfinite(x).all()
    ori = a[0].reshape(3, 300, 6, 3, 3).astype(np.float64)
    eye = np.einsum("...ji,...jk->...ik", ori, ori)
    assert np.abs(eye - np.eye(3)).max() < 1e-5      # rotation matrices
    assert np.abs(np.diff(ori, axis=1)).max() < 0.2  # smooth at 60 Hz


def test_pb_requests_are_the_seeds_and_every_seed_gets_the_same_sizes():
    lengths = traffic.stratified(240, 2400, 16)
    assert lengths[0] == 240 and lengths[-1] == 2400
    assert np.all(np.diff(lengths) == 144)
    pool = {"sequences": 16, "frames": 4800}
    def take(seed, salt):
        return list(itertools.islice(
            traffic.sequences(seed, salt, lengths, pool), 64))

    a, b, c, d = take(SEED, 0), take(SEED, 0), take(SEED + 1, 0), take(SEED, 1)
    assert a == b and a != c and a != d
    for reqs in (a, c, d):
        for cycle in range(4):
            got = sorted(n for _, _, n in reqs[16 * cycle:16 * cycle + 16])
            assert got == sorted(lengths.tolist())
        assert all(0 <= off and off + n <= 4800 for _, off, n in reqs)


def test_pb_drawn_positions():
    a = traffic.drawn_positions(SEED, 0, 48, 6)
    assert a == traffic.drawn_positions(SEED, 0, 48, 6)
    assert len(a) == 6 and all(0 <= i < 48 for i in a)
    assert a != traffic.drawn_positions(SEED + 1, 0, 48, 6)
