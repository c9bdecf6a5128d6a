"""Synthetic raw corpora of the data factory in their on-disk layouts
(AMASS, DIP-IMU, DIP-recalculated TotalCapture) and the factory's
tolerances, for the port's tests: numpy, scipy and pickle only, so the card
tests (run without jax) use them too."""

import os

import numpy as np


def write_raw_amass(root, specs, seed=0):
    """AMASS npz files under ``root`` (the raw AMASS directory):
    ``<ds>/<ds>/<subject>/<name>_poses.npz`` holding poses [T, 156]
    (SMPLH axis-angle), trans [T, 3], betas [16] and mocap_framerate, one a
    spec ``(ds, subject, name, T, framerate)``; framerate None writes a file
    that does not load. The motion is smooth, as mocap is: each angle a
    sinusoid of 0.3-1.5 Hz about a random pose, so the synthesized
    accelerations are of a body's size."""
    rng = np.random.default_rng(seed)
    for i, (ds, subject, name, T, fps) in enumerate(specs):
        d = os.path.join(root, ds, ds, subject)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{name}_poses.npz")
        if fps is None:
            with open(path, "wb") as f:
                f.write(b"not an npz")
            continue
        base = rng.normal(scale=0.3, size=156)
        freq = rng.uniform(0.3, 1.5, size=156)
        phase = rng.uniform(0, 2 * np.pi, size=156)
        t = np.arange(T)[:, None] / float(fps)
        poses = base + 0.3 * np.sin(2 * np.pi * freq * t + phase)
        np.savez(path, poses=poses,
                 trans=np.cumsum(rng.normal(scale=0.01, size=(T, 3)), 0),
                 betas=rng.normal(scale=0.5, size=16),
                 mocap_framerate=np.array(float(fps)))


def write_raw_dip(root, specs, seed=0):
    """DIP-IMU pickles under ``root`` (the raw DIP_IMU directory):
    ``<subject>/<motion>.pkl`` holding imu_acc [T, 17, 3], imu_ori
    [T, 17, 3, 3] and gt [T, 72] (axis-angle), one a spec ``(subject,
    motion, T, nans)``: nans "burst" puts NaN bursts into the sensors that
    the fill repairs, "dead" one sensor NaN throughout (the sequence is
    discarded), None none."""
    import pickle
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    for i, (subject, motion, T, nans) in enumerate(specs):
        d = os.path.join(root, subject)
        os.makedirs(d, exist_ok=True)
        acc = rng.normal(size=(T, 17, 3))
        ori = Rotation.random(T * 17, random_state=seed + i).as_matrix(
        ).reshape(T, 17, 3, 3)
        if nans == "burst":
            acc[10:13, 7] = np.nan
            ori[T // 2:T // 2 + 2, 11] = np.nan
            acc[-9:-7, 2] = np.nan
        elif nans == "dead":
            acc[:, 12] = np.nan
        gt = Rotation.random(T * 24, random_state=seed + 50 + i).as_rotvec()
        with open(os.path.join(d, f"{motion}.pkl"), "wb") as f:
            pickle.dump({"imu_acc": acc, "imu_ori": ori,
                         "gt": (gt * 0.3).reshape(T, 72)}, f)


def write_raw_totalcapture(root, specs, seed=0):
    """DIP-recalculated TotalCapture pickles under ``root``: ``<name>.pkl``
    holding ori [T_imu, 6, 3, 3], acc [T_imu, 6, 3] and gt [T, 72], one a
    spec ``(name, T, T_imu)``."""
    import pickle
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i, (name, T, T_imu) in enumerate(specs):
        ori = Rotation.random(T_imu * 6, random_state=seed + i).as_matrix()
        gt = Rotation.random(T * 24, random_state=seed + 70 + i).as_rotvec()
        with open(os.path.join(root, f"{name}.pkl"), "wb") as f:
            pickle.dump({"ori": ori.reshape(T_imu, 6, 3, 3),
                         "acc": rng.normal(size=(T_imu, 6, 3)),
                         "gt": (gt * 0.3).reshape(T, 72)}, f)


# the factory's tolerances: rotations, positions and poses; normalized
# accelerations (the finite difference scales the positions' rounding by up
# to 3600 / 30); the synthesized accelerations before the normalization's
# division by ACC_SCALE = 30, in m/s^2
FACTORY_TOL = {"acc": 1e-4, "vacc": 30 * 1e-4}
ROT_POS_TOL = 1e-5


def assert_factory_close(got, want, what=""):
    """Every field of two factory outputs (lists of dicts): equal keys and
    shapes, values within ``FACTORY_TOL`` (else ``ROT_POS_TOL``)."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (what, i)
        for k in w:
            assert np.shape(g[k]) == np.shape(w[k]), (what, i, k)
            np.testing.assert_allclose(
                np.asarray(g[k]), np.asarray(w[k]), rtol=0,
                atol=FACTORY_TOL.get(k, ROT_POS_TOL),
                err_msg=f"{what} item {i} field {k}")
