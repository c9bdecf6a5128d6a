"""The port's driver entry points (a3gc_tpu_torch.graft_entry) against the
JAX package's ``__graft_entry__``: ``entry()``'s full-width flagship
forward on JAX's parameters and the same IMU, the TransPose flagship at
narrow width, the synthetic body model; ``dryrun_multichip`` on meshes of
CPU devices, its refusal without devices, and the module's command line.

Tolerance 1e-5 absolute on the poses: fp32 on both sides (the CPU runs
"default" at fp32), sums reordered over 300 frames of six recurrent layers
and IK."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as JGE
from a3gc_tpu_torch import graft_entry as GE
from a3gc_tpu_torch.compat.from_jax import cascade_params_from_jax

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_torch_port_entry_matches_jax_entry():
    """The full-width forward (A3GC 256 / 64 / 128, T = 300) on JAX
    ``entry()``'s parameters and a seeded IMU."""
    jfn, (jparams3, jimu) = JGE.entry()
    imu = np.random.default_rng(0).normal(
        scale=0.5, size=jimu.shape).astype(np.float32)
    want = np.asarray(jfn(jparams3, imu))
    fn, (params3, timu) = GE.entry(device="cpu")
    assert timu.shape == jimu.shape and timu.device.type == "cpu"
    got = fn(cascade_params_from_jax(_numpy(jparams3), device="cpu"),
             torch.from_numpy(imu))
    assert got.shape == (300, 24, 3, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # the port's own weights (torch.Generator bits) give finite poses too
    assert torch.isfinite(fn(params3, timu)).all()


def test_torch_port_tp_flagship_matches_jax():
    """``_flagship("tp")``: the TransPose cascade of dense biLSTMs."""
    jcfg, jparams3, jbody, jimu = JGE._flagship(hidden=(16, 16, 16),
                                                seq_len=32, model_name="tp")
    from a3gc_tpu.models.pipeline import cascade_apply as jax_cascade_apply
    from a3gc_tpu_torch.models.pipeline import cascade_apply
    imu = np.random.default_rng(1).normal(
        scale=0.5, size=jimu.shape).astype(np.float32)
    want = np.asarray(jax_cascade_apply(jparams3, jcfg, jbody, imu))
    cfg, _, body, timu = GE._flagship(hidden=(16, 16, 16), seq_len=32,
                                      model_name="tp", device="cpu")
    assert timu.shape == (1, 32, 72)
    got = cascade_apply(cascade_params_from_jax(_numpy(jparams3), "cpu"), cfg,
                        body, imu, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_torch_port_graft_body_model_equals_jax():
    jm = JGE._body_model()
    tm = GE._body_model(device="cpu")
    assert tm.parent == tuple(jm.parent)
    for name in ("j_regressor", "skinning_weights", "posedirs", "shapedirs",
                 "v_template", "joints_template"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(tm.faces, np.asarray(jm.faces))


@pytest.mark.parametrize("n", [8, 5])
def test_torch_port_dryrun_multichip_on_cpu_devices(n):
    """An even n runs data × model = n/2 × 2 (the TP kernels split), an odd
    n data × 1."""
    GE.dryrun_multichip(n, devices=["cpu"] * n)


def test_torch_port_dryrun_multichip_needs_devices():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    with pytest.raises(RuntimeError, match="devices="):
        GE.dryrun_multichip(2)


def test_torch_port_graft_entry_command_line():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "a3gc_tpu_torch.graft_entry", "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines == ["compile check: True", "dryrun_multichip ok"]
