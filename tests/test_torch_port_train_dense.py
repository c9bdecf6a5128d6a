"""The port's trainers on the dense nets against the JAX package's, dropout
and noise off: the TransPose stages (``StageRunner(graph=False)``, the flat
wiring) and the DIP net (``DIPRunner``): one step's loss and gradients
(rtol 1e-5), three steps' parameters (2e-5), validation (1e-5)."""

import numpy as np
import pytest
import torch

from a3gc_tpu.data import pipeline as JDP
from a3gc_tpu_torch.data import pipeline as TDP

from test_torch_port_train import RTOL, check_one_step, check_three_steps
from test_torch_port_train import packed  # noqa: F401  (fixture)
from torch_port_oracle import train_runners

torch.set_num_threads(1)


@pytest.mark.parametrize("kind, stage", [
    ("tp", 1), ("tp", 2), ("tp", 3), ("dip", 1)])
def test_torch_port_dense_one_step_loss_and_grads_match_jax(kind, stage,
                                                            packed):
    check_one_step(kind, stage, packed)


@pytest.mark.parametrize("kind, stage, train_kw", [
    ("tp", 3, dict(weight_decay=1e-2, start_epoch=1)),
    ("dip", 1, dict(lr=2e-3)),
])
def test_torch_port_dense_three_steps_match_jax(kind, stage, train_kw,
                                                packed):
    check_three_steps(kind, stage, packed, **train_kw)


@pytest.mark.parametrize("kind, stage", [("tp", 2), ("dip", 1)])
def test_torch_port_dense_eval_epoch_matches_jax(kind, stage, packed):
    jr, tr = train_runners(kind, stage)

    def sampler(mod):
        return mod.Sampler(packed, 4, shuffle=False, pad_remainder=True)
    np.testing.assert_allclose(tr.eval_epoch(sampler(TDP)),
                               jr.eval_epoch(sampler(JDP)), rtol=RTOL)
