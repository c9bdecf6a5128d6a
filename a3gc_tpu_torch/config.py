r"""The SMPL joint sets of the pipeline and the trainer's hyperparameters
(copies of ``a3gc_tpu/config.py`` ``JointSet`` and ``TrainConfig``; the
port keeps its own so it never imports the JAX package)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class JointSet:
    """SMPL joint subsets used throughout the pipeline."""

    leaf: Tuple[int, ...] = (7, 8, 12, 20, 21)
    full: Tuple[int, ...] = tuple(range(1, 24))
    reduced: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19)
    ignored: Tuple[int, ...] = (0, 7, 8, 10, 11, 20, 21, 22, 23)

    lower_body: Tuple[int, ...] = (0, 1, 2, 4, 5, 7, 8, 10, 11)
    lower_body_parent: Tuple[Optional[int], ...] = (None, 0, 0, 1, 2, 3, 4, 5, 6)

    sensor: Tuple[int, ...] = (18, 19, 4, 5, 15, 0, 1, 2, 9)
    dip_imu: Tuple[int, ...] = (7, 8, 11, 12, 0, 2, 9, 10, 1)
    vertex_ids: Tuple[int, ...] = (1962, 5431, 1096, 4583, 412, 3021, 949, 4434, 3506)
    smpl_sensor: Tuple[str, ...] = (
        "L_Elbow", "R_Elbow", "L_Knee", "R_Knee", "Head", "Pelvis"
    )

    # graph wiring of the 15-node reduced skeleton
    input_joints: Tuple[int, ...] = (3, 4, 13, 14, 10)
    leaf_nodes: Tuple[int, ...] = (4, 5, 15, 18, 19)
    leaf_nodes_reduced: Tuple[int, ...] = (3, 4, 10, 13, 14)

    # SIP error mask: hips + shoulders
    sip_joints: Tuple[int, ...] = (1, 2, 16, 17)

    @property
    def n_leaf(self) -> int:
        return len(self.leaf)

    @property
    def n_full(self) -> int:
        return len(self.full)

    @property
    def n_reduced(self) -> int:
        return len(self.reduced)

    @property
    def n_ignored(self) -> int:
        return len(self.ignored)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the 3-stage trainer, with the JAX package's
    defaults. The JAX config's ``mesh`` field waits for the port's
    multi-card training (ROADMAP Queue 1 item 14)."""

    batch_size: int = 32
    lr: float = 1e-3
    lr_decay: float = 0.8        # ExponentialLR gamma, stepped per epoch
    weight_decay: float = 0.0    # L2 folded into the gradient (torch Adam)
    max_epochs: int = 500
    patience: int = 3            # early-stopping tolerance on val loss
    hidden_units: Tuple[int, int, int] = (256, 64, 128)   # per cascade stage
    seq_len: int = 300           # training chunk length
    leaf_noise_std: float = 0.04   # teacher-forcing noise on leaf positions
    full_noise_std: float = 0.025  # and on all positions
    normalize: bool = False
    cda: bool = False            # contralateral data augmentation (sym data)
    finetuning: bool = False
    start_stage: int = 1
    start_epoch: int = 0
    seed: int = 0
    dtype: str = "float32"       # compute dtype ("float32" or "bfloat16")
    accum_steps: int = 1         # microbatches per optimizer step (the
                                 # peak activation memory of one)
    steps_per_dispatch: int = 1  # parsed for the JAX CLI's command lines;
                                 # the port runs its steps one by one (the
                                 # same parameter trajectory)
    keep_checkpoints: int = 0    # keep only the newest N improvement
                                 # checkpoints this run writes (0 = all)
    min_save_delta: float = 0.0  # write an improvement checkpoint only when
                                 # the valid loss beats the last saved one by
                                 # more than this (early stopping unchanged)
    eval_batch_size: int = 0     # validation chunk; 0 = min(batch_size, 128)


joint_set = JointSet()
