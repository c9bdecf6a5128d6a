r"""Dataset locations, the SMPL joint sets of the pipeline, the data
factory's constants and the trainer's hyperparameters (copies of
``a3gc_tpu/config.py`` ``Paths``, ``JointSet``, ``ACC_SCALE``, the mirror
permutations, ``MeshConfig`` and ``TrainConfig``; the port keeps its own so
it never imports the JAX package).

Unlike the JAX package, the port keeps no module-level ``Paths``: a factory
given ``paths=None`` builds ``Paths()`` when it is called, so the data root
is ``$A3GC_DATA_ROOT`` as it stands then."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass(frozen=True)
class Paths:
    """Dataset and asset locations, relative to ``data_root`` unless
    absolute. ``data_root`` defaults to ``$A3GC_DATA_ROOT``, else ``data``,
    read when the instance is made."""

    data_root: str = dataclasses.field(
        default_factory=lambda: _env("A3GC_DATA_ROOT", "data")
    )

    # raw datasets
    raw_dipimu_dir: str = "raw_datasets/DIP_IMU"
    raw_totalcapture_dir: str = "raw_datasets/TotalCapture/DIP_recalculate"
    raw_amass_dir: str = "raw_datasets/AMASS"

    # preprocessed (stage 1 of the data factory)
    dipimu_dir_pre: str = "preprocessed/dip-imu"
    dipimu_dir_pre_sym: str = "preprocessed/dip-imu_sym"
    totalcapture_dir_pre: str = "preprocessed/total_capture"
    amass_dir_pre: str = "preprocessed/amass"
    amass_dir_pre_sym: str = "preprocessed/amass_sym"

    # processed (stage 2: normalized, chunked, packed)
    dipimu_dir: str = "dip-imu"
    dipimu_dir_sym: str = "dip-imu_sym"
    totalcapture_dir: str = "total_capture"
    amass_dir: str = "amass"
    amass_dir_sym: str = "amass_sym"

    # SMPL body models (official pickles; not redistributable)
    male_smpl_file: str = dataclasses.field(
        default_factory=lambda: _env(
            "A3GC_SMPL_MALE", "models/basicModel_m_lbs_10_207_0_v1.1.0.pkl"
        )
    )
    female_smpl_file: str = dataclasses.field(
        default_factory=lambda: _env(
            "A3GC_SMPL_FEMALE", "models/basicModel_f_lbs_10_207_0_v1.1.0.pkl"
        )
    )

    # normalization statistics (npz; see data/stats.py)
    train_stats: str = "stats/all_train_stats.npz"
    train_stats_sym: str = "stats/all_sym_train_stats.npz"

    def resolve(self, rel: str) -> str:
        """Join a config-relative path onto the data root."""
        return rel if os.path.isabs(rel) else os.path.join(self.data_root, rel)


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
class MeshConfig:
    """Device-mesh layout (:func:`a3gc_tpu_torch.parallel.make_mesh`):
    ``data`` shards the batch or the serving slots over devices, ``model``
    the last axis of a stage's wide parameters over the devices of a model
    group (tensor parallelism, in training). The default, one device, is
    the single-device semantics."""

    data: int = 1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")

    @property
    def n_devices(self) -> int:
        return self.data * self.model


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the 3-stage trainer, with the JAX package's
    defaults."""

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
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


joint_set = JointSet()

# IMU acceleration normalizer of the packed sets
ACC_SCALE = 30.0

# contralateral mirroring permutations: SMPL joints, IMU orientations and
# accelerations (left <-> right)
SMPL_MIRROR: Sequence[int] = (
    0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18,
    21, 20, 23, 22,
)
ORI_MIRROR: Sequence[int] = (1, 0, 3, 2, 4, 5)
ACC_MIRROR: Sequence[int] = (1, 0, 3, 2, 4, 5)
