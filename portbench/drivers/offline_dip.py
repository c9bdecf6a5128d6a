r"""Driver ``offline_dip``: the per-sequence offline protocol of
``evaluate_dip.py`` (``DipEvaluator.evaluate``, which ``cli evaluate
--model dip`` runs), one sequence at a time, S = 1.

The timed path takes a sequence's raw IMU frames from host arrays to its
local pose on the host: upload, the evaluator's preparation
(``data/pipeline.dip_batch`` with the root sensor dropped: 60 normalized
features), ``models/pipeline.forward_offline`` (the net and IK) and the
copy back. Everything else, the window, the kept sequences and the
reference's answers, is :mod:`portbench.drivers.offline_seq`'s, with the
mix keys it reads.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.drivers import offline_seq


class Run(offline_seq.Run):
    def _infer(self, ori: np.ndarray, acc: np.ndarray) -> np.ndarray:
        from a3gc_tpu_torch.data import pipeline as DPipe
        from a3gc_tpu_torch.models.pipeline import forward_offline

        raw = {"ori": torch.as_tensor(ori, device=self.dev)[None],
               "acc": torch.as_tensor(acc, device=self.dev)[None],
               "pose": None}
        imu, _ = DPipe.dip_batch(raw, self.stats, no_root=True)
        return forward_offline(self.params3, self.port_cfg, self.model,
                               imu).cpu().numpy()
