r"""Observability: JSONL event logs and the reference's text reports
(counterpart of ``a3gc_tpu/utils/logging.py``). The text report is kept
byte-compatible with the JAX package's: it is the artifact a user compares.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["JsonlLogger", "write_eval_report"]


class JsonlLogger:
    r"""Append-mode JSONL event logger (one object per line, wall-clock
    stamped)."""

    def __init__(self, path: Optional[str], echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, event: dict):
        event = dict(event, time=time.time())
        line = json.dumps(event, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, flush=True)


def write_eval_report(path: str, dataset: str, offline_time: float,
                      errors, metric_names) -> str:
    r"""Append a text report in the reference's format: the dataset, the
    offline time, then one ``name: mean (+/- std)`` line a metric."""
    if isinstance(errors, torch.Tensor):
        errors = errors.cpu()
    errors = np.asarray(errors)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write("Dataset: {}\n".format(dataset))
        f.write("offline time {}\n".format(offline_time))
        for i, name in enumerate(metric_names):
            f.write("%s: %.2f (+/- %.2f)\n" % (name, errors[i, 0],
                                               errors[i, 1]))
    return path
