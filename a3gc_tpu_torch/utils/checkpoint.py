r"""Checkpoint save, restore and discovery with the reference's naming
(counterpart of ``a3gc_tpu/utils/checkpoint.py``).

The reference saves ``checkpoint_model{stage}_{pretrain|finetuning}_{epoch}
.tar`` and resumes by the max epoch per stage, preferring 'pretrain' when
both phases exist. The JAX package keeps those names for orbax
directories; the port keeps them for directories of its own format: one
file, ``params.pt``, holding ``torch.save({"epoch": e, "state_dict":
module.state_dict()})`` on the CPU, restored into a template module of
the same config with ``load_state_dict(strict=True)``. The round trip is
exact and needs no JAX.

An orbax checkpoint of the JAX package (the same directory name, no
``params.pt`` inside) cannot be read without JAX: :func:`restore_params`
raises and names the conversion, ``python -m a3gc_tpu.cli
convert-checkpoint --to_torch <dir>`` to a reference ``.tar``, which the
port loads (``cli serve --torch_checkpoints``).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["PARAMS_FILE", "save_params", "write_params", "restore_params",
           "discover_latest", "check_shapes"]

PARAMS_FILE = "params.pt"
_NAME = "checkpoint_model{stage}_{phase}_{epoch}"
_RE = re.compile(r"checkpoint_model(\d+)_(pretrain|finetuning)_(\d+)$")


def check_shapes(got: Mapping, want: Mapping, what: str):
    r"""Raise ``ValueError`` for the first key of ``want`` whose tensor in
    ``got`` has another shape (or is missing), naming the key and both
    shapes: a checkpoint of another width is refused before any tensor is
    copied."""
    for key, w in want.items():
        if key not in got:
            raise ValueError(f"{what}: the checkpoint has no {key!r} "
                             f"(expected shape {tuple(np.shape(w))})")
        g, w = tuple(np.shape(got[key])), tuple(np.shape(w))
        if g != w:
            raise ValueError(f"{what}: {key!r} has shape {g} in the "
                             f"checkpoint, the config expects {w}")


def write_params(path: str, params: nn.Module, epoch: int = 0) -> str:
    r"""Write ``params`` as a checkpoint directory ``path`` of the port's
    format (created if absent; the file is replaced atomically)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, PARAMS_FILE)
    tmp = target + ".tmp"
    sd = {k: v.detach().cpu() for k, v in params.state_dict().items()}
    torch.save({"epoch": int(epoch), "state_dict": sd}, tmp)
    os.replace(tmp, target)
    return path


def save_params(params: nn.Module, directory: str, stage: int, epoch: int,
                finetuning: bool = False) -> str:
    r"""Save a net under the reference naming scheme; returns the
    checkpoint's directory."""
    phase = "finetuning" if finetuning else "pretrain"
    path = os.path.join(os.path.abspath(directory),
                        _NAME.format(stage=stage, phase=phase, epoch=epoch))
    return write_params(path, params, epoch)


def discover_latest(directory: str, stage: int,
                    phase: Optional[str] = None,
                    epoch: Optional[int] = None) -> Optional[Tuple[str, int]]:
    r"""The checkpoint to resume for a stage: the max epoch; when both
    phases exist and none is asked for, 'pretrain' wins; an explicit
    ``epoch`` pins it (the eval scripts' ``--mid{1,2,3}``). Returns
    ``(path, epoch)`` or None."""
    entries = []
    for p in glob.glob(os.path.join(directory, "checkpoint_model*")):
        m = _RE.search(os.path.basename(p.rstrip("/")))
        if m and int(m.group(1)) == stage:
            entries.append((p, m.group(2), int(m.group(3))))
    if not entries:
        return None
    if phase is None:
        phases = {e[1] for e in entries}
        phase = "pretrain" if "pretrain" in phases else "finetuning"
    entries = [e for e in entries if e[1] == phase]
    if epoch is not None:
        entries = [e for e in entries if e[2] == epoch]
    if not entries:
        return None
    path, _, ep = max(entries, key=lambda e: e[2])
    return path, ep


def restore_params(path: str, template: nn.Module) -> nn.Module:
    r"""Load checkpoint directory ``path`` into ``template`` (a module of
    the same config, on the device the tensors should land on) and return
    it. A tensor of another shape raises ``ValueError`` naming the key and
    both shapes; a JAX orbax directory raises naming the conversion."""
    target = os.path.join(path, PARAMS_FILE)
    if not os.path.isfile(target):
        if os.path.isdir(path):
            raise ValueError(
                f"{path} holds no {PARAMS_FILE}: it is not a checkpoint of "
                "a3gc_tpu_torch (an orbax checkpoint of the JAX package "
                "cannot be read without JAX). Convert it with `python -m "
                f"a3gc_tpu.cli convert-checkpoint --to_torch {path} --model "
                "<model> --n_input <in> --n_output <out> --hu1 <hidden> "
                "--output x.tar`, then load x.tar (`cli serve "
                "--torch_checkpoints x.tar`, or `python -m a3gc_tpu_torch.cli "
                "convert-checkpoint --torch x.tar` for a directory)")
        raise FileNotFoundError(f"no checkpoint at {path}")
    sd = torch.load(target, map_location="cpu",
                    weights_only=True)["state_dict"]
    check_shapes(sd, template.state_dict(), target)
    template.load_state_dict(sd, strict=True)
    return template
