r"""Weights drawn from the run's seed on the device, in a few large calls.

A family module gives the leaves of a configuration as ``(name, shape,
bound)``; every leaf is U(-bound, bound). One ``torch.rand`` on the device
fills a flat buffer for all leaves, one product scales it leaf by leaf, and
each leaf is a view of it, its offset a multiple of 64 floats (the scan
kernels want 16-byte aligned operands). The same seed gives the same
tensors, so the reference draws them again after the program has run and
takes nothing the program held.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

_ALIGN = 64         # floats


def draw(spec: List[Tuple[str, tuple, float]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    r"""``{name: tensor}`` fp32 on ``device``, from ``seed``."""
    sizes, offsets, total = [], [], 0
    for _, shape, _ in spec:
        n = 1
        for d in shape:
            n *= int(d)
        offsets.append(total)
        sizes.append(n)
        total += -(-n // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device)
    padded = torch.tensor([-(-n // _ALIGN) * _ALIGN for n in sizes],
                          device=device)
    bounds = torch.tensor([float(b) for _, _, b in spec], device=device)
    flat.mul_(2.0).sub_(1.0).mul_(torch.repeat_interleave(bounds, padded))
    return {name: flat[o:o + n].view(shape)
            for (name, shape, _), o, n in zip(spec, offsets, sizes)}
