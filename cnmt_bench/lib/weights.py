"""Weights made by the benchmark from ``--seed``, on the device.

Two draws from one ``torch.Generator`` on the card (uniform and normal,
each over every parameter that takes its law at once); each parameter is
a scaled slice of one of them.  The same seed gives the same tensors, so
the reference can make them again after the window rather than keep a
second copy beside the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# law -> (draw, scale, shift); "glorot" scales by its own fan
_LAWS = {
    "glorot": ("uniform", None, 0.0),
    "bias": ("normal", 0.02, 0.0),
    "ln_weight": ("normal", 0.05, 1.0),
    "ln_bias": ("normal", 0.05, 0.0),
    "embed": ("normal", None, 0.0),
}


def _scale(law: str, shape: tuple) -> float:
    if law == "glorot":            # U(-lim, lim), lim = sqrt(6 / (in + out))
        return math.sqrt(6.0 / (shape[-2] + shape[-1]))
    if law == "embed":             # N(0, 1 / width)
        return shape[-1] ** -0.5
    return _LAWS[law][1]


def make(spec: List[Tuple[str, tuple, str]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor for every (name, shape, law) of ``spec``."""
    sizes = {"uniform": 0, "normal": 0}
    for _, shape, law in spec:
        sizes[_LAWS[law][0]] += math.prod(shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    pools = {
        "uniform": torch.rand(sizes["uniform"], generator=gen,
                              device=device).mul_(2.0).sub_(1.0),
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
    }
    offsets = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, law in spec:
        draw, _, shift = _LAWS[law]
        n = math.prod(shape)
        flat = pools[draw][offsets[draw]:offsets[draw] + n]
        offsets[draw] += n
        out[name] = flat.view(shape).mul_(_scale(law, shape)).add_(shift)
    return out
