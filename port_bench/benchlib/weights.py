"""Seeded weights for a U-Net of the reference's layout, made on the device
in a few large calls.

Every convolution and dense kernel is drawn from a normal truncated at two
standard deviations with variance 1 / fan_in (lecun_normal, flax's default
and the JAX package's), biases are 0, norms' scales 1. All kernels come from
one draw of one flat buffer, scaled leaf by leaf. The state dict that comes
back is keyed like diffusers' and the program's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from . import traffic

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for the parameters of `model` (on any device, meta included)."""
    kernels, rest = [], []
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, (nn.Conv2d, nn.Linear)) and p_name == "weight":
                kernels.append((key, tuple(p.shape)))
            else:
                rest.append((key, tuple(p.shape), isinstance(mod, (nn.GroupNorm, nn.LayerNorm))
                             and p_name == "weight"))
    total = sum(math.prod(s) for _, s in kernels)
    flat = torch.empty(total, device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                          generator=traffic.generator(device, seed, traffic.WEIGHTS))
    out, offset = {}, 0
    for key, shape in kernels:
        n = math.prod(shape)
        fan_in = n // shape[0]
        out[key] = flat[offset:offset + n].view(shape).mul_(
            math.sqrt(1.0 / fan_in) / TRUNC_STD)
        offset += n
    for key, shape, is_scale in rest:
        out[key] = (torch.ones if is_scale else torch.zeros)(shape, device=device)
    return out
