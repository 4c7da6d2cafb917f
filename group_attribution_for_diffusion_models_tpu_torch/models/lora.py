"""LoRA targets of the U-Net, as far as TRAK's features read them.

Port of the parts of the JAX package's ``models/lora.py`` that the TRAK
slice needs: the target names, the probe sketch (`probe_sketch_init`) and
the attention-projection restriction (`attention_params_filter`). Where the
JAX package keeps a LoRA tree keyed by parameter paths, the port keys it by
the name of the ``LoRADense`` module (``...attentions.0.to_q``, and
``...to_out.0`` for the output projection, which the diffusers layout keeps
in a ModuleList); ``torch.func.functional_call`` attaches it as the modules'
``lora_down``/``lora_up`` buffers. `lora_init`, `lora_merge`, rank pruning
and the safetensors I/O come with the text-to-image slice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import LoRADense

DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out")


def target_modules(
    model: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS
) -> List[Tuple[str, LoRADense]]:
    """(name, module) of each LoRADense whose own name is a target, in module
    order. A ModuleList index is seen through: ``to_out.0`` is ``to_out``."""
    found = []
    for name, module in model.named_modules():
        if not isinstance(module, LoRADense):
            continue
        parts = [p for p in name.split(".") if not p.isdigit()]
        if parts and parts[-1] in targets:
            found.append((name, module))
    return found


def probe_sketch_init(
    model: nn.Module,
    k: int = 64,
    generator: Optional[torch.Generator] = None,
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """A LoRA-shaped tree for gradient sketching, not adaptation:
    {module name: {"down": (in, k') Rademacher / sqrt(k'), "up": (k', out)
    zeros}}, k' = min(k, in), on the module's device.

    `up` = 0 leaves the forward unchanged. The gradient of a loss with
    respect to `up` alone is (x @ down)^T dL/dy = down^T grad_kernel, with
    grad_kernel = dL/dW^T (the JAX kernel's (in, out) layout): a k'-row
    sketch of each projection's per-sample gradient that autograd forms
    without the (in, out) per-sample gradient ever existing."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, module in target_modules(model, targets):
        d_in, d_out = module.in_features, module.out_features
        kk = min(k, d_in)
        signs = torch.randint(0, 2, (d_in, kk), generator=generator).float() * 2 - 1
        device = module.weight.device
        tree[name] = {"down": (signs / math.sqrt(kk)).to(device),
                      "up": torch.zeros((kk, d_out), device=device)}
    return tree


def attention_params_filter(
    model: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS
) -> Optional[List[str]]:
    """Names of the attention projections' parameters (weights and biases),
    in `named_parameters` order: the exact per-sample gradients over what the
    probe sketch sees. None when the model has no attention projection."""
    prefixes = {name for name, _ in target_modules(model, targets)}
    names = [n for n, _ in model.named_parameters() if n.rsplit(".", 1)[0] in prefixes]
    return names or None
