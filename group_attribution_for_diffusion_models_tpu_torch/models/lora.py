"""LoRA on the U-Net's attention projections, with a rank per projection.

Port of the JAX package's ``models/lora.py``. There LoRA is a pytree
{layer path: {down: (in, r), up: (r, out)}}; here the tree is keyed by the
name of the ``LoRADense`` module (``...attentions.0.transformer_blocks.0.
attn1.to_q``, and ``...to_out.0`` for the output projection, which the
diffusers layout keeps in a ModuleList), and `lora_collection` turns it
into the ``lora_down``/``lora_up`` buffers that ``torch.func.
functional_call`` attaches: the side branch y += (x @ down) @ up, no merged
copy of the base. `lora_merge` folds a tree into a state dict instead
(W_eff = W + scale * (down @ up)^T), as sampling from one LoRA does.
Ranks are leaf shapes, so rank pruning (`prune_lora`, numpy, bit for bit
the JAX function) gives heterogeneous ranks for free. `stack_lora_trees`
puts M members' trees of one shape on a leading member axis, the stacked
side branch `unet2d.members_forward` runs over one frozen base. A tree is saved as
the JAX CLI's ``lora_weights.npz`` (``<JAX path>::down`` / ``::up``), so one
file serves both packages (`save_lora_npz`, `load_lora_npz`).

Also the TRAK slice's pieces: the probe sketch (`probe_sketch_init`) and
the attention-projection restriction (`attention_params_filter`).
`lora_plus_optimizer` and the safetensors I/O are not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .layers import LoRADense

DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out")
LoraTree = Dict[str, Dict[str, torch.Tensor]]


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


def lora_init(
    model: nn.Module,
    rank: int = 256,
    generator: Optional[torch.Generator] = None,
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> LoraTree:
    """Zero-output init of every target projection: down ~ N(0, 1) / r, up = 0,
    r = min(rank, in, out), drawn in module order from `generator` (on its
    device) and placed on the module's device, f32."""
    device = generator.device if generator is not None else torch.device("cpu")
    tree: LoraTree = {}
    for name, module in target_modules(model, targets):
        d_in, d_out = module.in_features, module.out_features
        r = min(rank, d_in, d_out)
        down = torch.randn((d_in, r), generator=generator, device=device) / r
        where = module.weight.device
        tree[name] = {"down": down.to(where), "up": torch.zeros((r, d_out), device=where)}
    return tree


def lora_collection(lora_tree: Mapping) -> Dict[str, torch.Tensor]:
    """The buffers `functional_call(model, lora_collection(tree), args)`
    attaches: each LoRADense's ``lora_down`` and ``lora_up``. The forward
    then runs the side branch, numerically the merge without materialising
    a merged copy of the base."""
    out = {}
    for name, ab in lora_tree.items():
        out[f"{name}.lora_down"] = ab["down"]
        out[f"{name}.lora_up"] = ab["up"]
    return out


def stack_lora_trees(trees: Sequence[Mapping]) -> LoraTree:
    """Member trees of one shape stacked on a leading member axis (copies)."""
    return {name: {k: torch.stack([t[name][k].detach() for t in trees]) for k in ("down", "up")}
            for name in trees[0]}


def unstack_lora_tree(tree: Mapping, member: int) -> LoraTree:
    """Member `member`'s tree of a stacked one (copies)."""
    return {name: {k: v[member].detach().clone() for k, v in ab.items()}
            for name, ab in tree.items()}


def lora_merge(state_dict: Mapping[str, torch.Tensor], lora_tree: Mapping,
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """A new state dict with W + scale * (down @ up)^T on each targeted
    weight, the delta cast to the weight's dtype first (a bf16 base stays
    bf16)."""
    new = dict(state_dict)
    for name, ab in lora_tree.items():
        w = state_dict[f"{name}.weight"]
        delta = (ab["down"] @ ab["up"]).T.to(device=w.device, dtype=w.dtype)
        new[f"{name}.weight"] = w + scale * delta
    return new


def lora_ranks(lora_tree: Mapping) -> Dict[str, int]:
    return {name: int(ab["down"].shape[1]) for name, ab in lora_tree.items()}


def lora_num_params(lora_tree: Mapping) -> int:
    return int(sum(int(np.prod(ab["down"].shape)) + int(np.prod(ab["up"].shape))
                   for ab in lora_tree.values()))


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def rank_pair_importance(lora_tree: Mapping) -> Dict[str, np.ndarray]:
    """Magnitude importance of each rank-1 (down-col, up-row) pair:
    |down[:, r]| * |up[r, :]|, the score `prune_lora` removes by (reference
    text_to_image/prune_lora.py:122-141)."""
    return {name: np.linalg.norm(_np(ab["down"]), axis=0) * np.linalg.norm(_np(ab["up"]), axis=1)
            for name, ab in lora_tree.items()}


def prune_lora(lora_tree: Mapping, pruning_ratio: float, min_rank: int = 1) -> LoraTree:
    """Globally remove the lowest-importance rank pairs until only
    (1 - ratio) of the LoRA parameters remain, each projection keeping at
    least `min_rank` (reference prune_lora.py:143-180); in numpy, the JAX
    function's order and ties. Leaves come back as CPU tensors."""
    if not 0.0 <= pruning_ratio < 1.0:
        raise ValueError(f"pruning_ratio must be in [0, 1), got {pruning_ratio}")
    imp = rank_pair_importance(lora_tree)
    pool = []  # (score, layer, rank index, params freed by removing the pair)
    for name, scores in imp.items():
        cost = lora_tree[name]["down"].shape[0] + lora_tree[name]["up"].shape[1]
        for r_idx, s in enumerate(scores):
            pool.append((float(s), name, r_idx, cost))
    pool.sort(key=lambda t: t[0])

    total = lora_num_params(lora_tree)
    target = total * (1.0 - pruning_ratio)
    remaining = total
    ranks_left = {name: len(s) for name, s in imp.items()}
    drop: Dict[str, set] = {name: set() for name in imp}
    for _, name, r_idx, cost in pool:
        if remaining <= target:
            break
        if ranks_left[name] <= min_rank:
            continue
        drop[name].add(r_idx)
        ranks_left[name] -= 1
        remaining -= cost

    pruned: LoraTree = {}
    for name, ab in lora_tree.items():
        down, up = _np(ab["down"]), _np(ab["up"])
        keep = np.asarray([r for r in range(down.shape[1]) if r not in drop[name]])
        pruned[name] = {"down": torch.from_numpy(np.ascontiguousarray(down[:, keep])),
                        "up": torch.from_numpy(np.ascontiguousarray(up[keep, :]))}
    return pruned


def save_lora_npz(path: str, lora_tree: Mapping) -> None:
    """Write a tree as the JAX CLI's ``lora_weights.npz``: ``<JAX module
    path>::down`` and ``::up`` arrays."""
    from .convert_diffusers import lora_tree_to_jax

    flat = {f"{name}::{leaf}": v for name, ab in lora_tree_to_jax(lora_tree).items()
            for leaf, v in ab.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_lora_npz(path: str, device="cpu") -> LoraTree:
    """A ``lora_weights.npz`` of either package as the port's tree, f32 on
    `device`."""
    from .convert_diffusers import lora_tree_from_jax

    tree: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as store:
        for key in store.files:
            name, leaf = key.rsplit("::", 1)
            tree.setdefault(name, {})[leaf] = store[key]
    return {name: {leaf: v.to(device) for leaf, v in ab.items()}
            for name, ab in lora_tree_from_jax(tree).items()}
