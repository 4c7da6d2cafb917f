"""Structural channel pruning as a (UNetSpec, state dict) -> (UNetSpec, state
dict) transform.

Port of the JAX package's ``pruning/structural.py``, on the port's state
dict in the diffusers layout (``conv1.weight`` is (out, in, kh, kw)). Each
resnet block's hidden channels are scored, the top (1 - ratio) fraction is
kept, and the dependency group of the hidden width is sliced coherently:
conv1 (out), time_emb_proj (out), norm2 (weight/bias) and conv2 (in). The
new widths go to ``UNetSpec.pruned_channels`` under the JAX package's block
names (``down_1_res_0``, ``mid_res_0``, ``up_2_res_1``), so a pruned model
re-instantiates dense and smaller from spec + state dict.

Importance criteria:
* magnitude: L2 norm of each hidden channel's conv1-out and conv2-in weights;
* taylor / diff-pruning: |grad x weight| accumulated over diffusion
  timesteps from T-1 down, stopping once the loss at a timestep falls under
  a threshold fraction of the largest so far (diff-pruning). Forward and
  backward run through the model on its device (the kernels on the card);
* random: seeded scores (ablation baseline), drawn from one numpy stream
  across the blocks in the JAX package's block order, so both packages keep
  the same channels.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config.registry import UNetSpec
from ..diffusion.schedulers import ScheduleState, add_noise

_BLOCK_RE = re.compile(r"^(?:(down|up)_blocks\.(\d+)|mid_block)\.resnets\.(\d+)\.conv1\.weight$")
_SIDE_ORDER = {"down": 0, None: 1, "up": 2}


def _block_prefix(path: str) -> str:
    """State-dict prefix of a JAX block name: ``down_1_res_0`` ->
    ``down_blocks.1.resnets.0``, ``mid_res_1`` -> ``mid_block.resnets.1``."""
    m = re.match(r"^(down|up)_(\d+)_res_(\d+)$", path)
    if m:
        side, i, j = m.groups()
        return f"{side}_blocks.{i}.resnets.{j}"
    m = re.match(r"^mid_res_(\d+)$", path)
    if m:
        return f"mid_block.resnets.{m.group(1)}"
    raise ValueError(f"not a resnet block name: {path!r}")


def resnet_block_paths(state_dict: Mapping[str, torch.Tensor]) -> Tuple[str, ...]:
    """JAX names of every resnet block in a UNet2D state dict, in the JAX
    model's creation order: down blocks, then the mid block, then up blocks,
    each by block then layer."""
    found = []
    for key in state_dict:
        m = _BLOCK_RE.match(key)
        if m:
            side, i, j = m.groups()
            name = f"{side}_{i}_res_{j}" if side else f"mid_res_{j}"
            found.append(((_SIDE_ORDER[side], int(i or 0), int(j)), name))
    return tuple(name for _, name in sorted(found))


def _weights(state_dict, path: str):
    """conv1 and conv2 weights of one block, as float32 numpy."""
    prefix = _block_prefix(path)
    return tuple(state_dict[f"{prefix}.{conv}.weight"].detach().float().cpu().numpy()
                 for conv in ("conv1", "conv2"))


def magnitude_importance(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Per-hidden-channel L2 norm over conv1-out plus that over conv2-in."""
    scores = {}
    for path in resnet_block_paths(state_dict):
        w1, w2 = _weights(state_dict, path)  # (hidden, in, kh, kw), (out, hidden, kh, kw)
        s1 = np.sqrt((w1**2).sum(axis=(1, 2, 3)))
        s2 = np.sqrt((w2**2).sum(axis=(0, 2, 3)))
        scores[path] = s1 + s2
    return scores


def random_importance(state_dict: Mapping[str, torch.Tensor],
                      seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {
        path: rng.rand(state_dict[f"{_block_prefix(path)}.conv1.weight"].shape[0])
        for path in resnet_block_paths(state_dict)
    }


def taylor_importance(
    model: torch.nn.Module,
    schedule: ScheduleState,
    images: np.ndarray,
    num_timesteps: int = 1000,
    timestep_stride: int = 1,
    loss_threshold: Optional[float] = None,
    seed: int = 0,
    batch_size: int = 64,
    noise_fn: Optional[Callable[[int], torch.Tensor]] = None,
) -> Dict[str, np.ndarray]:
    """|grad x weight| per hidden channel, accumulated over timesteps.

    `model` is a UNet2D on its device; `images` (N, H, W, C) in [-1, 1], of
    which the first `batch_size` are used. Walks t = T-1, T-1-stride, ...
    down to 0; at each, the diffusion loss of the noised batch is
    differentiated with respect to every parameter (one forward and one
    backward), and the timestep's scores are added unless its loss is under
    `loss_threshold` times the largest loss so far, which ends the walk
    (diff-pruning). The noise of timestep t is ``noise_fn(t)`` when given (a
    (B, C, H, W) tensor), else drawn from a ``torch.Generator`` on the
    model's device seeded with `seed`.
    """
    device = next(model.parameters()).device
    x0 = torch.from_numpy(np.ascontiguousarray(images[:batch_size])).permute(0, 3, 1, 2)
    x0 = x0.to(device=device, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = dict(model.named_parameters())
    names = list(params)
    paths = resnet_block_paths(params)
    was_training = model.training
    model.eval()  # the JAX apply is deterministic: no dropout
    acc: Dict[str, torch.Tensor] = {}
    max_loss = 0.0
    for t in range(num_timesteps - 1, -1, -timestep_stride):
        noise = (noise_fn(t) if noise_fn is not None
                 else torch.randn(x0.shape, generator=gen, device=device))
        noise = noise.to(device=device, dtype=torch.float32)
        tt = torch.full((x0.shape[0],), t, dtype=torch.long, device=device)
        eps = model(add_noise(schedule, x0, noise, tt), tt)
        loss_t = torch.mean((eps - noise) ** 2)
        grads = dict(zip(names, torch.autograd.grad(loss_t, list(params.values()))))
        loss = loss_t.detach().item()
        max_loss = max(max_loss, loss)
        if loss_threshold is not None and loss < loss_threshold * max_loss:
            break
        with torch.no_grad():
            for path in paths:
                prefix = _block_prefix(path)
                k1, k2 = f"{prefix}.conv1.weight", f"{prefix}.conv2.weight"
                s = ((grads[k1] * params[k1]).abs().sum(dim=(1, 2, 3))
                     + (grads[k2] * params[k2]).abs().sum(dim=(0, 2, 3)))
                acc[path] = acc[path] + s if path in acc else s
    model.train(was_training)
    return {path: s.cpu().numpy() for path, s in acc.items()}


def _slice_block(state_dict, prefix: str, keep: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One resnet block's sliced tensors: the kept hidden channels."""
    out = {}
    for name, dim in (("conv1.weight", 0), ("conv1.bias", 0), ("time_emb_proj.weight", 0),
                      ("time_emb_proj.bias", 0), ("norm2.weight", 0), ("norm2.bias", 0),
                      ("conv2.weight", 1)):
        key = f"{prefix}.{name}"
        v = state_dict[key]
        out[key] = v.index_select(dim, keep.to(v.device))
    return out


def prune_unet(
    spec: UNetSpec,
    state_dict: Mapping[str, torch.Tensor],
    pruning_ratio: float,
    importance: Mapping[str, np.ndarray],
    group_size: Optional[int] = None,
) -> Tuple[UNetSpec, Dict[str, torch.Tensor]]:
    """Keep the top (1 - ratio) hidden channels of every resnet block.

    Kept widths round up to `group_size` (default spec.norm_num_groups, the
    GroupNorm's divisibility). Returns the new spec (with pruned_channels)
    and the sliced state dict; tensors of other layers are the input's.
    """
    if not 0.0 <= pruning_ratio < 1.0:
        raise ValueError(f"pruning_ratio must be in [0, 1), got {pruning_ratio}")
    if group_size is None:
        group_size = spec.norm_num_groups
    new_state = dict(state_dict)
    pruned_channels = dict(spec.pruned_channels or {})
    for path in resnet_block_paths(state_dict):
        scores = np.asarray(importance[path])
        hidden = len(scores)
        n_keep = max(int(round(hidden * (1.0 - pruning_ratio))), group_size)
        n_keep = min(int(-(-n_keep // group_size) * group_size), hidden)
        keep = np.sort(np.argsort(scores)[::-1][:n_keep])
        new_state.update(_slice_block(state_dict, _block_prefix(path), torch.from_numpy(keep)))
        if n_keep != hidden:
            pruned_channels[path] = n_keep
    return dataclasses.replace(spec, pruned_channels=pruned_channels), new_state


def count_params(state_dict: Mapping[str, torch.Tensor]) -> int:
    return int(sum(v.numel() for v in state_dict.values()))
