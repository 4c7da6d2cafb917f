"""Checkpoints in the port's own format.

``<model_dir>/ckpt_steps_%08d/state.pt`` holds ``{"params", "ema_params",
"step"}`` (two UNet2D state dicts and an int) and ``meta.json`` beside it
has the JAX package's schema (step, total_steps_time, remaining_idx,
removed_idx, unet_spec). Latest-checkpoint discovery is the same
directory-name scan.

The JAX package's orbax checkpoints cannot be read without JAX. To move one
across, restore it with the JAX package and pass its params through
`models.convert_diffusers.params_from_jax`, then `save_checkpoint` (README).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config.registry import UNetSpec

_STEP_RE = re.compile(r"ckpt_steps_(\d{8})$")


def ckpt_dir_for_step(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"ckpt_steps_{step:08d}")


def get_max_steps(model_dir: str) -> Optional[int]:
    """Latest checkpointed step by directory-name scan."""
    if not os.path.isdir(model_dir):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(model_dir)
        if (m := _STEP_RE.match(name))
    ]
    return max(steps) if steps else None


def save_checkpoint(
    model_dir: str,
    step: int,
    params: Mapping[str, torch.Tensor],
    ema_params: Mapping[str, torch.Tensor],
    remaining_idx: Optional[np.ndarray] = None,
    removed_idx: Optional[np.ndarray] = None,
    total_steps_time: float = 0.0,
    unet_spec: Optional[UNetSpec] = None,
) -> str:
    """Save params + EMA params + provenance; returns the checkpoint path."""
    path = ckpt_dir_for_step(model_dir, step)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    state = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "ema_params": {k: v.detach().cpu() for k, v in ema_params.items()},
        "step": int(step),
    }
    torch.save(state, os.path.join(path, "state.pt"))
    meta: Dict[str, Any] = {"step": int(step), "total_steps_time": total_steps_time}
    if remaining_idx is not None:
        meta["remaining_idx"] = np.asarray(remaining_idx).tolist()
    if removed_idx is not None:
        meta["removed_idx"] = np.asarray(removed_idx).tolist()
    if unet_spec is not None:
        spec_dict = dataclasses.asdict(unet_spec)
        if spec_dict.get("pruned_channels") is not None:
            spec_dict["pruned_channels"] = dict(spec_dict["pruned_channels"])
        meta["unet_spec"] = spec_dict
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def _resolve_step(model_dir: str, step: Optional[int]) -> int:
    if step is None:
        step = get_max_steps(model_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {model_dir}")
    return step


def load_checkpoint(model_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """{"params", "ema_params", "step"} on the CPU; step=None loads the latest."""
    path = ckpt_dir_for_step(model_dir, _resolve_step(model_dir, step))
    return torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      weights_only=True)


def load_meta(model_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Read just a checkpoint's meta.json."""
    path = ckpt_dir_for_step(model_dir, _resolve_step(model_dir, step))
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def load_unet_spec(meta: Dict[str, Any]) -> Optional[UNetSpec]:
    """Rebuild the UNetSpec stored in checkpoint metadata."""
    if "unet_spec" not in meta:
        return None
    d = dict(meta["unet_spec"])
    for key in ("block_out_channels", "down_block_types", "up_block_types"):
        d[key] = tuple(d[key])
    return UNetSpec(**d)
