"""Checkpoints in the port's own format.

``<model_dir>/ckpt_steps_%08d/state.pt`` holds ``{"params", "ema_params",
"step"}`` (two UNet2D state dicts and an int), and ``"opt_state"`` (Adam's
count and moments) when a trainer saves it to resume, and ``meta.json``
beside it has the JAX package's schema (step, total_steps_time,
remaining_idx, removed_idx, unet_spec). Latest-checkpoint discovery is the
same directory-name scan; `resume_or_init` restarts a run from its newest
checkpoint, and wipes a model directory whose newest checkpoint cannot be
read (the reference's recovery).

The JAX package's orbax checkpoints cannot be read without JAX. To move one
across, restore it with the JAX package and pass its params through
`models.convert_diffusers.params_from_jax`, then `save_checkpoint` (README).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config.registry import UNetSpec
from ..training.state import OptState, TrainState


def weights_tag(weights_path: Optional[str], seed: int) -> str:
    """Names the tower a cache was made with: the weights file's absolute
    path and size, or ``random:<seed>`` for the seeded random init."""
    if weights_path is None:
        return f"random:{seed}"
    return f"{os.path.abspath(weights_path)}:{os.path.getsize(weights_path)}"

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
    opt_state: Optional[OptState] = None,
) -> str:
    """Save params + EMA params (+ the optimizer state) + provenance; returns
    the checkpoint path."""
    path = ckpt_dir_for_step(model_dir, step)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    state = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "ema_params": {k: v.detach().cpu() for k, v in ema_params.items()},
        "step": int(step),
    }
    if opt_state is not None:
        state["opt_state"] = {"count": opt_state.count,
                              "mu": [t.detach().cpu() for t in opt_state.mu],
                              "nu": [t.detach().cpu() for t in opt_state.nu]}
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
    """{"params", "ema_params", "step"[, "opt_state"]} on the CPU; step=None
    loads the latest. Raises FileNotFoundError where there is none, and
    ValueError on a file that cannot be read."""
    path = ckpt_dir_for_step(model_dir, _resolve_step(model_dir, step))
    try:
        return torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                          weights_only=True)
    except (RuntimeError, EOFError, pickle.UnpicklingError) as e:
        raise ValueError(f"corrupted checkpoint at {path}: {e}") from e


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


def resume_or_init(model_dir: str, init_state: TrainState) -> Tuple[TrainState, Dict[str, Any], bool]:
    """(state, meta, resumed): `init_state` restored in place from the newest
    checkpoint under `model_dir` (parameters, EMA, optimizer state when it
    was saved, step), or as it is when there is none. A checkpoint that
    cannot be read wipes the model directory, and the run starts afresh."""
    try:
        ckpt, meta = load_checkpoint(model_dir), load_meta(model_dir)
    except FileNotFoundError:
        return init_state, {}, False
    except ValueError:  # a corrupted state.pt, or meta.json (json's error is one)
        shutil.rmtree(model_dir, ignore_errors=True)
        return init_state, {}, False
    model = init_state.model
    model.load_state_dict(ckpt["params"])
    ema = ckpt["ema_params"]
    with torch.no_grad():
        for shadow, (name, _) in zip(init_state.ema, model.named_parameters()):
            shadow.copy_(ema[name])
        if "opt_state" in ckpt:
            saved = ckpt["opt_state"]
            init_state.opt_state.count = int(saved["count"])
            for dst, src in zip(init_state.opt_state.mu + init_state.opt_state.nu,
                                saved["mu"] + saved["nu"]):
                dst.copy_(src)
    init_state.step = int(ckpt["step"])
    return init_state, meta, True
