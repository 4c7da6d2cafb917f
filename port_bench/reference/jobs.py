"""The plain reference's three jobs: a stacked member's first training steps,
a LoRA member's first steps over a frozen base, and DDIM images.

Each is handed the benchmark's inputs (weights, data, subsets, LoRA factors,
noise) and works out again what the program derives from them, in plain
PyTorch: no stacking, no vmap, no kernels of the program. ``variant`` puts a
flawed copy in the program's place for the calibration of the limits:
``tf32`` computes in TF32 (the control, the precision below the configured
float32), ``half_batch`` leaves out half of each batch and means the loss
over the rest.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .diffusion import alphas_cumprod, ddim_sample, q_sample, train_record
from .unet import UNet, lora_targets

_RAW_SLOT_BOUND = 1 << 62


@contextlib.contextmanager
def precision(variant: Optional[str]):
    """TF32 in cuDNN and cuBLAS for the ``tf32`` variant, float32 otherwise."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = variant == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rows(variant: Optional[str], batch: int) -> int:
    return batch // 2 if variant == "half_batch" else batch


# --- the ensemble trainer's draws --------------------------------------------------
# The stacked trainer draws each step's slots, timesteps and noise on the
# device from one generator under common noise; these are its rules, written
# out again so that the reference sees the rows the program trained on.

def trainer_seed(*entropy: int) -> int:
    state = np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0]
    return int(state) & ((1 << 63) - 1)


def step_seed(seed: int, step: int) -> int:
    return (seed * 1_000_003 + step) % (1 << 32)


def ensemble_draws(seed: int, step: int, batch: int, shape: Sequence[int], timesteps: int,
                   device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(trainer_seed(step_seed(seed, step)))
    raw = torch.randint(0, _RAW_SLOT_BOUND, (batch,), generator=g, device=device)
    half = batch // 2 + 1
    t = torch.randint(0, timesteps, (half,), generator=g, device=device)
    t = torch.cat([t, timesteps - t - 1])[:batch]
    noise = torch.randn((batch, *shape), generator=g, device=device)
    return {"raw": raw, "t": t, "noise": noise}


def ensemble_record(config: Mapping, weights: Mapping[str, torch.Tensor],
                    images_u8: torch.Tensor, rows: torch.Tensor, seed: int, steps: int,
                    batch: int, variant: Optional[str] = None) -> Dict[str, object]:
    """One member's first `steps` steps from `weights`: its data `rows` of the
    (N, H, W, C) uint8 `images_u8`, the trainer's draws from `seed`."""
    device = images_u8.device
    with torch.device("meta"):
        model = UNet(config["unet"])
    model.load_state_dict({k: v.clone() for k, v in weights.items()}, assign=True)
    params = dict(model.named_parameters())
    acp = alphas_cumprod(config["scheduler"], device)
    nchw = images_u8.permute(0, 3, 1, 2)
    shape = tuple(nchw.shape[1:])
    n = _rows(variant, batch)

    def loss_and_grads(k: int):
        d = ensemble_draws(seed, k, batch, shape, config["scheduler"]["num_train_timesteps"],
                           device)
        x0 = nchw[rows[d["raw"] % len(rows)]].float() / 127.5 - 1.0
        noise, t = d["noise"][:n], d["t"][:n]
        with precision(variant):
            loss = ((model(q_sample(acp, x0[:n], noise, t), t) - noise) ** 2).mean()
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    return train_record(params, config["train"]["optimizer"], steps, loss_and_grads,
                        config["train"].get("ema_max_decay"))


# --- a LoRA member over a frozen base ----------------------------------------------

def lora_record(model: UNet, config: Mapping, lora: Mapping[str, Dict[str, torch.Tensor]],
                latents: torch.Tensor, captions: torch.Tensor, group_of: torch.Tensor,
                rows: torch.Tensor, draws: Callable[[int], Dict[str, torch.Tensor]], steps: int,
                batch: int, microbatch: int, variant: Optional[str] = None) -> Dict[str, object]:
    """One member's first `steps` LoRA steps: `model` the frozen base with its
    weights loaded, `lora` {projection: {"down", "up"}} its starting factors
    (copied here), `draws(k)` step k's {"slot", "t", "noise"}; each image's
    context is its group's caption embedding. The batch's gradient is summed
    over slices of `microbatch` rows."""
    device = latents.device
    targets = dict(lora_targets(model))
    params: Dict[str, torch.Tensor] = {}
    for name, ab in lora.items():
        for leaf in ("down", "up"):
            params[f"{name}.{leaf}"] = ab[leaf].detach().clone().requires_grad_(True)
        targets[name].lora = (params[f"{name}.down"], params[f"{name}.up"])
    acp = alphas_cumprod(config["scheduler"], device)
    n = _rows(variant, batch)

    def loss_and_grads(k: int):
        d = draws(k)
        idx = rows[d["slot"][:n]]
        total, grads = 0.0, None
        for s in range(0, n, microbatch):
            sl = slice(s, min(s + microbatch, n))
            noise, t = d["noise"][sl], d["t"][sl]
            with precision(variant):
                x_t = q_sample(acp, latents[idx[sl]], noise, t)
                eps = model(x_t, t, captions[group_of[idx[sl]]])
                loss = ((eps - noise) ** 2).mean(dim=(1, 2, 3)).sum() / n
                g = torch.autograd.grad(loss, list(params.values()))
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            total += float(loss.detach())
        return torch.tensor(total), dict(zip(params, grads))

    try:
        return train_record(params, config["train"]["optimizer"], steps, loss_and_grads)
    finally:
        for module in targets.values():
            module.lora = None


def lora_layout(model: torch.nn.Module, rank: int) -> List[tuple]:
    """(projection, in, r, out) of every LoRA target of `model`, in module
    order, r = min(rank, in, out)."""
    return [(name, m.in_features, min(rank, m.in_features, m.out_features), m.out_features)
            for name, m in lora_targets(model)]


# --- DDIM images ---------------------------------------------------------------

def ddim_images(model: UNet, config: Mapping, noise: torch.Tensor, steps: int,
                chunk: int, variant: Optional[str] = None) -> torch.Tensor:
    """Images in [0, 1] from `noise`, `chunk` rows at a time; ``half_batch``
    leaves the second half of the rows as they start."""
    out = []
    for s in range(0, noise.shape[0], chunk):
        with precision(variant):
            out.append(ddim_sample(lambda x, t, c: model(x, t), config["scheduler"],
                                   noise[s:s + chunk], steps))
    images = torch.cat(out)
    if variant == "half_batch":
        keep = noise.shape[0] // 2
        images[keep:] = (noise[keep:] / 2.0 + 0.5).clamp(0.0, 1.0)
    return images
