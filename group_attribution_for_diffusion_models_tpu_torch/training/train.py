"""The diffusion train step.

Port of the JAX package's ``training/train.py`` (the reference's Accelerate
hot loop, unconditional_generation/main.py:654-845): antithetic (or
uniform) timesteps, q-sample, the U-Net's noise prediction, MSE (optionally
weighted per example), value and gradient, global-norm clip, Adam, then the
EMA with its decay at step + 1. Where the JAX step is a
pure function of (state, batch, key), this one updates the `TrainState` in
place and draws its timesteps and noise from a `torch.Generator`; both can
be injected instead, so tests give the two packages the same draws.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config.registry import SchedulerSpec
from ..diffusion.schedulers import ScheduleState, add_noise, antithetic_timesteps
from .state import EMA_MAX_DECAY, Optimizer, TrainState, ema_decay_schedule, ema_update


def diffusion_loss(
    model: nn.Module,
    schedule: ScheduleState,
    images: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
    loss_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Noise-prediction MSE; optional per-example weights (masked ensembles)."""
    x_t = add_noise(schedule, images, noise, timesteps)
    err = (model(x_t, timesteps) - noise) ** 2
    if loss_weights is None:
        return err.mean()
    per_example = err.reshape(err.shape[0], -1).mean(dim=1)
    denom = torch.clamp(loss_weights.sum(), min=1.0)
    return (per_example * loss_weights).sum() / denom


def make_train_step(tx: Optimizer, schedule: ScheduleState, spec: SchedulerSpec,
                    ema_max_decay: float = EMA_MAX_DECAY, ema_inv_gamma: float = 1.0,
                    ema_power: float = 0.75, use_antithetic: bool = True):
    """The train step for an optimizer/schedule pair:
    `train_step(state, images, generator=None, timesteps=None, noise=None,
    loss_weights=None) -> {"loss", "grad_norm"}` (0-d tensors; the norm is
    the gradient's before the clip, reported when the optimizer clips).
    Timesteps and noise not given are drawn from `generator`, timesteps
    first: antithetic pairs, or uniform without `use_antithetic`.
    `loss_weights` (B,) weight each example's MSE. The EMA decays with
    `ema_decay_schedule(step, ema_max_decay, False, ema_inv_gamma,
    ema_power)`, the JAX step's call: without warm-up, inverse gamma and
    power have no effect. The clipped gradients stay in the parameters'
    `.grad` until the next step."""

    def train_step(
        state: TrainState,
        images: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        timesteps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        loss_weights: Optional[torch.Tensor] = None,
    ):
        batch, device = images.shape[0], images.device
        if timesteps is None and use_antithetic:
            timesteps = antithetic_timesteps(generator, batch, spec.num_train_timesteps,
                                             device)
        elif timesteps is None:
            timesteps = torch.randint(0, spec.num_train_timesteps, (batch,),
                                      generator=generator, device=device)
        if noise is None:
            noise = torch.randn(images.shape, generator=generator, device=device,
                                dtype=images.dtype)
        params = state.params
        for p in params:
            p.grad = None
        loss = diffusion_loss(state.model, schedule, images, noise, timesteps, loss_weights)
        loss.backward()
        missing = [n for n, p in state.model.named_parameters() if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing[:4]} ({len(missing)} in all)")
        grad_norm = tx.update([p.grad for p in params], state.opt_state, params)
        state.step += 1
        decay = ema_decay_schedule(state.step, ema_max_decay, False, ema_inv_gamma, ema_power)
        ema_update(state.ema, params, decay)
        metrics = {"loss": loss.detach()}
        if grad_norm is not None:
            metrics["grad_norm"] = grad_norm
        return metrics

    return train_step
