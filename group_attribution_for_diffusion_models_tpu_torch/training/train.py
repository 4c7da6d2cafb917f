"""The diffusion train step.

Port of the JAX package's ``training/train.py`` (the reference's Accelerate
hot loop, unconditional_generation/main.py:654-845): antithetic (or
uniform) timesteps, q-sample, the U-Net's noise prediction, MSE (optionally
weighted per example), value and gradient, global-norm clip, Adam, then the
EMA with its decay at step + 1. Where the JAX step is a
pure function of (state, batch, key), this one updates the `TrainState` in
place and draws its timesteps and noise from a `torch.Generator`; both can
be injected instead, so tests give the two packages the same draws. A
conditional step (``conditional=True``, the prompt-conditional path of
cli.main) passes each batch's context to the cross-attention U-Net.

`make_members_step` is the step of M stacked members (an `EnsembleState`),
the counterpart of ``jax.vmap(train_step)``: `members_loss` runs them
through `members_forward` (each kernel launched once for all of them),
plain autograd differentiates the sum of their losses, which gives each
member its own gradient, and one optimizer and EMA update covers the stack.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Mapping, Optional

import torch
from torch import nn

from ..config.registry import SchedulerSpec
from ..diffusion.schedulers import ScheduleState, add_noise, antithetic_timesteps
from ..models.unet2d import members_forward
from .state import (
    EMA_MAX_DECAY,
    EnsembleState,
    Optimizer,
    TrainState,
    ema_decay_schedule,
    ema_update,
)


def diffusion_loss(
    model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: ScheduleState,
    images: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
    loss_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Noise-prediction MSE; optional per-example weights (masked ensembles).

    Images and noise (..., B, C, H, W), timesteps and loss weights (..., B):
    with a leading member axis (`model` then maps stacked batches, as
    `members_forward` does) it is one loss a member."""
    x_t = add_noise(schedule, images, noise, timesteps)
    err = (model(x_t, timesteps) - noise) ** 2
    if loss_weights is None:
        return err.flatten(-4).mean(-1)
    per_example = err.flatten(-3).mean(-1)
    denom = torch.clamp(loss_weights.sum(-1), min=1.0)
    return (per_example * loss_weights).sum(-1) / denom


def members_loss(
    model: nn.Module,
    weights: Mapping[str, torch.Tensor],
    schedule: ScheduleState,
    images: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
    loss_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`diffusion_loss` of M members at once, as a function of their stacked
    weights (parameter and buffer names to (M, ...) tensors): images and
    noise (M, B, C, H, W), timesteps and loss weights (M, B). Returns the
    (M,) losses."""
    return diffusion_loss(functools.partial(members_forward, model, weights), schedule,
                          images, noise, timesteps, loss_weights)


def make_train_step(tx: Optimizer, schedule: ScheduleState, spec: SchedulerSpec,
                    ema_max_decay: float = EMA_MAX_DECAY, ema_inv_gamma: float = 1.0,
                    ema_power: float = 0.75, use_antithetic: bool = True,
                    conditional: bool = False):
    """The train step for an optimizer/schedule pair:
    `train_step(state, images, generator=None, timesteps=None, noise=None,
    loss_weights=None, encoder_hidden_states=None) -> {"loss", "grad_norm"}`
    (0-d tensors; the norm is the gradient's before the clip, reported when
    the optimizer clips). Timesteps and noise not given are drawn from
    `generator`, timesteps first: antithetic pairs, or uniform without
    `use_antithetic`. `loss_weights` (B,) weight each example's MSE. A
    `conditional` step passes `encoder_hidden_states` (B, M, D), the
    batch's context, to the U-Net (the JAX step's ``conditional=True``);
    an unconditional one ignores it, as the JAX step does. The EMA decays with
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
        encoder_hidden_states: Optional[torch.Tensor] = None,
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
        model = state.model
        if conditional:
            model = functools.partial(state.model, encoder_hidden_states=encoder_hidden_states)
        loss = diffusion_loss(model, schedule, images, noise, timesteps, loss_weights)
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


def make_members_step(tx: Optimizer, schedule: ScheduleState,
                      ema_max_decay: float = EMA_MAX_DECAY, ema_inv_gamma: float = 1.0,
                      ema_power: float = 0.75,
                      pmean: Optional[Callable[[List[torch.Tensor]], None]] = None):
    """The step of M stacked members on injected draws:
    `members_step(state, images, timesteps, noise, loss_weights=None) ->
    {"loss", "grad_norm"}`, each (M,) on the device, with `state` an
    `EnsembleState` updated in place and the draws as `members_loss` takes
    them. Each member's gradient is clipped by its own norm; the EMA decay is
    the one `make_train_step` uses (every member is at the same step). The
    clipped gradients stay in the stacked parameters' `.grad`. `pmean`, where
    a member's batch is split over ranks, means the gradients and the losses
    over them in place before the optimizer (the JAX step's ``pmean_axis``),
    so the clip sees the whole batch's gradient."""

    def members_step(state: EnsembleState, images: torch.Tensor, timesteps: torch.Tensor,
                     noise: torch.Tensor, loss_weights: Optional[torch.Tensor] = None):
        params = list(state.params.values())
        for p in params:
            p.grad = None
        losses = members_loss(state.model, state.weights(), schedule, images, noise,
                              timesteps, loss_weights)
        losses.sum().backward()  # members are independent: each gets its own gradient
        missing = [n for n, p in state.params.items() if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing[:4]} ({len(missing)} in all)")
        grads, losses = [p.grad for p in params], losses.detach()
        if pmean is not None:
            pmean(grads + [losses])
        grad_norm = tx.update(grads, state.opt_state, params, members=state.num_members)
        state.step += 1
        decay = ema_decay_schedule(state.step, ema_max_decay, False, ema_inv_gamma, ema_power)
        ema_update(state.ema, params, decay)
        metrics = {"loss": losses}
        if grad_norm is not None:
            metrics["grad_norm"] = grad_norm
        return metrics

    return members_step
