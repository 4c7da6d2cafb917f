"""DDPM/DDIM noise schedules as pure tensor functions.

Port of the JAX package's ``diffusion/schedulers.py``. Schedule tables are
built once on the host (numpy, float32), so every device gets the same
tables, into a `ScheduleState` of tensors on the caller's device;
`add_noise`, `velocity_target`, `ddpm_step` and `ddim_step` are pure functions of their tensor
arguments, with noise always supplied by the caller, and
`antithetic_timesteps` draws from the caller's `torch.Generator`.

Semantics mirror diffusers v0.24: linear/scaled_linear/cosine betas,
DDPM ancestral steps with fixed_small/fixed_large variance, DDIM with eta,
leading/trailing/linspace timestep spacing and set_alpha_to_one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config.registry import SchedulerSpec


class ScheduleState(NamedTuple):
    """Precomputed noise-schedule tables, all shape (T,) float32."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor


def make_betas(spec: SchedulerSpec) -> np.ndarray:
    """Build the beta table for a schedule spec (host-side numpy)."""
    t = spec.num_train_timesteps
    if spec.beta_schedule == "linear":
        betas = np.linspace(spec.beta_start, spec.beta_end, t, dtype=np.float64)
    elif spec.beta_schedule == "scaled_linear":
        betas = (
            np.linspace(spec.beta_start**0.5, spec.beta_end**0.5, t, dtype=np.float64)
            ** 2
        )
    elif spec.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(s):
            return np.cos((s + 0.008) / 1.008 * np.pi / 2) ** 2

        i = np.arange(t, dtype=np.float64)
        betas = np.minimum(1 - alpha_bar((i + 1) / t) / alpha_bar(i / t), 0.999)
    else:
        raise ValueError(f"unknown beta_schedule {spec.beta_schedule!r}")
    return betas.astype(np.float32)


def make_schedule(spec: SchedulerSpec, device="cpu") -> ScheduleState:
    betas = make_betas(spec)
    alphas = np.float32(1.0) - betas
    acp = np.cumprod(alphas, dtype=np.float32)
    return ScheduleState(
        *(torch.from_numpy(a).to(device) for a in (betas, alphas, acp))
    )


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep scalars and broadcast to an image batch rank."""
    vals = table[t]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.ndim))


def add_noise(
    state: ScheduleState, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) (matches diffusers add_noise)."""
    acp = _extract(state.alphas_cumprod, t, x0.ndim)
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def velocity_target(
    state: ScheduleState, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """v-prediction target sqrt(acp) eps - sqrt(1-acp) x0."""
    acp = _extract(state.alphas_cumprod, t, x0.ndim)
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * x0


def antithetic_timesteps(
    generator: torch.Generator, batch: int, num_train_timesteps: int, device=None
) -> torch.Tensor:
    """Antithetic timestep sampling for variance reduction: batch // 2 + 1
    uniform draws from `generator`, then their mirrors T - t - 1, cut to
    `batch` (the reference hot loop, unconditional_generation/main.py:683-696)."""
    half = batch // 2 + 1
    t = torch.randint(0, num_train_timesteps, (half,), generator=generator,
                      device=device or generator.device)
    return torch.cat([t, num_train_timesteps - t - 1])[:batch]


def pred_original_sample(
    state: ScheduleState,
    model_out: torch.Tensor,
    t: torch.Tensor,
    x_t: torch.Tensor,
    prediction_type: str = "epsilon",
) -> torch.Tensor:
    """Recover x0-hat from a model prediction at timestep t."""
    acp = _extract(state.alphas_cumprod, t, x_t.ndim)
    if prediction_type == "epsilon":
        return (x_t - torch.sqrt(1.0 - acp) * model_out) / torch.sqrt(acp)
    if prediction_type == "sample":
        return model_out
    if prediction_type == "v_prediction":
        return torch.sqrt(acp) * x_t - torch.sqrt(1.0 - acp) * model_out
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def ddpm_step(
    state: ScheduleState,
    spec: SchedulerSpec,
    model_out: torch.Tensor,
    t: torch.Tensor,
    x_t: torch.Tensor,
    noise: torch.Tensor,
    t_prev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One ancestral DDPM reverse step x_t -> x_{t_prev}.

    `noise` is pre-sampled gaussian noise of x_t's shape (the caller owns the
    generator). Variance follows diffusers fixed_small / fixed_large with the
    t==0 no-noise convention. Without `t_prev` the step goes to t - 1 with
    the tables' alpha and beta at t, as the JAX package's ``ddpm_step``
    does at every timestep count. With `t_prev` (negative: the end of the
    chain, alpha_cumprod 1) alpha and beta are the ones of the whole stride,
    alpha_cumprod[t] / alpha_cumprod[t_prev] and one minus it, as diffusers'
    DDPMScheduler steps a grid of fewer inference steps; at t_prev = t - 1
    the two agree but for rounding.
    """
    ndim = x_t.ndim
    acp = state.alphas_cumprod
    acp_t = _extract(acp, t, ndim)
    if t_prev is None:
        # alpha_cumprod at t-1 (1.0 when t == 0).
        acp_prev = _extract(torch.cat([acp.new_ones(1), acp[:-1]]), t, ndim)
        beta_t = _extract(state.betas, t, ndim)
        alpha_t = _extract(state.alphas, t, ndim)
    else:
        acp_prev = torch.where((t_prev >= 0).reshape((-1,) + (1,) * (ndim - 1)),
                               _extract(acp, torch.clamp(t_prev, min=0), ndim),
                               torch.ones((1,) * ndim, dtype=acp.dtype, device=acp.device))
        alpha_t = acp_t / acp_prev
        beta_t = 1.0 - alpha_t

    x0 = pred_original_sample(state, model_out, t, x_t, spec.prediction_type)
    if spec.clip_sample:
        x0 = torch.clamp(x0, -spec.clip_sample_range, spec.clip_sample_range)

    # mu_t coefficients (DDPM eq. 7).
    coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef_xt = torch.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * x0 + coef_xt * x_t

    if spec.variance_type == "fixed_small":
        var = beta_t * (1.0 - acp_prev) / (1.0 - acp_t)
    elif spec.variance_type == "fixed_large":
        var = beta_t
    else:
        raise ValueError(f"unknown variance_type {spec.variance_type!r}")
    var = torch.clamp(var, min=1e-20)

    nonzero = (t > 0).reshape((-1,) + (1,) * (ndim - 1)).to(x_t.dtype)
    return mean + nonzero * torch.sqrt(var) * noise


def ddim_step(
    state: ScheduleState,
    spec: SchedulerSpec,
    model_out: torch.Tensor,
    t: torch.Tensor,
    t_prev: torch.Tensor,
    x_t: torch.Tensor,
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One DDIM step x_t -> x_{t_prev} (Song et al. 2021, eq. 12).

    `t_prev < 0` selects the final alpha_cumprod (1.0 under set_alpha_to_one,
    matching diffusers DDIMScheduler).
    """
    ndim = x_t.ndim
    acp = state.alphas_cumprod
    acp_t = _extract(acp, t, ndim)
    final_acp = 1.0 if spec.set_alpha_to_one else float(acp[0])
    acp_prev = torch.where(
        (t_prev >= 0).reshape((-1,) + (1,) * (ndim - 1)),
        _extract(acp, torch.clamp(t_prev, min=0), ndim),
        torch.full((1,) * ndim, final_acp, dtype=x_t.dtype, device=x_t.device),
    )

    x0 = pred_original_sample(state, model_out, t, x_t, spec.prediction_type)
    if spec.clip_sample:
        x0 = torch.clamp(x0, -spec.clip_sample_range, spec.clip_sample_range)
    # Re-derive eps from the (possibly clipped) x0 like diffusers does.
    eps = (x_t - torch.sqrt(acp_t) * x0) / torch.sqrt(1.0 - acp_t)

    var = (1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)
    sigma = eta * torch.sqrt(var)

    dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma**2, min=0.0)) * eps
    x_prev = torch.sqrt(acp_prev) * x0 + dir_xt
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires caller-provided noise")
        x_prev = x_prev + sigma * noise
    return x_prev


def inference_timesteps(
    num_train_timesteps: int,
    num_inference_steps: int,
    spacing: str = "leading",
    steps_offset: int = 0,
) -> np.ndarray:
    """Descending timestep grid for sampling (diffusers timestep_spacing)."""
    if spacing == "leading":
        ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.int64)
        ts = ts + steps_offset
    elif spacing == "trailing":
        ratio = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -ratio)).astype(np.int64) - 1
    elif spacing == "linspace":
        ts = (
            np.linspace(0, num_train_timesteps - 1, num_inference_steps)
            .round()[::-1]
            .astype(np.int64)
        )
    else:
        raise ValueError(f"unknown timestep_spacing {spacing!r}")
    return ts
