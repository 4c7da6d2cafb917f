"""DDIM sampling loop.

Port of the JAX package's ``diffusion/sampling.py``, as far as its ported
caller (``cli/generate_samples.py``) uses it: deterministic DDIM (eta=0)
from an initial noise, post-processed to float images in [0, 1], NCHW. The
JAX package scans the denoising loop inside one jit; here it is a Python
loop of eager calls under ``torch.inference_mode``. The initial noise is
either passed in (`init_noise`, which lets tests feed both packages the same
draw) or drawn from the caller's `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config.registry import SchedulerSpec
from .schedulers import ScheduleState, ddim_step, inference_timesteps, make_schedule


def sample_loop(
    model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: ScheduleState,
    spec: SchedulerSpec,
    shape: Tuple[int, ...],
    *,
    device,
    generator: Optional[torch.Generator] = None,
    init_noise: Optional[torch.Tensor] = None,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """Generate a batch of images of `shape` (B, C, H, W) with DDIM, eta=0.
    `model(x, t)` predicts the noise. Only the initial noise is random, so
    the result is a function of it."""
    if init_noise is None and generator is None:
        raise ValueError("sample_loop needs init_noise or a generator to draw it")

    with torch.inference_mode():
        if init_noise is None:
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        else:
            x = init_noise.to(device, torch.float32)
        ts = inference_timesteps(
            spec.num_train_timesteps, num_inference_steps,
            spec.timestep_spacing, spec.steps_offset,
        ).tolist()
        b = shape[0]
        for t, t_prev in zip(ts, ts[1:] + [-1]):
            t_b = torch.full((b,), t, dtype=torch.long, device=device)
            eps = model(x, t_b)
            x = ddim_step(
                schedule, spec, eps, t_b,
                torch.full((b,), t_prev, dtype=torch.long, device=device), x,
            )
        return torch.clamp(x / 2.0 + 0.5, 0.0, 1.0)


def make_sampler(
    model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    spec: SchedulerSpec,
    shape: Tuple[int, ...],
    *,
    device,
    num_inference_steps: int = 100,
):
    """Sampler factory: (generator=None, init_noise=None) -> images.

    The schedule is built once, from the spec, on `device` (the reference
    re-instantiates a fresh DDIMScheduler for inference).
    """
    schedule = make_schedule(spec, device)

    def sampler(generator: Optional[torch.Generator] = None,
                init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return sample_loop(
            model, schedule, spec, shape, device=device, generator=generator,
            init_noise=init_noise, num_inference_steps=num_inference_steps,
        )

    return sampler
