"""DDIM sampling loop.

Port of the JAX package's ``diffusion/sampling.py``, as far as its ported
callers (``cli/generate_samples.py``, ``cli/grad_features.py``) use it:
deterministic DDIM (eta=0) from an initial noise, post-processed to float
images in [0, 1], NCHW, and `sample_with_trajectory`, which also returns
the latents each step starts from (Journey TRAK). For latent workloads a
`decode_fn` (the VQ decoder, latents -> images in [-1, 1]) runs after the
denoise loop, on the same device, before the post-processing. A
conditional U-Net takes its context as `encoder_hidden_states` (B, M, D),
passed to every step (the text-to-image path). The JAX package scans the
denoising loop inside one jit; here it is a Python loop of eager calls under
``torch.inference_mode``. The initial noise is either passed in
(`init_noise`, which lets tests feed both packages the same draw) or drawn
from the caller's `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..config.registry import SchedulerSpec
from .schedulers import ScheduleState, ddim_step, inference_timesteps, make_schedule


def _ddim(
    model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: ScheduleState,
    spec: SchedulerSpec,
    shape: Tuple[int, ...],
    device,
    generator: Optional[torch.Generator],
    init_noise: Optional[torch.Tensor],
    num_inference_steps: int,
    trajectory: Optional[List[torch.Tensor]] = None,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    encoder_hidden_states: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images in [0, 1], timesteps) of a DDIM run with eta=0, decoded by
    `decode_fn` when given; appends the latent each step starts from to
    `trajectory` when given one."""
    context = () if encoder_hidden_states is None else (encoder_hidden_states.to(device),)
    if init_noise is None and generator is None:
        raise ValueError("sampling needs init_noise or a generator to draw it")
    ts = inference_timesteps(
        spec.num_train_timesteps, num_inference_steps,
        spec.timestep_spacing, spec.steps_offset,
    )

    with torch.inference_mode():
        if init_noise is None:
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        else:
            x = init_noise.to(device, torch.float32)
        b = shape[0]
        steps = ts.tolist()
        for t, t_prev in zip(steps, steps[1:] + [-1]):
            if trajectory is not None:
                trajectory.append(x)
            t_b = torch.full((b,), t, dtype=torch.long, device=device)
            eps = model(x, t_b, *context)
            x = ddim_step(
                schedule, spec, eps, t_b,
                torch.full((b,), t_prev, dtype=torch.long, device=device), x,
            )
        if decode_fn is not None:
            x = decode_fn(x)
        images = torch.clamp(x / 2.0 + 0.5, 0.0, 1.0)
    return images, torch.from_numpy(ts).to(device)


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
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    encoder_hidden_states: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generate a batch of images of `shape` (B, C, H, W) with DDIM, eta=0.
    `model(x, t)` predicts the noise, or `model(x, t, encoder_hidden_states)`
    when a context is given; `decode_fn` maps the final latents of `shape`
    to images in [-1, 1] (the LDM path). Only the initial noise is random,
    so the result is a function of it."""
    images, _ = _ddim(model, schedule, spec, shape, device, generator, init_noise,
                      num_inference_steps, decode_fn=decode_fn,
                      encoder_hidden_states=encoder_hidden_states)
    return images


def sample_with_trajectory(
    model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: ScheduleState,
    spec: SchedulerSpec,
    shape: Tuple[int, ...],
    *,
    device,
    generator: Optional[torch.Generator] = None,
    init_noise: Optional[torch.Tensor] = None,
    num_inference_steps: int = 100,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DDIM (eta=0) as `sample_loop`, returning (images in [0, 1], the
    trajectory (T, B, C, H, W) of the latents x_t each step starts from, the
    timesteps (T,)): the Journey TRAK capture of the JAX package's
    ``sample_with_trajectory``. The trajectory is stacked outside inference
    mode, so autograd may save it (the journey features' backward does)."""
    trajectory: List[torch.Tensor] = []
    images, ts = _ddim(model, schedule, spec, shape, device, generator, init_noise,
                       num_inference_steps, trajectory, decode_fn)
    return images, torch.stack(trajectory), ts


def make_sampler(
    model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    spec: SchedulerSpec,
    shape: Tuple[int, ...],
    *,
    device,
    num_inference_steps: int = 100,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    encoder_hidden_states: Optional[torch.Tensor] = None,
):
    """Sampler factory: (generator=None, init_noise=None) -> images, decoded
    by `decode_fn` for latent workloads, conditioned on
    `encoder_hidden_states` for a conditional U-Net.

    The schedule is built once, from the spec, on `device` (the reference
    re-instantiates a fresh DDIMScheduler for inference).
    """
    schedule = make_schedule(spec, device)

    def sampler(generator: Optional[torch.Generator] = None,
                init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return sample_loop(
            model, schedule, spec, shape, device=device, generator=generator,
            init_noise=init_noise, num_inference_steps=num_inference_steps,
            decode_fn=decode_fn, encoder_hidden_states=encoder_hidden_states,
        )

    return sampler
