"""DDIM and DDPM sampling loops.

Port of the JAX package's ``diffusion/sampling.py``: DDIM (eta 0 or more)
or ancestral DDPM from an initial noise, post-processed to float images in
[0, 1], NCHW, and `sample_with_trajectory`, deterministic DDIM that also
returns the latents each step starts from (Journey TRAK). `kind` defaults
to the spec's, as in the JAX package; CIFAR's and MNIST's specs say
"ddpm", so every CLI that samples passes ``kind="ddim"``, as the JAX CLIs
do. For latent workloads a `decode_fn` (the VQ decoder, latents -> images
in [-1, 1]) runs after the denoise loop, on the same device, before the
post-processing. A conditional U-Net takes its context as
`encoder_hidden_states` (B, M, D), passed to every step (the text-to-image
path); `postprocess=False` returns the raw final latents, unclamped and not
decoded (the text-to-image behaviors and gradient features read them). The
JAX package scans the denoising loop inside one jit; here it is a Python
loop of eager calls under ``torch.inference_mode``.

Randomness: the initial noise is either passed in (`init_noise`) or drawn
from the caller's `torch.Generator`, then each step that needs noise (DDPM,
DDIM with eta > 0) draws its own, in step order, from the same generator,
or takes it from `step_noise` (T, B, C, H, W), which lets tests feed both
packages the same draws. DDPM steps a strided grid with the stride's alpha
and beta (`schedulers.ddpm_step` with `t_prev`), as diffusers does; at a
grid of every training timestep it is the JAX package's step (ROADMAP C4).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..config.registry import SchedulerSpec
from .schedulers import (
    ScheduleState,
    ddim_step,
    ddpm_step,
    inference_timesteps,
    make_schedule,
)


def _denoise(
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
    postprocess: bool = True,
    kind: str = "ddim",
    eta: float = 0.0,
    step_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images in [0, 1], timesteps) of a DDIM or DDPM run, decoded by
    `decode_fn` when given, or the raw final latents without `postprocess`;
    appends the latent each step starts from to `trajectory` when given
    one."""
    if kind not in ("ddim", "ddpm"):
        raise ValueError(f"unknown sampler kind {kind!r}")
    context = () if encoder_hidden_states is None else (encoder_hidden_states.to(device),)
    noisy = kind == "ddpm" or eta > 0
    if (init_noise is None or (noisy and step_noise is None)) and generator is None:
        raise ValueError("sampling needs its noise passed in or a generator to draw it")
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
        for i, (t, t_prev) in enumerate(zip(steps, steps[1:] + [-1])):
            if trajectory is not None:
                trajectory.append(x)
            t_b = torch.full((b,), t, dtype=torch.long, device=device)
            eps = model(x, t_b, *context)
            noise = None
            if noisy:
                noise = (step_noise[i].to(device, torch.float32) if step_noise is not None
                         else torch.randn(shape, generator=generator, device=device,
                                          dtype=torch.float32))
            t_prev_b = torch.full((b,), t_prev, dtype=torch.long, device=device)
            if kind == "ddim":
                x = ddim_step(schedule, spec, eps, t_b, t_prev_b, x, eta=eta, noise=noise)
            else:
                x = ddpm_step(schedule, spec, eps, t_b, x, noise,
                              t_prev=None if t_prev == t - 1 else t_prev_b)
        if not postprocess:
            return x, torch.from_numpy(ts).to(device)
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
    eta: float = 0.0,
    kind: Optional[str] = None,
    step_noise: Optional[torch.Tensor] = None,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    encoder_hidden_states: Optional[torch.Tensor] = None,
    postprocess: bool = True,
) -> torch.Tensor:
    """Generate a batch of images of `shape` (B, C, H, W) with `kind`
    ("ddim" or "ddpm"; default `spec.kind`) and DDIM's `eta`.
    `model(x, t)` predicts the noise, or `model(x, t, encoder_hidden_states)`
    when a context is given; `decode_fn` maps the final latents of `shape`
    to images in [-1, 1] (the LDM path). With `postprocess=False` the raw
    final latents come back instead, unclamped and not decoded. DDIM at eta
    0 is a function of the initial noise alone."""
    images, _ = _denoise(model, schedule, spec, shape, device, generator, init_noise,
                         num_inference_steps, decode_fn=decode_fn,
                         encoder_hidden_states=encoder_hidden_states, postprocess=postprocess,
                         kind=kind or spec.kind, eta=eta, step_noise=step_noise)
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
    encoder_hidden_states: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DDIM (eta=0) as `sample_loop`, returning (images in [0, 1], the
    trajectory (T, B, C, H, W) of the latents x_t each step starts from, the
    timesteps (T,)): the Journey TRAK capture of the JAX package's
    ``sample_with_trajectory``, conditioned on `encoder_hidden_states` when
    given. The trajectory is stacked outside inference mode, so autograd may
    save it (the journey features' backward does)."""
    trajectory: List[torch.Tensor] = []
    images, ts = _denoise(model, schedule, spec, shape, device, generator, init_noise,
                          num_inference_steps, trajectory, decode_fn, encoder_hidden_states)
    return images, torch.stack(trajectory), ts


def make_sampler(
    model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    spec: SchedulerSpec,
    shape: Tuple[int, ...],
    *,
    device,
    num_inference_steps: int = 100,
    eta: float = 0.0,
    kind: Optional[str] = None,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    encoder_hidden_states: Optional[torch.Tensor] = None,
):
    """Sampler factory: (generator=None, init_noise=None, step_noise=None)
    -> images, by `kind` (default `spec.kind`) and `eta` as `sample_loop`
    takes them, decoded by `decode_fn` for latent workloads, conditioned on
    `encoder_hidden_states` for a conditional U-Net.

    The schedule is built once, from the spec, on `device` (the reference
    re-instantiates a fresh DDIMScheduler for inference).
    """
    schedule = make_schedule(spec, device)

    def sampler(generator: Optional[torch.Generator] = None,
                init_noise: Optional[torch.Tensor] = None,
                step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return sample_loop(
            model, schedule, spec, shape, device=device, generator=generator,
            init_noise=init_noise, num_inference_steps=num_inference_steps, eta=eta,
            kind=kind, step_noise=step_noise, decode_fn=decode_fn,
            encoder_hidden_states=encoder_hidden_states,
        )

    return sampler
