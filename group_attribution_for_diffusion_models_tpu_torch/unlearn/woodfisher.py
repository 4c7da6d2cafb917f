"""WoodFisher influence unlearning (the iu/iu_u methods).

Port of the JAX package's ``unlearn/woodfisher.py`` (reference
src/unlearn/Wfisher.py:12-207): approximate the inverse Hessian by the
WoodFisher rank-1 recursion over per-batch gradients, and perturb the
parameters by alpha * H^-1 applied to frac * (g_removed - g_remaining).

* `average_gradient`: the flat dataset-mean gradient with antithetic
  timesteps (reference get_grad :37-122), one backward a batch.
* `woodfisher_inv_hvp`: the sequential rank-1 recursion
  (`woodfisher_recursion`) over one gradient a batch, computed as it is
  consumed, so the memory is O(D): three flat vectors, never an (N, D)
  matrix.
* `apply_perturbation`: params + alpha * delta (reference apply_perturb
  :12-21).
* `influence_unlearn`: the whole method (reference unlearn.py:509-546).

Flat vectors are float32 on the model's device, in `named_parameters` order
(the JAX package ravels `tree_leaves`, alphabetical paths; tests compare the
two through `models.convert_diffusers.params_{from,to}_jax`). The JAX
functions draw each batch's timesteps and noise from a threefry key of
`seed`; here each function draws them from a torch generator seeded with
`seed` (timesteps, then noise, a batch), or takes them injected as `draws`,
one (timesteps, noise NCHW) pair a batch, so tests give both packages the
same draws.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config.registry import SchedulerSpec
from ..diffusion.schedulers import ScheduleState, add_noise, antithetic_timesteps
from ..utils.device import to_device

Draws = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def batch_gradient(model: nn.Module, schedule: ScheduleState, images: torch.Tensor,
                   timesteps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The flat gradient of the noise-prediction MSE of one batch (NCHW)."""
    params = [p for p in model.parameters()]
    with torch.enable_grad():
        x_t = add_noise(schedule, images, noise, timesteps)
        loss = torch.mean((model(x_t, timesteps) - noise) ** 2)
        grads = torch.autograd.grad(loss, params)
    return torch.cat([g.reshape(-1) for g in grads])


def _draws(spec: SchedulerSpec, seed: int, shapes: Iterable[Tuple[int, ...]],
           device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One (antithetic timesteps, noise) pair for each batch shape, in
    order, from a generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape in shapes:
        t = antithetic_timesteps(gen, shape[0], spec.num_train_timesteps, device)
        out.append((t, torch.randn(shape, generator=gen, device=device)))
    return out


def _grads(model, schedule, spec, batches: List[np.ndarray], seed: int,
           draws: Optional[Draws]):
    """The flat gradient of each batch, one at a time, on drawn or injected draws."""
    device = _device(model)
    shapes = [(len(b), b.shape[3], b.shape[1], b.shape[2]) for b in batches]
    draws = _draws(spec, seed, shapes, device) if draws is None else draws
    if len(draws) != len(batches):
        raise ValueError(f"{len(draws)} draws for {len(batches)} batches")
    for b, (t, noise) in zip(batches, draws):
        yield batch_gradient(model, schedule, to_device(b, device), t.to(device), noise.to(device))


def average_gradient(
    model: nn.Module,
    schedule: ScheduleState,
    spec: SchedulerSpec,
    images: np.ndarray,
    batch_size: int = 64,
    seed: int = 0,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """Flat dataset-mean gradient over `images` (N, H, W, C) (reference
    Wfisher.get_grad): the full batches of `batch_size` (one batch of all N
    when N < batch_size), each gradient weighted by its batch's size."""
    n = len(images)
    stops = range(0, n - n % batch_size or n, batch_size)
    batches = [images[i:i + batch_size] for i in stops]
    if not batches:
        raise ValueError("no data")
    total, count = None, 0
    for b, g in zip(batches, _grads(model, schedule, spec, batches, seed, draws)):
        w = len(b)
        total = g * w if total is None else total + g * w
        count += w
    return total / count


def woodfisher_recursion(vector: torch.Tensor, grads: Iterable[torch.Tensor], n: float,
                         damping: float = 1e-4) -> torch.Tensor:
    """The WoodFisher rank-1 recursion of reference woodfisher_diff
    (Wfisher.py:195-205) over flat gradients g_0, g_1, ... with sample count
    `n` and k = `vector`:

        i = 0:   o = g_0
        i > 0:   tmp = o . g_i
                 k  -= (k . g_i) / (n + tmp + damping) * o
                 o  -= tmp / (n + tmp + damping) * o

    returning k. Each gradient is read once, as the iterable yields it; the
    scalars stay on the device (no host round trip a batch)."""
    k = vector.clone()
    o = None
    for g in grads:
        if o is None:
            o = g
            continue
        tmp = torch.dot(o, g)
        denom = n + tmp + damping
        k = k - (torch.dot(k, g) / denom) * o
        o = o - (tmp / denom) * o
    return k


def woodfisher_inv_hvp(
    model: nn.Module,
    schedule: ScheduleState,
    spec: SchedulerSpec,
    images: np.ndarray,
    vector: torch.Tensor,
    num_batches: int = 32,
    batch_size: int = 8,
    damping: float = 1e-4,
    seed: int = 1,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """WoodFisher approximate H^-1 `vector` over the first `num_batches`
    batches of `batch_size` of `images` (fewer when there are fewer), with
    n = len(images): `woodfisher_recursion` on their gradients."""
    num_batches = min(num_batches, len(images) // batch_size)
    if num_batches < 1:
        raise ValueError("not enough data for woodfisher batches")
    batches = [images[j * batch_size:(j + 1) * batch_size] for j in range(num_batches)]
    grads = _grads(model, schedule, spec, batches, seed, draws)
    return woodfisher_recursion(vector, grads, float(len(images)), damping)


def apply_perturbation(model: nn.Module, flat_delta: torch.Tensor,
                       alpha: float = 1.0) -> Dict[str, torch.Tensor]:
    """`model`'s state dict with params + alpha * delta, the flat delta in
    `named_parameters` order (reference apply_perturb)."""
    size = sum(p.numel() for p in model.parameters())
    if flat_delta.numel() != size:
        raise ValueError(f"delta of {flat_delta.numel()} for {size} parameters")
    new = dict(model.state_dict())
    offset = 0
    for name, p in model.named_parameters():
        d = flat_delta[offset:offset + p.numel()].view_as(p)
        new[name] = p.detach() + alpha * d
        offset += p.numel()
    return new


def influence_unlearn(
    model: nn.Module,
    schedule: ScheduleState,
    spec: SchedulerSpec,
    removed_images: np.ndarray,
    remaining_images: np.ndarray,
    alpha: float = 1.0,
    batch_size: int = 32,
    wf_batches: int = 16,
    seed: int = 0,
    draws: Optional[Dict[str, Draws]] = None,
    seconds: Optional[Dict[str, float]] = None,
) -> Dict[str, torch.Tensor]:
    """The iu method (reference unlearn.py:509-546): `model`'s state dict
    perturbed by alpha * WoodFisher^-1 applied to frac * (mean gradient on
    the removed set - mean gradient on the remaining set), frac = |removed| /
    |total|; the WoodFisher batches are the remaining set's, of
    max(batch_size // 4, 1). Seeds seed, seed + 1 and seed + 2 draw the three
    parts, as in the JAX function; `draws` injects them instead, under
    "removed", "remaining" and "woodfisher". `seconds`, when given, receives
    each part's seconds (to a device synchronise)."""
    draws = draws or {}
    device = _device(model)
    clock = [time.perf_counter()]

    def lap(key: str) -> None:
        if seconds is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            seconds[key] = now - clock[0]
            clock[0] = now

    g_removed = average_gradient(model, schedule, spec, removed_images, batch_size, seed,
                                 draws.get("removed"))
    lap("g_removed")
    g_remaining = average_gradient(model, schedule, spec, remaining_images, batch_size,
                                   seed + 1, draws.get("remaining"))
    lap("g_remaining")
    frac = len(removed_images) / (len(removed_images) + len(remaining_images))
    direction = frac * (g_removed - g_remaining)
    del g_removed, g_remaining
    inv_hvp = woodfisher_inv_hvp(model, schedule, spec, remaining_images, direction,
                                 num_batches=wf_batches, batch_size=max(batch_size // 4, 1),
                                 seed=seed + 2, draws=draws.get("woodfisher"))
    lap("woodfisher")
    return apply_perturbation(model, inv_hvp, alpha)
