"""The plain reference's diffusion arithmetic, training loop and sampler,
from the published descriptions (DDPM, DDIM, optax's Adam and AdamW chain,
diffusers' EMA), in float32 unless a caller turns TF32 on.

Nothing here imports the program. Each function is written as the papers and
libraries state it, not copied from the program, and is handed the same
inputs the program is handed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def alphas_cumprod(sched: Mapping, device) -> torch.Tensor:
    """ᾱ_t of a configuration's ``scheduler`` group, (T,) float32."""
    n = sched["num_train_timesteps"]
    if sched["beta_schedule"] == "linear":
        betas = np.linspace(sched["beta_start"], sched["beta_end"], n, dtype=np.float64)
    elif sched["beta_schedule"] == "scaled_linear":
        betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
    else:
        raise ValueError(f"unknown beta_schedule {sched['beta_schedule']!r}")
    acp = np.cumprod(1.0 - betas)
    return torch.tensor(acp, dtype=torch.float32, device=device)


def q_sample(acp: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    a = acp[t].reshape((-1,) + (1,) * (x0.ndim - 1))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def ddim_timesteps(sched: Mapping, steps: int) -> List[int]:
    """The "leading" grid of diffusers' DDIMScheduler, descending."""
    ratio = sched["num_train_timesteps"] // steps
    return [int(i * ratio + sched.get("steps_offset", 0)) for i in range(steps)][::-1]


@torch.no_grad()
def ddim_sample(model: Callable, sched: Mapping, noise: torch.Tensor, steps: int,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM at eta 0 (Song et al. 2021, eq. 12) from `noise`, with diffusers'
    x0 clipping; returns images in [0, 1]."""
    acp = alphas_cumprod(sched, noise.device)
    final = 1.0 if sched.get("set_alpha_to_one", True) else float(acp[0])
    grid = ddim_timesteps(sched, steps)
    x = noise.float()
    for t, t_prev in zip(grid, grid[1:] + [-1]):
        eps = model(x, torch.full((x.shape[0],), t, device=x.device, dtype=torch.long), context)
        a_t = acp[t]
        a_prev = acp[t_prev] if t_prev >= 0 else torch.tensor(final, device=x.device)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        if sched.get("clip_sample", True):
            r = sched.get("clip_sample_range", 1.0)
            x0 = x0.clamp(-r, r)
        eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
        x = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    return (x / 2.0 + 0.5).clamp(0.0, 1.0)


def learning_rate(opt: Mapping, count: int) -> float:
    """The rate at optimizer count `count` (read before it increments)."""
    lr = opt["lr"]
    if opt.get("lr_schedule", "constant") == "constant":
        return lr
    total = opt["total_steps"]
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count, total) / total))


class Adam:
    """optax's chain clip_by_global_norm -> adam / adamw, updating the
    tensors of `params` in place."""

    def __init__(self, opt: Mapping, params: Sequence[torch.Tensor]):
        self.opt = opt
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        limit = self.opt.get("grad_clip_norm")
        if limit is None:
            return grads
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if float(norm) < limit:
            return grads
        return [g / norm * limit for g in grads]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        lr = learning_rate(self.opt, self.count)
        self.count += 1
        c1, c2 = 1.0 - ADAM_B1 ** self.count, 1.0 - ADAM_B2 ** self.count
        wd = self.opt.get("weight_decay", 0.0) if self.opt["name"] == "adamw" else 0.0
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
            nu.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * g * g)
            update = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
            if wd:
                update = update + wd * p
            p.sub_(lr * update)


def ema_decay(step: int, max_decay: float) -> float:
    """diffusers EMAModel's decay without warm-up, at the step count after
    the update."""
    return min(max_decay, (1.0 + step) / (10.0 + step))


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def train_record(params: Dict[str, torch.Tensor], opt: Mapping, steps: int,
                 loss_and_grads: Callable[[int], tuple],
                 ema_max_decay: Optional[float] = None) -> Dict[str, object]:
    """Train the leaves of `params` (name -> tensor, updated in place) for
    `steps` steps; `loss_and_grads(k)` gives step k's (loss, {name: grad}).
    Returns what a run is judged by: each step's loss, the leaf norms of the
    first gradient after the clip, the largest leaf norm of any step's
    gradient (the rule that leaves out leaves that do not train), and the
    leaf norms of the change of the parameters, and of the EMA with
    `ema_max_decay`, after the steps."""
    names = list(params)
    start = {k: params[k].detach().clone() for k in names}
    ema = {k: v.clone() for k, v in start.items()} if ema_max_decay is not None else None
    adam = Adam(opt, [params[k] for k in names])
    losses, grad_max, first = [], {k: 0.0 for k in names}, None
    for k in range(steps):
        loss, grads = loss_and_grads(k)
        for n in names:
            grad_max[n] = max(grad_max[n], float(torch.linalg.vector_norm(grads[n].double())))
        clipped = adam.clip([grads[n] for n in names])
        if k == 0:
            first = leaf_norms(dict(zip(names, clipped)))
        adam.step([params[n] for n in names], clipped)
        losses.append(float(loss))
        if ema is not None:
            d = ema_decay(k + 1, ema_max_decay)
            with torch.no_grad():
                for n in names:
                    ema[n].sub_((1.0 - d) * (ema[n] - params[n]))
    record = {"losses": losses, "grad1": first, "grad_max": grad_max,
              "change": leaf_norms({k: params[k].detach() - start[k] for k in names})}
    if ema is not None:
        record["ema_change"] = leaf_norms({k: ema[k] - start[k] for k in names})
    return record
