"""The one traffic generator: every input a run hands to the program and to
the reference, made from ``--seed`` and a traffic file's parameters.

Host-side choices (subsets, group sizes) come from numpy generators seeded
by `numpy.random.SeedSequence` of (seed, purpose, ...); tensors are drawn on
the device with a `torch.Generator` seeded the same way, in a few large
calls. The same seed gives the same inputs, and any whole number is a seed.
The work a run does does not depend on the seed: subsets and groups change
which rows a member reads, never how many.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

# Purposes, so that no two draws of one run share a stream.
WEIGHTS, DATA, LABELS, SUBSETS, GROUPS, LORA, CAPTIONS, STEPS, NOISE, SAMPLE = range(1, 11)


def derive(*entropy: int) -> int:
    """A 63-bit seed from whole numbers of any size."""
    state = np.random.SeedSequence([int(e) % (1 << 64) for e in entropy]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31 | int(state[1]) >> 1) & ((1 << 63) - 1)


def rng(*entropy: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(e) % (1 << 64) for e in entropy]))


def generator(device, *entropy: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(*entropy))


def shapley_size(n: int, r: np.random.Generator) -> int:
    """A coalition size from the Shapley kernel's size distribution,
    p(k) ∝ (n - 1) / (k (n - k)) over 1..n-1 (the reference's
    ``remove_data_by_shapley``)."""
    k = np.arange(1, n)
    p = (n - 1) / (k * (n - k))
    return int(r.choice(k, p=p / p.sum()))


def shapley_group_subsets(group_of: np.ndarray, n_groups: int, members: int,
                          min_rows: int, seed: int) -> List[np.ndarray]:
    """Each member's remaining rows: a Shapley-kernel coalition of groups,
    drawn again until it holds at least `min_rows` rows (the batch, so that
    every member trains at the full batch)."""
    out = []
    for m in range(members):
        r = rng(seed, SUBSETS, m)
        while True:
            keep = r.permutation(n_groups)[:shapley_size(n_groups, r)]
            rows = np.flatnonzero(np.isin(group_of, keep))
            if len(rows) >= min_rows:
                out.append(rows.astype(np.int64))
                break
    return out


def balanced_labels(n: int, classes: int, seed: int) -> np.ndarray:
    """n labels, n / classes of each class, in a seeded order (CIFAR-10's
    layout)."""
    return rng(seed, LABELS).permutation(np.repeat(np.arange(classes), n // classes))


def heavy_tailed_sizes(total: int, groups: int, sigma: float, seed: int) -> np.ndarray:
    """Rows per group: log-normal shares of `total`, at least one each, summing
    to `total` exactly (largest remainders)."""
    w = rng(seed, GROUPS).lognormal(0.0, sigma, groups)
    share = w / w.sum() * (total - groups)
    sizes = np.floor(share).astype(np.int64) + 1
    rest = total - int(sizes.sum())
    sizes[np.argsort(-(share - np.floor(share)))[:rest]] += 1
    return sizes


def group_of_rows(sizes: np.ndarray, seed: int) -> np.ndarray:
    """Each row's group, rows in a seeded order."""
    return rng(seed, GROUPS, 1).permutation(np.repeat(np.arange(len(sizes)), sizes))


def uint8_images(n: int, hwc: Sequence[int], seed: int, device) -> torch.Tensor:
    """(n, H, W, C) seeded uint8 stand-in images, on `device`."""
    g = generator(device, seed, DATA)
    return torch.randint(0, 256, (n, *hwc), generator=g, device=device, dtype=torch.uint8)


def normal(shape: Sequence[int], device, *entropy: int) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator(device, *entropy), device=device)


def lora_step_draws(seed: int, step: int, member: int, rows: int, batch: int,
                    timesteps: int, latent_shape: Sequence[int], device) -> Dict[str, torch.Tensor]:
    """One member's draws of one LoRA step, as the LoRA trainer draws them:
    slots uniform over the member's rows, uniform timesteps, Gaussian noise,
    in that order from one generator."""
    g = generator(device, seed, STEPS, step, member)
    slot = torch.randint(0, rows, (batch,), generator=g, device=device)
    t = torch.randint(0, timesteps, (batch,), generator=g, device=device)
    noise = torch.randn((batch, *latent_shape), generator=g, device=device)
    return {"slot": slot, "t": t, "noise": noise}
