"""The ensemble axis: one model per removal subset, trained side by side.

Port of the JAX package's ``parallel/ensemble.py`` without a mesh. As there,
the members' states are stacked on a leading axis (`training.state.
EnsembleState`) and one step covers all of them
(`training.train.make_members_step`, the counterpart of the JAX
``local_step``): one forward and backward in which each kernel launches once
for every member (the kernels' autograd Functions take a gamma/beta per
member under vmap), then one optimizer and EMA update of the stack.
`run_scanned` is ``lax.scan`` as a Python loop over chunks of steps that
reads nothing back to the host inside a chunk; it gives exactly `run`'s
states. `--chunk_size` of the pipeline bounds how many members share a
launch; a mesh over several cards is later work.

Data path: the whole training set stays on the device (NCHW): pixels as
uint8, or, for latent workloads, the VQ-VAE's float32 latents as the JAX
trainer keeps them. Each member draws its batch slots on the device from its
padded remaining-index table, modulo its true size, so every member samples
uniformly with replacement from exactly its own subset.

Randomness: each ensemble step has a seed, `_step_seed(seed, step)`, as in
the JAX trainer. With `common_noise` one generator, seeded from it, draws
the raw slots, the timesteps and the noise that every member shares, and
every member starts from the same initial weights: members then differ only
through their subsets, and identical subsets give bit-identical members.
Otherwise each member draws from its own generator, seeded from (step seed,
1 + member), and gets its own initial weights. The streams differ from the
JAX package's threefry streams; what matches is their structure.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config.registry import SchedulerSpec
from ..diffusion.schedulers import ScheduleState, antithetic_timesteps
from ..training.state import EnsembleState, Optimizer, init_ensemble_state
from ..training.train import make_members_step

_RAW_SLOT_BOUND = 1 << 62  # raw draws, reduced modulo each member's size


def _step_seed(seed: int, step: int) -> int:
    """Per-step seed, reduced mod 2**32 (the JAX trainer's)."""
    return (seed * 1_000_003 + step) % (1 << 32)


def derived_seed(*entropy: int) -> int:
    """A 63-bit torch seed from non-negative integers."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0]
    return int(state) & ((1 << 63) - 1)


def pad_member_indices(
    member_indices: Sequence[np.ndarray], pad_multiple: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ragged remaining-index lists into a (B, max_n) table.

    Padding repeats each member's indices cyclically, so any slot < max_n is a
    valid datum; sampling stays uniform because draws are taken modulo the
    member's true size.
    """
    sizes = np.asarray([len(ix) for ix in member_indices], dtype=np.int32)
    if (sizes == 0).any():
        raise ValueError("every ensemble member needs a nonempty subset")
    max_n = int(-(-sizes.max() // pad_multiple) * pad_multiple)
    table = np.zeros((len(member_indices), max_n), dtype=np.int32)
    for row, ix in enumerate(member_indices):
        reps = -(-max_n // len(ix))
        table[row] = np.tile(np.asarray(ix, dtype=np.int32), reps)[:max_n]
    return table, sizes


@dataclasses.dataclass
class EnsembleTrainer:
    """Subset-parallel trainer.

    Args:
        tx: the optimizer (shared configuration; each member has its own state).
        schedule/spec: noise schedule, `schedule` on `device`.
        images_u8: full training set, (N, H, W, C), moved to the device
            once: uint8 pixels, or float32 latents used as they are (the JAX
            trainer's name and rule for both).
        member_indices: per-member remaining indices (ragged), from
            data.removal samplers.
        batch_size: per-member batch size.
    """

    tx: Optimizer
    schedule: ScheduleState
    spec: SchedulerSpec
    images_u8: np.ndarray
    member_indices: Sequence[np.ndarray]
    batch_size: int
    device: torch.device
    # Common random numbers across members (the JAX trainer's default in the
    # CLI): shared init, slots, timesteps and noise.
    common_noise: bool = False

    def __post_init__(self):
        table, sizes = pad_member_indices(self.member_indices)
        self.num_members = len(self.member_indices)
        self._sizes = torch.from_numpy(sizes).long().to(self.device)[:, None]
        self._table = torch.from_numpy(table).long().to(self.device)
        if self.images_u8.dtype not in (np.uint8, np.float32):
            raise ValueError(f"images must be uint8 or float32, got {self.images_u8.dtype}")
        self._images = torch.from_numpy(
            np.ascontiguousarray(self.images_u8.transpose(0, 3, 1, 2))
        ).to(self.device)
        self._members_step = make_members_step(self.tx, self.schedule)

    def init_state(
        self, init_fn: Callable[[int], nn.Module],
        params: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
    ) -> EnsembleState:
        """The stacked state. `init_fn(seed)` builds a module with its
        initial weights drawn from `seed`: one shared seed under common
        noise, one derived seed per member otherwise. `params` (a state
        dict), when given, is loaded into every member instead (sparse
        fine-tuning from one model)."""
        if params is not None:
            model = init_fn(seed)
            model.load_state_dict(params)
            return init_ensemble_state(model.to(self.device), self.tx, self.num_members)
        seeds = [seed if self.common_noise else derived_seed(seed, m)
                 for m in range(self.num_members)]
        return init_ensemble_state(None, self.tx, self.num_members, init_seeds=seeds,
                                   init_fn=lambda s: init_fn(s).to(self.device))

    def _generator(self, *entropy: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(derived_seed(*entropy))

    def _draws(self, gen: torch.Generator):
        """(raw slots, timesteps, noise) for one member-step, in that order."""
        bs, dev = self.batch_size, self.device
        raw = torch.randint(0, _RAW_SLOT_BOUND, (bs,), generator=gen, device=dev)
        t = antithetic_timesteps(gen, bs, self.spec.num_train_timesteps, dev)
        shape = (bs,) + tuple(self._images.shape[1:])
        noise = torch.randn(shape, generator=gen, device=dev)
        return raw, t, noise

    def draws(self, step_seed: int):
        """(raw slots (M, bs), timesteps (M, bs), noise (M, bs, C, H, W)) of
        one ensemble step: member m's from the generator of (step seed,
        1 + m), or, under common noise, one draw that every member shares."""
        m = self.num_members
        if self.common_noise:
            return tuple(x.expand((m,) + x.shape)
                         for x in self._draws(self._generator(step_seed)))
        per_member = [self._draws(self._generator(step_seed, 1 + i)) for i in range(m)]
        return tuple(torch.stack(xs) for xs in zip(*per_member))

    def batch(self, raw: torch.Tensor) -> torch.Tensor:
        """The members' data at slots raw % size, raw (M, bs), as float32
        (M, bs, C, H, W): uint8 pixels mapped to [-1, 1], float32 latents as
        they are."""
        batch = self._images[torch.gather(self._table, 1, raw % self._sizes)]
        return batch.float() / 127.5 - 1.0 if batch.dtype == torch.uint8 else batch

    def step(self, state: EnsembleState, step_seed: int) -> Dict[str, torch.Tensor]:
        """One step of every member, in place; returns {"loss", "grad_norm"},
        each (M,) on the device."""
        raw, t, noise = self.draws(step_seed)
        return self._members_step(state, self.batch(raw), t, noise)

    def run(self, state: EnsembleState, num_steps: int, seed: int = 0,
            log_every: int = 0, log_fn: Optional[Callable] = None):
        """Drive num_steps ensemble steps; returns (state, last metrics).

        `log_fn(metrics, step)` fires every `log_every` steps (0 = never);
        metrics values are (M,) device tensors. Nothing else waits for the
        device."""
        metrics: Optional[Dict[str, torch.Tensor]] = None
        for i in range(num_steps):
            metrics = self.step(state, _step_seed(seed, i))
            if log_fn is not None and log_every and (i + 1) % log_every == 0:
                log_fn(metrics, i + 1)
        return state, metrics

    def run_scanned(self, state: EnsembleState, num_steps: int, seed: int = 0,
                    chunk: int = 0, chunk_fn: Optional[Callable] = None):
        """Like run(), in chunks of `chunk` steps (default: the whole run), the
        counterpart of the JAX trainer's ``lax.scan`` chunks: nothing inside a
        chunk reads back to the host. The per-step seeds are run()'s, so
        run_scanned(s, n) and run(s, n) give identical states. Returns
        (state, metrics) with a leading (num_steps,) axis, (n, M) each;
        `chunk_fn(metrics, end)` sees each chunk's (n_chunk, M) metrics after
        step `end`."""
        chunk = min(chunk or num_steps, num_steps)
        chunks = []
        for start in range(0, num_steps, chunk):
            end = min(start + chunk, num_steps)
            steps = [self.step(state, _step_seed(seed, i)) for i in range(start, end)]
            chunks.append({k: torch.stack([m[k] for m in steps]) for k in steps[0]})
            if chunk_fn is not None:
                chunk_fn(chunks[-1], end)
        return state, {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
