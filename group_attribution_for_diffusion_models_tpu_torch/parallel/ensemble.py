"""The ensemble axis: one model per removal subset, trained side by side.

Port of the JAX package's ``parallel/ensemble.py`` without a mesh. The JAX
trainer stacks the members' states and vmaps one compiled step over them;
here the members are stepped one after another, each a U-Net with its own
optimizer state, and the loop keeps every per-member property plainly true.
Members in the batch are possible: the kernels' autograd Functions have
vmap rules that take a gamma/beta per member, so `torch.func.vmap` over
`stack_module_state` runs one launch a layer for every member. Training
that way, or capturing the step in a CUDA graph, is later work.

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
member), and gets its own initial weights. The streams differ from the JAX
package's threefry streams; what matches is their structure.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config.registry import SchedulerSpec
from ..diffusion.schedulers import ScheduleState, antithetic_timesteps
from ..training.state import Optimizer, TrainState
from ..training.train import make_train_step

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
        self._sizes = [int(s) for s in sizes]
        self._table = torch.from_numpy(table).long().to(self.device)
        if self.images_u8.dtype not in (np.uint8, np.float32):
            raise ValueError(f"images must be uint8 or float32, got {self.images_u8.dtype}")
        self._images = torch.from_numpy(
            np.ascontiguousarray(self.images_u8.transpose(0, 3, 1, 2))
        ).to(self.device)
        self._member_step = make_train_step(self.tx, self.schedule, self.spec)

    def init_state(
        self, init_fn: Callable[[int], nn.Module],
        params: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
    ) -> List[TrainState]:
        """One TrainState per member. `init_fn(seed)` builds a module with its
        initial weights drawn from `seed`: one shared seed under common noise,
        one derived seed per member otherwise. `params` (a state dict), when
        given, is loaded into every member instead (sparse fine-tuning from one
        model)."""
        states = []
        for m in range(self.num_members):
            model = init_fn(seed if self.common_noise else derived_seed(seed, m))
            if params is not None:
                model.load_state_dict(params)
            states.append(TrainState.create(model.to(self.device), self.tx))
        return states

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

    def batch(self, member: int, raw: torch.Tensor) -> torch.Tensor:
        """The member's data at slots raw % size, as float32 NCHW: uint8
        pixels mapped to [-1, 1], float32 latents as they are."""
        idx = self._table[member].index_select(0, raw % self._sizes[member])
        batch = self._images.index_select(0, idx)
        return batch.float() / 127.5 - 1.0 if batch.dtype == torch.uint8 else batch

    def step(self, states: List[TrainState], step_seed: int) -> torch.Tensor:
        """One step of every member; returns the (M,) losses on the device."""
        shared = self._draws(self._generator(step_seed)) if self.common_noise else None
        losses = []
        for m, state in enumerate(states):
            raw, t, noise = shared or self._draws(self._generator(step_seed, 1 + m))
            metrics = self._member_step(state, self.batch(m, raw), timesteps=t, noise=noise)
            losses.append(metrics["loss"])
        return torch.stack(losses)

    def run(self, states: List[TrainState], num_steps: int, seed: int = 0,
            log_every: int = 0, log_fn: Optional[Callable] = None):
        """Drive num_steps ensemble steps; returns (states, last metrics).

        `log_fn(metrics, step)` fires every `log_every` steps (0 = never);
        metrics values are (M,) device tensors. Nothing else waits for the
        device."""
        metrics: Optional[Dict[str, torch.Tensor]] = None
        for i in range(num_steps):
            metrics = {"loss": self.step(states, _step_seed(seed, i))}
            if log_fn is not None and log_every and (i + 1) % log_every == 0:
                log_fn(metrics, i + 1)
        return states, metrics
