"""Train state, EMA update and the optimizer, with optax's semantics.

Port of the JAX package's ``training/state.py``. There the whole state is
one pytree; here `TrainState` holds the U-Net module (its parameters are
trained in place), the EMA shadow and the optimizer state of one model.
`EnsembleState` is the JAX package's stacked TrainState (its
``parallel/ensemble.py``): M members' parameters, EMA shadows and Adam
moments with a leading member axis, built by `stack_states` or
`init_ensemble_state` and taken apart by `unstack_state`. The optimizer
updates it in one pass; its clip takes each member's own global norm.

`make_optimizer` builds the chain the JAX package builds with optax: global-
norm clip, an optional sign flip (``maximize``, gradient-ascent unlearning),
then Adam, AdamW, Adafactor (``optax.adafactor`` at its defaults) or 8-bit
Adam (`training.quantized`) under a constant, warmup or warmup-cosine
schedule. It follows optax's formulas, not ``torch.optim``'s: the clip
scales by max_norm / ||g|| with no epsilon (``clip_grad_norm_`` adds 1e-6 to
the norm), the update is mu_hat / (sqrt(nu_hat) + eps), and a schedule is
read at the step count before it increments (warmup step 0 has lr 0; 8-bit
Adam reads it after, as its JAX function does). Schedule values and bias
corrections are computed on the host in float32, as optax computes them on
the device. Each optimizer's state names its tensors (`slots`), which
checkpoints save and `stack_states` stacks. With a member axis, Adafactor
factors and clips each member's tensor alone and 8-bit Adam quantizes it in
blocks of its own, as ``jax.vmap`` of the optax update does.

EMA semantics match diffusers EMAModel (`ema_decay_schedule`); the train
step calls it with use_warmup=False, as the JAX step and the reference do:
per-step decay min(max_decay, (1+step)/(10+step)), where inv_gamma and
power have no effect.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_F32 = np.float32
EMA_MAX_DECAY = 0.9999
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def ema_decay_schedule(step: int, max_decay: float = EMA_MAX_DECAY, use_warmup: bool = False,
                       inv_gamma: float = 1.0, power: float = 0.75) -> np.float32:
    """Per-step EMA decay (diffusers EMAModel.get_decay), in float32:
    1 - (1 + step / inv_gamma) ** -power with `use_warmup`, else
    (1 + step) / (10 + step); clipped to [0, max_decay]."""
    step_f = max(_F32(step), _F32(0.0))
    if use_warmup:
        decay = _F32(1.0) - (_F32(1.0) + step_f / _F32(inv_gamma)) ** -_F32(power)
    else:
        decay = (_F32(1.0) + step_f) / (_F32(10.0) + step_f)
    return _F32(min(max(decay, _F32(0.0)), _F32(max_decay)))


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], decay) -> None:
    """Polyak update ema <- ema - (1 - decay) (ema - params), in place."""
    diff = torch._foreach_sub(ema, params)
    torch._foreach_mul_(diff, float(_F32(1.0) - _F32(decay)))
    torch._foreach_sub_(ema, diff)


def _linear(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule (polynomial, power 1) in float32."""

    def schedule(count: int) -> np.float32:
        c = _F32(min(max(count, 0), steps)) if steps > 0 else _F32(0.0)
        frac = _F32(1.0) - c / _F32(steps) if steps > 0 else _F32(1.0)
        return _F32(_F32(init - end) * frac + _F32(end))

    return schedule


def _cosine(init: float, decay_steps: int) -> Callable[[int], np.float32]:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1, in float32."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> np.float32:
        c = _F32(min(count, decay_steps))
        cosine = _F32(0.5) * (_F32(1.0) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        return _F32(_F32(init) * cosine)

    return schedule


def make_schedule_fn(
    lr: float, lr_schedule: str = "constant", total_steps: int = 0, warmup_steps: int = 0
) -> Callable[[int], np.float32]:
    """Learning rate as a function of the step count (the JAX package's
    choices of optax schedule)."""
    if lr_schedule == "constant":
        if warmup_steps:
            return _linear(0.0, lr, warmup_steps)
        return lambda count: _F32(lr)
    if lr_schedule == "cosine":
        warm = _linear(0.0 if warmup_steps else lr, lr, warmup_steps)
        cos = _cosine(lr, max(total_steps, 1) - warmup_steps)
        return lambda count: warm(count) if count < warmup_steps else cos(count - warmup_steps)
    raise ValueError(f"unknown lr_schedule {lr_schedule!r}")


@dataclasses.dataclass
class OptState:
    """Adam moments and the shared step count of the chain's stateful parts."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]

    def slots(self) -> Dict[str, List[torch.Tensor]]:
        return {"mu": self.mu, "nu": self.nu}


ADAFACTOR_DECAY, ADAFACTOR_EPS = 0.8, 1e-30  # optax.adafactor's defaults
ADAFACTOR_MIN_DIM, ADAFACTOR_CLIP, ADAFACTOR_MIN_SCALE = 128, 1.0, 1e-3


@dataclasses.dataclass
class FactoredState:
    """Adafactor's second moments a parameter: row and column statistics of
    a factored tensor ((1,) tensors for v), or the full v of one that is not
    ((1,) tensors for the rows and columns), as optax's FactoredState."""

    count: int
    v_row: List[torch.Tensor]
    v_col: List[torch.Tensor]
    v: List[torch.Tensor]

    def slots(self) -> Dict[str, List[torch.Tensor]]:
        return {"v_row": self.v_row, "v_col": self.v_col, "v": self.v}


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (second largest, largest) axis of a
    tensor of at least 2 axes whose second largest is at least
    ADAFACTOR_MIN_DIM, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor_init(params: List[torch.Tensor], members: int) -> FactoredState:
    state = FactoredState(0, [], [], [])
    lead = (members,) if members else ()
    for p in params:
        shape = tuple(p.shape[1:] if members else p.shape)
        dims = factored_dims(shape)
        one = p.new_zeros(lead + (1,))
        if dims is None:
            state.v_row.append(one)
            state.v_col.append(one.clone())
            state.v.append(torch.zeros_like(p))
        else:
            d1, d0 = dims
            state.v_row.append(p.new_zeros(lead + tuple(np.delete(shape, d0))))
            state.v_col.append(p.new_zeros(lead + tuple(np.delete(shape, d1))))
            state.v.append(one)
    return state


def _adafactor_update(grads: List[torch.Tensor], state: FactoredState,
                      params: List[torch.Tensor], schedule: Callable[[int], np.float32],
                      members: int) -> None:
    """optax.adafactor(schedule) at its defaults, in place: factored RMS
    scaling, the block-RMS clip at 1, the learning rate, the scale by each
    parameter block's RMS (at least 1e-3), descent. `members` > 0: each
    member's slice of a tensor is its own block."""
    decay = float(_F32(1.0) - _F32(state.count + 1) ** _F32(-ADAFACTOR_DECAY))
    lr = float(_F32(schedule(state.count)))
    k = 1 if members else 0  # the first axis of a member's own tensor

    def block_rms(x: torch.Tensor) -> torch.Tensor:
        if not members:
            return torch.sqrt(torch.mean(x * x))
        return torch.sqrt(torch.mean((x * x).flatten(1), dim=1)).view(
            (-1,) + (1,) * (x.ndim - 1))

    for i, (g, p) in enumerate(zip(grads, params)):
        dims = factored_dims(tuple(p.shape[k:]))
        g2 = g * g + ADAFACTOR_EPS
        if dims is None:
            v = state.v[i].mul_(decay).add_((1.0 - decay) * g2)
            u = g * v ** -0.5
        else:
            d1, d0 = dims[0] + k, dims[1] + k
            v_row = state.v_row[i].mul_(decay).add_((1.0 - decay) * g2.mean(d0))
            v_col = state.v_col[i].mul_(decay).add_((1.0 - decay) * g2.mean(d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        u = u / torch.clamp(block_rms(u) / ADAFACTOR_CLIP, min=1.0)
        rms = block_rms(p)
        scale = torch.where(rms <= ADAFACTOR_MIN_SCALE, torch.full_like(rms, ADAFACTOR_MIN_SCALE),
                            rms)
        p.sub_((lr * u) * scale)
    state.count += 1


@dataclasses.dataclass
class Optimizer:
    """clip -> [scale(-1)] -> adam/adamw/adafactor/adam8bit, as optax
    chains them. `update` applies the update to the parameters in place,
    where optax returns it."""

    name: str
    schedule: Callable[[int], np.float32]
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    maximize: bool = False

    def init(self, params: List[torch.Tensor], members: int = 0):
        """The zero state of `params`; `members` > 0 when they carry a
        leading member axis of that size (Adafactor and 8-bit Adam lay out
        their state by member)."""
        if self.name == "adafactor":
            return _adafactor_init(params, members)
        if self.name == "adam8bit":
            from .quantized import adam8bit_init

            return adam8bit_init(params, members)
        return OptState(
            count=0,
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor], members: int = 0) -> Optional[torch.Tensor]:
        """One step. Overwrites `grads` with the clipped gradients and returns
        their global norm before the clip (None when nothing is clipped).

        With `members` > 0 every tensor carries a leading member axis of that
        size (an `EnsembleState`), as under ``jax.vmap`` of the optax chain:
        each member is clipped by its own global norm, an (M,) vector that
        is returned. The schedule and the bias corrections stay shared host
        values: every member steps together."""
        norm = None
        if self.grad_clip_norm is not None:
            norm = global_norm(grads, members)
            clip = norm >= self.grad_clip_norm  # optax: select(norm < max, g, g / norm * max)
            one = torch.ones_like(norm)
            div = torch.where(clip, norm, one)
            mul = torch.where(clip, one * self.grad_clip_norm, one)
            if members:  # each member's factor, broadcast over its slice of every tensor
                div, mul = ([x.view((members,) + (1,) * (g.ndim - 1)) for g in grads]
                            for x in (div, mul))
            torch._foreach_div_(grads, div)
            torch._foreach_mul_(grads, mul)
        if self.maximize:
            torch._foreach_neg_(grads)
        if self.name == "adafactor":
            _adafactor_update(grads, state, params, self.schedule, members)
            return norm
        if self.name == "adam8bit":
            from .quantized import adam8bit_update

            adam8bit_update(grads, state, params, self.schedule, members)
            return norm
        torch._foreach_mul_(state.mu, ADAM_B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(state.nu, ADAM_B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - ADAM_B2)
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = _F32(1.0) - _F32(ADAM_B1) ** _F32(state.count)
        bc2 = _F32(1.0) - _F32(ADAM_B2) ** _F32(state.count)
        update = torch._foreach_div(state.mu, float(bc1))
        denom = torch._foreach_div(state.nu, float(bc2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        torch._foreach_div_(update, denom)
        if self.name == "adamw":
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_mul_(update, float(-_F32(lr)))
        torch._foreach_add_(params, update)
        return norm


def global_norm(tensors: List[torch.Tensor], members: int = 0) -> torch.Tensor:
    """The global L2 norm of `tensors` (0-d); with `members` > 0, of each
    member's slices along the leading axis ((M,), not one norm of the
    stack)."""
    if not members:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.flatten(1), dim=1) for t in tensors]), dim=0)


def make_optimizer(
    name: str = "adam",
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    grad_clip_norm: Optional[float] = 1.0,
    lr_schedule: str = "constant",
    total_steps: int = 0,
    warmup_steps: int = 0,
    maximize: bool = False,
) -> Optimizer:
    """The optimizer of the JAX package's `make_optimizer`: `adam`,
    `adamw`, `adafactor` or `adam8bit` (its `flat` option only regroups
    optax's leaves: not needed). Weight decay is AdamW's alone."""
    if name not in ("adam", "adamw", "adafactor", "adam8bit"):
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(
        name=name,
        schedule=make_schedule_fn(lr, lr_schedule, total_steps, warmup_steps),
        weight_decay=weight_decay if name == "adamw" else 0.0,
        grad_clip_norm=grad_clip_norm,
        maximize=maximize,
    )


@dataclasses.dataclass
class TrainState:
    """One model's training state: the module (parameters trained in place),
    the EMA shadow in the module's parameter order, the optimizer state and
    the step count."""

    model: nn.Module
    ema: List[torch.Tensor]
    opt_state: OptState
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> "TrainState":
        params = [p for p in model.parameters()]
        return cls(model=model, ema=[p.detach().clone() for p in params],
                   opt_state=tx.init(params), step=0)

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    def state_dicts(self):
        """(params, ema_params) as state dicts keyed like the module's."""
        names = [n for n, _ in self.model.named_parameters()]
        params: Dict[str, torch.Tensor] = {
            n: p.detach() for n, p in self.model.named_parameters()
        }
        return params, dict(zip(names, self.ema))


@dataclasses.dataclass
class EnsembleState:
    """M members' training state on a leading member axis: parameters and
    buffers by state-dict name (the parameters are the leaves the step
    differentiates and updates in place), the EMA shadows and the optimizer
    state in parameter order, and one count and step for all of them, as in
    the JAX package's stacked TrainState. `model` gives the architecture
    only (`models.unet2d.members_forward`); its own tensors are on the meta
    device."""

    model: nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    ema: List[torch.Tensor]
    opt_state: OptState
    step: int = 0

    @property
    def num_members(self) -> int:
        return next(iter(self.params.values())).shape[0]

    def weights(self) -> Dict[str, torch.Tensor]:
        """Parameters and buffers, the mapping `members_forward` takes."""
        return {**self.params, **self.buffers}


def stack_states(states: Sequence[TrainState]) -> EnsembleState:
    """Stack per-member TrainStates of one architecture along a new leading
    member axis (copies; the states are left as they were)."""
    first = states[0]
    if any((s.step, s.opt_state.count) != (first.step, first.opt_state.count) for s in states):
        raise ValueError("stacked members must share their step and optimizer count")
    params, buffers = torch.func.stack_module_state([s.model for s in states])
    params = {n: p.requires_grad_(True) for n, p in params.items()}

    def stack(lists):
        return [torch.stack(xs) for xs in zip(*lists)]

    opt = first.opt_state
    slots = {name: stack([s.opt_state.slots()[name] for s in states]) for name in opt.slots()}
    return EnsembleState(
        model=copy.deepcopy(first.model).to("meta"), params=params, buffers=buffers,
        ema=stack([s.ema for s in states]),
        opt_state=type(opt)(count=opt.count, **slots), step=first.step)


@torch.no_grad()
def unstack_state(stacked: EnsembleState, member: int) -> TrainState:
    """Member `member`'s TrainState, a module of its own (copies)."""
    weights = stacked.weights()
    device = next(iter(weights.values())).device
    model = copy.deepcopy(stacked.model).to_empty(device=device)
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        t.copy_(weights[name][member])
    opt = stacked.opt_state
    slots = {name: [x[member].clone() for x in xs] for name, xs in opt.slots().items()}
    return TrainState(
        model=model, ema=[e[member].clone() for e in stacked.ema],
        opt_state=type(opt)(count=opt.count, **slots), step=stacked.step)


def init_ensemble_state(params: Optional[nn.Module], tx: Optimizer, num_members: int,
                        init_seeds: Optional[Sequence[int]] = None,
                        init_fn: Optional[Callable[[int], nn.Module]] = None) -> EnsembleState:
    """Stacked state of `num_members` members: with `init_fn`, member m's
    module is `init_fn(init_seeds[m])` (independent retrains; a seed given
    twice is built once); else every member starts from a copy of the one
    module `params` (sparse fine-tuning from one pruned model)."""
    if init_fn is not None:
        if not init_seeds:
            raise ValueError("init_fn requires init_seeds")
        built: Dict[int, TrainState] = {}
        for s in init_seeds:
            if s not in built:
                built[s] = TrainState.create(init_fn(s), tx)
        return stack_states([built[s] for s in init_seeds])
    return stack_states([TrainState.create(params, tx)] * num_members)
