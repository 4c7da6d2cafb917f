"""8-bit-state Adam: blockwise int8 storage of the optimizer moments.

Port of the JAX package's ``training/quantized.py``, its counterpart of
bitsandbytes' Adam8bit, which the reference needs to fit 256^2 LDM training
on small GPUs (reference unconditional_generation/main.py:562-588). Each
tensor's moments are stored in blocks of BLOCK = 2048 elements of its
flattened values (the last block zero-padded):

* the first moment as int8 with one f32 absmax scale a block;
* the second moment as int8 codes of log2(v), affine in each block between
  its min and max (254 steps), since v spans orders of magnitude within a
  block and a linear code would zero its small entries.

That is about 2 bytes of state a parameter where Adam keeps 8. Each step
dequantizes a tensor's moments, takes Adam's step in f32 and quantizes them
again. As in the JAX function, the schedule is read at the step count after
it increments, and the first step starts v from an exact zero (the log code
has none), gated on the count.

With a leading member axis (an `EnsembleState`, the JAX package's
``jax.vmap`` of the update over members) each member's tensor is flattened
and cut into blocks of its own: no block spans two members.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 2048
_F32 = np.float32


def _blocks(x: torch.Tensor, members: int) -> torch.Tensor:
    """(M', nb, BLOCK) f32 blocks of each member's flattened values (M' = 1
    without members), the last block zero-padded."""
    flat = x.float().reshape(members or 1, -1)
    return F.pad(flat, (0, (-flat.shape[1]) % BLOCK)).reshape(flat.shape[0], -1, BLOCK)


def _unblocks(blocks: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    n = math.prod(shape) // blocks.shape[0]
    return blocks.reshape(blocks.shape[0], -1)[:, :n].reshape(shape)


def _lead(t: torch.Tensor, members: int) -> torch.Tensor:
    return t if members else t.unsqueeze(0)


def _unlead(t: torch.Tensor, members: int) -> torch.Tensor:
    return t if members else t.squeeze(0)


def quantize(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, f32 scales (..., nb, 1)) of absmax blocks."""
    scales = blocks.abs().amax(-1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scales, min=1e-12)), -127, 127)
    return q.to(torch.int8), scales


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales


def quantize_log(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 codes, lmin, scale) of log2 of non-negative blocks, affine in
    each block. The floor 1e-30 keeps log2 finite and in f32's normal range."""
    lg = torch.log2(torch.clamp(blocks, min=1e-30))
    lmin = lg.amin(-1, keepdim=True)
    scale = torch.clamp((lg.amax(-1, keepdim=True) - lmin) / 254.0, min=1e-8)
    q = torch.round((lg - lmin) / scale) - 127.0
    return q.to(torch.int8), lmin, scale


def dequantize_log(q: torch.Tensor, lmin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.exp2((q.float() + 127.0) * scale + lmin)


@dataclasses.dataclass
class Adam8bitState:
    """The step count and, for each parameter in order, its quantized
    moments: codes (nb, BLOCK) and per-block f32 (nb, 1) tensors, each with
    a leading member axis in an `EnsembleState`."""

    count: int
    mu_q: List[torch.Tensor]
    mu_scale: List[torch.Tensor]
    nu_q: List[torch.Tensor]
    nu_lmin: List[torch.Tensor]
    nu_scale: List[torch.Tensor]

    def slots(self) -> Dict[str, List[torch.Tensor]]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "count"}


@torch.no_grad()
def adam8bit_init(params: List[torch.Tensor], members: int = 0) -> Adam8bitState:
    """The state of zero moments, quantized as the JAX function quantizes
    them."""
    state = Adam8bitState(0, [], [], [], [], [])
    for p in params:
        zeros = _blocks(torch.zeros_like(p, dtype=torch.float32), members)
        q, s = quantize(zeros)
        qv, lmin, sv = quantize_log(zeros)
        for slot, t in zip((state.mu_q, state.mu_scale, state.nu_q, state.nu_lmin,
                            state.nu_scale), (q, s, qv, lmin, sv)):
            slot.append(_unlead(t, members))
    return state


@torch.no_grad()
def adam8bit_update(grads: List[torch.Tensor], state: Adam8bitState,
                    params: List[torch.Tensor], schedule: Callable[[int], np.float32],
                    members: int = 0, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> None:
    """One step of Adam on the quantized moments, applied to `params` in
    place (`grads` already clipped and signed by the chain before it)."""
    first = state.count == 0
    state.count += 1
    lr = _F32(schedule(state.count))
    b1c = float(_F32(1.0) - _F32(b1) ** _F32(state.count))
    b2c = float(_F32(1.0) - _F32(b2) ** _F32(state.count))
    for i, (g, p) in enumerate(zip(grads, params)):
        qm, sm = _lead(state.mu_q[i], members), _lead(state.mu_scale[i], members)
        m = dequantize(qm, sm)
        if first:
            v = torch.zeros_like(m)
        else:
            v = dequantize_log(_lead(state.nu_q[i], members), _lead(state.nu_lmin[i], members),
                               _lead(state.nu_scale[i], members))
        gb = _blocks(g, members)
        m = b1 * m + (1 - b1) * gb
        v = b2 * v + (1 - b2) * gb * gb
        upd = -float(lr) * (m / b1c) / (torch.sqrt(v / b2c) + eps)
        p.add_(_unblocks(upd, p.shape).to(p.dtype))
        n = g.numel() // gb.shape[0]
        # The padding re-enters the codes as exact zeros, as the JAX function
        # pads the unpadded moments again.
        m.view(m.shape[0], -1)[:, n:] = 0.0
        v.view(v.shape[0], -1)[:, n:] = 0.0
        q, s = quantize(m)
        qv, lmin, sv = quantize_log(v)
        for slot, t in zip((state.mu_q, state.mu_scale, state.nu_q, state.nu_lmin,
                            state.nu_scale), (q, s, qv, lmin, sv)):
            slot[i] = _unlead(t, members)
