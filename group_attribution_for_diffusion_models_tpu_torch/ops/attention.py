"""Scaled dot-product attention on (B, S, H, D): CUDA kernels, plain versions
and the autograd Function that joins them.

Port of the Pallas kernels of the JAX package's ``ops/attention.py``: the
forward (``_flash_kernel``, ``_hp_fwd_kernel``) in ``csrc/attention.cu`` and
the backward's two passes (``_flash_bwd_dq_kernel``/``_hp_bwd_dq_kernel``,
``_flash_bwd_dkv_kernel``/``_hp_bwd_dkv_kernel``) in
``csrc/attention_bwd.cu``. Each CUDA kernel serves both TPU layouts by
reading strides. The JAX package routes each shape between Pallas and XLA
through a table measured on a TPU; here the kernels are the path for every
CUDA tensor they take, in both directions. The one shape rule kept is the
JAX package's own (``pallas_ok = d % 8 == 0 and d <= 256``): a head dim the
kernels do not take (the VQ-VAE's mid attention, one head of 512) goes to
XLA there and to the plain f32 version on the card here, in both directions,
through `attention_plain_route` and `attention_bwd_plain_route`, which count
their calls. That is a route chosen by shape, not a fallback: no kernel
error is caught, and a shape the kernels take never reaches it.

`dot_product_attention` is a `torch.autograd.Function` that saves only
(q, k, v), as the JAX ``custom_vjp`` does, and recomputes the softmax in the
backward. Its forward and backward each take the plain PyTorch version for a
CPU tensor and the kernel for a CUDA tensor; there is no fallback between
them. Under autocast both compute in f32 from the inputs' dtype, as the
kernels do. Forward and backward are each a Function with a `vmap` rule, so
``torch.func.vmap(torch.func.grad(f))`` (TRAK's per-sample gradients, the
JAX package's ``jax.vmap(jax.grad(f))``) runs the same kernels, one launch
for the whole vmapped batch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reference softmax(Q K^T / sqrt(D)) V in f32, returned in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention_bwd_dq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference dQ pass in f32: (dq, lse, delta) with lse = logsumexp of the
    scores and delta = rowsum(dO * O), both (B, H, Sq); dq in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    delta = (o * gf).sum(-1).permute(0, 2, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq.to(q.dtype), lse, delta


def attention_bwd_dkv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference dK/dV pass in f32 from the dQ pass's lse and delta:
    P = exp(S - lse), dS = P (dP - delta), dk = dS^T Q / sqrt(D), dv = P^T dO."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference (dq, dk, dv) of `attention_plain` for the upstream gradient
    `do`: the two passes above, in f32, returned in the inputs' dtypes."""
    dq, lse, delta = attention_bwd_dq_plain(q, k, v, do)
    dk, dv = attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    return dq, dk, dv


def kernel_takes(d: int) -> bool:
    """Whether the kernels take head dim `d` (the JAX package's `pallas_ok`)."""
    return d % 8 == 0 and d <= 256


def _check_plain_route(q: torch.Tensor) -> None:
    if kernel_takes(q.shape[-1]) or not q.is_cuda:
        raise ValueError(f"the plain route is for CUDA tensors whose head dim the kernels "
                         f"do not take, got D={q.shape[-1]} on {q.device}")


def attention_plain_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The forward on the card for a head dim the kernels do not take: the plain
    f32 version, the counterpart of the JAX package's ``_xla_attention``."""
    _check_plain_route(q)
    attention_plain_route.launches += 1
    return attention_plain(q, k, v)


attention_plain_route.launches = 0


def attention_bwd_plain_route(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card for a head dim the kernels do not take: the
    plain f32 version (the vjp of ``_xla_attention``)."""
    _check_plain_route(q)
    attention_bwd_plain_route.launches += 1
    return attention_bwd_plain(q, k, v, do)


attention_bwd_plain_route.launches = 0


def _bind(source: str, symbol: str, pointers: int, ints: int):
    lib = _build.load(source)
    fn = getattr(lib, symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * pointers
        + [ctypes.c_int] * ints
        + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _fwd_fn():
    return _bind("attention", "gadm_attention_fwd", 4, 6)


@functools.cache
def _bwd_dq_fn():
    return _bind("attention_bwd", "gadm_attention_bwd_dq", 7, 6)


@functools.cache
def _bwd_dkv_fn():
    return _bind("attention_bwd", "gadm_attention_bwd_dkv", 8, 6)


def _checked(name, q, k, v, *more):
    """Validate (B, Sq, H, D) q and (B, Skv, H, D) k/v (plus tensors shaped
    like q in `more`) for a kernel; returns them with unit stride on D."""
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise ValueError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: gradient shape must be q's {tuple(q.shape)}")
    if not kernel_takes(d):
        raise ValueError(f"head dim {d} must be a multiple of 8 and at most 256")
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *more))):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    return tuple(t if t.stride(-1) == 1 and _rows_aligned(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (q, k, v, *more))


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether every (b, s, h) row of `t` starts on 16 bytes, as the kernels'
    16-byte copies need (a stride over a size-1 dimension is unused)."""
    es, shape, stride = t.element_size(), t.shape, t.stride()
    return t.data_ptr() % 16 == 0 and all(
        stride[i] * es % 16 == 0 for i in range(3) if shape[i] > 1)


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The CUDA attention forward kernel. q: (B, Sq, H, D), k/v: (B, Skv, H, D),
    all on one CUDA device in float32 or bfloat16, D % 8 == 0 and D <= 256."""
    q, k, v = _checked("attention_kernel", q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib, fn = _fwd_fn()
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, h, sq, k.shape[1], d, _strides(q, k, v), 1.0 / math.sqrt(d), q.device.index,
        _stream(q),
    )
    _build.check(lib, err, "attention forward kernel")
    attention_kernel.launches += 1
    return out


attention_kernel.launches = 0


def attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA dQ pass: (dq, lse, delta), lse and delta of shape (B, H, Sq)
    in f32. Takes what `attention_kernel` takes, and `do` shaped like q."""
    q, k, v, do = _checked("attention_bwd_dq", q, k, v, do)
    b, sq, h, d = q.shape
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib, fn = _bwd_dq_fn()
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype], b, h, sq, k.shape[1], d,
        _strides(q, k, v, do), 1.0 / math.sqrt(d), q.device.index, _stream(q),
    )
    _build.check(lib, err, "attention backward dQ kernel")
    attention_bwd_dq.launches += 1
    return dq, lse, delta


attention_bwd_dq.launches = 0


def attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA dK/dV pass: (dk, dv), from the dQ pass's lse and delta."""
    q, k, v, do = _checked("attention_bwd_dkv", q, k, v, do)
    b, sq, h, d = q.shape
    want = (b, h, sq)
    for t in (lse, delta):
        if t.shape != want or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"lse/delta must be float32 {want} on {q.device}")
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    lib, fn = _bwd_dkv_fn()
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, h, sq,
        k.shape[1], d, _strides(q, k, v, do), 1.0 / math.sqrt(d), q.device.index,
        _stream(q),
    )
    _build.check(lib, err, "attention backward dK/dV kernel")
    attention_bwd_dkv.launches += 1
    return dk, dv


attention_bwd_dkv.launches = 0


def attention_bwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through both CUDA backward passes."""
    dq, lse, delta = attention_bwd_dq(q, k, v, do)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


def fold_vmapped(info, in_dims, *tensors):
    """For a `vmap` rule: each tensor with its vmapped dimension moved to the
    front and merged into its batch dimension, (Bv, B, ...) -> (Bv*B, ...).
    A tensor that is not vmapped (in_dim None) is broadcast over Bv first."""
    out = []
    for t, dim in zip(tensors, in_dims):
        t = t.expand(info.batch_size, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.reshape(-1, *t.shape[2:]))
    return out


def unfold_vmapped(info, t: torch.Tensor) -> torch.Tensor:
    """(Bv*B, ...) -> (Bv, B, ...): the inverse of `fold_vmapped`."""
    return t.reshape(info.batch_size, -1, *t.shape[1:])


class _Attention(torch.autograd.Function):
    """softmax(QK^T/sqrt(D))V, transformable by torch.func: under `vmap` the
    vmapped dimension is folded into the batch, so one kernel launch serves
    every sample, and the backward is `_AttentionBackward`, which has its own
    `vmap` rule, so `vmap(grad(f))` runs the backward kernels too."""

    @staticmethod
    def forward(q, k, v):
        with torch.autocast(q.device.type, enabled=False):  # f32 inside, as the kernel
            if q.device.type == "cpu":
                return attention_plain(q, k, v)
            if not kernel_takes(q.shape[-1]):
                return attention_plain_route(q, k, v)
            return attention_kernel(q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, do):
        return _AttentionBackward.apply(*ctx.saved_tensors, do)

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        out = _Attention.apply(*fold_vmapped(info, in_dims, q, k, v))
        return unfold_vmapped(info, out), 0


class _AttentionBackward(torch.autograd.Function):
    """(dq, dk, dv) of `_Attention` for the upstream gradient `do`: both
    backward kernels on a CUDA tensor, the plain version on a CPU tensor."""

    @staticmethod
    def forward(q, k, v, do):
        if q.device.type == "cpu":
            return attention_bwd_plain(q, k, v, do)
        if not kernel_takes(q.shape[-1]):
            return attention_bwd_plain_route(q, k, v, do)
        return attention_bwd_kernel(q, k, v, do.to(q.dtype))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, do):
        grads = _AttentionBackward.apply(*fold_vmapped(info, in_dims, q, k, v, do))
        return tuple(unfold_vmapped(info, g) for g in grads), (0, 0, 0)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Scaled dot-product attention on (B, S, H, D), differentiable and
    transformable by torch.func (`vmap`, `grad`): the CUDA kernels for CUDA
    tensors (the plain route for a head dim they do not take), the plain
    versions for CPU tensors."""
    return _Attention.apply(q, k, v)
