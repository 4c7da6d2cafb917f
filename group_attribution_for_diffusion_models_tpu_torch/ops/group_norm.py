"""GroupNorm(+SiLU) on NCHW: CUDA kernels, plain versions and the autograd
Function that joins them.

Port of the Pallas kernels of the JAX package's ``ops/group_norm.py``: the
forward ``_fwd_kernel`` (``csrc/group_norm.cu``: f32 group statistics with
var = E[x^2] - mean^2, (x - mean) * rstd * gamma + beta, an optional SiLU,
the output in ``out_dtype``, and mean/rstd of shape (B, G) in f32) and the
backward ``_bwd_kernel`` (``csrc/group_norm_bwd.cu``: dx in x's dtype and
per-(sample, channel) partial dgamma/dbeta in f32, which the autograd
Function sums over the batch). The JAX package keeps its kernels opt-in on
the TPU; here they are the path for every CUDA tensor, in both directions.

`group_norm_silu` is a `torch.autograd.Function` that saves
(x, gamma, beta, mean, rstd), as the JAX ``custom_vjp`` does. Its forward
and backward each take the plain PyTorch version for a CPU tensor and the
kernel for a CUDA tensor; there is no fallback between them. Forward and
backward each have a `vmap` rule, so ``torch.func.vmap(torch.func.grad(f))``
runs the kernels, and the backward kernel's per-(sample, channel) dgamma and
dbeta partials become the per-sample gradients of gamma and beta.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .attention import fold_vmapped, unfold_vmapped

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def group_norm_silu_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
    eps: float, silu: bool, out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference (out, mean, rstd) for x of shape (B, C, *spatial)."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1)
    var = (xf * xf).mean(dim=-1) - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.ndim - 2)
    y = y * gamma.float().reshape(bshape) + beta.float().reshape(bshape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(out_dtype), mean, rstd


def group_norm_silu_bwd_plain(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, groups: int, silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference (dx, dgamma, dbeta) for x of shape (B, C, *spatial), the
    upstream gradient `dy` and the forward's (B, G) mean/rstd, following
    ``_bwd_kernel``: dx in x's dtype; dgamma and dbeta in f32, per (sample,
    channel), of shape (B, C)."""
    b, c = x.shape[:2]
    cshape = (1, c) + (1,) * (x.ndim - 2)

    def per_channel(t):  # (B, G) -> broadcastable over (B, C, *spatial)
        return t.reshape(b, groups, 1).expand(b, groups, c // groups).reshape(
            (b, c) + (1,) * (x.ndim - 2))

    gam = gamma.float().reshape(cshape)
    xhat = (x.float() - per_channel(mean)) * per_channel(rstd)
    g = dy.float()
    if silu:
        y = xhat * gam + beta.float().reshape(cshape)
        sig = torch.sigmoid(y)
        g = g * sig * (1.0 + y * (1.0 - sig))
    spatial = tuple(range(2, x.ndim))
    dgamma = (g * xhat).sum(dim=spatial)
    dbeta = g.sum(dim=spatial)
    dyg = g * gam
    n = x[0].numel() // groups
    m1 = dyg.reshape(b, groups, -1).sum(-1) / n
    m2 = (dyg * xhat).reshape(b, groups, -1).sum(-1) / n
    dx = (dyg.reshape(b, groups, -1) - m1[..., None]
          - xhat.reshape(b, groups, -1) * m2[..., None]) * rstd[..., None]
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


@functools.cache
def _fwd_fn():
    lib = _build.load("group_norm")
    fn = lib.gadm_group_norm_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_fn():
    lib = _build.load("group_norm_bwd")
    fn = lib.gadm_group_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def group_norm_kernel(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
    eps: float, silu: bool, out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA GroupNorm(+SiLU) forward kernel: (out, mean, rstd) for x of
    shape (B, C, *spatial) on a CUDA device, float32 or bfloat16."""
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"group_norm_kernel takes float32 or bfloat16, got "
                         f"{x.dtype} -> {out_dtype}")
    b, c = x.shape[:2]
    if c % groups or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"channels {c}, groups {groups}, gamma {tuple(gamma.shape)}")
    if not x.is_cuda:
        raise ValueError("group_norm_kernel needs a CUDA tensor")
    x = x.contiguous()
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    lib, fn = _fwd_fn()
    err = fn(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), _DTYPES[x.dtype], _DTYPES[out_dtype],
        b, c, x[0, 0].numel(), groups, eps, int(silu), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "group norm forward kernel")
    group_norm_kernel.launches += 1
    return out, mean, rstd


group_norm_kernel.launches = 0


def group_norm_bwd_kernel(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, groups: int, silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA GroupNorm(+SiLU) backward kernel: (dx, dgamma, dbeta) as
    `group_norm_silu_bwd_plain` returns them, dgamma/dbeta per (sample,
    channel). dy is taken in x's dtype, as the JAX rule casts it."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"group_norm_bwd_kernel takes float32 or bfloat16, got {x.dtype}")
    b, c = x.shape[:2]
    if c % groups or gamma.shape != (c,) or beta.shape != (c,) or dy.shape != x.shape:
        raise ValueError(f"channels {c}, groups {groups}, gamma {tuple(gamma.shape)}, "
                         f"dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    if mean.shape != (b, groups) or rstd.shape != (b, groups):
        raise ValueError(f"mean/rstd must be ({b}, {groups})")
    if not (x.is_cuda and dy.device == x.device):
        raise ValueError("group_norm_bwd_kernel needs x and dy on one CUDA device")
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    gamma, beta, mean, rstd = (
        t.to(device=x.device, dtype=torch.float32).contiguous()
        for t in (gamma, beta, mean, rstd)
    )
    dx = torch.empty_like(x)
    dgamma_p = torch.empty((b, c), dtype=torch.float32, device=x.device)
    dbeta_p = torch.empty_like(dgamma_p)
    lib, fn = _bwd_fn()
    err = fn(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dgamma_p.data_ptr(), dbeta_p.data_ptr(),
        _DTYPES[x.dtype], b, c, x[0, 0].numel(), groups, int(silu), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "group norm backward kernel")
    group_norm_bwd_kernel.launches += 1
    return dx, dgamma_p, dbeta_p


group_norm_bwd_kernel.launches = 0


def group_norm_silu_forward(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, groups: int = 32,
    eps: float = 1e-6, silu: bool = True, out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, mean, rstd), not differentiable: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. out_dtype defaults to x's."""
    out_dtype = out_dtype or x.dtype
    if x.shape[1] % groups:
        raise ValueError(f"channels {x.shape[1]} not divisible by groups {groups}")
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, groups, eps, silu, out_dtype)
    return group_norm_kernel(x, gamma, beta, groups, eps, silu, out_dtype)


class _GroupNormSiLU(torch.autograd.Function):
    """GroupNorm(+SiLU) returning (out, mean, rstd), transformable by
    torch.func: under `vmap` the vmapped dimension is folded into the batch
    (one launch for every sample), and the backward is
    `_GroupNormSiLUBackward`, which has its own `vmap` rule."""

    @staticmethod
    def forward(x, gamma, beta, groups, eps, silu, out_dtype):
        with torch.autocast(x.device.type, enabled=False):  # f32 statistics
            return group_norm_silu_forward(
                x, gamma, beta, groups=groups, eps=eps, silu=silu, out_dtype=out_dtype
            )

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, groups, _, silu, _ = inputs
        _, mean, rstd = output
        ctx.mark_non_differentiable(mean, rstd)
        ctx.set_materialize_grads(False)  # no zero gradients made for mean/rstd
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.groups, ctx.silu = groups, silu

    @staticmethod
    def backward(ctx, dout, _dmean, _drstd):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = _GroupNormSiLUBackward.apply(
            x, dout.to(x.dtype), gamma, beta, mean, rstd, ctx.groups, ctx.silu)
        # Per-(sample, channel) partials summed over the batch: under vmap,
        # over each vmapped sample's own batch.
        return (dx, dgamma.sum(dim=0).to(gamma.dtype), dbeta.sum(dim=0).to(beta.dtype),
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, gamma, beta, groups, eps, silu, out_dtype):
        _vmapped_affine_unsupported(in_dims[1:3])
        (xf,) = fold_vmapped(info, in_dims[:1], x)
        out = _GroupNormSiLU.apply(xf, gamma, beta, groups, eps, silu, out_dtype)
        return tuple(unfold_vmapped(info, t) for t in out), (0, 0, 0)


class _GroupNormSiLUBackward(torch.autograd.Function):
    """(dx, dgamma, dbeta) of `_GroupNormSiLU`, dgamma/dbeta per (sample,
    channel): the backward kernel on a CUDA tensor, the plain version on a
    CPU tensor. Under `vmap` (per-sample gradients: x and dy vmapped, gamma
    and beta shared) the partials of every vmapped sample come from one
    launch, (Bv, B, C), which `_GroupNormSiLU.backward` sums over B."""

    @staticmethod
    def forward(x, dy, gamma, beta, mean, rstd, groups, silu):
        args = (x, dy, gamma, beta, mean, rstd, groups, silu)
        if x.device.type == "cpu":
            return group_norm_silu_bwd_plain(*args)
        return group_norm_bwd_kernel(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("group norm has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, dy, gamma, beta, mean, rstd, groups, silu):
        _vmapped_affine_unsupported(in_dims[2:4])
        xf, dyf, meanf, rstdf = fold_vmapped(
            info, (in_dims[0], in_dims[1], in_dims[4], in_dims[5]), x, dy, mean, rstd)
        out = _GroupNormSiLUBackward.apply(xf, dyf, gamma, beta, meanf, rstdf, groups, silu)
        return tuple(unfold_vmapped(info, t) for t in out), (0, 0, 0)


def _vmapped_affine_unsupported(affine_dims) -> None:
    if any(d is not None for d in affine_dims):
        raise NotImplementedError(
            "group_norm_silu under vmap takes one gamma/beta for every vmapped sample")


def group_norm_silu(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, groups: int = 32,
    eps: float = 1e-6, silu: bool = True, out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """GroupNorm over the channel axis of (B, C, *spatial), optionally fused
    with SiLU; statistics in f32 (torch GroupNorm semantics). Differentiable
    in x, gamma and beta, and transformable by torch.func (`vmap` over x,
    `grad`)."""
    return _GroupNormSiLU.apply(x, gamma, beta, groups, eps, silu, out_dtype or x.dtype)[0]
