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

gamma and beta are (C,), or (R, C) with R dividing the batch: sample b then
reads row b // (B // R). That is how a vmapped gamma/beta (the members of
an ensemble, stacked) reaches the kernels with the vmapped dimension folded
into the batch, as ``jax.vmap`` carries it through the Pallas kernels.

`group_norm_silu` is a `torch.autograd.Function` that saves
(x, gamma, beta, mean, rstd), as the JAX ``custom_vjp`` does. Its forward
and backward each take the plain PyTorch version for a CPU tensor and the
kernel for a CUDA tensor; there is no fallback between them. Forward and
backward each have a `vmap` rule, so ``torch.func.vmap(torch.func.grad(f))``
runs the kernels, and the backward kernel's per-(sample, channel) dgamma and
dbeta partials become the per-sample gradients of gamma and beta. A vmapped
gamma or beta (``torch.func.vmap`` over stacked member parameters) folds
into (R, C) rows, so one launch serves every member too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..utils.profiling import launch_scope
from . import _build
from .attention import fold_vmapped, unfold_vmapped

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _affine_rows(t: torch.Tensor, b: int, c: int, ndim: int) -> torch.Tensor:
    """gamma or beta, (C,) or (R, C), in f32, broadcastable over (B, C, *spatial)."""
    t = t.float()
    if t.ndim == 2:
        t = t.repeat_interleave(b // t.shape[0], dim=0)
    return t.reshape((-1, c) + (1,) * (ndim - 2))


def group_norm_silu_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
    eps: float, silu: bool, out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference (out, mean, rstd) for x of shape (B, C, *spatial); gamma and
    beta (C,) or (R, C), sample b reading row b // (B // R)."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1)
    var = (xf * xf).mean(dim=-1) - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    y = y * _affine_rows(gamma, b, c, x.ndim) + _affine_rows(beta, b, c, x.ndim)
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
    channel), of shape (B, C). gamma and beta are (C,) or (R, C), as in
    `group_norm_silu_plain`."""
    b, c = x.shape[:2]

    def per_channel(t):  # (B, G) -> broadcastable over (B, C, *spatial)
        return t.reshape(b, groups, 1).expand(b, groups, c // groups).reshape(
            (b, c) + (1,) * (x.ndim - 2))

    gam = _affine_rows(gamma, b, c, x.ndim)
    xhat = (x.float() - per_channel(mean)) * per_channel(rstd)
    g = dy.float()
    if silu:
        y = xhat * gam + _affine_rows(beta, b, c, x.ndim)
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
        + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_fn():
    lib = _build.load("group_norm_bwd")
    fn = lib.gadm_group_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _affine_count(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  groups: int, what: str) -> int:
    """R, the rows of gamma/beta ((C,) counts as 1), after checking the
    shapes a kernel takes: gamma and beta alike, (C,) or (R, C), R dividing B."""
    b, c = x.shape[:2]
    rows = gamma.shape[0] if gamma.ndim == 2 else 1
    if (c % groups or gamma.shape != beta.shape or gamma.shape[-1:] != (c,)
            or gamma.ndim > 2 or rows < 1 or b % rows):
        raise ValueError(f"{what}: channels {c}, groups {groups}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}, batch {b}")
    return rows


def _name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]


def _dims(x: torch.Tensor, groups: int, silu: bool) -> dict:
    """A launch's shape, as its profiler range names it."""
    return dict(B=x.shape[0], C=x.shape[1], HW=x[0, 0].numel(), G=groups, silu=int(silu),
                dtype=_name(x.dtype))


def group_norm_kernel(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
    eps: float, silu: bool, out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA GroupNorm(+SiLU) forward kernel: (out, mean, rstd) for x of
    shape (B, C, *spatial) on a CUDA device, float32 or bfloat16; gamma and
    beta (C,) or (R, C)."""
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"group_norm_kernel takes float32 or bfloat16, got "
                         f"{x.dtype} -> {out_dtype}")
    rows = _affine_count(x, gamma, beta, groups, "group_norm_kernel")
    if not x.is_cuda:
        raise ValueError("group_norm_kernel needs a CUDA tensor")
    b, c = x.shape[:2]
    x = x.contiguous()
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    lib, fn = _fwd_fn()
    with launch_scope("group_norm_fwd",
                      lambda: dict(_dims(x, groups, silu), out=_name(out_dtype))):
        err = fn(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), _DTYPES[x.dtype], _DTYPES[out_dtype],
            b, c, x[0, 0].numel(), groups, rows, eps, int(silu), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "group norm forward kernel")
    group_norm_kernel.launches += 1
    return out, mean, rstd


group_norm_kernel.launches = 0


def group_norm_bwd_kernel(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, groups: int, silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA GroupNorm(+SiLU) backward kernel: (dx, partials) for x of
    shape (B, C, *spatial) on a CUDA device: dx in x's dtype and one (2, B, C)
    f32 buffer of the per-(sample, channel) dgamma (row 0) and dbeta (row 1)
    partials that `group_norm_silu_bwd_plain` returns as its second and third
    results. dy is taken in x's dtype, as the JAX rule casts it."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"group_norm_bwd_kernel takes float32 or bfloat16, got {x.dtype}")
    rows = _affine_count(x, gamma, beta, groups, "group_norm_bwd_kernel")
    b, c = x.shape[:2]
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} for x {tuple(x.shape)}")
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
    part = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    lib, fn = _bwd_fn()
    with launch_scope("group_norm_bwd", lambda: _dims(x, groups, silu)):
        err = fn(
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), part.data_ptr(), _DTYPES[x.dtype], b, c,
            x[0, 0].numel(), groups, rows, int(silu), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "group norm backward kernel")
    group_norm_bwd_kernel.launches += 1
    return dx, part


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


def _fold_affine(info, in_dims, gamma: torch.Tensor, beta: torch.Tensor):
    """For a `vmap` rule: gamma and beta as the kernels take them beside an x
    folded to (Bv*B, ...). Shared (C,) ones stay as they are (one row for
    every sample); otherwise each becomes (Bv*R, C), vmapped dimension first,
    a shared one expanded over Bv, so folded sample v*B + b reads row v*R +
    b // (B // R), its own vmapped sample's."""
    if all(d is None for d in in_dims) and gamma.ndim == 1:
        return gamma, beta
    out = []
    for t, dim in zip((gamma, beta), in_dims):
        t = t.expand(info.batch_size, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.reshape(-1, t.shape[-1]))
    return out


class _GroupNormSiLU(torch.autograd.Function):
    """GroupNorm(+SiLU) returning (out, mean, rstd), transformable by
    torch.func: under `vmap` the vmapped dimension is folded into the batch
    (one launch for every sample), a vmapped gamma/beta into (R, C) rows, and
    the backward is `_GroupNormSiLUBackward`, which has its own `vmap` rule."""

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
        dx, part = _GroupNormSiLUBackward.apply(
            x, dout.to(x.dtype), gamma, beta, mean, rstd, ctx.groups, ctx.silu)
        if not (ctx.needs_input_grad[1] or ctx.needs_input_grad[2]):
            # A frozen gamma/beta (LoRA training): the kernel has written the
            # partials, but nothing sums them and no gradient is returned.
            return dx, None, None, None, None, None, None
        # The (2, B, C) partials summed over each gamma row's samples in one
        # reduction: under vmap, over each vmapped sample's own batch.
        group_norm_silu.affine_sums += 1
        rows = gamma.shape[0] if gamma.ndim == 2 else 1
        sums = part.unflatten(1, (rows, -1)).sum(dim=2)
        return (dx, sums[0].reshape(gamma.shape).to(gamma.dtype),
                sums[1].reshape(beta.shape).to(beta.dtype), None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, gamma, beta, groups, eps, silu, out_dtype):
        (xf,) = fold_vmapped(info, in_dims[:1], x)
        gamma, beta = _fold_affine(info, in_dims[1:3], gamma, beta)
        out = _GroupNormSiLU.apply(xf, gamma, beta, groups, eps, silu, out_dtype)
        return tuple(unfold_vmapped(info, t) for t in out), (0, 0, 0)


class _GroupNormSiLUBackward(torch.autograd.Function):
    """(dx, partials) of `_GroupNormSiLU`: dx and the (2, B, C) f32 dgamma and
    dbeta partials per (sample, channel), from the backward kernel on a CUDA
    tensor, the plain version on a CPU tensor. Under `vmap` (per-sample
    gradients: x and dy vmapped; gamma and beta shared or vmapped) the
    partials of every vmapped sample come from one launch, (2, Bv, B, C),
    which `_GroupNormSiLU.backward` sums over B."""

    @staticmethod
    def forward(x, dy, gamma, beta, mean, rstd, groups, silu):
        args = (x, dy, gamma, beta, mean, rstd, groups, silu)
        if x.device.type == "cpu":
            dx, dgamma, dbeta = group_norm_silu_bwd_plain(*args)
            return dx, torch.stack((dgamma, dbeta))
        return group_norm_bwd_kernel(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("group norm has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, dy, gamma, beta, mean, rstd, groups, silu):
        xf, dyf, meanf, rstdf = fold_vmapped(
            info, (in_dims[0], in_dims[1], in_dims[4], in_dims[5]), x, dy, mean, rstd)
        gamma, beta = _fold_affine(info, in_dims[2:4], gamma, beta)
        dx, part = _GroupNormSiLUBackward.apply(xf, dyf, gamma, beta, meanf, rstdf, groups,
                                                silu)
        return (unfold_vmapped(info, dx),
                part.reshape(2, info.batch_size, -1, part.shape[-1])), (0, 1)


def group_norm_silu(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, groups: int = 32,
    eps: float = 1e-6, silu: bool = True, out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """GroupNorm over the channel axis of (B, C, *spatial), optionally fused
    with SiLU; statistics in f32 (torch GroupNorm semantics). Differentiable
    in x, gamma and beta, and transformable by torch.func (`vmap` over x,
    gamma and beta, `grad`). gamma and beta are (C,), or (R, C) with one row
    for each of R equal runs of samples. A gamma and beta that need no
    gradient get none: their partials are not summed (`affine_sums` counts
    the reductions made)."""
    return _GroupNormSiLU.apply(x, gamma, beta, groups, eps, silu, out_dtype or x.dtype)[0]


group_norm_silu.affine_sums = 0
