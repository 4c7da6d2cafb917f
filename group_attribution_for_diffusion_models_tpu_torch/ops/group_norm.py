"""GroupNorm(+SiLU) forward on NCHW: CUDA kernel and plain version.

Port of the forward Pallas kernel of the JAX package's ``ops/group_norm.py``
(``_fwd_kernel``): f32 group statistics with var = E[x^2] - mean^2,
(x - mean) * rstd * gamma + beta, an optional SiLU, the output in
``out_dtype``, and mean/rstd of shape (B, G) in f32, the residuals the
backward kernel will read. The JAX package keeps its kernel opt-in on the
TPU; here ``csrc/group_norm.cu`` is the path for every CUDA tensor.

`group_norm_silu_forward` takes the plain PyTorch version for a CPU tensor
and the kernel for a CUDA tensor; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

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


def group_norm_silu_forward(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, groups: int = 32,
    eps: float = 1e-6, silu: bool = True, out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, mean, rstd): the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. out_dtype defaults to x's dtype."""
    out_dtype = out_dtype or x.dtype
    if x.shape[1] % groups:
        raise ValueError(f"channels {x.shape[1]} not divisible by groups {groups}")
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, groups, eps, silu, out_dtype)
    return group_norm_kernel(x, gamma, beta, groups, eps, silu, out_dtype)


def group_norm_silu(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, groups: int = 32,
    eps: float = 1e-6, silu: bool = True, out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """GroupNorm over the channel axis of (B, C, *spatial), optionally fused
    with SiLU; statistics in f32 (torch GroupNorm semantics)."""
    return group_norm_silu_forward(
        x, gamma, beta, groups=groups, eps=eps, silu=silu, out_dtype=out_dtype
    )[0]
