"""Scaled dot-product attention on (B, S, H, D): CUDA kernel and plain version.

Port of the forward Pallas kernels of the JAX package's ``ops/attention.py``
(``_flash_kernel`` and ``_hp_fwd_kernel``); both compute softmax(Q K^T /
sqrt(D)) V per (batch, head) with an f32 softmax, and one CUDA kernel
(``csrc/attention.cu``) serves both layouts by reading strides. The JAX
package routes each shape between Pallas and XLA through a table measured on
a TPU; here the kernel is the path for every CUDA tensor.

`dot_product_attention` takes the plain PyTorch version for a CPU tensor and
the kernel for a CUDA tensor; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reference softmax(Q K^T / sqrt(D)) V in f32, returned in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


@functools.cache
def _fwd_fn():
    lib = _build.load("attention")
    fn = lib.gadm_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The CUDA attention forward kernel. q: (B, Sq, H, D), k/v: (B, Skv, H, D),
    all on one CUDA device in float32 or bfloat16, D % 8 == 0 and D <= 256."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention_kernel takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8 and at most 256")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention_kernel needs q, k, v on one CUDA device")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(
        *(t.stride(i) for t in (q, k, v) for i in (0, 1, 2))
    )
    lib, fn = _fwd_fn()
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, h, sq, k.shape[1], d, strides, 1.0 / math.sqrt(d), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "attention forward kernel")
    attention_kernel.launches += 1
    return out


attention_kernel.launches = 0


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Scaled dot-product attention on (B, S, H, D): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return attention_kernel(q, k, v)
