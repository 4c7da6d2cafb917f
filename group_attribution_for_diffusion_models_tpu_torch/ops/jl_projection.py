"""Johnson-Lindenstrauss projection of per-sample gradients: CUDA kernel and
plain version.

Port of the Pallas kernel ``_jl_kernel`` of the JAX package's
``ops/jl_projection.py`` (``csrc/jl_projection.cu``): Y = G R / sqrt(P) for
(B, D) gradient rows G, float32 or bfloat16, with a Rademacher (D, P) matrix
R that is generated inside the kernel and never stored, f32 accumulation and
an f32 (B, P) result. The norm of each row is kept in expectation.

Each sign R[d, p] is a function of (seed, d, p) alone: bit p % 32 of a
32-bit hash word per (d, p // 32), set meaning -1 (``csrc/jl_projection.cu``
gives the hash). So the output depends on no tile size, grid order or split
of D, and `jl_project_plain` reproduces R exactly, one d-tile at a time, in
int64 arithmetic masked to 32 bits. The stream is the port's own: it cannot
be the TPU kernel's, nor `jl_project_xla`'s, so a feature store is built
with one package.

The kernel runs the products on the tensor cores in bf16: each sign is an
exact bf16 +-1, and an f32 G enters as three bf16 pieces whose sum is G, so
every product is exact and only the order of the f32 sums differs from the
plain version's.

`jl_project` takes the kernel for a CUDA tensor and the plain version for a
CPU tensor; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import numpy as np
import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_D_MIX = 0x27D4EB2F
# csrc/jl_projection.cu: 512 columns and 32 rows a block, D in tiles of 64;
# two blocks are resident on a multiprocessor, and the split of D aims at
# four waves of them.
_BLOCK_COLS, _BLOCK_ROWS, _TILE_D = 512, 32, 64
_BLOCKS_PER_SM = 2 * 4
# The longest chunk of D one block sums. The tensor cores add each product
# into the f32 accumulators with truncation, not round-to-nearest, so the
# error of a block's partial grows with the length it sums, not as its square
# root: at the CelebA U-Net's 274M coordinates, chunks of D / 132 put every
# output 4x past the kernel's tolerance. Partials of this length (summed in
# order, in IEEE f32, by the second kernel) keep it near a twentieth of it,
# for the same kernel time; the (splits, B, P) buffer grows to D / 2^15 rows.
_MAX_CHUNK_D = 1 << 15
_MAX_SPLITS = 65_535  # gridDim.y


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2^32): a product
    wraps in int64, but its low 32 bits are the uint32 product."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK
    return h ^ (h >> 16)


def rademacher_rows(seed: int, d0: int, d1: int, proj_dim: int, device="cpu") -> torch.Tensor:
    """R[d0:d1, :proj_dim] as float32 +-1, the signs the kernel generates."""
    seed_key = _fmix32(torch.tensor((seed & _MASK) ^ _GOLDEN, dtype=torch.int64))
    groups = torch.arange(-(-proj_dim // 32), dtype=torch.int64, device=device)
    keys = _fmix32(seed_key.to(device) ^ ((groups * _GOLDEN) & _MASK))
    d = torch.arange(d0, d1, dtype=torch.int64, device=device)
    words = _fmix32(keys[None, :] ^ ((d * _D_MIX) & _MASK)[:, None])
    bits = (words[:, :, None] >> torch.arange(32, device=device)) & 1
    bits = bits.reshape(d1 - d0, -1)[:, :proj_dim]
    return 1.0 - 2.0 * bits.to(torch.float32)


def _scale(proj_dim: int) -> float:
    """1/sqrt(P) rounded to float32: the kernel's and the plain version's."""
    return float(np.float32(1.0 / math.sqrt(proj_dim)))


def _check(grads: torch.Tensor, proj_dim: int) -> None:
    if grads.ndim != 2:
        raise ValueError(f"grads must be (B, D), got {tuple(grads.shape)}")
    if proj_dim <= 0:
        raise ValueError(f"proj_dim must be positive, got {proj_dim}")


def jl_project_plain(
    grads: torch.Tensor, proj_dim: int, seed: int = 0, tile_d: int = 1024
) -> torch.Tensor:
    """Reference projection: R materialised `tile_d` rows at a time, f32
    products summed over the tiles, then scaled by 1/sqrt(P)."""
    _check(grads, proj_dim)
    b, d = grads.shape
    acc = torch.zeros((b, proj_dim), dtype=torch.float32, device=grads.device)
    for d0 in range(0, d, tile_d):
        d1 = min(d, d0 + tile_d)
        acc += grads[:, d0:d1].float() @ rademacher_rows(seed, d0, d1, proj_dim, grads.device)
    return acc * _scale(proj_dim)


@functools.cache
def _fn():
    lib = _build.load("jl_projection")
    fn = lib.gadm_jl_project
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
           ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(b: int, d: int, proj_dim: int, device: torch.device):
    """(chunk, splits) of D: enough blocks for _BLOCKS_PER_SM a multiprocessor
    over the column and row tiles, each chunk a whole number of d-tiles and
    at most _MAX_CHUNK_D long (longer only where the grid's _MAX_SPLITS
    forces it, D > 2^31)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = _cdiv(proj_dim, _BLOCK_COLS) * _cdiv(b, _BLOCK_ROWS)
    splits = max(1, min(_cdiv(sms * _BLOCKS_PER_SM, tiles), _cdiv(d, _TILE_D)))
    chunk = _cdiv(_cdiv(d, splits), _TILE_D) * _TILE_D
    longest = max(_MAX_CHUNK_D, _cdiv(_cdiv(d, _MAX_SPLITS), _TILE_D) * _TILE_D)
    chunk = min(chunk, longest)
    return chunk, _cdiv(d, chunk)


def jl_project_kernel(grads: torch.Tensor, proj_dim: int, seed: int = 0) -> torch.Tensor:
    """The CUDA projection kernel: contiguous (B, D) float32 or bfloat16 on a
    CUDA device, D < 2^32, to (B, proj_dim) float32."""
    _check(grads, proj_dim)
    if grads.dtype not in _DTYPES:
        raise ValueError(f"jl_project_kernel takes float32 or bfloat16, got {grads.dtype}")
    if not grads.is_cuda:
        raise ValueError("jl_project_kernel needs a CUDA tensor")
    if not grads.is_contiguous():
        raise ValueError("jl_project_kernel needs contiguous (B, D) rows")
    b, d = grads.shape
    if d >= 2**32:
        raise ValueError(f"D = {d} must be below 2^32")
    chunk, splits = _split(b, d, proj_dim, grads.device)
    partial = torch.empty((splits, b, proj_dim), dtype=torch.float32, device=grads.device)
    out = torch.empty((b, proj_dim), dtype=torch.float32, device=grads.device)
    lib, fn = _fn()
    err = fn(
        grads.data_ptr(), partial.data_ptr(), out.data_ptr(), _DTYPES[grads.dtype], b, d,
        proj_dim, chunk, splits, seed & _MASK, _scale(proj_dim), grads.device.index,
        torch.cuda.current_stream(grads.device).cuda_stream,
    )
    _build.check(lib, err, "JL projection kernel")
    jl_project_kernel.launches += 1
    return out


jl_project_kernel.launches = 0


def jl_project(grads: torch.Tensor, proj_dim: int, seed: int = 0) -> torch.Tensor:
    """Project (B, D) gradient rows to (B, proj_dim) float32, scaled by
    1/sqrt(proj_dim): the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if grads.device.type == "cpu":
        return jl_project_plain(grads, proj_dim, seed)
    return jl_project_kernel(grads, proj_dim, seed)


def jl_project_pytree(grads: Sequence[torch.Tensor], proj_dim: int, seed: int = 0) -> torch.Tensor:
    """Flatten a batch of gradients, a list of (B, ...) tensors, into (B, D)
    in list order and project."""
    b = grads[0].shape[0]
    return jl_project(torch.cat([t.reshape(b, -1) for t in grads], dim=1), proj_dim, seed)
