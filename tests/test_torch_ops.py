"""The port's plain attention and GroupNorm(+SiLU) against the JAX package's
Pallas kernels (interpret mode on the CPU), on the same numpy inputs.

The plain versions are what the port's wrappers run on CPU tensors and what
chip_smoke.py holds the CUDA kernels against on the card. Tolerance: atol
2e-5 in float32, as tests/test_flash_attention.py holds the Pallas kernels
against XLA (summation order differs; no precision is lost on either side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.ops.attention import (
    flash_attention,
    flash_attention_hp,
)
from group_attribution_for_diffusion_models_tpu.ops.group_norm import (
    _pallas_fwd,
    group_norm_silu as jax_group_norm_silu,
)
from group_attribution_for_diffusion_models_tpu_torch.ops import (
    attention_kernel,
    attention_plain,
    dot_product_attention,
    group_norm_kernel,
    group_norm_silu,
    group_norm_silu_forward,
)

ATOL = 2e-5


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((b, s, h, d)).astype(np.float32) for s in (sq, skv, skv)
    )


@pytest.mark.parametrize(
    "b,sq,skv,h,d",
    [
        (2, 256, 256, 2, 32),  # aligned self-attention
        (1, 16, 16, 1, 64),    # shorter than one tile (the CIFAR mid block's S)
        (1, 130, 77, 2, 40),   # ragged queries and keys, ragged head dim
    ],
)
def test_attention_plain_matches_flash(b, sq, skv, h, d):
    q, k, v = _qkv(0, b, sq, skv, h, d)
    want = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_attention_plain_matches_head_packed_flash():
    q, k, v = _qkv(1, 1, 256, 256, 2, 64)
    want = np.asarray(flash_attention_hp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_attention_cpu_tensor_takes_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 20, 20, 2, 16))
    before = attention_kernel.launches
    torch.testing.assert_close(dot_product_attention(q, k, v), attention_plain(q, k, v),
                               rtol=0, atol=0)
    assert attention_kernel.launches == before


def test_kernels_refuse_cpu_tensors():
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        attention_kernel(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        group_norm_kernel(torch.zeros(1, 8, 2, 2), torch.ones(8), torch.zeros(8),
                          4, 1e-6, True, torch.float32)


@pytest.mark.parametrize("q,k,match", [
    (torch.zeros(1, 8, 1, 12), torch.zeros(1, 8, 1, 12), "multiple of 8"),
    (torch.zeros(1, 8, 1, 264), torch.zeros(1, 8, 1, 264), "at most 256"),
    (torch.zeros(1, 8, 1, 8, dtype=torch.float16),
     torch.zeros(1, 8, 1, 8, dtype=torch.float16), "float32 or bfloat16"),
    (torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 1, 8), "disagree"),
])
def test_attention_kernel_rejects_what_it_cannot_run(q, k, match):
    with pytest.raises(ValueError, match=match):
        attention_kernel(q, k, k)


def test_group_norm_rejects_bad_groups():
    x = torch.zeros(1, 12, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        group_norm_silu(x, torch.ones(12), torch.zeros(12), groups=8)
    with pytest.raises(ValueError, match="groups 4, gamma"):
        group_norm_kernel(x, torch.ones(8), torch.zeros(12), 4, 1e-6, True, torch.float32)


def _gn_inputs(seed, shape_nhwc):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape_nhwc) * 3.0 + 0.5).astype(np.float32)
    c = shape_nhwc[-1]
    gamma = (rng.standard_normal(c) + 1.0).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", [((3, 8, 8, 64), 32), ((2, 4, 4, 48), 8)])
def test_group_norm_plain_matches_pallas(shape, groups, silu):
    x, gamma, beta = _gn_inputs(3, shape)
    want = np.asarray(jax_group_norm_silu(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups=groups,
        eps=1e-6, silu=silu, interpret=True,
    ))
    got = group_norm_silu(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(gamma),
        torch.from_numpy(beta), groups=groups, eps=1e-6, silu=silu,
    )
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)


def test_group_norm_stats_match_pallas_residuals():
    shape, groups = (2, 8, 8, 64), 16
    x, gamma, beta = _gn_inputs(4, shape)
    b, c = shape[0], shape[-1]
    out, mean, rstd = _pallas_fwd(
        jnp.asarray(x).reshape(b, -1, c), jnp.asarray(gamma), jnp.asarray(beta),
        groups, 1e-6, True, jnp.float32, True,
    )
    before = group_norm_kernel.launches
    got, got_mean, got_rstd = group_norm_silu_forward(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(gamma),
        torch.from_numpy(beta), groups=groups, eps=1e-6, silu=True,
    )
    assert group_norm_kernel.launches == before
    assert got_mean.shape == got_rstd.shape == (b, groups)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean)[:, 0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_rstd.numpy(), np.asarray(rstd)[:, 0], atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).reshape(b, -1, c).numpy(),
                               np.asarray(out), atol=ATOL, rtol=0)
