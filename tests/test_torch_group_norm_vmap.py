"""GroupNorm(+SiLU) with a gamma/beta per vmapped sample, on the CPU, against
the JAX package.

- `torch.func.vmap` of the port's `group_norm_silu` over stacked gamma/beta
  (3 members; x per member or shared; gamma alone vmapped), forward and
  per-member gradients (`vmap(grad)`), against `jax.vmap` of the JAX
  `group_norm_silu` through its Pallas kernels in interpret mode.
- Two `synthetic_32x8` U-Nets stacked with `stack_module_state` and run by
  `torch.func.vmap(functional_call)`, forward and per-member parameter
  gradients (both `vmap(grad)` and the gradient of the vmapped loss), against
  `jax.vmap` of the JAX `UNet2D.apply` over stacked params.
- With one shared gamma/beta the plain versions and the autograd Function
  give bit for bit what the formulas before per-row gamma/beta gave.

Tolerances as tests/test_torch_backward.py and tests/test_torch_unet.py state
them: float32 on both sides, sums in other orders; GroupNorm outputs and dx
atol 2e-5, dgamma/dbeta (sums over B*HW terms) atol 1e-4; the U-Net output
atol 1e-4, its gradients 1e-4 of the largest |g| over all tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.ops.group_norm import (
    group_norm_silu as jax_group_norm_silu,
)
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.ops import (
    group_norm_silu,
    group_norm_silu_bwd_plain,
    group_norm_silu_plain,
)
from test_torch_unet import _jax_params, _port_spec, _variant

ATOL = 2e-5
SUM_ATOL = 1e-4
MEMBERS = 3


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


@pytest.mark.parametrize("silu,groups", [(True, 8), (False, 32), (True, 32), (False, 8)])
@pytest.mark.parametrize("in_dims", [(0, 0, 0), (None, 0, 0), (0, 0, None)],
                         ids=["all", "shared_x", "shared_beta"])
def test_vmapped_affine_matches_jax_vmap(silu, groups, in_dims):
    rng = np.random.default_rng(0)
    b, h, w, c = 2, 4, 4, 64
    xs = (rng.standard_normal((MEMBERS, b, h, w, c)) * 3 + 0.5).astype(np.float32)
    gammas = (rng.standard_normal((MEMBERS, c)) + 1).astype(np.float32)
    betas = rng.standard_normal((MEMBERS, c)).astype(np.float32)
    weight = rng.standard_normal((b, h, w, c)).astype(np.float32)
    args = [a if d == 0 else a[0] for a, d in zip((xs, gammas, betas), in_dims)]

    def jax_gn(x, g, bb):
        return jax_group_norm_silu(x, g, bb, groups=groups, eps=1e-6, silu=silu,
                                   interpret=True)

    def jax_loss(x, g, bb):
        return jnp.sum(jax_gn(x, g, bb) * weight)

    want = np.asarray(jax.vmap(jax_gn, in_axes=in_dims)(*args))
    want_grads = jax.vmap(jax.grad(jax_loss, argnums=(0, 1, 2)), in_axes=in_dims)(*args)

    targs = [_nchw(a) if i == 0 else torch.from_numpy(a) for i, a in enumerate(args)]
    tweight = _nchw(weight)

    def gn(x, g, bb):
        return group_norm_silu(x, g, bb, groups=groups, eps=1e-6, silu=silu)

    def loss(x, g, bb):
        return (gn(x, g, bb) * tweight).sum()

    got = torch.func.vmap(gn, in_dims=in_dims)(*targs)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=0)
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)), in_dims=in_dims)(*targs)
    np.testing.assert_allclose(_nhwc(grads[0]), np.asarray(want_grads[0]), atol=ATOL, rtol=0)
    for g, wg in zip(grads[1:], want_grads[1:]):
        assert g.shape == (MEMBERS, c)
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=SUM_ATOL, rtol=0)


@functools.cache
def _members_reference():
    """Two synthetic_32x8 members' params, their inputs and jax.vmap of the
    JAX UNet2D's output and per-member parameter gradients."""
    spec = _variant("synthetic_32x8")
    members = [_jax_params(spec, seed) for seed in (0, 1)]
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *members)
    rng = np.random.default_rng(3)
    shape = (2, 2, spec.sample_size, spec.sample_size, 3)  # (members, batch, H, W, C)
    xs = rng.standard_normal(shape).astype(np.float32)
    targets = rng.standard_normal(shape).astype(np.float32)
    t = np.array([999, 17], dtype=np.int32)

    def apply(p, x):
        return JaxUNet2D(spec).apply({"params": p}, x, jnp.asarray(t))

    def loss(p, x, target):
        return jnp.mean((apply(p, x) - target) ** 2)

    out = jax.jit(jax.vmap(apply))(stacked, xs)
    grads = jax.jit(jax.vmap(jax.grad(loss)))(stacked, xs, targets)
    want_grads = [params_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a)[m], grads))
                  for m in range(2)]
    return spec, members, xs, targets, t, np.asarray(out), want_grads


@pytest.mark.parametrize("order", ["vmap_of_grad", "grad_of_vmap"])
def test_stacked_unet_members_match_jax_vmap(order):
    spec, members, xs, targets, t, want_out, want_grads = _members_reference()
    models = []
    for p in members:
        model = UNet2D(_port_spec(spec))
        model.load_state_dict(params_from_jax(p), strict=True)
        models.append(model)
    params, buffers = torch.func.stack_module_state(models)
    tt = torch.from_numpy(t).long()
    tx, ttarget = _nchw(xs), _nchw(targets)

    def apply(p, bufs, x):
        return torch.func.functional_call(models[0], (p, bufs), (x, tt))

    def loss(p, bufs, x, target):
        return torch.mean((apply(p, bufs, x) - target) ** 2)

    out = torch.func.vmap(apply)(params, buffers, tx)
    np.testing.assert_allclose(_nhwc(out), want_out, atol=1e-4, rtol=0)
    if order == "vmap_of_grad":
        grads = torch.func.vmap(torch.func.grad(loss))(params, buffers, tx, ttarget)
    else:
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total = torch.func.vmap(loss)(leaves, buffers, tx, ttarget).sum()
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    scale = max(np.abs(np.asarray(w)).max() for wg in want_grads for w in wg.values())
    for m in range(2):
        assert grads.keys() == want_grads[m].keys()
        for n, g in grads.items():
            np.testing.assert_allclose(g[m].detach().numpy(), np.asarray(want_grads[m][n]),
                                       atol=1e-4 * scale, rtol=0, err_msg=f"member {m} {n}")


def _before_fwd(x, gamma, beta, groups, eps, silu, out_dtype):
    """group_norm_silu_plain as it was with one shared (C,) gamma/beta."""
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


def _before_bwd(x, dy, gamma, beta, mean, rstd, groups, silu):
    """group_norm_silu_bwd_plain as it was with one shared (C,) gamma/beta."""
    b, c = x.shape[:2]
    cshape = (1, c) + (1,) * (x.ndim - 2)

    def per_channel(t):
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


def _bitwise(got, want):
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("silu", [True, False])
def test_one_shared_gamma_is_bitwise_as_before(silu):
    rng = np.random.default_rng(7)
    b, c, groups = 4, 24, 4
    x = torch.from_numpy((rng.standard_normal((b, c, 5, 7)) * 3 + 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, c, 5, 7)).astype(np.float32))
    gamma = torch.from_numpy((rng.standard_normal(c) + 1).astype(np.float32))
    beta = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    want = _before_fwd(x, gamma, beta, groups, 1e-6, silu, torch.float32)
    _, mean, rstd = want
    want_bwd = _before_bwd(x, dy, gamma, beta, mean, rstd, groups, silu)
    # (C,), one row (1, C), and B equal rows: the same numbers.
    for g, bb in ((gamma, beta), (gamma[None], beta[None]),
                  (gamma.expand(b, c), beta.expand(b, c))):
        _bitwise(group_norm_silu_plain(x, g, bb, groups, 1e-6, silu, torch.float32), want)
        _bitwise(group_norm_silu_bwd_plain(x, dy, g, bb, mean, rstd, groups, silu), want_bwd)
    # The Function: dx, and the partials summed over the batch as before.
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    out = group_norm_silu(*leaves, groups=groups, eps=1e-6, silu=silu)
    assert torch.equal(out, want[0])
    got = torch.autograd.grad(out, leaves, dy)
    _bitwise(got, (want_bwd[0], want_bwd[1].sum(dim=0), want_bwd[2].sum(dim=0)))
