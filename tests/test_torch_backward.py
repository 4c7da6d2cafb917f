"""The port's backward passes against the JAX package's, on the CPU.

- The plain attention backward against the Pallas flash backward (transposed
  and head-packed kernels, interpret mode) and against jax.vjp of the XLA
  attention; the plain GroupNorm(+SiLU) backward against the Pallas backward
  (interpret mode) and autodiff of the XLA GroupNorm.
- The autograd Functions, on CPU tensors, against torch.autograd through the
  plain forwards: the same Function runs the kernels on the card.
- The U-Net's gradients against jax.grad of the JAX U-Net through the weight
  bridge, with and without remat.

Tolerances: float32 on both sides, sums in other orders. Kernels and plain
versions: atol 2e-5 on gradients of order 1 (as tests/test_torch_ops.py holds
the forwards); dgamma/dbeta sum B*HW terms: atol 1e-4. U-Net: per tensor,
max |g_port - g_jax| <= 1e-4 * max |g_jax| over all tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.ops.attention import (
    _flash_backward,
    _hp_backward_bshd,
    _xla_backward,
)
from group_attribution_for_diffusion_models_tpu.ops.group_norm import (
    _pallas_bwd,
    _pallas_fwd,
    _xla_group_norm_silu,
)
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.ops import (
    attention_bwd_dkv_plain,
    attention_bwd_dq_plain,
    attention_bwd_plain,
    attention_plain,
    dot_product_attention,
    group_norm_silu,
    group_norm_silu_bwd_plain,
    group_norm_silu_plain,
)
from test_torch_unet import _jax_params, _port_spec, _variant

ATOL = 2e-5
SUM_ATOL = 1e-4


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkvg(seed, b, sq, skv, h, d):
    return _arrays(seed, [(b, sq, h, d), (b, skv, h, d), (b, skv, h, d), (b, sq, h, d)])


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 256, 256, 2, 32),  # aligned: the transposed and head-packed layouts
    (2, 16, 16, 1, 64),    # shorter than one tile (the CIFAR mid block's S)
    (1, 130, 77, 2, 40),   # ragged queries and keys, ragged head dim
])
def test_attention_bwd_plain_matches_flash_backward(b, sq, skv, h, d):
    q, k, v, g = _qkvg(0, b, sq, skv, h, d)
    got = attention_bwd_plain(*_torch(q, k, v, g))
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    refs = [_flash_backward(jq, jk, jv, jg), _xla_backward(jq, jk, jv, jg)]
    if sq % 256 == 0:  # the head-packed kernels tile whole 256-query blocks
        refs.append(_hp_backward_bshd(jq, jk, jv, jg))
    for want in refs:
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_attention_bwd_passes_compose_and_match_stats():
    """The two plain passes: lse is the scores' logsumexp, delta is
    rowsum(dO * O), and the dK/dV pass from them gives the plain dk, dv."""
    q, k, v, g = _torch(*_qkvg(1, 2, 40, 24, 3, 16))
    dq, lse, delta = attention_bwd_dq_plain(q, k, v, g)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-6, rtol=0)
    o = attention_plain(q, k, v)
    torch.testing.assert_close(delta, (o * g).sum(-1).permute(0, 2, 1), atol=1e-5, rtol=0)
    dk, dv = attention_bwd_dkv_plain(q, k, v, g, lse, delta)
    whole = attention_bwd_plain(q, k, v, g)
    for a, w in zip((dq, dk, dv), whole):
        assert torch.equal(a, w)


@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 8, 8, 64), 32, True), ((2, 8, 8, 64), 32, False), ((3, 4, 4, 48), 8, True)])
def test_group_norm_bwd_plain_matches_pallas_and_xla(shape, groups, silu):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    c = shape[-1]
    gamma = (rng.standard_normal(c) + 1).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    b = shape[0]
    x3, dy3 = jnp.asarray(x).reshape(b, -1, c), jnp.asarray(dy).reshape(b, -1, c)
    _, mean, rstd = _pallas_fwd(x3, jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-6,
                                silu, jnp.float32, True)
    want_pallas = _pallas_bwd(x3, dy3, jnp.asarray(gamma), jnp.asarray(beta), mean, rstd,
                              groups, 1e-6, silu, True)
    _, vjp = jax.vjp(lambda xx, gg, bb: _xla_group_norm_silu(
        xx, gg, bb, groups, 1e-6, silu, jnp.float32), jnp.asarray(x), jnp.asarray(gamma),
        jnp.asarray(beta))
    want_xla = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = group_norm_silu_bwd_plain(
        xt, torch.from_numpy(dy).permute(0, 3, 1, 2), torch.from_numpy(gamma),
        torch.from_numpy(beta), torch.from_numpy(np.array(mean)[:, 0]),
        torch.from_numpy(np.array(rstd)[:, 0]), groups, silu)
    dx = got[0].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(dx.reshape(b, -1, c), np.asarray(want_pallas[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dx, np.asarray(want_xla[0]), atol=ATOL, rtol=0)
    for a, wp, wx in zip(got[1:], want_pallas[1:], want_xla[1:]):
        assert a.shape == (b, c)  # per (sample, channel), summed by the Function
        np.testing.assert_allclose(a.sum(dim=0).numpy(), np.asarray(wp), atol=SUM_ATOL, rtol=0)
        np.testing.assert_allclose(a.sum(dim=0).numpy(), np.asarray(wx), atol=SUM_ATOL, rtol=0)


def _leaves(*arrays):
    return [t.clone().requires_grad_(True) for t in _torch(*arrays)]


def test_attention_function_matches_autograd_of_plain():
    q, k, v, g = _qkvg(3, 2, 33, 20, 2, 24)
    a = _leaves(q, k, v)
    out = dot_product_attention(*a)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, a, torch.from_numpy(g))
    b = _leaves(q, k, v)
    want = torch.autograd.grad(attention_plain(*b), b, torch.from_numpy(g))
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_function_matches_autograd_of_plain(silu):
    x, dy = _arrays(4, [(2, 16, 5, 5), (2, 16, 5, 5)])
    gb = _arrays(5, [(16,), (16,)])
    a = _leaves(x * 3 + 0.5, gb[0] + 1, gb[1])
    out = group_norm_silu(*a, groups=4, eps=1e-6, silu=silu)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, a, torch.from_numpy(dy))
    b = _leaves(x * 3 + 0.5, gb[0] + 1, gb[1])
    ref = group_norm_silu_plain(*b, 4, 1e-6, silu, torch.float32)[0]
    want = torch.autograd.grad(ref, b, torch.from_numpy(dy))
    for x_, w, tol in zip(got, want, (ATOL, SUM_ATOL, SUM_ATOL)):
        torch.testing.assert_close(x_, w, atol=tol, rtol=0)


def _unet_loss_and_grads(spec, params, x, t, target, remat=False):
    model = UNet2D(_port_spec(spec), remat=remat)
    model.load_state_dict(params_from_jax(params), strict=True)
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long())
    loss = ((out - torch.from_numpy(target).permute(0, 3, 1, 2)) ** 2).mean()
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def test_unet_gradients_match_jax_grad():
    """Every parameter gets a gradient, and it is jax.grad's: GroupNorm and
    attention carry the graph through their autograd Functions (the _big spec
    has both, at two levels and in the mid block)."""
    spec = _variant("synthetic_32x8_big")
    params = _jax_params(spec, 0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, spec.sample_size, spec.sample_size, 3)).astype(np.float32)
    target = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([999, 17], dtype=np.int32)

    def loss_fn(p):
        out = JaxUNet2D(spec).apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    loss, got = _unet_loss_and_grads(spec, params, x, t, target)
    assert got.keys() == want.keys()
    assert all(g is not None for g in got.values())
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    scale = max(np.abs(np.asarray(w)).max() for w in want.values())
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]), atol=1e-4 * scale,
                                   rtol=0, err_msg=n)


def test_remat_gives_the_gradients_of_no_remat():
    spec = _variant("synthetic_32x8_big")
    params = _jax_params(spec, 1)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    target = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([500, 3], dtype=np.int32)
    loss, plain = _unet_loss_and_grads(spec, params, x, t, target)
    loss_r, remat = _unet_loss_and_grads(spec, params, x, t, target, remat=True)
    assert loss_r == loss
    for n in plain:
        torch.testing.assert_close(remat[n], plain[n], atol=0, rtol=0, msg=n)


def test_bf16_compute_tracks_the_jax_bf16_model():
    """compute_dtype=bf16 is the JAX model's dtype=bf16: f32 parameters, bf16
    convolutions, linears and activations. Rounding lands in other places, so
    each package's bf16 output and gradients are held to the f32 ones (the
    port's f32 model, which test_unet_gradients_match_jax_grad holds to
    jax.grad): within 3% of the output's range and 5% of the gradients'
    global norm, and the two bf16 models within the same of each other."""
    spec = _variant("synthetic_32x8_big")
    params = _jax_params(spec, 2)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    target = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([700, 40], dtype=np.int32)

    def loss_fn(p):
        out = JaxUNet2D(spec, dtype=jnp.bfloat16).apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean((out - jnp.asarray(target)) ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    outs = {"jax bf16": np.asarray(out)}
    grads = {"jax bf16": {n: v.numpy() for n, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, g)).items()}}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = UNet2D(_port_spec(spec), compute_dtype=dtype)
        model.load_state_dict(params_from_jax(params))
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long())
        assert out.dtype == torch.float32
        ((out - torch.from_numpy(target).permute(0, 3, 1, 2)) ** 2).mean().backward()
        outs[name] = out.detach().permute(0, 2, 3, 1).numpy()
        grads[name] = {n: p.grad.numpy() for n, p in model.named_parameters()}
        assert all(p.grad.dtype == torch.float32 for p in model.parameters())

    def gnorm(g):
        return np.sqrt(sum(float(np.sum(np.square(v))) for v in g.values()))

    span, norm = np.abs(outs["f32"]).max(), gnorm(grads["f32"])
    for a, b in (("bf16", "f32"), ("jax bf16", "f32"), ("bf16", "jax bf16")):
        assert np.abs(outs[a] - outs[b]).max() <= 0.03 * span, (a, b)
        diff = {n: grads[a][n] - grads[b][n] for n in grads["f32"]}
        assert gnorm(diff) <= 0.05 * norm, (a, b, gnorm(diff) / norm)
