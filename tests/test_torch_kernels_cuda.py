"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the train step on the card against the CPU.

Marked `cuda`: they skip without a CUDA device and run on the GPU machine
with `python -m pytest tests/test_torch_kernels_cuda.py -m cuda`.
Tolerances (atol, rtol): float32 (5e-5, 1e-5), for summation order only;
bfloat16 (1e-2, 2**-7): both sides round f32 results that differ in the
last bits to bf16, so they may land one bf16 ulp (2**-7 relative) apart.
dgamma/dbeta sum B*HW terms: atol 5e-5 + 1e-5 * max |ref|. The train step:
relative 1e-4 on the loss and the gradients' norm, f32 with TF32 off. The JL
projection sums D terms in another order than its plain version: per row
|dY| <= 1e-6 * sum_d |G[b, d]| / sqrt(P) (the plain version rounds bf16 G to
f32 as the kernel does); identity rows are exact.
"""

import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu_torch.ops import (
    attention_bwd_dkv,
    attention_bwd_dkv_plain,
    attention_bwd_dq,
    attention_bwd_dq_plain,
    attention_bwd_kernel,
    attention_bwd_plain,
    attention_bwd_plain_route,
    attention_kernel,
    attention_plain,
    attention_plain_route,
    dot_product_attention,
    group_norm_bwd_kernel,
    group_norm_kernel,
    group_norm_silu,
    group_norm_silu_bwd_plain,
    group_norm_silu_plain,
    jl_project,
    jl_project_kernel,
    jl_project_plain,
    rademacher_rows,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (5e-5, 1e-5), torch.bfloat16: (1e-2, 2**-7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


# The registry's head dims (16, 32, 40, 64, 80, 160, 256), ragged Sq and Skv.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,d", [
    (4, 256, 256, 1, 256), (4, 16, 16, 1, 256), (2, 1024, 1024, 14, 32),
    (1, 130, 77, 2, 40), (2, 64, 64, 3, 80), (1, 300, 300, 2, 160),
    (3, 17, 1, 2, 16), (2, 33, 45, 2, 64), (2, 257, 130, 1, 256), (1, 77, 257, 2, 160),
])
def test_attention_kernel_matches_plain(cuda, dtype, b, sq, skv, h, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
               for s in (sq, skv, skv))
    before = attention_kernel.launches
    got = attention_kernel(q, k, v)
    torch.cuda.synchronize()
    assert attention_kernel.launches == before + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), attention_plain(q, k, v).float(),
                               atol=atol, rtol=rtol)
    assert torch.equal(got, attention_kernel(q, k, v))  # no atomics: bitwise repeatable


def test_attention_kernel_reads_strided_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 96, 3, 2, 40, generator=g, device=cuda)  # packed q/k/v
    q, k, v = qkv.unbind(dim=2)
    atol, rtol = TOL[torch.float32]
    torch.testing.assert_close(attention_kernel(q, k, v), attention_plain(q, k, v),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", [((8, 128, 32, 32), 32), ((8, 256, 4, 4), 32),
                                          ((2, 384, 32, 32), 32)])
def test_group_norm_kernel_matches_plain(cuda, dtype, silu, shape, groups):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn(shape, generator=g, device=cuda) * 3 + 0.5).to(dtype)
    gamma = torch.randn(shape[1], generator=g, device=cuda) + 1
    beta = torch.randn(shape[1], generator=g, device=cuda)
    got = group_norm_kernel(x, gamma, beta, groups, 1e-6, silu, dtype)
    want = group_norm_silu_plain(x, gamma, beta, groups, 1e-6, silu, dtype)
    for a, w, (atol, rtol) in zip(got, want, (TOL[dtype], (1e-5, 1e-5), (1e-5, 1e-5))):
        torch.testing.assert_close(a.float(), w.float(), atol=atol, rtol=rtol)


def test_unet_forward_on_card_matches_cpu(cuda):
    from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet

    torch.backends.cudnn.allow_tf32 = False
    model = build_unet(config_for("synthetic_32x8_big").unet, seed=0).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))
    t = torch.tensor([999, 3])
    with torch.no_grad():
        want = model(x, t)
        got = model.to(cuda)(x.to(cuda), t.to(cuda)).cpu()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_unet_bf16_forward_on_card_tracks_f32(cuda):
    """bf16 weights and activations (8-bit mantissa) through the _big spec's
    10 resnet/attention blocks: within 5% of the f32 output's range."""
    from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet

    model = build_unet(config_for("synthetic_32x8_big").unet, seed=0).eval()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 3, 8, 8)).astype(np.float32))
    t = torch.tensor([999, 500, 3, 0])
    with torch.no_grad():
        want = model(x, t)
        got = model.to(cuda, torch.bfloat16)(x.to(cuda), t.to(cuda)).cpu()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=0.05 * want.abs().max().item(), rtol=0)


def test_generate_samples_on_card_goes_through_the_kernels(cuda, tmp_path):
    import os

    from group_attribution_for_diffusion_models_tpu_torch.cli import generate_samples
    from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint

    spec = config_for("synthetic_32x8_big").unet
    sd = build_unet(spec, seed=0).state_dict()
    save_checkpoint(str(tmp_path / "m"), 1, sd, sd, unet_spec=spec)
    for dtype in ("fp32", "bf16"):
        attention_kernel.launches = group_norm_kernel.launches = 0
        out = tmp_path / dtype
        generate_samples.main(["--dataset", "synthetic_32x8_big", "--load",
                               str(tmp_path / "m"), "--sample_outdir", str(out),
                               "--n_samples", "3", "--num_inference_steps", "2",
                               "--dtype", dtype])
        assert len([n for n in os.listdir(out) if n.endswith(".png")]) == 3
        # _big, per forward: 6 attention layers; 12 resnets x 2 + 6 pre-norms
        # + conv_norm_out = 31 GroupNorms. Two DDIM steps.
        assert (attention_kernel.launches, group_norm_kernel.launches) == (2 * 6, 2 * 31)


# The backward's shapes: the registry's head dims (16, 32, 40, 64, 80, 160,
# 256), ragged Sq and Skv (1, 17, 77, 130, 257) on either side, and TRAK's
# folded mid block (B*H = 512).
BWD_SHAPES = [
    (4, 256, 256, 1, 256), (4, 16, 16, 1, 256), (1, 1024, 1024, 14, 32),
    (2, 130, 77, 2, 40), (2, 64, 64, 3, 80), (1, 300, 200, 2, 160),
    (3, 17, 1, 2, 16), (2, 1, 77, 4, 40), (2, 257, 130, 1, 256), (1, 77, 257, 2, 160),
    (2, 130, 17, 8, 80), (2, 33, 45, 2, 64), (512, 16, 16, 1, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,d", BWD_SHAPES)
def test_attention_bwd_kernels_match_plain(cuda, dtype, b, sq, skv, h, d):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
                   for s in (sq, skv, skv, sq))
    before = (attention_bwd_dq.launches, attention_bwd_dkv.launches)
    dq, lse, delta = attention_bwd_dq(q, k, v, do)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (attention_bwd_dq.launches, attention_bwd_dkv.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    want_dq, want_lse, want_delta = attention_bwd_dq_plain(q, k, v, do)
    want_dk, want_dv = attention_bwd_dkv_plain(q, k, v, do, want_lse, want_delta)
    atol, rtol = TOL[dtype]
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    for got, want in ((lse, want_lse), (delta, want_delta)):
        torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-5)
    again = attention_bwd_kernel(q, k, v, do)  # no atomics: bitwise repeatable
    assert all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,d", [(4, 256, 256, 1, 256), (2, 130, 77, 2, 40),
                                          (64, 16, 16, 1, 256)])
def test_attention_bwd_passes_repeat_bitwise(cuda, dtype, b, sq, skv, h, d):
    """No atomics and a fixed order of every sum: each pass gives the same
    bits twice, lse and delta included."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
                   for s in (sq, skv, skv, sq))
    first = attention_bwd_dq(q, k, v, do)
    again = attention_bwd_dq(q, k, v, do)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _, lse, delta = first
    assert torch.equal(torch.cat(attention_bwd_dkv(q, k, v, do, lse, delta)),
                       torch.cat(attention_bwd_dkv(q, k, v, do, lse, delta)))


# The CelebA U-Net's attention, head dim 32 (the D <= 64 template): 14 heads
# at 32x32 latents, 21 at 16x16, 28 at 8x8.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h", [(2, 1024, 14), (2, 256, 21), (2, 64, 28)])
def test_attention_kernels_at_the_celeba_unet_shapes(cuda, dtype, b, s, h):
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, do = (torch.randn(b, s, h, 32, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    atol, rtol = TOL[dtype]
    out = attention_kernel(q, k, v)
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(),
                               atol=atol, rtol=rtol)
    assert torch.equal(out, attention_kernel(q, k, v))
    got = attention_bwd_kernel(q, k, v, do)
    for a, w in zip(got, attention_bwd_plain(q, k, v, do)):
        torch.testing.assert_close(a.float(), w.float(), atol=atol, rtol=rtol)
    assert all(torch.equal(a, w) for a, w in zip(got, attention_bwd_kernel(q, k, v, do)))


# miniSD's attention, 8 heads at widths 320, 640 and 1280 (head dims 40, 80
# and 160: the D <= 64, <= 128 and <= 256 templates), against a 77-token
# text context: every key tile partial, Skv > Sq in the 4x4 mid block.
@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 1024, 77, 8, 40), (2, 256, 77, 8, 80),
                                          (2, 64, 77, 8, 160), (2, 16, 77, 8, 160)])
def test_attention_kernels_at_the_minisd_cross_attention_shapes(cuda, b, sq, skv, h, d):
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=cuda)
                   for s in (sq, skv, skv, sq))
    atol, rtol = TOL[torch.float32]
    out = attention_kernel(q, k, v)
    torch.testing.assert_close(out, attention_plain(q, k, v), atol=atol, rtol=rtol)
    assert torch.equal(out, attention_kernel(q, k, v))
    dq, lse, delta = attention_bwd_dq(q, k, v, do)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, delta)
    want_dq, want_lse, want_delta = attention_bwd_dq_plain(q, k, v, do)
    want_dk, want_dv = attention_bwd_dkv_plain(q, k, v, do, want_lse, want_delta)
    for a, w in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(a, w, atol=atol, rtol=rtol)
    for a, w in ((lse, want_lse), (delta, want_delta)):
        torch.testing.assert_close(a, w, atol=5e-5, rtol=1e-5)
    assert dk.shape == (b, skv, h, d)
    assert all(torch.equal(a, w) for a, w in zip((dq, dk, dv), attention_bwd_kernel(q, k, v, do)))


def test_attention_at_head_dim_512_takes_the_plain_route(cuda):
    """The VQ-VAE's mid attention (one head of 512, which the kernels do not
    take) runs the plain f32 version on the card in both directions, counted
    on the route and not on the kernels; the kernel itself refuses it."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(2, 256, 1, 512, generator=g, device=cuda).requires_grad_(True)
               for _ in range(3))
    do = torch.randn(2, 256, 1, 512, generator=g, device=cuda)
    kernels = (attention_kernel.launches, attention_bwd_dq.launches, attention_bwd_dkv.launches)
    routes = (attention_plain_route.launches, attention_bwd_plain_route.launches)
    out = dot_product_attention(q, k, v)
    out.backward(do)
    assert (attention_plain_route.launches, attention_bwd_plain_route.launches) == (
        routes[0] + 1, routes[1] + 1)
    assert (attention_kernel.launches, attention_bwd_dq.launches,
            attention_bwd_dkv.launches) == kernels
    torch.testing.assert_close(out, attention_plain(q, k, v), atol=0, rtol=0)
    for got, want in zip((q.grad, k.grad, v.grad), attention_bwd_plain(q, k, v, do)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="head dim"):
        attention_kernel(q.detach(), k.detach(), v.detach())


def test_attention_bwd_copies_rows_off_16_bytes(cuda):
    """A view whose rows do not start on 16 bytes is copied before the 16-byte
    loads, with the same gradients."""
    g = torch.Generator(device=cuda).manual_seed(9)
    flat = torch.randn(4 * 2 * 40 * 3 + 1, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = flat[1:].view(3, 4, 2, 1, 40)  # storage offset of 2 bytes
    do = torch.randn(4, 2, 1, 40, generator=g, device=cuda).to(torch.bfloat16)
    atol, rtol = TOL[torch.bfloat16]
    for got, want in zip(attention_bwd_kernel(q, k, v, do), attention_bwd_plain(q, k, v, do)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_attention_bwd_reads_strided_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(2, 96, 3, 2, 40, generator=g, device=cuda)
    q, k, v = qkv.unbind(dim=2)
    do = torch.randn(2, 96, 2, 80, generator=g, device=cuda)[..., ::2]
    atol, rtol = TOL[torch.float32]
    for got, want in zip(attention_bwd_kernel(q, k, v, do), attention_bwd_plain(q, k, v, do)):
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", [((8, 128, 32, 32), 32), ((8, 256, 4, 4), 32),
                                          ((2, 24, 5, 7), 4)])
def test_group_norm_bwd_kernel_matches_plain(cuda, dtype, silu, shape, groups):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(shape, generator=g, device=cuda) * 3 + 0.5).to(dtype)
    gamma = torch.randn(shape[1], generator=g, device=cuda) + 1
    beta = torch.randn(shape[1], generator=g, device=cuda)
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    _, mean, rstd = group_norm_silu_plain(x, gamma, beta, groups, 1e-6, silu, dtype)
    args = (x, dy, gamma, beta, mean, rstd, groups, silu)
    before = group_norm_bwd_kernel.launches
    dx, part = group_norm_bwd_kernel(*args)
    assert group_norm_bwd_kernel.launches == before + 1
    assert part.shape == (2,) + shape[:2]
    want = group_norm_silu_bwd_plain(*args)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(dx.float(), want[0].float(), atol=atol, rtol=rtol)
    for a, w in zip(part, want[1:]):
        torch.testing.assert_close(a, w, atol=5e-5 + 1e-5 * w.abs().max().item(), rtol=0)
    assert all(torch.equal(a, w) for a, w in zip((dx, part), group_norm_bwd_kernel(*args)))


def _gn_case(cuda, shape, dtype, seed, rows=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=cuda) * 3 + 0.5).to(dtype)
    c = shape[1]
    affine = (c,) if rows is None else (rows, c)
    gamma = torch.randn(affine, generator=g, device=cuda) + 1
    beta = torch.randn(affine, generator=g, device=cuda)
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    return x, gamma, beta, dy


def _check_gn_both(x, gamma, beta, dy, groups, silu, dtype, eps=1e-6):
    """Both kernels against their plain versions, each repeated bit for bit."""
    args = (x, gamma, beta, groups, eps, silu, dtype)
    got = group_norm_kernel(*args)
    want = group_norm_silu_plain(*args)
    for a, w, (atol, rtol) in zip(got, want, (TOL[dtype], (1e-5, 1e-5), (1e-5, 1e-5))):
        torch.testing.assert_close(a.float(), w.float(), atol=atol, rtol=rtol)
    assert all(torch.equal(a, w) for a, w in zip(got, group_norm_kernel(*args)))
    bargs = (x, dy, gamma, beta, want[1], want[2], groups, silu)
    dx, part = group_norm_bwd_kernel(*bargs)
    want = group_norm_silu_bwd_plain(*bargs)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(dx.float(), want[0].float(), atol=atol, rtol=rtol)
    for a, w in zip(part, want[1:]):
        torch.testing.assert_close(a, w, atol=5e-5 + 1e-5 * w.abs().max().item(), rtol=0)
    assert all(torch.equal(a, w) for a, w in zip((dx, part), group_norm_bwd_kernel(*bargs)))


# Every GroupNorm shape of the CIFAR U-Net (chip_smoke.py's GN_CENSUS) at batch 4.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chw,silu", [
    ((128, 32, 32), True), ((256, 16, 16), True), ((256, 16, 16), False),
    ((256, 4, 4), True), ((256, 4, 4), False), ((256, 8, 8), True), ((512, 4, 4), True),
    ((512, 8, 8), True), ((512, 16, 16), True), ((256, 32, 32), True),
    ((128, 16, 16), True), ((384, 16, 16), True), ((384, 32, 32), True),
])
def test_group_norm_kernels_at_the_unet_shapes(cuda, dtype, chw, silu):
    x, gamma, beta, dy = _gn_case(cuda, (4,) + chw, dtype, 7)
    _check_gn_both(x, gamma, beta, dy, 32, silu, dtype)


# norm2 of a structurally pruned CIFAR U-Net: hidden widths rounded to the 32
# groups give 2, 3 or 6 channels a group (ratio 0.5: 64, 128; ratio 0.3: 96,
# 192) at every level's resolution.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpg", [2, 3, 6])
@pytest.mark.parametrize("hw", [32, 16, 8, 4])
def test_group_norm_kernels_at_the_pruned_norm2_shapes(cuda, dtype, cpg, hw):
    x, gamma, beta, dy = _gn_case(cuda, (4, 32 * cpg, hw, hw), dtype, 9)
    _check_gn_both(x, gamma, beta, dy, 32, True, dtype)


# Each size class: one warp a group, several warps a group, the stream (a
# group past the register budget in f32, HW/4 = 12 neither a multiple of 32
# nor a power of two, HW = 35 not a multiple of 16 bytes, cpg = 6; 1100
# channels a group, past one pass of the backward's shared partials).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((4, 256, 8, 8), 32), ((4, 384, 32, 32), 32),
                                          ((2, 64, 96, 96), 32), ((4, 64, 6, 8), 32),
                                          ((4, 24, 5, 7), 4), ((2, 1100, 4, 4), 1)])
@pytest.mark.parametrize("rows", ["shared", "R1", "R2", "RB"])
def test_group_norm_kernels_take_a_gamma_row_per_run_of_samples(cuda, dtype, shape, groups,
                                                                 rows):
    rows = {"shared": None, "R1": 1, "R2": 2, "RB": shape[0]}[rows]
    x, gamma, beta, dy = _gn_case(cuda, shape, dtype, 8, rows)
    _check_gn_both(x, gamma, beta, dy, groups, True, dtype)


# The CelebA LDM's GroupNorms in the streaming class: a group of the U-Net's
# 224 channels at 64x64 holds 7 x 4096 elements (eps 1e-5), one of the
# VQ-VAE's 128 channels at 256x256 4 x 65,536 (eps 1e-6).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,eps", [((2, 224, 64, 64), 1e-5), ((1, 128, 256, 256), 1e-6)])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_kernels_at_the_ldm_streaming_shapes(cuda, dtype, shape, eps, silu):
    x, gamma, beta, dy = _gn_case(cuda, shape, dtype, 10)
    _check_gn_both(x, gamma, beta, dy, 32, silu, dtype, eps)


def test_group_norm_kernels_read_tensors_off_16_bytes(cuda):
    shape = (2, 64, 8, 8)
    n = torch.Size(shape).numel()
    x = torch.randn(n + 1, device=cuda)[1:].view(shape)
    dy = torch.randn(n + 1, device=cuda)[1:].view(shape)
    assert x.data_ptr() % 16
    _check_gn_both(x, torch.randn(64, device=cuda) + 1, torch.randn(64, device=cuda), dy, 32,
                   True, torch.float32)


# A transformer's GroupNorm in miniSD (no SiLU, eps 1e-5) at 32x32, width 320.
def test_group_norm_kernels_without_silu_at_the_minisd_transformer_norm(cuda):
    x, gamma, beta, dy = _gn_case(cuda, (2, 320, 32, 32), torch.float32, 13)
    _check_gn_both(x, gamma, beta, dy, 32, False, torch.float32, eps=1e-5)


def test_a_frozen_group_norm_returns_no_gamma_beta_gradient(cuda):
    """A gamma/beta that need no gradient (LoRA training's frozen base) get
    none, and their partials are not summed; dx still comes from the kernel."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(2, 320, 32, 32, generator=g, device=cuda).requires_grad_(True)
    gamma = torch.randn(320, generator=g, device=cuda) + 1
    beta = torch.randn(320, generator=g, device=cuda)
    y = group_norm_silu(x, gamma, beta, groups=32, eps=1e-5, silu=False)
    before = (group_norm_bwd_kernel.launches, group_norm_silu.affine_sums)
    y.square().sum().backward()
    assert (group_norm_bwd_kernel.launches, group_norm_silu.affine_sums) == (before[0] + 1,
                                                                             before[1])
    assert gamma.grad is None and beta.grad is None
    xc = x.detach().cpu().requires_grad_(True)
    group_norm_silu(xc, gamma.cpu(), beta.cpu(), groups=32, eps=1e-5,
                    silu=False).square().sum().backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, atol=5e-5, rtol=1e-5)


def test_autograd_functions_on_the_card_launch_the_backward_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(2, 64, 1, 64, generator=g, device=cuda).requires_grad_(True)
               for _ in range(3))
    out = dot_product_attention(q, k, v)
    assert out.grad_fn is not None
    before = (attention_bwd_dq.launches, attention_bwd_dkv.launches)
    out.square().sum().backward()
    assert (attention_bwd_dq.launches, attention_bwd_dkv.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    x = torch.randn(2, 64, 8, 8, generator=g, device=cuda).requires_grad_(True)
    w = torch.ones(64, device=cuda, requires_grad=True)
    y = group_norm_silu(x, w, torch.zeros(64, device=cuda, requires_grad=True), groups=32)
    assert y.grad_fn is not None
    before = group_norm_bwd_kernel.launches
    y.square().sum().backward()
    assert group_norm_bwd_kernel.launches == before + 1
    assert x.grad is not None and w.grad is not None


def _train_step_run(spec, weights, images, t, noise, device):
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D
    from group_attribution_for_diffusion_models_tpu_torch.training import (
        TrainState, make_optimizer, make_train_step)

    model = UNet2D(spec)
    model.load_state_dict(weights)
    tx = make_optimizer("adam", lr=1e-3)
    state = TrainState.create(model.to(device), tx)
    step = make_train_step(tx, make_schedule(SchedulerSpec(), device), SchedulerSpec())
    metrics = step(state, images.to(device), timesteps=t.to(device), noise=noise.to(device))
    return (metrics["loss"].item(), metrics["grad_norm"].item(),
            [p.grad.detach().cpu() for p in state.params])


def test_train_step_on_card_matches_cpu_and_repeats_bitwise(cuda):
    from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet

    spec = config_for("synthetic_32x8_big").unet
    weights = build_unet(spec, seed=0).state_dict()
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, 4))
    noise = torch.from_numpy(rng.standard_normal((4, 3, 8, 8)).astype(np.float32))
    loss_c, norm_c, grads_c = _train_step_run(spec, weights, images, t, noise, "cpu")
    loss_g, norm_g, grads_g = _train_step_run(spec, weights, images, t, noise, cuda)
    _, _, grads_g2 = _train_step_run(spec, weights, images, t, noise, cuda)
    assert abs(loss_g - loss_c) <= 1e-4 * loss_c
    assert abs(norm_g - norm_c) <= 1e-4 * norm_c
    gmax = max(g.abs().max().item() for g in grads_c)
    assert max((a - w).abs().max().item() for a, w in zip(grads_g, grads_c)) <= 1e-4 * gmax
    assert all(torch.equal(a, w) for a, w in zip(grads_g, grads_g2))


def test_bf16_compute_on_card_tracks_f32(cuda):
    """compute_dtype=bf16 (f32 parameters): the kernels get bf16 activations,
    the gradients stay f32 and within 5% of the f32 gradients' norm."""
    from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, build_unet

    spec = config_for("synthetic_32x8_big").unet
    weights = build_unet(spec, seed=0).state_dict()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 3, 8, 8)).astype(np.float32)).to(cuda)
    t = torch.tensor([999, 500, 3, 0], device=cuda)
    grads = {}
    for dtype in (None, torch.bfloat16):
        model = UNet2D(spec, compute_dtype=dtype).to(cuda)
        model.load_state_dict(weights)
        before = attention_bwd_dq.launches
        model(x, t).square().mean().backward()
        assert attention_bwd_dq.launches == before + 6
        grads[dtype] = torch.cat([p.grad.flatten() for p in model.parameters()])
        assert grads[dtype].dtype == torch.float32
    err = (grads[torch.bfloat16] - grads[None]).norm() / grads[None].norm()
    assert 0 < err.item() <= 0.05


def test_train_ensemble_on_card_goes_through_the_kernels(cuda, tmp_path):
    from group_attribution_for_diffusion_models_tpu_torch.cli import train_ensemble

    attention_kernel.launches = attention_bwd_dq.launches = attention_bwd_dkv.launches = 0
    group_norm_kernel.launches = group_norm_bwd_kernel.launches = 0
    summary = train_ensemble.main([
        "--dataset", "synthetic_32x8_big", "--removal_dist", "shapley", "--num_seeds", "2",
        "--training_steps", "3", "--outdir", str(tmp_path), "--eval_loss"])
    assert np.isfinite(summary["losses"]).all() and np.isfinite(summary["eval_losses"]).all()
    # _big, per forward: 6 attention layers and 31 GroupNorms; the 2 members
    # stacked, so 3 steps of one forward and backward for both, then one eval
    # forward per member.
    fwd, bwd = 3 + 2, 3
    assert (attention_kernel.launches, attention_bwd_dq.launches, attention_bwd_dkv.launches,
            group_norm_kernel.launches, group_norm_bwd_kernel.launches) == (
        6 * fwd, 6 * bwd, 6 * bwd, 31 * fwd, 31 * bwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,p", [(32, 1 << 18, 4096), (3, 70_001, 1000), (2, 5, 33),
                                   (40, 9_000, 513), (70, 100_003, 777)])
def test_jl_kernel_matches_plain(cuda, dtype, b, d, p):
    g = torch.randn(b, d, generator=torch.Generator(device=cuda).manual_seed(7),
                    device=cuda).to(dtype)
    before = jl_project_kernel.launches
    got = jl_project_kernel(g, p, seed=3)
    torch.cuda.synchronize()
    assert jl_project_kernel.launches == before + 1 and got.dtype == torch.float32
    want = jl_project_plain(g, p, seed=3)
    limit = 1e-6 * g.float().abs().sum(dim=1, keepdim=True) / p ** 0.5
    assert ((got - want).abs() <= limit).all()
    assert torch.equal(got, jl_project_kernel(g, p, seed=3))  # no atomics
    assert not torch.equal(got, jl_project_kernel(g, p, seed=4))
    assert torch.equal(jl_project(g, p, seed=3), got)


def test_jl_kernel_identity_rows_are_r_exactly(cuda):
    eye = torch.eye(48, 4000, device=cuda)
    assert torch.equal(jl_project_kernel(eye, 777, seed=5), jl_project_plain(eye, 777, seed=5))
    eye = eye.to(torch.bfloat16)
    assert torch.equal(jl_project_kernel(eye, 777, seed=5), jl_project_plain(eye, 777, seed=5))
    with pytest.raises(ValueError, match="contiguous"):
        jl_project_kernel(torch.zeros(8, 4, device=cuda).t(), 16)


def test_per_sample_gradients_on_card_batch_the_kernels(cuda):
    """vmap(grad) through the kernels' vmap rules: one launch per op for the
    whole batch, and the gradients of a per-example loop on the card."""
    from group_attribution_for_diffusion_models_tpu_torch.attributions.methods.trak import (
        PerSampleGradients)
    from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import add_noise, make_schedule
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet

    model = build_unet(config_for("synthetic_32x8_big").unet, seed=0).to(cuda).eval()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 3, 8, 8)).astype(np.float32)).to(cuda)
    n = torch.from_numpy(rng.standard_normal((3, 3, 8, 8)).astype(np.float32)).to(cuda)
    t = torch.tensor([999, 500, 3], device=cuda)
    schedule = make_schedule(SchedulerSpec(), cuda)
    x_t = add_noise(schedule, x, n, t)
    grads = PerSampleGradients(model)
    acc = torch.zeros((3, grads.dim), device=cuda)
    before = (attention_bwd_dq.launches, group_norm_bwd_kernel.launches)
    grads.accumulate(acc, x_t, t, n)
    assert (attention_bwd_dq.launches - before[0], group_norm_bwd_kernel.launches - before[1]) \
        == (6, 31)
    params = list(model.parameters())
    for b in range(3):
        eps = model(x_t[b:b + 1], t[b:b + 1])
        want = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            torch.mean((eps - n[b:b + 1]) ** 2), params)])
        assert (acc[b] - want).abs().max() <= 1e-4 * want.abs().max()


def test_jl_kernel_at_the_lora_gradient_width(cuda):
    """B5 where grad_features_tti calls it: a batch of 16 per-sample
    gradients of miniSD's rank-256 LoRA (D = 51,019,776) -> 4096."""
    b, d, p = 16, 51_019_776, 4096
    g = torch.randn(b, d, generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    before = jl_project_kernel.launches
    got = jl_project_kernel(g, p, seed=0)
    torch.cuda.synchronize()
    assert jl_project_kernel.launches == before + 1
    want = jl_project_plain(g, p, seed=0, tile_d=16_384)
    limit = 1e-6 * g.abs().sum(dim=1, keepdim=True) / p ** 0.5
    assert ((got - want).abs() <= limit).all()
    assert torch.equal(got, jl_project_kernel(g, p, seed=0))


def test_jl_kernel_over_a_long_window_of_d(cuda):
    """A row whose nonzero coordinates fill a long window: the truncating
    tensor-core accumulation of a block's chunk grows with its length, so the
    wrapper caps the chunk. With chunks of D / 132 (909,120 coordinates
    here) this row read 1.43x its tolerance on an H100, with chunks of 2^15
    0.07x; the plain version over the window alone is the reference (each
    output sums its row's coordinates)."""
    b, d, p, w = 1, 120_000_000, 4096, 1 << 24
    g = torch.zeros(b, d, device=cuda)
    g[:, d - w:] = torch.randn(b, w, generator=torch.Generator(device=cuda).manual_seed(9),
                               device=cuda)
    got = jl_project_kernel(g, p, seed=3)
    want = torch.zeros(b, p, device=cuda)
    for d0 in range(d - w, d, 16_384):
        d1 = min(d, d0 + 16_384)
        want += g[:, d0:d1] @ rademacher_rows(3, d0, d1, p, cuda)
    want *= float(np.float32(1 / np.sqrt(p)))
    limit = 1e-6 * g.abs().sum(dim=1, keepdim=True) / p ** 0.5
    assert ((got - want).abs() <= limit).all()


@pytest.mark.parametrize("b,sq,h,d", [(3, 1024, 8, 40), (3, 256, 8, 80), (2, 64, 8, 160)])
def test_attention_under_vmap_with_a_context_per_sample(cuda, b, sq, h, d):
    """Cross-attention over Skv = 77 text tokens under vmap(grad) with a
    different context (K, V) for each vmapped sample: one forward and one
    launch of each backward pass for the whole batch, and each sample's
    gradients those of a per-sample autograd call."""
    from torch.func import grad, vmap

    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(b, 1, sq, h, d, generator=g, device=cuda)
    k, v = (torch.randn(b, 1, 77, h, d, generator=g, device=cuda) for _ in range(2))
    w = torch.randn(1, sq, h, d, generator=g, device=cuda)

    def f(q1, k1, v1):
        return (dot_product_attention(q1, k1, v1) * w).sum()

    before = (attention_kernel.launches, attention_bwd_dq.launches, attention_bwd_dkv.launches)
    got = vmap(grad(f, argnums=(0, 1, 2)))(q, k, v)
    torch.cuda.synchronize()
    after = (attention_kernel.launches, attention_bwd_dq.launches, attention_bwd_dkv.launches)
    assert tuple(a - bf for a, bf in zip(after, before)) == (1, 1, 1)
    atol, rtol = TOL[torch.float32]
    for i in range(b):
        qi, ki, vi = (t[i].clone().requires_grad_(True) for t in (q, k, v))
        want = torch.autograd.grad(f(qi, ki, vi), (qi, ki, vi))
        for a, bw in zip(got, want):
            torch.testing.assert_close(a[i], bw, atol=atol, rtol=rtol)
