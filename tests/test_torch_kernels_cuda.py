"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without a CUDA device and run on the GPU machine
with `python -m pytest tests/test_torch_kernels_cuda.py -m cuda`.
Tolerances (atol, rtol): float32 (5e-5, 1e-5), for summation order only;
bfloat16 (1e-2, 2**-7): both sides round f32 results that differ in the
last bits to bf16, so they may land one bf16 ulp (2**-7 relative) apart.
"""

import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu_torch.ops import (
    attention_kernel,
    attention_plain,
    group_norm_kernel,
    group_norm_silu_plain,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (5e-5, 1e-5), torch.bfloat16: (1e-2, 2**-7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,d", [
    (4, 256, 256, 1, 256), (4, 16, 16, 1, 256), (2, 1024, 1024, 14, 32),
    (1, 130, 77, 2, 40), (2, 64, 64, 3, 80), (1, 300, 300, 2, 160),
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
