"""`models.unet2d.empty_unet`, the U-Net the CLIs build for a checkpoint's
weights, on the CPU.

* Filled by `load_state_dict`, it computes what the model that made the
  weights computes, bit for bit (the same f32 ops on the same tensors), on
  the unconditional and the cross-attention tiny configs.
* It draws nothing: torch's global generator is where it was, where a
  UNet2D built the usual way draws its whole initialisation from it.
"""

import pytest
import torch

from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.models import (
    UNet2D,
    build_unet,
    empty_unet,
)


@pytest.mark.parametrize("dataset", ["synthetic_64x8", "synthetic_64x8_cond"])
def test_loaded_empty_unet_computes_what_the_source_computes(dataset):
    spec = config_for(dataset).unet
    source = build_unet(spec, seed=3).eval()
    model = empty_unet(spec).eval()
    model.load_state_dict(source.state_dict())
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, spec.in_channels, spec.sample_size, spec.sample_size), generator=g)
    t = torch.tensor([999, 10])
    ctx = (torch.randn((2, 77, spec.cross_attention_dim), generator=g)
           if spec.cross_attention_dim else None)
    with torch.no_grad():
        assert torch.equal(model(x, t, ctx), source(x, t, ctx))


def test_empty_unet_draws_nothing():
    spec = config_for("synthetic_64x8").unet
    before = torch.random.get_rng_state()
    model = empty_unet(spec)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert all(p.device.type == "cpu" for p in model.parameters())
    UNet2D(spec)
    assert not torch.equal(torch.random.get_rng_state(), before)
