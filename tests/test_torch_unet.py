"""The port's UNet2D against the JAX package's, through the weight bridge.

Random JAX UNet2D params (every bias and norm scale non-trivial) go through `params_from_jax` into the port's state dict; both
forwards run on the same numpy inputs in float32 on the CPU. Tolerance: atol
1e-4 on outputs of order 1, for convolutions summed in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli.common import (
    config_for as jax_config_for,
)
from group_attribution_for_diffusion_models_tpu.config import registry as jax_registry
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.config import registry
from group_attribution_for_diffusion_models_tpu_torch.models import (
    UNet2D,
    params_from_jax,
    params_to_jax,
)


def _variant(name):
    spec = jax_config_for(name.split(":")[0]).unet
    if name.endswith(":celeba_opts"):
        # celeba-style options: symmetric downsample padding, flipped sin/cos
        # with no frequency shift, multi-head attention, a pruned resnet.
        spec = dataclasses.replace(
            spec, downsample_padding=1, flip_sin_to_cos=True, freq_shift=0.0,
            attention_head_dim=16, pruned_channels={"down_1_res_0": 48},
        )
    return spec


def _jax_params(spec, seed):
    """Random params in the JAX UNet2D's tree (shapes from eval_shape, so
    nothing is compiled): kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.01),
    norm scales ~ 1 + N(0, 0.01)."""
    x = jnp.zeros((1, spec.sample_size, spec.sample_size, spec.in_channels))
    shapes = jax.eval_shape(JaxUNet2D(spec).init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return (z / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (1.0 if name == "scale" else 0.0) + np.float32(0.1) * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_spec(spec):
    d = dataclasses.asdict(spec)
    return registry.UNetSpec(**d)


@pytest.mark.parametrize("name", ["synthetic_32x8", "synthetic_32x8_big",
                                  "synthetic_32x8_big:celeba_opts"])
def test_unet_forward_matches_jax(name):
    spec = _variant(name)
    params = _jax_params(spec, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, spec.sample_size, spec.sample_size, 3)).astype(np.float32)
    t = np.array([999, 17], dtype=np.int32)
    want = np.asarray(jax.jit(JaxUNet2D(spec).apply)({"params": params}, jnp.asarray(x),
                                                     jnp.asarray(t)))

    model = UNet2D(_port_spec(spec))
    model.load_state_dict(params_from_jax(params), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


def test_bridge_round_trip():
    spec = _variant("synthetic_32x8_big")
    params = _jax_params(spec, 2)
    back = params_to_jax(params_from_jax(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_registry_equal_field_for_field():
    for name in jax_registry._REGISTRY:
        assert dataclasses.asdict(registry.get_config(name)) == dataclasses.asdict(
            jax_registry.get_config(name)
        ), name
    for name in ("synthetic_32x8", "synthetic_64x16_big", "synthetic_32x32_ldm",
                 "synthetic_32x8_cond"):
        assert dataclasses.asdict(config_for(name)) == dataclasses.asdict(
            jax_config_for(name)
        ), name


def test_cifar_unet_shapes_and_counts():
    """Full-width CIFAR: the diffusers parameter count (35.7M) and the
    kernel calls one forward makes (6 attention, 51 GroupNorm)."""
    model = UNet2D(registry.get_config("cifar").unet)
    assert sum(p.numel() for p in model.parameters()) == 35_746_307
    attn = [m for m in model.modules() if type(m).__name__ == "SelfAttention2D"]
    norms = [m for m in model.modules() if type(m).__name__ == "GroupNormSiLU"]
    assert (len(attn), len(norms)) == (6, 51)
