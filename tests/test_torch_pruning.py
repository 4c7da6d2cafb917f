"""The port's structural pruning against the JAX package's, on the CPU.

Random JAX UNet2D params (the tiny synthetic specs) go through
`params_from_jax` into the port's state dict. Magnitude and random scores
must match the JAX scores within rtol 1e-5 (random ones are the same numpy
stream, walked in the JAX block order); the kept channels,
`pruned_channels` and every sliced tensor must equal JAX `prune_unet`'s
after the bridge, bit for bit. Taylor scores, with the JAX noise injected
through `noise_fn`, must match within rtol 1e-4 (f32 gradients summed in
other orders) and keep the same channels. The pruned forwards of both
packages agree within the U-Net tests' atol 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli.common import (
    config_for as jax_config_for,
)
from group_attribution_for_diffusion_models_tpu.diffusion import make_schedule as jax_schedule
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.pruning import structural as jax_pruning
from group_attribution_for_diffusion_models_tpu_torch.cli import prune as prune_cli
from group_attribution_for_diffusion_models_tpu_torch.config import registry
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.pruning import (
    count_params,
    magnitude_importance,
    prune_unet,
    random_importance,
    resnet_block_paths,
    taylor_importance,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import (
    load_checkpoint,
    load_meta,
    load_unet_spec,
    save_checkpoint,
)

CONFIGS = ["synthetic_32x8", "synthetic_32x8_big"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its U-Nets are tiny, and the
    test workers share the CPU, where torch's default of a thread per core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(spec, seed):
    """Random params in the JAX UNet2D's tree (shapes from eval_shape):
    kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.01), norm scales ~ 1 + N(0, 0.01)."""
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
    return registry.UNetSpec(**dataclasses.asdict(spec))


_CASES = {}


def _case(name, seed=0):
    """(JAX spec, JAX params, port state dict), made once a (name, seed); no
    test changes them."""
    if (name, seed) not in _CASES:
        spec = jax_config_for(name).unet
        params = _jax_params(spec, seed)
        _CASES[name, seed] = spec, params, params_from_jax(params)
    return _CASES[name, seed]


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _assert_pruned_equal(jax_out, port_out):
    """Same pruned spec and bit-identical sliced tensors after the bridge."""
    (jax_spec, jax_params), (port_spec, port_state) = jax_out, port_out
    assert dict(port_spec.pruned_channels) == dict(jax_spec.pruned_channels)
    _assert_state_equal(port_state, params_from_jax(jax_params))


@pytest.mark.parametrize("name", CONFIGS)
def test_block_paths_in_the_jax_order(name):
    _, params, state = _case(name)
    paths = resnet_block_paths(state)
    assert paths == tuple(jax_pruning.resnet_block_paths(params))
    # Creation order: down blocks, the mid block, up blocks; whatever the
    # state dict's key order.
    assert resnet_block_paths(dict(reversed(list(state.items())))) == paths
    if name == "synthetic_32x8":
        assert paths == ("down_0_res_0", "down_1_res_0", "mid_res_0", "mid_res_1",
                         "up_0_res_0", "up_0_res_1", "up_1_res_0", "up_1_res_1")


@pytest.mark.parametrize("name", CONFIGS)
def test_magnitude_and_random_scores_match_jax(name):
    _, params, state = _case(name)
    got, want = magnitude_importance(state), jax_pruning.magnitude_importance(params)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
    for seed in (0, 3):
        got = random_importance(state, seed=seed)
        want = jax_pruning.random_importance(params, seed=seed)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("ratio", [0.3, 0.5])
@pytest.mark.parametrize("pruner", ["magnitude", "random"])
def test_prune_unet_slices_match_jax_bitwise(name, ratio, pruner):
    spec, params, state = _case(name)
    if pruner == "magnitude":
        jax_imp, port_imp = (jax_pruning.magnitude_importance(params),
                             magnitude_importance(state))
    else:
        jax_imp, port_imp = (jax_pruning.random_importance(params, seed=1),
                             random_importance(state, seed=1))
    want = jax_pruning.prune_unet(spec, params, ratio, jax_imp)
    assert want[0].pruned_channels  # something was pruned
    # The JAX scores through the port's transform, and the port's own scores.
    _assert_pruned_equal(want, prune_unet(_port_spec(spec), state, ratio, jax_imp))
    got_spec, got_state = prune_unet(_port_spec(spec), state, ratio, port_imp)
    _assert_pruned_equal(want, (got_spec, got_state))
    assert count_params(got_state) == jax_pruning.count_params(want[1])
    assert all(v % spec.norm_num_groups == 0 for v in got_spec.pruned_channels.values())
    UNet2D(got_spec).load_state_dict(got_state, strict=True)
    with pytest.raises(ValueError, match="pruning_ratio"):
        prune_unet(_port_spec(spec), state, 1.0, port_imp)


def _jax_taylor_noise(images, seed, num_timesteps, stride):
    """The JAX taylor_importance's noise draws, by timestep, NCHW."""
    key = jax.random.PRNGKey(seed)
    out = {}
    for t in range(num_timesteps - 1, -1, -stride):
        key, sub = jax.random.split(key)
        out[t] = torch.from_numpy(
            np.asarray(jax.random.normal(sub, images.shape)).transpose(0, 3, 1, 2).copy())
    return out


@pytest.mark.parametrize("name,threshold", [("synthetic_32x8_big", None),
                                            ("synthetic_32x8", 0.999)])
def test_taylor_scores_and_pruned_forward_match_jax(name, threshold):
    batch, stride, seed = 4, 250, 5
    spec, params, state = _case(name, seed=1)
    cfg = jax_config_for(name)
    images = create_dataset(name).images[:batch]
    want = jax_pruning.taylor_importance(
        JaxUNet2D(spec).apply, params, jax_schedule(cfg.scheduler), images,
        num_timesteps=cfg.scheduler.num_train_timesteps, timestep_stride=stride,
        loss_threshold=threshold, seed=seed, batch_size=batch)
    noise = _jax_taylor_noise(images, seed, cfg.scheduler.num_train_timesteps, stride)
    model = UNet2D(_port_spec(spec))
    model.load_state_dict(state)
    got = taylor_importance(
        model, make_schedule(cfg.scheduler), images,
        num_timesteps=cfg.scheduler.num_train_timesteps, timestep_stride=stride,
        loss_threshold=threshold, seed=seed, batch_size=batch, noise_fn=noise.__getitem__)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0)

    jax_spec, jax_pruned = jax_pruning.prune_unet(spec, params, 0.3, want)
    port_spec, port_pruned = prune_unet(_port_spec(spec), state, 0.3, got)
    _assert_pruned_equal((jax_spec, jax_pruned), (port_spec, port_pruned))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, spec.sample_size, spec.sample_size, 3)).astype(np.float32)
    t = np.array([999, 17], dtype=np.int32)
    ref = np.asarray(jax.jit(JaxUNet2D(jax_spec).apply)(
        {"params": jax_pruned}, jnp.asarray(x), jnp.asarray(t)))
    pruned = UNet2D(port_spec)
    pruned.load_state_dict(port_pruned, strict=True)
    with torch.no_grad():
        out = pruned.eval()(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(t).long())
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4, rtol=0)


def test_taylor_draws_seeded_noise_on_its_own():
    name = "synthetic_32x8"
    spec, _, state = _case(name)
    cfg = jax_config_for(name)
    model = UNet2D(_port_spec(spec))
    model.load_state_dict(state)
    images = create_dataset(name).images
    run = [taylor_importance(model, make_schedule(cfg.scheduler), images, timestep_stride=400,
                             seed=s, batch_size=4) for s in (0, 0, 1)]
    assert all(np.array_equal(run[0][k], run[1][k]) for k in run[0])
    assert not all(np.array_equal(run[0][k], run[2][k]) for k in run[0])
    assert model.training  # left as it was found


@pytest.mark.parametrize("pruner", ["magnitude", "random", "taylor"])
def test_prune_cli_writes_a_step0_checkpoint_of_the_pruned_params(tmp_path, pruner):
    name = "synthetic_32x8_big"
    spec, params, state = _case(name)
    src = str(tmp_path / "full")
    ema = {k: v + 1.0 for k, v in state.items()}  # the CLI prunes params, not the EMA
    save_checkpoint(src, 7, state, ema, unet_spec=_port_spec(spec))
    summary = prune_cli.main(["--dataset", name, "--load", src, "--pruner", pruner,
                              "--pruning_ratio", "0.5", "--opt_seed", "4",
                              "--timestep_stride", "500", "--taylor_batch_size", "4",
                              "--outdir", str(tmp_path), "--device", "cpu"])
    out = os.path.join(str(tmp_path), name, "prune", "models", "full")
    assert summary["model_dir"] == out
    ckpt, meta = load_checkpoint(out), load_meta(out)
    assert ckpt["step"] == 0 and meta["step"] == 0
    _assert_state_equal(ckpt["ema_params"], ckpt["params"])
    saved_spec = load_unet_spec(meta)
    assert saved_spec == summary["spec"]
    if pruner != "taylor":
        imp = (jax_pruning.magnitude_importance(params) if pruner == "magnitude"
               else jax_pruning.random_importance(params, seed=4))
        want = jax_pruning.prune_unet(spec, params, 0.5, imp)
        _assert_pruned_equal(want, (saved_spec, ckpt["params"]))
    assert summary["params_after"] == count_params(ckpt["params"]) < summary["params_before"]
