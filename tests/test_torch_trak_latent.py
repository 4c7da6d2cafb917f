"""TRAK features in VQ latents: the port's ``grad_features`` on a latent
workload against the JAX package, on the CPU.

- Per-sample timestep-mean gradients of a tiny latent U-Net with the
  CelebA U-Net's options (multi-head attention at head dim 8, symmetric
  downsample padding, flipped sin/cos, eps 1e-5) on 4x4x3 latents, against
  ``jax.vmap(jax.grad)`` of the JAX U-Net on the same latents, timesteps and
  noise, for every grad mode: full, attn_full (the attention projections'
  rows) and probe (the sketch down^T grad_kernel). Tolerance: max |g_port -
  g_jax| <= 1e-4 * max |g_jax| per row, as tests/test_torch_trak.py holds
  the pixel U-Net.
- The CLI end to end on ``synthetic_32x16_ldm``: the train source's rows
  are the projected gradients of the tagged latents cache times the
  VQ-VAE's scaling factor; the generated source's those of the sampler's
  raw final latents; the journey's those of its latent trajectory, each with
  the CLI's own noise streams, bit for bit; probe and attn_full run; then
  ``traks`` on the latent store writes the files the JAX ``traks`` writes,
  byte for byte.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import traks as jax_traks
from group_attribution_for_diffusion_models_tpu.config import SchedulerSpec as JaxSchedulerSpec
from group_attribution_for_diffusion_models_tpu.config import UNetSpec as JaxUNetSpec
from group_attribution_for_diffusion_models_tpu.diffusion import make_schedule as jax_make_schedule
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import add_noise as jax_add_noise
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu_torch.attributions.methods import trak
from group_attribution_for_diffusion_models_tpu_torch.cli import grad_features, traks
from group_attribution_for_diffusion_models_tpu_torch.cli.common import (
    config_for,
    latents_cache_path,
)
from group_attribution_for_diffusion_models_tpu_torch.cli.generate_samples import batch_generator
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.diffusion import (
    make_schedule,
    sample_loop,
    sample_with_trajectory,
)
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
    attention_params_filter,
    probe_sketch_init,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint
from test_torch_unet import _jax_params, _port_spec

GRAD_RTOL = 1e-4
TIMESTEPS = 2  # feature grid (0, 500)
B = 3
DATASET = "synthetic_32x16_ldm"  # 16x16 images, 4x4x3 VQ latents
LATENT_UNET = JaxUNetSpec(
    sample_size=4,
    in_channels=3,
    out_channels=3,
    block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    norm_num_groups=4,
    attention_head_dim=8,
    norm_eps=1e-5,
    downsample_padding=1,
    flip_sin_to_cos=True,
    freq_shift=0.0,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ldm():
    """The JAX params, the port's model carrying them, latents (NHWC) and
    one noise draw per timestep, and the JAX per-sample mean gradients as
    port-named dicts."""
    params = _jax_params(LATENT_UNET, 8)
    model = UNet2D(_port_spec(LATENT_UNET))
    model.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(12)
    latents = rng.standard_normal((B, 4, 4, 3)).astype(np.float32)
    noise = rng.standard_normal((TIMESTEPS, B, 4, 4, 3)).astype(np.float32)
    spec = JaxSchedulerSpec()
    schedule = jax_make_schedule(spec)
    apply = JaxUNet2D(LATENT_UNET).apply
    ts = jnp.asarray(trak.feature_timesteps(spec.num_train_timesteps, TIMESTEPS))

    def loss(p, x0, n, t):
        x_t = jax_add_noise(schedule, x0[None], n[None], t[None])
        return jnp.mean((apply({"params": p}, x_t, t[None])[0] - n) ** 2)

    def per_sample(p, x0, noises):
        g = jax.vmap(jax.grad(loss), in_axes=(None, None, 0, 0))(p, x0, noises, ts)
        return jax.tree_util.tree_map(lambda v: v.mean(0), g)

    grads = jax.jit(jax.vmap(per_sample, in_axes=(None, 0, 1)))(
        params, jnp.asarray(latents), jnp.asarray(noise))
    grads = jax.tree_util.tree_map(np.asarray, grads)
    want = [params_from_jax(jax.tree_util.tree_map(lambda g: g[b], grads)) for b in range(B)]
    return model.eval(), latents, noise, want


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _mean_grads(model, latents, noise, **kw):
    spec = SchedulerSpec()
    fn = trak.make_grad_feature_fn(model, make_schedule(spec), spec,
                                   num_timesteps=TIMESTEPS, **kw)
    return fn.mean_gradients(_nchw(latents), noise=[_nchw(n) for n in noise])


def _rows(per_sample, names):
    return torch.stack([torch.cat([s[n].reshape(-1) for n in names]) for s in per_sample])


def _assert_rows_close(got, want):
    for b in range(got.shape[0]):
        scale = want[b].abs().max().item()
        assert scale > 0
        assert (got[b] - want[b]).abs().max().item() <= GRAD_RTOL * scale, b


def test_full_gradients_in_latents_match_jax(ldm):
    model, latents, noise, want = ldm
    names = [n for n, _ in model.named_parameters()]
    got = _mean_grads(model, latents, noise)
    assert got.shape == (B, sum(p.numel() for p in model.parameters()))
    _assert_rows_close(got, _rows(want, names))


def test_attn_full_gradients_in_latents_match_jax(ldm):
    model, latents, noise, want = ldm
    names = attention_params_filter(model)
    assert len(names) == 32 and all(".to_" in n for n in names)
    _assert_rows_close(_mean_grads(model, latents, noise, params_filter=names),
                       _rows(want, names))


def test_probe_sketch_in_latents_is_down_transpose_times_the_jax_gradient(ldm):
    model, latents, noise, want = ldm
    probe = probe_sketch_init(model, k=4, generator=torch.Generator().manual_seed(0))
    assert len(probe) == 16
    sketch = _mean_grads(model, latents, noise, sketch_probe=probe)
    offset = 0
    for m, ab in probe.items():
        k, out = ab["up"].shape
        got = sketch[:, offset:offset + k * out].reshape(B, -1)
        offset += k * out
        grad_w = torch.stack([s[f"{m}.weight"] for s in want])  # (B, out, in)
        _assert_rows_close(got, (ab["down"].T @ grad_w.transpose(1, 2)).reshape(B, -1))
    assert offset == sketch.shape[1]


def test_grad_features_cli_on_a_latent_workload(ldm, tmp_path):
    model, _, _, _ = ldm
    spec = _port_spec(LATENT_UNET)
    sd = model.state_dict()
    ema = {k: v + 0.01 for k, v in sd.items()}  # samples come from the EMA weights
    save_checkpoint(str(tmp_path / "m"), 2, sd, ema, unet_spec=spec)
    store = str(tmp_path / "f" / "feats.npz")
    seed, proj = 42, 16
    common = ["--dataset", DATASET, "--outdir", str(tmp_path), "--load", str(tmp_path / "m"),
              "--save_path", store, "--proj_dim", str(proj), "--num_timesteps",
              str(TIMESTEPS), "--batch_size", str(B), "--num_inference_steps", "2",
              "--seed", str(seed), "--device", "cpu"]
    cfg = config_for(DATASET)
    sched = make_schedule(cfg.scheduler)
    feat_fn = trak.make_grad_feature_fn(model, sched, cfg.scheduler, proj_dim=proj,
                                        num_timesteps=TIMESTEPS)

    def projected(x, b):
        return feat_fn(x, generator=batch_generator(seed + 1, b, "cpu")).numpy()

    train = grad_features.main(common + ["--source", "train", "--max_examples", "6"])
    assert train["features_shape"] == (6, proj)
    cache = latents_cache_path(str(tmp_path), DATASET)
    latents = np.load(cache) * cfg.vqvae.scaling_factor
    assert latents.shape == (32, 4, 4, 3) and os.path.exists(cache[:-4] + ".tag.json")
    got = np.load(store)["train_features"]
    for b in range(2):
        np.testing.assert_array_equal(got[b * B:(b + 1) * B],
                                      projected(_nchw(latents[b * B:(b + 1) * B]), b))

    gen = grad_features.main(common + ["--source", "generated", "--n_samples", str(B)])
    assert gen["features_shape"] == (B, proj)
    ema_model = UNet2D(spec)
    ema_model.load_state_dict(ema)
    raw = sample_loop(ema_model.eval(), sched, cfg.scheduler, (B, 3, 4, 4), device="cpu",
                      generator=batch_generator(seed, 0, "cpu"), num_inference_steps=2,
                      kind="ddim", postprocess=False)
    assert raw.min() < 0.0  # raw latents, not post-processed to [0, 1]
    np.testing.assert_array_equal(np.load(store)["gen_features"], projected(raw, 0))

    journey = grad_features.main(common + ["--source", "generated_journey",
                                           "--n_samples", str(B)])
    _, traj, ts = sample_with_trajectory(ema_model, sched, cfg.scheduler, (B, 3, 4, 4),
                                         device="cpu", generator=batch_generator(seed, 0, "cpu"),
                                         num_inference_steps=2)
    jfn = trak.make_journey_feature_fn(model, sched, cfg.scheduler, proj_dim=proj)
    assert journey["features_shape"] == (B, proj)
    np.testing.assert_array_equal(
        np.load(store)["gen_features"],
        jfn(traj, ts, generator=batch_generator(seed + 1, 0, "cpu")).numpy())
    probe_dim = sum(ab["up"].numel() for ab in probe_sketch_init(model, k=4).values())
    attn_dim = sum(p.numel() for n, p in model.named_parameters()
                   if n in attention_params_filter(model))
    for mode, dim in (("probe", probe_dim), ("attn_full", attn_dim)):
        out = grad_features.main(common + ["--source", "train", "--max_examples", str(B),
                                           "--grad_mode", mode, "--sketch_k", "4",
                                           "--save_path", str(tmp_path / f"{mode}.npz")])
        feats = np.load(tmp_path / f"{mode}.npz")["train_features"]
        assert feats.shape == (B, proj) and np.isfinite(feats).all() and feats.std() > 0
        assert out["grad_dim"] == dim

    # traks on the latent store (train rows from the first call, gen rows from
    # the journey): the JAX traks writes the same files.
    argv = ["--feature_store", store, "--agg_mode", "mean"]
    attrs = traks.main(argv + ["--save_dir", str(tmp_path / "port")])
    jax_traks.main(argv + ["--save_dir", str(tmp_path / "jax")])
    labels = np.load(store)["group_labels"]
    for a in attrs.values():
        assert a.shape == (len(np.unique(labels)),) and np.isfinite(a).all()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 8
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


@pytest.mark.parametrize("b,d", [(8, 274_056_163), (32, 35_746_307), (16, 51_019_776),
                                 (3, 70_001), (1, 2**32 - 1)])
def test_jl_split_caps_the_chunk_a_block_sums(monkeypatch, b, d):
    """The JL kernel's split of D (host side): whole tiles covering D once, a
    block summing at most 2^15 coordinates (the tensor cores' truncating
    accumulation grows with that length), longer only where the grid's 65,535
    chunks force it."""
    from group_attribution_for_diffusion_models_tpu_torch.ops import jl_projection

    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    chunk, splits = jl_projection._split(b, d, 4096, "cuda")
    assert chunk % 64 == 0 and (splits - 1) * chunk < d <= splits * chunk
    assert splits <= 65_535
    assert chunk <= 1 << 15 or chunk <= -(-d // 65_535) + 64
