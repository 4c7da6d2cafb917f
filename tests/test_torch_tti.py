"""The port's text-to-image towers against the JAX package's, on the CPU.

The same numpy-drawn parameters (carried across by `params_from_jax`,
`kl_vae_params_from_jax`, `clip_text_params_from_jax` and
`lora_tree_from_jax`) and the same numpy inputs go through both packages at
tiny sizes: `tiny_sd_spec(8)` (widths 16 and 32, 2 heads, a 32-wide
context), a 2-layer CLIP of width 32, a 2-level KL VAE of widths 8 and 16.

Tolerances, all f32 on both sides: a transformer layer within 1e-5
(a few products of width 16 to 128, outputs of order 1); the conditional
U-Net forward within 1e-5, its gradient with respect to the LoRA tree
within 1e-4 of each leaf's largest entry (a backward through 12 layers,
summed in other orders); the CLIP tower within 1e-5; the KL VAE within 1e-4
(as the VQ-VAE's, about 20 convolutions and 14 GroupNorms); the merged LoRA
against the side branch within 1e-5. Token ids, group splits, rank pruning
and the npz files are compared exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from group_attribution_for_diffusion_models_tpu.cli import (
    train_text_to_image_lora as jax_tti,
)
from group_attribution_for_diffusion_models_tpu.config import registry as jax_registry
from group_attribution_for_diffusion_models_tpu.data import groups as jax_groups
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    inference_timesteps as jax_inference_timesteps,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_betas as jax_make_betas,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.models import clip_text as jax_clip
from group_attribution_for_diffusion_models_tpu.models import layers as jax_layers
from group_attribution_for_diffusion_models_tpu.models import lora as jax_lora
from group_attribution_for_diffusion_models_tpu.models import vqvae as jax_vqvae
from group_attribution_for_diffusion_models_tpu.models.clip_tokenizer import (
    CLIPBPETokenizer as JaxBPE,
)
from group_attribution_for_diffusion_models_tpu_torch.cli.train_text_to_image_lora import (
    tiny_sd_spec,
)
from group_attribution_for_diffusion_models_tpu_torch.config import registry
from group_attribution_for_diffusion_models_tpu_torch.data import groups
from group_attribution_for_diffusion_models_tpu_torch.diffusion.schedulers import (
    inference_timesteps,
    make_betas,
)
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.models.clip_text import (
    CLIPTextEncoder,
    HashTokenizer,
    load_clip_text,
    load_tokenizer,
)
from group_attribution_for_diffusion_models_tpu_torch.models.clip_tokenizer import (
    CLIPBPETokenizer,
)
from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
    clip_text_params_from_jax,
    kl_vae_params_from_jax,
    kl_vae_params_to_jax,
    lora_tree_from_jax,
    lora_tree_to_jax,
    params_to_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.models.layers import (
    CrossAttention,
    SpatialTransformer,
    TransformerBlock,
)
from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
    load_lora_npz,
    lora_collection,
    lora_init,
    lora_merge,
    lora_num_params,
    lora_ranks,
    prune_lora,
    save_lora_npz,
)
from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import (
    AutoencoderKL,
    load_sd_vae,
)
from test_clip_tokenizer import PROMPTS, _write_tiny_vocab
from test_torch_unet import _port_spec

SPEC = tiny_sd_spec(8)
CTX = 32  # tiny_sd_spec's cross_attention_dim
KL_SPEC = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
               norm_num_groups=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny products run faster on one thread than on every core with the
    tier's other workers beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(shapes, seed):
    """Numpy parameters for a JAX shape tree: kernels ~ N(0, 1/fan_in),
    embeddings ~ N(0, 1/width), position embeddings ~ 0.01 N(0, 1), norm
    scales ~ 1 + 0.1 N(0, 1), biases ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return (z / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "embedding":
            return (z / np.sqrt(leaf.shape[-1])).astype(np.float32)
        if name == "position_embedding":
            return np.float32(0.01) * z
        return ((1.0 if name == "scale" else 0.0) + np.float32(0.1) * z).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _unet_params(seed):
    x = jnp.zeros((1, 8, 8, 4))
    shapes = jax.eval_shape(JaxUNet2D(SPEC).init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5, CTX)))["params"]
    return _draw(shapes, seed)


def _port_unet(params):
    model = UNet2D(_port_spec(SPEC))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def _lora_tree(params, seed, rank=3):
    """A numpy LoRA tree on every target, both factors nonzero."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path in jax_lora._iter_dense_paths(params, jax_lora.DEFAULT_TARGETS):
        d_in, d_out = jax_lora._get(params, path)["kernel"].shape
        r = min(rank, d_in, d_out)
        tree["/".join(path)] = {
            "down": (rng.standard_normal((d_in, r)) / np.sqrt(d_in)).astype(np.float32),
            "up": (0.3 * rng.standard_normal((r, d_out)) / np.sqrt(r)).astype(np.float32)}
    return tree


def _nchw(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).permute(0, 3, 1, 2)


def _inputs(seed, b=2, m=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, m, CTX)).astype(np.float32)
    return x, np.array([999, 17][:b], np.int32), ctx


@pytest.fixture(scope="module")
def unet_case():
    """One tiny conditional U-Net, a LoRA tree and inputs, shared."""
    params = _unet_params(0)
    return params, _lora_tree(params, 1), _inputs(2)


def test_minisd_specs_equal_the_jax_registry_field_for_field():
    import dataclasses

    for name in ("MINISD_UNET", "MINISD_SCHEDULER", "MINISD_VAE",
                 "ARTBENCH_POST_IMPRESSIONISM_LORA"):
        assert dataclasses.asdict(getattr(registry, name)) == dataclasses.asdict(
            getattr(jax_registry, name)), name
    assert registry.PROMPTS_ARTBENCH == jax_registry.PROMPTS_ARTBENCH
    assert registry.ARTBENCH_NUM_GROUPS == jax_registry.ARTBENCH_NUM_GROUPS == 258
    assert dataclasses.asdict(registry.KLVAESpec()) == dataclasses.asdict(
        jax_registry.KLVAESpec())
    sched = registry.MINISD_SCHEDULER
    assert (sched.beta_schedule, sched.steps_offset, sched.clip_sample) == (
        "scaled_linear", 1, False)
    np.testing.assert_array_equal(make_betas(sched), np.asarray(
        jax_make_betas(jax_registry.MINISD_SCHEDULER)))
    for steps in (50, 100):
        np.testing.assert_array_equal(
            inference_timesteps(1000, steps, sched.timestep_spacing, sched.steps_offset),
            np.asarray(jax_inference_timesteps(1000, steps, sched.timestep_spacing,
                                               sched.steps_offset)))


def test_minisd_towers_have_the_published_sizes():
    from group_attribution_for_diffusion_models_tpu_torch.models.layers import GroupNormSiLU
    from group_attribution_for_diffusion_models_tpu_torch.models.lora import target_modules

    with torch.device("meta"):
        unet = UNet2D(registry.MINISD_UNET)
        text, vae = CLIPTextEncoder(), AutoencoderKL(registry.MINISD_VAE)
    assert sum(p.numel() for p in unet.parameters()) == 859_520_964
    assert sum(p.numel() for p in text.parameters()) == 123_060_480
    assert sum(p.numel() for p in vae.parameters()) == 83_653_863
    assert sum(isinstance(m, CrossAttention) for m in unet.modules()) == 32
    assert sum(isinstance(m, SpatialTransformer) for m in unet.modules()) == 16
    assert sum(isinstance(m, GroupNormSiLU) for m in unet.modules()) == 61  # 22 resnets x 2, 16 transformers, conv_norm_out
    targets = target_modules(unet)
    assert len(targets) == 128
    assert sum(min(256, m.in_features, m.out_features) * (m.in_features + m.out_features)
               for _, m in targets) == 51_019_776


def _sub_state(tree, wrap, prefix):
    """Port state dict of a JAX transformer subtree, via the U-Net bridge."""
    sd = params_from_jax(wrap(tree))
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize("which", ["cross_attention", "transformer_block",
                                   "spatial_transformer"])
def test_transformer_layers_match_jax(which):
    rng = np.random.default_rng(3)
    b, h, w, c, m, heads = 2, 4, 3, 16, 7, 2  # Sq = 12 tokens, Skv = 7
    x = rng.standard_normal((b, h * w, c)).astype(np.float32)
    ctx = rng.standard_normal((b, m, CTX)).astype(np.float32)
    base = "mid_block.attentions.0."
    if which == "cross_attention":
        jmod = jax_layers.CrossAttention(heads)
        args = (jnp.asarray(x), jnp.asarray(ctx))
        wrap = lambda t: {"mid_xattn": {"block_0": {"attn2": t}}}  # noqa: E731
        prefix = base + "transformer_blocks.0.attn2."
        port = CrossAttention(c, heads, CTX)
        port_args = (torch.from_numpy(x), torch.from_numpy(ctx))
    elif which == "transformer_block":
        jmod = jax_layers.TransformerBlock(heads)
        args = (jnp.asarray(x), jnp.asarray(ctx))
        wrap = lambda t: {"mid_xattn": {"block_0": t}}  # noqa: E731
        prefix = base + "transformer_blocks.0."
        port = TransformerBlock(c, heads, CTX)
        port_args = (torch.from_numpy(x), torch.from_numpy(ctx))
    else:
        jmod = jax_layers.SpatialTransformer(heads, groups=4, eps=1e-5)
        xs = x.reshape(b, h, w, c)
        args = (jnp.asarray(xs), jnp.asarray(ctx))
        wrap = lambda t: {"mid_xattn": t}  # noqa: E731
        prefix = base
        port = SpatialTransformer(c, heads, CTX, groups=4, eps=1e-5)
        port_args = (_nchw(xs), torch.from_numpy(ctx))
    params = _draw(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)["params"], 4)
    want = np.asarray(jmod.apply({"params": params}, *args))
    port.load_state_dict(_sub_state(params, wrap, prefix), strict=True)
    with torch.no_grad():
        got = port(*port_args)
    if which == "spatial_transformer":
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_conditional_unet_forward_and_lora_gradient_match_jax(unet_case):
    params, lora_np, (x, t, ctx) = unet_case
    model = JaxUNet2D(SPEC)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x),
                                           jnp.asarray(t), jnp.asarray(ctx)))
    port = _port_unet(params)
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)

    target = np.random.default_rng(5).standard_normal(want.shape).astype(np.float32)

    def jax_loss(lo):
        eps = model.apply({"params": params, "lora": jax_lora.lora_collection(lo)},
                          jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        return jnp.mean((eps - target) ** 2)

    jax_grads = jax.jit(jax.grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, lora_np))
    tree = lora_tree_from_jax(lora_np)
    leaves = [ab[k].requires_grad_(True) for ab in tree.values() for k in ("down", "up")]
    port.requires_grad_(False)
    eps = functional_call(port, lora_collection(tree),
                          (_nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx)))
    loss = ((eps.permute(0, 2, 3, 1) - torch.from_numpy(target)) ** 2).mean()
    grads = torch.autograd.grad(loss, leaves)
    want_g = jax_grads
    got_g = lora_tree_to_jax({n: {"down": g_d, "up": g_u} for n, g_d, g_u in
                              zip(tree, grads[0::2], grads[1::2])})
    assert set(got_g) == set(want_g) and len(got_g) == 32  # 4 transformers
    for name, ab in got_g.items():
        for leaf, g in ab.items():
            w = np.asarray(want_g[name][leaf])
            assert np.abs(w).max() > 0, (name, leaf)
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                       err_msg=f"{name}::{leaf}")


def test_unet_bridge_round_trip_and_lora_names(unet_case):
    params, lora_np, _ = unet_case
    back = params_to_jax(params_from_jax(params))
    flat_a = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(str, flat_a)) == set(map(str, flat_b))
    for k, v in flat_a.items():
        np.testing.assert_array_equal(np.asarray(v), flat_b[k])
    tree = lora_tree_from_jax(lora_np)
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q" in tree
    assert "up_blocks.1.attentions.0.transformer_blocks.0.attn2.to_out.0" in tree
    back = lora_tree_to_jax(tree)
    assert list(back) == list(lora_np)
    for name, ab in lora_np.items():
        for leaf, v in ab.items():
            np.testing.assert_array_equal(back[name][leaf], v)
    model = _port_unet(params)
    init = lora_init(model, rank=3, generator=torch.Generator().manual_seed(0))
    assert set(init) == set(tree)
    assert all(torch.equal(ab["up"], torch.zeros_like(ab["up"])) for ab in init.values())
    assert lora_ranks(init) == lora_ranks(tree)


def test_lora_merge_matches_the_side_branch_and_the_jax_merge(unet_case):
    params, lora_np, (x, t, ctx) = unet_case
    model = _port_unet(params)
    tree = lora_tree_from_jax(lora_np)
    args = (_nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))
    with torch.no_grad():
        side = functional_call(model, lora_collection(tree), args)
        merged_sd = lora_merge(model.state_dict(), tree)
        model.load_state_dict(merged_sd)
        merged = model(*args)
    np.testing.assert_allclose(merged.numpy(), side.numpy(), atol=1e-5, rtol=0)
    want = params_from_jax(jax_lora.lora_merge(params, lora_np))
    for k, v in want.items():
        np.testing.assert_allclose(merged_sd[k].numpy(), v.numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)


def _clip_params(seed):
    text = jax_clip.CLIPTextEncoder(width=32, layers=2, heads=2)
    shapes = jax.eval_shape(text.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 77), jnp.int32))["params"]
    return text, _draw(shapes, seed)


def test_clip_text_tower_and_hash_tokenizer_match_jax(tmp_path):
    prompts = ["a Post-Impressionist painting by vincent-van-gogh",
               "A Baroque painting", "", "word " * 90]
    ids = HashTokenizer()(prompts)
    np.testing.assert_array_equal(ids, jax_clip.HashTokenizer()(prompts))
    text, params = _clip_params(6)
    want = np.asarray(jax.jit(text.apply)({"params": params}, jnp.asarray(ids)))
    sd = clip_text_params_from_jax(params)
    assert "text_model.encoder.layers.1.self_attn.q_proj.weight" in sd
    port = CLIPTextEncoder(width=32, layers=2, heads=2)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # The .npz of cli.convert_weights clip_text ('/'-joined paths), and an HF
    # state dict with its position_ids buffer, both load.
    flat = {"/".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "clip.npz", **flat)
    torch.save({**sd, "text_model.embeddings.position_ids": torch.arange(77)[None]},
               tmp_path / "clip.pt")
    for path in ("clip.npz", "clip.pt"):
        loaded = load_clip_text(str(tmp_path / path), device="cpu", width=32, layers=2,
                                heads=2)
        with torch.no_grad():
            np.testing.assert_array_equal(loaded(torch.from_numpy(ids).long()).numpy(),
                                          got.numpy())
    with pytest.raises(SystemExit):
        load_clip_text(str(tmp_path / "clip.npz"), device="cpu", width=64, layers=2, heads=2)


def test_clip_bpe_tokenizer_matches_the_jax_copy(tmp_path):
    d = _write_tiny_vocab(tmp_path / "vocab")
    ours = load_tokenizer(str(d), max_length=77)
    assert isinstance(ours, CLIPBPETokenizer)
    np.testing.assert_array_equal(ours(PROMPTS), JaxBPE.from_dir(str(d))(PROMPTS))
    np.testing.assert_array_equal(CLIPBPETokenizer.from_dir(str(d), max_length=16)(PROMPTS),
                                  JaxBPE.from_dir(str(d), max_length=16)(PROMPTS))
    with pytest.raises(OSError):
        load_tokenizer(str(d / "nope"))
    assert isinstance(load_tokenizer(), HashTokenizer)


def test_kl_vae_encode_and_decode_match_jax():
    jspec = jax_registry.KLVAESpec(**KL_SPEC)
    model = jax_vqvae.AutoencoderKL(jspec)
    x = np.random.default_rng(7).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = _draw(shapes["params"], 8)
    v = {"params": params}

    @jax.jit
    def run(x):
        mean, logvar = model.apply(v, x, method=model.encode_moments)
        z = model.apply(v, x, method=model.encode)
        return mean, logvar, z, model.apply(v, z, method=model.decode)

    mean, logvar, z, dec = (np.asarray(a) for a in run(jnp.asarray(x)))
    port = AutoencoderKL(registry.KLVAESpec(**KL_SPEC)).eval()
    sd = kl_vae_params_from_jax(params)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        m_p, lv_p = port.encode_moments(_nchw(x))
        z_p = port.encode(_nchw(x))
        d_p = port.decode(_nchw(z))
        gen = torch.Generator().manual_seed(0)
        sampled = port.encode(_nchw(x), generator=gen)
        eps = torch.randn(m_p.shape, generator=torch.Generator().manual_seed(0))
    nhwc = lambda a: a.permute(0, 2, 3, 1).numpy()  # noqa: E731
    for got, want in ((m_p, mean), (lv_p, logvar), (z_p, z), (d_p, dec)):
        np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        sampled.numpy(), ((m_p + torch.exp(0.5 * lv_p) * eps) * 0.18215).numpy(), atol=1e-6)
    back = kl_vae_params_to_jax(sd)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(str, flat_a)) == set(map(str, flat_b))
    # The seeded random tower: one tower for every consumer, on a given device.
    a, b = (load_sd_vae(registry.KLVAESpec(**KL_SPEC), device="cpu", quiet=True)
            for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def _random_lora_np(seed, shapes=((16, 16), (32, 16), (16, 48), (40, 40)), rank=6):
    rng = np.random.default_rng(seed)
    names = ["down_0_xattn_0/block_0/attn1/to_q", "down_0_xattn_0/block_0/attn2/to_k",
             "up_1_xattn_0/block_0/attn1/to_out", "mid_xattn/block_0/attn2/to_v"]
    return {n: {"down": rng.standard_normal((i, rank)).astype(np.float32),
                "up": rng.standard_normal((rank, o)).astype(np.float32)}
            for n, (i, o) in zip(names, shapes)}


@pytest.mark.parametrize("ratio,min_rank", [(0.0, 1), (0.3, 1), (0.5, 1), (0.9, 2)])
def test_prune_lora_is_bit_for_bit_the_jax_function(ratio, min_rank):
    tree_np = _random_lora_np(9)
    want = jax_lora.prune_lora(tree_np, ratio, min_rank)
    got = lora_tree_to_jax(prune_lora(lora_tree_from_jax(tree_np), ratio, min_rank))
    assert list(got) == list(want)
    for name in want:
        for leaf in ("down", "up"):
            np.testing.assert_array_equal(got[name][leaf], np.asarray(want[name][leaf]))
    assert lora_num_params(lora_tree_from_jax(got)) == jax_lora.lora_num_params(want)


def test_lora_npz_reads_across_the_packages(tmp_path):
    tree_np = _random_lora_np(10)
    jax_tti._save_lora_npz(str(tmp_path / "jax" / "lora_weights.npz"), tree_np)
    got = load_lora_npz(str(tmp_path / "jax" / "lora_weights.npz"))
    save_lora_npz(str(tmp_path / "port" / "lora_weights.npz"), got)
    back = jax_tti._load_lora_npz(str(tmp_path / "port" / "lora_weights.npz"))
    with np.load(tmp_path / "jax" / "lora_weights.npz") as a, \
            np.load(tmp_path / "port" / "lora_weights.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for name, ab in tree_np.items():
        for leaf, v in ab.items():
            np.testing.assert_array_equal(np.asarray(back[name][leaf]), v)


FILES = [f"{a}_work-{j}_{1880 + j}.jpg" for a in ("van-gogh", "gauguin", "cezanne",
                                                   "seurat", "signac", "bernard")
         for j in range(3)] + ["toulouse-lautrec_moulin.jpg", "redon.png"]


@pytest.mark.parametrize("dist,idx", [("uniform", None), ("uniform_paired", None),
                                      ("datamodel", None), ("shapley", None),
                                      ("shapley_paired", None), ("loo", 2), ("aoi", 3),
                                      ("full", None)])
@pytest.mark.parametrize("unit", ["artist", "filename"])
def test_group_removal_split_is_bit_for_bit_the_jax_function(dist, idx, unit):
    fn = groups.artist_from_filename if unit == "artist" else os.path.basename
    units = sorted({fn(f) for f in FILES})
    for seed in (0, 1, 7):
        got = groups.group_removal_split(FILES, units, dist, seed, alpha=0.4, unit=unit,
                                         idx=idx)
        want = jax_groups.group_removal_split(FILES, units, dist, seed, alpha=0.4,
                                              unit=unit, idx=idx)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_group_tables_and_counterfactual_split_match_jax(tmp_path):
    assert [groups.artist_from_filename(f) for f in FILES] == [
        jax_groups.artist_from_filename(f) for f in FILES]
    got = groups.build_group_tables(FILES, "post_impressionism", str(tmp_path / "port"))
    want = jax_groups.build_group_tables(FILES, "post_impressionism", str(tmp_path / "jax"))
    assert got == want
    for name in ("post_impressionism_artists.csv", "post_impressionism_filenames.csv",
                 "metadata.csv"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
        assert groups.load_group_table(str(tmp_path / "port" / name)) == \
            jax_groups.load_group_table(str(tmp_path / "jax" / name))
    units = got[0]
    ranking = np.random.default_rng(11).permutation(len(units))
    for direction in ("top", "bottom"):
        a = groups.counterfactual_split(FILES, units, ranking, 0.3, direction)
        b = jax_groups.counterfactual_split(FILES, units, ranking, 0.3, direction)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_a_frozen_base_sums_no_group_norm_partials(unet_case):
    """LoRA training's base is frozen: the GroupNorms return no gamma/beta
    gradient (their partials are not summed), no base weight gets a gradient,
    and dx is what it is with gamma/beta trainable."""
    from group_attribution_for_diffusion_models_tpu_torch.ops import group_norm_silu

    params, lora_np, (x, t, ctx) = unet_case
    model = _port_unet(params).requires_grad_(False)
    tree = lora_tree_from_jax(lora_np)
    leaves = [ab[k].requires_grad_(True) for ab in tree.values() for k in ("down", "up")]
    args = (_nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))
    before = group_norm_silu.affine_sums
    loss = functional_call(model, lora_collection(tree), args).square().mean()
    frozen = torch.autograd.grad(loss, leaves)
    assert group_norm_silu.affine_sums == before
    assert all(p.grad is None for p in model.parameters())
    model.requires_grad_(True)
    loss = functional_call(model, lora_collection(tree), args).square().mean()
    trainable = torch.autograd.grad(loss, leaves)
    # tiny_sd_spec(8) has 21 GroupNorms; autograd.grad runs the backward of
    # those on a path to a LoRA factor: all but down block 0's first resnet's
    # two and its transformer's.
    assert group_norm_silu.affine_sums == before + 18
    for a, b in zip(frozen, trainable):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
