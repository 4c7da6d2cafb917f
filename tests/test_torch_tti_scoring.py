"""The port's text-to-image scoring against the JAX package's, on the CPU.

Image metrics, the CLIP vision tower and the aesthetic head, the raw-latent
and conditional-trajectory samplers, `compute_model_behaviors`, the
similarity baselines and the tagged latents caches. The same numpy-drawn
parameters (`clip_vision.params_from_jax`, `params_from_jax`) and the same
numpy inputs go through both packages at tiny sizes: `tiny_sd_spec(8)`, the
tiny CLIP tower (32 px, patch 8, width 32, 2 layers, projection 16).

Tolerances, f32 on both sides: MSE, NRMSE and SSIM within rtol 1e-5 (sums
over 8x8 to 32x32 windows in other orders); the CLIP tower within atol 1e-5
at 48, 16 and 32 px input (a resize that shrinks, grows or keeps the size,
then 2 layers of width 32), the aesthetic head within 1e-5; the behaviors'
CLIP and aesthetic values within 1e-5 and the diffusion loss within rtol
1e-5; DDIM latents within 2e-4 (raw latents, twice the scale of the [0, 1]
images the sampler tests hold to 1e-4) and the trajectory within 2e-4; the
`clip` baseline's attributions within 1e-5. Row keys, the duplicate guard
and the caches are compared exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from group_attribution_for_diffusion_models_tpu.cli import (
    compute_model_behaviors as jax_behaviors_cli,
)
from group_attribution_for_diffusion_models_tpu.cli import (
    similarity_baselines as jax_similarity_cli,
)
from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.diffusion.sampling import (
    sample_loop as jax_sample_loop,
)
from group_attribution_for_diffusion_models_tpu.diffusion.sampling import (
    sample_with_trajectory as jax_sample_with_trajectory,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    add_noise as jax_add_noise,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.models import clip_text as jax_clip
from group_attribution_for_diffusion_models_tpu.models import clip_vision as jax_vision
from group_attribution_for_diffusion_models_tpu.utils import image_metrics as jax_metrics
from group_attribution_for_diffusion_models_tpu.utils import jsonl as jax_jsonl
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    compute_model_behaviors,
    similarity_baselines,
    train_ensemble,
    train_text_to_image_lora,
)
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.diffusion.sampling import (
    sample_loop,
    sample_with_trajectory,
)
from group_attribution_for_diffusion_models_tpu_torch.diffusion.schedulers import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import clip_vision
from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import (
    cached_latents,
    precompute_latents,
)
from group_attribution_for_diffusion_models_tpu_torch.utils import image_metrics, jsonl
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import weights_tag
from test_torch_tti import SPEC, _draw, _nchw, _port_unet, _unet_params
from test_torch_tti_cli import _fast

DATASET = "synthetic_64x8"
TINY = dict(image_size=32, patch_size=8, width=32, layers=2, heads=2, proj_dim=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, n=3, size=32, c=3):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, size, size, c)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("size,c", [(32, 3), (8, 3), (16, 1)])
def test_image_metrics_match_jax(size, c):
    a, b = _images(size, size=size, c=c)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("mse", "nrmse", "ssim"):
        want = np.asarray(getattr(jax_metrics, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(image_metrics, name)(ta, tb).numpy()
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=name)
    # Identical images: SSIM 1, NRMSE 0.
    np.testing.assert_allclose(image_metrics.ssim(ta, ta).numpy(), 1.0, rtol=1e-6)
    assert (image_metrics.nrmse(ta, ta) == 0).all()


@pytest.fixture(scope="module")
def tower():
    """The tiny JAX tower with drawn parameters, its head, and both ported."""
    model = jax_vision.CLIPVisionEncoder(**TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = _draw(shapes["params"], 40)
    head = jax_vision.AestheticHead()
    head_params = _draw(jax.eval_shape(head.init, jax.random.PRNGKey(0),
                                       jnp.zeros((1, 16)))["params"], 41)
    port = clip_vision.CLIPVisionEncoder(**TINY)
    port.load_state_dict(clip_vision.params_from_jax(params), strict=True)
    port_head = clip_vision.AestheticHead(16)
    port_head.load_state_dict(clip_vision.params_from_jax({}, head=head_params), strict=True)
    return model, params, head, head_params, port.eval(), port_head.eval()


@pytest.mark.parametrize("size", [48, 16, 32], ids=["shrink", "grow", "equal"])
def test_clip_vision_tower_and_aesthetic_head_match_jax(tower, size):
    model, params, head, head_params, port, port_head = tower
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    want_s = np.asarray(head.apply({"params": head_params}, jnp.asarray(want)))
    with torch.no_grad():
        got_s = port_head(torch.from_numpy(want.copy()))
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-5, rtol=0)


def test_clip_weights_files_load_in_both_packages(tower, tmp_path):
    """A tower saved by the port in HF names, with HF's position_ids buffer,
    loads in the JAX package and back in the port; the head from an .npz
    and from a torch nn.Linear state dict; the random towers are seeded."""
    model, params, head, head_params, port, port_head = tower
    sd = {**port.state_dict(), "vision_model.embeddings.position_ids": torch.arange(17)[None]}
    torch.save(sd, tmp_path / "clip.pt")
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jm, jv = jax_vision.load_clip_vision(str(tmp_path / "clip.pt"), tiny=True)
    want = np.asarray(jm.apply(jv, jnp.asarray(x)))
    loaded = clip_vision.load_clip_vision(str(tmp_path / "clip.pt"), tiny=True, device="cpu")
    got = clip_vision.make_embed_fn(loaded, batch_size=1)(x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    kernel = np.asarray(head_params["linear"]["kernel"])
    np.savez(tmp_path / "head.npz", kernel=kernel, bias=np.asarray(head_params["linear"]["bias"]))
    torch.save(port_head.linear.state_dict(), tmp_path / "head.pth")
    for path in ("head.npz", "head.pth"):
        h = clip_vision.load_aesthetic_head(str(tmp_path / path), dim=16, device="cpu")
        jh, jhv = jax_vision.load_aesthetic_head(str(tmp_path / path), dim=16)
        np.testing.assert_allclose(h(torch.from_numpy(want.copy())).detach().numpy(),
                                   np.asarray(jh.apply(jhv, jnp.asarray(want))), atol=1e-6)
    with pytest.raises(ValueError):
        clip_vision.load_aesthetic_head(str(tmp_path / "head.npz"), dim=8, device="cpu")
    a = clip_vision.load_clip_vision(None, tiny=True, device="cpu")
    b = clip_vision.load_clip_vision(None, tiny=True, device="cpu")
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], atol=0, rtol=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clip_vision.load_clip_vision(None, tiny=True)


@pytest.fixture(scope="module")
def unet_params():
    return _unet_params(0)


def test_raw_latents_and_the_conditional_trajectory_match_jax(unet_params):
    params = unet_params
    model = JaxUNet2D(SPEC)
    spec = JaxSchedulerSpec(kind="ddim")
    ehs = np.random.default_rng(42).standard_normal((2, 6, 32)).astype(np.float32)
    shape, key = (2, 8, 8, 4), jax.random.PRNGKey(43)
    schedule = jax_make_schedule(spec)
    want = np.asarray(jax.jit(lambda k: jax_sample_loop(
        model.apply, params, schedule, spec, shape, k, num_inference_steps=3, kind="ddim",
        encoder_hidden_states=jnp.asarray(ehs), postprocess=False))(key))
    want_img, want_traj, want_ts = jax.jit(lambda k: jax_sample_with_trajectory(
        model.apply, params, schedule, spec, shape, k, num_inference_steps=3,
        encoder_hidden_states=jnp.asarray(ehs)))(key)
    noise = _nchw(jax.random.normal(jax.random.split(key)[0], shape, dtype=jnp.float32))
    port_spec = SchedulerSpec(kind="ddim")
    port, sched = _port_unet(params), make_schedule(port_spec)
    ctx = torch.from_numpy(ehs)
    got = sample_loop(port, sched, port_spec, (2, 4, 8, 8), device="cpu", init_noise=noise,
                      num_inference_steps=3, encoder_hidden_states=ctx, postprocess=False)
    assert want.min() < 0  # raw latents, not images in [0, 1]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-4, rtol=0)
    img, traj, ts = sample_with_trajectory(port, sched, port_spec, (2, 4, 8, 8), device="cpu",
                                           init_noise=noise, num_inference_steps=3,
                                           encoder_hidden_states=ctx)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(want_ts))
    np.testing.assert_allclose(traj.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want_traj),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(img.permute(0, 2, 3, 1).numpy(), np.asarray(want_img),
                               atol=1e-4, rtol=0)


def test_behaviors_on_fixed_images_and_injected_loss_noise_match_jax(tower, unet_params):
    """The CLI's per-image behaviors, as the JAX CLI computes them, on the
    same images, towers, latents, context and loss draws."""
    model, params, head, head_params, port, port_head = tower
    a, b = _images(7, n=4, size=8)
    ehs = np.random.default_rng(8).standard_normal((1, 6, 32)).astype(np.float32)
    got = compute_model_behaviors.pair_metrics(torch.from_numpy(a), torch.from_numpy(b))
    got.update(compute_model_behaviors.clip_metrics(
        torch.from_numpy(a), torch.from_numpy(b), clip_vision.make_embed_fn(port), port_head,
        ehs[:, 0]))
    embed = jax.jit(lambda x: model.apply({"params": params}, x))
    emb_ref, emb_sub = np.asarray(embed(jnp.asarray(a))), np.asarray(embed(jnp.asarray(b)))

    def unit(e):
        return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)

    want = {"ssim": np.asarray(jax_metrics.ssim(jnp.asarray(a), jnp.asarray(b))),
            "nrmse": np.asarray(jax_metrics.nrmse(jnp.asarray(a), jnp.asarray(b))),
            "clip_similarity": (unit(emb_ref) * unit(emb_sub)).sum(axis=1),
            "clip_prompt_score": (unit(emb_sub) * unit(ehs[:, 0, :16])).sum(axis=1),
            "aesthetic_score": np.asarray(head.apply({"params": head_params},
                                                     jnp.asarray(emb_sub)))}
    for k in ("ssim", "nrmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    for k in ("clip_similarity", "clip_prompt_score", "aesthetic_score"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    # A context narrower than the embedding scores zeros, as in the JAX CLI.
    narrow = compute_model_behaviors.clip_metrics(
        torch.from_numpy(a), torch.from_numpy(b), clip_vision.make_embed_fn(port), port_head,
        ehs[:, 0, :8])
    assert (narrow["clip_prompt_score"] == 0).all()

    # The diffusion loss on latents with injected (t, noise) draws.
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    draws = [(rng.integers(0, 1000, 4), rng.standard_normal((4, 8, 8, 4)).astype(np.float32))
             for _ in range(3)]
    jmodel, jsched = JaxUNet2D(SPEC), jax_make_schedule(JaxSchedulerSpec())
    ehs_b = np.broadcast_to(ehs, (4, 6, 32))

    @jax.jit
    def jax_loss(t, noise):  # the JAX CLI's diff_loss on injected draws
        x_t = jax_add_noise(jsched, jnp.asarray(lat), noise, t)
        eps = jmodel.apply({"params": unet_params}, x_t, t, jnp.asarray(ehs_b))
        return jnp.mean((eps - noise) ** 2, axis=(1, 2, 3))

    want_loss = np.mean([np.asarray(jax_loss(jnp.asarray(t), jnp.asarray(n)))
                         for t, n in draws], axis=0)
    got_loss = compute_model_behaviors.diffusion_loss(
        _port_unet(unet_params), make_schedule(SchedulerSpec()), _nchw(lat),
        torch.from_numpy(np.ascontiguousarray(ehs_b)),
        [(torch.from_numpy(t).long(), _nchw(n)) for t, n in draws])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=0)
    q = compute_model_behaviors.quantiles(got_loss)
    assert q == {"0.5": float(np.quantile(got_loss, 0.5)),
                 "0.75": float(np.quantile(got_loss, 0.75)),
                 "0.9": float(np.quantile(got_loss, 0.9)), "avg": float(np.mean(got_loss))}


@pytest.fixture(scope="module")
def members(tmp_path_factory, tower):
    """Two datamodel LoRAs and a full one from the port's trainer, and the
    tiny tower saved by the port in HF names."""
    out = str(tmp_path_factory.mktemp("tti_members"))
    common = ["--dataset", DATASET, "--outdir", out, "--max_train_steps", "1",
              "--train_batch_size", "8", "--rank", "2", "--device", "cpu"]
    sub = train_text_to_image_lora.main(common + ["--removal_dist", "datamodel",
                                                  "--num_seeds", "2"])
    full = train_text_to_image_lora.main(common + ["--removal_dist", "full"])
    clip_path = os.path.join(out, "clip.pt")
    torch.save(tower[4].state_dict(), clip_path)
    linear = tower[3]["linear"]
    np.savez(os.path.join(out, "head.npz"), kernel=np.asarray(linear["kernel"]),
             bias=np.asarray(linear["bias"]))
    return out, sub["lora_paths"], full["lora_paths"][0], clip_path


def test_compute_model_behaviors_row_and_guard_beside_the_jax_cli(members, tmp_path):
    out, subs, full, clip_path = members
    argv = ["--dataset", DATASET, "--outdir", out, "--lora_dir", subs[0],
            "--reference_lora_dir", full, "--removal_dist", "datamodel", "--removal_seed", "0",
            "--n_samples", "3", "--num_inference_steps", "2", "--n_noises", "2",
            "--clip_weights", clip_path]
    jax_db = str(tmp_path / "jax.jsonl")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_behaviors_cli, "UNet2D", _fast(JaxUNet2D, 50))
    mp.setattr(jax_behaviors_cli, "CLIPTextEncoder", _fast(jax_clip.CLIPTextEncoder, 51))
    try:
        jax_behaviors_cli.main(argv + ["--db", jax_db])
    finally:
        mp.undo()
    (jax_row,) = list(jax_jsonl.read_records(jax_db))
    db = str(tmp_path / "port.jsonl")
    s = compute_model_behaviors.main(argv + ["--db", db, "--device", "cpu"])
    (row,) = list(jsonl.read_records(db))
    assert not s["skipped"] and s["images"].shape == (3, 8, 8, 3)
    assert set(row) - {"device"} == set(jax_row)
    assert set(row["metric_times"]) == set(jax_row["metric_times"])
    want_removed = np.loadtxt(os.path.join(os.path.dirname(subs[0]), "removal_idx.csv"),
                              skiprows=1, dtype=np.int64, ndmin=1).tolist()
    assert row["removed_idx"] == jax_row["removed_idx"] == want_removed
    for m in compute_model_behaviors.METRICS:
        assert np.isfinite([row[f"{m}_{q}"] for q in ("0.5", "0.75", "0.9", "avg")]).all()
    assert row["generated_image_2_simple_loss"] > 0
    # The duplicate guard: the same (lora_dir, removal_dist, removal_seed,
    # n_samples) is skipped, in either package's DB; another n_samples is not.
    assert compute_model_behaviors.main(argv + ["--db", db, "--device", "cpu"])["skipped"]
    assert compute_model_behaviors.main(argv + ["--db", jax_db, "--device", "cpu"])["skipped"]
    assert len(list(jsonl.read_records(db))) == 1
    assert jsonl.has_record(db, {"lora_dir": subs[0], "n_samples": 3})
    assert not jsonl.has_record(db, {"lora_dir": subs[0], "n_samples": 4})
    # Paired generation: scoring the reference against itself gives SSIM 1.
    same = compute_model_behaviors.main(
        ["--dataset", DATASET, "--outdir", out, "--lora_dir", full, "--reference_lora_dir",
         full, "--n_samples", "2", "--num_inference_steps", "2", "--n_noises", "1",
         "--db", db, "--device", "cpu"])["row"]
    assert same["ssim_avg"] == pytest.approx(1.0, abs=1e-6) and same["nrmse_avg"] == 0.0


def test_entry_points_default_to_cuda():
    argv = ["--outdir", "o", "--db", "d.jsonl", "--lora_dir", "l.npz"]
    args = compute_model_behaviors.parse_args(argv)
    assert args.device == "cuda"
    want = vars(jax_behaviors_cli.parse_args(argv))
    got = vars(args)
    got.pop("device")
    assert got == want
    argv = ["--dataset", DATASET, "--save_path", "s.npy"]
    got = vars(similarity_baselines.parse_args(argv))
    assert got.pop("device") == "cuda" and got == vars(jax_similarity_cli.parse_args(argv))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        similarity_baselines.main(argv)


@pytest.mark.parametrize("baseline", ["pixel", "clip", "aesthetic"])
def test_similarity_baselines_match_the_jax_cli(members, tmp_path, baseline):
    out, _, _, clip_path = members
    gen = tmp_path / "gen"
    gen.mkdir()
    rng = np.random.default_rng(11)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(gen / f"{i}.png")
    argv = ["--dataset", DATASET, "--baseline", baseline, "--generated_dir", str(gen),
            "--clip_weights", clip_path, "--aesthetic_weights", os.path.join(out, "head.npz"),
            "--max_examples", "40"]
    jax_similarity_cli.main(argv + ["--save_path", str(tmp_path / "jax.npy")])
    got = similarity_baselines.main(argv + ["--save_path", str(tmp_path / "port.npy"),
                                            "--device", "cpu"])
    want = np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape and len(got) > 1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got)
    np.testing.assert_array_equal(np.load(tmp_path / "port_ranking.npy"),
                                  np.load(tmp_path / "jax_ranking.npy"))


class _MeanEncoder(torch.nn.Module):
    """A stand-in encoder: 2x2 mean pooling of NCHW images, times `scale`."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(scale))

    def encode(self, x):
        return torch.nn.functional.avg_pool2d(x, 2) * self.scale


@pytest.mark.parametrize("stale", ["encoder", "dataset", "count", "untagged"])
def test_a_stale_latents_cache_is_encoded_again(tmp_path, capsys, stale):
    """A cache is read only when its tag (encoder, dataset, image count)
    matches; an untagged cache (the JAX package writes none) is read when its
    row count matches and encoded again when it does not."""
    images = np.random.default_rng(12).uniform(-1, 1, (6, 4, 4, 3)).astype(np.float32)
    cache = str(tmp_path / "precomputed_emb" / "vae_latents.npy")
    tag = {"encoder": weights_tag(None, 2), "dataset": "imagenette"}
    first = precompute_latents(_MeanEncoder(), images, cache_path=cache, tag=tag)
    assert first.shape == (6, 2, 2, 3)
    with open(str(tmp_path / "precomputed_emb" / "vae_latents.tag.json")) as f:
        assert json.load(f) == dict(tag, images=6)
    again = precompute_latents(_MeanEncoder(2.0), images, cache_path=cache, tag=tag)
    np.testing.assert_array_equal(again, first)  # the tag matches: the cache is read
    capsys.readouterr()
    new_tag, new_images, encoder = dict(tag), images, _MeanEncoder(2.0)
    if stale == "encoder":
        weights = tmp_path / "vae.npy"
        np.save(weights, np.zeros(3))
        new_tag["encoder"] = weights_tag(str(weights), 2)
        assert new_tag["encoder"] == f"{weights}:{os.path.getsize(weights)}"
    elif stale == "dataset":
        new_tag["dataset"] = "synthetic_64x8"
    elif stale == "count":
        new_images = images[:5]
    else:
        os.remove(str(tmp_path / "precomputed_emb" / "vae_latents.tag.json"))
        read = precompute_latents(encoder, images, cache_path=cache, tag=tag)
        np.testing.assert_array_equal(read, first)
        assert "has no tag" in capsys.readouterr().out
        new_images = images[:4]
    assert cached_latents(cache, len(new_images), new_tag) is None
    got = precompute_latents(encoder, new_images, cache_path=cache, tag=new_tag)
    said = capsys.readouterr().out
    assert ("holds 6 rows" if stale == "untagged" else "is stale") in said
    np.testing.assert_allclose(got, 2.0 * first[:len(new_images)], rtol=1e-6)
    np.testing.assert_array_equal(np.load(cache), got)
    assert cached_latents(cache, len(new_images), new_tag) is not None


def test_train_ensemble_encodes_again_for_another_vqvae(tmp_path, capsys):
    """The LDM trainer's cache is tagged: a second call with another
    --vqvae_weights encodes the dataset again instead of reading the first
    encoder's latents; a third call with the same weights reads them."""
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import VQVAESpec
    from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
        vqvae_params_to_jax)
    from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import init_vqvae

    dataset = "synthetic_64x16_ldm"
    spec = VQVAESpec(sample_size=16, block_out_channels=(8, 16, 16), layers_per_block=1,
                     num_vq_embeddings=32, norm_num_groups=4)
    weights = str(tmp_path / "vq.npy")
    np.save(weights, vqvae_params_to_jax(init_vqvae(spec, 11).state_dict()),
            allow_pickle=True)
    argv = ["--dataset", dataset, "--outdir", str(tmp_path), "--removal_dist", "shapley",
            "--training_steps", "1", "--device", "cpu"]
    a = train_ensemble.main(argv)
    assert a["latents_cached"] is False
    cache = tmp_path / dataset / "precomputed_emb" / "vqvae_latents.npy"
    first = np.load(cache)
    capsys.readouterr()
    b = train_ensemble.main(argv + ["--seed_start", "1", "--vqvae_weights", weights])
    assert b["latents_cached"] is False and "stale" in capsys.readouterr().out
    assert not np.array_equal(np.load(cache), first)
    c = train_ensemble.main(argv + ["--seed_start", "2", "--vqvae_weights", weights])
    assert c["latents_cached"] is True


def test_similarity_baselines_group_an_artbench_folder_by_artist(tmp_path, monkeypatch):
    """On an ArtBench-style folder the groups are the artists (sorted), where
    the JAX CLI takes the dataset's labels, all 0 there (ROADMAP C4): the
    pixel baseline's attributions hold one value per artist, each the mean
    over that artist's images of its best cosine with a generated image."""
    from group_attribution_for_diffusion_models_tpu_torch.config import constants
    from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset

    base = tmp_path / "imagenette2" / "train"
    base.mkdir(parents=True)
    rng = np.random.default_rng(13)
    for a in ("b-painter", "a-painter", "c-painter"):
        for j in range(2):
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).resize(
                (256, 256)).save(base / f"{a}_work-{j}_1900.png")
    gen = tmp_path / "gen"
    gen.mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)).save(
            gen / f"{i}.png")
    monkeypatch.setattr(constants, "DATASET_DIR", str(tmp_path))
    got = similarity_baselines.main(["--dataset", "imagenette", "--baseline", "pixel",
                                     "--generated_dir", str(gen), "--save_path",
                                     str(tmp_path / "px.npy"), "--device", "cpu"])
    train = create_dataset("imagenette")
    assert (train.labels == 0).all() and len(got) == 3
    imgs = (train.images / 2.0 + 0.5).reshape(6, -1)
    g = np.stack([np.asarray(Image.open(gen / f"{i}.png"), np.float32) / 255.0
                  for i in range(2)]).reshape(2, -1)
    cos = (g / np.linalg.norm(g, axis=1, keepdims=True)) @ (
        imgs / np.linalg.norm(imgs, axis=1, keepdims=True)).T
    artists = [os.path.basename(n).split("_")[0] for n in train.names]
    want = [np.mean([cos[:, i].max() for i in range(6) if artists[i] == a])
            for a in sorted(set(artists))]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
