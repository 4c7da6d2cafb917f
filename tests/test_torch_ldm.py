"""The port's latent-diffusion path against the JAX package's, on the CPU.

The same numpy-drawn VQ-VAE and U-Net parameters (carried across by
`vqvae_params_from_jax` and `params_from_jax`) and the same numpy inputs go
through both packages at the tiny ``synthetic_64x16_ldm`` sizes (VQ-VAE
widths (8, 16, 16), 32 codes, 4 groups; 16x16 images, 4x4 latents).

Tolerances, all f32 on both sides: VQ encode and decode within 1e-4 (about
12 convolutions and 10 GroupNorms summed in other orders, outputs of order
1); `quantize` picks the same codes, exactly; one `train_vqvae` step: loss
within 1e-5 relative, and every parameter tensor within 1e-5 of its norm
(Adam's first step moves each element by lr * g / (|g| + 1e-8), so an element
whose gradient is float noise could flip; none does at these inputs; the
codebook rows no latent picked have gradient 0 exactly on both sides); the
latent train step as test_torch_training.py's; DDIM with the VQ decoder
within 1e-4 on images in [0, 1]. The U-Net's selective remat gives the
gradients of no remat bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli.common import config_for as jax_config_for
from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.data import datasets as jax_datasets
from group_attribution_for_diffusion_models_tpu.diffusion.sampling import (
    sample_loop as jax_sample_loop,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.models import vqvae as jax_vqvae
from group_attribution_for_diffusion_models_tpu.training import state as jax_state
from group_attribution_for_diffusion_models_tpu.training.train import (
    diffusion_loss as jax_diffusion_loss,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    generate_samples,
    train_ensemble,
    train_vqvae,
)
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.data import datasets
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.diffusion.sampling import sample_loop
from group_attribution_for_diffusion_models_tpu_torch.models import (
    UNet2D,
    build_unet,
    params_from_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
    vqvae_params_from_jax,
    vqvae_params_to_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import (
    VQVAE,
    init_vqvae,
    load_vqvae,
    make_vq_decode_fn,
    precompute_latents,
)
from group_attribution_for_diffusion_models_tpu_torch.ops import (
    attention_bwd_plain_route,
    attention_plain_route,
    dot_product_attention,
)
from group_attribution_for_diffusion_models_tpu_torch.parallel.ensemble import EnsembleTrainer
from group_attribution_for_diffusion_models_tpu_torch.training import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from group_attribution_for_diffusion_models_tpu_torch.utils import jsonl
from test_torch_unet import _jax_params, _port_spec

DATASET = "synthetic_64x16_ldm"
JAX_CFG = jax_config_for(DATASET)
CFG = config_for(DATASET)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny convolutions run faster on one thread than on every core with the
    tier's other workers beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_vq_params(seed):
    """Random params in the JAX VQVAE's tree (shapes from eval_shape, so
    nothing is compiled): kernels ~ N(0, 1/fan_in), biases ~ 0.1 N(0, 1), norm
    scales ~ 1 + 0.1 N(0, 1), the codebook U[0, 1) as the JAX init draws it."""
    spec = JAX_CFG.vqvae
    shapes = jax.eval_shape(
        jax_vqvae.VQVAE(spec).init, jax.random.PRNGKey(0),
        jnp.zeros((1, spec.sample_size, spec.sample_size, spec.in_channels)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "codebook":
            return rng.uniform(0, 1, leaf.shape).astype(np.float32)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return (z / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((1.0 if name == "scale" else 0.0) + np.float32(0.1) * z).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_vqvae(params) -> VQVAE:
    model = VQVAE(CFG.vqvae)
    model.load_state_dict(vqvae_params_from_jax(params), strict=True)
    return model.eval()


def _nchw(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).permute(0, 3, 1, 2)


def _images(seed, n=2):
    s = CFG.vqvae.sample_size
    return np.random.default_rng(seed).uniform(-1, 1, (n, s, s, 3)).astype(np.float32)


def test_vqvae_encode_quantize_decode_match_jax():
    params = _jax_vq_params(0)
    jm, variables = jax_vqvae.VQVAE(JAX_CFG.vqvae), {"params": params}
    model = _port_vqvae(params)
    x = _images(1)
    want_z = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode))(variables, x))
    with torch.no_grad():
        z = model.encode(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert z.shape == (2, 4, 4, 3)
    np.testing.assert_allclose(z, want_z, atol=1e-4, rtol=0)
    want_q, want_idx = jm.apply(variables, jnp.asarray(want_z), method=jm.quantize)
    with torch.no_grad():
        q, idx = model.quantize(_nchw(want_z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), np.asarray(want_q))
    for force in (False, True):
        want = np.asarray(jax.jit(lambda v, z: jm.apply(v, z, force, method=jm.decode))(
            variables, want_z))
        with torch.no_grad():
            got = model.decode(_nchw(want_z), force_not_quantize=force).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_vqvae_bridge_round_trip_and_random_init():
    params = _jax_vq_params(2)
    back = vqvae_params_to_jax(vqvae_params_from_jax(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    with pytest.raises(ValueError, match="unexpected state-dict key"):
        vqvae_params_to_jax({"encoder.bogus.weight": torch.zeros(1)})
    a, b = init_vqvae(CFG.vqvae, 7), init_vqvae(CFG.vqvae, 7)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    book = a.quantize.embedding.weight
    assert book.shape == (32, 3) and 0 <= book.min() and book.max() < 1
    assert not torch.equal(book, init_vqvae(CFG.vqvae, 8).quantize.embedding.weight)
    # The JAX init's distributions: unit GroupNorm scales, zero biases.
    assert torch.equal(a.encoder.conv_norm_out.weight, torch.ones(16))
    assert torch.equal(a.decoder.conv_in.bias, torch.zeros(16))


def test_train_vqvae_step_matches_jax():
    """One step of the JAX CLI's loss (reconstruction + codebook + beta *
    commitment, straight-through) and optax.adam, against the port's."""
    params = _jax_vq_params(3)
    jm = jax_vqvae.VQVAE(JAX_CFG.vqvae)
    x = _images(4, 4)
    beta, lr = 0.25, 2e-4

    def loss_fn(p, x):
        z = jm.apply({"params": p}, x, method=jm.encode)
        zq, _ = jm.apply({"params": p}, z, method=jm.quantize)
        z_st = z + jax.lax.stop_gradient(zq - z)
        recon = jm.apply({"params": p}, z_st, True, method=jm.decode)
        return (jnp.mean((recon - x) ** 2) + jnp.mean((jax.lax.stop_gradient(z) - zq) ** 2)
                + beta * jnp.mean((z - jax.lax.stop_gradient(zq)) ** 2))

    tx = optax.adam(lr)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, x)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = vqvae_params_from_jax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))

    model = _port_vqvae(params).train()
    step = train_vqvae.make_vqvae_step(model, make_optimizer("adam", lr=lr, grad_clip_norm=None),
                                       beta)
    metrics = step(_nchw(x))
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=1e-5)
    assert metrics["perplexity"].item() >= 1.0
    for name, got in model.state_dict().items():
        if name.endswith("to_k.bias"):
            continue  # zero gradient in exact arithmetic: Adam normalises float noise
        err = torch.linalg.vector_norm(got - want[name]).item()
        assert err <= 1e-5 * torch.linalg.vector_norm(want[name]).item(), name


def test_train_vqvae_cli_writes_weights_both_packages_read(tmp_path):
    out = train_vqvae.main(["--dataset", DATASET, "--outdir", str(tmp_path),
                            "--training_steps", "2", "--batch_size", "4", "--log_freq", "1",
                            "--device", "cpu"])
    assert np.isfinite(out["loss"]) and out["perplexity"] >= 1.0
    tree = np.load(out["weights_out"], allow_pickle=True).item()
    assert set(tree) == {"encoder", "decoder", "quant_conv", "post_quant_conv", "codebook"}
    port = load_vqvae(CFG.vqvae, out["weights_out"], device="cpu")
    jm, variables = jax_vqvae.load_vqvae(JAX_CFG.vqvae, out["weights_out"])
    x = _images(5)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode))(variables, x))
    with torch.no_grad():
        got = port.encode(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    (row,) = jsonl.read_records(str(tmp_path / f"{DATASET}_vqvae_db.jsonl"))
    assert row["weights_out"] == out["weights_out"] and row["loss"] == out["loss"]
    with pytest.raises(SystemExit, match="no vqvae spec"):
        train_vqvae.main(["--dataset", "synthetic_64x8", "--outdir", str(tmp_path),
                          "--device", "cpu"])


def test_latents_cache_cross_reads_in_both_directions(tmp_path):
    params = _jax_vq_params(6)
    path = str(tmp_path / "vq.npy")
    np.save(path, params, allow_pickle=True)
    images = _images(7, 5)
    jm, variables = jax_vqvae.load_vqvae(JAX_CFG.vqvae, path)
    port = load_vqvae(CFG.vqvae, path, device="cpu")
    # JAX writes, the port reads (and its own encode agrees).
    jax_cache = str(tmp_path / "jax" / "vqvae_latents.npy")
    want = jax_vqvae.precompute_latents(jm, variables, images, batch_size=2,
                                        cache_path=jax_cache)
    assert precompute_latents(port, images, cache_path=jax_cache) is not None
    np.testing.assert_array_equal(precompute_latents(port, images, cache_path=jax_cache), want)
    fresh = precompute_latents(port, images, batch_size=2)
    assert fresh.shape == (5, 4, 4, 3) and fresh.dtype == np.float32
    np.testing.assert_allclose(fresh, want, atol=1e-4, rtol=0)
    # The port writes, JAX reads.
    port_cache = str(tmp_path / "port" / "vqvae_latents.npy")
    written = precompute_latents(port, images, batch_size=3, cache_path=port_cache)
    np.testing.assert_array_equal(
        jax_vqvae.precompute_latents(jm, variables, images, cache_path=port_cache), written)


def test_sample_loop_with_the_vq_decoder_matches_jax(tmp_path):
    """DDIM with decode_fn from the same initial noise (the JAX loop's own
    draw, injected into the port), the VQ weights from one .npy file."""
    spec = JAX_CFG.unet
    params = _jax_params(spec, 8)
    path = str(tmp_path / "vq.npy")
    vq_params = _jax_vq_params(9)
    np.save(path, vq_params, allow_pickle=True)
    jm = jax_vqvae.VQVAE(JAX_CFG.vqvae)
    # The JAX decode_fn on device arrays: its load_vqvae keeps a weights file's
    # numpy arrays, whose codebook a traced index cannot take (ROADMAP C3).
    vq_vars = {"params": jax.tree_util.tree_map(jnp.asarray, vq_params)}

    def jax_decode(z):
        return jm.apply(vq_vars, z / JAX_CFG.vqvae.scaling_factor, method=jm.decode)

    jsched = JaxSchedulerSpec()
    shape = (2, spec.sample_size, spec.sample_size, spec.in_channels)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda p: jax_sample_loop(
        JaxUNet2D(spec).apply, p, jax_make_schedule(jsched), jsched, shape, key,
        num_inference_steps=3, kind="ddim", decode_fn=jax_decode))(params))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], shape, dtype=jnp.float32))

    model = UNet2D(_port_spec(spec))
    model.load_state_dict(params_from_jax(params))
    model.eval()
    got = sample_loop(model, make_schedule(SchedulerSpec()), SchedulerSpec(),
                      (2, 3, spec.sample_size, spec.sample_size), device="cpu",
                      init_noise=_nchw(noise), num_inference_steps=3,
                      decode_fn=make_vq_decode_fn(CFG.vqvae, path, device="cpu"))
    assert got.shape == (2, 3, 16, 16) and want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("policy", ["full", "convs", "convs_dots"])
def test_remat_policy_gradients_equal_no_remat(policy):
    spec = config_for("synthetic_32x8_big").unet
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))
    t = torch.tensor([3, 900])
    grads = []
    for remat, remat_policy in ((False, None), (True, policy)):
        model = build_unet(spec, 0, remat=remat, remat_policy=remat_policy)
        (model(x, t) ** 2).mean().backward()
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with pytest.raises(ValueError, match="remat_policy"):
        build_unet(spec, 0, remat=True, remat_policy="dots")


def test_latent_train_step_with_injected_batch_indices_matches_jax():
    """The trainer's float32 latents: a member's batch at injected slots is the
    latents at its table's indices, as they are; one train step on it with
    injected timesteps and noise against the JAX step's loss and update."""
    spec = JAX_CFG.unet
    params = _jax_params(spec, 11)
    rng = np.random.default_rng(12)
    latents = rng.standard_normal((10, 4, 4, 3)).astype(np.float32)
    subset = np.array([1, 4, 6, 9])
    trainer = EnsembleTrainer(
        tx=make_optimizer("adam", lr=1e-3), schedule=make_schedule(SchedulerSpec()),
        spec=SchedulerSpec(), images_u8=latents, member_indices=[subset], batch_size=4,
        device=torch.device("cpu"))
    raw = torch.tensor([0, 5, 2, 7])
    batch = trainer.batch(raw[None])[0]
    assert torch.equal(batch, _nchw(latents[subset[[0, 1, 2, 3]]]))
    t = rng.integers(0, 1000, 4).astype(np.int32)
    noise = rng.standard_normal((4, 4, 4, 3)).astype(np.float32)

    jsched = jax_make_schedule(JaxSchedulerSpec())
    tx = jax_state.make_optimizer("adam", lr=1e-3)
    images = latents[subset]
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_diffusion_loss(
        JaxUNet2D(spec).apply, p, jsched, images, noise, t)))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  optax.apply_updates(params, updates)))

    model = UNet2D(_port_spec(spec))
    model.load_state_dict(params_from_jax(params))
    state = TrainState.create(model, trainer.tx)
    step = make_train_step(trainer.tx, trainer.schedule, trainer.spec)
    metrics = step(state, batch, timesteps=torch.from_numpy(t).long(), noise=_nchw(noise))
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), atol=1e-5, rtol=0)
    start, (got, _) = params_from_jax(params), state.state_dicts()
    for n, w in want.items():
        if n.endswith("to_k.bias"):
            continue  # zero gradient in exact arithmetic: Adam normalises float noise
        moved = w - start[n]
        err = torch.linalg.vector_norm(got[n] - start[n] - moved).item()
        assert err <= 1e-2 * torch.linalg.vector_norm(moved).item(), n


def test_train_ensemble_and_generate_samples_on_a_latent_workload(tmp_path):
    """train_ensemble encodes once (a second call reads the cache), trains on
    the latents with the eval probe in latent space and samples through the VQ
    decoder; generate_samples writes the VQ-VAE's image size."""
    argv = ["--dataset", DATASET, "--removal_dist", "shapley", "--num_seeds", "2",
            "--training_steps", "2", "--eval_loss", "--n_samples", "2",
            "--num_inference_steps", "2", "--outdir", str(tmp_path), "--device", "cpu",
            "--remat", "--remat_policy", "convs"]
    first = train_ensemble.main(argv)
    cache = tmp_path / DATASET / "precomputed_emb" / "vqvae_latents.npy"
    assert first["latents_cached"] is False and cache.exists()
    assert np.load(cache).shape == (64, 4, 4, 3)
    assert first["samples"].shape == (2, 2, 3, 16, 16)
    assert np.isfinite(first["eval_losses"]).all() and np.isfinite(first["losses"]).all()
    second = train_ensemble.main(argv + ["--seed_start", "2"])
    assert second["latents_cached"] is True and second["seeds"] == [2, 3]
    out = tmp_path / "pngs"
    generate_samples.main(["--dataset", DATASET, "--load", first["model_dirs"][0],
                           "--sample_outdir", str(out), "--n_samples", "3",
                           "--batch_size", "2", "--num_inference_steps", "2",
                           "--device", "cpu"])
    from PIL import Image

    pngs = sorted(p for p in os.listdir(out) if p.endswith(".png"))
    assert len(pngs) == 3 and Image.open(out / pngs[0]).size == (16, 16)


def test_the_plain_attention_route_is_for_card_tensors_the_kernels_do_not_take():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 1, 512, generator=g).requires_grad_(True) for _ in range(3))
    before = (attention_plain_route.launches, attention_bwd_plain_route.launches)
    dot_product_attention(q, k, v).sum().backward()  # the CPU takes the plain version
    assert (attention_plain_route.launches, attention_bwd_plain_route.launches) == before
    for fn, args in ((attention_plain_route, (q, k, v)),
                     (attention_bwd_plain_route, (q, k, v, q))):
        with pytest.raises(ValueError, match="plain route"):
            fn(*(a.detach() for a in args))


def _write_celeba(root, ids, size):
    from PIL import Image

    os.makedirs(root)
    rng = np.random.default_rng(13)
    rows = []
    for i, celeb in enumerate(ids):
        name = f"{i:05d}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(root, name))
        rows.append(f"{name},{celeb}")
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("filename,celeb\n" + "\n".join(rows) + "\n")


def test_celeba_loader_matches_the_jax_loader(tmp_path):
    """Group codes as pandas' category codes: integer ids sort numerically, so
    2 comes before 10; images, names and codes equal the JAX loader's."""
    root = str(tmp_path / "celeba_hq" / "train")
    _write_celeba(root, [10, 2, 7, 2, 10, 3], 256)
    got = datasets.create_dataset("celeba", dataset_dir=str(tmp_path))
    want = jax_datasets.create_dataset("celeba", dataset_dir=str(tmp_path))
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.tolist() == [3, 0, 2, 0, 3, 1]
    assert got.names == want.names == [f"{i:05d}.png" for i in range(6)]
    np.testing.assert_array_equal(got.images, want.images)
    assert got.images.shape == (6, 256, 256, 3)
    text = ["b", "a", "10", "2", ""]
    assert datasets.category_codes(text).tolist() == [3, 2, 0, 1, -1]


def test_train_vqvae_flags_and_defaults_match_the_jax_cli():
    from group_attribution_for_diffusion_models_tpu.cli import train_vqvae as jax_cli

    argv = ["--dataset", DATASET, "--outdir", "o"]
    port = vars(train_vqvae.parse_args(argv))
    assert port.pop("device") == "cuda"
    assert port == vars(jax_cli.parse_args(argv))
