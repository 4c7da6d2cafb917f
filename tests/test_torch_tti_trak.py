"""The port's text-to-image TRAK features against the JAX package, on the CPU.

LoRA-only, text-conditional per-sample gradients: the port's
`make_grad_feature_fn(..., lora=, conditional=True).mean_gradients` and its
journey twin against ``jax.vmap(jax.grad)`` of the same output function
through the JAX package's `lora_merge` (the JAX CLI's ``params_filter``),
with a context for each sample, on the same numpy-drawn `tiny_sd_spec(8)`
U-Net, LoRA tree, latents, timesteps and noise; the rows are flattened in
the JAX leaf order. The reference compares the prediction with the whole
noise, as the port does (ROADMAP C3). Tolerance: rtol 1e-4 of each row's
largest gradient (a backward through 12 layers summed in other orders, and
the merge against the side branch). Then `grad_features_tti` end to end in
every source on ``synthetic_64x8``: the store's keys and shapes, group.csv,
the merge into an existing store, and `traks` on the store.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.data import groups as jax_groups
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    add_noise as jax_add_noise,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.models import lora as jax_lora
from group_attribution_for_diffusion_models_tpu_torch.attributions.methods.trak import (
    PerSampleGradients,
    make_grad_feature_fn,
    make_journey_feature_fn,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    grad_features_tti,
    traks,
    train_text_to_image_lora,
)
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
from group_attribution_for_diffusion_models_tpu_torch.diffusion import add_noise
from group_attribution_for_diffusion_models_tpu_torch.diffusion.schedulers import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
    lora_tree_from_jax,
    unet_module_name,
)
from group_attribution_for_diffusion_models_tpu_torch.ops import group_norm_silu
from test_torch_tti import SPEC, _lora_tree, _nchw, _port_unet, _unet_params

DATASET = "synthetic_64x8"
B, M, CTX = 3, 5, 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    """Drawn U-Net parameters and LoRA tree, latents, a context per sample,
    two timesteps' noise, and the JAX reference's per-sample gradients at
    each timestep (one compile for the module)."""
    params = _unet_params(70)
    lora_np = _lora_tree(params, 71)
    rng = np.random.default_rng(72)
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((B, M, CTX)).astype(np.float32)
    noise = [rng.standard_normal((B, 8, 8, 4)).astype(np.float32) for _ in range(2)]
    ts = [100, 700]
    model = JaxUNet2D(SPEC)
    schedule = jax_make_schedule(JaxSchedulerSpec())

    def per_sample(lo, latent, n, t, c, q_sample):
        def f(tr):
            p = jax_lora.lora_merge(params, tr)
            x_t = jax_add_noise(schedule, latent[None], n[None], t[None]) if q_sample \
                else latent[None]
            eps = model.apply({"params": p}, x_t, t[None], c[None])
            return jnp.mean((eps[0] - n) ** 2)  # the whole noise (ROADMAP C3)

        return jax.grad(f)(lo)

    @jax.jit
    def grads(lo, latents, n, t, c):
        out = {}
        for q in (True, False):
            g = jax.vmap(lambda *a: per_sample(*a, q_sample=q), in_axes=(None, 0, 0, 0, 0))(
                lo, latents, n, t, c)
            out[q] = jnp.concatenate([leaf.reshape(B, -1)
                                      for leaf in jax.tree_util.tree_leaves(g)], axis=1)
        return out

    lora = jax.tree_util.tree_map(jnp.asarray, lora_np)
    want = [grads(lora, jnp.asarray(x), jnp.asarray(n), jnp.full((B,), t, jnp.int32),
                  jnp.asarray(ctx)) for n, t in zip(noise, ts)]
    return params, lora_np, x, ctx, noise, ts, want


def lora_module(jax_path):
    return unet_module_name(tuple(jax_path.split("/")))


def _assert_rows_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (scale > 0).all()
    err = np.abs(got - want)
    assert (err <= 1e-4 * scale).all(), (err / scale).max()


def test_lora_only_conditional_gradients_match_jax_vmap_grad(case):
    params, lora_np, x, ctx, noise, ts, want = case
    model = _port_unet(params).requires_grad_(False)
    # The tree in another order than the JAX one: the rows still follow the JAX leaves.
    tree = dict(reversed(list(lora_tree_from_jax(lora_np).items())))
    sched = SchedulerSpec()
    # The port's timestep grid: num_timesteps=2 of 1000 gives 0 and 500; the
    # JAX reference took 100 and 700, so run the accumulator on those.
    grads = PerSampleGradients(model, lora=tree, conditional=True)
    assert grads.dim == want[0][True].shape[1]
    jax_order = sorted(lora_np)  # tree_leaves order: JAX paths sorted, down before up
    assert grads.names == [f"{lora_module(p)}.lora_{k}" for p in jax_order
                           for k in ("down", "up")]
    schedule = make_schedule(sched)
    before = group_norm_silu.affine_sums
    for (n, t), w in zip(zip(noise, ts), want):
        acc = torch.zeros(B, grads.dim)
        t_b = torch.full((B,), t, dtype=torch.long)
        grads.accumulate(acc, add_noise(schedule, _nchw(x), _nchw(n), t_b), t_b, _nchw(n),
                         torch.from_numpy(ctx))
        _assert_rows_close(acc.numpy(), w[True])
        acc.zero_()
        grads.accumulate(acc, _nchw(x), t_b, _nchw(n), torch.from_numpy(ctx))
        _assert_rows_close(acc.numpy(), w[False])
    assert group_norm_silu.affine_sums == before  # the frozen base sums no gamma/beta
    with pytest.raises(ValueError, match="encoder_hidden_states"):
        grads.accumulate(acc, _nchw(x), t_b, _nchw(n))
    with pytest.raises(ValueError, match="exclusive"):
        PerSampleGradients(model, lora=tree, params_filter=["conv_in.weight"])


def test_feature_and_journey_extractors_average_the_per_sample_gradients(case):
    """`make_grad_feature_fn` (q-samples at its grid) and
    `make_journey_feature_fn` (the given latents) with `lora` and a context
    per sample, against the JAX reference's mean over the same points."""
    params, lora_np, x, ctx, noise, ts, want = case
    model = _port_unet(params).requires_grad_(False)
    tree = lora_tree_from_jax(lora_np)
    sched = SchedulerSpec()
    schedule = make_schedule(sched)
    journey = make_journey_feature_fn(model, schedule, sched, proj_dim=16, lora=tree,
                                      conditional=True)
    traj = torch.stack([_nchw(x), _nchw(x)])
    got = journey.mean_gradients(traj, torch.tensor(ts), noise=[_nchw(n) for n in noise],
                                 encoder_hidden_states=torch.from_numpy(ctx))
    _assert_rows_close(got.numpy(), (np.asarray(want[0][False])
                                     + np.asarray(want[1][False])) / 2)
    feat = make_grad_feature_fn(model, schedule, sched, proj_dim=16, num_timesteps=2,
                                lora=tree, conditional=True)
    out = feat(_nchw(x), generator=torch.Generator().manual_seed(0),
               encoder_hidden_states=torch.from_numpy(ctx))
    assert out.shape == (B, 16) and torch.isfinite(out).all() and feat.dim == journey.dim


@pytest.fixture(scope="module")
def lora_path(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tti_trak"))
    r = train_text_to_image_lora.main([
        "--dataset", DATASET, "--outdir", out, "--removal_dist", "full",
        "--max_train_steps", "1", "--train_batch_size", "8", "--rank", "2", "--device", "cpu"])
    return out, r["lora_paths"][0]


def test_grad_features_tti_end_to_end_in_every_source(lora_path, tmp_path):
    out, lora = lora_path
    store = str(tmp_path / "feats" / "f.npz")
    common = ["--dataset", DATASET, "--outdir", out, "--lora_dir", lora, "--proj_dim", "32",
              "--num_timesteps", "2", "--num_inference_steps", "2", "--batch_size", "4",
              "--save_path", store, "--device", "cpu"]
    tr = grad_features_tti.main(common + ["--source", "train", "--max_examples", "10"])
    assert tr["features_shape"] == (10, 32) and len(tr["batch_seconds"]) == 3
    assert len(tr["grad_seconds"]) == len(tr["jl_seconds"]) == 3
    files = [f"artist-{lab}_work_{i}.jpg" for i, lab in enumerate(create_dataset(DATASET).labels)]
    with open(tmp_path / "feats" / "group.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == "row,unit" and len(lines) == 11
    assert lines[1:] == [f"{i},{jax_groups.artist_from_filename(n)}"
                         for i, n in enumerate(files[:10])]
    with np.load(store) as s:
        assert sorted(s.files) == ["group_labels", "train_features"]
        units = sorted({jax_groups.artist_from_filename(n) for n in files})
        np.testing.assert_array_equal(
            s["group_labels"], [units.index(jax_groups.artist_from_filename(n))
                                for n in files[:10]])
        train, labels = s["train_features"], s["group_labels"]
    np.testing.assert_array_equal(np.load(store.replace(".npz", "_train_mm.npy")), train)
    gen = grad_features_tti.main(common + ["--source", "generated", "--n_samples", "3"])
    assert gen["features_shape"] == (3, 32) and gen["grad_dim"] == tr["grad_dim"]
    with np.load(store) as s:  # merged into the train store
        assert sorted(s.files) == ["gen_features", "group_labels", "train_features"]
        np.testing.assert_array_equal(s["train_features"], train)
    attrs = traks.main(["--feature_store", store, "--save_dir", str(tmp_path / "a")])
    assert all(a.shape == (len(np.unique(labels)),) and np.isfinite(a).all()
               for a in attrs.values())
    jr = grad_features_tti.main(common[:-4] + ["--save_path", str(tmp_path / "j.npz"),
                                               "--device", "cpu", "--source",
                                               "generated_journey", "--n_samples", "2"])
    with np.load(tmp_path / "j.npz") as s:
        assert s.files == ["gen_features"] and s["gen_features"].shape == (2, 32)
        assert np.isfinite(s["gen_features"]).all()
    assert jr["grad_dim"] == tr["grad_dim"]
    probe = grad_features_tti.main(common[:-4] + ["--save_path", str(tmp_path / "p.npz"),
                                                  "--device", "cpu", "--source", "train",
                                                  "--max_examples", "4", "--grad_mode",
                                                  "probe"])
    assert probe["features_shape"] == (4, 32) and probe["grad_dim"] != tr["grad_dim"]
    # A second train call gives the same features: every draw is seeded.
    again = grad_features_tti.main(common[:-4] + ["--save_path", str(tmp_path / "r.npz"),
                                                  "--device", "cpu", "--source", "train",
                                                  "--max_examples", "10"])
    with np.load(again["save_path"]) as s:
        np.testing.assert_array_equal(s["train_features"], train)


def test_grad_features_tti_flags_match_the_jax_cli():
    from group_attribution_for_diffusion_models_tpu.cli import grad_features_tti as jax_cli

    argv = ["--outdir", "o", "--lora_dir", "l.npz", "--save_path", "s.npz"]
    got = vars(grad_features_tti.parse_args(argv))
    assert got.pop("device") == "cuda" and got == vars(jax_cli.parse_args(argv))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grad_features_tti.main(argv)


def test_probe_mode_on_generated_latents_samples_from_one_merge(lora_path, tmp_path):
    """--grad_mode probe merges the LoRA into the base for the sketch; the
    generated source samples from the LoRA merged once, as in full mode:
    the generated latents of both modes are the same."""
    out, lora = lora_path
    seen = []
    real = grad_features_tti.sample_loop

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(grad_features_tti, "sample_loop", spy)
    try:
        for mode in ("full", "probe"):
            grad_features_tti.main(["--dataset", DATASET, "--outdir", out, "--lora_dir", lora,
                                    "--source", "generated", "--n_samples", "2",
                                    "--num_inference_steps", "2", "--num_timesteps", "1",
                                    "--proj_dim", "8", "--grad_mode", mode, "--save_path",
                                    str(tmp_path / f"{mode}.npz"), "--device", "cpu"])
    finally:
        mp.undo()
    assert len(seen) == 2
    torch.testing.assert_close(seen[0], seen[1], atol=0, rtol=0)
