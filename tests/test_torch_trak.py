"""The port's TRAK path against the JAX package's, on the CPU.

- Per-sample gradients: the port's timestep-mean gradient rows
  (``make_grad_feature_fn(...).mean_gradients``) against
  ``jax.vmap(jax.grad(.))`` of the JAX U-Net built here from the same
  images, noise and timesteps, parameter by parameter, for the six output
  functions and for ``attn_full``; the `vmap`-rule path against a loop of
  per-example autograd calls; the probe sketch against down^T grad_kernel.
- The JL projection's plain version (the CUDA kernel's reference): the hash
  contract, determinism, an explicit R, tile-size independence, linearity,
  norms and distances, and TRAK scores against the JAX ``jl_project_xla``.
- ``sample_with_trajectory``, the numpy score functions, and the
  ``grad_features``/``traks`` CLIs end to end.

Tolerances: per-sample gradients of two float32 U-Nets (convolutions summed
in other orders) agree to max |g_port - g_jax| <= 1e-4 * max |g_jax| per row,
as tests/test_torch_backward.py holds the U-Net's gradients; the vmap path
and the per-example loop run the same float32 ops on other batch shapes,
1e-5 * max |g|; the JL plain version is held exactly where its sums are of
small integers (exact in float32), to 1e-4 relative elsewhere.

One divergence from the JAX package, deliberate: its per-sample output
function reads ``f(eps[0], noise[0])`` with a per-sample noise of shape
(H, W, C), so the 'loss' features compare the prediction with the noise's
first row broadcast over H. The port compares with the whole noise, as the
reference D-TRAK loss does; the JAX reference below is built the same way.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

from group_attribution_for_diffusion_models_tpu.attributions.methods import trak as jax_trak
from group_attribution_for_diffusion_models_tpu.cli import grad_features as jax_grad_features
from group_attribution_for_diffusion_models_tpu.cli import traks as jax_traks
from group_attribution_for_diffusion_models_tpu.config import SchedulerSpec as JaxSchedulerSpec
from group_attribution_for_diffusion_models_tpu.diffusion import make_schedule as jax_make_schedule
from group_attribution_for_diffusion_models_tpu.diffusion.sampling import (
    sample_with_trajectory as jax_sample_with_trajectory,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import add_noise as jax_add_noise
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.ops.jl_projection import jl_project_xla
from group_attribution_for_diffusion_models_tpu_torch.attributions.methods import trak
from group_attribution_for_diffusion_models_tpu_torch.cli import grad_features, traks
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.diffusion import (
    add_noise,
    make_schedule,
    sample_with_trajectory,
)
from group_attribution_for_diffusion_models_tpu_torch.models import (
    UNet2D,
    build_unet,
    params_from_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
    attention_params_filter,
    probe_sketch_init,
)
from group_attribution_for_diffusion_models_tpu_torch.ops import jl_projection
from group_attribution_for_diffusion_models_tpu_torch.ops.jl_projection import (
    jl_project,
    jl_project_kernel,
    jl_project_plain,
    jl_project_pytree,
    rademacher_rows,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint
from test_torch_unet import _jax_params, _port_spec
from test_trak import ATTN_TINY

GRAD_RTOL = 1e-4
LOOP_RTOL = 1e-5
TIMESTEPS = 2  # feature grid (0, 500)
B = 3
NO_ATTENTION = dataclasses.replace(config_for("synthetic_64x8").unet, add_attention=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """The JAX ATTN_TINY params, the port's model carrying them, numpy
    images (NHWC) and one noise draw per timestep."""
    params = _jax_params(ATTN_TINY, 3)
    model = UNet2D(_port_spec(ATTN_TINY))
    model.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(11)
    images = rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32)
    noise = rng.standard_normal((TIMESTEPS, B, 8, 8, 3)).astype(np.float32)
    return params, model.eval(), images, noise


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _port_mean_grads(model, images, noise, output_fn="loss", **kw):
    spec = SchedulerSpec()
    fn = trak.make_grad_feature_fn(model, make_schedule(spec), spec, output_fn=output_fn,
                                   num_timesteps=TIMESTEPS, **kw)
    return fn.mean_gradients(_nchw(images), noise=[_nchw(n) for n in noise])


@pytest.fixture(scope="module")
def jax_grads(tiny):
    """{output fn: [per-sample {port parameter name: gradient}]} from the
    JAX U-Net, averaged over the feature grid: per sample and timestep the
    jacobian of the six output functions (each row one jax.grad), vmapped
    over timesteps and samples, in one jit."""
    params, _, images, noise = tiny
    spec = JaxSchedulerSpec()
    schedule = jax_make_schedule(spec)
    apply = JaxUNet2D(ATTN_TINY).apply
    ts = jnp.asarray(jax_trak.feature_timesteps(spec.num_train_timesteps, TIMESTEPS))
    fns = [jax_trak._output_fn(name) for name in jax_trak.OUTPUT_FNS]

    def outputs(p, image, n, t):
        x_t = jax_add_noise(schedule, image[None], n[None], t[None])
        eps = apply({"params": p}, x_t, t[None])[0]
        return jnp.stack([f(eps, n) for f in fns])

    def per_sample(p, image, noises):
        g = jax.vmap(jax.jacrev(outputs), in_axes=(None, None, 0, 0))(p, image, noises, ts)
        return jax.tree_util.tree_map(lambda x: x.mean(0), g)

    grads = jax.jit(jax.vmap(per_sample, in_axes=(None, 0, 1)))(
        params, jnp.asarray(images), jnp.asarray(noise))
    grads = jax.tree_util.tree_map(np.asarray, grads)  # leaves (B, 6, ...)
    return {name: [params_from_jax(jax.tree_util.tree_map(lambda g: g[b, i], grads))
                   for b in range(B)]
            for i, name in enumerate(jax_trak.OUTPUT_FNS)}


def _rows(per_sample, names):
    return torch.stack([torch.cat([s[n].reshape(-1) for n in names]) for s in per_sample])


def _assert_rows_close(got, want, rtol):
    for b in range(got.shape[0]):
        scale = want[b].abs().max().item()
        assert scale > 0
        err = (got[b] - want[b]).abs().max().item()
        assert err <= rtol * scale, (b, err, scale)


@pytest.mark.parametrize("output_fn", trak.OUTPUT_FNS)
def test_per_sample_mean_gradients_match_jax(tiny, jax_grads, output_fn):
    _, model, images, noise = tiny
    got = _port_mean_grads(model, images, noise, output_fn)
    names = [n for n, _ in model.named_parameters()]
    assert got.shape == (B, sum(p.numel() for p in model.parameters()))
    _assert_rows_close(got, _rows(jax_grads[output_fn], names), GRAD_RTOL)


def test_attn_full_gradients_match_jax(tiny, jax_grads):
    _, model, images, noise = tiny
    names = attention_params_filter(model)
    # 4 attention blocks (down, mid, 2 up) x 4 projections x (weight, bias).
    assert len(names) == 32 and all(".to_" in n for n in names)
    assert any(n.endswith("to_out.0.weight") for n in names)
    got = _port_mean_grads(model, images, noise, params_filter=names)
    assert got.shape[1] == 4 * 4 * (16 * 16 + 16)
    _assert_rows_close(got, _rows(jax_grads["loss"], names), GRAD_RTOL)


def test_vmap_rules_batch_the_kernels_and_match_a_per_example_loop(tiny, monkeypatch):
    """The vmap path calls each attention and GroupNorm op once per timestep
    for the whole batch, and gives what a loop of per-example autograd calls
    through the same Functions gives."""
    from group_attribution_for_diffusion_models_tpu_torch.ops import attention, group_norm

    _, model, images, noise = tiny
    calls = {"attn": 0, "attn_bwd": 0, "gn_bwd": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(attention, "attention_plain", counting("attn", attention.attention_plain))
    monkeypatch.setattr(attention, "attention_bwd_plain",
                        counting("attn_bwd", attention.attention_bwd_plain))
    monkeypatch.setattr(group_norm, "group_norm_silu_bwd_plain",
                        counting("gn_bwd", group_norm.group_norm_silu_bwd_plain))
    got = _port_mean_grads(model, images, noise, "l2-norm")
    n_attn = sum(type(m).__name__ == "SelfAttention2D" for m in model.modules())
    n_gn = sum(type(m).__name__ == "GroupNormSiLU" for m in model.modules())
    assert calls == {"attn": TIMESTEPS * n_attn, "attn_bwd": TIMESTEPS * n_attn,
                     "gn_bwd": TIMESTEPS * n_gn}

    schedule = make_schedule(SchedulerSpec())
    params = [p for _, p in model.named_parameters()]
    want = torch.zeros_like(got)
    for i, t in enumerate(trak.feature_timesteps(1000, TIMESTEPS)):
        for b in range(B):
            x0, n = _nchw(images[b:b + 1]), _nchw(noise[i, b:b + 1])
            t_b = torch.full((1,), int(t))
            eps = model(add_noise(schedule, x0, n, t_b), t_b)
            g = torch.autograd.grad(torch.sqrt(torch.sum(eps ** 2)), params)
            want[b] += torch.cat([x.reshape(-1) for x in g]) / TIMESTEPS
    _assert_rows_close(got, want, LOOP_RTOL)


def test_probe_sketch_is_down_transpose_times_the_kernel_gradient(tiny, jax_grads):
    _, model, images, noise = tiny
    full = _port_mean_grads(model, images, noise)
    names = [n for n, _ in model.named_parameters()]
    sizes = dict((n, p.numel()) for n, p in model.named_parameters())
    offsets = dict(zip(names, np.cumsum([0] + [sizes[n] for n in names[:-1]])))

    probe = probe_sketch_init(model, k=4, generator=torch.Generator().manual_seed(0))
    assert len(probe) == 16 and any(m.endswith("to_out.0") for m in probe)
    rng = np.random.default_rng(5)
    for ab in probe.values():  # the same downs as a numpy draw hands them over
        assert ab["down"].shape[1] == 4 and not ab["up"].any()
        assert set(ab["down"].abs().unique().tolist()) == {0.5}
        ab["down"] = torch.from_numpy(
            (rng.integers(0, 2, ab["down"].shape) * 2 - 1).astype(np.float32) / 2.0)

    # up = 0: the forward is the model's own, bit for bit.
    x, t = _nchw(images), torch.tensor([999, 17, 3])
    attached = {f"{m}.{k}": v for m, ab in probe.items()
                for k, v in (("lora_down", ab["down"]), ("lora_up", ab["up"]))}
    with torch.no_grad():
        torch.testing.assert_close(torch.func.functional_call(model, attached, (x, t)),
                                   model(x, t), atol=0, rtol=0)
    assert not any("lora" in k for k in model.state_dict())

    sketch = _port_mean_grads(model, images, noise, sketch_probe=probe)
    offset = 0
    for m, ab in probe.items():
        k, out = ab["up"].shape
        got = sketch[:, offset:offset + k * out].reshape(B, k, out)
        offset += k * out
        w = f"{m}.weight"
        port_w = full[:, offsets[w]:offsets[w] + sizes[w]].reshape(B, out, -1)
        jax_w = torch.stack([s[w] for s in jax_grads["loss"]])
        for grad_w in (port_w, jax_w):
            want = ab["down"].T @ grad_w.transpose(1, 2)  # down^T grad_kernel
            _assert_rows_close(got.reshape(B, -1), want.reshape(B, -1), GRAD_RTOL)
    assert offset == sketch.shape[1]


def test_sketch_and_filter_are_exclusive(tiny):
    _, model, _, _ = tiny
    probe = probe_sketch_init(model, k=2)
    with pytest.raises(ValueError, match="exclusive"):
        trak.PerSampleGradients(model, sketch_probe=probe, params_filter=["conv_in.weight"])
    with pytest.raises(ValueError, match="unknown parameters"):
        trak.PerSampleGradients(model, params_filter=["nope.weight"])
    plain = build_unet(NO_ATTENTION, seed=0)
    assert attention_params_filter(plain) is None and probe_sketch_init(plain) == {}


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_jl_signs_follow_the_kernels_hash():
    """R[d, p] is bit p % 32 of word(d, p // 32), set meaning -1, with the
    uint32 hash csrc/jl_projection.cu computes."""
    seed = 123456789
    key = _fmix32(seed ^ 0x9E3779B9)
    r = rademacher_rows(seed, 1000, 1010, 70)
    for d in range(1000, 1010):
        for p in range(70):
            word = _fmix32(_fmix32(key ^ ((p // 32) * 0x9E3779B9 & 0xFFFFFFFF))
                           ^ ((d * 0x27D4EB2F) & 0xFFFFFFFF))
            assert r[d - 1000, p].item() == (-1.0 if word >> (p % 32) & 1 else 1.0)
    big = rademacher_rows(3, 0, 4096, 512)
    assert abs(big.mean().item()) < 0.01  # balanced signs
    assert abs((big[:-1] * big[1:]).mean().item()) < 0.01  # neighbouring d uncorrelated
    assert abs((big[:, :-1] * big[:, 1:]).mean().item()) < 0.01  # and neighbouring p


def test_jl_plain_is_deterministic_and_equals_an_explicit_r():
    rng = np.random.RandomState(0)
    g = torch.from_numpy(rng.normal(size=(8, 10000)).astype(np.float32))
    y1, y2, y3 = (jl_project_plain(g, 2048, seed=s) for s in (1, 1, 2))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    scale = np.float32(1 / np.sqrt(2048))
    # Identity rows give R's rows / sqrt(P) exactly.
    eye = torch.eye(40, 3000)
    assert torch.equal(jl_project_plain(eye, 777, seed=5),
                       rademacher_rows(5, 0, 40, 777) * float(np.float32(1 / np.sqrt(777))))
    explicit = (g.double() @ rademacher_rows(1, 0, 10000, 2048).double()) * float(scale)
    torch.testing.assert_close(y1.double(), explicit, atol=1e-4 * explicit.abs().max().item(),
                               rtol=0)
    # jl_project takes the plain version for a CPU tensor; the kernel refuses one.
    assert torch.equal(jl_project(g, 2048, seed=1), y1)
    with pytest.raises(ValueError, match="CUDA"):
        jl_project_kernel(g, 2048)
    leaves = [g[:, :3000].reshape(8, 30, 100), g[:, 3000:]]
    assert torch.equal(jl_project_pytree(leaves, 2048, seed=1), y1)


@pytest.mark.parametrize("tile_d", [13, 77, 2048, 70001])
def test_jl_plain_does_not_depend_on_the_tile_size(tile_d):
    # Small integers: every partial sum is exact in float32, in any order.
    g = torch.from_numpy(np.random.RandomState(1).randint(-3, 4, (3, 70001)).astype(np.float32))
    want = jl_project_plain(g, 1000, seed=9, tile_d=1024)
    assert torch.equal(jl_project_plain(g, 1000, seed=9, tile_d=tile_d), want)


def test_jl_plain_is_linear_and_keeps_norms_and_distances():
    rng = np.random.RandomState(2)
    a, b = (torch.from_numpy(rng.normal(size=(2, 3000)).astype(np.float32)) for _ in range(2))
    torch.testing.assert_close(jl_project_plain(a + b, 512, seed=5),
                               jl_project_plain(a, 512, seed=5) + jl_project_plain(b, 512, seed=5),
                               atol=1e-3, rtol=0)
    g = torch.from_numpy(rng.normal(size=(8, 10000)).astype(np.float32))
    y = jl_project_plain(g, 2048, seed=1)
    np.testing.assert_allclose((y.norm(dim=1) / g.norm(dim=1)).numpy(), 1.0, atol=0.15)
    g6 = torch.from_numpy(np.random.RandomState(1).normal(size=(6, 5000)).astype(np.float32))
    y6 = jl_project_plain(g6, 2048, seed=0)
    iu = np.triu_indices(6, 1)
    ratio = torch.cdist(y6, y6).numpy()[iu] / torch.cdist(g6, g6).numpy()[iu]
    np.testing.assert_allclose(ratio, 1.0, atol=0.15)


def test_trak_scores_rank_like_the_jax_projection(tiny):
    """Two JL streams of the same unprojected features (the tiny U-Net's
    mean gradients of 12 train and 4 generated images) give grad-sim scores
    of the same ranking, up to the projections' noise: Spearman > 0.9 with
    each other, as with the unprojected scores."""
    _, model, _, _ = tiny
    rng = np.random.default_rng(4)
    imgs = rng.uniform(-1, 1, (16, 8, 8, 3)).astype(np.float32)
    noise = rng.standard_normal((TIMESTEPS, 16, 8, 8, 3)).astype(np.float32)
    feats = _port_mean_grads(model, imgs, noise, "mean").numpy()
    exact = jax_trak.compute_gradient_scores(feats[:12], feats[12:], "grad_sim").ravel()
    port = jl_project_plain(torch.from_numpy(feats), 2048, seed=0).numpy()
    jaxp = np.asarray(jl_project_xla(jnp.asarray(feats), 2048, seed=0))
    s_port = trak.compute_gradient_scores(port[:12], port[12:], "grad_sim").ravel()
    s_jax = jax_trak.compute_gradient_scores(jaxp[:12], jaxp[12:], "grad_sim").ravel()
    assert spearmanr(s_port, s_jax)[0] > 0.9
    assert spearmanr(s_port, exact)[0] > 0.9 and spearmanr(s_jax, exact)[0] > 0.9


def test_sample_with_trajectory_matches_jax():
    cfg = config_for("synthetic_32x8")
    model = build_unet(cfg.unet, seed=2).eval()
    from group_attribution_for_diffusion_models_tpu_torch.models import params_to_jax

    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    key = jax.random.PRNGKey(3)
    shape = (2, 8, 8, 3)
    want = jax_sample_with_trajectory(JaxUNet2D(cfg.unet).apply, params,
                                      jax_make_schedule(JaxSchedulerSpec()), JaxSchedulerSpec(),
                                      shape, key, num_inference_steps=4)
    key_init, _ = jax.random.split(key)  # as the JAX sampler splits it
    noise = np.array(jax.random.normal(key_init, shape, dtype=jnp.float32))
    imgs, traj, ts = sample_with_trajectory(
        model, make_schedule(cfg.scheduler), cfg.scheduler, (2, 3, 8, 8), device="cpu",
        init_noise=_nchw(noise), num_inference_steps=4)
    assert traj.shape == (4, 2, 3, 8, 8) and not traj.is_inference()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(np.moveaxis(imgs.numpy(), 1, -1), np.asarray(want[0]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.moveaxis(traj.numpy(), 2, -1), np.asarray(want[1]),
                               atol=1e-4, rtol=0)


def test_numpy_parts_equal_jax():
    for n, s in ((1000, 10), (1000, 7), (1000, 3)):
        for strategy in ("uniform", "cumulative"):
            np.testing.assert_array_equal(trak.feature_timesteps(n, s, strategy),
                                          jax_trak.feature_timesteps(n, s, strategy))
    rng = np.random.RandomState(3)
    phi_t, phi_g = rng.normal(size=(20, 16)), rng.normal(size=(5, 16))
    labels = rng.randint(0, 4, 20)
    for method in ("grad_sim", "trak", "relative_if", "renormalized_if"):
        got = trak.compute_gradient_scores(phi_t, phi_g, method, 0.1)
        np.testing.assert_array_equal(got, jax_trak.compute_gradient_scores(phi_t, phi_g,
                                                                            method, 0.1))
        for mode in ("sum", "mean", "max"):
            np.testing.assert_array_equal(trak.aggregate_by_group(got, labels, mode),
                                          jax_trak.aggregate_by_group(got, labels, mode))
    with pytest.raises(ValueError):
        trak.compute_gradient_scores(phi_t, phi_g, "bogus")
    assert trak.OUTPUT_FNS == jax_trak.OUTPUT_FNS


def test_grad_features_and_traks_end_to_end(tmp_path):
    spec = config_for("synthetic_64x8").unet
    save_checkpoint(str(tmp_path / "m"), 2, build_unet(spec, 0).state_dict(),
                    build_unet(spec, 1).state_dict(), unet_spec=spec)
    store = str(tmp_path / "f" / "feats.npz")
    common = ["--dataset", "synthetic_64x8", "--load", str(tmp_path / "m"), "--save_path",
              store, "--proj_dim", "32", "--num_timesteps", "2", "--batch_size", "16",
              "--num_inference_steps", "2", "--device", "cpu"]
    train = grad_features.main(common + ["--source", "train", "--max_examples", "20"])
    assert train["features_shape"] == (20, 32) and len(train["batch_seconds"]) == 2
    assert train["grad_dim"] == sum(p.numel() for p in build_unet(spec, 0).parameters())
    mm = np.load(str(tmp_path / "f" / "feats_train_mm.npy"))
    with open(tmp_path / "f" / "feats_group.csv") as f:
        rows = f.read().splitlines()
    gen = grad_features.main(common + ["--source", "generated", "--n_samples", "5"])
    assert gen["features_shape"] == (5, 32) and gen["sample_seconds"] > 0
    got = np.load(store)
    assert sorted(got) == ["gen_features", "group_labels", "train_features"]
    np.testing.assert_array_equal(got["train_features"], mm)
    np.testing.assert_array_equal(got["gen_features"],
                                  np.load(str(tmp_path / "f" / "feats_generated_mm.npy")))
    assert np.isfinite(mm).all() and np.abs(mm).sum() > 0
    labels = got["group_labels"]
    assert rows == ["row,group"] + [f"{i},{g}" for i, g in enumerate(labels)]
    from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset

    np.testing.assert_array_equal(labels, create_dataset("synthetic_64x8").labels[:20])
    # Batches draw their noise from (seed, batch): a rerun repeats the features.
    grad_features.main(common + ["--source", "train", "--max_examples", "20"])
    np.testing.assert_array_equal(np.load(store)["train_features"], mm)
    journey = grad_features.main(common + ["--source", "generated_journey", "--n_samples", "3"])
    assert journey["features_shape"] == (3, 32)
    assert np.load(store)["gen_features"].shape == (3, 32)
    attrs = traks.main(["--feature_store", store, "--save_dir", str(tmp_path / "a")])
    assert set(attrs) == set(traks.METHODS)
    for method, a in attrs.items():
        assert a.shape == (len(np.unique(labels)),) and np.isfinite(a).all()
        np.testing.assert_array_equal(np.load(str(tmp_path / "a" / f"ranking_{method}.npy")),
                                      np.argsort(a)[::-1])
    sd = build_unet(NO_ATTENTION, 0).state_dict()
    save_checkpoint(str(tmp_path / "n"), 1, sd, sd, unet_spec=NO_ATTENTION)
    for mode in ("probe", "attn_full"):
        with pytest.raises(SystemExit, match="attention projections"):
            grad_features.main(common + ["--load", str(tmp_path / "n"), "--grad_mode", mode])


def test_generated_features_draw_noise_apart_from_sampling(tmp_path, monkeypatch):
    """A generated image's feature noise (first timestep) is not the initial
    latent it was sampled from: the two come from separate streams."""
    spec = config_for("synthetic_64x8").unet
    save_checkpoint(str(tmp_path / "m"), 1, build_unet(spec, 0).state_dict(),
                    build_unet(spec, 1).state_dict(), unet_spec=spec)
    first = {}

    def first_draw(key, generator, shape):
        copy = torch.Generator().set_state(generator.get_state())
        first.setdefault(key, torch.randn(shape, generator=copy))

    real_sample, real_make = grad_features.sample_loop, grad_features.make_grad_feature_fn

    def sample_loop(model, schedule, spec, shape, *, generator, **kw):
        first_draw("sample", generator, shape)
        return real_sample(model, schedule, spec, shape, generator=generator, **kw)

    def make_grad_feature_fn(*a, **kw):
        fn = real_make(*a, **kw)
        inner = fn.mean_gradients

        def mean_gradients(images, generator):
            first_draw("features", generator, images.shape)
            return inner(images, generator=generator)
        fn.mean_gradients = mean_gradients
        return fn

    monkeypatch.setattr(grad_features, "sample_loop", sample_loop)
    monkeypatch.setattr(grad_features, "make_grad_feature_fn", make_grad_feature_fn)
    grad_features.main(["--dataset", "synthetic_64x8", "--load", str(tmp_path / "m"),
                        "--save_path", str(tmp_path / "f.npz"), "--proj_dim", "8",
                        "--num_timesteps", "1", "--num_inference_steps", "1",
                        "--source", "generated", "--n_samples", "2", "--device", "cpu"])
    assert first["sample"].shape == first["features"].shape == (2, 3, 8, 8)
    assert not torch.allclose(first["sample"], first["features"])


def test_traks_on_a_jax_feature_store_writes_the_jax_files(tmp_path):
    from group_attribution_for_diffusion_models_tpu.training import TrainState, make_optimizer
    from group_attribution_for_diffusion_models_tpu.utils.ckpt import (
        save_checkpoint as jax_save_checkpoint,
    )

    jax_spec = jax_grad_features.config_for("synthetic_64x8").unet
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(jax_spec, 4))
    jax_save_checkpoint(str(tmp_path / "m"), 1,
                        TrainState.create(params, make_optimizer("adam", lr=1e-4)))
    store = str(tmp_path / "feats.npz")
    common = ["--dataset", "synthetic_64x8", "--load", str(tmp_path / "m"), "--save_path",
              store, "--proj_dim", "16", "--num_timesteps", "1", "--batch_size", "12",
              "--num_inference_steps", "2"]
    jax_grad_features.main(common + ["--source", "train", "--max_examples", "12"])
    jax_grad_features.main(common + ["--source", "generated", "--n_samples", "4"])
    argv = ["--feature_store", store, "--agg_mode", "mean"]
    jax_traks.main(argv + ["--save_dir", str(tmp_path / "jax")])
    traks.main(argv + ["--save_dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 8
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


def test_grad_features_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grad_features.main(["--dataset", "synthetic_64x8", "--load", str(tmp_path),
                            "--save_path", str(tmp_path / "f.npz")])


def test_jl_kernel_split_covers_d(monkeypatch):
    """The kernel's chunking of D (computed on the host) covers D exactly
    once in whole tiles, for the main path's and ragged shapes."""
    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    for b, d, p in ((32, 35_746_307, 4096), (3, 70_001, 1000), (2, 5, 33), (64, 393_216, 4096)):
        chunk, splits = jl_projection._split(b, d, p, "cuda")
        assert chunk % 32 == 0 and (splits - 1) * chunk < d <= splits * chunk
        assert splits <= 65535
