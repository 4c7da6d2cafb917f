"""The port's diversity behavior and BLIP vision tower against the JAX
package's, on the CPU.

Ward clustering, nearest-cluster assignment, entropy and the CLI on
``--embeddings_npz`` are numpy and scipy on both sides: bit for bit. The
BLIP tower (the ``--blip_tiny`` geometry: 32 px, patch 8, width 32, 2 layers,
2 heads) holds the JAX tower's output within 2e-3 from the same numpy-drawn
params carried across by `params_from_jax`, on 16 px inputs (resized up to
32) and 48 px ones (resized down, antialiased): f32 on both sides, the
LayerNorms' variance formulas differ (flax's E[x^2] - E[x]^2) and bilinear
weights are computed in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    diversity as jax_diversity,
)
from group_attribution_for_diffusion_models_tpu.cli import (
    calculate_global_scores_diversity as jax_cli,
)
from group_attribution_for_diffusion_models_tpu.models import blip_vision as jax_blip
from group_attribution_for_diffusion_models_tpu_torch.attributions.global_scores import (
    diversity,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    calculate_global_scores_diversity,
    train_ensemble,
)
from group_attribution_for_diffusion_models_tpu_torch.models import blip_vision
from group_attribution_for_diffusion_models_tpu_torch.utils import jsonl

BLIP_TOL = 2e-3
# The JAX common flag of a slice not ported yet (a torch profiler).
LEFT_OUT = {"profile_dir"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _embeddings(seed, n_ref=60, n_gen=25, d=12):
    """Reference embeddings around 5 centres, generated ones around 3 of them."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((5, d)) * 4
    ref = (centres[rng.integers(0, 5, n_ref)] + rng.standard_normal((n_ref, d))).astype(
        np.float32)
    gen = (centres[rng.integers(0, 3, n_gen)] + rng.standard_normal((n_gen, d))).astype(
        np.float32)
    return ref, gen


@pytest.mark.parametrize("num_clusters", [1, 4, 8])
def test_diversity_matches_jax_bit_for_bit(num_clusters):
    ref, gen = _embeddings(0)
    clusters = diversity.ward_cluster(ref, num_clusters)
    np.testing.assert_array_equal(clusters, jax_diversity.ward_cluster(ref, num_clusters))
    assign = diversity.assign_to_clusters(gen, ref, clusters)
    np.testing.assert_array_equal(assign, jax_diversity.assign_to_clusters(gen, ref, clusters))
    got = diversity.calculate_diversity_score(ref, gen, num_clusters)
    want = jax_diversity.calculate_diversity_score(ref, gen, num_clusters)
    assert got["entropy"] == want["entropy"]
    assert got["cluster_count"] == want["cluster_count"]
    assert got["cluster_proportions"] == want["cluster_proportions"]
    np.testing.assert_array_equal(got["assignments"], want["assignments"])
    assert len(got["cluster_count"]) == num_clusters and sum(got["cluster_count"]) == 25
    labels = np.arange(60) % 3
    assert diversity.embedding_dist_to_mean(ref, labels) == \
        jax_diversity.embedding_dist_to_mean(ref, labels)


def test_cli_on_embeddings_npz_matches_the_jax_cli(tmp_path):
    ref, gen = _embeddings(1)
    npz = str(tmp_path / "emb.npz")
    np.savez(npz, ref_emb=ref, gen_emb=gen)
    argv = ["--dataset", "celeba", "--embeddings_npz", npz, "--num_clusters", "6"]
    jax_cli.main(argv + ["--outdir", str(tmp_path / "jax")])
    row = calculate_global_scores_diversity.main(argv + ["--outdir", str(tmp_path / "port")])
    (want,) = jsonl.read_records(str(tmp_path / "jax" / "celeba_diversity_db.jsonl"))
    (got,) = jsonl.read_records(str(tmp_path / "port" / "celeba_diversity_db.jsonl"))
    for key in ("entropy", "cluster_count", "cluster_proportions", "remaining_idx",
                "removed_idx", "sampling_time", "num_clusters"):
        assert got[key] == want[key], key
    assert row["entropy"] == want["entropy"]
    assert set(got) - {"device"} == set(want) - LEFT_OUT


def test_cli_flags_and_defaults_match_the_jax_cli():
    argv = ["--dataset", "celeba"]
    port = vars(calculate_global_scores_diversity.parse_args(argv))
    assert port.pop("device") == "cuda"
    assert port == {k: v for k, v in vars(jax_cli.parse_args(argv)).items()
                    if k not in LEFT_OUT}
    with pytest.raises(SystemExit, match="need --load"):
        calculate_global_scores_diversity.main(argv + ["--device", "cpu"])


def _jax_tiny_blip():
    """The tiny JAX tower and numpy-drawn params of its tree (eval_shape, no
    compile): kernels N(0, 1/fan_in), biases and embeddings 0.1 N(0, 1), norm
    scales 1 + 0.1 N(0, 1)."""
    model = jax_blip.BlipVisionTower(**blip_vision.TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(2)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return (z / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((1.0 if name == "scale" else 0.0) + np.float32(0.1) * z).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes["params"])


@pytest.mark.parametrize("size", [16, 48])
def test_blip_tower_matches_jax(size):
    model, params = _jax_tiny_blip()
    images = np.random.default_rng(size).uniform(0, 1, (3, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, images))
    port = blip_vision.BlipVisionTower(**blip_vision.TINY)
    port.load_state_dict(blip_vision.params_from_jax(params), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=BLIP_TOL, rtol=0)


def test_blip_weights_load_as_hf_state_dicts_and_jax_trees(tmp_path):
    """The port's state dict carries HF BlipVisionModel names: the JAX
    converter of HF state dicts reads it back to the tower's own outputs."""
    _, params = _jax_tiny_blip()
    port = blip_vision.BlipVisionTower(**blip_vision.TINY).eval()
    port.load_state_dict(blip_vision.params_from_jax(params))
    hf = {f"vision_model.{k}": v for k, v in port.state_dict().items()}
    back = jax_blip.convert_blip_vision_state_dict({k: v.numpy() for k, v in hf.items()})
    images = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    model = jax_blip.BlipVisionTower(**blip_vision.TINY)
    np.testing.assert_allclose(np.asarray(model.apply({"params": back}, images)),
                               np.asarray(model.apply({"params": params}, images)), atol=1e-6)
    torch.save(hf, tmp_path / "blip.pt")
    np.save(tmp_path / "blip.npy", params, allow_pickle=True)
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = port(x)
        for path in ("blip.pt", "blip.npy"):
            loaded = blip_vision.load_blip_vision(str(tmp_path / path), tiny=True, device="cpu")
            assert torch.equal(loaded(x), want), path
    full = blip_vision.BlipVisionTower()
    assert sum(p.numel() for p in full.parameters()) == 86_090_496  # blip-vqa-base's tower


def test_cli_samples_a_latent_checkpoint_and_embeds_it(tmp_path):
    """--load on a latent workload: DDIM samples decoded by the VQ-VAE, then
    the tiny BLIP tower, or the InceptionV3 pool3 fallback."""
    member = train_ensemble.main([
        "--dataset", "synthetic_64x16_ldm", "--num_seeds", "1", "--removal_dist", "shapley",
        "--training_steps", "1", "--outdir", str(tmp_path), "--device", "cpu"])["model_dirs"][0]
    common = ["--dataset", "synthetic_64x16_ldm", "--load", member, "--n_samples", "6",
              "--batch_size", "4", "--num_inference_steps", "2", "--outdir", str(tmp_path),
              "--device", "cpu"]
    row = calculate_global_scores_diversity.main(common + ["--blip_tiny", "--num_clusters", "3"])
    assert len(row["cluster_count"]) == 3 and sum(row["cluster_count"]) == 6
    assert np.isfinite(row["entropy"]) and row["remaining_idx"]
    assert row["seconds"]["sampling"] > 0 and row["seconds"]["tower"] > 0
    row = calculate_global_scores_diversity.main(
        common[:5] + ["2"] + common[6:] + ["--num_clusters", "2"])
    assert sum(row["cluster_count"]) == 2 and np.isfinite(row["entropy"])
