"""The port's ``sketch_quality`` CLI against the JAX CLI, on the CPU.

- On the same saved features (each variant's train and generated rows,
  handed to both CLIs in place of their feature extractors, whose parity is
  tests/test_torch_trak.py's), the report's variants, Spearman values, group
  attributions and LDS equal the JAX CLI's; the report has the JAX CLI's
  keys. Tolerance: 1e-12 relative (the same float64 numpy and scipy on the
  same inputs; the LDS passes through a float32 store in neither).
- End to end on a tiny attention U-Net: every variant runs, self-correlations
  are 1, timings are recorded.
- On a latent workload the port exits: the JAX CLI would feed the U-Net
  pixels in place of latents (ROADMAP C4).
"""

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import sketch_quality as jax_sketch
from group_attribution_for_diffusion_models_tpu.models import lora as jax_lora
from group_attribution_for_diffusion_models_tpu_torch.cli import sketch_quality
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import append_record

DATASET = "synthetic_64x8_big"
RTOL = 1e-12
N_GEN, BATCH, PROJ = 6, 16, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sketch") / "m")
    spec = config_for(DATASET).unet
    save_checkpoint(path, 3, build_unet(spec, 0).state_dict(), build_unet(spec, 1).state_dict(),
                    unet_spec=spec)
    return path


def _test_db(path, labels):
    rng = np.random.default_rng(3)
    for seed in range(6):
        kept = np.flatnonzero(np.isin(labels, rng.choice(10, 5, replace=False)))
        append_record(path, {"dataset": DATASET, "removal_dist": "datamodel",
                             "removal_seed": seed, "remaining_idx": kept.tolist(),
                             "eval_loss": float(rng.uniform(0.5, 1.0))})


def _stub_features(variant_of, n_train):
    """A make_grad_feature_fn stand-in for either CLI: each variant's
    extractor returns, call by call, a warm batch and then that variant's
    saved train and generated rows, batch by batch."""
    rng = np.random.default_rng(9)
    saved = {}

    def make(*args, **kwargs):
        name = variant_of(kwargs)
        rows = saved.setdefault(name, (rng.standard_normal((n_train, PROJ)),
                                       rng.standard_normal((N_GEN, PROJ))))
        batches = [rows[0][:BATCH]]
        batches += [rows[0][i:i + BATCH] for i in range(0, n_train, BATCH)]
        batches += [rows[1][i:i + BATCH] for i in range(0, N_GEN, BATCH)]
        calls = iter(batches)

        def features(*a, **k):  # the port's takes a tensor, the JAX CLI's (params, batch, key)
            rows = next(calls).astype(np.float32)
            return torch.from_numpy(rows) if isinstance(a[0], torch.Tensor) else rows
        return features

    return make


def _variant_of(kwargs):
    if kwargs.get("sketch_probe") is not None:
        return f"probe_k{kwargs['sketch_probe']['k']}"
    return "attn_full" if kwargs.get("params_filter") is not None else "full"


def _stub_the_jax_cli(monkeypatch, n_train):
    """The JAX CLI without its model: features, sampling, checkpoint and the
    attention discovery stubbed (no U-Net is built or compiled)."""
    class _Model:
        apply = None

        def __init__(self, spec):
            pass

        def init(self, *a, **k):
            return {"params": {}}

    monkeypatch.setattr(jax_sketch, "UNet2D", _Model)
    monkeypatch.setattr(jax_sketch, "load_checkpoint", lambda path, template: (
        SimpleNamespace(params={}, ema_params={}), {}))
    monkeypatch.setattr(jax_sketch, "sample_loop",
                        lambda apply, params, sched, spec, shape, key, **k: jnp.zeros(shape))
    monkeypatch.setattr(jax_lora, "attention_params_filter", lambda params: "attn")
    monkeypatch.setattr(jax_lora, "probe_sketch_init", lambda params, k, key: {"k": k})
    monkeypatch.setattr(jax_sketch, "make_grad_feature_fn", _stub_features(_variant_of, n_train))


def test_report_matches_the_jax_cli_on_the_same_features(model_dir, tmp_path, monkeypatch):
    labels = create_dataset(DATASET).labels
    db = str(tmp_path / "test_db.jsonl")
    _test_db(db, labels)
    argv = ["--dataset", DATASET, "--load", model_dir, "--outdir", str(tmp_path),
            "--sketch_ks", "4", "16", "--proj_dim", str(PROJ), "--num_timesteps", "1",
            "--n_gen", str(N_GEN), "--batch_size", str(BATCH), "--num_inference_steps", "1",
            "--test_db", db]

    _stub_the_jax_cli(monkeypatch, 64)
    jax_sketch.main(argv + ["--save_path", str(tmp_path / "jax.json")])

    monkeypatch.setattr(sketch_quality, "probe_sketch_init",
                        lambda model, k, generator: {"k": k})
    monkeypatch.setattr(sketch_quality, "make_grad_feature_fn", _stub_features(_variant_of, 64))
    got = sketch_quality.main(argv + ["--save_path", str(tmp_path / "port.json"),
                                      "--device", "cpu"])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert list(got) == list(want)
    assert list(got["variants"]) == list(want["variants"]) == [
        "full", "attn_full", "probe_k4", "probe_k16"]
    for key in ("dataset", "proj_dim", "num_timesteps", "n_train", "n_gen", "sketch_ks"):
        assert got[key] == want[key]
    assert set(got["timings"]) == set(want["timings"])
    for name, row in want["variants"].items():
        assert list(got["variants"][name]) == list(row)
        for key, value in row.items():
            np.testing.assert_allclose(got["variants"][name][key], value, rtol=RTOL, atol=0)
        assert np.isfinite(row["lds"]) and len(row["group_attributions"]) == 10


def test_lds_masks_come_from_the_whole_dataset(model_dir, tmp_path, monkeypatch):
    """With --max_examples below the dataset's size, the test rows'
    remaining_idx still index the whole dataset: the port builds the masks
    from its labels, where the JAX CLI indexes the kept examples' labels and
    fails (ROADMAP C4)."""
    from group_attribution_for_diffusion_models_tpu.attributions import collect_data
    from scipy.stats import spearmanr

    labels = create_dataset(DATASET).labels
    db = str(tmp_path / "test_db.jsonl")
    _test_db(db, labels)
    argv = ["--dataset", DATASET, "--load", model_dir, "--outdir", str(tmp_path),
            "--sketch_ks", "4", "--proj_dim", str(PROJ), "--num_timesteps", "1",
            "--n_gen", str(N_GEN), "--batch_size", str(BATCH), "--num_inference_steps", "1",
            "--max_examples", "32", "--test_db", db, "--save_path", str(tmp_path / "p.json")]
    monkeypatch.setattr(sketch_quality, "probe_sketch_init",
                        lambda model, k, generator: {"k": k})
    monkeypatch.setattr(sketch_quality, "make_grad_feature_fn", _stub_features(_variant_of, 32))
    got = sketch_quality.main(argv + ["--device", "cpu"])
    masks, behaviors, _ = collect_data(db, {"dataset": DATASET, "removal_dist": "datamodel"},
                                       num_units=10, behavior_key="eval_loss", by_class=True,
                                       labels=labels)
    assert masks.shape == (6, 10)
    for row in got["variants"].values():
        grp = np.asarray(row["group_attributions"])
        want = spearmanr(masks @ -grp, behaviors).statistic * 100
        np.testing.assert_allclose(row["lds"], want, rtol=RTOL)
    _stub_the_jax_cli(monkeypatch, 32)
    with pytest.raises(IndexError):
        jax_sketch.main(argv)


def test_sketch_quality_end_to_end_and_its_latent_exit(model_dir, tmp_path):
    save = str(tmp_path / "sq.json")
    report = sketch_quality.main([
        "--dataset", DATASET, "--load", model_dir, "--outdir", str(tmp_path),
        "--sketch_ks", "4", "--proj_dim", "32", "--num_timesteps", "2", "--n_gen", "4",
        "--batch_size", "8", "--num_inference_steps", "2", "--max_examples", "16",
        "--save_path", save, "--device", "cpu"])
    v = report["variants"]
    assert set(v) == {"full", "attn_full", "probe_k4"} and report["n_train"] == 16
    assert v["full"]["spearman_example_vs_full"] > 0.999
    assert v["attn_full"]["spearman_example_vs_attn_full"] > 0.999
    assert all(np.isfinite(r["spearman_example_vs_attn_full"]) for r in v.values())
    assert set(report["timings"]) == set(v)
    assert all(t["train_extract_s"] >= 0 for t in report["timings"].values())
    assert os.path.exists(save)
    with pytest.raises(SystemExit, match="latent workload"):
        sketch_quality.main(["--dataset", "synthetic_32x16_ldm", "--load", model_dir,
                             "--save_path", save, "--device", "cpu"])
