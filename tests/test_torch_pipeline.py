"""The port's shapley_pipeline against the JAX package's, on the CPU.

One JAX pipeline run (the config of the JAX package's own pipeline test:
synthetic_64x8_mix --by_class, 6 fit and 4 test subsets, 3 steps at batch
8) is shared by the module. The port's run of the same config must write
rows of the same (removal_dist, seed, method, training_steps) with the same
remaining_idx, bit for bit, and a summary with the same keys; the port's fit
stage on the JAX-written DB must reproduce the JAX pipeline's attributions
and LDS exactly (numpy on the same rows). A sparse fine-tuning run (port
`prune`, then `--method prune_fine_tune --load`) keeps its own anchors and
reuses the retrained test rows.

Fit-stage parity over every `--fit_dist` runs both pipelines on a stand-in
trainer that writes the rows `train_ensemble` would (the package's own
argument parser, the removal sampler, an additive game as the behavior).

Two tests show where the port follows the intended behavior and the JAX
package does not: a run without --training_steps keeps its test rows (the
JAX CLI trains them without a budget, records None and filters them all
out), and 31 test rows land in 3 groups with none dropped (the JAX CLI cuts
len // 3 = 10 rows a group and drops the 31st).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import shapley_pipeline as jax_pipeline
from group_attribution_for_diffusion_models_tpu.cli import train_ensemble as jax_train_ensemble
from group_attribution_for_diffusion_models_tpu_torch.attributions import evaluate_lds
from group_attribution_for_diffusion_models_tpu_torch.cli import lds as lds_cli
from group_attribution_for_diffusion_models_tpu_torch.cli import prune as prune_cli
from group_attribution_for_diffusion_models_tpu_torch.cli import shapley_pipeline, train_ensemble
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset, sample_removal
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import load_meta, load_unet_spec
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import (
    append_record,
    filter_records,
    read_records,
)

DATASET = "synthetic_64x8_mix"
CONFIG = ["--dataset", DATASET, "--by_class", "--num_fit_subsets", "6",
          "--num_test_subsets", "4", "--training_steps", "3", "--batch_size", "8",
          "--behavior", "eval_loss", "--chunk_size", "6"]
SUMMARY_TIMES = ("train_time_s", "total_time_s", "subset_passes_per_hour")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its U-Nets are tiny, and the
    test workers share the CPU, where torch's default of a thread per core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _db(outdir):
    return os.path.join(outdir, f"{DATASET}_pipeline_db.jsonl")


def _run(pipeline_main, outdir, extra=()):
    out = pipeline_main(CONFIG + ["--outdir", outdir, *extra])
    rows = list(read_records(_db(outdir)))
    return {"out": out, "outdir": outdir, "db": _db(outdir), "rows": rows[:-1],
            "summary": rows[-1],
            "attrs": np.load(os.path.join(outdir, "shapley_pipeline_attrs.npy"))}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _run(jax_pipeline.main, str(tmp_path_factory.mktemp("jax")))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return _run(shapley_pipeline.main, str(tmp_path_factory.mktemp("port")),
                ["--device", "cpu"])


def _key(r):
    return (r["removal_dist"], r["removal_seed"], r["method"], r["training_steps"])


def test_port_rows_and_summary_match_the_jax_pipeline(jax_run, port_run):
    jax_rows = {_key(r): r for r in jax_run["rows"]}
    port_rows = {_key(r): r for r in port_run["rows"]}
    assert len(port_rows) == len(port_run["rows"]) == 12  # 6 fit, 4 test, 2 anchors
    assert set(port_rows) == set(jax_rows)
    for k, r in port_rows.items():
        assert r["remaining_idx"] == jax_rows[k]["remaining_idx"], k
        assert r["removed_idx"] == jax_rows[k]["removed_idx"], k
        assert np.isfinite(r["eval_loss"])
    assert set(port_run["summary"]) == set(jax_run["summary"])
    s = port_run["summary"]
    assert (s["num_fit_subsets"], s["num_test_subsets"], s["test_groups"]) == (6, 4, 1)
    attrs = port_run["attrs"]
    assert attrs.shape == (10,) and np.isfinite(attrs).all()
    np.testing.assert_array_equal(attrs, port_run["out"]["attrs"])
    assert abs(attrs.sum() - (s["v1"] - s["v0"])) <= 1e-6 * max(1.0, abs(s["v1"] - s["v0"]))


def test_fit_stage_on_the_jax_db_reproduces_the_jax_pipeline(jax_run):
    n_units, labels = shapley_pipeline.attribution_units(DATASET, by_class=True)
    assert n_units == 10
    out = shapley_pipeline.fit_stage(jax_run["db"], DATASET, "eval_loss", "shapley", "retrain",
                                     (0, 6), (42, 46), 3, 3, n_units, labels)
    np.testing.assert_array_equal(out["attrs"], jax_run["attrs"])
    s = jax_run["summary"]
    for k in ("lds_mean", "lds_ci", "lds_pooled", "v1", "v0", "test_groups"):
        assert out[k] == s[k], k
    assert (len(out["x_fit"]), len(out["x_test"])) == (6, 4)


def test_sparse_fine_tuning_keeps_its_anchors_and_reuses_the_test_rows(port_run, tmp_path):
    outdir = str(tmp_path / "sparse")
    shutil.copytree(port_run["outdir"], outdir)
    full = os.path.join(outdir, DATASET, "retrain", "models", "full")
    pruned = prune_cli.main(["--dataset", DATASET, "--load", full, "--pruner", "magnitude",
                             "--pruning_ratio", "0.5", "--outdir", outdir, "--device", "cpu"])
    assert pruned["spec"].pruned_channels
    out = shapley_pipeline.main(CONFIG + ["--outdir", outdir, "--method", "prune_fine_tune",
                                          "--load", pruned["model_dir"],
                                          "--fit_training_steps", "2", "--device", "cpu"])
    rows = list(read_records(_db(outdir)))
    summary = rows[-1]
    assert summary["method"] == "prune_fine_tune" and summary["fit_training_steps"] == 2
    fit = [r for r in rows if r.get("removal_dist") == "shapley"
           and r.get("method") == "prune_fine_tune"]
    assert len(fit) == 6 and all(r["training_steps"] == 2 for r in fit)
    # The retrained test rows were reused, not trained again.
    test = [r for r in rows if r.get("removal_dist") == "datamodel"]
    assert len(test) == 4 and all(r["method"] == "retrain" and r["training_steps"] == 3
                                  for r in test)
    np.testing.assert_array_equal(out["y_test"], port_run["out"]["y_test"])
    # The fit game's anchors: the pruned base untouched (v0) and fine-tuned (v1).
    anchors = {r["training_steps"]: r["eval_loss"] for r in rows
               if r.get("removal_dist") == "full" and r.get("method") == "prune_fine_tune"}
    assert set(anchors) == {0, 2}
    assert (out["v0"], out["v1"]) == (anchors[0], anchors[2])
    assert out["v0"] != port_run["out"]["v0"]
    anchor_dir = os.path.join(outdir, DATASET, "prune_fine_tune", "models", "full")
    assert load_unet_spec(load_meta(anchor_dir)) == pruned["spec"]
    assert abs(out["attrs"].sum() - (out["v1"] - out["v0"])) <= 1e-6 * max(
        1.0, abs(out["v1"] - out["v0"]))


def _stand_in_trainer(parse_args, calls):
    """A `train_ensemble.main` that trains nothing and appends the rows the
    real one would (vars(args), the removal subset, a behavior): eval_loss
    of an additive game over the kept classes; the untrained null model
    (--training_steps 0) reads 1.2. It returns the port's summary seconds,
    all 0."""
    w = np.linspace(-1.0, 1.0, 10)

    def main(argv):
        calls.append(list(argv))
        args = parse_args(argv)
        labels = create_dataset(args.dataset).labels
        for seed in range(args.seed_start, args.seed_start + args.num_seeds):
            remaining, removed = sample_removal(
                args.removal_dist, labels if args.by_class else len(labels), seed=seed,
                alpha=args.datamodel_alpha, by_class=args.by_class)
            classes = np.zeros(10)
            classes[np.unique(labels[remaining])] = 1.0
            value = (1.2 if args.training_steps == 0
                     else 1.0 - 0.05 * classes @ w + 0.01 * np.sin(seed))
            append_record(args.db, {**vars(args), "removal_seed": seed,
                                    "remaining_idx": remaining, "removed_idx": removed,
                                    "eval_loss": float(value)})
        return {f"{k}_seconds": 0.0 for k in ("train", "sample", "tower", "fid", "encode")}

    return main


def _stand_in_runs(monkeypatch, tmp_path, argv):
    """Both pipelines with stand-in trainers: (JAX run or the SystemExit it
    raised, port run, the argv each passed its trainer)."""
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_train_ensemble, "main",
                        _stand_in_trainer(jax_train_ensemble.parse_args, calls["jax"]))
    monkeypatch.setattr(train_ensemble, "main",
                        _stand_in_trainer(train_ensemble.parse_args, calls["port"]))
    runs = {}
    for name, main, extra in (("jax", jax_pipeline.main, []),
                              ("port", shapley_pipeline.main, ["--device", "cpu"])):
        outdir = str(tmp_path / name)
        try:
            main(argv + ["--outdir", outdir] + extra)
        except SystemExit as e:
            runs[name] = e
            continue
        rows = list(read_records(_db(outdir)))
        runs[name] = {"summary": rows[-1], "db": _db(outdir),
                      "attrs": np.load(os.path.join(outdir, "shapley_pipeline_attrs.npy"))}
    return runs["jax"], runs["port"], calls


@pytest.mark.parametrize("fit_dist,seed", [("shapley", 0), ("shapley_paired", 2),
                                           ("datamodel", 100), ("uniform", 0),
                                           ("uniform_paired", 4)])
def test_every_fit_dist_fits_as_the_jax_pipeline(monkeypatch, tmp_path, fit_dist, seed):
    argv = ["--dataset", DATASET, "--by_class", "--fit_dist", fit_dist, "--removal_seed",
            str(seed), "--num_fit_subsets", "16", "--num_test_subsets", "12",
            "--training_steps", "3", "--chunk_size", "5", "--no-save_ckpts"]
    jax_out, port_out, calls = _stand_in_runs(monkeypatch, tmp_path, argv)
    np.testing.assert_array_equal(port_out["attrs"], jax_out["attrs"])
    times = set(SUMMARY_TIMES)
    assert ({k: v for k, v in port_out["summary"].items() if k not in times}
            == {k: v for k, v in jax_out["summary"].items() if k not in times})
    # 4 fit chunks, 3 test chunks, 2 anchors in each package.
    assert len(calls["port"]) == len(calls["jax"]) == 9
    assert all(a[a.index("--device") + 1] == "cpu" for a in calls["port"])


def test_a_run_without_training_steps_keeps_its_test_rows(monkeypatch, tmp_path):
    """Intended behavior: test rows train with the retrain budget passed
    explicitly. The JAX CLI trains them without --training_steps, so its
    rows record training_steps None and its fit stage drops all of them."""
    out = shapley_pipeline.main([
        "--dataset", DATASET, "--by_class", "--num_fit_subsets", "4", "--num_test_subsets",
        "3", "--batch_size", "8", "--chunk_size", "4", "--no-save_ckpts",
        "--outdir", str(tmp_path / "real"), "--device", "cpu"])
    assert out["row"]["num_test_subsets"] == 3 and len(out["y_test"]) == 3
    budget = 10  # the synthetic configs' retrain budget
    test_rows = filter_records(out["db"], {"removal_dist": "datamodel"})
    assert len(test_rows) == 3 and all(r["training_steps"] == budget for r in test_rows)

    argv = ["--dataset", DATASET, "--by_class", "--num_fit_subsets", "4",
            "--num_test_subsets", "3", "--chunk_size", "4"]
    jax_out, port_out, calls = _stand_in_runs(monkeypatch, tmp_path / "stand_in", argv)
    assert isinstance(jax_out, SystemExit)
    assert "not enough scored rows (fit 4, test 0)" in str(jax_out)
    jax_test_call = next(a for a in calls["jax"] if "datamodel" in a)
    assert "--training_steps" not in jax_test_call
    port_test_call = next(a for a in calls["port"] if "datamodel" in a)
    assert port_test_call[port_test_call.index("--training_steps") + 1] == str(budget)
    assert port_out["summary"]["num_test_subsets"] == 3


def test_31_test_rows_land_in_3_groups_with_none_dropped(monkeypatch, tmp_path):
    """Intended behavior: np.array_split keeps every test row (11, 10, 10).
    The JAX CLI's len // 3 groups hold 10 rows each and drop the 31st."""
    x = np.arange(31 * 2, dtype=np.float64).reshape(31, 2)
    groups = shapley_pipeline.lds_groups(x, x[:, 0])
    assert [len(g[0]) for g in groups] == [11, 10, 10]
    np.testing.assert_array_equal(np.concatenate([g[0] for g in groups]), x)
    assert len(shapley_pipeline.lds_groups(x[:29], x[:29, 0])) == 1

    argv = ["--dataset", DATASET, "--by_class", "--num_fit_subsets", "8",
            "--num_test_subsets", "31", "--training_steps", "3", "--chunk_size", "16"]
    jax_out, port_out, _ = _stand_in_runs(monkeypatch, tmp_path, argv)
    np.testing.assert_array_equal(port_out["attrs"], jax_out["attrs"])
    n_units, labels = shapley_pipeline.attribution_units(DATASET, by_class=True)
    x_test, y_test = shapley_pipeline.rows_to_xy(port_out["db"], DATASET, "datamodel", 42, 73,
                                                 "retrain", 3, "eval_loss", n_units, labels)
    attrs = port_out["attrs"]
    assert len(x_test) == 31
    assert port_out["summary"]["num_test_subsets"] == jax_out["summary"]["num_test_subsets"]
    jax_groups = [(x_test[i * 10:(i + 1) * 10], y_test[i * 10:(i + 1) * 10]) for i in range(3)]
    assert jax_out["summary"]["lds_mean"] == evaluate_lds(attrs, jax_groups)[0]
    port_groups = [(x_test[i], y_test[i]) for i in np.array_split(np.arange(31), 3)]
    assert port_out["summary"]["lds_mean"] == evaluate_lds(attrs, port_groups)[0]
    assert port_out["summary"]["test_groups"] == 3


# The JAX common flag of a slice not ported yet (a torch profiler).
LEFT_OUT = {"profile_dir"}
# Defaults the port sets apart: a train_ensemble call stacks all its members
# on one card at once, so the pipeline's calls hold what one 80 GB H100 fits
# (train_ensemble.MEMBERS_PER_CALL) where the JAX CLI's hold 32.
PORT_DEFAULTS = {"shapley_pipeline": {"chunk_size": train_ensemble.MEMBERS_PER_CALL}}


@pytest.mark.parametrize("name,argv", [
    ("shapley_pipeline", ["--dataset", DATASET]),
    ("prune", ["--dataset", DATASET, "--load", "m"]),
    ("lds", ["--dataset", DATASET, "--train_db", "a", "--test_db", "b"]),
])
def test_cli_flags_and_defaults_match_the_jax_cli(name, argv):
    import importlib

    port = importlib.import_module(
        f"group_attribution_for_diffusion_models_tpu_torch.cli.{name}").parse_args(argv)
    jax = importlib.import_module(
        f"group_attribution_for_diffusion_models_tpu.cli.{name}").parse_args(argv)
    want = {k: v for k, v in vars(jax).items() if k not in LEFT_OUT}
    want.update(PORT_DEFAULTS.get(name, {}))
    assert {k: v for k, v in vars(port).items() if k != "device"} == want


def test_entry_points_default_to_cuda_and_name_what_is_not_ported(tmp_path):
    for mod, argv in ((shapley_pipeline, ["--dataset", DATASET]),
                      (prune_cli, ["--dataset", DATASET, "--load", str(tmp_path)]),
                      (lds_cli, ["--dataset", DATASET, "--train_db", "a", "--test_db", "b"])):
        assert mod.parse_args(argv).device == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                mod.main(argv)
    # The sample behaviors run (tests/test_torch_scoring_cli.py), and so does a
    # latent (VQ-VAE) workload: its calls share one encode of the dataset.
    for behavior in ("fid_value", "is"):
        assert shapley_pipeline.parse_args(
            ["--dataset", DATASET, "--behavior", behavior]).behavior == behavior
    ldm = shapley_pipeline.main([
        "--dataset", "synthetic_64x8_ldm", "--num_fit_subsets", "3", "--num_test_subsets", "2",
        "--training_steps", "1", "--batch_size", "4", "--chunk_size", "3", "--device", "cpu",
        "--outdir", str(tmp_path)])
    assert (tmp_path / "synthetic_64x8_ldm" / "precomputed_emb" / "vqvae_latents.npy").exists()
    assert ldm["attrs"].shape == (64,) and np.isfinite(ldm["attrs"]).all()
    assert abs(ldm["attrs"].sum() - (ldm["v1"] - ldm["v0"])) <= 1e-6 * max(
        1.0, abs(ldm["v1"] - ldm["v0"]))
    with pytest.raises(SystemExit, match="overlap"):
        shapley_pipeline.main(["--dataset", DATASET, "--fit_dist", "datamodel",
                               "--removal_seed", "40", "--num_fit_subsets", "8",
                               "--outdir", str(tmp_path), "--device", "cpu"])
