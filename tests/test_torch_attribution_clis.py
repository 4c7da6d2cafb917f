"""The port's attribute, empirical_verification and shapley_groundtruth
against the JAX CLIs, on the CPU, on JAX-written DBs.

The DBs are written by the JAX package (`append_record`) from a stand-in
trainer: the rows `train_ensemble` would write (its own argument parser, the
removal sampler, the enumerated masks), with the eval loss of a seeded game
over the kept classes in place of training. Every reader is host numpy, so
the port's outputs equal the JAX CLIs' to 1e-10 (in practice bit for bit).
A tiny end-to-end `shapley_groundtruth` of the port (2 classes, 2 steps of
the real trainer) closes the file.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import attribute as jax_attribute
from group_attribution_for_diffusion_models_tpu.cli import (
    empirical_verification as jax_empirical,
)
from group_attribution_for_diffusion_models_tpu.cli import (
    shapley_groundtruth as jax_groundtruth,
)
from group_attribution_for_diffusion_models_tpu.cli import train_ensemble as jax_train_ensemble
from group_attribution_for_diffusion_models_tpu.data import create_dataset as jax_create_dataset
from group_attribution_for_diffusion_models_tpu.data import sample_removal as jax_sample_removal
from group_attribution_for_diffusion_models_tpu.utils import append_record as jax_append_record
from group_attribution_for_diffusion_models_tpu.utils import read_records as jax_read_records
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    attribute,
    empirical_verification,
    shapley_groundtruth,
    train_ensemble,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import read_records

DATASET = "synthetic_64x8_mix"  # 10 classes
GT_DATASET = "synthetic_64x8_c4_mix"  # 4 classes: 15 enumerated subsets
ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value(classes, seed, method):
    """The game: additive over the kept classes, plus a seeded perturbation
    that differs by method (so two methods' behaviors correlate, unequal)."""
    w = np.linspace(-1.0, 1.0, len(classes))
    shift = 0.02 if method == "prune_fine_tune" else 0.0
    return float(1.0 - 0.05 * classes @ w + 0.01 * np.sin(3 * seed + shift) + shift)


def _write_rows(db, dataset, method, removal_dist, seeds, by_class=True, **extra):
    """Rows as the JAX train_ensemble writes them, through the JAX
    append_record, with eval_loss and fid_value from `_value`."""
    labels = jax_create_dataset(dataset).labels
    n_cls = int(labels.max()) + 1
    argv = ["--dataset", dataset, "--method", method, "--removal_dist", removal_dist,
            "--db", db] + (["--by_class"] if by_class else [])
    args = jax_train_ensemble.parse_args(argv)
    for seed in seeds:
        remaining, removed = jax_sample_removal(
            removal_dist, labels if by_class else len(labels), seed=seed, by_class=by_class)
        classes = np.zeros(n_cls)
        classes[np.unique(labels[remaining])] = 1.0
        value = _value(classes, seed, method)
        jax_append_record(db, {**vars(args), "removal_seed": seed, "remaining_idx": remaining,
                               "removed_idx": removed, "eval_loss": value,
                               "fid_value": 10 * value, **extra})


@pytest.fixture(scope="module")
def jax_db(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("db") / "behaviors.jsonl")
    for method in ("retrain", "prune_fine_tune"):
        _write_rows(db, DATASET, method, "shapley", range(16))
        _write_rows(db, DATASET, method, "shapley_paired", range(6))
    _write_rows(db, DATASET, "retrain", "datamodel", range(42, 54))
    _write_rows(db, DATASET, "retrain", "uniform", range(14))
    _write_rows(db, DATASET, "retrain", "uniform_paired", range(4))
    return db


def _attrs(main, argv, path):
    main(argv + ["--save_path", path])
    return np.load(path), np.load(path.replace(".npy", "_ranking.npy"))


@pytest.mark.parametrize("method,key", [
    ("shapley", "eval_loss"), ("shapley", "fid_value"), ("datamodel", "eval_loss"),
    ("banzhaf", "eval_loss")])
def test_attribute_fits_the_jax_attributions_from_a_jax_db(jax_db, tmp_path, method, key):
    argv = ["--dataset", DATASET, "--by_class", "--train_db", jax_db,
            "--attribution_method", method, "--model_behavior_key", key, "--num_runs", "2"]
    want, want_rank = _attrs(jax_attribute.main, argv, str(tmp_path / "jax.npy"))
    got, got_rank = _attrs(attribute.main, argv, str(tmp_path / "port.npy"))
    assert got.shape == (10,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_rank, want_rank)


def test_attribute_with_anchors_and_num_units(jax_db, tmp_path):
    argv = ["--dataset", DATASET, "--by_class", "--train_db", jax_db, "--v1", "1.1",
            "--v0", "0.9", "--method", "prune_fine_tune", "--model_behavior_key", "eval_loss"]
    want, _ = _attrs(jax_attribute.main, argv, str(tmp_path / "jax.npy"))
    got, _ = _attrs(attribute.main, argv, str(tmp_path / "port.npy"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert abs(got.sum() - 0.2) <= 1e-6


@pytest.mark.parametrize("method", ["d_trak", "trak", "relative_if", "renormalized_if",
                                    "grad_sim"])
@pytest.mark.parametrize("groups", [True, False])
def test_attribute_scores_a_feature_store_as_jax_does(tmp_path, method, groups):
    rng = np.random.default_rng(3)
    store = {"train_features": rng.standard_normal((12, 6)).astype(np.float32),
             "gen_features": rng.standard_normal((5, 6)).astype(np.float32)}
    if groups:
        store["group_labels"] = np.repeat(np.arange(4), 3)
    path = str(tmp_path / "f.npz")
    np.savez(path, **store)
    argv = ["--dataset", DATASET, "--train_db", path, "--attribution_method", method,
            "--agg_mode", "mean"]
    want, want_rank = _attrs(jax_attribute.main, argv, str(tmp_path / "jax.npy"))
    got, got_rank = _attrs(attribute.main, argv, str(tmp_path / "port.npy"))
    assert got.shape == ((4,) if groups else (12,))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_rank, want_rank)


@pytest.mark.parametrize("method", ["clip_score", "pixel_dist"])
def test_attribute_reads_saved_similarity_scores(tmp_path, method):
    """The JAX CLI offers clip_score and pixel_dist and has no branch for them
    (a KeyError); the port reads the attribution vector similarity_baselines
    saved (ROADMAP C4)."""
    saved = np.array([0.3, -1.0, 2.5, 0.0])
    path = str(tmp_path / "sim.npy")
    np.save(path, saved)
    argv = ["--dataset", DATASET, "--train_db", path, "--attribution_method", method]
    with pytest.raises(KeyError, match=method):
        jax_attribute.main(argv + ["--save_path", str(tmp_path / "jax.npy")])
    got, rank = _attrs(attribute.main, argv, str(tmp_path / "port.npy"))
    np.testing.assert_array_equal(got, saved)
    np.testing.assert_array_equal(rank, [2, 0, 3, 1])


def test_attribute_without_rows_exits(jax_db, tmp_path):
    argv = ["--dataset", DATASET, "--by_class", "--train_db", jax_db, "--method", "gd",
            "--save_path", str(tmp_path / "a.npy")]
    with pytest.raises(SystemExit, match="no rows matched"):
        attribute.main(argv)


@pytest.mark.parametrize("extra", [[], ["--attributions", "--dataset", DATASET, "--by_class"],
                                   ["--removal_dist", "shapley_paired"]])
def test_empirical_verification_prints_the_jax_numbers(jax_db, capsys, extra):
    argv = ["--db", jax_db, "--model_behavior_key", "eval_loss", *extra]
    jax_empirical.main(argv)
    want = capsys.readouterr().out
    out = empirical_verification.main(argv)
    assert capsys.readouterr().out == want
    n = 6 if "shapley_paired" in extra else 16
    assert out["seeds"] == list(range(n)) and np.isfinite(out["pearson"])
    assert ("attr_pearson" in out) == ("--attributions" in extra)


def test_empirical_verification_needs_three_shared_seeds(tmp_path):
    db = str(tmp_path / "db.jsonl")
    _write_rows(db, DATASET, "retrain", "shapley", range(4))
    _write_rows(db, DATASET, "prune_fine_tune", "shapley", range(2))
    with pytest.raises(SystemExit, match="found 2"):
        empirical_verification.main(["--db", db, "--model_behavior_key", "eval_loss"])


def _enum_stand_in(parse_args, calls):
    """A train_ensemble.main that trains nothing and appends, through the JAX
    append_record, the rows the real one would for the enumerated masks (and
    the null model): eval_loss of a seeded game over the kept classes."""
    def main(argv):
        calls.append(list(argv))
        args = parse_args(argv)
        labels = jax_create_dataset(args.dataset).labels
        rng = np.random.default_rng(0)
        pair = rng.standard_normal((4, 4)) * 0.01
        for seed in range(args.seed_start, args.seed_start + args.num_seeds):
            if args.removal_dist == "enum":
                keep = np.load(args.removal_masks)[seed].astype(bool)[labels]
            else:
                keep = np.ones(len(labels), bool)
            classes = np.zeros(4)
            classes[np.unique(labels[keep])] = 1.0
            value = (1.2 if args.training_steps == 0
                     else _value(classes, 0, "retrain") + classes @ pair @ classes)
            jax_append_record(args.db, {**vars(args), "removal_seed": seed,
                                        "remaining_idx": np.flatnonzero(keep),
                                        "removed_idx": np.flatnonzero(~keep),
                                        "eval_loss": float(value)})
    return main


def test_shapley_groundtruth_on_a_jax_written_db(monkeypatch, tmp_path, capsys):
    """The JAX CLI enumerates with a stand-in trainer into its DB; the port's
    CLI, on a copy of that outdir, finds every row (its real train_ensemble
    skips each recorded seed) and computes the same exact values, anchors and
    convergence curve."""
    calls = []
    monkeypatch.setattr(jax_train_ensemble, "main",
                        _enum_stand_in(jax_train_ensemble.parse_args, calls))
    argv = ["--dataset", GT_DATASET, "--training_steps", "3", "--chunk_size", "6",
            "--fit_counts", "4,10", "--num_estimate_seeds", "2", "--eval_t_max", "600"]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_groundtruth.main(argv + ["--outdir", jax_dir])
    assert len(calls) == 4  # 15 masks in chunks of 6, and the null model
    shutil.copytree(jax_dir, port_dir)
    os.remove(os.path.join(port_dir, "shapley_groundtruth_exact.npy"))
    capsys.readouterr()
    out = shapley_groundtruth.main(argv + ["--outdir", port_dir, "--device", "cpu"])
    assert "nothing to do" in capsys.readouterr().out
    want = np.load(os.path.join(jax_dir, "shapley_groundtruth_exact.npy"))
    np.testing.assert_allclose(out["exact"], want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        np.load(os.path.join(port_dir, "shapley_groundtruth_exact.npy")), out["exact"])
    jax_summary = list(jax_read_records(os.path.join(jax_dir,
                                                     f"{GT_DATASET}_groundtruth_db.jsonl")))[-1]
    s = out["summary"]
    for k in ("n_classes", "num_enumerated", "v1", "v0", "exact_std", "exact_rel_spread"):
        np.testing.assert_allclose(s[k], jax_summary[k], atol=ATOL, rtol=0)
    assert [(c["dist"], c["fit_subsets"]) for c in s["convergence"]] == [
        (c["dist"], c["fit_subsets"]) for c in jax_summary["convergence"]]
    for c, w in zip(s["convergence"], jax_summary["convergence"]):
        for k in ("pearson", "spearman", "mse"):
            np.testing.assert_allclose(c[k], w[k], atol=ATOL, rtol=0)
    assert set(s) == set(jax_summary)
    assert abs(out["exact"].sum() - (s["v1"] - s["v0"])) <= 1e-12


def test_shapley_groundtruth_fails_loudly_on_stale_rows(monkeypatch, tmp_path):
    """Rows of another budget do not fill the game: where the trainer skips
    (as it does for members checkpointed by an earlier run), the CLI exits."""
    calls = []
    monkeypatch.setattr(jax_train_ensemble, "main",
                        _enum_stand_in(jax_train_ensemble.parse_args, calls))
    monkeypatch.setattr(train_ensemble, "main", lambda argv: calls.append(list(argv)))
    outdir = str(tmp_path / "gt")
    jax_groundtruth.main(["--dataset", GT_DATASET, "--training_steps", "3",
                          "--outdir", outdir, "--fit_counts", "4", "--num_estimate_seeds", "1"])
    with pytest.raises(SystemExit, match="15 subset values missing"):
        shapley_groundtruth.main(["--dataset", GT_DATASET, "--training_steps", "4",
                                  "--outdir", outdir, "--fit_counts", "4", "--device", "cpu",
                                  "--num_estimate_seeds", "1"])


def test_port_shapley_groundtruth_end_to_end(tmp_path):
    """2 classes: 3 subsets trained 2 steps by the port's train_ensemble and
    the null model; exact values meet the efficiency constraint."""
    outdir = str(tmp_path / "gt")
    out = shapley_groundtruth.main([
        "--dataset", "synthetic_64x8_c2", "--training_steps", "2", "--batch_size", "8",
        "--outdir", outdir, "--fit_counts", "2,4", "--num_estimate_seeds", "1",
        "--device", "cpu"])
    rows = list(read_records(os.path.join(outdir, "synthetic_64x8_c2_groundtruth_db.jsonl")))
    enum = [r for r in rows if r.get("removal_dist") == "enum"]
    assert sorted(r["removal_seed"] for r in enum) == [0, 1, 2]
    assert all(r["training_steps"] == 2 for r in enum)
    exact = out["exact"]
    assert exact.shape == (2,) and np.isfinite(exact).all()
    assert abs(exact.sum() - (out["v1"] - out["v0"])) <= 1e-6 * max(1.0, abs(out["v1"] - out["v0"]))
    assert rows[-1]["removal_dist"] == "groundtruth_summary"
    assert len(rows[-1]["convergence"]) == 4
