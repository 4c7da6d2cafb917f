"""The port's estimators, LDS and the LDS CLI against the JAX package's.

Everything here is numpy (and scipy's Spearman) in both packages, so every
result must be bit-identical (`np.array_equal`) on the same seeded inputs:
the closed-form KernelSHAP, the anchored and ridge KernelSHAP variants,
ridge-CV, bootstrapped datamodels, Banzhaf, LDS and its bootstrap, the
per-distribution fit dispatch and the JSONL row collection. The closed form
must also recover the exact Shapley values of an additive game (the
enumeration oracle) to 1e-9.
"""

import numpy as np
import pytest

from group_attribution_for_diffusion_models_tpu.attributions import lds as jax_lds
from group_attribution_for_diffusion_models_tpu.attributions import methods as jax_methods
from group_attribution_for_diffusion_models_tpu.cli import lds as jax_lds_cli
from group_attribution_for_diffusion_models_tpu.data import removal as jax_removal
from group_attribution_for_diffusion_models_tpu_torch.attributions import (
    bootstrap_lds_ci,
    collect_data,
    collect_local_data,
    evaluate_lds,
    methods,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import lds as lds_cli
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import append_record


def _game(seed, n, d, additive_noise=0.05):
    """(masks (n, d) 0/1, y (n,), v1, v0) of a noisy additive game."""
    rng = np.random.RandomState(seed)
    w = rng.normal(size=d)
    x = (rng.rand(n, d) > 0.5).astype(np.float32)
    y = 0.3 + x @ w + additive_noise * rng.normal(size=n)
    return x, y, 0.3 + w.sum(), 0.3


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed,n,d", [(0, 40, 8), (1, 6, 10), (2, 200, 25)])
def test_shapley_estimators_bitwise(seed, n, d):
    x, y, v1, v0 = _game(seed, n, d)
    _equal(methods.data_shapley(d, x, y, v1, v0), jax_methods.data_shapley(d, x, y, v1, v0))
    _equal(methods.kernel_shap(d, x, y, v1, v0), jax_methods.kernel_shap(d, x, y, v1, v0))
    if n > d:
        _equal(methods.kernel_shap_ridge(d, x, y, v1, v0),
               jax_methods.datashapley.kernel_shap_ridge(d, x, y, v1, v0))
    else:  # near-zero ridge on an underdetermined design: singular in both
        for fn in (methods.kernel_shap_ridge, jax_methods.datashapley.kernel_shap_ridge):
            with pytest.raises(np.linalg.LinAlgError):
                fn(d, x, y, v1, v0)
    # Efficiency holds exactly in the closed form, even underdetermined (n < d).
    assert abs(methods.data_shapley(d, x, y, v1, v0).sum() - (v1 - v0)) < 1e-9


@pytest.mark.parametrize("seed,n,d", [(0, 40, 8), (3, 30, 12)])
def test_ridge_datamodel_banzhaf_bitwise(seed, n, d):
    x, y, _, _ = _game(seed, n, d)
    _equal(methods.ridge_cv(x, y, seed=seed), jax_methods.ridge_cv(x, y, seed=seed))
    _equal(methods.ridge_cv(x, y, alphas=(1e-3, 5.0), cv=3),
           jax_methods.ridge_cv(x, y, alphas=(1e-3, 5.0), cv=3))
    _equal(methods.datamodel(x, y, num_runs=3, seed=seed),
           jax_methods.datamodel(x, y, num_runs=3, seed=seed))
    _equal(methods.data_banzhaf(x, y), jax_methods.data_banzhaf(x, y))
    masks = x.astype(np.float64)
    _equal(methods.compute_datamodel_scores(masks, y, np.arange(0, n // 2),
                                            np.arange(n // 2, n), num_runs=2, seed=1),
           jax_methods.compute_datamodel_scores(masks, y, np.arange(0, n // 2),
                                                np.arange(n // 2, n), num_runs=2, seed=1))


def test_data_shapley_recovers_an_additive_game():
    """Six players, v(S) = c + sum_{i in S} w_i: the closed form on every
    proper nonempty subset gives the enumeration oracle's values."""
    w = np.array([0.7, -1.3, 0.25, 2.0, -0.4, 0.05])
    c = 0.6

    def value(s):
        return c + sum(w[i] for i in s)

    oracle = methods.brute_force_shapley(6, value)
    _equal(oracle, jax_methods.brute_force_shapley(6, value))
    np.testing.assert_allclose(oracle, w, rtol=0, atol=1e-12)
    subsets = [np.array([(k >> i) & 1 for i in range(6)], np.float32) for k in range(1, 63)]
    x = np.stack(subsets)
    y = np.array([value(np.flatnonzero(m)) for m in x])
    got = methods.data_shapley(6, x, y, value(range(6)), value(())).ravel()
    assert np.abs(got - oracle).max() <= 1e-9


@pytest.mark.parametrize("behaviors", [1, 3])
def test_evaluate_lds_and_bootstrap_bitwise(behaviors):
    rng = np.random.RandomState(4)
    attrs = rng.normal(size=(behaviors, 10))
    tests = []
    for n in (12, 9, 15):
        x = (rng.rand(n, 10) > 0.5).astype(np.float32)
        y = x @ attrs.T + 0.5 * rng.normal(size=(n, behaviors))
        tests.append((x, y[:, 0] if behaviors == 1 else y))
    _equal(evaluate_lds(attrs, tests, behaviors),
           jax_lds.evaluate_lds(attrs, tests, behaviors))
    x, y = tests[0][0], (tests[0][1] if behaviors == 1 else tests[0][1][:, 0])
    _equal(bootstrap_lds_ci(attrs[0], x, y, num_iters=30, seed=2),
           jax_lds.bootstrap_lds_ci(attrs[0], x, y, num_iters=30, seed=2))


@pytest.mark.parametrize("dist", ["shapley", "shapley_paired", "uniform", "uniform_paired",
                                  "datamodel", "loo", "aoi"])
def test_fit_attribution_every_dist_bitwise(dist):
    d = 9
    x, y, v1, v0 = _game(5, 24, d)
    if dist in ("loo", "aoi"):
        # One flipped unit a row (some rows flip none, some two: ignored).
        base = np.zeros(d) if dist == "aoi" else np.ones(d)
        x = np.tile(base, (d + 2, 1)).astype(np.float32)
        for i in range(d):
            x[i, i] = 1 - base[i]
        x[d + 1, :2] = 1 - base[:2]
        y = np.random.RandomState(6).normal(size=len(x))
    for anchors in ({}, {"v1": v1, "v0": v0}):
        _equal(lds_cli.fit_attribution(dist, x, y, d, num_runs=2, **anchors),
               jax_lds_cli.fit_attribution(dist, x, y, d, num_runs=2, **anchors))
    with pytest.raises(ValueError, match="unknown removal_dist"):
        lds_cli.fit_attribution("nope", x, y, d)


def _write_db(path, labels, n_rows=14):
    """Rows of several (dist, method), some without remaining_idx (re-derived
    from the seed), some without the behavior, with per-image local keys."""
    rng = np.random.RandomState(7)
    for seed in range(n_rows):
        dist = ("shapley", "datamodel", "uniform")[seed % 3]
        remaining, removed = jax_removal.sample_removal(dist, labels, seed=seed, alpha=0.5,
                                                        by_class=True)
        row = {"dataset": "synthetic_64x8_mix", "method": "retrain" if seed % 4 else "gd",
               "removal_dist": dist, "removal_seed": seed, "datamodel_alpha": 0.5,
               "eval_loss": None if seed == 5 else float(rng.normal()),
               "generated_image_0_mse": float(rng.rand()),
               "generated_image_1_mse": None if seed == 8 else float(rng.rand())}
        if seed % 2:
            row.update(remaining_idx=remaining, removed_idx=removed)
        append_record(path, row)


@pytest.mark.parametrize("by_class", [False, True])
def test_collect_data_bitwise(tmp_path, by_class):
    labels = create_dataset("synthetic_64x8_mix").labels
    db = str(tmp_path / "db.jsonl")
    _write_db(db, labels)
    units = int(labels.max()) + 1 if by_class else len(labels)
    lab = labels if by_class else None
    for dist in ("shapley", "datamodel", "uniform"):
        cond = {"dataset": "synthetic_64x8_mix", "removal_dist": dist, "method": "retrain"}
        got = collect_data(db, cond, units, "eval_loss", by_class=by_class, labels=lab)
        want = jax_lds.collect_data(db, cond, units, "eval_loss", by_class=by_class,
                                    labels=lab)
        for g, w in zip(got, want):
            _equal(g, w)
        got = collect_local_data(db, cond, units, "mse", 2, by_class=by_class, labels=lab)
        want = jax_lds.collect_local_data(db, cond, units, "mse", 2, by_class=by_class,
                                          labels=lab)
        for g, w in zip(got, want):
            _equal(g, w)
    empty = collect_data(db, {"dataset": "other"}, units, "eval_loss")
    for g, w in zip(empty, jax_lds.collect_data(db, {"dataset": "other"}, units, "eval_loss")):
        _equal(g, w)


def test_lds_cli_prints_the_jax_lines(tmp_path, capsys):
    labels = create_dataset("synthetic_64x8_mix").labels
    db = str(tmp_path / "db.jsonl")
    _write_db(db, labels, n_rows=30)
    common = ["--dataset", "synthetic_64x8_mix", "--removal_dist", "shapley", "--by_class",
              "--train_db", db, "--test_db", db, "--model_behavior_key", "eval_loss",
              "--method", "retrain", "--train_size_step", "3", "--bootstrapped",
              "--num_bootstrap_iters", "20", "--v1", "1.5", "--v0", "-0.5"]
    jax_lds_cli.main(common)
    want = capsys.readouterr().out
    results = lds_cli.main(common + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert [r["train_size"] for r in results] == [3, 6, 7]
    with pytest.raises(SystemExit, match="no rows matched"):
        lds_cli.main(common[:-4] + ["--method", "ga", "--device", "cpu"])
