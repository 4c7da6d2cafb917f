"""The port's text-to-image LDS CLIs against the JAX package's, on the CPU.

One behavior DB written by the JAX package's `append_record` holds shapley
and shapley_paired, uniform, loo and aoi rows (some with `kept_units`, as
the LoRA trainer writes them, some without, as `compute_model_behaviors`
writes them, so the mask is redrawn from removal_dist and removal_seed),
retrain and sparse_gd rows, three datamodel test DBs and the full and null
anchors. The six CLIs (`shapley_lds`, `banzhaf_lds`, `loo_lds`, `aoi_lds`,
`shapley_convergence`, `baseline_lds`) run in both packages on it: the
printed lines and the saved arrays are held equal exactly (numpy and scipy
on both sides).
"""

import os

import numpy as np
import pytest

from group_attribution_for_diffusion_models_tpu.cli import aoi_lds as jax_aoi
from group_attribution_for_diffusion_models_tpu.cli import banzhaf_lds as jax_banzhaf
from group_attribution_for_diffusion_models_tpu.cli import baseline_lds as jax_baseline
from group_attribution_for_diffusion_models_tpu.cli import loo_lds as jax_loo
from group_attribution_for_diffusion_models_tpu.cli import (
    shapley_convergence as jax_convergence,
)
from group_attribution_for_diffusion_models_tpu.cli import shapley_lds as jax_shapley
from group_attribution_for_diffusion_models_tpu.data.removal import (
    sample_removal as jax_sample_removal,
)
from group_attribution_for_diffusion_models_tpu.utils.jsonl import append_record
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    _tti_lds,
    aoi_lds,
    banzhaf_lds,
    baseline_lds,
    loo_lds,
    shapley_convergence,
    shapley_lds,
)

GROUPS = 8
KEY = "aesthetic_score_avg"


def _row(rng, dist, seed, method="retrain", kept=None, key=KEY, **extra):
    row = {"removal_dist": dist, "removal_seed": seed, "method": method,
           "datamodel_alpha": 0.5, key: float(rng.standard_normal()), **extra}
    if kept is not None:
        row["kept_units"] = [int(k) for k in kept]
    return row


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """A JAX-written train DB, three test DBs, the anchors and two attribution
    vectors, in one directory."""
    d = tmp_path_factory.mktemp("tti_lds")
    rng = np.random.default_rng(60)
    train = str(d / "train.jsonl")
    for seed in range(14):  # every other row without kept_units
        kept = jax_sample_removal("shapley", GROUPS, seed=seed)[0] if seed % 2 else None
        append_record(train, _row(rng, "shapley", seed, kept=kept))
        append_record(train, _row(rng, "shapley", seed, method="sparse_gd",
                                  simple_loss_avg=float(rng.uniform(0.1, 0.2))))
    for seed in range(4):
        append_record(train, _row(rng, "shapley_paired", 100 + seed))
    for seed in range(9):
        append_record(train, _row(rng, "uniform", seed))
    for g in range(GROUPS):
        keep = np.delete(np.arange(GROUPS), g)
        append_record(train, _row(rng, "loo", g, kept=keep))
        append_record(train, _row(rng, "aoi", g, kept=[g]))
    append_record(train, {"removal_dist": "shapley", "method": "retrain", "removal_seed": 99,
                          KEY: None})  # no behavior: skipped
    tests = []
    for j in range(3):
        path = str(d / f"test_{j}.jsonl")
        for seed in range(6):
            append_record(path, _row(rng, "datamodel", 42 + j * 10 + seed,
                                     simple_loss_avg=float(rng.uniform(0.1, 0.2))))
        tests.append(path)
    append_record(str(d / "full.jsonl"), {KEY: 1.5, "removal_dist": "full"})
    append_record(str(d / "null.jsonl"), {"other": 1.0})
    append_record(str(d / "null.jsonl"), {KEY: -0.5, "removal_dist": "null"})
    np.save(d / "attrs_a.npy", rng.standard_normal(GROUPS))
    np.save(d / "attrs_b.npy", rng.standard_normal(GROUPS + 1))  # wrong width: skipped
    return d, train, tests


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _common(db, save):
    d, train, tests = db
    return ["--train_db", train, "--test_db", *tests, "--num_groups", str(GROUPS),
            "--train_size_step", "5", "--save_dir", str(d / save)]


@pytest.mark.parametrize("name,extra", [
    ("shapley", []),
    ("shapley", ["--full_db", "FULL", "--null_db", "NULL"]),
    ("shapley", ["--v1", "2.0", "--v0", "-1.0", "--max_train_size", "12"]),
    ("banzhaf", []),
    ("loo", ["--v1", "1.25"]),
    ("aoi", []),
])
def test_lds_clis_reproduce_the_jax_clis(db, capsys, name, extra):
    d = db[0]
    extra = [str(d / "full.jsonl") if x == "FULL" else str(d / "null.jsonl") if x == "NULL"
             else x for x in extra]
    mods = {"shapley": (shapley_lds, jax_shapley), "banzhaf": (banzhaf_lds, jax_banzhaf),
            "loo": (loo_lds, jax_loo), "aoi": (aoi_lds, jax_aoi)}
    port, jax_mod = mods[name]
    want = _run(jax_mod.main, _common(db, "jax") + extra, capsys)
    got = _run(port.main, _common(db, "port") + extra, capsys)
    assert got.replace("port", "X") == want.replace("jax", "X")
    assert got.count("LDS=") >= 2
    saved = sorted(os.listdir(d / "port"))
    assert saved == sorted(os.listdir(d / "jax")) and len(saved) >= 2
    for f in saved:
        np.testing.assert_array_equal(np.load(d / "port" / f), np.load(d / "jax" / f))
    if "--full_db" in extra:  # the efficiency constraint on the anchors
        (attrs,) = [np.load(d / "port" / f) for f in saved if f.startswith("attrs")]
        assert abs(attrs.sum() - (1.5 - (-0.5))) <= 1e-6 * 2.0


def test_shapley_convergence_reproduces_the_jax_cli(db, capsys):
    argv = _common(db, "conv")[:-2] + ["--method", "sparse_gd", "--train_size_step", "4",
                                       "--v1", "1.0", "--v0", "0.0"]
    want = _run(jax_convergence.main, argv, capsys)
    got = _run(shapley_convergence.main, argv, capsys)
    assert got == want and got.count("fit_size=") == 4


@pytest.mark.parametrize("key,boot", [(KEY, True), ("simple_loss_avg", False)])
def test_baseline_lds_reproduces_the_jax_cli(db, capsys, key, boot):
    """A loss-like key flips the sign; a vector of the wrong width is skipped."""
    d, _, tests = db
    argv = ["--attrs", str(d / "attrs_a.npy"), str(d / "attrs_b.npy"), "--test_db", *tests,
            "--model_behavior_key", key, "--num_groups", str(GROUPS),
            "--num_bootstrap_iters", "20"] + (["--bootstrapped"] if boot else [])
    want = _run(jax_baseline.main, argv, capsys)
    got = _run(baseline_lds.main, argv, capsys)
    assert got == want and "skipped" in got and ("bootstrap=[" in got) == boot


def test_masks_redrawn_from_the_removal_seed_equal_the_recorded_ones(db):
    """A row without kept_units gets the mask its removal_dist and seed draw:
    the trainer's kept_units for the same seed."""
    _, train, _ = db
    x, _, seeds = _tti_lds.collect_group_data(train, {"removal_dist": "shapley",
                                                      "method": "retrain"}, GROUPS, KEY)
    assert seeds == list(range(14)) and x.shape == (14, GROUPS)
    for seed, mask in zip(seeds, x):
        kept = jax_sample_removal("shapley", GROUPS, seed=seed)[0]
        np.testing.assert_array_equal(np.flatnonzero(mask), np.sort(kept))
    with pytest.raises(SystemExit, match="no rows matched"):
        shapley_lds.main(_common(db, "none") + ["--method", "gd"])
