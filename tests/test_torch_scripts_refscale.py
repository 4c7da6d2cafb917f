"""The reference-protocol twins of the experiment scripts, on the CPU.

`scripts/refscale_attribution_torch.sh` -> `refscale_sparseft_torch.sh` ->
`refscale_prefix_curve_torch.py` run end to end at smoke scale with
``DEVICE=cpu`` on one DB shared by the module (`_twin_runner` starts their
Python processes from one pre-imported interpreter). The prefix-curve twin
gives the JAX script's curve on the same DB: on the chain's DB and on a DB of
hand-made rows long enough for several prefixes. The protocols' datasets and
removal subsets are the JAX package's bit for bit, so the packages' runs
differ only in the draws torch cannot share with threefry.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from group_attribution_for_diffusion_models_tpu.data import create_dataset as jax_create_dataset
from group_attribution_for_diffusion_models_tpu.data import sample_removal as jax_sample_removal
from group_attribution_for_diffusion_models_tpu.utils import native_jsonl as jax_native_jsonl
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset, sample_removal
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import append_record

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _twin_runner import TwinRunner  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "synthetic_64x8_tpl_mix"
SMOKE = dict(DEVICE="cpu", DATASET=DATASET, FIT="8", TEST="6", STEPS="2", SPARSE_STEPS="2")
PORT = "group_attribution_for_diffusion_models_tpu_torch"

# Every dataset a recorded protocol or a twin's default trains on.
PROTOCOL_DATASETS = [
    "synthetic_2048x32_c32_tpl_mix_sizes", "synthetic_512x8_c8_tpl_mix_sizes",
    "synthetic_2048x32_c32_tpl_mix_sizes_big", "synthetic_2048x32_tpl_mix_big",
    "synthetic_2048x32_tpl_mix", "synthetic_2048x32_mix",
]


def _jax_prefix_script():
    spec = importlib.util.spec_from_file_location(
        "jax_refscale_prefix_curve", os.path.join(REPO, "scripts", "refscale_prefix_curve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_curve(monkeypatch, tmp_path, db, dataset, steps, method):
    """The JAX script's curve of `db`, run in a scratch working directory: it
    writes docs/refscale_prefix_curve*.json relative to it. Its reads take the
    JAX package's plain JSONL path: the native scanner keeps every file it
    opens in a table of 64 slots for the life of the process
    (native/jsonl_scan.cpp), and this worker may run test_native_jsonl.py
    next."""
    work = tmp_path / f"jax_{method}"
    (work / "docs").mkdir(parents=True)
    monkeypatch.chdir(work)
    monkeypatch.setattr(jax_native_jsonl, "filter_records_native", lambda *args: None)
    monkeypatch.setattr(sys, "argv", ["refscale_prefix_curve.py", str(db), dataset,
                                      str(steps), method])
    _jax_prefix_script().main()
    suffix = "" if method == "retrain" else f"_{method}"
    return json.loads((work / "docs" / f"refscale_prefix_curve{suffix}.json").read_text())


def _docs_state():
    docs = os.path.join(REPO, "docs")
    return {n: open(os.path.join(docs, n), "rb").read() for n in sorted(os.listdir(docs))
            if n.startswith("refscale_prefix_curve")}


@pytest.fixture(scope="module")
def runner():
    r = TwinRunner(REPO)
    yield r
    r.close()


@pytest.fixture(scope="module")
def chain(runner, tmp_path_factory):
    """The refscale chain at smoke scale: pipeline, sparse FT, both curves."""
    out = tmp_path_factory.mktemp("refscale")
    env = dict(SMOKE, OUT=str(out))
    procs = {name: runner.run(f"scripts/{name}", env)
             for name in ("refscale_attribution_torch.sh", "refscale_sparseft_torch.sh")}
    db = out / f"{DATASET}_pipeline_db.jsonl"
    for method, steps in (("retrain", SMOKE["STEPS"]), ("prune_fine_tune", SMOKE["SPARSE_STEPS"])):
        procs[method] = runner.run("scripts/refscale_prefix_curve_torch.py", {}, args=(
            str(db), DATASET, steps, method, "--out", str(out / f"curve_{method}.json")))
    rows = [json.loads(line) for line in db.read_text().splitlines() if line.strip()]
    return dict(out=out, db=db, procs=procs, rows=rows)


def _rows(rows, **match):
    return [r for r in rows if all(r.get(k) == v for k, v in match.items())]


def test_refscale_twin_trains_the_protocol_rows_on_the_port(chain):
    proc = chain["procs"]["refscale_attribution_torch.sh"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    commands = [line for line in proc.stderr.splitlines() if line.startswith("+ python")]
    assert commands and all(f" -m {PORT}.cli." in c and c.endswith("--device cpu")
                            for c in commands)
    rows = chain["rows"]
    fit = _rows(rows, removal_dist="shapley_paired", method="retrain", training_steps=2)
    assert sorted(r["removal_seed"] for r in fit) == list(range(100, 108))
    test = _rows(rows, removal_dist="datamodel", method="retrain", training_steps=2)
    assert sorted(r["removal_seed"] for r in test) == list(range(5000, 5006))
    assert sorted(r["training_steps"] for r in _rows(rows, removal_dist="full",
                                                     method="retrain")) == [0, 2]
    (summary,) = _rows(rows, exp_name="shapley_pipeline")
    assert summary["num_fit_subsets"] == 8 and summary["num_test_subsets"] == 6
    assert np.isfinite(summary["lds_mean"]) and "LDS =" in proc.stdout


def test_sparseft_twin_fits_pruned_members_against_the_same_test_rows(chain):
    proc = chain["procs"]["refscale_sparseft_torch.sh"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--pruner diff-pruning --timestep_stride 10" in proc.stderr
    assert (chain["out"] / DATASET / "prune" / "models" / "full").is_dir()
    rows = chain["rows"]
    fit = _rows(rows, removal_dist="shapley_paired", method="prune_fine_tune", training_steps=2)
    assert sorted(r["removal_seed"] for r in fit) == list(range(100, 108))
    # The retrain test rows are reused, not trained again.
    assert len(_rows(rows, removal_dist="datamodel")) == 6
    (summary,) = _rows(rows, exp_name="sparseft_pipeline")
    assert summary["method"] == "prune_fine_tune" and np.isfinite(summary["lds_mean"])


@pytest.mark.parametrize("method", ["retrain", "prune_fine_tune"])
def test_prefix_curve_twin_gives_the_jax_scripts_curve_on_the_chains_db(
        chain, method, monkeypatch, tmp_path):
    proc = chain["procs"][method]
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads((chain["out"] / f"curve_{method}.json").read_text())
    docs = _docs_state()
    want = _jax_curve(monkeypatch, tmp_path, chain["db"], DATASET, 2, method)
    assert _docs_state() == docs
    assert got == want
    assert np.isfinite(got["curve"][-1]["lds"]) and got["num_test"] == 6


def _hand_made_db(path, n_fit, n_test, seed=0, extra_test_steps=None):
    """A pipeline DB of rows made without training: the port's removal
    subsets, seeded behaviors, anchors at 0 and 2 steps."""
    labels = create_dataset(DATASET, train=True, device="cpu").labels
    rng = np.random.default_rng(seed)
    for dist, seeds, steps in (("shapley_paired", range(100, 100 + n_fit), 2),
                               ("datamodel", range(5000, 5000 + n_test), 2),
                               *((("datamodel", range(5000, 5000 + n_test), extra_test_steps),)
                                 if extra_test_steps else ())):
        for s in seeds:
            remaining, removed = sample_removal(dist, labels, seed=s, by_class=True)
            kept = np.unique(labels[remaining])
            append_record(str(path), dict(
                dataset=DATASET, method="retrain", removal_dist=dist, removal_seed=s,
                training_steps=steps, remaining_idx=remaining.tolist(),
                eval_loss=float(1.0 - 0.01 * kept.sum() + 0.02 * rng.standard_normal())))
    for steps, value in ((0, 1.3), (2, 0.6)):
        append_record(str(path), dict(dataset=DATASET, method="retrain", removal_dist="full",
                                      removal_seed=0, training_steps=steps, eval_loss=value))


def _twin_curve(runner, db, out, *extra):
    proc = runner.run("scripts/refscale_prefix_curve_torch.py", {},
                      args=(str(db), DATASET, "2", "retrain", "--out", str(out), *extra))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_prefix_curve_twin_gives_the_jax_curve_over_every_prefix(runner, monkeypatch, tmp_path):
    db = tmp_path / "db.jsonl"
    _hand_made_db(db, n_fit=400, n_test=30)
    got = _twin_curve(runner, db, tmp_path / "twin.json")
    want = _jax_curve(monkeypatch, tmp_path, db, DATASET, 2, "retrain")
    assert [c["fit"] for c in got["curve"]] == [32, 64, 128, 250, 374, 400]
    assert got == want


def test_prefix_curve_twin_keeps_every_test_row_and_one_budget(runner, monkeypatch, tmp_path):
    """Intended behavior where the JAX script differs (ROADMAP C4): 31 test
    rows give groups of 11, 10 and 10 (the JAX script's len // 3 drops one),
    and test rows at a second budget stay out (the JAX script takes them)."""
    db = tmp_path / "db.jsonl"
    _hand_made_db(db, n_fit=40, n_test=31, extra_test_steps=7)
    got = _twin_curve(runner, db, tmp_path / "twin.json")
    want = _jax_curve(monkeypatch, tmp_path, db, DATASET, 2, "retrain")
    assert got["num_test"] == 31 and want["num_test"] == 62
    assert got["test_groups"] == 3


def test_prefix_curve_twin_never_writes_the_jax_runs_files(runner, chain):
    docs = _docs_state()
    proc = runner.run("scripts/refscale_prefix_curve_torch.py", {}, args=(
        str(chain["db"]), DATASET, "2", "retrain",
        "--out", os.path.join(REPO, "docs", "refscale_prefix_curve.json")))
    assert proc.returncode != 0 and "JAX package's run" in proc.stderr
    assert _docs_state() == docs


@pytest.mark.parametrize("dataset", PROTOCOL_DATASETS)
def test_protocol_datasets_are_the_jax_packages_bit_for_bit(dataset):
    got = create_dataset(dataset, train=True, device="cpu")
    want = jax_create_dataset(dataset, train=True)
    assert got.images.dtype == np.asarray(want.images).dtype
    assert np.array_equal(got.images, np.asarray(want.images))
    assert np.array_equal(got.labels, np.asarray(want.labels))


@pytest.mark.parametrize("dataset, dist, seeds", [
    # refscale's fit and test subsets.
    ("synthetic_2048x32_c32_tpl_mix_sizes", "shapley_paired", range(100, 600)),
    ("synthetic_2048x32_c32_tpl_mix_sizes", "datamodel", range(5000, 5300)),
    # the ground truth's estimate draws (seeds 10,000 (e + 1) + j).
    ("synthetic_512x8_c8_tpl_mix_sizes", "shapley_paired", range(10_000, 10_200)),
    ("synthetic_512x8_c8_tpl_mix_sizes", "shapley", range(30_000, 30_200)),
])
def test_protocol_removal_subsets_are_the_jax_packages_bit_for_bit(dataset, dist, seeds):
    labels = create_dataset(dataset, train=True, device="cpu").labels
    for s in seeds:
        got = sample_removal(dist, labels, seed=s, by_class=True)
        want = jax_sample_removal(dist, labels, seed=s, by_class=True)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(got, want)), s
