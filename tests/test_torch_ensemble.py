"""The port's data tier, ensemble trainer and train_ensemble CLI against the
JAX package's, on the CPU.

The numpy parts (removal samplers and masks, synthetic datasets, the
CIFAR-10 reader, the member index table, the per-step seed) must match bit
for bit. JSONL rows and tracker rows must be readable by the other package.
The trainer keeps the common-noise contract: identical subsets give
bitwise-identical members. The CLI draws the JAX CLI's removal subsets and
writes rows with its key set, apart from the flags this slice leaves out.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.data import datasets as jax_datasets
from group_attribution_for_diffusion_models_tpu.data import removal as jax_removal
from group_attribution_for_diffusion_models_tpu.parallel import ensemble as jax_ensemble
from group_attribution_for_diffusion_models_tpu.utils import jsonl as jax_jsonl
from group_attribution_for_diffusion_models_tpu.utils import trackers as jax_trackers
from group_attribution_for_diffusion_models_tpu_torch.cli import train_ensemble
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.data import datasets, removal
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
from group_attribution_for_diffusion_models_tpu_torch.parallel import ensemble
from group_attribution_for_diffusion_models_tpu_torch.training import (
    make_optimizer,
    unstack_state,
)
from group_attribution_for_diffusion_models_tpu_torch.utils import jsonl, trackers
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import (
    get_max_steps,
    load_checkpoint,
    load_meta,
)

LABELS = np.random.RandomState(0).randint(0, 6, size=50)
DISTS = ["uniform", "uniform_paired", "datamodel", "shapley", "shapley_paired", "full"]


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("by_class", [False, True])
def test_sample_removal_bitwise(dist, by_class):
    target = LABELS if by_class else len(LABELS)
    for seed in range(6):
        for alpha in (0.5, 0.25):
            _same(removal.sample_removal(dist, target, seed=seed, alpha=alpha, by_class=by_class),
                  jax_removal.sample_removal(dist, target, seed=seed, alpha=alpha,
                                             by_class=by_class))


def test_loo_aoi_class_samplers_and_masks_bitwise():
    for dist in ("loo", "aoi"):
        _same(removal.sample_removal(dist, 50, idx=7), jax_removal.sample_removal(dist, 50, idx=7))
        with pytest.raises(ValueError, match="requires idx"):
            removal.sample_removal(dist, 50)
    _same(removal.remove_data_by_class(LABELS, [1, 4]),
          jax_removal.remove_data_by_class(LABELS, [1, 4]))
    for seed in range(4):
        _same(removal.removed_by_classes(LABELS, seed),
              jax_removal.removed_by_classes(LABELS, seed))
    for dist in ("uniform", "datamodel", "shapley", "shapley_paired"):
        got = removal.removal_masks(dist, 40, range(7), alpha=0.3)
        want = jax_removal.removal_masks(dist, 40, range(7), alpha=0.3)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError, match="unknown removal_dist"):
        removal.sample_removal("nope", 10)


@pytest.mark.parametrize("name", [
    "synthetic_64x8", "synthetic_32x8_mix", "synthetic_32x8_tex", "synthetic_32x8_tpl",
    "synthetic_48x8_c4_sizes", "synthetic_32x8_tpl_mix_big"])
def test_synthetic_datasets_bitwise(name):
    got, want = datasets.create_dataset(name), jax_datasets.create_dataset(name)
    _same((got.images, got.labels), (want.images, want.labels))


def test_cifar_reader_bitwise_and_unknown_names(tmp_path):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(0)
    for i in range(1, 6):
        with open(base / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                         "labels": rng.integers(0, 10, 3).tolist()}, f)
    got = datasets.create_dataset("cifar", dataset_dir=str(tmp_path))
    want = jax_datasets.create_dataset("cifar", dataset_dir=str(tmp_path))
    assert got.images.shape == (15, 32, 32, 3)
    _same((got.images, got.labels), (want.images, want.labels))
    with pytest.raises(ValueError, match="unknown synthetic dataset token"):
        datasets.create_dataset("synthetic_32x8_tlp")
    with pytest.raises(ValueError, match="should be one of .*'mnist'"):
        datasets.create_dataset("svhn")


def test_member_index_table_and_step_seed_bitwise():
    members = [np.array([3, 1, 4]), np.arange(130), np.array([9])]
    for pad in (1, 8, 128):
        _same(ensemble.pad_member_indices(members, pad),
              jax_ensemble.pad_member_indices(members, pad))
    with pytest.raises(ValueError, match="nonempty"):
        ensemble.pad_member_indices([np.array([1]), np.array([], dtype=np.int64)])
    for seed, step in ((0, 0), (42, 7), (5000, 123), (2**31, 9)):
        assert ensemble._step_seed(seed, step) == jax_ensemble._step_seed(seed, step)


def test_jsonl_rows_cross_packages(tmp_path):
    db = str(tmp_path / "db.jsonl")
    jsonl.append_record(db, {"a": np.int64(1), "x": np.float32(0.5), "idx": np.arange(3)})
    jax_jsonl.append_record(db, {"a": 2, "x": 1.5, "idx": [0]})
    with open(db, "a") as f:
        f.write("{torn\n\n")
    assert list(jsonl.read_records(db)) == list(jax_jsonl.read_records(db))
    assert jsonl.filter_records(db, {"a": 2}) == jax_jsonl.filter_records(db, {"a": 2})
    assert [r["idx"] for r in jsonl.read_records(db)] == [[0, 1, 2], [0]]
    assert list(jsonl.read_records(str(tmp_path / "missing.jsonl"))) == []


def test_trackers_write_the_jax_rows(tmp_path):
    rows = {}
    for name, make in (("port", trackers.make_tracker), ("jax", jax_trackers.make_tracker)):
        t = make("jsonl", run_name=name, config={"lr": 1e-3, "obj": object},
                 logdir=str(tmp_path))
        t.log({"loss": np.float32(0.25)}, 3)
        t.finish()
        with open(tmp_path / f"{name}.jsonl") as f:
            rows[name] = [json.loads(line) for line in f]
        for r in rows[name]:
            r.pop("ts", None)
    assert rows["port"] == rows["jax"]
    assert isinstance(trackers.make_tracker("none"), trackers.NullTracker)
    with pytest.raises(ImportError, match="wandb"):
        trackers.make_tracker("wandb")


def _trainer(member_indices, common_noise):
    ds = datasets.make_synthetic(n=32, size=8)
    images_u8 = ((ds.images + 1.0) * 127.5).round().astype(np.uint8)
    sched = config_for("synthetic_32x8").scheduler
    return ensemble.EnsembleTrainer(
        tx=make_optimizer("adam", lr=1e-3), schedule=make_schedule(sched), spec=sched,
        images_u8=images_u8, member_indices=member_indices, batch_size=4,
        device=torch.device("cpu"), common_noise=common_noise,
    )


def _flat(state):
    return torch.cat([p.detach().flatten() for p in state.params])


def test_common_noise_identical_subsets_identical_members():
    subset = removal.sample_removal("shapley", 32, seed=0)[0]
    other = removal.sample_removal("shapley", 32, seed=1)[0]
    assert not np.array_equal(subset, other)
    spec = config_for("synthetic_32x8").unet
    trainer = _trainer([subset, subset, other], common_noise=True)
    stacked = trainer.init_state(lambda seed: build_unet(spec, seed), seed=3)
    stacked, metrics = trainer.run(stacked, 3, seed=5)
    states = [unstack_state(stacked, m) for m in range(3)]
    p0, p1, p2 = (_flat(s) for s in states)
    assert torch.equal(p0, p1)
    assert not torch.equal(p0, p2)
    assert metrics["loss"][0] == metrics["loss"][1]
    assert all(torch.equal(a, b) for a, b in zip(states[0].ema, states[1].ema))


def test_independent_noise_members_differ_and_batches_stay_in_subset():
    subset = np.array([2, 5, 11])
    spec = config_for("synthetic_32x8").unet
    trainer = _trainer([subset, subset], common_noise=False)
    stacked = trainer.init_state(lambda seed: build_unet(spec, seed), seed=3)
    states = [unstack_state(stacked, m) for m in range(2)]
    assert not torch.equal(_flat(states[0]), _flat(states[1]))  # own init each
    raw = torch.arange(0, 1000, 7)
    batch = trainer.batch(torch.stack([raw, raw + 1]))
    assert batch.shape == (2, len(raw), 3, 8, 8)
    allowed = torch.from_numpy(trainer.images_u8[subset]).permute(0, 3, 1, 2).float() / 127.5 - 1
    assert all(any(torch.equal(b, a) for a in allowed) for b in batch.flatten(0, 1))
    stacked, _ = trainer.run(stacked, 2, seed=0)
    assert stacked.step == 2 and stacked.opt_state.count == 2


def _run_port(outdir, *extra):
    return train_ensemble.main([
        "--dataset", "synthetic_64x8", "--removal_dist", "shapley", "--num_seeds", "3",
        "--outdir", str(outdir), "--device", "cpu", *extra])


# Flags of the JAX CLI the port leaves out (none since the mesh came); the
# port adds --device.
LEFT_OUT: set = set()


def test_train_ensemble_matches_the_jax_cli(tmp_path, monkeypatch):
    import jax

    from group_attribution_for_diffusion_models_tpu.cli import train_ensemble as jax_cli

    # flax's init runs op by op outside jit (seconds per member on the CPU);
    # one jitted init gives the same parameters.
    init_state = jax_ensemble.EnsembleTrainer.init_state
    monkeypatch.setattr(
        jax_ensemble.EnsembleTrainer, "init_state",
        lambda self, params=None, init_fn=None, seed=0: init_state(
            self, params, init_fn and jax.jit(init_fn), seed))
    jax_out = tmp_path / "jax"
    jax_cli.main(["--dataset", "synthetic_64x8", "--removal_dist", "shapley",
                  "--num_seeds", "1", "--training_steps", "0", "--outdir", str(jax_out),
                  "--no-save_ckpts"])
    (jax_row,) = list(jax_jsonl.read_records(str(jax_out / "synthetic_64x8_train_db.jsonl")))

    summary = _run_port(tmp_path / "port", "--training_steps", "2", "--eval_loss",
                        "--n_samples", "2", "--num_inference_steps", "2")
    rows = list(jsonl.read_records(summary["db"]))
    assert [r["removal_seed"] for r in rows] == [0, 1, 2] == summary["seeds"]
    assert set(jax_row) - LEFT_OUT == set(rows[0]) - {"device"}
    # The smallest subset caps the batch (8 in the synthetic config), as in JAX.
    assert summary["batch_size"] == min(8, *(len(r["remaining_idx"]) for r in rows))
    for r in rows:
        want = jax_removal.sample_removal("shapley", 64, seed=r["removal_seed"])
        assert r["remaining_idx"] == want[0].tolist()
        assert r["removed_idx"] == want[1].tolist()
        assert np.isfinite(r["loss"]) and np.isfinite(r["eval_loss"])
    assert rows[0]["remaining_idx"] == jax_row["remaining_idx"]
    for d, r in zip(summary["model_dirs"], rows):
        assert get_max_steps(d) == 2
        meta = load_meta(d)
        assert meta["remaining_idx"] == r["remaining_idx"]
        assert meta["unet_spec"]["block_out_channels"] == [8, 16]
        np.testing.assert_array_equal(np.load(os.path.join(d, "remaining_idx.npy")),
                                      r["remaining_idx"])
    assert summary["samples"].shape == (3, 2, 3, 8, 8)
    assert np.isfinite(summary["samples"]).all()

    again = _run_port(tmp_path / "port", "--training_steps", "2")  # idempotent
    assert again["seeds"] == [] and again["skipped"] == [0, 1, 2]
    assert len(list(jsonl.read_records(summary["db"]))) == 3


def test_train_ensemble_zero_steps_and_load(tmp_path):
    null = _run_port(tmp_path / "null", "--training_steps", "0")
    assert np.isnan(null["losses"]).all()
    rows = list(jsonl.read_records(null["db"]))
    assert all(np.isnan(r["loss"]) for r in rows) and len(rows) == 3
    member0 = load_checkpoint(null["model_dirs"][0])
    # Common noise: every member starts from one init.
    member1 = load_checkpoint(null["model_dirs"][1])
    assert all(torch.equal(member0["params"][k], member1["params"][k]) for k in member0["params"])
    loaded = _run_port(tmp_path / "ft", "--training_steps", "0", "--load",
                       null["model_dirs"][0], "--seed_start", "5")
    state = load_checkpoint(loaded["model_dirs"][0])
    assert all(torch.equal(state["params"][k], member0["params"][k]) for k in member0["params"])
    with pytest.raises(SystemExit, match="requires --removal_masks"):
        _run_port(tmp_path / "enum", "--removal_dist", "enum")


def test_train_ensemble_removal_masks_and_db_completion(tmp_path):
    masks = np.zeros((3, 64), dtype=np.float32)
    masks[:, :10] = 1
    masks[1, 10:20] = 1
    path = str(tmp_path / "masks.npy")
    np.save(path, masks)
    args = ["--dataset", "synthetic_64x8", "--removal_dist", "enum", "--removal_masks", path,
            "--num_seeds", "3", "--training_steps", "1", "--outdir", str(tmp_path),
            "--device", "cpu", "--no-save_ckpts", "--bf16", "--remat"]
    summary = train_ensemble.main(args)
    rows = list(jsonl.read_records(summary["db"]))
    assert [len(r["remaining_idx"]) for r in rows] == [10, 20, 10]
    assert all(r["bf16"] and r["remat"] and np.isfinite(r["loss"]) for r in rows)
    assert train_ensemble.main(args)["skipped"] == [0, 1, 2]  # rows complete the seeds
    with pytest.raises(SystemExit, match="requires --removal_dist enum"):
        train_ensemble.main([a if a != "enum" else "shapley" for a in args])
