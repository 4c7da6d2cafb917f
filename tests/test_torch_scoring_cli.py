"""The port's scoring CLIs on the CPU, tiny and end to end.

`train_ensemble --score fid_is` scores its members in the loop; its per-member
FID and IS must be those of the JAX package's functions (`make_feature_fn`,
`calculate_fid_from_features`, `inception_score_from_logits`) on the same
samples and the same tower, carried over by the JAX converter, within 1e-4
relative. Beside that end-to-end check, the JAX tower's features and
reference stats must be those the port scored, within 1e-4 relative, and the
JAX `calculate_fid_from_features` on the features the port scored must give
the port's FID bit for bit. That FID is the same scipy ``sqrtm`` of the same
product, so the test computes each distinct ``sqrtm`` input once (a memo by
the matrix's bytes). `shapley_pipeline --behavior is` runs the estimation
loop on the Inception Score; `calculate_global_scores` scores a sample
directory with precision and recall on the tiny VGG tower; `evaluate_fid`
compares two PNG directories.

Reference stats carry the tag of the tower that made them. The JAX CLIs
load any ``--ref_stats`` file they find, whatever tower made it
(``cli/train_ensemble.py:503-504``, ROADMAP C3); the port recomputes the
stats of a file with another tag, which `train_ensemble`'s test shows.

Each 2048-d FID costs a scipy ``sqrtm`` of seconds on this CPU, so the
module takes six: two members in the port and in JAX, one for each of the
other two CLIs.
"""

import hashlib
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    calculate_fid_from_features as jax_calculate_fid_from_features,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    compute_feature_stats as jax_compute_feature_stats,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    inception_score_from_logits as jax_inception_score_from_logits,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores.inception_v3 import (
    InceptionV3 as JaxInceptionV3,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores.inception_v3 import (
    convert_torch_state_dict,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores.inception_v3 import (
    make_feature_fn as jax_make_feature_fn,
)
from group_attribution_for_diffusion_models_tpu.cli import calculate_global_scores as jax_cgs
from group_attribution_for_diffusion_models_tpu_torch.attributions.global_scores import (
    load_inception,
    save_stats,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    calculate_global_scores,
    evaluate_fid,
    shapley_pipeline,
    train_ensemble,
)
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import read_records

DATASET = "synthetic_32x8"  # 32 images of 8x8: the reference set of FID
SCORE_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread and one BLAS thread while this module runs: the test
    workers share the CPU, and scipy's 2048-d sqrtm gains little from more
    (about 25 s with 8 OpenBLAS threads, 29 s with one, on an idle 8-core
    CPU) while their spinning slows the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _ensemble_argv(outdir, *extra):
    return ["--dataset", DATASET, "--removal_dist", "shapley", "--num_seeds", "2",
            "--training_steps", "2", "--num_inference_steps", "2", "--outdir", str(outdir),
            "--device", "cpu", *extra]


def test_train_ensemble_scores_members_as_the_jax_functions_do(tmp_path, capsys, monkeypatch):
    ref_path = tmp_path / "ref.pkl"
    # Stats of another tower, as a JAX run or an earlier weights file leaves
    # them: the port must not score against them.
    save_stats(str(ref_path), np.zeros(2048), np.eye(2048), tower="random:7")
    scored = []  # (generated features, reference stats) of each port FID
    port_fid = train_ensemble.calculate_fid_from_features

    def recording_fid(feats, ref_stats):
        scored.append((np.array(feats), ref_stats))
        return port_fid(feats, ref_stats=ref_stats)

    roots = {}
    sqrtm = scipy.linalg.sqrtm

    def sqrtm_once(a, *args, **kwargs):
        key = (a.shape, hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest())
        if key not in roots:
            roots[key] = sqrtm(a, *args, **kwargs)
        return roots[key]

    monkeypatch.setattr(train_ensemble, "calculate_fid_from_features", recording_fid)
    monkeypatch.setattr(scipy.linalg, "sqrtm", sqrtm_once)
    # 12 samples a member: IS over 10 splits needs chunks of more than one.
    summary = train_ensemble.main(_ensemble_argv(
        tmp_path, "--n_samples", "12", "--score", "fid_is", "--ref_stats", str(ref_path)))
    assert "made by tower 'random:7', not 'random:0': recomputing" in capsys.readouterr().out
    with open(ref_path, "rb") as f:
        assert pickle.load(f)["tower"] == "random:0"
    rows = list(read_records(summary["db"]))
    assert len(rows) == 2
    for row, fid, is_ in zip(rows, summary["fid_values"], summary["is_values"]):
        assert row["fid_value"] == fid and row["is"] == is_
        assert math.isfinite(fid) and fid > 0 and math.isfinite(is_) and is_ > 1.0
        assert row["scoring_time"] > 0
    assert summary["tower_seconds"] > 0 and summary["fid_seconds"] > 0
    n_roots = len(roots)

    # The JAX CLI's scoring on the same samples, with the port's random tower
    # carried over by the JAX converter.
    port_tower = load_inception(None, device="cpu")
    variables = jax.tree_util.tree_map(jnp.asarray, convert_torch_state_dict(
        {k: v.numpy() for k, v in port_tower.state_dict().items()}))
    extract = jax_make_feature_fn(JaxInceptionV3(), variables, batch_size=256)
    ref_images = create_dataset(DATASET).images[:2048] / 2.0 + 0.5
    samples = summary["samples"].transpose(0, 1, 3, 4, 2)  # (M, n, H, W, C)
    m, n = samples.shape[:2]
    # One pass over the reference images and the samples: one tower compile.
    all_feats, all_logits = extract(np.concatenate(
        [ref_images, samples.reshape((m * n,) + samples.shape[2:])]))
    ref_stats = jax_compute_feature_stats(all_feats[:len(ref_images)])
    feats, logits = all_feats[len(ref_images):], all_logits[len(ref_images):]
    assert len(scored) == m
    for i, (port_feats, port_stats) in enumerate(scored):
        want = np.asarray(feats[i * n:(i + 1) * n], np.float64)
        np.testing.assert_allclose(port_feats, want, rtol=SCORE_RTOL,
                                   atol=SCORE_RTOL * np.abs(want).max())
        for got_stat, want_stat in zip(port_stats, ref_stats):
            np.testing.assert_allclose(got_stat, want_stat, rtol=SCORE_RTOL,
                                       atol=SCORE_RTOL * np.abs(want_stat).max())
        assert summary["fid_values"][i] == jax_calculate_fid_from_features(
            port_feats, ref_stats=port_stats)
        want_is = jax_inception_score_from_logits(logits[i * n:(i + 1) * n])[0]
        assert summary["is_values"][i] == pytest.approx(want_is, rel=SCORE_RTOL)
    assert len(roots) == n_roots == m  # the JAX FIDs took the port's square roots
    for i in range(m):
        want_fid = jax_calculate_fid_from_features(feats[i * n:(i + 1) * n],
                                                   ref_stats=ref_stats)
        assert summary["fid_values"][i] == pytest.approx(want_fid, rel=SCORE_RTOL)


def test_train_ensemble_reruns_members_whose_rows_lack_the_score(tmp_path):
    """Under --no-save_ckpts the DB row is the completion record, but a row
    without the behavior a scored run asks for does not complete it."""
    argv = _ensemble_argv(tmp_path, "--no-save_ckpts")
    assert train_ensemble.main(argv)["seeds"] == [0, 1]
    scored = argv + ["--n_samples", "2", "--score", "is"]
    out = train_ensemble.main(scored)
    assert out["seeds"] == [0, 1] and out["skipped"] == []
    assert all(math.isfinite(v) for v in out["is_values"])
    assert train_ensemble.main(scored)["skipped"] == [0, 1]
    with pytest.raises(SystemExit, match="needs --n_samples > 0"):
        train_ensemble.main(argv + ["--score", "fid"])


def test_shapley_pipeline_on_the_inception_score(tmp_path):
    out = shapley_pipeline.main([
        "--dataset", DATASET, "--by_class", "--num_fit_subsets", "2",
        "--num_test_subsets", "2", "--training_steps", "2", "--batch_size", "8",
        "--behavior", "is", "--n_samples", "11", "--num_inference_steps", "2",
        "--chunk_size", "2", "--no-save_ckpts", "--outdir", str(tmp_path),
        "--device", "cpu"])
    rows = list(read_records(out["db"]))
    members = rows[:-1]
    assert len(members) == 2 + 2 + 2  # fit, test, the null and full anchors
    assert all(math.isfinite(r["is"]) and r["is"] >= 1.0 for r in members)
    assert all(r["fid_value"] is None for r in members)
    assert rows[-1]["behavior"] == "is"
    assert out["attrs"].shape == (10,) and np.isfinite(out["attrs"]).all()
    assert abs(out["attrs"].sum() - (out["v1"] - out["v0"])) <= 1e-6 * max(
        1.0, abs(out["v1"] - out["v0"]))
    seconds = out["seconds"]
    assert seconds["train"] > 0 and seconds["sample"] > 0 and seconds["tower"] > 0
    assert seconds["fid"] == 0.0
    assert not os.path.exists(tmp_path / "inception_ref_stats.pkl")


def _write_pngs(path, n, seed, size=8):
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(path, f"sample_{i:06d}.png"))


def test_calculate_global_scores_on_a_sample_dir(tmp_path):
    samples = tmp_path / "samples"
    _write_pngs(samples, 12, seed=0)
    db = tmp_path / "global.jsonl"
    row = calculate_global_scores.main([
        "--dataset", DATASET, "--sample_dir", str(samples), "--pr_extractor", "vgg16",
        "--pr_vgg_tiny", "--ref_stats", str(tmp_path / "ref.pkl"), "--db", str(db),
        "--outdir", str(tmp_path), "--device", "cpu"])
    (written,) = list(read_records(str(db)))
    assert written["fid_value"] == row["fid_value"] and row["samples"].shape == (12, 8, 8, 3)
    assert math.isfinite(row["fid_value"]) and row["fid_value"] > 0
    assert math.isfinite(row["is"]) and math.isfinite(row["is_std"])
    assert 0.0 <= row["precision"] <= 1.0 and 0.0 <= row["recall"] <= 1.0
    assert row["remaining_idx"] == [] and row["removed_idx"] == []
    with open(tmp_path / "ref.pkl", "rb") as f:
        assert pickle.load(f)["tower"] == "random:0"


def test_per_class_fid_matches_jax(tmp_path):
    """--per_class averages the FID of each class subdirectory against that
    class's reference images; the same features (a stand-in extractor of
    mean colours, so the 3-d FIDs are cheap) give the JAX CLI's value bit
    for bit."""
    for cls in ("0", "1", "7"):
        _write_pngs(tmp_path / cls, 5, seed=int(cls))

    def extract(images):
        images = np.asarray(images, np.float64)
        return images.mean(axis=(1, 2)) + images.std(axis=(1, 2)), None

    rng = np.random.default_rng(3)
    ref_by_class = {c: rng.uniform(0, 1, (6, 8, 8, 3)) for c in ("0", "1", "2", "3")}
    got = calculate_global_scores._per_class_fid(str(tmp_path), extract, ref_by_class)
    assert got == jax_cgs._per_class_fid(str(tmp_path), extract, ref_by_class, 256)
    with pytest.raises(SystemExit, match="no class subdirectories"):
        calculate_global_scores._per_class_fid(str(tmp_path), extract, {"9": None})


def test_evaluate_fid_between_two_png_dirs(tmp_path):
    _write_pngs(tmp_path / "gen", 10, seed=1)
    _write_pngs(tmp_path / "ref", 10, seed=2, size=12)
    db = tmp_path / "fid.jsonl"
    out = evaluate_fid.main(["--generated_dir", str(tmp_path / "gen"), "--reference_dir",
                             str(tmp_path / "ref"), "--db", str(db), "--device", "cpu"])
    assert math.isfinite(out["fid_value"]) and out["fid_value"] > 0
    assert math.isfinite(out["is"])
    (row,) = list(read_records(str(db)))
    assert row["fid_value"] == out["fid_value"] and row["generated_dir"] == str(tmp_path / "gen")
    with pytest.raises(SystemExit, match="need --reference_dir"):
        evaluate_fid.main(["--generated_dir", str(tmp_path / "gen"), "--device", "cpu"])
