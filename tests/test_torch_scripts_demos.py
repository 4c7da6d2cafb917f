"""The demo and sweep twins of the experiment scripts, on the CPU.

Each `scripts/*_torch.sh` beside a JAX experiment script keeps that script's
knobs, defaults and CLI flags, with ``${DEVICE:+--device "$DEVICE"}`` added,
and runs end to end at smoke scale with ``DEVICE=cpu`` (`_twin_runner`
starts their Python processes from one pre-imported interpreter). Also the
fault the ground-truth protocol found on the card: the port's U-Net drew
torch's default initialisation, not the JAX package's.
"""

import json
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from group_attribution_for_diffusion_models_tpu.cli.common import config_for as jax_config_for
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.models import build_unet, params_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _twin_runner import TwinRunner  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "group_attribution_for_diffusion_models_tpu_torch"
JAX_PKG = "group_attribution_for_diffusion_models_tpu"
SMOKE = dict(DEVICE="cpu", FIT="2", TEST="2", STEPS="2")

# Every shell script the twins stand beside, and what a twin may write
# differently from it: the sketch table goes beside the run (the JAX run's
# is docs/), and a failing runtime report fails the sweep.
TWINS = {
    "refscale_attribution": [],
    "refscale_sparseft": [],
    "refscale_fid": [],
    "groundtruth_convergence_demo": [],
    "sketch_quality_realscale": [('docs/sketch_quality_realscale.json',
                                  '"$OUT/sketch_quality_realscale.json"')],
    "pixel_quality_demo": [],
    "latent_quality_demo": [],
    "pruning_ratio_sweep": [(" || true", "")],
}


def _read(name):
    with open(os.path.join(REPO, "scripts", name)) as f:
        return f.read()


def _knobs(text):
    return dict(re.findall(r"^(\w+)=\$\{\1:-([^}]*)\}", text, re.MULTILINE))


def _calls(text):
    """Every `python -m <module> <args>` line (continuations joined), the
    package named `PKG`, the twin's device knob dropped."""
    text = re.sub(r"\\\n\s*", " ", text).replace(f"PKG={PORT}", f"PKG={JAX_PKG}")
    text = text.replace(PORT, "PKG").replace(JAX_PKG, "PKG").replace("$PKG", "PKG")
    text = text.replace(' ${DEVICE:+--device "$DEVICE"}', "")
    return [" ".join(line.split()) for line in re.findall(r"python -m .*", text)]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_each_twin_keeps_the_jax_scripts_knobs_and_flags(name):
    jax_text, twin = _read(f"{name}.sh"), _read(f"{name}_torch.sh")
    for old, new in TWINS[name]:
        jax_text = jax_text.replace(old, new)
    assert "set -euxo pipefail" in twin
    assert _knobs(twin) == _knobs(jax_text) and _knobs(twin)
    assert _calls(twin) == _calls(jax_text) and _calls(twin)
    lines = re.sub(r"\\\n\s*", " ", twin).splitlines()
    calls = [line for line in lines if "python -m" in line]
    devices = [line for line in calls if '${DEVICE:+--device "$DEVICE"}' in line]
    # runtime_report reads rows only and has no --device.
    assert len(devices) == len(calls) - ("runtime_report" in twin)
    assert JAX_PKG + "." not in twin.replace(PORT, "")


@pytest.fixture(scope="module")
def runner():
    r = TwinRunner(REPO)
    yield r
    r.close()


def _run(runner, name, tmp_path, **env):
    proc = runner.run(f"scripts/{name}", dict(SMOKE, OUT=str(tmp_path), **env))
    assert proc.returncode == 0, proc.stderr[-3000:]
    commands = [line for line in proc.stderr.splitlines() if line.startswith("+ python")]
    assert commands and all(f" -m {PORT}.cli." in c for c in commands)
    return proc


def _rows(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_groundtruth_twin_enumerates_a_three_class_game(runner, tmp_path):
    dataset = "synthetic_64x8_c3_tpl_mix"
    proc = _run(runner, "groundtruth_convergence_demo_torch.sh", tmp_path, DATASET=dataset,
                CHUNK="7")
    rows = _rows(tmp_path / f"{dataset}_groundtruth_db.jsonl")
    assert len([r for r in rows if r.get("removal_dist") == "enum"]) == 7
    (summary,) = [r for r in rows if r.get("removal_dist") == "groundtruth_summary"]
    assert summary["num_enumerated"] == 7 and summary["args"]["device"] == "cpu"
    assert {(c["dist"], c["fit_subsets"]) for c in summary["convergence"]} == {
        (d, n) for d in ("shapley", "shapley_paired") for n in (10, 24, 50, 100, 200)}
    assert np.load(tmp_path / "shapley_groundtruth_exact.npy").shape == (3,)
    assert "ground-truth convergence" in proc.stdout


def test_pixel_quality_twin_runs_the_estimation_loop(runner, tmp_path):
    dataset = "synthetic_64x8_tpl_mix"
    proc = _run(runner, "pixel_quality_demo_torch.sh", tmp_path, DATASET=dataset)
    rows = _rows(tmp_path / f"{dataset}_pipeline_db.jsonl")
    assert {r.get("removal_dist") for r in rows} >= {"shapley_paired", "datamodel", "full"}
    assert "LDS =" in proc.stdout


def test_latent_quality_twin_trains_its_vqvae_then_the_latent_loop(runner, tmp_path):
    dataset = "synthetic_64x8_tpl_mix"
    proc = _run(runner, "latent_quality_demo_torch.sh", tmp_path, DATASET=dataset,
                VQ_STEPS="2")
    assert (tmp_path / "vqvae_weights.npy").exists()
    rows = _rows(tmp_path / f"{dataset}_ldm_pipeline_db.jsonl")
    assert any(r.get("removal_dist") == "datamodel" for r in rows)
    assert "LDS =" in proc.stdout


def test_refscale_fid_twin_scores_every_member_in_the_loop(runner, tmp_path):
    """FID of 2 samples a member against the reference stats. The runner's
    child takes scipy's sqrtm of the rank-1 product of covariances through its
    range (exact; O(n^2) where scipy's Schur route spends 20 s a 2048-d root
    on this CPU); the FID math itself is held in test_torch_global_scores.py."""
    dataset = "synthetic_64x8_tpl_mix"
    _run(runner, "refscale_fid_torch.sh", tmp_path, DATASET=dataset, NSAMP="2", INFER="2",
         TWIN_RUNNER_LOWRANK_SQRTM="1")
    rows = _rows(tmp_path / f"{dataset}_pipeline_db.jsonl")
    members = [r for r in rows if r.get("removal_dist") in ("shapley_paired", "datamodel")]
    assert len(members) == 4 and all(np.isfinite(r["fid_value"]) for r in members)
    (summary,) = [r for r in rows if r.get("exp_name") == "refscale_fid_pipeline"]
    assert summary["behavior"] == "fid_value"


def test_pruning_ratio_sweep_twin_reports_fidelity_and_runtime(runner, tmp_path):
    dataset = "synthetic_64x8_mix"
    proc = _run(runner, "pruning_ratio_sweep_torch.sh", tmp_path, DATASET=dataset, N="3",
                RATIOS="0.5", RETRAIN_STEPS="2", SFT_STEPS="2")
    ratio = tmp_path / "ratio_0.5"
    assert (ratio / dataset / "prune" / "models" / "full").is_dir()
    assert (ratio / "fidelity.txt").read_text().strip()
    assert "method=prune_fine_tune" in (ratio / "runtime.txt").read_text()
    assert "=== ratio 0.5 runtime ===" in proc.stdout


def test_sketch_twin_writes_its_table_beside_the_run(runner, tmp_path):
    """The script's fixed flags ask for 4096 JL columns of the `_big` U-Net's
    1.0M gradient coordinates at 10 timesteps for 64 generated and every
    train image, in 5 variants: 113 s alone on this CPU and 509 s beside the
    tier's other workers. So the child's gradient features are a seeded
    projection of the pixels to 64 columns (`_twin_runner`), as
    test_torch_sketch_quality.py stubs them; the features themselves are held
    in test_torch_trak.py and, on the card, in chip_smoke.py's [local]."""
    docs = open(os.path.join(REPO, "docs", "sketch_quality_realscale.json"), "rb").read()
    _run(runner, "sketch_quality_realscale_torch.sh", tmp_path,
         DATASET="synthetic_32x8_c4_tpl_mix_big", TWIN_RUNNER_FEATURE_WIDTH="64")
    table = json.loads((tmp_path / "sketch_quality_realscale.json").read_text())
    assert set(table["variants"]) == {"full", "attn_full", "probe_k16", "probe_k64",
                                      "probe_k256"}
    assert table["proj_dim"] == 4096 and table["num_timesteps"] == 10
    assert open(os.path.join(REPO, "docs", "sketch_quality_realscale.json"), "rb").read() == docs


def test_the_unet_starts_from_the_jax_packages_initialisation():
    """The ground-truth protocol's null model read 1.1037 on the card where
    the JAX run read 1.3241: `build_unet` drew torch's default init
    (kaiming-uniform kernels, std 1/sqrt(3 fan_in), uniform biases). It now
    draws flax's, as the JAX package does: every kernel lecun_normal (std
    1/sqrt(fan_in), truncated at 2 standard deviations), biases 0, norms at
    scale 1 and bias 0. Both packages' inits are held to that, tensor by
    tensor under the diffusers names, on the conditional U-Net (convolutions,
    dense layers, GroupNorm, LayerNorm, attention)."""
    dataset = "synthetic_32x8_cond"
    spec = jax_config_for(dataset).unet
    x = jnp.zeros((1, spec.sample_size, spec.sample_size, spec.in_channels))
    args = (x, jnp.zeros((1,), jnp.int32))
    if spec.cross_attention_dim:
        args += (jnp.zeros((1, 77, spec.cross_attention_dim)),)
    want = params_from_jax(JaxUNet2D(spec).init(jax.random.PRNGKey(0), *args)["params"])
    got = build_unet(config_for(dataset).unet, seed=0).state_dict()
    assert set(got) == set(want)
    ratios = []
    for key, w in got.items():
        j = want[key]
        if not np.any(j.numpy()):
            assert not w.any(), key
        elif np.all(j.numpy() == 1):
            assert bool((w == 1).all()), key
        else:
            fan_in = w[0].numel()
            limit = 2 / (0.87962566103423978 * math.sqrt(fan_in)) + 1e-6
            for t in (w, j):
                assert t.abs().max().item() <= limit, key
                if t.numel() >= 512:
                    ratios.append(t.std().item() * math.sqrt(fan_in))
    ratios = np.asarray(ratios).reshape(-1, 2)
    assert len(ratios) >= 5
    assert np.all((ratios > 0.85) & (ratios < 1.15)), ratios
    assert np.all(np.abs(ratios.mean(axis=0) - 1) < 0.03), ratios.mean(axis=0)

