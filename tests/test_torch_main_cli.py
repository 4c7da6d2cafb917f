"""The port's single-model trainer (`cli.main`) and what it is built on,
against the JAX package, on the CPU.

* The train step with the options `cli.main` passes (maximize for ga, a
  pruned spec, uniform timesteps without antithetic pairs, per-example loss
  weights, the EMA's max decay) against the JAX `make_train_step`, two steps
  on injected draws: the JAX step's own threefry draws, computed from its key
  the way it computes them. Tolerances as tests/test_torch_training.py's:
  atol 1e-5 on the loss; per tensor, the change of the parameters and of the
  EMA agrees to 1% of its L2 norm (Adam turns float noise of a gradient
  element near zero into a visible share of lr, so single elements are not
  compared).
* `batch_iterator`, `ArrayDataset.subset` / `num_classes` and
  `setup_removal` bit for bit.
* The CLI: its row and checkpoint meta against the JAX CLI's (keys; removal
  indices bit for bit), resume against an uninterrupted run (bit for bit on
  the CPU), ``--ckpt_freq 0``, prune_fine_tune's pruned spec and weights, the
  latent path on a tiny VQ config, and ``--profile_dir``, whose trace
  `utils.device_profile` reads and whose flag the row carries (the
  prompt-conditional path: tests/test_torch_cond_main.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import common as jax_common
from group_attribution_for_diffusion_models_tpu.cli import main as jax_main
from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.data import datasets as jax_datasets
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.training import state as jax_state
from group_attribution_for_diffusion_models_tpu.training.train import (
    make_train_step as jax_make_train_step,
)
from group_attribution_for_diffusion_models_tpu.utils import read_records as jax_read_records
from group_attribution_for_diffusion_models_tpu_torch.cli import main as main_cli
from group_attribution_for_diffusion_models_tpu_torch.cli import prune as prune_cli
from group_attribution_for_diffusion_models_tpu_torch.cli.common import setup_removal
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.data import (
    batch_iterator,
    create_dataset,
)
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.training import (
    TrainState,
    ema_decay_schedule,
    make_optimizer,
    make_train_step,
)
from group_attribution_for_diffusion_models_tpu_torch.utils import device_profile
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import (
    get_max_steps,
    load_checkpoint,
    load_meta,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import read_records
from test_torch_tti_cli import _fast
from test_torch_unet import _jax_params, _port_spec, _variant

DATASET = "synthetic_64x8"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_step_options_match_the_jax_step():
    """A JAX step compiles for about 8 s on a CPU, so the options share one case:
    gradient ascent (ga) on a pruned spec (prune_fine_tune) with uniform
    timesteps, per-example weights and a max decay that binds from step 1.
    The default step (retrain, gd) is held against the JAX composition in
    tests/test_torch_training.py."""
    tx_kw = {"maximize": True}
    step_kw = {"use_antithetic": False, "ema_max_decay": 0.05, "ema_power": 3.0}
    spec = dataclasses.replace(_variant("synthetic_32x8"),
                               pruned_channels={"down_1_res_0": 8, "up_0_res_1": 8})
    params = _jax_params(spec, 11)
    sched = JaxSchedulerSpec()
    model = JaxUNet2D(spec)
    tx = jax_state.make_optimizer("adam", lr=1e-3, **tx_kw)
    jax_step = jax.jit(jax_make_train_step(model.apply, tx, jax_make_schedule(sched), sched,
                                           **step_kw))
    jstate = jax_state.TrainState.create(params, tx)

    port_model = UNet2D(_port_spec(spec))
    port_model.load_state_dict(params_from_jax(params))
    port_tx = make_optimizer("adam", lr=1e-3, **tx_kw)
    state = TrainState.create(port_model, port_tx)
    step = make_train_step(port_tx, make_schedule(SchedulerSpec()), SchedulerSpec(), **step_kw)
    rng = np.random.default_rng(12)
    for i in range(2):
        images = rng.uniform(-1, 1, (6, 8, 8, 3)).astype(np.float32)
        weights = np.array([1.0, 0.0, 1.0, 0.5, 0.0, 1.0], np.float32)
        key = jax.random.PRNGKey(100 + i)
        # The JAX step's draws, from its key as it draws them.
        key_t, key_n = jax.random.split(key)
        t = jax.random.randint(key_t, (6,), 0, sched.num_train_timesteps)
        noise = jax.random.normal(key_n, images.shape, dtype=jnp.float32)
        jstate, jm = jax_step(jstate, jnp.asarray(images), key, loss_weights=jnp.asarray(weights))
        metrics = step(state, torch.from_numpy(images).permute(0, 3, 1, 2),
                       timesteps=torch.tensor(np.asarray(t)).long(),
                       noise=torch.tensor(np.asarray(noise)).permute(0, 3, 1, 2),
                       loss_weights=torch.from_numpy(weights))
        np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-4)
    start = params_from_jax(params)
    got_params, got_ema = state.state_dicts()
    for got, want in ((got_params, jstate.params), (got_ema, jstate.ema_params)):
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
        for n, w in want.items():
            if n.endswith("to_k.bias"):
                # Its gradient is zero in exact arithmetic (a key bias shifts
                # all of a query's scores alike), so Adam normalises noise.
                continue
            moved = w - start[n]
            err = torch.linalg.vector_norm(got[n] - start[n] - moved).item()
            assert err <= 1e-2 * torch.linalg.vector_norm(moved).item(), n


def test_ema_power_has_no_effect_without_warmup_as_in_jax():
    """The JAX step calls ema_decay_schedule(step, max_decay, False,
    inv_gamma, power): without warm-up, --ema_power and inv_gamma change
    nothing (ROADMAP C4). With warm-up both packages follow the power."""
    for step in (0, 1, 7, 500, 10**5):
        base = ema_decay_schedule(step)
        for power, inv_gamma in ((0.5, 1.0), (3.0, 2.0)):
            got = ema_decay_schedule(step, 0.9999, False, inv_gamma, power)
            assert got == base == np.float32(jax_state.ema_decay_schedule(
                jnp.asarray(step), 0.9999, False, inv_gamma, power))
            warm = ema_decay_schedule(step, 0.9999, True, inv_gamma, power)
            np.testing.assert_allclose(warm, np.float32(jax_state.ema_decay_schedule(
                jnp.asarray(step), 0.9999, True, inv_gamma, power)), rtol=1e-6)
        assert ema_decay_schedule(step, 0.5) == min(base, np.float32(0.5))
    assert ema_decay_schedule(50, 0.9999, True, 1.0, 0.5) != ema_decay_schedule(
        50, 0.9999, True, 1.0, 3.0)


@pytest.mark.parametrize("batch,drop", [(8, True), (10, True), (10, False)])
def test_batch_iterator_and_subset_match_jax(batch, drop):
    jax_ds = jax_datasets.create_dataset("synthetic_64x8_mix")
    ds = create_dataset("synthetic_64x8_mix")
    idx = np.random.default_rng(0).permutation(64)[:37]
    jax_sub, sub = jax_ds.subset(idx), ds.subset(idx)
    assert sub.num_classes == jax_sub.num_classes == 10
    np.testing.assert_array_equal(sub.images, jax_sub.images)
    want = jax_datasets.batch_iterator(jax_sub, batch, seed=5, drop_remainder=drop)
    got = batch_iterator(sub, batch, seed=5, drop_remainder=drop)
    for _ in range(12):  # several epochs
        (wi, wl), (gi, gl) = next(want), next(got)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("argv", [
    ["--removal_dist", "full"],
    ["--removal_dist", "shapley", "--removal_seed", "3"],
    ["--removal_dist", "shapley", "--removal_seed", "3", "--by_class"],
    ["--removal_dist", "datamodel", "--removal_seed", "2", "--datamodel_alpha", "0.3"],
    ["--removal_dist", "uniform_paired", "--removal_seed", "5", "--by_class"],
    ["--removal_dist", "loo", "--removal_idx", "7"],
    ["--removal_dist", "aoi", "--removal_idx", "3"],
])
def test_setup_removal_matches_jax(argv):
    argv = ["--dataset", "synthetic_64x8_mix"] + argv
    ds = create_dataset("synthetic_64x8_mix")
    want = jax_common.setup_removal(jax_main.parse_args(argv), ds)
    got = setup_removal(main_cli.parse_args(argv), ds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _main(outdir, *extra, steps=2):
    return main_cli.main(["--dataset", DATASET, "--outdir", outdir, "--training_steps",
                          str(steps), "--log_freq", "1", "--device", "cpu", *extra])


def _no_step(apply_fn, tx, *args, **kwargs):
    """A JAX train step that leaves the state as it is (the row and the meta
    depend on no weight; the real step compiles for about 8 s)."""
    def step(state, images, key, encoder_hidden_states=None):
        return state, {"loss": jnp.zeros(()), "grad_norm": jnp.zeros(())}
    return step


def test_row_and_meta_have_the_jax_keys(tmp_path, monkeypatch):
    """The JAX CLI runs with its flax init swapped for drawn parameters and a
    step that changes nothing, which leave its row and meta as they are."""
    monkeypatch.setattr(jax_main, "UNet2D", _fast(JaxUNet2D, 21))
    monkeypatch.setattr(jax_main, "make_train_step", _no_step)
    argv = ["--dataset", DATASET, "--method", "ga", "--removal_dist", "shapley",
            "--removal_seed", "1", "--training_steps", "1", "--sample_freq", "0"]
    jax_main.main(argv + ["--outdir", str(tmp_path / "jax")])
    out = main_cli.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    (want,) = list(jax_read_records(str(tmp_path / "jax" / f"{DATASET}_train_db.jsonl")))
    (got,) = list(read_records(out["db"]))
    assert set(got) - {"device"} == set(want)
    assert got["remaining_idx"] == want["remaining_idx"]
    assert got["removed_idx"] == want["removed_idx"] and len(got["removed_idx"]) > 0
    jax_dir = os.path.join(str(tmp_path / "jax"), DATASET, "ga", "models", "shapley",
                           "shapley_seed=1")
    assert os.path.relpath(out["model_dir"], str(tmp_path / "port")) == os.path.relpath(
        jax_dir, str(tmp_path / "jax"))
    with open(os.path.join(jax_dir, "ckpt_steps_00000001", "meta.json")) as f:
        jax_meta = json.load(f)
    meta = load_meta(out["model_dir"])
    assert set(meta) == set(jax_meta)
    assert meta["unet_spec"] == jax_meta["unet_spec"]
    for name in ("remaining_idx", "removed_idx"):
        np.testing.assert_array_equal(np.load(os.path.join(out["model_dir"], f"{name}.npy")),
                                      np.load(os.path.join(jax_dir, f"{name}.npy")))


def test_resume_gives_the_uninterrupted_run(tmp_path):
    """Parameters, EMA, Adam's moments, step and the batch order carry over:
    a run stopped at step 2 and resumed to 5 ends bit for bit where one
    uninterrupted run of 5 ends (the JAX CLI restarts the batch order on
    resume; ROADMAP C4). A complete run's second call writes no row."""
    whole = _main(str(tmp_path / "a"), "--ckpt_freq", "2", steps=5)
    first = _main(str(tmp_path / "b"), steps=2)
    resumed = _main(str(tmp_path / "b"), steps=5)
    assert (first["resumed"], resumed["resumed"], resumed["start_step"]) == (False, True, 2)
    a, b = load_checkpoint(whole["model_dir"]), load_checkpoint(resumed["model_dir"])
    assert a["step"] == b["step"] == 5 and b["opt_state"]["count"] == 5
    for key in ("params", "ema_params"):
        for n, w in a[key].items():
            assert torch.equal(b[key][n], w), (key, n)
    for w, g in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                    b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert torch.equal(g, w)
    rows = list(read_records(resumed["db"]))
    assert len(rows) == 2 and rows[1]["total_steps_time"] > rows[0]["total_steps_time"]
    again = _main(str(tmp_path / "b"), steps=5)
    assert again["resumed"] and again["steps_run"] == 0 and again["row"] is None
    assert len(list(read_records(resumed["db"]))) == 2


def test_a_corrupted_checkpoint_is_wiped_and_the_run_starts_afresh(tmp_path):
    first = _main(str(tmp_path), steps=1)
    with open(os.path.join(first["model_dir"], "ckpt_steps_00000001", "state.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    again = _main(str(tmp_path), steps=1)
    assert not again["resumed"] and get_max_steps(again["model_dir"]) == 1


def test_ckpt_freq_zero_still_writes_the_final_checkpoint(tmp_path):
    out = _main(str(tmp_path), "--ckpt_freq", "0", "--sample_freq", "0", steps=3)
    names = sorted(n for n in os.listdir(out["model_dir"]) if n.startswith("ckpt_steps_"))
    assert names == ["ckpt_steps_00000003"]
    assert not os.path.exists(os.path.join(out["model_dir"], "samples"))


@pytest.mark.parametrize("flag", [False, True])
def test_prune_fine_tune_takes_the_pruned_spec_and_weights(tmp_path, flag):
    """From the default ``<outdir>/<dataset>/prune/models/full`` or
    ``--pruned_model_dir``: the pruned spec, and the pruned weights as the
    start point (the JAX CLI loads them only with the flag; ROADMAP C4): one
    Adam step of lr 1e-3 moves no weight further than lr."""
    outdir = str(tmp_path)
    full = _main(outdir, "--ckpt_freq", "0")
    pruned = prune_cli.main(["--dataset", DATASET, "--load", full["model_dir"],
                             "--pruner", "magnitude", "--pruning_ratio", "0.5",
                             "--outdir", outdir, "--device", "cpu"])
    extra = ["--pruned_model_dir", pruned["model_dir"]] if flag else []
    out = _main(outdir, "--method", "prune_fine_tune", *extra, steps=1)
    assert out["spec"] == pruned["spec"] and out["spec"].pruned_channels
    start = load_checkpoint(pruned["model_dir"])["params"]
    got = load_checkpoint(out["model_dir"])["params"]
    assert max((got[n] - w).abs().max().item() for n, w in start.items()) <= 1.01e-3


def test_latent_path_on_a_tiny_vq_config(tmp_path):
    """synthetic_64x16_ldm: the U-Net trains on 4x4 VQ latents, the encoded
    dataset is cached with its tag, and the EMA sample grid is decoded to the
    VQ-VAE's 16x16."""
    from PIL import Image

    out = main_cli.main(["--dataset", "synthetic_64x16_ldm", "--outdir", str(tmp_path),
                         "--training_steps", "2", "--sample_freq", "2",
                         "--n_inference_samples", "2", "--device", "cpu"])
    assert out["spec"].sample_size == 4
    cache = os.path.join(str(tmp_path), "synthetic_64x16_ldm", "precomputed_emb",
                         "vqvae_latents")
    assert np.load(cache + ".npy").shape == (64, 4, 4, 3)
    with open(cache + ".tag.json") as f:
        assert json.load(f)["dataset"] == "synthetic_64x16_ldm"
    grid = np.asarray(Image.open(os.path.join(out["model_dir"], "samples",
                                              "steps_00000002.png")))
    assert grid.shape == (16, 32, 3)


def test_profile_dir_writes_a_trace_and_rows_carry_it(tmp_path):
    """--profile_dir traces the loop into one Chrome trace that
    `device_profile.parse_trace_dir` reads (on the CPU its ops, the U-Net's
    convolutions among them), and the row carries the flag, as the JAX
    CLI's rows do."""
    prof_dir = str(tmp_path / "prof")
    out = main_cli.main(["--dataset", DATASET, "--training_steps", "2", "--sample_freq", "0",
                         "--profile_dir", prof_dir, "--outdir", str(tmp_path),
                         "--device", "cpu"])
    assert out["row"]["profile_dir"] == prof_dir
    (row,) = list(read_records(out["db"]))
    assert row["profile_dir"] == prof_dir
    assert len(device_profile.trace_files(prof_dir)) == 1
    prof = device_profile.parse_trace_dir(prof_dir)
    assert prof.by_category["convolution"] > 0
    assert 0 < prof.device_total_us <= prof.wall_us
    assert any(r.gflops for r in prof.ops if r.category == "convolution")
