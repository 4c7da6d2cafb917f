"""The port's local-behavior CLIs (``calculate_local_scores``,
``calculate_local_loss``) and ``group_distribution`` against the JAX
package, on the CPU.

- ``calculate_local_scores``: the paired samples of a full and a removal
  model (EMA weights, DDIM from one initial noise, the JAX sampler's own
  draw injected into the port), their per-image MSE, NRMSE and SSIM, and
  the removal model's diffusion loss on the full model's samples (the JAX
  CLI's timestep and noise draws injected), against the same computation
  built from the JAX package's functions as the JAX CLI builds it; on a
  pixel workload and on a latent one, whose samples are VQ-decoded and
  re-encoded to latents times the scaling factor (one VQ weights file for
  both packages).
- ``calculate_local_loss``: the per-step MSE and SSIM of the two models'
  clipped x0-hat along their paired trajectories (decoded on the latent
  workload), the same way.
- Both CLIs' rows against the JAX CLIs' rows on the same drawn checkpoints:
  the key sets (the port adds ``device``) and the removal model's indices.
- ``group_distribution``: the table and the JSON file equal the JAX CLI's,
  grouped by a filenames CSV and by a dataset's labels.

Tolerances: samples within 1e-4 (the f32 U-Nets of both packages, 3 DDIM
steps; tests/test_torch_ldm.py's decode tolerance); metrics and losses
within 1e-4 relative (plus 1e-7 absolute for an MSE near 0).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import calculate_local_loss as jax_local_loss
from group_attribution_for_diffusion_models_tpu.cli import (
    calculate_local_scores as jax_local_scores,
)
from group_attribution_for_diffusion_models_tpu.cli import group_distribution as jax_group_dist
from group_attribution_for_diffusion_models_tpu.cli.common import config_for as jax_config_for
from group_attribution_for_diffusion_models_tpu.diffusion import add_noise as jax_add_noise
from group_attribution_for_diffusion_models_tpu.diffusion import make_schedule as jax_make_schedule
from group_attribution_for_diffusion_models_tpu.diffusion import (
    pred_original_sample as jax_pred_original_sample,
)
from group_attribution_for_diffusion_models_tpu.diffusion.sampling import (
    make_sampler as jax_make_sampler,
)
from group_attribution_for_diffusion_models_tpu.diffusion.sampling import (
    sample_with_trajectory as jax_sample_with_trajectory,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.models import vqvae as jax_vqvae
from group_attribution_for_diffusion_models_tpu.training import state as jax_state
from group_attribution_for_diffusion_models_tpu.utils import image_metrics as jax_metrics
from group_attribution_for_diffusion_models_tpu.utils.ckpt import (
    save_checkpoint as jax_save_checkpoint,
)
from group_attribution_for_diffusion_models_tpu.utils.jsonl import read_records as jax_read_records
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    calculate_local_loss,
    calculate_local_scores,
    group_distribution,
)
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import (
    load_vqvae,
    make_vq_decode_fn,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import read_records
from test_torch_ldm import _jax_vq_params
from test_torch_tti_cli import _fast
from test_torch_unet import _jax_params, _port_spec

SAMPLE_ATOL = 1e-4
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-7
B, STEPS, NOISES, SEED = 3, 3, 2, 42
WORKLOADS = ["synthetic_64x8", "synthetic_64x16_ldm"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workloads(tmp_path_factory):
    """Per workload: the drawn params (full: params, ema; removal: params,
    ema), the port's U-Nets carrying them, the VQ weights file (latent)."""
    root = tmp_path_factory.mktemp("local")
    out = {}
    for i, name in enumerate(WORKLOADS):
        spec = jax_config_for(name).unet
        params = [_jax_params(spec, 20 + 4 * i + j) for j in range(4)]
        models = []
        for p in params:
            m = UNet2D(_port_spec(spec))
            m.load_state_dict(params_from_jax(p))
            models.append(m.eval())
        vq_path = None
        if jax_config_for(name).vqvae is not None:
            vq_path = str(root / f"{name}_vq.npy")
            np.save(vq_path, _jax_vq_params(30 + i), allow_pickle=True)
        out[name] = {"spec": spec, "params": params, "models": models, "vq": vq_path}
    return out


def _nchw(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).permute(0, 3, 1, 2)


def _jax_decode(name, vq_path):
    """The JAX CLIs' decode on device arrays (ROADMAP C3: the JAX loader's
    numpy codebook cannot be indexed under jit), and the VQ model."""
    if vq_path is None:
        return None, None, None
    vqvae = jax_vqvae.VQVAE(jax_config_for(name).vqvae)
    variables = {"params": jax.tree_util.tree_map(
        jnp.asarray, np.load(vq_path, allow_pickle=True).item())}
    scale = jax_config_for(name).vqvae.scaling_factor
    return (lambda z: vqvae.apply(variables, z / scale, method=vqvae.decode)), vqvae, variables


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=METRIC_RTOL, atol=METRIC_ATOL)


@pytest.mark.parametrize("name", WORKLOADS)
def test_local_scores_match_the_jax_cli_computation(workloads, name):
    w = workloads[name]
    spec, (_, ema_full, p_rem, ema_rem) = w["spec"], w["params"]
    cfg, jcfg = config_for(name), jax_config_for(name)
    decode, vqvae, vq_vars = _jax_decode(name, w["vq"])
    shape = (B, spec.sample_size, spec.sample_size, spec.in_channels)
    key = jax.random.PRNGKey(SEED)
    apply = JaxUNet2D(spec).apply
    samplers = [jax.jit(jax_make_sampler(apply, jcfg.scheduler, shape, num_inference_steps=STEPS,
                                         kind="ddim", decode_fn=decode))] * 2
    want_full, want_rem = (np.asarray(s(p, key)) for s, p in zip(samplers, (ema_full, ema_rem)))
    want = {k: np.asarray(f(want_full, want_rem))
            for k, f in (("mse", jax_metrics.mse), ("nrmse", jax_metrics.nrmse),
                         ("ssim", jax_metrics.ssim))}
    x = jnp.asarray(want_full) * 2.0 - 1.0
    if vqvae is not None:
        x = vqvae.apply(vq_vars, x, method=vqvae.encode) * jcfg.vqvae.scaling_factor
    schedule = jax_make_schedule(jcfg.scheduler)
    draws, losses = [], []
    for i in range(NOISES):  # the JAX CLI's diff_loss draws
        k_t, k_n = jax.random.split(jax.random.fold_in(key, i))
        t = jax.random.randint(k_t, (x.shape[0],), 0, jcfg.scheduler.num_train_timesteps)
        noise = jax.random.normal(k_n, x.shape)
        eps = apply({"params": p_rem}, jax_add_noise(schedule, x, noise, t), t)
        losses.append(np.asarray(jnp.mean((eps - noise) ** 2, axis=(1, 2, 3))))
        draws.append((torch.from_numpy(np.asarray(t, np.int64)), _nchw(noise)))
    want["loss"] = np.mean(losses, axis=0)

    _, full_ema, rem, rem_ema = w["models"]
    init_noise = _nchw(jax.random.normal(jax.random.split(key)[0], shape, dtype=jnp.float32))
    decode_fn = None if w["vq"] is None else make_vq_decode_fn(cfg.vqvae, w["vq"], device="cpu")
    got_full, got_rem = calculate_local_scores.paired_samples(
        full_ema, rem_ema, cfg, init_noise, STEPS, decode_fn)
    np.testing.assert_allclose(got_full.numpy(), want_full, atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(got_rem.numpy(), want_rem, atol=SAMPLE_ATOL, rtol=0)
    # The metrics on the JAX samples, so sampling noise does not enter them.
    jf, jr = torch.from_numpy(want_full), torch.from_numpy(want_rem)
    for k, f in (("mse", calculate_local_scores.mse), ("nrmse", calculate_local_scores.nrmse),
                 ("ssim", calculate_local_scores.ssim)):
        _close(f(jf, jr).numpy(), want[k])
    x_port = jf.permute(0, 3, 1, 2) * 2.0 - 1.0
    if w["vq"] is not None:
        with torch.no_grad():
            x_port = load_vqvae(cfg.vqvae, w["vq"], device="cpu").encode(x_port) * (
                cfg.vqvae.scaling_factor)
        _close(x_port.permute(0, 2, 3, 1).numpy(), np.asarray(x))
    got_loss = calculate_local_scores.removal_loss(rem, make_schedule(cfg.scheduler), x_port,
                                                   draws)
    _close(got_loss.numpy(), want["loss"])


@pytest.mark.parametrize("name", WORKLOADS)
def test_local_loss_matches_the_jax_cli_computation(workloads, name):
    w = workloads[name]
    spec, (_, ema_full, _, ema_rem) = w["spec"], w["params"]
    cfg, jcfg = config_for(name), jax_config_for(name)
    decode, _, _ = _jax_decode(name, w["vq"])
    shape = (B, spec.sample_size, spec.sample_size, spec.in_channels)
    key = jax.random.PRNGKey(SEED)
    apply = JaxUNet2D(spec).apply
    schedule = jax_make_schedule(jcfg.scheduler)
    run = jax.jit(lambda p: jax_sample_with_trajectory(
        apply, p, schedule, jcfg.scheduler, shape, key, num_inference_steps=STEPS))
    (_, traj_f, ts), (_, traj_r, _) = run(ema_full), run(ema_rem)

    @jax.jit
    def step_metrics(x_f, x_r, t):  # the JAX CLI's step_metrics
        t_b = jnp.full((shape[0],), t, jnp.int32)
        x0 = []
        for p, x in ((ema_full, x_f), (ema_rem, x_r)):
            est = jax_pred_original_sample(schedule, apply({"params": p}, x, t_b), t_b, x)
            if decode is not None:
                est = decode(est)
            x0.append(jnp.clip(est / 2 + 0.5, 0, 1))
        return jnp.mean(jax_metrics.mse(*x0)), jnp.mean(jax_metrics.ssim(*x0))

    want = [step_metrics(traj_f[i], traj_r[i], int(t)) for i, t in enumerate(np.asarray(ts))]
    init_noise = _nchw(jax.random.normal(jax.random.split(key)[0], shape, dtype=jnp.float32))
    decode_fn = None if w["vq"] is None else make_vq_decode_fn(cfg.vqvae, w["vq"], device="cpu")
    got_ts, got_mse, got_ssim = calculate_local_loss.per_step_metrics(
        w["models"][1], w["models"][3], cfg, init_noise, STEPS, decode_fn)
    np.testing.assert_array_equal(got_ts, np.asarray(ts))
    assert len(got_mse) == len(got_ssim) == STEPS
    _close(got_mse, [float(m) for m, _ in want])
    _close(got_ssim, [float(s) for _, s in want])


@pytest.fixture(scope="module")
def checkpoints(workloads, tmp_path_factory):
    """The pixel workload's full and removal models saved by both packages,
    the removal one with its indices."""
    root = tmp_path_factory.mktemp("local_ckpts")
    w = workloads["synthetic_64x8"]
    spec, params = w["spec"], w["params"]
    remaining, removed = np.arange(0, 64, 2), np.arange(1, 64, 2)
    dirs = {}
    tx = jax_state.make_optimizer("adam", lr=1e-4)
    for label, (p, ema), idx in (("full", params[:2], (None, None)),
                                 ("removal", params[2:], (remaining, removed))):
        state = jax_state.TrainState.create(p, tx).replace(
            ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
        jax_save_checkpoint(str(root / f"jax_{label}"), 1, state, *idx, unet_spec=spec)
        save_checkpoint(str(root / f"port_{label}"), 1, params_from_jax(p),
                        params_from_jax(ema), *idx, unet_spec=_port_spec(spec))
        dirs[label] = {"jax": str(root / f"jax_{label}"), "port": str(root / f"port_{label}")}
    return root, dirs, remaining, removed


@pytest.mark.parametrize("cli", ["scores", "loss"])
def test_cli_rows_have_the_jax_keys(checkpoints, cli, monkeypatch):
    root, dirs, remaining, removed = checkpoints
    jax_cli, port_cli = {"scores": (jax_local_scores, calculate_local_scores),
                         "loss": (jax_local_loss, calculate_local_loss)}[cli]
    monkeypatch.setattr(jax_cli, "UNet2D", _fast(JaxUNet2D, 5))
    # The JAX samplers stubbed (the rows' keys and indices are held here; the
    # numbers by the tests above): no DDIM loop is compiled.
    if cli == "scores":
        monkeypatch.setattr(jax_cli, "make_sampler", lambda apply, spec, shape, **k: (
            lambda params, key: jnp.zeros(shape)))
    else:
        monkeypatch.setattr(jax_cli, "sample_with_trajectory", lambda apply, params, sched,
                            spec, shape, key, num_inference_steps: (
            jnp.zeros(shape), jnp.zeros((num_inference_steps, *shape)),
            jnp.arange(num_inference_steps)))
    argv = ["--dataset", "synthetic_64x8", "--n_samples", "2", "--num_inference_steps", "2",
            "--outdir", str(root / cli)]
    extra = ["--n_noises", "2"] if cli == "scores" else []

    def run(cli_main, pkg, *more):
        cli_main(argv + extra + ["--full_model_dir", dirs["full"][pkg], "--removal_model_dir",
                                 dirs["removal"][pkg], "--db", str(root / cli / f"{pkg}.jsonl"),
                                 *more])

    run(jax_cli.main, "jax")
    run(port_cli.main, "port", "--device", "cpu")
    (want,) = list(jax_read_records(str(root / cli / "jax.jsonl")))
    (got,) = list(read_records(str(root / cli / "port.jsonl")))
    assert set(got) - {"device"} == set(want)
    assert got["remaining_idx"] == want["remaining_idx"] == remaining.tolist()
    assert got["removed_idx"] == want["removed_idx"] == removed.tolist()
    if cli == "loss":
        assert len(got["timesteps"]) == len(want["timesteps"]) == len(got["per_step_mse"]) == 2
    else:
        assert all(np.isfinite(got[k]) for k in got if k.startswith(("avg_", "generated_")))
    default = port_cli.main(argv + extra + ["--full_model_dir", dirs["full"]["port"],
                                            "--removal_model_dir", dirs["removal"]["port"],
                                            "--device", "cpu"])
    name = "local_db" if cli == "scores" else "local_loss_db"
    assert default["db"] == os.path.join(str(root / cli), f"synthetic_64x8_{name}.jsonl")


def test_group_distribution_matches_the_jax_cli(tmp_path):
    rng = np.random.default_rng(4)
    files = [f"artist-{a}_title-{i}_19{i:02d}.jpg" for a in range(7) for i in range(a + 2)]
    csv = tmp_path / "style_filenames.csv"
    csv.write_text("filename\n" + "\n".join(files) + "\n")
    np.save(tmp_path / "s.npy", rng.standard_normal(len(files)))
    np.save(tmp_path / "d.npy", rng.standard_normal((64, 1)))
    for scores, group in (("s.npy", ["--filenames_csv", str(csv)]),
                          ("d.npy", ["--dataset", "synthetic_64x8"])):
        argv = ["--scores", str(tmp_path / scores), "--top", "2", *group]
        want = jax_group_dist.main(argv + ["--out", str(tmp_path / "jax.json")])
        got = group_distribution.main(argv + ["--out", str(tmp_path / "port.json")])
        assert got == want and len(got) in (7, 10)
        assert (tmp_path / "jax.json").read_text() == (tmp_path / "port.json").read_text()
    with pytest.raises(SystemExit, match="need --filenames_csv"):
        group_distribution.main(["--scores", str(tmp_path / "s.npy")])
    with pytest.raises(SystemExit, match="scores but"):
        group_distribution.main(["--scores", str(tmp_path / "d.npy"), "--filenames_csv",
                                 str(csv)])
    with open(tmp_path / "port.json") as f:
        rows = json.load(f)
    assert [r["median"] for r in rows] == sorted((r["median"] for r in rows), reverse=True)
