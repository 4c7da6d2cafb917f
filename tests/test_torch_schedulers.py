"""The port's noise schedules and DDPM/DDIM steps against the JAX package's,
on the same numpy inputs. Betas and timesteps are built the same way on the
host and must agree exactly; the steps are float32 elementwise formulas on
tables a few ulps apart, held to 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.diffusion import schedulers as jsched
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.diffusion import schedulers as tsched

SPECS = [
    {},
    {"beta_schedule": "scaled_linear", "beta_start": 0.0015, "beta_end": 0.0195,
     "clip_sample": False},
    {"beta_schedule": "squaredcos_cap_v2", "variance_type": "fixed_small"},
    {"set_alpha_to_one": False, "prediction_type": "v_prediction"},
]


def _specs(kw):
    return JaxSchedulerSpec(**kw), SchedulerSpec(**kw)


@pytest.mark.parametrize("kw", SPECS)
def test_schedule_tables_equal(kw):
    jspec, tspec = _specs(kw)
    js = jsched.make_schedule(jspec)
    ts = tsched.make_schedule(tspec)
    for name in ("betas", "alphas"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    # XLA's cumprod associates in its own order: a few float32 ulps apart.
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod),
                               rtol=2e-6, atol=0)


@pytest.mark.parametrize("spacing,offset", [("leading", 0), ("leading", 1),
                                            ("trailing", 0), ("linspace", 0)])
def test_inference_timesteps_equal(spacing, offset):
    for n in (5, 50, 100):
        np.testing.assert_array_equal(
            tsched.inference_timesteps(1000, n, spacing, offset),
            jsched.inference_timesteps(1000, n, spacing, offset),
        )


def _step_inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    shape = (b, 8, 8, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    eps = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    t = np.array([999, 500, 10, 0][:b], dtype=np.int32)
    return x, eps, noise, t


@pytest.mark.parametrize("kw", SPECS)
def test_ddpm_step_matches(kw):
    jspec, tspec = _specs(kw)
    x, eps, noise, t = _step_inputs(0)
    want = jsched.ddpm_step(jsched.make_schedule(jspec), jspec, jnp.asarray(eps),
                            jnp.asarray(t), jnp.asarray(x), jnp.asarray(noise))
    got = tsched.ddpm_step(tsched.make_schedule(tspec), tspec, torch.from_numpy(eps),
                           torch.from_numpy(t).long(), torch.from_numpy(x),
                           torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_matches(kw, eta):
    jspec, tspec = _specs(kw)
    x, eps, noise, t = _step_inputs(1)
    t_prev = np.array([989, 490, 0, -1], dtype=np.int32)
    want = jsched.ddim_step(jsched.make_schedule(jspec), jspec, jnp.asarray(eps),
                            jnp.asarray(t), jnp.asarray(t_prev), jnp.asarray(x),
                            eta=eta, noise=jnp.asarray(noise))
    got = tsched.ddim_step(tsched.make_schedule(tspec), tspec, torch.from_numpy(eps),
                           torch.from_numpy(t).long(), torch.from_numpy(t_prev).long(),
                           torch.from_numpy(x), eta=eta, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_add_noise_matches():
    jspec, tspec = _specs({})
    x, eps, _, t = _step_inputs(2)
    want = jsched.add_noise(jsched.make_schedule(jspec), jnp.asarray(x), jnp.asarray(eps),
                            jnp.asarray(t))
    got = tsched.add_noise(tsched.make_schedule(tspec), torch.from_numpy(x),
                           torch.from_numpy(eps), torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_scheduler_spec_fields_equal():
    assert dataclasses.asdict(SchedulerSpec()) == dataclasses.asdict(JaxSchedulerSpec())
