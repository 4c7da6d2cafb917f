"""The port's optimizer, EMA and train step against the JAX package's, on the CPU.

The same numpy parameters and gradients go through optax (the JAX package's
`make_optimizer`) and the port's optimizer; the same weights, images,
timesteps and noise go through the JAX composition of the train step and
the port's `make_train_step`. JAX threefry draws cannot be reproduced in
torch, so the step's random inputs are injected on both sides.

Tolerances: optimizer and EMA in float32 on both sides, 3 steps: rtol 1e-6
on parameters (schedules, bias corrections and moments round in other
orders, about one ulp a step). The train step: atol 1e-5 on the loss; per
tensor, the change of the parameters and of the EMA over two Adam steps of lr
1e-3 agrees to 1% of its L2 norm. Adam moves a weight by
lr * mu_hat / (sqrt(nu_hat) + 1e-8), which for a gradient element near zero
turns float noise of the gradient into a visible share of lr, so single
elements are not compared; a wrong step (order, decay, bias correction,
sign) moves the norm by O(1). The gradients themselves are held in
test_torch_backward.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.training import state as jax_state
from group_attribution_for_diffusion_models_tpu.training.train import (
    diffusion_loss as jax_diffusion_loss,
)
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.diffusion import (
    antithetic_timesteps,
    make_schedule,
)
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.training import (
    TrainState,
    diffusion_loss,
    ema_decay_schedule,
    ema_update,
    make_optimizer,
    make_schedule_fn,
    make_train_step,
)
from test_torch_unet import _jax_params, _port_spec, _variant

SHAPES = [(3, 4), (5,), (2, 3, 2)]


def _params_and_grads(seed, steps, scale):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("kw", [
    dict(name="adam", lr=1e-3),
    dict(name="adam", lr=1e-3, grad_clip_norm=None),
    dict(name="adamw", lr=2e-3, weight_decay=0.1),
    dict(name="adam", lr=1e-3, maximize=True),
    dict(name="adam", lr=1e-3, warmup_steps=2),
    dict(name="adam", lr=1e-3, lr_schedule="cosine", total_steps=5),
    dict(name="adamw", lr=1e-3, lr_schedule="cosine", total_steps=6, warmup_steps=2,
         weight_decay=0.01),
])
@pytest.mark.parametrize("scale", [0.05, 3.0])  # global norm below and above the clip
def test_optimizer_matches_optax(kw, scale):
    params, grads = _params_and_grads(0, 3, scale)
    tx = jax_state.make_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    port = make_optimizer(**kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    state = port.init(tp)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        port.update([torch.from_numpy(x.copy()) for x in g], state, tp)
    for a, w in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert state.count == 3


@pytest.mark.parametrize("lr_schedule,total,warmup", [
    ("constant", 0, 0), ("constant", 0, 4), ("cosine", 10, 0), ("cosine", 10, 3)])
def test_schedule_matches_optax_including_step_zero(lr_schedule, total, warmup):
    """optax reads a schedule at the count before it increments: a warmup's
    first update has lr 0."""
    fn = make_schedule_fn(1e-3, lr_schedule, total, warmup)
    if lr_schedule == "constant":
        want = (optax.linear_schedule(0.0, 1e-3, warmup) if warmup
                else optax.constant_schedule(1e-3))
    else:
        want = optax.warmup_cosine_decay_schedule(
            0.0 if warmup else 1e-3, 1e-3, warmup, max(total, 1))
    for count in range(12):
        np.testing.assert_allclose(fn(count), np.float32(want(count)), rtol=1e-6, atol=0)
    if warmup:
        assert fn(0) == 0.0


def test_clip_has_no_epsilon():
    """optax scales by max_norm / ||g|| exactly (clip_grad_norm_ adds 1e-6)."""
    g = [torch.tensor([3.0, 4.0])]  # norm 5
    port = make_optimizer("adam", lr=1e-3, grad_clip_norm=1.0)
    norm = port.update(g, port.init([torch.zeros(2)]), [torch.zeros(2)])
    assert norm.item() == 5.0
    assert g[0].tolist() == [np.float32(3.0) / np.float32(5.0), np.float32(4.0) / np.float32(5.0)]


def test_unported_optimizers_raise():
    for name in ("adafactor", "adam8bit", "sgd"):
        with pytest.raises(ValueError, match=name):
            make_optimizer(name)


def test_ema_matches_jax():
    for step in (0, 1, 2, 9, 100, 10**6):
        assert ema_decay_schedule(step) == np.float32(
            jax_state.ema_decay_schedule(jnp.asarray(step, jnp.int32)))
    params, (g,) = _params_and_grads(1, 1, 1.0)
    decay = ema_decay_schedule(3)
    want = jax_state.ema_update([jnp.asarray(x) for x in params],
                                [jnp.asarray(x) for x in g], jnp.float32(decay))
    ema = [torch.from_numpy(x.copy()) for x in params]
    ema_update(ema, [torch.from_numpy(x) for x in g], decay)
    for a, w in zip(ema, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_antithetic_timesteps_mirror():
    gen = torch.Generator().manual_seed(0)
    for batch in (1, 2, 7, 64):
        t = antithetic_timesteps(gen, batch, 1000)
        half = batch // 2 + 1
        assert t.shape == (batch,) and t.dtype == torch.long
        assert ((t >= 0) & (t < 1000)).all()
        full = torch.cat([t, torch.zeros(2 * half - batch, dtype=torch.long)])
        mirrored = t[half:]
        assert torch.equal(mirrored, 999 - full[: len(mirrored)])
    again = antithetic_timesteps(torch.Generator().manual_seed(5), 9, 1000)
    assert torch.equal(again, antithetic_timesteps(torch.Generator().manual_seed(5), 9, 1000))


def test_train_step_matches_jax_composition():
    """Two steps: antithetic t and noise (injected), value and grad, clip,
    Adam, then the EMA with decay at step + 1, on both sides."""
    spec = _variant("synthetic_32x8")
    params = _jax_params(spec, 3)
    sched = JaxSchedulerSpec()
    jschedule = jax_make_schedule(sched)
    model = JaxUNet2D(spec)
    tx = jax_state.make_optimizer("adam", lr=1e-3)
    rng = np.random.default_rng(8)
    batches = [(rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32),
                rng.integers(0, 1000, 4).astype(np.int32),
                rng.standard_normal((4, 8, 8, 3)).astype(np.float32)) for _ in range(2)]

    @jax.jit
    def jax_step(state, images, t, noise):
        loss, grads = jax.value_and_grad(lambda p: jax_diffusion_loss(
            model.apply, p, jschedule, images, noise, t))(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        step = state.step + 1
        ema = jax_state.ema_update(state.ema_params, new_params,
                                   jax_state.ema_decay_schedule(step))
        return jax_state.TrainState(new_params, ema, opt_state, step), loss

    jstate = jax_state.TrainState.create(params, tx)
    port_model = UNet2D(_port_spec(spec))
    port_model.load_state_dict(params_from_jax(params))
    port_tx = make_optimizer("adam", lr=1e-3)
    state = TrainState.create(port_model, port_tx)
    step = make_train_step(port_tx, make_schedule(SchedulerSpec()), SchedulerSpec())
    for images, t, noise in batches:
        jstate, jloss = jax_step(jstate, *(jnp.asarray(a) for a in (images, t, noise)))
        metrics = step(state, torch.from_numpy(images).permute(0, 3, 1, 2),
                       timesteps=torch.from_numpy(t).long(),
                       noise=torch.from_numpy(noise).permute(0, 3, 1, 2))
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), atol=1e-5, rtol=0)
    assert state.step == 2 and state.opt_state.count == 2
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


def test_diffusion_loss_with_weights_matches_jax():
    """Per-example weights (masked ensembles): sum(w * mse_i) / max(sum(w), 1)."""
    spec = _variant("synthetic_32x8")
    params = _jax_params(spec, 4)
    rng = np.random.default_rng(10)
    images = rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    t = np.array([10, 500, 990], dtype=np.int32)
    model = UNet2D(_port_spec(spec))
    model.load_state_dict(params_from_jax(params))
    for w in (None, [1.0, 0.0, 1.0], [0.0, 0.0, 0.25]):
        want = jax_diffusion_loss(
            JaxUNet2D(spec).apply, params, jax_make_schedule(JaxSchedulerSpec()),
            jnp.asarray(images), jnp.asarray(noise), jnp.asarray(t),
            loss_weights=None if w is None else jnp.asarray(w))
        got = diffusion_loss(
            model, make_schedule(SchedulerSpec()), torch.from_numpy(images).permute(0, 3, 1, 2),
            torch.from_numpy(noise).permute(0, 3, 1, 2), torch.from_numpy(t).long(),
            None if w is None else torch.tensor(w))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-7)


def test_train_step_draws_from_the_generator():
    spec = _port_spec(_variant("synthetic_32x8"))
    tx = make_optimizer("adam", lr=1e-3)
    images = torch.rand(4, 3, 8, 8) * 2 - 1
    losses = []
    for seed in (0, 0, 1):
        model = UNet2D(spec)
        torch.manual_seed(0)
        model.load_state_dict(UNet2D(spec).state_dict())
        state = TrainState.create(model, tx)
        step = make_train_step(tx, make_schedule(SchedulerSpec()), SchedulerSpec())
        losses.append(step(state, images, torch.Generator().manual_seed(seed))["loss"].item())
    assert losses[0] == losses[1] != losses[2]
