"""The stacked ensemble (members in one launch) against the JAX package's, on
the CPU.

* One stacked step of 3 members, each with its own parameters (a gamma/beta
  of its own in every GroupNorm), against JAX `EnsembleTrainer.step`: the
  JAX step's own threefry draws (slots, antithetic timesteps, noise),
  computed from its key the way its `local_step` computes them, injected
  into the port. Two steps; the loss within 1e-5, and per member and tensor
  the change of the parameters and of the EMA within 1% of its L2 norm (the
  rule of tests/test_torch_training.py: Adam turns float noise of a
  gradient element near zero into a visible share of lr).
* `run_scanned` gives `run`'s states bit for bit, with chunks that do not
  divide the steps; under common noise identical subsets give bit-identical
  members; the stacked state round-trips through `stack_states` /
  `unstack_state`.
* `members_loss` is each member's `diffusion_loss`, with loss weights or
  without (within 1e-6 relative).
* The per-member clip: `Optimizer.update` of stacked gradients, one member's
  100x, against ``jax.vmap`` of the optax chain and against each member
  updated alone (float32, within 1e-6 relative).
* Remat (full, convs, convs_dots) under the stacked step gives the
  gradients and weights of no remat bit for bit after a step, as the JAX package's
  `test_remat_policy_matches_in_scanned_ensemble` asks of its scan.
* `cli.main --scan_chunk`: the per-step noise and timesteps of the per-step
  loop (the same generator seed a step), batches drawn with replacement
  from the subset on a stream of their own, checkpoints and tracker rows at
  the JAX CLI's scan-path steps (its flax init swapped by `_fast`, its step
  a no-op), and a run resumed at a chunk boundary ending bit for bit where
  an uninterrupted one ends.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import main as jax_main
from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    antithetic_timesteps as jax_antithetic_timesteps,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.parallel import ensemble as jax_ensemble
from group_attribution_for_diffusion_models_tpu.training import state as jax_state
from group_attribution_for_diffusion_models_tpu_torch.cli import main as main_cli
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.data import datasets, removal
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import (
    UNet2D,
    build_unet,
    params_from_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.parallel import ensemble
from group_attribution_for_diffusion_models_tpu_torch.training import (
    TrainState,
    diffusion_loss,
    init_ensemble_state,
    make_members_step,
    make_optimizer,
    members_loss,
    stack_states,
    unstack_state,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import load_checkpoint
from test_torch_main_cli import _no_step
from test_torch_tti_cli import _fast
from test_torch_unet import _jax_params, _port_spec, _variant

M, BATCH, SEED = 3, 4, 5
DATASET = "synthetic_64x8"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images_u8(n=32):
    ds = datasets.make_synthetic(n=n, size=8)
    return ((ds.images + 1.0) * 127.5).round().astype(np.uint8)


def _subsets():
    return [removal.sample_removal("shapley", 32, seed=s)[0] for s in range(M)]


def _trainer(member_indices, common_noise=False, batch=BATCH):
    sched = config_for("synthetic_32x8").scheduler
    return ensemble.EnsembleTrainer(
        tx=make_optimizer("adam", lr=1e-3), schedule=make_schedule(sched), spec=sched,
        images_u8=_images_u8(), member_indices=member_indices, batch_size=batch,
        device=torch.device("cpu"), common_noise=common_noise)


def _jax_draws(key, sizes, shape, num_train_timesteps):
    """The slots, timesteps and noise JAX `local_step` draws from `key`
    (common_noise off): per-member keys split from the step key, each split
    into a slot key and a step key; the step key into the timestep and noise
    keys, as the JAX `train_step` splits it."""
    keys = jax.random.split(key, len(sizes))
    member_keys = jax.vmap(jax.random.split)(keys)
    slots, ts, noises = [], [], []
    for m, size in enumerate(sizes):
        slots.append(np.asarray(jax.random.randint(member_keys[m, 0], (shape[0],), 0, size)))
        key_t, key_n = jax.random.split(member_keys[m, 1])
        ts.append(np.asarray(jax_antithetic_timesteps(key_t, shape[0], num_train_timesteps)))
        noises.append(np.asarray(jax.random.normal(key_n, shape, dtype=jnp.float32)))
    return np.stack(slots), np.stack(ts), np.stack(noises)


@pytest.fixture(scope="module")
def jax_two_steps():
    """Two JAX `EnsembleTrainer.step`s of 3 members with parameters drawn
    from seeds 30..32, and each step's draws; shared by the module."""
    spec = _variant("synthetic_32x8")
    params = [_jax_params(spec, 30 + m) for m in range(M)]
    tx = jax_state.make_optimizer("adam", lr=1e-3)
    trainer = jax_ensemble.EnsembleTrainer(
        apply_fn=JaxUNet2D(spec).apply, tx=tx, schedule=jax_make_schedule(JaxSchedulerSpec()),
        spec=JaxSchedulerSpec(), images_u8=_images_u8(), member_indices=_subsets(),
        batch_size=BATCH)
    state = jax_ensemble.stack_states([jax_state.TrainState.create(p, tx) for p in params])
    draws, losses = [], []
    sizes = [len(ix) for ix in _subsets()]
    for i in range(2):
        key = jax.random.PRNGKey(jax_ensemble._step_seed(SEED, i))
        draws.append(_jax_draws(key, sizes, (BATCH, 8, 8, 3), 1000))
        state, metrics = trainer.step(state, key)
        losses.append(np.asarray(metrics["loss"]))
    return spec, params, draws, np.stack(losses), jax.tree_util.tree_map(np.asarray, state)


def test_stacked_step_matches_the_jax_ensemble_step(jax_two_steps):
    spec, params, draws, jax_losses, jstate = jax_two_steps
    trainer = _trainer(_subsets())
    states = []
    for p in params:
        model = UNet2D(_port_spec(spec))
        model.load_state_dict(params_from_jax(p))
        states.append(TrainState.create(model, trainer.tx))
    stacked = stack_states(states)
    step = make_members_step(trainer.tx, trainer.schedule)
    for i, (slots, t, noise) in enumerate(draws):
        metrics = step(stacked, trainer.batch(torch.from_numpy(slots).long()),
                       torch.from_numpy(t).long(),
                       torch.from_numpy(np.ascontiguousarray(np.moveaxis(noise, -1, -3))))
        np.testing.assert_allclose(metrics["loss"].numpy(), jax_losses[i], atol=1e-5, rtol=0)
        assert metrics["grad_norm"].shape == (M,)
    assert stacked.step == 2 and stacked.opt_state.count == 2
    for m in range(M):
        start = params_from_jax(params[m])
        got_params, got_ema = unstack_state(stacked, m).state_dicts()
        for got, want in ((got_params, jstate.params), (got_ema, jstate.ema_params)):
            want = params_from_jax(jax.tree_util.tree_map(lambda a: a[m], want))
            for n, w in want.items():
                if n.endswith("to_k.bias"):
                    continue  # zero gradient in exact arithmetic (test_torch_training.py)
                moved = w - start[n]
                err = torch.linalg.vector_norm(got[n] - start[n] - moved).item()
                assert err <= 1e-2 * torch.linalg.vector_norm(moved).item(), (m, n)


def _flat(state):
    return torch.cat([p.detach().flatten() for p in state.params])


@pytest.mark.parametrize("common_noise", [False, True])
def test_run_scanned_gives_run_bitwise(common_noise):
    spec = config_for("synthetic_32x8").unet
    subsets = _subsets()
    subsets[2] = subsets[0]  # identical subsets
    trainer = _trainer(subsets, common_noise=common_noise)
    init = lambda s: build_unet(spec, s)  # noqa: E731
    a, last = trainer.run(trainer.init_state(init, seed=3), 5, seed=SEED)
    b, metrics = trainer.run_scanned(trainer.init_state(init, seed=3), 5, seed=SEED, chunk=2)
    assert metrics["loss"].shape == metrics["grad_norm"].shape == (5, M)
    assert torch.equal(metrics["loss"][-1], last["loss"])
    for x, y in ((a.params, b.params), (a.buffers, b.buffers)):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert all(torch.equal(x, y) for x, y in zip(a.ema + a.opt_state.mu + a.opt_state.nu,
                                                 b.ema + b.opt_state.mu + b.opt_state.nu))
    members = [unstack_state(b, m) for m in range(M)]
    same = torch.equal(_flat(members[0]), _flat(members[2]))
    assert same == common_noise  # own init and draws each without common noise
    assert not torch.equal(_flat(members[0]), _flat(members[1]))


def test_stack_unstack_round_trip_and_shared_init():
    spec = config_for("synthetic_32x8").unet
    tx = make_optimizer("adam", lr=1e-3)
    states = [TrainState.create(build_unet(spec, s), tx) for s in (1, 2)]
    stacked = stack_states(states)
    assert stacked.num_members == 2 and stacked.model.conv_in.weight.is_meta
    for m, s in enumerate(states):
        back = unstack_state(stacked, m)
        assert all(torch.equal(x, y) for x, y in zip(back.params, s.params))
        assert all(torch.equal(x, y) for x, y in zip(back.ema, s.ema))
    model = build_unet(spec, 7)
    shared = init_ensemble_state(model, tx, 3)
    assert all(torch.equal(v[2], dict(model.named_parameters())[k])
               for k, v in shared.params.items())
    seeded = init_ensemble_state(None, tx, 3, init_seeds=[4, 5, 4],
                                 init_fn=lambda s: build_unet(spec, s))
    assert all(torch.equal(v[0], v[2]) and not torch.equal(v[0], v[1])
               for k, v in seeded.params.items() if k.endswith("conv_in.weight"))
    with pytest.raises(ValueError, match="share their step"):
        states[1].step = 1
        stack_states(states)


@pytest.mark.parametrize("weighted", [False, True])
def test_members_loss_is_each_members_diffusion_loss(weighted):
    """`members_loss` of 3 stacked members against `diffusion_loss` of each
    member's module alone, with per-example loss weights or without (the
    same f32 ops on other batch shapes: within 1e-6 relative)."""
    spec = config_for("synthetic_32x8").unet
    models = [build_unet(spec, s) for s in range(M)]
    stacked = stack_states([TrainState.create(m, make_optimizer("adam")) for m in models])
    g = torch.Generator().manual_seed(9)
    images = torch.randn((M, BATCH, 3, 8, 8), generator=g)
    noise = torch.randn(images.shape, generator=g)
    t = torch.randint(0, 1000, (M, BATCH), generator=g)
    w = (torch.rand((M, BATCH), generator=g) > 0.3).float() if weighted else None
    schedule = make_schedule(config_for("synthetic_32x8").scheduler)
    got = members_loss(stacked.model, stacked.weights(), schedule, images, noise, t, w)
    want = torch.stack([diffusion_loss(models[m], schedule, images[m], noise[m], t[m],
                                       None if w is None else w[m]) for m in range(M)])
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=0)


def test_per_member_clip_matches_vmapped_optax():
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal((M,) + s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: 0.05 * rng.standard_normal((M,) + s).astype(np.float32)
             for k, s in shapes.items()}
    for g in grads.values():
        g[1] *= 100  # only member 1 passes the clip norm of 1
    tx = jax_state.make_optimizer("adam", lr=1e-3)
    opt = jax.jit(jax.vmap(tx.init))(params)
    updates, _ = jax.jit(jax.vmap(tx.update))(grads, opt, params)
    want = optax.apply_updates(params, updates)

    port_tx = make_optimizer("adam", lr=1e-3)
    names = list(shapes)
    p = [torch.from_numpy(params[k].copy()) for k in names]
    g = [torch.from_numpy(grads[k].copy()) for k in names]
    norm = port_tx.update(g, port_tx.init(p), p, members=M)
    flat = np.concatenate([grads[k].reshape(M, -1) for k in names], axis=1)
    np.testing.assert_allclose(norm.numpy(), np.linalg.norm(flat, axis=1), rtol=1e-6)
    assert norm[1] > 1 > norm[0] and norm[2] < 1
    for k, got in zip(names, p):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    for m in range(M):  # each member alone gives its own row
        pm = [torch.from_numpy(params[k][m].copy()) for k in names]
        gm = [torch.from_numpy(grads[k][m].copy()) for k in names]
        port_tx.update(gm, port_tx.init(pm), pm)
        for got, alone in zip(p, pm):
            np.testing.assert_allclose(got[m].numpy(), alone.numpy(), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def no_remat_run():
    return _remat_run(False, None)


def _remat_run(remat, policy):
    spec = config_for("synthetic_64x8_big").unet
    trainer = _trainer(_subsets()[:2], batch=4)
    stacked = trainer.init_state(
        lambda s: build_unet(spec, s, remat=remat, remat_policy=policy), seed=2)
    trainer.run(stacked, 1, seed=SEED)
    return stacked


@pytest.mark.parametrize("policy", [None, "convs", "convs_dots"])
def test_remat_under_the_stacked_step_matches_no_remat(no_remat_run, policy):
    got = _remat_run(True, policy)
    assert got.model.remat
    for k, w in no_remat_run.params.items():
        assert torch.equal(got.params[k], w), k
        assert torch.equal(got.params[k].grad, w.grad), k


def _main(outdir, *extra, steps):
    return main_cli.main(["--dataset", DATASET, "--outdir", outdir, "--training_steps",
                          str(steps), "--sample_freq", "0", "--device", "cpu", *extra])


def _spy_steps(monkeypatch):
    """Record each train step's generator seed and batch."""
    seen = []
    real = main_cli.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def spy(state, images, generator=None, **kw):
            seen.append((generator.initial_seed(), images.clone()))
            return step(state, images, generator, **kw)
        return spy

    monkeypatch.setattr(main_cli, "make_train_step", make)
    return seen


def test_scan_chunk_keeps_the_loops_draws_and_samples_the_subset(tmp_path, monkeypatch):
    seen = _spy_steps(monkeypatch)
    loop = _main(str(tmp_path / "loop"), "--log_freq", "5", steps=5)
    per_step = list(seen)
    seen.clear()
    scan = _main(str(tmp_path / "scan"), "--log_freq", "5", "--scan_chunk", "2", steps=5)
    seeds = [s for s, _ in seen]
    assert seeds == [s for s, _ in per_step]  # timesteps and noise: the loop's streams
    assert seeds == [(42 * 1_000_003 + i) % (1 << 32) for i in range(5)]  # the JAX CLI's keys
    subset = torch.from_numpy(_subset_images(scan["row"]["remaining_idx"])).permute(0, 3, 1, 2)
    for (_, images), (_, loop_images) in zip(seen, per_step):
        assert images.shape == loop_images.shape
        assert all(any(torch.equal(x, y) for y in subset) for x in images)
    assert not all(torch.equal(a, b) for (_, a), (_, b) in zip(seen, per_step))
    assert np.isfinite(scan["loss"]) and loop["row"].keys() == scan["row"].keys()


def _subset_images(remaining_idx):
    """The dataset's images (N, H, W, C) at `remaining_idx`."""
    return datasets.create_dataset(DATASET).images[np.asarray(remaining_idx)]


def _ckpt_steps(model_dir):
    return sorted(int(os.path.basename(d).split("_")[-1])
                  for d in glob.glob(os.path.join(model_dir, "ckpt_steps_*")))


def _logged_steps(outdir):
    (path,) = glob.glob(os.path.join(outdir, "logs", "*.jsonl"))
    with open(path) as f:
        return [r["step"] for r in map(json.loads, f) if "step" in r]


def test_scan_chunk_boundaries_match_the_jax_scan_path(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_main, "UNet2D", _fast(JaxUNet2D, 21))
    monkeypatch.setattr(jax_main, "make_train_step", _no_step)
    argv = ["--dataset", DATASET, "--training_steps", "7", "--scan_chunk", "3",
            "--ckpt_freq", "4", "--log_freq", "5", "--sample_freq", "0", "--tracker", "jsonl",
            "--keep_all_ckpts"]
    jax_main.main(argv + ["--outdir", str(tmp_path / "jax")])
    out = main_cli.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    jax_dir = os.path.join(str(tmp_path / "jax"), os.path.relpath(out["model_dir"],
                                                                  str(tmp_path / "port")))
    assert _ckpt_steps(out["model_dir"]) == _ckpt_steps(jax_dir)
    assert _logged_steps(str(tmp_path / "port")) == _logged_steps(str(tmp_path / "jax"))
    assert _logged_steps(str(tmp_path / "port")) == [5, 7]


def test_scan_chunk_resumed_at_a_chunk_boundary_gives_the_uninterrupted_run(tmp_path):
    whole = _main(str(tmp_path / "a"), "--scan_chunk", "4", "--ckpt_freq", "2",
                  "--log_freq", "2", steps=6)
    first = _main(str(tmp_path / "b"), "--scan_chunk", "4", "--log_freq", "2", steps=4)
    resumed = _main(str(tmp_path / "b"), "--scan_chunk", "4", "--log_freq", "2", steps=6)
    assert (first["resumed"], resumed["resumed"], resumed["start_step"]) == (False, True, 4)
    a, b = load_checkpoint(whole["model_dir"]), load_checkpoint(resumed["model_dir"])
    assert a["step"] == b["step"] == 6 and b["opt_state"]["count"] == 6
    for key in ("params", "ema_params"):
        for n, w in a[key].items():
            assert torch.equal(b[key][n], w), (key, n)
    for w, g in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                    b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert torch.equal(g, w)
