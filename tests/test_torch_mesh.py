"""Members over ranks (`parallel/{mesh,multihost}.py`) against the JAX
package's mesh, on the CPU: ranks are processes that `multihost.spawn`
starts and joins over gloo through a file store under the test's tmp_path,
one torch thread each, every launch bounded by a timeout.

* `make_mesh` gives JAX `make_mesh`'s clamped shape and warnings, for shapes
  and world sizes over the conftest's 8 virtual devices.
* Two ranks at (2, 1), at (1, 2) and four at (2, 2) draw bit for bit what
  the one-process trainer draws (a member's rows, a batch's slices), and end
  within the stacked step's tolerance of it (tests/test_torch_ensemble_
  stacked.py: the loss within 1e-5, per member and tensor the change of the
  parameters and of the EMA within 1% of its L2 norm); a mesh the members do
  not fit warns and gives the unsharded run.
* The data axis against JAX `EnsembleTrainer.step` on a (1, 2) mesh: the JAX
  step's threefry draws, the slots sliced and each shard's timesteps and
  noise from ``fold_in(k_step, d)``, injected into two ranks at (1, 2) and
  four at (2, 2), within the same tolerance.
* A 2-rank state saved mid-run, restored and sharded again continues bit for
  bit as the uninterrupted 2-rank run (JAX ``test_orbax_save_restore_under_
  sharding``).
* ``train_ensemble --mesh_ensemble 2`` and ``train_text_to_image_lora
  --mesh_ensemble 2`` on two ranks, and ``train_ensemble --mesh_ensemble 2
  --mesh_data 2`` on four, with a batch the data axis divides and with one it
  does not (the fallback), leave the files and rows of one process, written
  once, their values within the tolerance.
* A rank that raises fails the launch at once; a rank whose peer died exits
  non-zero at its collective timeout; NCCL without a card a rank refuses,
  naming gloo, and an NCCL group carries host tensors over gloo. The
  ``python -m`` entry runs `dryrun_multichip` on two ranks, the smoke's
  losses written by rank 0.

The rank side of each launch is `rank_main` in this module, which the ranks
import; it imports no JAX.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu_torch.cli import (
    train_ensemble,
    train_text_to_image_lora,
)
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.data import datasets, removal
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, build_unet
from group_attribution_for_diffusion_models_tpu_torch.parallel import (
    EnsembleTrainer,
    gather_members,
    make_mesh,
    member_range,
    multihost,
    shard_ensemble,
)
from group_attribution_for_diffusion_models_tpu_torch.parallel.ensemble import _step_seed
from group_attribution_for_diffusion_models_tpu_torch.parallel.mesh import AXES, Mesh
from group_attribution_for_diffusion_models_tpu_torch.training import (
    EnsembleState,
    TrainState,
    make_members_step,
    make_optimizer,
    stack_states,
)
from group_attribution_for_diffusion_models_tpu_torch.utils import jsonl
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import load_checkpoint

M, BATCH, SEED, STEPS, INIT_SEED = 2, 4, 5, 2, 3
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
# Seconds a launch may take: its ranks are stopped then, and each collective
# waits as long at most. The test waits a minute more for the launcher.
LAUNCH_TIMEOUT = 300
DATASET = "synthetic_64x8"
TIMING_KEYS = {"timestamp", "total_steps_time", "sampling_time", "scoring_time"}


# --- the rank side (run in the ranks, no JAX) ---------------------------------

def _images_u8(n=32):
    ds = datasets.make_synthetic(n=n, size=8)
    return ((ds.images + 1.0) * 127.5).round().astype(np.uint8)


def _subsets():
    return [removal.sample_removal("shapley", 32, seed=s)[0] for s in range(M)]


def _trainer(mesh=None, member_indices=None):
    sched = config_for("synthetic_32x8").scheduler
    return EnsembleTrainer(
        tx=make_optimizer("adam", lr=1e-3), schedule=make_schedule(sched), spec=sched,
        images_u8=_images_u8(), member_indices=member_indices or _subsets(),
        batch_size=BATCH, device=torch.device("cpu"), mesh=mesh)


def _init(trainer):
    spec = config_for("synthetic_32x8").unet
    return trainer.init_state(lambda seed: build_unet(spec, seed), seed=INIT_SEED)


def _gather_state(mesh, state: EnsembleState):
    """The whole stacked state's tensors on rank 0, members in global order
    (None on the other ranks): `gather_members` of the parameters, buffers,
    EMA shadows and optimizer slots, laid out as `_load` reads them."""
    slots = state.opt_state.slots()
    flat = (list(state.params.values()) + list(state.buffers.values()) + list(state.ema)
            + [t for xs in slots.values() for t in xs])
    got = gather_members(mesh, [t.detach() for t in flat])
    if got is None:
        return None
    it = iter(got)
    return {"params": {n: next(it) for n in state.params},
            "buffers": {n: next(it) for n in state.buffers}, "ema": [next(it) for _ in state.ema],
            "slots": {n: [next(it) for _ in xs] for n, xs in slots.items()},
            "count": state.opt_state.count, "step": state.step}


def _load(path: str, like: EnsembleState) -> EnsembleState:
    d = torch.load(path)
    opt = like.opt_state
    return EnsembleState(
        model=like.model, params={n: p.requires_grad_(True) for n, p in d["params"].items()},
        buffers=d["buffers"], ema=d["ema"], opt_state=type(opt)(count=d["count"], **d["slots"]),
        step=d["step"])


def _own_draws(trainer, state, steps=STEPS, seed=SEED):
    """`steps` steps; returns each step's draws and losses."""
    draws, losses = [], []
    for i in range(steps):
        draws.append(trainer.draws(_step_seed(seed, i)))
        losses.append(trainer.step(state, _step_seed(seed, i))["loss"])
    return draws, losses


def _rank_own(work, tag, shape):
    """The trainer's own draws on `shape`: each rank's draws, and on rank 0
    the gathered losses and state."""
    mesh = make_mesh(shape)
    trainer = _trainer(mesh)
    state = _init(trainer)
    draws, losses = _own_draws(trainer, state)
    torch.save(draws, os.path.join(work, f"{tag}_draws{mesh.rank}.pt"))
    loss = gather_members(mesh, [torch.stack(losses, 1)])
    full = _gather_state(mesh, state)
    if full is not None:
        torch.save({"loss": loss[0], **full}, os.path.join(work, f"{tag}.pt"))
    return mesh, trainer, state


def _rank_injected(work, tag, shape):
    """The JAX step's draws of `inputs.pt` injected on `shape`; rank 0 saves
    the losses and the final state."""
    inputs = torch.load(os.path.join(work, "inputs.pt"))
    mesh = make_mesh(shape)
    trainer = _trainer(mesh)
    spec = config_for("synthetic_32x8").unet
    states = []
    for sd in inputs["params"]:
        model = UNet2D(spec)
        model.load_state_dict(sd)
        states.append(TrainState.create(model, trainer.tx))
    state = shard_ensemble(stack_states(states), mesh)
    step = make_members_step(trainer.tx, trainer.schedule, pmean=mesh.pmean_data)
    local, d = slice(trainer.members.start, trainer.members.stop), mesh.coord("data")
    losses = []
    for slots, t, noise in inputs["draws"]:  # (M, data, b, ...) each
        metrics = step(state, trainer.batch(slots[local, d].long()), t[local, d].long(),
                       noise[local, d].permute(0, 1, 4, 2, 3).contiguous())
        losses.append(gather_members(mesh, [metrics["loss"]]))
    full = _gather_state(mesh, state)
    if full is not None:
        torch.save({"loss": torch.stack([x[0] for x in losses]), **full},
                   os.path.join(work, f"{tag}.pt"))


def _rank_round_trip(work, mesh, trainer, state):
    """Save the state mid-run (rank 0, gathered), continue 2 steps; restore
    it on every rank, shard it, continue the same 2 steps; rank 0 saves both
    ends."""
    import torch.distributed as dist

    path = os.path.join(work, "mid.pt")
    full = _gather_state(mesh, state)
    if full is not None:
        torch.save(full, path)
    dist.barrier()
    trainer.run(state, 2, seed=8)
    cont = _gather_state(mesh, state)
    restored = shard_ensemble(_load(path, state), mesh)
    trainer.run(restored, 2, seed=8)
    again = _gather_state(mesh, restored)
    if cont is not None:
        torch.save({"cont": cont, "restored": again},
                   os.path.join(work, "round_trip.pt"))


def _cli_argv(outdir, mesh_data=1):
    return ["--dataset", DATASET, "--removal_dist", "shapley", "--num_seeds", str(M),
            "--training_steps", "2", "--eval_loss", "--n_samples", "2",
            "--num_inference_steps", "2", "--log_freq", "1", "--tracker", "jsonl",
            "--mesh_ensemble", "2", "--mesh_data", str(mesh_data), "--outdir", outdir,
            "--device", "cpu"]


def _lora_argv(outdir):
    return ["--dataset", DATASET, "--outdir", outdir, "--removal_dist", "datamodel",
            "--num_seeds", str(M), "--max_train_steps", "2", "--train_batch_size", "8",
            "--rank", "2", "--log_freq", "1", "--mesh_ensemble", "2", "--device", "cpu"]


def _fallback_argv(outdir):
    """--mesh_data 2 with a batch of 3, which the data axis does not divide."""
    return _cli_argv(outdir, mesh_data=2) + ["--batch_size", "3"]


def rank_main(work, which):
    """One rank of a launch (`multihost.spawn`): `which` names the launch."""
    torch.set_num_threads(1)
    if which == "two":
        mesh, trainer, state = _rank_own(work, "own_2x1", (2, 1))
        _rank_round_trip(work, mesh, trainer, state)
        _rank_own(work, "own_1x2", (1, 2))
        _rank_injected(work, "jax_1x2", (1, 2))
        train_ensemble.main(_cli_argv(os.path.join(work, "cli")))
        train_text_to_image_lora.main(_lora_argv(os.path.join(work, "lora")))
    elif which == "four":
        _rank_own(work, "own_2x2", (2, 2))
        _rank_injected(work, "jax_2x2", (2, 2))
        train_ensemble.main(_cli_argv(os.path.join(work, "cli"), mesh_data=2))
        train_ensemble.main(_fallback_argv(os.path.join(work, "cli_fallback")))
    else:
        raise ValueError(which)


def failing_rank():
    """Rank 1 raises; rank 0 would sleep past the launch's timeout."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(2 * LAUNCH_TIMEOUT)


# --- the test side ---------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([TESTS, REPO, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(cmd, log):
    """`cmd` in a session of its own (so that it and its ranks can be stopped
    together), its output to `log`."""
    out = open(log, "w")
    return subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=out, stderr=subprocess.STDOUT,
                            start_new_session=True), out


def _stop(proc):
    """Stop `proc` and every rank it started."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _spawned(fn, n, args, log_dir):
    """`multihost.spawn` of `fn` on `n` gloo ranks of the CPU: (None, or the
    error it raised; the ranks' logs; its seconds)."""
    t0 = time.monotonic()
    try:
        multihost.spawn(fn, n, args, backend="gloo", device="cpu", timeout=LAUNCH_TIMEOUT,
                        log_dir=str(log_dir))
        error = None
    except Exception as e:  # noqa: BLE001 -- reported by the tests that read it
        error = e
    seconds = time.monotonic() - t0
    logs = "".join(open(f).read() for f in sorted(glob.glob(f"{log_dir}/rank*.log")))
    return error, logs, seconds


def _jax_draws(key, sizes, data):
    """JAX `local_step`'s draws on a (., data) mesh (common_noise off): each
    member's whole-batch slots, sliced by data shard; each shard's timesteps
    and noise from its step key with the shard folded in, split as the JAX
    `train_step` splits it. (M, data, b, ...) arrays."""
    import jax
    import jax.numpy as jnp

    from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
        antithetic_timesteps,
    )

    b = BATCH // data
    keys = jax.vmap(jax.random.split)(jax.random.split(key, len(sizes)))
    slots, ts, noises = [], [], []
    for m, size in enumerate(sizes):
        whole = np.asarray(jax.random.randint(keys[m, 0], (BATCH,), 0, size))
        slots.append([whole[d * b:(d + 1) * b] for d in range(data)])
        ts.append([])
        noises.append([])
        for d in range(data):
            key_t, key_n = jax.random.split(jax.random.fold_in(keys[m, 1], d))
            ts[-1].append(np.asarray(antithetic_timesteps(key_t, b, 1000)))
            noises[-1].append(np.asarray(jax.random.normal(key_n, (b, 8, 8, 3), jnp.float32)))
    return tuple(torch.from_numpy(np.asarray(x)) for x in (slots, ts, noises))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs, as in each rank: its U-Nets
    are tiny, and the test workers share the CPU, where torch's default of a
    thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every launch of the module, started together; meanwhile the JAX (1, 2)
    mesh step and the one-process runs. Returns the paths and references."""
    import jax

    from group_attribution_for_diffusion_models_tpu.config.registry import (
        SchedulerSpec as JaxSchedulerSpec,
    )
    from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
        make_schedule as jax_make_schedule,
    )
    from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
    from group_attribution_for_diffusion_models_tpu.parallel import ensemble as jax_ensemble
    from group_attribution_for_diffusion_models_tpu.parallel import mesh as jax_mesh
    from group_attribution_for_diffusion_models_tpu.training import state as jax_state
    from group_attribution_for_diffusion_models_tpu_torch.models import params_from_jax
    from test_torch_unet import _jax_params, _variant

    root = tmp_path_factory.mktemp("mesh")
    spec = _variant("synthetic_32x8")
    params = [_jax_params(spec, 30 + m) for m in range(M)]
    sizes = [len(ix) for ix in _subsets()]
    keys = [jax.random.PRNGKey(_step_seed(SEED, i)) for i in range(STEPS)]
    work = {}
    for name in ("two", "four"):
        work[name] = root / name
        work[name].mkdir()
        torch.save({"params": [params_from_jax(p) for p in params],
                    "draws": [_jax_draws(k, sizes, 2) for k in keys]},
                   work[name] / "inputs.pt")
    pool = ThreadPoolExecutor(max_workers=3)
    launches = {name: pool.submit(_spawned, rank_main, n, (str(work[name]), name),
                                  root / f"{name}_logs")
                for name, n in (("two", 2), ("four", 4))}
    launches["fail"] = pool.submit(_spawned, failing_rank, 2, (), root / "fail_logs")
    # The python -m entry: the dry run on two ranks, the smoke's losses in --out.
    dry = _start([sys.executable, "-m", "group_attribution_for_diffusion_models_tpu_torch."
                  "parallel.multihost", "--dryrun_multichip", "2", "--device", "cpu",
                  "--timeout", str(LAUNCH_TIMEOUT), "--out", str(root / "losses.txt")],
                 root / "dry.log")
    started = time.monotonic()
    try:
        # The JAX step on a (1, 2) mesh of the conftest's virtual devices.
        tx = jax_state.make_optimizer("adam", lr=1e-3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmesh = jax_mesh.make_mesh((1, 2), ("ensemble", "data"))
        trainer = jax_ensemble.EnsembleTrainer(
            apply_fn=JaxUNet2D(spec).apply, tx=tx,
            schedule=jax_make_schedule(JaxSchedulerSpec()), spec=JaxSchedulerSpec(),
            images_u8=_images_u8(), member_indices=_subsets(), batch_size=BATCH, mesh=jmesh)
        # Committed to the step's sharding, as the JAX init_state places it:
        # the step then compiles once, not again for its own output.
        state = jax_mesh.shard_ensemble(
            jax_ensemble.stack_states([jax_state.TrainState.create(p, tx) for p in params]), jmesh)
        jax_losses = []
        for k in keys:
            state, metrics = trainer.step(state, k)
            jax_losses.append(np.asarray(metrics["loss"]))
        jstate = jax.tree_util.tree_map(np.asarray, state)
        jax_ref = dict(start=[params_from_jax(p) for p in params], losses=np.stack(jax_losses),
                       params=[params_from_jax(jax.tree_util.tree_map(lambda a: a[m],
                                                                      jstate.params))
                               for m in range(M)],
                       ema=[params_from_jax(jax.tree_util.tree_map(lambda a: a[m],
                                                                   jstate.ema_params))
                            for m in range(M)])
        # The one-process runs, on one thread as the ranks run.
        one = _trainer()
        one_state = _init(one)
        start = [p.detach().clone() for p in one_state.params.values()]
        one_draws, one_losses = _own_draws(one, one_state)
        cli_one = train_ensemble.main(_cli_argv(str(root / "cli_one")))
        train_ensemble.main(_cli_argv(str(root / "cli_one_data"), mesh_data=2))
        lora_one = train_text_to_image_lora.main(_lora_argv(str(root / "lora_one")))
        cli_fallback_one = train_ensemble.main(_fallback_argv(str(root / "cli_one_b3")))
        results = {name: f.result() for name, f in launches.items()}
        dry[0].wait(timeout=LAUNCH_TIMEOUT + 60)
        results["dry"] = (dry[0].returncode, (root / "dry.log").read_text())
    finally:
        pool.shutdown(wait=True)
        _stop(dry[0])
        dry[1].close()
    return dict(root=root, work=work, results=results, seconds=time.monotonic() - started,
                jax=jax_ref, one=dict(state=one_state, start=start, draws=one_draws,
                                      losses=torch.stack(one_losses, 1)),
                cli_one=cli_one, lora_one=lora_one, cli_fallback_one=cli_fallback_one)


def _moves_within(start, got, want, rel=1e-2):
    """Per tensor, ||got - want|| <= rel ||want - start|| (the stacked test's
    rule; a key projection's bias has a zero gradient in exact arithmetic)."""
    for n, w in want.items():
        if n.endswith("to_k.bias"):
            continue
        moved = torch.linalg.vector_norm(w - start[n]).item()
        err = torch.linalg.vector_norm(got[n] - w).item()
        assert err <= rel * moved + 1e-12, (n, err, moved)


def _ok(ranks, name):
    """The launch returned: no error from `spawn` (exit code 0 for the dry
    run's process)."""
    error, log = ranks["results"][name][:2]
    assert not error, f"{error}\n{log[-4000:]}"


def _member(tree, m):
    return {n: t[m] for n, t in tree.items()}


def _by_name(state, tensors):
    return dict(zip(state.params, tensors))


@pytest.mark.parametrize("shape,world", [
    ((2, 1), 8), ((4, 2), 8), ((8, 1), 8), ((3, 3), 8), ((8, 2), 8), ((2, 2), 4),
    ((2, 1), 1), ((1, 2), 2), ((4, 4), 2), (None, 8), (None, 1), ((6,), 4)])
def test_make_mesh_matches_jax(shape, world):
    import jax

    from group_attribution_for_diffusion_models_tpu.parallel import mesh as jax_mesh

    names = ("ensemble",) if shape is not None and len(shape) == 1 else AXES
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jax_mesh.make_mesh(shape, names, devices=jax.devices()[:world])
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = make_mesh(shape, names, world_size=world)
    assert got.shape == tuple(want.shape.values())
    assert got.axis_names == tuple(want.axis_names)
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    assert got.coords == (0,) * len(names) and got.group is None  # no process group here


def test_a_mesh_larger_than_the_world_warns_and_clamps():
    with pytest.warns(UserWarning, match=r"needs 8 devices but only 2 are visible; "
                                         r"clamping to \(1, 2\)"):
        mesh = make_mesh((4, 2), world_size=2)
    assert mesh.shape == (1, 2) and mesh.coords == (0, 0)
    # At world size 1 (no process group) the clamped mesh's trainer is the
    # unsharded trainer bit for bit.
    with pytest.warns(UserWarning, match=r"clamping to \(1, 1\)"):
        clamped = make_mesh((2, 1))
    a, b = _trainer(clamped), _trainer()
    sa, sb = _init(a), _init(b)
    (da, la), (db, lb) = _own_draws(a, sa), _own_draws(b, sb)
    assert all(torch.equal(x, y) for s, t in zip(da, db) for x, y in zip(s, t))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert all(torch.equal(sa.params[n], sb.params[n]) for n in sa.params)


def test_member_range_and_shard_ensemble_slice_a_rank_block():
    mesh = Mesh((2, 2), AXES, rank=3, coords=(1, 1))
    assert member_range(mesh, 6) == range(3, 6)
    assert member_range(None, 6) == range(6)
    assert member_range(Mesh((2, 1), AXES, rank=3), 6) == range(0)  # outside the mesh
    with pytest.raises(ValueError, match="do not divide"):
        member_range(mesh, 5)
    state = _init(_trainer(member_indices=_subsets() * 2))  # 4 members
    part = shard_ensemble(state, Mesh((2, 1), AXES, rank=1, coords=(1, 0)))
    assert part.num_members == 2 and part.step == state.step
    for n, p in state.params.items():
        assert torch.equal(part.params[n], p[2:]) and part.params[n].requires_grad
    assert all(torch.equal(x, y[2:]) for x, y in zip(part.ema, state.ema))
    assert all(torch.equal(x, y[2:]) for x, y in zip(part.opt_state.mu, state.opt_state.mu))
    tree = {"a": {"down": torch.arange(8).view(4, 2)}}
    assert torch.equal(shard_ensemble(tree, Mesh((4,), ("ensemble",), 2, (2,)))["a"]["down"],
                       torch.tensor([[4, 5]]))
    # Without a process group the gathers give the tensors back, on the host.
    got = gather_members(None, state.ema)
    assert all(torch.equal(x, y) and x.device.type == "cpu" for x, y in zip(got, state.ema))


def test_a_mesh_the_members_do_not_fit_warns_and_trains_every_member():
    mesh = Mesh((3, 1), AXES, rank=0, coords=(0, 0))
    with pytest.warns(UserWarning, match="does not fit 2 members / batch 4"):
        sharded = _trainer(mesh)
    assert sharded.members == range(M) and sharded.mesh is None  # what the CLI gathers with
    plain = _trainer()
    sa, sb = _init(sharded), _init(plain)
    la, lb = _own_draws(sharded, sa)[1], _own_draws(plain, sb)[1]
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    with pytest.warns(UserWarning, match="does not fit"):
        _trainer(Mesh((1, 3), AXES, rank=0, coords=(0, 0)))  # batch 4 over 3


def test_rank_devices_never_change_quietly(monkeypatch):
    with pytest.raises(ValueError, match="--backend gloo"):
        multihost.rank_device("cpu", "nccl", 0)
    assert multihost.rank_device("cpu", "gloo", 5) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.rank_device("cuda", "gloo", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.rank_device("cuda", "nccl", 0) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="two ranks on one device.*--backend gloo"):
        multihost.rank_device("cuda", "nccl", 1)
    assert multihost.rank_device("cuda", "gloo", 1) == torch.device("cuda", 0)


def test_an_nccl_group_carries_host_tensors_over_gloo(monkeypatch, tmp_path):
    """NCCL takes CUDA tensors only, and `gather_members` gathers host copies:
    asked for NCCL, `initialize` makes the group ``cpu:gloo,cuda:nccl``."""
    assert multihost.group_backend("nccl") == "cpu:gloo,cuda:nccl"
    assert multihost.group_backend("gloo") == "gloo"
    got = {}
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: got.update(device=dev))
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: got.update(backend=backend, **kw))
    dev = multihost.initialize(f"file://{tmp_path}/store", 2, 1, device="cuda", timeout=7)
    assert dev == got["device"] == torch.device("cuda", 1)
    assert got["backend"] == "cpu:gloo,cuda:nccl" and got["world_size"] == 2
    assert got["rank"] == 1 and got["timeout"].total_seconds() == 7
    multihost.initialize(f"file://{tmp_path}/store", 2, 1, backend="gloo", device="cuda")
    assert got["backend"] == "gloo"


def test_the_rendezvous_comes_from_flags_or_torchrun(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    assert multihost.init_method_of("10.0.0.1:1234") == "tcp://10.0.0.1:1234"
    assert multihost.init_method_of("file:///tmp/s") == "file:///tmp/s"
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.init_method_of(None)
    monkeypatch.setenv("MASTER_ADDR", "h")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert multihost.init_method_of(None) == "tcp://h:29500"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        multihost.initialize(device="cpu")
    assert multihost.is_main() and multihost.maybe_initialize("cpu") == torch.device("cpu")


@pytest.mark.parametrize("tag,shape", [("own_2x1", (2, 1)), ("own_1x2", (1, 2)),
                                       ("own_2x2", (2, 2))])
def test_sharded_runs_draw_the_unsharded_draws_and_agree(ranks, tag, shape):
    launch = "four" if shape == (2, 2) else "two"
    _ok(ranks, launch)
    one = ranks["one"]
    e_size, d_size = shape
    local, b = M // e_size, BATCH // d_size
    for r in range(e_size * d_size):
        e, d = divmod(r, d_size)
        got = torch.load(ranks["work"][launch] / f"{tag}_draws{r}.pt")
        for step_got, step_want in zip(got, one["draws"]):
            for x, y in zip(step_got, step_want):
                assert torch.equal(x, y[e * local:(e + 1) * local, d * b:(d + 1) * b]), (r, tag)
    res = torch.load(ranks["work"][launch] / f"{tag}.pt")
    np.testing.assert_allclose(res["loss"].numpy(), one["losses"].numpy(), atol=1e-5, rtol=0)
    state = one["state"]
    for m in range(M):
        start = _member(_by_name(state, one["start"]), m)
        _moves_within(start, _member(res["params"], m), _member(state.params, m))
        _moves_within(start, _member(_by_name(state, res["ema"]), m),
                      _member(_by_name(state, state.ema), m))
    if shape == (2, 1):
        # Members are independent: the ensemble axis changes no arithmetic
        # but the vmapped batch's width.
        assert res["step"] == STEPS and res["count"] == STEPS


@pytest.mark.parametrize("tag", ["jax_1x2", "jax_2x2"])
def test_data_axis_matches_the_jax_mesh_step(ranks, tag):
    _ok(ranks, "four" if tag == "jax_2x2" else "two")
    ref = ranks["jax"]
    res = torch.load(ranks["work"]["four" if tag == "jax_2x2" else "two"] / f"{tag}.pt")
    np.testing.assert_allclose(res["loss"].numpy(), ref["losses"], atol=1e-5, rtol=0)
    names = list(res["params"])
    for m in range(M):
        start = ref["start"][m]
        _moves_within(start, _member(res["params"], m), ref["params"][m])
        _moves_within(start, {n: e[m] for n, e in zip(names, res["ema"])}, ref["ema"][m])


def test_a_sharded_checkpoint_round_trip_continues_bit_for_bit(ranks):
    _ok(ranks, "two")
    rt = torch.load(ranks["work"]["two"] / "round_trip.pt")
    cont, again = rt["cont"], rt["restored"]
    assert cont["step"] == again["step"] == 2 * STEPS
    assert all(torch.equal(cont["params"][n], again["params"][n]) for n in cont["params"])
    for a, b in zip(cont["ema"] + cont["slots"]["mu"] + cont["slots"]["nu"],
                    again["ema"] + again["slots"]["mu"] + again["slots"]["nu"]):
        assert torch.equal(a, b)


def _tree(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(f"{root}/**/*", recursive=True)
                  if os.path.isfile(p))


@pytest.mark.parametrize("launch,one", [("two", "cli_one"), ("four", "cli_one_data"),
                                        ("four", "cli_one_b3")])
def test_train_ensemble_over_ranks_leaves_the_one_process_files(ranks, launch, one):
    """--mesh_ensemble 2 on two ranks, and with --mesh_data 2 on four; on four
    too with a batch of 3, which the data axis does not divide: the trainer
    warns, every rank trains both members, and rank 0 alone writes."""
    _ok(ranks, launch)
    fallback = one == "cli_one_b3"
    one_dir = ranks["root"] / one
    two_dir = ranks["work"][launch] / ("cli_fallback" if fallback else "cli")
    if fallback:
        assert ranks["results"][launch][1].count("does not fit 2 members / batch 3") == 4
    assert _tree(two_dir) == _tree(one_dir)
    rows_one = list(jsonl.read_records(str(one_dir / f"{DATASET}_train_db.jsonl")))
    rows_two = list(jsonl.read_records(str(two_dir / f"{DATASET}_train_db.jsonl")))
    assert len(rows_two) == len(rows_one) == M  # each row once
    # Common noise (the CLI's default): every member starts from --opt_seed's init.
    start = dict(build_unet(config_for(DATASET).unet, 42).named_parameters())
    for a, b in zip(rows_one, rows_two):
        assert set(a) == set(b)
        for k in set(a) - TIMING_KEYS - {"outdir", "model_dir", "loss", "eval_loss"}:
            assert a[k] == b[k], k
        assert abs(a["loss"] - b["loss"]) <= 1e-5 and abs(a["eval_loss"] - b["eval_loss"]) <= 1e-5
        assert a["mesh_ensemble"] == 2 and a["mesh_data"] == (2 if launch == "four" else 1)
        pa, pb = (load_checkpoint(r["model_dir"]) for r in (a, b))
        for key in ("params", "ema_params"):
            _moves_within(start, pb[key], pa[key])
            # A member's file holds its own tensors, not views of the stack.
            assert all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
                       for ckpt in (pa, pb) for t in ckpt[key].values())
    logs = [list(jsonl.read_records(str(d / "logs" / f"{DATASET}_ensemble_retrain.jsonl")))
            for d in (one_dir, two_dir)]
    steps = [[(r["step"], r["loss_mean"]) for r in log if "step" in r] for log in logs]
    assert [x for x, _ in steps[0]] == [x for x, _ in steps[1]] == [1, 2, 2]
    np.testing.assert_allclose([y for _, y in steps[1]], [y for _, y in steps[0]], atol=1e-5)


def test_the_lora_trainer_over_two_ranks_leaves_the_one_process_files(ranks):
    _ok(ranks, "two")
    one_dir, two_dir = ranks["root"] / "lora_one", ranks["work"]["two"] / "lora"
    assert _tree(two_dir) == _tree(one_dir)
    files = sorted(glob.glob(f"{one_dir}/**/lora_weights.npz", recursive=True))
    assert len(files) == M
    for f in files:
        a, b = np.load(f), np.load(str(two_dir / os.path.relpath(f, one_dir)))
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], atol=1e-6, rtol=0)
    rows = [list(jsonl.read_records(str(d / f"{DATASET}_lora_db.jsonl"))) for d in (one_dir,
                                                                                  two_dir)]
    assert len(rows[1]) == M
    for a, b in zip(*rows):
        for k in set(a) - TIMING_KEYS - {"outdir", "lora_path", "loss"}:
            assert a[k] == b[k], k
        assert abs(a["loss"] - b["loss"]) <= 1e-5
    assert ranks["lora_one"]["seeds"] == [0, 1]


def test_a_failed_rank_fails_the_launch_and_a_lost_peer_times_out(ranks, tmp_path):
    error, _, seconds = ranks["results"]["fail"]
    assert isinstance(error, torch.multiprocessing.ProcessRaisedException)
    assert error.error_index == 1 and "rank 1 fails on purpose" in str(error)
    assert seconds < LAUNCH_TIMEOUT / 2  # rank 0 was stopped, not waited for
    # Without the launcher: rank 1 joins and dies; rank 0's collective gives
    # up at its timeout and the process exits non-zero.
    script = ("import sys, torch\n"
              "from group_attribution_for_diffusion_models_tpu_torch.parallel import multihost\n"
              "r = int(sys.argv[1])\n"
              f"multihost.initialize('file://{tmp_path}/store', 2, r, device='cpu', timeout=5)\n"
              "if r == 1:\n    sys.exit(3)\n"
              "torch.distributed.all_reduce(torch.ones(1))\n")
    procs = [_start([sys.executable, "-c", script, str(r)], tmp_path / f"{r}.log")
             for r in range(2)]
    try:
        for p, _ in procs:
            p.wait(timeout=120)  # the 5 s timeout, the imports, a loaded host
    finally:
        for p, out in procs:
            _stop(p)
            out.close()
    assert procs[1][0].returncode == 3
    assert procs[0][0].returncode != 0, (tmp_path / "0.log").read_text()[-2000:]


def test_the_python_m_smoke_and_the_dry_run(ranks):
    _ok(ranks, "dry")
    losses = [float(x) for x in (ranks["root"] / "losses.txt").read_text().split()]
    assert len(losses) == 2 and np.isfinite(losses).all()
    log = ranks["results"]["dry"][1]
    for line in ("dryrun_multichip OK: mesh=(2,1)", "dryrun_multichip LoRA ensemble OK",
                 "dryrun_multichip full pass OK on (2,1) mesh",
                 "dryrun_multichip full-pass layout invariance OK"):
        assert line in log
    print(f"launches of the module: {ranks['seconds']:.1f} s")


def test_launch_reports_rank_logs_and_the_cli_writes_once(ranks):
    """Rank 0 alone wrote: the other rank's log of the CLI has no row line."""
    _ok(ranks, "two")
    log = ranks["results"]["two"][1]
    assert log.count(f"{M} members -> ") == 1 and log.count(f"{M} LoRA members in") == 1
    assert json.dumps(ranks["cli_one"]["seeds"]) == "[0, 1]"
