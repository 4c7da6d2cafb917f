"""Multi-process runs: one rank a process, one device a rank.

Port of the JAX package's ``parallel/multihost.py`` on torch.distributed.
`initialize` is the counterpart of ``jax.distributed.initialize``: it joins
the process group from its arguments or, where they are not given, from
torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), and returns the rank's device. The backend is NCCL
on the card, each rank on ``cuda:<LOCAL_RANK>``, and gloo on the CPU; gloo on
the card only where the caller asks for it, and then ranks past the host's
card count share its cards. With NCCL the group is made as
``cpu:gloo,cuda:nccl``: NCCL carries the collectives of CUDA tensors (the
data row's gradient mean) and gloo those of host tensors (`mesh.
gather_members` gathers host copies, because its product goes to files).
NCCL does not put two ranks on one device: asked to, `initialize` raises and
names the gloo option; it never changes backend or device on its own. Every
collective waits at most `timeout` seconds, so a rank whose peer died raises
instead of hanging. `is_main` gates I/O: rank 0, or the one process where
there is no group.

`pin_virtual_cpu` of the JAX module has no counterpart: on the CPU the
port's ranks are processes of their own, not virtual XLA devices of one.

Ranks are started by torchrun, each process reading its environment, or, for
the dry run and tests, by `spawn`: ranks of this host through
torch.multiprocessing and a file store, stopped together as soon as one
fails or the timeout passes, and never outliving the caller.
``python -m group_attribution_for_diffusion_models_tpu_torch.parallel.multihost``
runs as one rank the JAX module's smoke: one sharded ensemble step, the
losses gathered to rank 0, which writes ``--out``. ``--dryrun_multichip N``
is the counterpart of the repository root's ``dryrun_multichip``: `spawn`s N
gloo ranks, which run that step, a LoRA ensemble step and the full-pass
layout check of ``train_ensemble``. Examples:

    # the smoke on two ranks of the CPU, or on four cards (NCCL)
    torchrun --standalone --nproc_per_node 2 -m \\
        group_attribution_for_diffusion_models_tpu_torch.parallel.multihost \\
        --device cpu --out /tmp/losses.txt
    # one rank of a world given by flags
    python -m group_attribution_for_diffusion_models_tpu_torch.parallel.multihost \\
        --coordinator_address host:1234 --num_processes 2 --process_id 0
    # train_ensemble over four cards
    torchrun --standalone --nproc_per_node 4 -m \\
        group_attribution_for_diffusion_models_tpu_torch.cli.train_ensemble \\
        --dataset cifar --num_seeds 8 --mesh_ensemble 4 --outdir /tmp/out
    # the dry run on two gloo ranks of the CPU
    python -m group_attribution_for_diffusion_models_tpu_torch.parallel.multihost \\
        --dryrun_multichip 2 --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import group_ready, world

DEFAULT_TIMEOUT = 600.0  # seconds a collective, or a spawn, may wait
GLOO_HINT = "--backend gloo (initialize(..., backend='gloo'))"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_method_of(coordinator_address: Optional[str]) -> str:
    """The rendezvous URL: `coordinator_address` as given where it has a
    scheme (``tcp://``, ``file://``), ``tcp://<host:port>`` where it has
    none, else torchrun's ``MASTER_ADDR``/``MASTER_PORT``."""
    if coordinator_address:
        return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not (addr and port):
        raise ValueError("no coordinator: pass --coordinator_address, or set MASTER_ADDR "
                         "and MASTER_PORT (torchrun sets them)")
    return f"tcp://{addr}:{port}"


def rank_device(name: str, backend: str, local_rank: int) -> torch.device:
    """The device of a rank: the CPU, or the card of its local rank. NCCL
    needs cards and one card a rank; gloo, where asked for, shares the
    host's cards among its ranks (local rank modulo the card count)."""
    device = resolve_device(name)
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError(f"NCCL runs between CUDA devices; on the CPU pass {GLOO_HINT}")
        return device
    count = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= count:
        raise RuntimeError(
            f"NCCL cannot put two ranks on one device: local rank {local_rank} on a host "
            f"with {count} CUDA device(s). Start at most {count} rank(s) a host, or pass "
            f"{GLOO_HINT} to let ranks share a card")
    return torch.device("cuda", local_rank % count)


def group_backend(backend: str) -> str:
    """The backend `init_process_group` is given for `backend`: NCCL for
    CUDA tensors with gloo for host tensors, or gloo for both."""
    return "cpu:gloo,cuda:nccl" if backend == "nccl" else backend


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
    timeout: float = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join the default process group and return this rank's device (the
    current CUDA device is set to it). Arguments not given come from
    torchrun's environment; `backend` defaults to NCCL on the card and gloo
    on the CPU (`group_backend`: with NCCL, gloo carries host tensors). Each
    collective then waits at most `timeout` seconds."""
    world_size = num_processes or _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world_size is None or rank is None:
        raise ValueError("no world: pass --num_processes and --process_id, or set "
                         "WORLD_SIZE and RANK (torchrun sets them)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dev = rank_device(device, backend, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(group_backend(backend), init_method=init_method_of(coordinator_address),
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def maybe_initialize(device: str = "cuda") -> torch.device:
    """The device of an entry point that may run as a rank: joins the group
    from torchrun's environment when it holds a world of more than one rank
    and no group exists yet; then, on the card, the rank's own card."""
    if not group_ready() and (_env_int("WORLD_SIZE") or 1) > 1:
        return initialize(device=device)
    dev = resolve_device(device)
    if group_ready() and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def is_main() -> bool:
    """Rank 0, or the one process where there is no process group: the
    process that writes."""
    return world()[1] == 0


def shutdown() -> None:
    if group_ready():
        dist.destroy_process_group()


def _demo(out_path: Optional[str], device: torch.device, data_axis: int = 1) -> List[float]:
    """One sharded ensemble train step across all ranks (the JAX module's
    smoke): the ranks on an (ensemble, `data_axis`) mesh, a member for each
    data row, the losses gathered to rank 0, which checks them and writes
    them to `out_path`. Returns them on rank 0, [] elsewhere."""
    import numpy as np

    from ..config.registry import SchedulerSpec, UNetSpec
    from ..data import make_synthetic, sample_removal
    from ..diffusion import make_schedule
    from ..models import build_unet
    from ..training import make_optimizer
    from .ensemble import EnsembleTrainer
    from .mesh import gather_members, make_mesh

    n_ranks = world()[0]
    mesh = make_mesh((n_ranks // data_axis, data_axis), ("ensemble", "data"))
    e_axis = mesh.axis_size("ensemble")
    spec = SchedulerSpec()
    unet_spec = UNetSpec(
        sample_size=8, block_out_channels=(8, 16),
        down_block_types=("DownBlock2D", "AttnDownBlock2D"),
        up_block_types=("AttnUpBlock2D", "UpBlock2D"),
        layers_per_block=1, norm_num_groups=4,
    )
    ds = make_synthetic(n=32, size=8)
    images_u8 = ((ds.images + 1.0) * 127.5).astype(np.uint8)
    trainer = EnsembleTrainer(
        tx=make_optimizer("adam", lr=1e-3), schedule=make_schedule(spec, device), spec=spec,
        images_u8=images_u8,
        member_indices=[sample_removal("shapley", 32, seed=s)[0] for s in range(e_axis)],
        batch_size=4 * mesh.axis_size("data"), device=device, mesh=mesh,
    )
    state = trainer.init_state(lambda seed: build_unet(unet_spec, seed), seed=0)
    got = gather_members(mesh, [trainer.step(state, 0)["loss"]])
    if got is None:
        return []
    losses = got[0].tolist()
    if not (len(losses) == e_axis and np.isfinite(losses).all()):
        raise AssertionError(f"losses {losses}")
    print(f"rank 0 of {n_ranks}, mesh {mesh.shape}: losses={np.round(losses, 4).tolist()}",
          flush=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(" ".join(str(float(x)) for x in losses))
    return losses


def _spawned_rank(index: int, fn: Callable, args: tuple, nprocs: int, init_method: str,
                  backend: Optional[str], device: str, timeout: float,
                  log_dir: Optional[str]) -> None:
    """Rank `index` of `spawn`: its output to its log, the group joined,
    `fn(*args)`, the group left."""
    if log_dir is not None:
        log = open(os.path.join(log_dir, f"rank{index}.log"), "w", buffering=1)
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    os.environ["LOCAL_RANK"] = str(index)
    initialize(init_method, nprocs, index, backend, device, timeout)
    try:
        fn(*args)
    finally:
        shutdown()


def spawn(
    fn: Callable,
    nprocs: int,
    args: tuple = (),
    *,
    backend: Optional[str] = None,
    device: str = "cuda",
    timeout: float = DEFAULT_TIMEOUT,
    log_dir: Optional[str] = None,
) -> None:
    """Run `fn(*args)` in `nprocs` ranks of this host: processes started by
    torch.multiprocessing (spawn; `fn` must be a module-level function), each
    joined to the group through a file store with `initialize(backend=...,
    device=..., timeout=...)`. Returns when every rank has returned. As soon
    as one rank fails, the others are stopped and its error raised
    (``ProcessRaisedException``, or ``ProcessExitedException`` for a rank
    that died); at `timeout` seconds all are stopped and TimeoutError raised.
    The ranks die with the caller. Each rank's output goes to
    ``<log_dir>/rank<r>.log`` where `log_dir` is given, else to the caller's."""
    import torch.multiprocessing as mp

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="gadm_store_") as tmp:
        ctx = mp.start_processes(
            _spawned_rank, args=(fn, tuple(args), nprocs, f"file://{tmp}/store", backend,
                                 device, timeout, log_dir),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def dryrun_multichip(n: int, device: str = "cpu", timeout: float = DEFAULT_TIMEOUT,
                     out: Optional[str] = None) -> None:
    """The multi-device dry run on `n` gloo ranks of this host (the CPU, or
    the card when `device` is "cuda"): the one-step check of a sharded
    ensemble (`_demo`, rank 0 writing `out`), a LoRA ensemble step over the
    ranks, and train_ensemble's full pass on the mesh, then at its ensemble
    axis alone against the unsharded run. Raises as `spawn` does."""
    spawn(_dryrun_rank, n, (device, out), backend="gloo", device=device, timeout=timeout)


def _dryrun_rank(device_name: str, out: Optional[str]) -> None:
    """One rank of `dryrun_multichip`, the process group joined."""
    import numpy as np

    from ..cli import train_ensemble
    from ..cli.train_text_to_image_lora import lora_leaves, members_step, tiny_sd_spec
    from ..config.registry import SchedulerSpec
    from ..diffusion import make_schedule
    from ..models import build_unet
    from ..models.lora import lora_init, stack_lora_trees
    from ..training import make_optimizer
    from ..utils.jsonl import read_records
    from .mesh import gather_members, make_mesh, shard_ensemble

    n, rank = world()
    device = maybe_initialize(device_name)
    data_axis = 2 if n >= 4 and n % 2 == 0 else 1
    e_axis = n // data_axis
    loss = _demo(out, device, data_axis)
    if is_main():
        print(f"dryrun_multichip OK: mesh=({e_axis},{data_axis}) "
              f"losses={np.round(loss, 4).tolist()}", flush=True)
    spec = SchedulerSpec()

    # The text-to-image path: stacked LoRA members over the ranks' ensemble
    # axis, the frozen base on every rank (train_text_to_image_lora
    # --mesh_ensemble).
    sd_spec = tiny_sd_spec(8)
    base = build_unet(sd_spec, seed=0, device=device).eval().requires_grad_(False)
    lora_mesh = make_mesh((n,), ("ensemble",))
    tree = shard_ensemble(stack_lora_trees([
        lora_init(base, 2, generator=torch.Generator(device=device).manual_seed(100 + m))
        for m in range(n)]), lora_mesh)
    leaves = lora_leaves(tree)
    for leaf in leaves:
        leaf.requires_grad_(True)
    lora_tx = make_optimizer("adamw", lr=1e-3)
    opt_state = lora_tx.init(leaves)
    g = torch.Generator(device=device).manual_seed(5 + rank)
    latents = torch.randn((4, 4, 8, 8), generator=g, device=device)
    emb = torch.zeros((1, 77, sd_spec.cross_attention_dim), device=device)
    idx = torch.randint(0, 4, (1, 4), generator=g, device=device)
    t = torch.randint(0, spec.num_train_timesteps, (1, 4), generator=g, device=device)
    noise = torch.randn((1, 4, 4, 8, 8), generator=g, device=device)
    lora_loss = members_step(base, tree, lora_tx, opt_state, latents, emb,
                             torch.zeros(4, dtype=torch.long, device=device), idx, t, noise,
                             make_schedule(spec, device))
    lora_loss = gather_members(lora_mesh, [lora_loss])
    if is_main():
        lora_loss = lora_loss[0].numpy()
        if not (lora_loss.shape == (n,) and np.isfinite(lora_loss).all()):
            raise AssertionError(f"LoRA losses {lora_loss}")
        print(f"dryrun_multichip LoRA ensemble OK: losses={lora_loss.round(4).tolist()}",
              flush=True)

    # train_ensemble's full pass on the mesh's ensemble axis alone against
    # the unsharded run (rank 0 alone trains there; the others idle), and on
    # the whole mesh where it has a data axis: losses and eval losses of the
    # first two within 1e-6 relative, and per tensor the
    # checkpointed weights' change within 1% of its L2 norm (the stacked
    # step's rule: a vmapped convolution as wide as the rank's members sums in
    # another order, and Adam turns float noise of a gradient element near
    # zero into a visible share of lr).
    from ..cli.common import config_for
    from ..utils.ckpt import load_checkpoint

    dataset = "synthetic_64x8"
    root = tempfile.mkdtemp(prefix="gadm_dryrun_") if is_main() else None
    roots = [root]
    dist.broadcast_object_list(roots, src=0)
    root = roots[0]

    def full_pass(tag, mesh_e, mesh_d, num_seeds=e_axis, steps=4):
        outdir = os.path.join(root, tag)
        train_ensemble.main([
            "--dataset", dataset, "--removal_dist", "shapley", "--seed_start", "0",
            "--num_seeds", str(num_seeds), "--training_steps", str(steps),
            "--batch_size", str(max(2 * mesh_d, 2)), "--eval_loss", "--eval_probe_size", "8",
            "--n_samples", "2", "--num_inference_steps", "2", "--mesh_ensemble", str(mesh_e),
            "--mesh_data", str(mesh_d), "--outdir", outdir, "--device", device.type])
        dist.barrier()
        if not is_main():
            return None
        rows = sorted(read_records(os.path.join(outdir, f"{dataset}_train_db.jsonl")),
                      key=lambda r: r["removal_seed"])
        if not (len(rows) == num_seeds and all(
                np.isfinite(r["loss"]) and np.isfinite(r["eval_loss"]) for r in rows)):
            raise AssertionError(f"rows {rows}")
        return rows

    rows_sharded = full_pass("sharded", e_axis, 1, steps=1)
    rows_mesh = rows_sharded if data_axis == 1 else full_pass("mesh", e_axis, data_axis)
    if is_main():
        print(f"dryrun_multichip full pass OK on ({e_axis},{data_axis}) mesh: eval_losses="
              f"{[round(r['eval_loss'], 5) for r in rows_mesh]}", flush=True)
    rows_unsharded = full_pass("unsharded", 1, 1, steps=1)
    if is_main():
        # Common noise: every member starts from --opt_seed's (42) init.
        start = dict(build_unet(config_for(dataset).unet, 42).named_parameters())
        for a, b in zip(rows_sharded, rows_unsharded):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
            np.testing.assert_allclose(a["eval_loss"], b["eval_loss"], rtol=1e-6)
            pa, pb = (load_checkpoint(r["model_dir"])["params"] for r in (a, b))
            for k in pa:
                moved = torch.linalg.vector_norm(pb[k] - start[k]).item()
                err = torch.linalg.vector_norm(pa[k] - pb[k]).item()
                if not k.endswith("to_k.bias") and err > 1e-2 * moved:
                    raise AssertionError(f"params differ across layouts at {k}: {err} of a "
                                         f"move of {moved}")
        print(f"dryrun_multichip full-pass layout invariance OK: {e_axis}-member sharded == "
              f"unsharded to <=1e-6 rel (loss, eval_loss), checkpointed params within 1% "
              f"of their move", flush=True)
        import shutil

        shutil.rmtree(root, ignore_errors=True)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="tcp://host:port, host:port or file:///path (default: torchrun's "
                             "MASTER_ADDR and MASTER_PORT)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="the world's size (default: WORLD_SIZE)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this rank (default: RANK)")
    parser.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="default: nccl on the card, gloo on the CPU; gloo on the card "
                             "lets ranks share a card")
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    parser.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT,
                        help="seconds a collective (and the dry run) may wait")
    parser.add_argument("--out", type=str, default=None, help="loss file written by rank 0")
    parser.add_argument("--dryrun_multichip", type=int, default=0,
                        help="spawn this many gloo ranks on this host for the dry run")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dryrun_multichip:
        dryrun_multichip(args.dryrun_multichip, args.device, args.timeout, out=args.out)
        return 0
    device = initialize(args.coordinator_address, args.num_processes, args.process_id,
                        args.backend, args.device, args.timeout)
    try:
        _demo(args.out, device)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
