"""Train / retrain / prune-fine-tune / unlearn one diffusion model on a removal subset.

Port of the JAX package's ``cli/main.py`` (reference
unconditional_generation/main.py): one U-Net on the subset this job's
removal split keeps, trained step by step with the train step of
`training.train` (antithetic timesteps unless ``--no_antithetic``, EMA, the
global-norm clip), checkpoints carrying the removal indices, the timing, the
optimizer state and the (possibly pruned) U-Net spec, and a JSONL provenance
row at the end. Methods: retrain (and every other method of the choices,
which train as it does), prune_fine_tune (the pruned spec and weights of
``--pruned_model_dir``, default ``<outdir>/<dataset>/prune/models/full``),
gd/gd_u (fine-tune on the remaining set) and ga/ga_u (gradient ascent on
the removed set, the optimizer's ``maximize``).

A call whose model directory holds checkpoints resumes from the newest one:
parameters, EMA, optimizer state, step and ``total_steps_time`` carry over,
and the batch order continues where it stopped, so a resumed run ends with
the parameters of an uninterrupted one. ``--ckpt_freq 0`` writes only the
final checkpoint; ``--sample_freq 0`` never samples. Latent workloads
(``celeba``, ``synthetic_*_ldm``) train on the VQ-VAE's latents times
``scaling_factor`` (the tagged cache at ``<outdir>/<dataset>/
precomputed_emb/`` with ``--precompute_stage save|reuse``), and the sample
grid is decoded.

Each step's timesteps and noise come from a generator seeded from
(``--opt_seed``, step), as the JAX CLI keys each step; the streams differ
from threefry's. Runs on CUDA unless ``--device cpu`` is given; on CUDA,
float32 means float32 (TF32 off) and cuDNN runs deterministic algorithms.

Not ported yet: the prompt-conditional path (``imagenette``,
``synthetic_*_cond``), which needs ``pipelines.ImagenetteCaptioner`` (ROADMAP
queue A item 9) and the LDMBert tower (item 8); ``--profile_dir`` (item 9);
``--scan_chunk`` (item 6). Each exits with the item's name.

Usage (smoke, CPU):
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.main \\
        --dataset synthetic_64x8 --method retrain --removal_dist shapley \\
        --removal_seed 0 --outdir /tmp/out --training_steps 10 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import constants
from ..data import batch_iterator, create_dataset
from ..data.datasets import ArrayDataset
from ..diffusion.sampling import make_sampler
from ..diffusion.schedulers import make_schedule
from ..models.unet2d import UNet2D, build_unet
from ..models.vqvae import make_vq_decode_fn
from ..parallel.ensemble import _step_seed
from ..training.state import TrainState, make_optimizer
from ..training.train import make_train_step
from ..utils.ckpt import load_checkpoint, resume_or_init, save_checkpoint
from ..utils.device import resolve_device, to_device
from ..utils.jsonl import append_record
from .common import (
    add_common_args,
    checkpoint_spec,
    config_for,
    dataset_latents,
    model_output_dir,
    provenance_row,
    save_removal_indices,
    setup_removal,
    tracker_for,
)

GRID_STEPS = 100  # DDIM steps of the in-training EMA sample grid


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--method", type=str, default="retrain", choices=constants.METHOD)
    parser.add_argument("--load", type=str, default=None,
                        help="model dir of a pretrained ckpt to start from")
    parser.add_argument("--pruned_model_dir", type=str, default=None,
                        help="model dir of a pruned ckpt (prune_fine_tune)")
    parser.add_argument("--training_steps", type=int, default=None,
                        help="override the config's per-method budget")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--ckpt_freq", type=int, default=None)
    parser.add_argument("--sample_freq", type=int, default=None)
    parser.add_argument("--log_freq", type=int, default=100)
    parser.add_argument("--ema_max_decay", type=float, default=0.9999)
    parser.add_argument("--ema_power", type=float, default=0.75,
                        help="as in the JAX CLI, no effect: the EMA runs without warm-up")
    parser.add_argument("--no_antithetic", action="store_true", default=False)
    parser.add_argument("--scan_chunk", type=int, default=0,
                        help="not ported (ROADMAP queue A item 6); 0 = per-step loop")
    parser.add_argument("--keep_all_ckpts", action="store_true", default=False)
    parser.add_argument("--precompute_stage", type=str, default="reuse",
                        choices=["none", "save", "reuse"],
                        help="latent workloads: cache the encoded dataset (save, reuse) "
                             "or encode it in this call only (none)")
    # The conditional path's flags, kept so rows keep the JAX schema; that
    # path exits (module docstring).
    parser.add_argument("--text_encoder_kind", type=str, default="ldm_bert",
                        choices=["ldm_bert", "clip"])
    parser.add_argument("--text_encoder_weights", type=str, default=None)
    parser.add_argument("--tokenizer_dir", type=str, default=None)
    parser.add_argument("--random_text_encoder", action="store_true", default=False)
    parser.add_argument("--n_inference_samples", type=int, default=None,
                        help="images per in-training EMA sample grid "
                             "(default min(config n_samples, 16))")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="not ported (ROADMAP queue A item 9)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def _unported(args, cfg) -> None:
    if cfg.unet.conditional:
        raise SystemExit(
            f"dataset {args.dataset!r} is prompt-conditional: cli.main's conditional path "
            "needs pipelines.ImagenetteCaptioner (ROADMAP queue A item 9) and the LDMBert "
            "text tower (queue A item 8), not ported yet")
    if args.profile_dir:
        raise SystemExit("--profile_dir: a torch.profiler trace of the training loop is not "
                         "ported yet (ROADMAP queue A item 9)")
    if args.scan_chunk:
        raise SystemExit("--scan_chunk: the loop without a host round trip a step is not "
                         "ported yet (ROADMAP queue A item 6)")


def save_sample_grid(model: UNet2D, cfg, spec, n: int, step: int, model_dir: str, device,
                     decode_fn=None) -> str:
    """DDIM-sample `n` images (GRID_STEPS steps, noise seeded 1_000_000 +
    step) from `model`, decoded by `decode_fn` for latent workloads, and save
    them as one PNG grid of up to 4 columns under <model_dir>/samples/."""
    from PIL import Image

    shape = (n, spec.in_channels, spec.sample_size, spec.sample_size)
    gen = torch.Generator(device=device).manual_seed(1_000_000 + step)
    imgs = make_sampler(model, cfg.scheduler, shape, device=device,
                        num_inference_steps=GRID_STEPS, decode_fn=decode_fn)(generator=gen)
    imgs = imgs.permute(0, 2, 3, 1).cpu().numpy()
    cols = min(n, 4)
    rows = -(-n // cols)
    h, w, c = imgs.shape[1:]
    grid = np.zeros((rows * h, cols * w, c), np.float32)
    for i, im in enumerate(imgs):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = im
    arr = (np.clip(grid, 0, 1) * 255).round().astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.join(model_dir, "samples"), exist_ok=True)
    path = os.path.join(model_dir, "samples", f"steps_{step:08d}.png")
    Image.fromarray(arr).save(path)
    print(f"saved EMA sample grid: {path}", flush=True)
    return path


def main(argv=None):
    """Run the CLI. Returns a summary: the model dir, the DB, whether the run
    resumed and from which step, the steps this call ran, the batch size,
    the seconds of training (to a device synchronise, sampling excluded,
    checkpoints included), of sample grids, of checkpoint writes and of the
    latents' encode, the last loss, the U-Net spec
    and the row written (None, and the loss NaN, when the run was already
    complete: nothing runs and no row is written)."""
    args = parse_args(argv)
    cfg = config_for(args.dataset)
    _unported(args, cfg)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    method_key = "gd" if args.method in ("gd_u", "ga_u") else args.method
    method_base = {"ga": "ga", "ga_u": "ga"}.get(args.method, method_key)
    training_steps = args.training_steps or cfg.train.training_steps.get(method_base, 1000)
    batch_size = args.batch_size or cfg.train.batch_size
    # --ckpt_freq 0 drops the intermediate checkpoints only: the final one is
    # the run's product. --sample_freq 0 means never.
    ckpt_freq = (args.ckpt_freq if args.ckpt_freq is not None
                 else cfg.train.ckpt_freq.get(method_base, 10000))
    sample_freq = (args.sample_freq if args.sample_freq is not None
                   else cfg.train.sample_freq.get(method_base, 0))

    model_dir = model_output_dir(
        args.outdir, args.dataset, args.method, args.removal_dist, args.removal_seed,
        args.datamodel_alpha if args.removal_dist == "datamodel" else None,
    )
    os.makedirs(model_dir, exist_ok=True)
    dataset = create_dataset(args.dataset, train=True, device=device)
    remaining_idx, removed_idx = setup_removal(args, dataset)
    save_removal_indices(model_dir, remaining_idx, removed_idx)
    # Gradient ascent unlearns on the removed subset (reference main.py:298-300).
    ga = args.method in ("ga", "ga_u")
    train_idx = removed_idx if ga else remaining_idx
    if len(train_idx) == 0:
        raise SystemExit("empty training subset; nothing to do")
    subset = dataset.subset(train_idx)

    decode_fn, encode_s = None, 0.0
    if cfg.vqvae is not None:
        t0 = time.perf_counter()
        latents, vqvae, _ = dataset_latents(args, cfg, dataset, device,
                                            cache=args.precompute_stage != "none")
        subset = ArrayDataset((latents * cfg.vqvae.scaling_factor)[train_idx],
                              dataset.labels[train_idx])
        decode_fn = make_vq_decode_fn(cfg.vqvae, vqvae=vqvae)
        encode_s = time.perf_counter() - t0

    spec = cfg.unet
    pruned_src = None
    if args.pruned_model_dir or args.method == "prune_fine_tune":
        # The pruned architecture travels as the spec in the checkpoint meta.
        pruned_src = args.pruned_model_dir or model_output_dir(
            args.outdir, args.dataset, "prune", "full")
        spec = checkpoint_spec(pruned_src, spec)

    model = build_unet(spec, args.opt_seed, device=device)
    opt = cfg.train.optimizer
    tx = make_optimizer(opt.name, lr=args.lr or opt.lr, weight_decay=opt.weight_decay,
                        grad_clip_norm=opt.grad_clip_norm, maximize=ga)
    # Start point: resume > pruned / pretrained load > the seeded init.
    state, meta, resumed = resume_or_init(model_dir, TrainState.create(model, tx))
    src = pruned_src or args.load
    if not resumed and src:
        # The JAX CLI loads only --load / --pruned_model_dir, so its
        # prune_fine_tune without --pruned_model_dir fine-tunes a random init
        # of the pruned spec; the port loads the pruned weights it read the
        # spec from (ROADMAP C4).
        model.load_state_dict(load_checkpoint(src)["params"])
        state = TrainState.create(model, tx)  # the EMA restarts from the loaded params
        print(f"loaded pretrained params from {src}")
    start_step = state.step
    total_steps_time = float(meta.get("total_steps_time", 0.0))
    db = args.db or os.path.join(args.outdir, f"{args.dataset}_train_db.jsonl")
    summary = {"model_dir": model_dir, "db": db, "resumed": resumed, "start_step": start_step,
               "steps_run": max(training_steps - start_step, 0), "batch_size": None,
               "train_seconds": 0.0, "sampling_seconds": 0.0, "ckpt_seconds": 0.0,
               "encode_seconds": encode_s,
               "loss": float("nan"), "spec": spec, "row": None}
    if start_step >= training_steps:
        # The JAX CLI appends a second row, with a NaN loss, for a run that is
        # already complete; the port writes none (ROADMAP C4).
        print(f"{model_dir} is trained to step {start_step} of {training_steps}; nothing to do")
        return summary

    schedule = make_schedule(cfg.scheduler, device)
    step_fn = make_train_step(tx, schedule, cfg.scheduler, ema_max_decay=args.ema_max_decay,
                              ema_power=args.ema_power,
                              use_antithetic=not args.no_antithetic)
    n_grid = args.n_inference_samples or min(cfg.train.n_samples or 16, 16)
    grid_model = None

    def sample_grid(step: int) -> None:
        nonlocal grid_model
        if grid_model is None:
            grid_model = UNet2D(spec).to(device).eval()
        grid_model.load_state_dict(state.state_dicts()[1])
        save_sample_grid(grid_model, cfg, spec, n_grid, step, model_dir, device, decode_fn)

    eff_batch = min(batch_size, len(subset))
    batches = batch_iterator(subset, eff_batch, seed=args.opt_seed)
    # A resumed run continues the batch order where it stopped (the JAX CLI
    # starts it over; ROADMAP C4).
    for _ in range(start_step):
        next(batches)
    tracker = tracker_for(args, f"{args.dataset}_{args.method}")

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def elapsed() -> float:
        return time.time() - t_start - sampling_time

    sampling_time = ckpt_time = 0.0
    t_start = time.time()
    for step_i in range(start_step, training_steps):
        images, _ = next(batches)
        gen = torch.Generator(device=device).manual_seed(_step_seed(args.opt_seed, step_i))
        metrics = step_fn(state, to_device(images, device), gen)
        done = step_i + 1
        if done % args.log_freq == 0 or done == training_steps:
            loss, norm = float(metrics["loss"]), float(metrics.get("grad_norm", float("nan")))
            print(f"Step[{done}/{training_steps}] loss={loss:.5f} grad_norm={norm:.4f} "
                  f"steps_time={elapsed():.1f}s", flush=True)
            tracker.log({"loss": loss, "grad_norm": norm, "steps_time": elapsed()}, done)
        if sample_freq and done % sample_freq == 0:
            t_s = time.time()
            sample_grid(done)
            sampling_time += time.time() - t_s
        if (ckpt_freq and done % ckpt_freq == 0) or done == training_steps:
            sync()
            t_c = time.time()
            params, ema = state.state_dicts()
            save_checkpoint(model_dir, done, params, ema, remaining_idx, removed_idx,
                            total_steps_time + elapsed(), unet_spec=spec,
                            opt_state=state.opt_state)
            ckpt_time += time.time() - t_c
    sync()
    train_s = elapsed()
    total_steps_time += train_s
    tracker.finish()

    loss = float(metrics["loss"])
    row = provenance_row(args, loss=loss, remaining_idx=remaining_idx, removed_idx=removed_idx,
                         total_steps_time=total_steps_time, sampling_time=sampling_time,
                         model_dir=model_dir)
    append_record(db, row)
    print(f"done: {model_dir}")
    summary.update(batch_size=eff_batch, train_seconds=train_s, sampling_seconds=sampling_time,
                   ckpt_seconds=ckpt_time, loss=loss, row=row)
    return summary


if __name__ == "__main__":
    main()
