"""Train many removal subsets as one ensemble, score them, write their rows.

Port of the JAX package's ``cli/train_ensemble.py``: give it a seed range
and it draws each seed's removal subset, trains one U-Net per subset
(`parallel.ensemble.EnsembleTrainer`: the members stacked, each kernel
launched once for all of them, in chunks of ``--log_freq`` steps through
`run_scanned`, the host reading the losses once a chunk, as the JAX CLI's
``lax.scan`` chunks), optionally records each member's
fixed-probe eval loss and samples it with DDIM, writes one checkpoint per
member and appends one JSONL provenance row per member, the rows the LDS
tier reads. With ``--score fid|is|fid_is`` each member's samples are scored
in the loop: one InceptionV3 pass over every member's samples gives FID
features (against reference stats of the first 2048 training images, cached
at ``--ref_stats`` with the tag of the tower that made them) and IS logits,
written to the rows as ``fid_value`` and ``is``. Members whose final
checkpoint (or, under --no-save_ckpts, whose DB row) already exists are
skipped.

Latent workloads (``celeba``, ``synthetic_*_ldm``) train in the frozen
VQ-VAE's latent space, as the JAX CLI does: the VQ-VAE (``--vqvae_weights``,
else the seeded random tower) encodes the dataset once, cached at
``<outdir>/<dataset>/precomputed_emb/vqvae_latents.npy`` in the JAX layout
(N, h, w, c), so either package reads the other's cache, with a tag of the
encoder, dataset and image count beside it: a cache whose tag does not match
is encoded again (`models.vqvae.cached_latents`); the members train
on those float32 latents times ``scaling_factor``, the eval-loss probe lives
in latent space, and sampling runs the VQ decoder after the denoise loop.

Runs on CUDA unless ``--device cpu`` is given; on CUDA, float32 means
float32 (TF32 off in cuDNN convolutions and CUDA matmuls) and cuDNN runs
deterministic algorithms, so two runs of a step give bit-identical
gradients (the attention and GroupNorm kernels use no atomics). Not ported yet:
the device mesh (``--mesh_ensemble``, ``--mesh_data``). ``--bf16`` is the JAX
CLI's: float32 parameters and optimizer state, bf16 compute.

Usage (smoke, CPU):
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.train_ensemble \\
        --dataset synthetic_64x8 --removal_dist shapley --seed_start 0 \\
        --num_seeds 8 --training_steps 10 --outdir /tmp/out --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..attributions.global_scores import (
    calculate_fid_from_features,
    compute_feature_stats,
    inception_score_from_logits,
    inception_tag,
    load_inception,
    load_reference_stats,
    make_feature_fn,
    save_stats,
)
from ..config import constants
from ..data import create_dataset
from ..diffusion.sampling import make_sampler
from ..diffusion.schedulers import add_noise, make_schedule
from ..models.unet2d import REMAT_POLICIES, UNet2D, build_unet
from ..models.vqvae import make_vq_decode_fn
from ..parallel.ensemble import EnsembleTrainer, derived_seed
from ..training.state import TrainState, make_optimizer, unstack_state
from ..utils.ckpt import get_max_steps, load_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from ..utils.jsonl import append_record, filter_records
from .common import (
    add_common_args,
    as_rgb,
    checkpoint_spec,
    config_for,
    dataset_latents,
    latents_cache_path,
    model_output_dir,
    provenance_row,
    reference_images,
    save_removal_indices,
    setup_removal,
    tracker_for,
)

EVAL_PROBE_SEED = 12345
REF_IMAGES = 2048  # training images the in-loop FID's reference stats are taken over
TOWER_BATCH = 256
# Members of one call, all stacked on the card at once, that one 80 GB H100
# holds at the workload's default batch: CIFAR's 3 x 128 and CelebA's 3 x 32.
# The default --chunk_size of shapley_pipeline and shapley_groundtruth.
MEMBERS_PER_CALL = 3


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--method", type=str, default="retrain",
                        choices=constants.METHOD)
    parser.add_argument("--seed_start", type=int, default=0)
    parser.add_argument("--num_seeds", type=int, default=8)
    parser.add_argument("--training_steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--load", type=str, default=None,
                        help="shared start point for every member (a port checkpoint dir)")
    parser.add_argument("--n_samples", type=int, default=0,
                        help="per-member samples to generate after training")
    parser.add_argument("--score", type=str, default="none",
                        choices=["none", "fid", "is", "fid_is"],
                        help="score each member's generated samples in the loop "
                             "(needs --n_samples > 0): one InceptionV3 pass yields "
                             "FID features and IS logits, written to the DB rows "
                             "as fid_value / is")
    parser.add_argument("--inception_weights", type=str, default=None,
                        help="pytorch_fid / torchvision InceptionV3 state dict "
                             "(default: the seeded random tower)")
    parser.add_argument("--ref_stats", type=str, default=None,
                        help="reference-set Inception stats cache, used when its "
                             "tower tag matches, else computed from the training "
                             "set and saved here")
    parser.add_argument("--eval_loss", action="store_true", default=False,
                        help="record a deterministic eval loss per member: "
                             "diffusion loss of the EMA weights on a fixed probe "
                             "batch with fixed noise/timesteps shared across members")
    parser.add_argument("--eval_probe_size", type=int, default=256)
    parser.add_argument("--eval_t_min", type=int, default=0)
    parser.add_argument("--eval_t_max", type=int, default=None,
                        help="probe-timestep band [min, max)")
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="bf16 compute with float32 parameters and optimizer state")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="recompute each resnet/attention block in the backward")
    parser.add_argument("--remat_policy", default=None, choices=list(REMAT_POLICIES),
                        help="selective remat: what each block saves for backward "
                             "(full=nothing, convs=3x3 conv outputs, convs_dots=+dense "
                             "outputs)")
    parser.add_argument(
        "--removal_masks", type=str, default=None,
        help=".npy of explicit keep-masks, one row per removal seed (row "
        "index = seed). Class-level masks (width = #classes) need "
        "--by_class; image-level masks have width = len(dataset). "
        "Use with --removal_dist enum.",
    )
    parser.add_argument(
        "--save_ckpts", action=argparse.BooleanOptionalAction, default=True,
        help="save a checkpoint per member (default). With --no-save_ckpts the "
        "DB row is the completion record for the idempotent skip.",
    )
    parser.add_argument("--independent_noise", action="store_true", default=False,
                        help="per-member independent init/noise draws. Default is "
                             "common random numbers: every member shares the init "
                             "and the per-step slot/timestep/noise draws")
    parser.add_argument("--log_freq", type=int, default=0,
                        help="scan-chunk size and tracker log interval in steps "
                             "(0 = the whole run in one chunk, only the final log); "
                             "the host reads the losses once a chunk")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def _removals(args, dataset, seeds):
    """(remaining, removed) index arrays per seed, from --removal_masks or
    the removal sampler."""
    if args.removal_masks:
        if args.removal_dist != "enum":
            raise SystemExit(
                "--removal_masks requires --removal_dist enum "
                f"(got {args.removal_dist!r})"
            )
        masks = np.load(args.removal_masks)
        if masks.ndim != 2:
            raise SystemExit(
                f"--removal_masks must be 2-D (seeds x units); got shape {masks.shape}"
            )
        if args.seed_start + args.num_seeds > len(masks):
            raise SystemExit(
                f"--removal_masks has {len(masks)} rows but seeds run to "
                f"{args.seed_start + args.num_seeds - 1}"
            )
        expected = (int(dataset.labels.max()) + 1) if args.by_class else len(dataset)
        if masks.shape[1] != expected:
            raise SystemExit(
                f"--removal_masks width {masks.shape[1]} != expected "
                f"{expected} ({'classes, --by_class set' if args.by_class else 'images'})"
            )

        def mask_to_removal(row):
            keep = row.astype(bool)[dataset.labels] if args.by_class else row.astype(bool)
            return (np.flatnonzero(keep).astype(np.int64),
                    np.flatnonzero(~keep).astype(np.int64))

        return [mask_to_removal(masks[s]) for s in seeds]
    if args.removal_dist == "enum":
        raise SystemExit("--removal_dist enum requires --removal_masks")
    return [setup_removal(args, dataset, seed=s) for s in seeds]


def score_members(samples: np.ndarray, extract, ref_stats=None) -> dict:
    """Per-member behaviors of `samples` (M, n, H, W, C) in [0, 1]: one
    feature pass (`extract`, as `make_feature_fn` returns it) over the
    flattened (M*n) stack, gray repeated to RGB, then each member's IS and,
    given reference (mu, sigma), its FID. Returns {"fid": [M] or None, "is":
    [M], "tower_seconds", "fid_seconds"}: the feature pass (its results on
    the host) and the FID math, on the host clock."""
    m, n = samples.shape[:2]
    t0 = time.perf_counter()
    feats, logits = extract(as_rgb(samples.reshape((m * n,) + samples.shape[2:])))
    tower_s = time.perf_counter() - t0
    fid, fid_s = None, 0.0
    if ref_stats is not None:
        t0 = time.perf_counter()
        fid = [calculate_fid_from_features(feats[i * n:(i + 1) * n], ref_stats=ref_stats)
               for i in range(m)]
        fid_s = time.perf_counter() - t0
    is_ = [inception_score_from_logits(logits[i * n:(i + 1) * n])[0] for i in range(m)]
    return {"fid": fid, "is": is_, "tower_seconds": tower_s, "fid_seconds": fid_s}


def _ema_model(model: UNet2D, state: TrainState) -> UNet2D:
    """`model` holding the member's EMA weights."""
    model.load_state_dict(state.state_dicts()[1])
    return model


def main(argv=None):
    """Run the CLI. Returns a summary dict: the seeds trained and skipped,
    the per-member batch size (the smallest subset's size caps it, as in the
    JAX CLI), train and sampling seconds, per-member final loss and eval loss (None
    without --eval_loss), the samples (M, n, C, H, W) as a numpy array (None
    without --n_samples), with --score the per-member FID (None without
    fid) and IS and the seconds of the tower's feature passes (the
    reference set's included) and of the FID math, the DB path and the
    member model dirs; for latent workloads the seconds of the dataset's
    encode (or of reading its cache) and whether the cache was read."""
    args = parse_args(argv)
    if args.score != "none" and args.n_samples <= 0:
        raise SystemExit(f"--score {args.score} needs --n_samples > 0")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # cuDNN's default backward algorithms may sum with atomics; members on
        # identical subsets must stay bit-identical under common noise.
        torch.backends.cudnn.deterministic = True
    cfg = config_for(args.dataset)
    # NOT `or`: --training_steps 0 means the untrained null model (the
    # pipeline's y_v0 anchor), not "use the config budget".
    training_steps = (
        args.training_steps
        if args.training_steps is not None
        else cfg.train.training_steps.get(args.method, 1000)
    )
    batch_size = args.batch_size or cfg.train.batch_size

    dataset = create_dataset(args.dataset, train=True, device=device)
    seeds = list(range(args.seed_start, args.seed_start + args.num_seeds))
    db = args.db or os.path.join(args.outdir, f"{args.dataset}_train_db.jsonl")

    def member_dir(seed: int) -> str:
        return model_output_dir(
            args.outdir, args.dataset, args.method, args.removal_dist, seed,
            args.datamodel_alpha if args.removal_dist == "datamodel" else None,
        )

    def done(seed: int) -> bool:
        latest = get_max_steps(member_dir(seed))
        if latest is not None and latest >= training_steps:
            return True
        if args.save_ckpts or not os.path.exists(db):
            return False
        # Match on every arg that changes the row's value, not just the
        # subset identity.
        cond = {
            "dataset": args.dataset, "method": args.method,
            "removal_dist": args.removal_dist, "removal_seed": seed,
        }
        if args.removal_dist == "datamodel":
            cond["datamodel_alpha"] = args.datamodel_alpha
        for rec in filter_records(db, cond):
            if rec.get("training_steps") not in (training_steps, args.training_steps):
                continue
            if (rec.get("eval_t_min", args.eval_t_min) != args.eval_t_min
                    or rec.get("eval_t_max", args.eval_t_max) != args.eval_t_max):
                continue
            # A row trained without in-loop scoring does not satisfy a scored
            # run: the behavior value is the product.
            if "fid" in args.score and rec.get("fid_value") is None:
                continue
            if "is" in args.score and rec.get("is") is None:
                continue
            return True
        return False

    skipped = [s for s in seeds if done(s)]
    seeds = [s for s in seeds if s not in skipped]
    summary = {"seeds": seeds, "skipped": skipped, "batch_size": None, "train_seconds": 0.0,
               "sample_seconds": 0.0, "losses": [], "eval_losses": None,
               "samples": None, "fid_values": None, "is_values": None,
               "tower_seconds": 0.0, "fid_seconds": 0.0,
               "encode_seconds": 0.0, "latents_cached": None,
               "db": db, "model_dirs": [member_dir(s) for s in seeds]}
    if skipped:
        print(f"skipping {len(skipped)} already-complete seeds: {skipped}")
    if not seeds:
        print("all members already trained; nothing to do")
        return summary

    removals = _removals(args, dataset, seeds)
    member_indices = [r[0] for r in removals]
    empty = [s for s, m in zip(seeds, member_indices) if len(m) == 0]
    if empty:
        raise SystemExit(
            f"removal seeds {empty} keep zero examples; cannot train empty members"
        )

    spec = cfg.unet
    if args.load:
        # The stored (possibly pruned) architecture replaces the config's.
        spec = checkpoint_spec(args.load, spec)
    opt = cfg.train.optimizer
    tx = make_optimizer(
        opt.name, lr=args.lr or opt.lr, weight_decay=opt.weight_decay,
        grad_clip_norm=opt.grad_clip_norm, maximize=args.method in ("ga", "ga_u"),
    )
    decode_fn = None
    if cfg.vqvae is not None:
        # One encode of the whole dataset, shared by every member and cached
        # for every later call on this outdir.
        t0 = time.perf_counter()
        latents, vqvae, cached = dataset_latents(args, cfg, dataset, device)
        cache = latents_cache_path(args.outdir, args.dataset)
        train_data = (latents * cfg.vqvae.scaling_factor).astype(np.float32)
        decode_fn = make_vq_decode_fn(cfg.vqvae, vqvae=vqvae)
        summary.update(encode_seconds=time.perf_counter() - t0, latents_cached=cached)
        print(f"latents {train_data.shape} {'read from' if cached else 'encoded to'} {cache} "
              f"in {summary['encode_seconds']:.2f}s")
    else:
        train_data = ((dataset.images + 1.0) * 127.5).round().astype(np.uint8)
    trainer = EnsembleTrainer(
        tx=tx,
        schedule=make_schedule(cfg.scheduler, device),
        spec=cfg.scheduler,
        images_u8=train_data,
        member_indices=member_indices,
        batch_size=min(batch_size, min(len(m) for m in member_indices)),
        device=device,
        common_noise=not args.independent_noise,
    )
    summary["batch_size"] = trainer.batch_size

    compute_dtype = torch.bfloat16 if args.bf16 else None

    def init_fn(seed: int) -> UNet2D:
        return build_unet(spec, seed, remat=args.remat, compute_dtype=compute_dtype,
                          remat_policy=args.remat_policy)

    params = None
    if args.load:
        params = load_checkpoint(args.load)["params"]
        print(f"all members start from {args.load}")
    stacked = trainer.init_state(init_fn, params=params, seed=args.opt_seed)

    tracker = tracker_for(args, f"{args.dataset}_ensemble_{args.method}")

    def log_chunk(metrics, end):
        if args.log_freq > 0:
            tracker.log({"loss_mean": float(metrics["loss"][-1].mean())}, end)

    t_start = time.time()
    losses = np.full(len(seeds), np.nan)
    if training_steps > 0:
        # Chunks of log_freq steps (one chunk without it), as the JAX CLI scans.
        stacked, metrics = trainer.run_scanned(stacked, training_steps, seed=args.opt_seed,
                                               chunk=args.log_freq or training_steps,
                                               chunk_fn=log_chunk)
        losses = metrics["loss"][-1].cpu().numpy()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.time() - t_start
    if training_steps > 0:
        # Final log regardless of interval ('0 = only final').
        tracker.log({"loss_mean": float(np.mean(losses))}, training_steps)
    # training_steps=0: init-only members (the "null model" y_v0 of the
    # Shapley efficiency constraint), with NaN losses.
    tracker.finish()
    print(f"{len(seeds)} members x {training_steps} steps in {train_time:.1f}s; "
          f"losses {losses.round(4).tolist()}")
    summary.update(train_seconds=train_time, losses=losses.tolist())
    # Each member as a TrainState of its own, for evaluation, sampling and checkpoints.
    states = [unstack_state(stacked, m) for m in range(len(seeds))]
    del stacked

    scratch = UNet2D(spec, compute_dtype=compute_dtype).to(device).eval()
    eval_losses = None
    if args.eval_loss:
        # The probe, its timesteps and its noise come from a CPU generator,
        # so they are the same on every device and for every member. The
        # probe lives in the training space (latents for latent workloads).
        probe_n = min(args.eval_probe_size, len(dataset))
        space = train_data if cfg.vqvae is not None else dataset.images
        probe = torch.from_numpy(space[:probe_n]).permute(0, 3, 1, 2).contiguous()
        gen = torch.Generator().manual_seed(EVAL_PROBE_SEED)
        t_fixed = torch.randint(args.eval_t_min,
                                args.eval_t_max or cfg.scheduler.num_train_timesteps,
                                (probe_n,), generator=gen)
        noise_fixed = torch.randn(probe.shape, generator=gen)
        probe, t_fixed, noise_fixed = (x.to(device) for x in (probe, t_fixed, noise_fixed))
        schedule = make_schedule(cfg.scheduler, device)
        eval_losses = []
        with torch.no_grad():
            x_t = add_noise(schedule, probe, noise_fixed, t_fixed)
            for state in states:
                eps = _ema_model(scratch, state)(x_t, t_fixed)
                eval_losses.append(torch.mean((eps - noise_fixed) ** 2))
        eval_losses = torch.stack(eval_losses).cpu().numpy()
        print(f"eval losses: {eval_losses.round(5).tolist()}")
        summary["eval_losses"] = eval_losses.tolist()

    sample_time = 0.0
    if args.n_samples > 0:
        shape = (args.n_samples, spec.in_channels, spec.sample_size, spec.sample_size)
        t0 = time.time()
        samples = []
        for m, state in enumerate(states):
            sampler = make_sampler(_ema_model(scratch, state), cfg.scheduler, shape,
                                   device=device,
                                   num_inference_steps=args.num_inference_steps,
                                   decode_fn=decode_fn)
            gen = torch.Generator(device=device).manual_seed(derived_seed(args.opt_seed, m))
            samples.append(sampler(generator=gen))
        samples = torch.stack(samples).cpu().numpy()
        sample_time = time.time() - t0
        print(f"sampled {samples.shape} in {sample_time:.1f}s")
        summary.update(sample_seconds=sample_time, samples=samples)

    scores = {"fid": None, "is": None}
    scoring_time = 0.0
    if args.score != "none":
        t0 = time.perf_counter()
        extract = make_feature_fn(load_inception(args.inception_weights, device=device),
                                  batch_size=TOWER_BATCH)
        ref_stats, ref_tower_s = None, 0.0
        if "fid" in args.score:
            tag = inception_tag(args.inception_weights)
            ref_stats = load_reference_stats(args.ref_stats, tag)
            if ref_stats is None:
                t1 = time.perf_counter()
                ref_stats = compute_feature_stats(
                    extract(reference_images(dataset, REF_IMAGES))[0])
                ref_tower_s = time.perf_counter() - t1
                if args.ref_stats:
                    save_stats(args.ref_stats, *ref_stats, tower=tag)
        scores = score_members(samples.transpose(0, 1, 3, 4, 2), extract, ref_stats)
        scoring_time = time.perf_counter() - t0
        tower_s = scores["tower_seconds"] + ref_tower_s
        peak = (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if device.type == "cuda" else "")
        print(f"scored {len(seeds)} members in {scoring_time:.1f}s (tower {tower_s:.2f}s, "
              f"reference set {ref_tower_s:.2f}s of it; FID math {scores['fid_seconds']:.2f}s"
              f"{peak}); fid={scores['fid']}, is={scores['is']}")
        summary.update(fid_values=scores["fid"], is_values=scores["is"],
                       tower_seconds=tower_s, fid_seconds=scores["fid_seconds"])

    for m, seed in enumerate(seeds):
        remaining_idx, removed_idx = removals[m]
        model_dir = member_dir(seed)
        save_removal_indices(model_dir, remaining_idx, removed_idx)
        if args.save_ckpts:
            member_params, member_ema = states[m].state_dicts()
            save_checkpoint(
                model_dir, training_steps, member_params, member_ema, remaining_idx,
                removed_idx, train_time / len(seeds), unet_spec=spec,
            )
        row = provenance_row(
            args,
            removal_seed=seed,
            loss=float(losses[m]),
            eval_loss=float(eval_losses[m]) if eval_losses is not None else None,
            fid_value=float(scores["fid"][m]) if scores["fid"] is not None else None,
            **{"is": float(scores["is"][m]) if scores["is"] is not None else None},
            remaining_idx=remaining_idx,
            removed_idx=removed_idx,
            total_steps_time=train_time / len(seeds),
            sampling_time=sample_time / len(seeds),
            scoring_time=scoring_time / len(seeds),
            model_dir=model_dir,
        )
        append_record(db, row)
    print(f"{len(seeds)} members -> {db}")
    return summary


if __name__ == "__main__":
    main()
