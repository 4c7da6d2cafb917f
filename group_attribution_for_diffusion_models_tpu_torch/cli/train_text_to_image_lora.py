"""LoRA fine-tuning of a text-to-image latent-diffusion model on
contributor-group removal subsets.

Port of the JAX package's ``cli/train_text_to_image_lora.py`` (reference
text_to_image/train_text_to_image_lora.py:577-1545):

* The base U-Net, the CLIP text tower and the KL VAE are frozen
  (``requires_grad_(False)``): autograd computes the input gradients through
  the base and the LoRA factors' gradients, never a weight gradient of the
  base. LoRA rides as a side branch (``functional_call`` with
  `models.lora.lora_collection`), no merged copy of the base per member.
* Caption embeddings (style prompt + artist, one per group) and the VAE's
  latents are computed once; the latents are cached under
  ``<outdir>/precomputed_emb/vae_latents.npy`` (the JAX layout, read by
  either package) with a tag of the encoder, dataset and image count beside
  it, and a later call reuses them when the tag matches
  (`models.vqvae.cached_latents`).
* Group-unit removal (artist or filename) samples over the group table with
  the seed-deterministic samplers (`data.groups`) and writes
  removal_idx.csv; ``counterfactual`` removes the top or bottom of a
  ranking.
* Methods: retrain (LoRA from scratch), pruned_ft (continue from a pruned
  LoRA), gd / sparse_gd (from a trained or pruned LoRA); all train the same
  loss, as the JAX CLI does, from ``--lora_dir`` when it is given.
* ``--num_seeds`` members train as one program, as the JAX CLI vmaps them:
  their LoRA trees and AdamW states (weight decay 1e-6, cosine schedule
  over ``--max_train_steps``, the JAX optimizer's clip, a norm per member)
  are stacked, the frozen base is shared, and `members_step` runs them
  through one `members_forward` a microbatch, each kernel launched once for
  every member. Each member's batch indices, timesteps and noise are drawn
  on the device from a generator seeded by (opt_seed, step, removal seed),
  and `members_step` takes them injected. ``--num_seeds`` bounds the
  members that share a launch.

``synthetic*`` datasets run `tiny_sd_spec`, a 2-layer CLIP of width 32 and
the channel mean of the images as stand-in latents; any other dataset needs
per-image file names (``imagenette``, an ArtBench-style folder) and runs at
miniSD width. Idempotence: a member whose ``lora_weights.npz`` exists is
skipped. ``--mesh_ensemble`` and the wandb/tensorboard trackers of the JAX
CLI are not ported.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.registry import (
    MINISD_SCHEDULER,
    MINISD_UNET,
    MINISD_VAE,
    PROMPTS_ARTBENCH,
    SchedulerSpec,
    UNetSpec,
)
from ..data import create_dataset
from ..data.groups import artist_from_filename, counterfactual_split, group_removal_split
from ..diffusion.schedulers import ScheduleState, add_noise, make_schedule
from ..models.lora import (
    LoraTree,
    load_lora_npz,
    lora_collection,
    lora_init,
    lora_num_params,
    save_lora_npz,
    stack_lora_trees,
    unstack_lora_tree,
)
from ..models.unet2d import UNet2D, build_unet, members_forward
from ..parallel.ensemble import derived_seed, pad_member_indices
from ..training.state import Optimizer, OptState, make_optimizer
from ..utils.device import resolve_device
from ..utils.jsonl import append_record
from .common import (
    add_sd_pretrained_args,
    provenance_row,
    sd_base_params,
    sd_text_params,
    tracker_for,
)


def tiny_sd_spec(size: int = 8) -> UNetSpec:
    """Miniature conditional U-Net for smoke tests on synthetic data."""
    return UNetSpec(
        sample_size=size,
        in_channels=4,
        out_channels=4,
        block_out_channels=(16, 32),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block=1,
        norm_num_groups=4,
        attention_head_dim=2,
        cross_attention_dim=32,
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", type=str, default="artbench",
                        help="an image folder with ArtBench-style file names "
                             "('imagenette'), or synthetic_* for smoke runs")
    parser.add_argument("--cls", type=str, default="post_impressionism")
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--db", type=str, default=None)
    parser.add_argument("--method", type=str, default="retrain",
                        choices=["retrain", "pruned_ft", "gd", "sparse_gd"])
    parser.add_argument("--removal_dist", type=str, default="shapley",
                        choices=["uniform", "uniform_paired", "datamodel",
                                 "shapley", "shapley_paired", "loo",
                                 "aoi", "full", "counterfactual"])
    parser.add_argument("--removal_seed", type=int, default=0)
    parser.add_argument("--num_seeds", type=int, default=1,
                        help=">1 trains that many subset LoRAs side by side, "
                             "stacked in one program")
    parser.add_argument("--datamodel_alpha", type=float, default=0.5)
    parser.add_argument("--removal_unit", type=str, default="artist",
                        choices=["artist", "filename"])
    parser.add_argument("--rank_file", type=str, default=None,
                        help="unit-index ranking .npy for counterfactual "
                             "removal (reference :596-604,991-1014)")
    parser.add_argument("--masked_proportion", type=float, default=0.1)
    parser.add_argument("--direction", type=str, default="top",
                        choices=["top", "bottom"])
    parser.add_argument("--rank", type=int, default=256)
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--max_train_steps", type=int, default=200)
    parser.add_argument("--train_batch_size", type=int, default=64)
    parser.add_argument("--snr_gamma", type=float, default=None)
    parser.add_argument("--microbatch", type=int, default=0,
                        help="gradient-accumulation slice size: each member "
                             "sums its batch gradient over batch/microbatch "
                             "slices, one slice's activations alive at a time "
                             "(the whole-batch step up to the order of the "
                             "sums). 0 = whole batch.")
    parser.add_argument("--lora_dir", type=str, default=None,
                        help="trained/pruned LoRA .npz to start from (gd/pruned_ft)")
    parser.add_argument("--opt_seed", type=int, default=42)
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the random base U-Net (without --unet_ckpt)")
    parser.add_argument("--log_freq", type=int, default=50)
    parser.add_argument("--tracker", type=str, default="none", choices=["none", "jsonl"],
                        help="training-scalar tracker (logs under <outdir>/logs)")
    parser.add_argument("--device", type=str, default="cuda")
    add_sd_pretrained_args(parser)
    return parser.parse_args(argv)


def removal_splits(args, files: Sequence[str], units: Sequence[str],
                   seeds: Sequence[int]) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(remaining image indices, removed image indices, kept-unit mask) of
    each seed's member, as the JAX CLI draws them."""
    unit_of = ([artist_from_filename(f) for f in files] if args.removal_unit == "artist"
               else [os.path.basename(f) for f in files])
    removals = []
    for s in seeds:
        if args.removal_dist == "full":
            removals.append((np.arange(len(files)), np.array([], np.int64),
                             np.ones(len(units), np.float32)))
        elif args.removal_dist == "counterfactual":
            if not args.rank_file:
                raise SystemExit("counterfactual removal needs --rank_file")
            remaining, removed = counterfactual_split(
                files, units, np.load(args.rank_file), args.masked_proportion,
                direction=args.direction, unit=args.removal_unit)
            unit_index = {u: i for i, u in enumerate(units)}
            kept = np.ones(len(units), np.float32)
            for r in removed:
                kept[unit_index[unit_of[r]]] = 0.0
            removals.append((remaining, removed, kept))
        else:
            removals.append(group_removal_split(
                files, units, args.removal_dist, s, alpha=args.datamodel_alpha,
                unit=args.removal_unit))
    return removals


def lora_file(args, seed: int) -> str:
    if args.removal_dist == "full":
        leaf = "full"
    elif args.removal_dist == "counterfactual":
        leaf = f"counterfactual_{args.direction}_{args.masked_proportion}"
    else:
        leaf = f"{args.removal_dist}_seed={seed}"
    return os.path.join(args.outdir, f"seed{args.opt_seed}", f"{args.dataset}_{args.cls}",
                        args.method, "models", leaf, "lora_weights.npz")


def lora_leaves(tree: LoraTree) -> List[torch.Tensor]:
    """The tree's tensors in a fixed order (down, up of each projection)."""
    return [ab[k] for ab in tree.values() for k in ("down", "up")]


def members_step(
    model: UNet2D,
    lora: LoraTree,
    tx: Optimizer,
    opt_state: OptState,
    latents: torch.Tensor,
    caption_emb: torch.Tensor,
    img_artist: torch.Tensor,
    idx: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    schedule: ScheduleState,
    snr: Optional[torch.Tensor] = None,
    snr_gamma: Optional[float] = None,
    microbatch: int = 0,
) -> torch.Tensor:
    """One LoRA step of M stacked members on injected draws. `lora` and
    `opt_state` carry a leading member axis (`stack_lora_trees`); member m
    trains on the latents (N, C, h, w) at idx[m], each image's caption
    embedding caption_emb[img_artist[idx[m]]], the timesteps t[m] and
    noise[m] ((M, B) and (M, B, C, h, w)). The loss is the epsilon MSE per
    example, weighted by min(snr_t, gamma) / snr_t with `snr_gamma`,
    averaged; with `microbatch` < batch the gradient is summed over equal
    slices and divided by their count. AdamW updates the stacked leaves in
    place, each member clipped by its own norm. Returns the (M,) losses."""
    lat, ehs = latents[idx], caption_emb[img_artist[idx]]
    leaves = lora_leaves(lora)
    weights = lora_collection(lora)

    def loss_of(sl: slice) -> torch.Tensor:
        t_i, noise_i = t[:, sl], noise[:, sl]
        x_t = add_noise(schedule, lat[:, sl], noise_i, t_i)
        eps = members_forward(model, weights, x_t, t_i, ehs[:, sl])
        err = ((eps - noise_i) ** 2).mean(dim=(2, 3, 4))
        if snr is not None:
            s = snr[t_i]
            err = err * torch.clamp(s, max=snr_gamma) / s
        return err.mean(dim=1)

    batch = idx.shape[1]
    nm = batch // microbatch if 0 < microbatch < batch else 1
    size = batch // nm
    grads, loss = None, None
    with torch.enable_grad():
        for i in range(nm):
            li = loss_of(slice(i * size, (i + 1) * size))
            # Members are independent: the sum's gradient is each member's own.
            g = torch.autograd.grad(li.sum(), leaves)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            loss = li.detach() if loss is None else loss + li.detach()
    if nm > 1:
        grads, loss = [g / nm for g in grads], loss / nm
    tx.update(grads, opt_state, leaves, members=idx.shape[0])
    return loss


def _write_member(args, seed, tree, removal, time_rows, loss, train_time, n_members, db):
    remaining, removed, kept_mask = removal
    path = lora_file(args, seed)
    save_lora_npz(path, tree)
    d = os.path.dirname(path)
    with open(os.path.join(d, "removal_idx.csv"), "w") as f:
        f.write("idx\n")
        f.writelines(f"{i}\n" for i in removed)
    with open(os.path.join(d, "time.csv"), "w") as f:
        f.write("step,elapsed_s\n")
        f.writelines(f"{s},{t:.3f}\n" for s, t in time_rows)
    append_record(db, provenance_row(
        args, removal_seed=seed, loss=loss, remaining_idx=remaining, removed_idx=removed,
        kept_units=np.flatnonzero(kept_mask), lora_params=lora_num_params(tree),
        total_steps_time=train_time / n_members, lora_path=path))
    return path


def main(argv=None) -> Dict:
    """Train the pending members; returns a summary: the seeds trained, their
    LoRA paths, subset sizes and final losses, the effective batch, whether
    the latents came from the cache, each step's seconds (all members) and
    seconds per phase (towers, latents, caption embedding, training)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.removal_dist == "counterfactual" and args.num_seeds > 1:
        # Deterministic removal: every member would overwrite one leaf.
        print("counterfactual removal is deterministic; forcing num_seeds=1")
        args.num_seeds = 1
    seeds = list(range(args.removal_seed, args.removal_seed + args.num_seeds))
    synthetic = args.dataset.startswith("synthetic")
    seconds: Dict[str, float] = {}

    def sync():  # host clocks read device-complete times
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # --- data + groups ------------------------------------------------------
    dataset = create_dataset(args.dataset, train=True, device=device)
    if synthetic:
        files = [f"artist-{lab}_work_{i}.jpg" for i, lab in enumerate(dataset.labels)]
        spec = tiny_sd_spec(dataset.images.shape[1])
        sched_spec, text_config = SchedulerSpec(), dict(width=spec.cross_attention_dim,
                                                        layers=2, heads=2)
    else:
        if dataset.names is None:
            raise SystemExit(f"{args.dataset} needs per-image file names (the artists)")
        files = dataset.names
        spec, sched_spec, text_config = MINISD_UNET, MINISD_SCHEDULER, {}
    if args.removal_unit == "artist":
        units = sorted({artist_from_filename(f) for f in files})
    else:
        units = sorted(files)
    removals = removal_splits(args, files, units, seeds)

    pending = [(s, r) for s, r in zip(seeds, removals) if not os.path.exists(lora_file(args, s))]
    if not pending:
        print("all LoRA weights already exist; nothing to do")
        return {"seeds": [], "lora_paths": []}
    seeds = [s for s, _ in pending]
    removals = [r for _, r in pending]

    # --- frozen towers ------------------------------------------------------
    t0 = time.perf_counter()
    model = build_unet(spec, seed=args.seed, device=device)
    sd_base_params(args, model)
    model.eval().requires_grad_(False)
    text, tokenize = sd_text_params(args, device, **text_config)
    seconds["towers"] = time.perf_counter() - t0

    # --- latents, encoded once (or read from the cache) -----------------------
    t0 = time.perf_counter()
    latents_cached = None
    if synthetic:
        # The channel mean repeated to 4 channels: smoke runs need no VAE.
        latents_all = np.repeat(dataset.images.mean(axis=-1, keepdims=True), 4,
                                axis=-1).astype(np.float32)
    else:
        from ..models.vqvae import (
            SD_VAE_SEED, cached_latents, load_sd_vae, precompute_latents, save_latents)
        from ..utils.ckpt import weights_tag

        cache = os.path.join(args.outdir, "precomputed_emb", "vae_latents.npy")
        tag = {"encoder": weights_tag(None, SD_VAE_SEED), "dataset": args.dataset}
        latents_all = cached_latents(cache, len(dataset.images), tag)
        latents_cached = latents_all is not None
        if not latents_cached:
            vae = load_sd_vae(MINISD_VAE, device=device)
            latents_all = precompute_latents(vae, dataset.images)
            save_latents(cache, latents_all, tag)
            del vae
    latents = torch.from_numpy(latents_all).permute(0, 3, 1, 2).contiguous().to(device)
    sync()
    seconds["latents"] = time.perf_counter() - t0

    # --- one caption embedding per artist: style prompt + artist --------------
    # (per unit in the JAX CLI, where --removal_unit filename then fails to
    # find an image's artist among the units)
    t0 = time.perf_counter()
    prompt = PROMPTS_ARTBENCH.get(args.cls, f"a painting, {args.cls}")
    artists = sorted({artist_from_filename(f) for f in files})
    artist_index = {a: i for i, a in enumerate(artists)}
    with torch.no_grad():
        ids = torch.from_numpy(tokenize([f"{prompt} by {a}" for a in artists])).long()
        caption_emb = text(ids.to(device))
    img_artist = torch.tensor([artist_index[artist_from_filename(f)] for f in files],
                            device=device)
    del text
    sync()
    seconds["embed"] = time.perf_counter() - t0

    schedule = make_schedule(sched_spec, device)
    total_steps = args.max_train_steps
    tx = make_optimizer("adamw", lr=args.learning_rate, weight_decay=1e-6,
                        lr_schedule="cosine", total_steps=total_steps)

    # --- the members' LoRA trees, stacked -------------------------------------
    if args.lora_dir:
        base_tree = load_lora_npz(args.lora_dir, device)
        print(f"LoRA loaded from {args.lora_dir} ({lora_num_params(base_tree)} params)")
        tree = stack_lora_trees([base_tree] * len(seeds))
    else:
        tree = stack_lora_trees([
            lora_init(model, args.rank,
                      generator=torch.Generator(device=device).manual_seed(1000 + s))
            for s in seeds])
    for leaf in lora_leaves(tree):
        leaf.requires_grad_(True)
    opt_state = tx.init(lora_leaves(tree))

    table, sizes = pad_member_indices([r[0] for r in removals], pad_multiple=8)
    table = torch.from_numpy(table).long().to(device)
    batch = min(args.train_batch_size, int(sizes.min()))
    if args.microbatch and batch % args.microbatch:
        raise SystemExit(
            f"--microbatch {args.microbatch} must divide the effective batch {batch} "
            "(the batch is cut into equal accumulation slices)")
    print(f"{len(seeds)} members, subsets of {sizes.tolist()} images, batch {batch}")
    snr = None
    if args.snr_gamma is not None:
        acp = schedule.alphas_cumprod
        snr = acp / (1.0 - acp)

    tracker = tracker_for(args, f"{args.dataset}_lora_{args.method}")
    shape = (batch,) + tuple(latents.shape[1:])
    losses = torch.zeros(len(seeds), device=device)
    time_rows = []
    sync()
    t_start = time.time()
    for step_i in range(total_steps):
        draws = []
        for m, seed in enumerate(seeds):
            gen = torch.Generator(device=device).manual_seed(
                derived_seed(args.opt_seed, step_i, seed))
            slot = torch.randint(0, int(sizes[m]), (batch,), generator=gen, device=device)
            t = torch.randint(0, sched_spec.num_train_timesteps, (batch,), generator=gen,
                              device=device)
            noise = torch.randn(shape, generator=gen, device=device)
            draws.append((table[m][slot], t, noise))
        idx, t, noise = (torch.stack(x) for x in zip(*draws))
        losses = members_step(model, tree, tx, opt_state, latents, caption_emb, img_artist,
                              idx, t, noise, schedule, snr, args.snr_gamma, args.microbatch)
        if (args.log_freq and (step_i + 1) % args.log_freq == 0) or step_i + 1 == total_steps:
            vals = [float(v) for v in losses]
            el = time.time() - t_start
            print(f"Step[{step_i + 1}/{total_steps}] losses={np.round(vals, 4).tolist()} "
                  f"{el:.1f}s", flush=True)
            tracker.log({"loss_mean": float(np.mean(vals)), "elapsed_s": el}, step_i + 1)
        sync()
        time_rows.append((step_i, time.time() - t_start))
    train_time = time.time() - t_start
    seconds["train"] = train_time
    tracker.finish()

    db = args.db or os.path.join(args.outdir, f"{args.dataset}_lora_db.jsonl")
    final = [float(v) for v in losses]
    paths = []
    for m, seed in enumerate(seeds):
        paths.append(_write_member(args, seed, unstack_lora_tree(tree, m), removals[m],
                                   time_rows, final[m], train_time, len(seeds), db))
    print(f"{len(seeds)} LoRA members in {train_time:.1f}s -> {db}")
    return {"seeds": seeds, "lora_paths": paths, "losses": final, "batch": batch,
            "subset_sizes": sizes.tolist(), "latents_cached": latents_cached,
            "lora_params": lora_num_params(unstack_lora_tree(tree, 0)), "train_seconds": train_time,
            "step_seconds": np.diff([0.0] + [t for _, t in time_rows]).tolist(),
            "seconds": seconds, "db": db}


if __name__ == "__main__":
    main()
