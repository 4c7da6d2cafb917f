"""Shared CLI plumbing: workload configs, output layout, common arguments.

Port of the parts of the JAX package's ``cli/common.py`` that sampling, the
ensemble trainer and the TRAK features read: `config_for` (registry lookup,
plus the tiny ``synthetic_*`` specs the tests use), the model-directory
layout, the JSONL provenance row, the tracker, `add_common_args` without
``--vqvae_weights`` (the LDM slice) and ``--profile_dir`` (a torch profiler
comes later), and `checkpoint_spec`; for the scoring CLIs, the sample
directory loader (`load_sample_dir`) and the reference images of FID; and
for the text-to-image CLIs, the pretrained-tower flags and their loaders
(`add_sd_pretrained_args`, `sd_text_params`, `sd_base_params`); and the
removal split of one job (`setup_removal`), which the single-model jobs and
the ensemble trainer share.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import constants
from ..config.registry import (
    OptimizerSpec,
    SchedulerSpec,
    TrainSpec,
    UNetSpec,
    VQVAESpec,
    WorkloadConfig,
    get_config,
)
from ..data import sample_removal
from ..data.datasets import ArrayDataset
from ..utils.ckpt import load_meta, load_unet_spec
from ..utils.trackers import make_tracker


def config_for(dataset: str) -> WorkloadConfig:
    """Workload config; synthetic_* datasets get a tiny smoke-test config."""
    if not dataset.startswith("synthetic"):
        return get_config(dataset)

    parts = dataset.split("_")
    size = 32
    if len(parts) > 1 and "x" in parts[1]:
        _, size = (int(v) for v in parts[1].split("x"))
    # "synthetic_<n>x<s>_ldm" exercises the VQ-latent (celeba-style) path;
    # "..._cond" the cross-attention (imagenette-style) path; combinable.
    ldm = "ldm" in parts
    cond = "cond" in parts
    vqvae = (
        VQVAESpec(
            sample_size=size, block_out_channels=(8, 16, 16),
            layers_per_block=1, num_vq_embeddings=32, norm_num_groups=4,
        )
        if ldm
        else None
    )
    unet_size = size // 4 if ldm else size
    budgets = {m: 10 for m in ("retrain", "prune_fine_tune", "ga", "gd", "esd")}
    # "..._big": a ~1M-param U-Net with self-attention.
    big = "big" in parts
    return WorkloadConfig(
        dataset=dataset,
        image_size=size,
        unet=UNetSpec(
            sample_size=unet_size,
            block_out_channels=(32, 64) if big else (8, 16),
            down_block_types=(
                ("CrossAttnDownBlock2D", "DownBlock2D")
                if cond
                else (
                    ("DownBlock2D", "AttnDownBlock2D")
                    if big
                    else ("DownBlock2D", "DownBlock2D")
                )
            ),
            up_block_types=(
                ("UpBlock2D", "CrossAttnUpBlock2D")
                if cond
                else (
                    ("AttnUpBlock2D", "UpBlock2D")
                    if big
                    else ("UpBlock2D", "UpBlock2D")
                )
            ),
            layers_per_block=2 if big else 1,
            norm_num_groups=8 if big else 4,
            attention_head_dim=2 if cond else None,
            cross_attention_dim=32 if cond else None,
        ),
        scheduler=SchedulerSpec(),
        train=TrainSpec(
            batch_size=8,
            optimizer=OptimizerSpec(name="adam", lr=1e-3),
            training_steps=budgets,
            ckpt_freq={m: 10 for m in budgets},
            sample_freq={m: 100 for m in budgets},
            n_samples=4,
        ),
        vqvae=vqvae,
    )


def checkpoint_spec(model_dir: str, spec: UNetSpec) -> UNetSpec:
    """The U-Net spec the latest checkpoint under `model_dir` was saved with
    (its meta.json), which wins where it differs from the workload's `spec`
    (a pruned model, as the JAX CLIs read it); `spec` where none is saved."""
    return load_unet_spec(load_meta(model_dir)) or spec


def removal_dir_name(
    removal_dist: str,
    removal_seed: int = 0,
    datamodel_alpha: Optional[float] = None,
) -> str:
    """`full`, or `<dist>/<dist>[_alpha=<a>]_seed=<seed>`."""
    if removal_dist == "full":
        return "full"
    if removal_dist == "datamodel" and datamodel_alpha is not None:
        leaf = f"{removal_dist}_alpha={datamodel_alpha}_seed={removal_seed}"
    else:
        leaf = f"{removal_dist}_seed={removal_seed}"
    return os.path.join(removal_dist, leaf)


def model_output_dir(
    outdir: str,
    dataset: str,
    method: str,
    removal_dist: str,
    removal_seed: int = 0,
    datamodel_alpha: Optional[float] = None,
) -> str:
    return os.path.join(
        outdir, dataset, method, "models",
        removal_dir_name(removal_dist, removal_seed, datamodel_alpha),
    )


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dataset", type=str, required=True,
                        help="dataset name (incl. synthetic_* for smoke runs)")
    parser.add_argument("--outdir", type=str, default=constants.OUTDIR)
    parser.add_argument("--db", type=str, default=None,
                        help="JSONL results database path")
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--opt_seed", type=int, default=42,
                        help="seed for model init / training randomness")
    parser.add_argument("--removal_dist", type=str, default="full",
                        choices=constants.REMOVAL_DIST)
    parser.add_argument("--removal_seed", type=int, default=0)
    parser.add_argument("--datamodel_alpha", type=float, default=0.5)
    parser.add_argument("--removal_idx", type=int, default=None,
                        help="index for loo/aoi removal")
    parser.add_argument("--by_class", action="store_true", default=False)
    parser.add_argument("--num_inference_steps", type=int, default=100)
    parser.add_argument("--vqvae_weights", type=str, default=None,
                        help="VQ-VAE params (.npy, the JAX tree) for latent workloads; "
                             "default: the seeded random tower")
    parser.add_argument("--tracker", type=str, default="none", choices=["none", "jsonl"],
                        help="training-scalar tracker (logs under <outdir>/logs)")


def tracker_for(args, run_name: str):
    """Scalar tracker from common CLI args (logs land under <outdir>/logs)."""
    return make_tracker(
        args.tracker,
        run_name=run_name,
        config={k: v for k, v in vars(args).items()
                if isinstance(v, (int, float, str, bool, type(None)))},
        logdir=os.path.join(args.outdir, "logs"),
    )


def vq_decode_fn_for(cfg: WorkloadConfig, vqvae_weights: Optional[str] = None, device="cuda"):
    """decode_fn for latent workloads (None for pixel-space ones): the frozen
    VQ decoder the samplers run after the denoise loop, on `device`."""
    if cfg.vqvae is None:
        return None
    from ..models.vqvae import make_vq_decode_fn

    return make_vq_decode_fn(cfg.vqvae, vqvae_weights, device=device)


def setup_removal(
    args, dataset: ArrayDataset, seed: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """(remaining, removed) indices of this job from the CLI args: the
    removal split of ``--removal_dist`` at `seed` (default
    ``--removal_seed``), by class with ``--by_class``."""
    if args.removal_dist == "full":
        return np.arange(len(dataset)), np.array([], dtype=np.int64)
    target = dataset.labels if args.by_class else len(dataset)
    return sample_removal(
        args.removal_dist,
        target,
        seed=args.removal_seed if seed is None else seed,
        alpha=args.datamodel_alpha,
        by_class=args.by_class,
        idx=args.removal_idx,
    )


def latents_cache_path(outdir: str, dataset: str) -> str:
    """Where a latent workload's encoded dataset is cached (the JAX layout)."""
    return os.path.join(outdir, dataset, "precomputed_emb", "vqvae_latents.npy")


def dataset_latents(args, cfg: WorkloadConfig, dataset: ArrayDataset, device,
                    cache: bool = True):
    """(latents (N, h, w, c) float32 unscaled, the frozen VQ-VAE on `device`,
    whether a cache was read) for a latent workload: the VQ-VAE of
    ``--vqvae_weights`` (else the seeded random tower) encodes the dataset
    once; with `cache`, through the tagged cache at `latents_cache_path`,
    which either package's cache serves when its tag (or, untagged, its row
    count) matches."""
    from ..models.vqvae import (
        SHARED_TOWER_SEED, cached_latents, load_vqvae, precompute_latents, save_latents)
    from ..utils.ckpt import weights_tag

    vqvae = load_vqvae(cfg.vqvae, args.vqvae_weights, device=device)
    if not cache:
        return precompute_latents(vqvae, dataset.images, batch_size=32), vqvae, False
    path = latents_cache_path(args.outdir, args.dataset)
    tag = {"encoder": weights_tag(args.vqvae_weights, SHARED_TOWER_SEED),
           "dataset": args.dataset}
    latents = cached_latents(path, len(dataset.images), tag)
    if latents is not None:
        return latents, vqvae, True
    latents = precompute_latents(vqvae, dataset.images, batch_size=32)
    save_latents(path, latents, tag)
    return latents, vqvae, False


def provenance_row(args, **extra) -> Dict:
    """vars(args) + extras: the JSONL row schema LDS keys on."""
    row = {k: v for k, v in vars(args).items()}
    row["timestamp"] = time.time()
    row.update(extra)
    return row


def save_removal_indices(model_dir: str, remaining, removed) -> None:
    os.makedirs(model_dir, exist_ok=True)
    np.save(os.path.join(model_dir, "remaining_idx.npy"), np.asarray(remaining))
    np.save(os.path.join(model_dir, "removed_idx.npy"), np.asarray(removed))


def load_sample_dir(path: str) -> np.ndarray:
    """The .png/.jpg images of a directory, in name order, as RGB (N, H, W, 3)
    float32 in [0, 1]."""
    from PIL import Image

    files = sorted(f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg")))
    if not files:
        raise SystemExit(f"no .png or .jpg images in {path}")
    imgs = []
    for f in files:
        with Image.open(os.path.join(path, f)) as im:
            imgs.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
    return np.stack(imgs)


def as_rgb(images: np.ndarray) -> np.ndarray:
    """(..., H, W, C) images with a gray channel repeated to 3, for the towers."""
    return np.repeat(images, 3, axis=-1) if images.shape[-1] == 1 else images


def reference_images(dataset, n: int) -> np.ndarray:
    """The first `n` training images in [0, 1], RGB, NHWC: the reference set
    FID is measured against."""
    return as_rgb(dataset.images[:n] / 2.0 + 0.5)


def add_sd_pretrained_args(parser: argparse.ArgumentParser) -> None:
    """Pretrained-weight entry points of the text-to-image CLIs. Without them
    the towers are the seeded random ones, so the same CLIs run both
    smoke runs and real checkpoints."""
    parser.add_argument("--unet_ckpt", type=str, default=None,
                        help="checkpoint directory of the base U-Net in the port's "
                             "format (as train_ensemble writes it)")
    parser.add_argument("--text_encoder_weights", type=str, default=None,
                        help="CLIP text weights: the .npz of the JAX package's "
                             "cli.convert_weights clip_text, or a torch "
                             "CLIPTextModel state-dict file")
    parser.add_argument("--tokenizer_dir", type=str, default=None,
                        help="dir with CLIP vocab.json + merges.txt "
                             "(required with --text_encoder_weights)")


def validated_text_params(weights_path: str, device="cuda", **config):
    """The CLIP text tower `config` describes, with the weights in
    `weights_path`; a file for a tower of other shapes exits with the first
    mismatches."""
    from ..models.clip_text import load_clip_text

    return load_clip_text(weights_path, device=device, **config)


def sd_text_params(args, device="cuda", **config):
    """(text tower, tokenize) honoring the pretrained flags: the weights of
    ``--text_encoder_weights`` (which needs ``--tokenizer_dir``: hash ids
    would index a real embedding table arbitrarily), else the seeded random
    tower; the CLIP BPE of ``--tokenizer_dir``, else the hash tokenizer."""
    from ..models.clip_text import load_clip_text, load_tokenizer

    if args.text_encoder_weights:
        if not args.tokenizer_dir:
            raise SystemExit(
                "--text_encoder_weights needs --tokenizer_dir "
                "(vocab.json + merges.txt): hash-tokenized prompts would "
                "index the real embedding table with arbitrary ids")
        text = validated_text_params(args.text_encoder_weights, device, **config)
        print(f"loaded text encoder weights from {args.text_encoder_weights}")
    else:
        text = load_clip_text(None, device=device, **config)
    return text, load_tokenizer(args.tokenizer_dir)


def sd_base_params(args, model):
    """The base U-Net: `model` with ``--unet_ckpt``'s params loaded (the
    reference starts from miniSD's UNet2DConditionModel), else as it is
    (the seeded random init)."""
    if not getattr(args, "unet_ckpt", None):
        return model
    from ..utils.ckpt import load_checkpoint

    model.load_state_dict(load_checkpoint(args.unet_ckpt)["params"])
    print(f"loaded base U-Net from {args.unet_ckpt}")
    return model
