"""Shared CLI plumbing: workload configs, output layout, common arguments.

Port of the parts of the JAX package's ``cli/common.py`` that sampling, the
ensemble trainer and the TRAK features read: `config_for` (registry lookup,
plus the tiny ``synthetic_*`` specs the tests use), the model-directory
layout, the JSONL provenance row, the tracker, `add_common_args` (with
``--profile_dir``, a torch.profiler trace of a training loop that
`utils.device_profile` reads), and `checkpoint_spec`; for the scoring CLIs, the sample
directory loader (`load_sample_dir`) and the reference images of FID; and
for the text-to-image CLIs, the pretrained-tower flags and their loaders
(`add_sd_pretrained_args`, `sd_text_params`, `sd_base_params`); the class
conditioning of cli.main's prompt-conditional path (`class_conditioning`);
and the removal split of one job (`setup_removal`), which the single-model
jobs and the ensemble trainer share.
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
    parser.add_argument("--tracker", type=str, default="none",
                        choices=["none", "jsonl", "wandb", "tensorboard"],
                        help="training-scalar tracker (logs under <outdir>/logs)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the training loop here "
                             "(read it with utils.device_profile.parse_trace_dir)")


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


def validated_text_params(weights_path: str, device="cuda", loader=None, **config):
    """The text tower `config` describes, with the weights in `weights_path`;
    a file for a tower of other shapes exits with the first mismatches.
    `loader` defaults to the CLIP text loader; the prompt-conditional path of
    cli.main passes `models.ldm_bert.load_ldm_bert`."""
    if loader is None:
        from ..models.clip_text import load_clip_text as loader

    return loader(weights_path, device=device, **config)


def require_wordpiece(kind: str, tokenizer_dir: Optional[str]) -> None:
    """Exit unless an LDMBert tower has its WordPiece vocab. Without one the
    JAX CLI tokenizes with the CLIP hash tokenizer, whose ids (BOS/EOS/pad
    49406/49407) lie outside LDMBert's 30522-row table: its gather fills
    NaN rows and the run trains on NaN (ROADMAP C4)."""
    if kind == "ldm_bert" and not tokenizer_dir:
        raise SystemExit(
            "--text_encoder_kind ldm_bert needs --tokenizer_dir (a directory with "
            "LDMBert's WordPiece vocab.txt): the CLIP hash tokenizer's ids lie outside "
            "its 30522-token vocabulary, which makes the JAX CLI train on NaN")


def text_tower_config(kind: str, width: int) -> Dict[str, int]:
    """The text tower cli.main conditions a U-Net of cross-attention width
    `width` on, sized as the JAX CLI sizes it: LDMBert by
    `models.ldm_bert.ldm_bert_spec`; CLIP with 12 layers at 768 and over (2
    below), 12 heads where they divide the width (else width // 16)."""
    if kind == "ldm_bert":
        from ..models.ldm_bert import ldm_bert_spec

        return ldm_bert_spec(width)
    return dict(width=width, layers=12 if width >= 768 else 2,
                heads=12 if width % 12 == 0 else max(width // 16, 1))


def class_conditioning(kind: str, width: int, num_classes: int,
                       weights: Optional[str] = None, tokenizer_dir: Optional[str] = None,
                       random_tower: bool = False, dataset: str = "", device="cuda"):
    """(tower, tokenize, class embeddings (num_classes, 77, width) on
    `device`) of the prompt-conditional path (JAX cli/main.py:228-305):
    `pipelines.ImagenetteCaptioner`'s caption of class i % 10 for each
    class, tokenized (LDMBert's WordPiece of `tokenizer_dir`; for CLIP its
    BPE there, else the hash tokenizer) and embedded by the `kind` tower
    ("ldm_bert" or "clip") of `text_tower_config(kind, width)`, with the
    weights in `weights` (which needs `tokenizer_dir`), or the seeded random
    tower with `random_tower`. Exits as the JAX CLI does where neither is
    given, and on an LDMBert tower without its vocab (`require_wordpiece`)."""
    import torch

    from ..pipelines import ImagenetteCaptioner

    require_wordpiece(kind, tokenizer_dir)
    if weights and not tokenizer_dir:
        raise SystemExit(
            "--text_encoder_weights needs --tokenizer_dir "
            "(vocab.txt for ldm_bert, vocab.json + merges.txt for clip): "
            "hash-tokenized prompts would index the real embedding "
            "table with arbitrary ids")
    if not (weights or random_tower):
        raise SystemExit(
            f"dataset {dataset!r} is prompt-conditional: pass "
            "--text_encoder_weights <converted .npz / torch state dict> "
            "(see cli.convert_weights ldm_bert / clip_text), or opt in "
            "to a random encoder with --random_text_encoder")
    config = text_tower_config(kind, width)
    if kind == "ldm_bert":
        from ..models.bert_tokenizer import BertWordPieceTokenizer
        from ..models.ldm_bert import load_ldm_bert as loader

        tokenize = BertWordPieceTokenizer.from_dir(tokenizer_dir)
    else:
        from ..models.clip_text import load_clip_text as loader
        from ..models.clip_text import load_tokenizer

        tokenize = load_tokenizer(tokenizer_dir)
    if weights:
        tower = validated_text_params(weights, device, loader=loader, **config)
        print(f"loaded text encoder weights from {weights}")
    else:
        print("WARNING: conditional training with a RANDOM text encoder — "
              "prompt conditioning carries no semantics (smoke mode)", flush=True)
        tower = loader(None, device=device, quiet=True, **config)
    captioner = ImagenetteCaptioner()
    prompts = captioner([i % captioner.num_classes for i in range(max(num_classes, 1))])
    ids = torch.from_numpy(np.asarray(tokenize(prompts), np.int64)).to(device)
    with torch.no_grad():
        return tower, tokenize, tower(ids)


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
