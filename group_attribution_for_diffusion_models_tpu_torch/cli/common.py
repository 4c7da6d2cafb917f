"""Shared CLI plumbing: workload configs and the common arguments.

Port of the parts of the JAX package's ``cli/common.py`` that sampling
reads: `config_for` (registry lookup, plus the tiny ``synthetic_*`` specs
the tests use) and the `add_common_args` flags ``--dataset`` and
``--num_inference_steps``.
"""

from __future__ import annotations

import argparse

from ..config.registry import (
    OptimizerSpec,
    SchedulerSpec,
    TrainSpec,
    UNetSpec,
    VQVAESpec,
    WorkloadConfig,
    get_config,
)


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


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dataset", type=str, required=True,
                        help="dataset name (incl. synthetic_* for smoke runs)")
    parser.add_argument("--num_inference_steps", type=int, default=100)
