"""Declarative workload configuration registry.

The port's own copy of the JAX package's ``config/registry.py``: the
unconditional and latent workloads, and the text-to-image (miniSD LoRA on
ArtBench) specs at the end of the file. Each workload is a frozen dataclass tree; the U-Net architecture is a
`UNetSpec` that `models.unet2d.UNet2D` consumes directly. Values are
field-for-field those of the JAX package so both build the same networks and
schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetSpec:
    """Architecture of a diffusers-style UNet2D (reference src/ddpm_config.py:48-82).

    ``block_out_channels`` may be any per-block channel counts — structural
    pruning produces a new UNetSpec with reduced channels (see
    `pruning.magnitude`), so pruned models are dense-smaller, never masked.
    """

    sample_size: int
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 256)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D",
        "AttnDownBlock2D",
        "DownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "UpBlock2D",
        "AttnUpBlock2D",
        "UpBlock2D",
    )
    layers_per_block: int = 2
    attention_head_dim: Optional[int] = None  # None => single head of full width
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    downsample_padding: int = 0
    flip_sin_to_cos: bool = False
    freq_shift: float = 1.0
    add_attention: bool = True  # mid-block attention
    dropout: float = 0.0
    # Per-layer channel overrides produced by structural pruning. When set,
    # maps a layer path (e.g. "down_0/res_1/conv1") to its pruned out-channels.
    pruned_channels: Optional[Mapping[str, int]] = None
    # Cross-attention (UNet2DConditionModel) fields; None => unconditional.
    cross_attention_dim: Optional[int] = None

    @property
    def conditional(self) -> bool:
        return self.cross_attention_dim is not None


@dataclasses.dataclass(frozen=True)
class VQVAESpec:
    """VQ-VAE architecture for latent diffusion (reference src/ddpm_config.py:462-483)."""

    sample_size: int = 256
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    layers_per_block: int = 2
    num_vq_embeddings: int = 8192
    norm_num_groups: int = 32
    scaling_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class KLVAESpec:
    """AutoencoderKL (SD 1.x VAE): f=8, 4 latent channels, scaling 0.18215."""

    sample_size: int = 256
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    """Noise-schedule parameters (reference src/ddpm_config.py:83-100,452-461)."""

    kind: str = "ddpm"  # "ddpm" | "ddim"
    num_train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    variance_type: str = "fixed_large"
    timestep_spacing: str = "leading"
    steps_offset: int = 0
    set_alpha_to_one: bool = True  # DDIM final alpha_cumprod


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str = "adam"  # "adam" | "adamw"
    lr: float = 1e-4
    weight_decay: float = 0.0
    lr_schedule: str = "constant"  # "constant" | "cosine"
    warmup_steps: int = 0
    grad_clip_norm: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Per-method training budgets (reference src/ddpm_config.py:26-46 etc.)."""

    batch_size: int
    optimizer: OptimizerSpec
    training_steps: Mapping[str, int]
    ckpt_freq: Mapping[str, int]
    sample_freq: Mapping[str, int]
    n_samples: int = 64
    ema_max_decay: float = 0.9999
    ema_inv_gamma: float = 1.0
    ema_power: float = 0.75


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    dataset: str
    image_size: int
    unet: UNetSpec
    scheduler: SchedulerSpec
    train: TrainSpec
    vqvae: Optional[VQVAESpec] = None

    @property
    def latent_size(self) -> int:
        """Spatial size seen by the U-Net (latents for LDM, pixels otherwise)."""
        return self.unet.sample_size


_CIFAR_UNET = UNetSpec(sample_size=32)

_CIFAR_SCHED = SchedulerSpec()

_CIFAR_OPT = OptimizerSpec(name="adam", lr=1e-4)


def _cifar_like(
    dataset: str,
    training_steps: Mapping[str, int],
    ckpt_freq: Mapping[str, int],
    sample_freq: Mapping[str, int],
) -> WorkloadConfig:
    return WorkloadConfig(
        dataset=dataset,
        image_size=32,
        unet=_CIFAR_UNET,
        scheduler=_CIFAR_SCHED,
        train=TrainSpec(
            batch_size=128,
            optimizer=_CIFAR_OPT,
            training_steps=dict(training_steps),
            ckpt_freq=dict(ckpt_freq),
            sample_freq=dict(sample_freq),
            n_samples=64,
        ),
    )


CIFAR = _cifar_like(
    "cifar",
    training_steps={"retrain": 200000, "prune_fine_tune": 200000, "ga": 2000, "gd": 4000, "esd": 5000},
    ckpt_freq={"retrain": 10000, "prune_fine_tune": 10000, "ga": 400, "gd": 400, "esd": 1000},
    sample_freq={"retrain": 200000, "prune_fine_tune": 200000, "ga": 2000, "gd": 4000, "esd": 5000},
)

CIFAR2 = _cifar_like(
    "cifar2",
    training_steps={"retrain": 20000, "prune_fine_tune": 10000, "ga": 2000, "gd": 4000, "esd": 5000, "if": 1},
    ckpt_freq={"retrain": 10000, "prune_fine_tune": 10000, "ga": 400, "gd": 400, "esd": 1000, "if": 1},
    sample_freq={"retrain": 2000, "prune_fine_tune": 2000, "ga": 400, "gd": 400, "esd": 100, "if": 20},
)

CIFAR100 = _cifar_like(
    "cifar100",
    training_steps={"retrain": 20000, "prune_fine_tune": 10000, "ga": 40, "gd": 1000, "gd_u": 1000, "esd": 5000, "iu": 1},
    ckpt_freq={"retrain": 400, "prune_fine_tune": 5000, "ga": 400, "gd": 500, "gd_u": 500, "esd": 1000, "iu": 1},
    sample_freq={"retrain": 2000, "prune_fine_tune": 2000, "ga": 400, "gd": 500, "gd_u": 4000, "esd": 100, "iu": 20},
)

CIFAR100_F = _cifar_like(
    "cifar100_f",
    training_steps={"retrain": 20000, "prune_fine_tune": 20000, "ga": 40, "gd": 4000, "esd": 5000, "iu": 1},
    ckpt_freq={"retrain": 10000, "prune_fine_tune": 5000, "ga": 400, "gd": 500, "esd": 1000, "iu": 1},
    sample_freq={"retrain": 2000, "prune_fine_tune": 2000, "ga": 400, "gd": 500, "esd": 100, "iu": 20},
)

CELEBA = WorkloadConfig(
    dataset="celeba",
    image_size=256,
    unet=UNetSpec(
        sample_size=64,
        block_out_channels=(224, 448, 672, 896),
        down_block_types=(
            "DownBlock2D",
            "AttnDownBlock2D",
            "AttnDownBlock2D",
            "AttnDownBlock2D",
        ),
        up_block_types=(
            "AttnUpBlock2D",
            "AttnUpBlock2D",
            "AttnUpBlock2D",
            "UpBlock2D",
        ),
        attention_head_dim=32,
        norm_eps=1e-5,
        downsample_padding=1,
        flip_sin_to_cos=True,
        freq_shift=0.0,
    ),
    scheduler=SchedulerSpec(
        kind="ddim",
        beta_start=0.0015,
        beta_end=0.0195,
        beta_schedule="scaled_linear",
        clip_sample=False,
    ),
    train=TrainSpec(
        batch_size=32,
        optimizer=OptimizerSpec(name="adamw", lr=1e-4, weight_decay=0.0),
        training_steps={"retrain": 20000, "prune_fine_tune": 20000, "ga": 5, "gd": 500, "gd_u": 500, "esd": 500},
        ckpt_freq={"retrain": 5000, "prune_fine_tune": 5000, "ga": 1, "gd": 500, "gd_u": 500, "esd": 100},
        sample_freq={"retrain": 200000, "prune_fine_tune": 200000, "ga": 1, "gd": 40000, "gd_u": 5000, "esd": 100},
        n_samples=4,
    ),
    vqvae=VQVAESpec(),
)

MNIST = WorkloadConfig(
    dataset="mnist",
    image_size=28,
    unet=UNetSpec(
        sample_size=32,
        in_channels=1,
        out_channels=1,
        block_out_channels=(128, 128, 256, 512),
        down_block_types=(
            "DownBlock2D",
            "DownBlock2D",
            "AttnDownBlock2D",
            "DownBlock2D",
        ),
        up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D", "UpBlock2D"),
    ),
    scheduler=SchedulerSpec(),
    train=TrainSpec(
        batch_size=64,
        optimizer=OptimizerSpec(name="adam", lr=1e-3),
        training_steps={"retrain": 100, "ga": 5, "gd": 10, "esd": 100},
        ckpt_freq={"retrain": 2, "ga": 1, "gd": 1, "esd": 20},
        sample_freq={"retrain": 20, "ga": 1, "gd": 1, "esd": 20},
        n_samples=500,
    ),
)

IMAGENETTE = WorkloadConfig(
    dataset="imagenette",
    image_size=256,
    unet=UNetSpec(
        sample_size=32,
        in_channels=4,
        out_channels=4,
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=(
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        up_block_types=(
            "UpBlock2D",
            "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D",
        ),
        attention_head_dim=8,
        norm_eps=1e-5,
        downsample_padding=1,
        flip_sin_to_cos=True,
        freq_shift=0.0,
        # ldm-text2im-large-256 conditions on its LDMBert encoder's
        # d_model=1280 hidden states (reference src/diffusion_utils.py:
        # 215-223), so converted real checkpoints load shape-exact.
        cross_attention_dim=1280,
    ),
    scheduler=SchedulerSpec(
        kind="ddim",
        beta_start=0.00085,
        beta_end=0.012,
        beta_schedule="linear",
        clip_sample=False,
    ),
    train=TrainSpec(
        batch_size=64,
        optimizer=OptimizerSpec(name="adamw", lr=1e-4, weight_decay=1e-6),
        training_steps={"retrain": 50000, "ga": 5, "gd": 10, "esd": 150},
        ckpt_freq={"retrain": 2500, "ga": 1, "gd": 1, "esd": 50},
        sample_freq={"retrain": 2500, "ga": 1, "gd": 1, "esd": 50},
        n_samples=60,
    ),
)

_REGISTRY = {
    "cifar": CIFAR,
    "cifar2": CIFAR2,
    "cifar100": CIFAR100,
    "cifar100_f": CIFAR100_F,
    "celeba": CELEBA,
    "mnist": MNIST,
    "imagenette": IMAGENETTE,
}


def get_config(dataset: str) -> WorkloadConfig:
    """Look up the workload config for a dataset name."""
    try:
        return _REGISTRY[dataset]
    except KeyError:
        raise ValueError(
            f"dataset={dataset!r} must be one of {sorted(_REGISTRY)}"
        ) from None


# --- Text-to-image (SD LoRA / ArtBench) configs -----------------------------
# Reference src/ddpm_config.py:605-703.

PROMPTS_ARTBENCH = {
    "art_nouveau": "an Art Nouveau painting",
    "baroque": "a Baroque painting",
    "expressionism": "an Expressionist painting",
    "impressionism": "an Impressionist painting",
    "post_impressionism": "a Post-Impressionist painting",
    "realism": "a Realist painting",
    "renaissance": "a painting from the Renaissance",
    "romanticism": "a Romanticist painting",
    "surrealism": "a Surrealist painting",
    "ukiyo_e": "a ukiyo-e print",
}


@dataclasses.dataclass(frozen=True)
class LoraTrainSpec:
    """SD LoRA fine-tuning recipe (reference src/ddpm_config.py:622-642)."""

    pretrained_model: str = "lambdalabs/miniSD-diffusers"
    resolution: int = 256
    train_batch_size: int = 64
    checkpointing_steps: int = 500
    center_crop: bool = True
    random_flip: bool = True
    num_train_epochs: int = 200
    learning_rate: float = 3e-4
    lr_scheduler: str = "cosine"
    adam_weight_decay: float = 1e-6
    rank: int = 256
    cls_key: str = "style"
    cls: str = "post_impressionism"
    max_train_steps: Optional[int] = None  # unlearning configs cap at 200


ARTBENCH_POST_IMPRESSIONISM_LORA = LoraTrainSpec()
ARTBENCH_NUM_GROUPS = 258  # reference src/ddpm_config.py:700-703

# miniSD (lambdalabs/miniSD-diffusers): SD 1.x U-Net at 256px -> 32x32 latents,
# CLIP ViT-L/14 text conditioning, DDPM scaled_linear schedule
# (the reference's text-to-image base model, src/ddpm_config.py:626).
MINISD_UNET = UNetSpec(
    sample_size=32,
    in_channels=4,
    out_channels=4,
    block_out_channels=(320, 640, 1280, 1280),
    down_block_types=(
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    ),
    up_block_types=(
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    ),
    attention_head_dim=8,
    norm_eps=1e-5,
    downsample_padding=1,
    flip_sin_to_cos=True,
    freq_shift=0.0,
    cross_attention_dim=768,
)

MINISD_SCHEDULER = SchedulerSpec(
    kind="ddim",
    beta_start=0.00085,
    beta_end=0.012,
    beta_schedule="scaled_linear",
    clip_sample=False,
    steps_offset=1,
)

MINISD_VAE = KLVAESpec()
