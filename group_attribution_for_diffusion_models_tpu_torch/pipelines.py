"""High-level pipeline facade: checkpoint -> model -> images.

Port of the JAX package's ``pipelines.py`` (reference src/diffusion_utils.py:
`load_ckpt_model` :111, `build_pipeline` :208, `generate_images` :319,
`run_inference` :360): the model stack of a dataset's workload (pixel-space
DDPM, VQ-latent LDM), EMA-based inference and batched generation on the
port's samplers; and `ImagenetteCaptioner`, the class-to-caption map of the
prompt-conditional path (`cli.main`).

The JAX `Pipeline` caches one compiled sampler for each (batch, steps,
kind). Nothing here compiles; what takes the cache's place is that the
pipeline builds its schedule tables on the device once, for all its calls,
and loads the parameters or the EMA into its module only when the choice
changes between calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .cli.common import checkpoint_spec, config_for, vq_decode_fn_for
from .cli.generate_samples import batch_generator
from .config.registry import WorkloadConfig
from .diffusion.sampling import sample_loop
from .diffusion.schedulers import ScheduleState, make_schedule
from .models.unet2d import UNet2D, build_unet, empty_unet
from .utils.ckpt import load_checkpoint, load_meta
from .utils.device import resolve_device


@dataclasses.dataclass
class Pipeline:
    """A ready-to-sample U-Net with its parameters and EMA (state dicts on
    `device`), its workload config and checkpoint meta. For LDM workloads
    `decode_fn` renders the U-Net's latents to pixels (the reference's
    LDMPipeline carries its vqvae the same way, src/diffusion_utils.py:
    253-276)."""

    cfg: WorkloadConfig
    model: UNet2D
    params: Mapping[str, torch.Tensor]
    ema_params: Mapping[str, torch.Tensor]
    meta: dict
    device: torch.device
    decode_fn: Optional[Callable] = None
    _schedule: Optional[ScheduleState] = dataclasses.field(default=None, repr=False)
    _loaded: Optional[bool] = dataclasses.field(default=None, repr=False)

    @property
    def spec(self):
        return self.model.spec

    def generate_images(self, n_samples: int, seed: int = 42, batch_size: int = 64,
                        num_inference_steps: int = 100, use_ema: bool = True,
                        kind: str = "ddim", eta: float = 0.0) -> np.ndarray:
        """Batched generation (reference generate_images :319-357): (n, H, W,
        C) float images in [0, 1], by `kind` ("ddim" or "ddpm") and DDIM's
        `eta`. Batch b draws its noise from a generator seeded from (seed,
        b), the JAX pipeline's fold_in(PRNGKey(seed), b)."""
        spec = self.spec
        batch = min(batch_size, n_samples)
        if self._schedule is None:
            self._schedule = make_schedule(self.cfg.scheduler, self.device)
        if self._loaded is not use_ema:
            self.model.load_state_dict(self.ema_params if use_ema else self.params)
            self._loaded = use_ema
        chunks = []
        for b in range(math.ceil(n_samples / batch)):
            out = sample_loop(
                self.model, self._schedule, self.cfg.scheduler,
                (batch, spec.in_channels, spec.sample_size, spec.sample_size),
                device=self.device, generator=batch_generator(seed, b, self.device),
                num_inference_steps=num_inference_steps, eta=eta, kind=kind,
                decode_fn=self.decode_fn)
            chunks.append(out.permute(0, 2, 3, 1).cpu().numpy())
        return np.concatenate(chunks)[:n_samples]

    def run_inference(self, n_samples: Optional[int] = None, seed: int = 42,
                      num_inference_steps: int = 100) -> np.ndarray:
        """EMA sample grid like the in-training inference hook (reference
        run_inference :360-416)."""
        return self.generate_images(n_samples or self.cfg.train.n_samples, seed=seed,
                                    num_inference_steps=num_inference_steps, use_ema=True)


def load_ckpt_model(model_dir: str, dataset: str, vqvae_weights: Optional[str] = None,
                    device="cuda") -> Pipeline:
    """The pipeline of the latest checkpoint under `model_dir` for a
    dataset's workload (reference load_ckpt_model :111-205), with the pruned
    spec its meta holds, on `device`."""
    device = resolve_device(str(device))
    cfg = config_for(dataset)
    spec = checkpoint_spec(model_dir, cfg.unet)
    ckpt = load_checkpoint(model_dir)
    model = empty_unet(spec, device=device).eval()
    params = {k: v.to(device) for k, v in ckpt["params"].items()}
    ema = {k: v.to(device) for k, v in ckpt["ema_params"].items()}
    return Pipeline(cfg=cfg, model=model, params=params, ema_params=ema,
                    meta=load_meta(model_dir), device=device,
                    decode_fn=vq_decode_fn_for(cfg, vqvae_weights, device=device))


def build_pipeline(dataset: str, model_dir: Optional[str] = None,
                   vqvae_weights: Optional[str] = None, device="cuda") -> Pipeline:
    """Dataset-conditional pipeline construction (reference build_pipeline
    :208-316): `load_ckpt_model` with a checkpoint, else the seeded random
    init (seed 0) as both parameters and EMA, for smoke flows."""
    if model_dir is not None:
        return load_ckpt_model(model_dir, dataset, vqvae_weights, device)
    device = resolve_device(str(device))
    cfg = config_for(dataset)
    model = build_unet(cfg.unet, 0, device=device).eval()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return Pipeline(cfg=cfg, model=model, params=params, ema_params=params, meta={},
                    device=device, decode_fn=vq_decode_fn_for(cfg, vqvae_weights, device=device))


class ImagenetteCaptioner:
    """Class index -> prompt (reference diffusion_utils.py:29-71)."""

    CLASSES = (
        "tench", "English springer", "cassette player", "chain saw", "church",
        "French horn", "garbage truck", "gas pump", "golf ball", "parachute",
    )

    def __init__(self):
        self.num_classes = len(self.CLASSES)

    def __call__(self, class_indices) -> list:
        return [f"a photo of a {self.CLASSES[i]}." for i in class_indices]
