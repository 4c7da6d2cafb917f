"""VQ-VAE (diffusers VQModel) and KL VAE (diffusers AutoencoderKL) for
latent diffusion (torch.nn, NCHW).

Port of the JAX package's ``models/vqvae.py``. The CelebA-HQ LDM workload
trains its U-Net in the continuous latent space of a frozen VQ-VAE: 256x256x3
images encode to 64x64x3 latents (three levels, f=4), the U-Net diffuses
those, and decoding quantizes against the 8192-entry codebook before the
decoder (diffusers ``VQModel.decode(force_not_quantize=False)``).

Submodule names are the diffusers VQModel state-dict keys
(``encoder.down_blocks.I.resnets.J``, ``encoder.mid_block.attentions.0``,
``quantize.embedding.weight``, ``decoder.up_blocks.I.upsamplers.0.conv``,
...); `models.convert_diffusers.vqvae_params_{from,to}_jax` carry the JAX
package's parameter tree across, so one ``--vqvae_weights`` ``.npy`` file
serves both packages. GroupNorm(+SiLU) and the mid attention go through
``ops``: the GroupNorm kernels on the card at every level (eps 1e-6), the
mid attention (one head of 512 at 64x64) through the plain route, as the JAX
package sends that head dim to XLA.

The encoder pads (0, 1) before each VALID stride-2 conv, the decoder
upsamples by nearest x2; the codebook lookup is one f32 product and an argmin
(TF32 off, so the card picks the CPU's codes). Without weights the model is
a seeded random init of the JAX init's distributions: flax's lecun_normal
kernels, zero biases, unit GroupNorm scales and a U[0, 1) codebook (not
PRNGKey(7)'s values, which torch cannot draw).

`AutoencoderKL` is the SD 1.x VAE of the text-to-image tier (`KLVAESpec`:
four levels (128, 256, 512, 512), f=8, 4 latent channels, scaling 0.18215):
the same encoder and decoder stacks, the encoder emitting mean and logvar
(2 x 4 channels) through ``quant_conv``, the decoder reading
``post_quant_conv``; its mid attention is one head of 512 at 32x32 (the
plain route again). `models.convert_diffusers.kl_vae_params_{from,to}_jax`
carry the JAX tree across; `load_sd_vae` draws the random tower from
SD_VAE_SEED on the device it runs on.

`precompute_latents` caches a dataset's latents in the JAX layout with a
tag beside them (the encoder, the dataset, the image count), and reads a
cache back only when the tag matches (`cached_latents`): the JAX package
keys its caches by path alone, so another encoder or dataset in the same
outdir would read stale latents.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..attributions.global_scores.inception_v3 import lecun_init_
from ..config.registry import KLVAESpec, VQVAESpec
from ..utils.device import resolve_device
from .layers import Downsample, GroupNormSiLU, ResnetBlock, SelfAttention2D, Upsample

VQ_EPS = 1e-6  # every GroupNorm of the VQ-VAE, as the JAX modules' default
SHARED_TOWER_SEED = 7  # the random tower every CLI shares (the JAX CLIs' PRNGKey(7))
SD_VAE_SEED = 2  # the random KL VAE of the text-to-image CLIs (the JAX PRNGKey(2))


def _mid_block(ch: int, groups: int) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock(ch, ch, None, groups=groups, eps=VQ_EPS)
                                 for _ in range(2)])
    mid.attentions = nn.ModuleList([SelfAttention2D(ch, None, groups, VQ_EPS)])
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    """Images (B, C, H, W) in [-1, 1] -> pre-quantization latents (B, lc, H/4, W/4)
    for the default three levels."""

    def __init__(self, spec: VQVAESpec):
        super().__init__()
        boc, groups = spec.block_out_channels, spec.norm_num_groups
        self.conv_in = nn.Conv2d(spec.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, out in enumerate(boc):
            block = nn.Module()
            block.resnets = nn.ModuleList()
            for _ in range(spec.layers_per_block):
                block.resnets.append(ResnetBlock(ch, out, None, groups=groups, eps=VQ_EPS))
                ch = out
            if i < len(boc) - 1:
                block.downsamplers = nn.ModuleList([Downsample(ch, ch, padding=0)])
            self.down_blocks.append(block)
        self.mid_block = _mid_block(ch, groups)
        self.conv_norm_out = GroupNormSiLU(ch, groups, VQ_EPS)
        self.conv_out = nn.Conv2d(ch, spec.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    """Latents (B, lc, h, w) -> images (B, C, 4h, 4w), the encoder mirrored."""

    def __init__(self, spec: VQVAESpec):
        super().__init__()
        rev, groups = tuple(reversed(spec.block_out_channels)), spec.norm_num_groups
        self.conv_in = nn.Conv2d(spec.latent_channels, rev[0], 3, padding=1)
        ch = rev[0]
        self.mid_block = _mid_block(ch, groups)
        self.up_blocks = nn.ModuleList()
        for i, out in enumerate(rev):
            block = nn.Module()
            block.resnets = nn.ModuleList()
            for _ in range(spec.layers_per_block + 1):
                block.resnets.append(ResnetBlock(ch, out, None, groups=groups, eps=VQ_EPS))
                ch = out
            if i < len(rev) - 1:
                block.upsamplers = nn.ModuleList([Upsample(ch, ch)])
            self.up_blocks.append(block)
        self.conv_norm_out = GroupNormSiLU(ch, groups, VQ_EPS)
        self.conv_out = nn.Conv2d(ch, spec.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class VectorQuantizer(nn.Module):
    """The codebook (``quantize.embedding.weight``, (K, lc)) and its lookup."""

    def __init__(self, num_embeddings: int, channels: int):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, channels)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(quantized (B, lc, h, w), codes (B, h, w)): the nearest codebook
        entry of each latent vector by |z|^2 - 2 z.e + |e|^2 in f32, the JAX
        module's formula and order, with TF32 off for the product."""
        codebook = self.embedding.weight
        b, c, h, w = z.shape
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():  # the argmin passes no gradient; the lookup does
                flat = z.permute(0, 2, 3, 1).reshape(-1, c)
                d = ((flat ** 2).sum(dim=1, keepdim=True) - (2.0 * flat) @ codebook.T
                     + (codebook ** 2).sum(dim=1)[None, :])
                idx = d.argmin(dim=1)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        quantized = codebook[idx].reshape(b, h, w, c).permute(0, 3, 1, 2)
        return quantized, idx.reshape(b, h, w)


class VQVAE(nn.Module):
    """VQModel: encoder -> quant_conv -> [codebook] -> post_quant_conv -> decoder."""

    def __init__(self, spec: VQVAESpec):
        super().__init__()
        self.spec = spec
        lc = spec.latent_channels
        self.encoder = Encoder(spec)
        self.quant_conv = nn.Conv2d(lc, lc, 1)
        self.quantize = VectorQuantizer(spec.num_vq_embeddings, lc)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)
        self.decoder = Decoder(spec)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Continuous (pre-quantization) latents: the diffusion space."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        if not force_not_quantize:
            z, _ = self.quantize(z)
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def init_vqvae(spec: VQVAESpec, seed: int) -> VQVAE:
    """A VQVAE with the JAX init's distributions drawn from `seed` (module
    order), without touching the caller's global random state."""
    model = VQVAE(spec)
    gen = torch.Generator().manual_seed(seed)
    lecun_init_(model, gen)
    with torch.no_grad():
        model.quantize.embedding.weight.uniform_(0.0, 1.0, generator=gen)
    return model


def load_vqvae(spec: VQVAESpec, weights_path: Optional[str] = None, quiet: bool = False,
               device="cuda") -> VQVAE:
    """The frozen VQ-VAE of an LDM workload, in eval mode on `device`: the
    JAX parameter tree in `weights_path` (``np.save`` of a dict, as either
    package's ``train_vqvae`` writes it), else the random init from
    SHARED_TOWER_SEED, one tower across train, sample and score."""
    from .convert_diffusers import vqvae_params_from_jax

    model = VQVAE(spec)
    if weights_path:
        tree = np.load(weights_path, allow_pickle=True).item()
        model.load_state_dict(vqvae_params_from_jax(tree))
    else:
        model = init_vqvae(spec, SHARED_TOWER_SEED)
        if not quiet:
            print("WARNING: VQ-VAE running random-init (no vqvae weights); "
                  "outputs are not reference-comparable")
    return model.eval().requires_grad_(False).to(resolve_device(str(device)))


def make_vq_decode_fn(spec: VQVAESpec, weights_path: Optional[str] = None,
                      quiet: bool = False, device="cuda", vqvae: Optional[VQVAE] = None):
    """decode_fn for the samplers: scaled U-Net latents (B, lc, h, w) ->
    images in [-1, 1], undoing the trainer's ``* scaling_factor`` and running
    quantize -> post_quant_conv -> decoder on the latents' device. `vqvae`
    reuses a loaded tower."""
    vqvae = vqvae or load_vqvae(spec, weights_path, quiet=quiet, device=device)
    scale = spec.scaling_factor

    def decode_fn(z: torch.Tensor) -> torch.Tensor:
        return vqvae.decode(z / scale)

    return decode_fn


def _tag_path(cache_path: str) -> str:
    return os.path.splitext(cache_path)[0] + ".tag.json"


def cached_latents(cache_path: str, count: int,
                   tag: Optional[Mapping[str, str]] = None) -> Optional[np.ndarray]:
    """The latents cached at `cache_path` when they may stand for `count`
    images encoded as `tag` ({"encoder": `utils.ckpt.weights_tag`, "dataset"})
    says, else None, saying
    on stdout why a cache is passed over. A tagged cache is read only when
    its tag (encoder, dataset, image count) matches. A cache with no tag
    (the JAX package writes none) is read when its row count matches, and
    that is said too."""
    if not os.path.exists(cache_path):
        return None
    rows = np.load(cache_path, mmap_mode="r").shape[0]
    have = None
    if os.path.exists(_tag_path(cache_path)):
        with open(_tag_path(cache_path)) as f:
            have = json.load(f)
    if have is not None and tag is not None:
        want = dict(tag, images=count)
        if have != want:
            print(f"latents cache {cache_path} is stale (tagged {have}, wanted {want}); "
                  "recomputing")
            return None
    elif rows != count:
        print(f"latents cache {cache_path} holds {rows} rows for {count} images; recomputing")
        return None
    elif have is None:
        print(f"latents cache {cache_path} has no tag (written by the JAX package or "
              f"without one); read, since its {rows} rows match the dataset")
    return np.load(cache_path)


def precompute_latents(vqvae: nn.Module, images: np.ndarray, batch_size: int = 64,
                       cache_path: Optional[str] = None,
                       tag: Optional[Mapping[str, str]] = None) -> np.ndarray:
    """Encode the whole dataset once with `vqvae.encode` (a VQVAE's
    continuous latents, or an AutoencoderKL's scaled means): (N, H, W, C)
    float32 images in [-1, 1] -> (N, h, w, lc) float32 latents, the JAX
    layout, aligned with the dataset's order. With `cache_path` they are
    read from a cache `cached_latents` accepts (from either package), else
    encoded and saved there, with `tag` ({"encoder": `utils.ckpt.weights_tag`,
    "dataset": name}) and the image count in a ``.tag.json`` beside it."""
    if cache_path is not None:
        hit = cached_latents(cache_path, len(images), tag)
        if hit is not None:
            return hit
    device = next(vqvae.parameters()).device
    outs = []
    with torch.no_grad():
        for i in range(0, len(images), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch_size]))
            z = vqvae.encode(x.permute(0, 3, 1, 2).to(device))
            outs.append(z.permute(0, 2, 3, 1).cpu().numpy())
    latents = np.concatenate(outs).astype(np.float32)
    if cache_path is not None:
        save_latents(cache_path, latents, tag)
    return latents


def save_latents(cache_path: str, latents: np.ndarray,
                 tag: Optional[Mapping[str, str]] = None) -> None:
    """Write the latents cache and, with `tag`, its ``.tag.json`` (the tag
    and the row count); without one, no tag stays beside the new cache."""
    os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
    np.save(cache_path, latents)
    if tag is not None:
        with open(_tag_path(cache_path), "w") as f:
            json.dump(dict(tag, images=len(latents)), f)
    elif os.path.exists(_tag_path(cache_path)):
        os.remove(_tag_path(cache_path))


class AutoencoderKL(nn.Module):
    """KL VAE (SD 1.x): the encoder emits (mean, logvar); decode is
    deterministic. Images (B, 3, H, W) in [-1, 1] <-> latents (B, 4, H/8, W/8)
    scaled by `spec.scaling_factor`."""

    def __init__(self, spec: KLVAESpec):
        super().__init__()
        self.spec = spec
        lc = spec.latent_channels
        common = dict(sample_size=spec.sample_size, in_channels=spec.in_channels,
                      out_channels=spec.out_channels,
                      block_out_channels=tuple(spec.block_out_channels),
                      layers_per_block=spec.layers_per_block,
                      norm_num_groups=spec.norm_num_groups)
        self.encoder = Encoder(VQVAESpec(latent_channels=2 * lc, **common))  # mean + logvar
        self.decoder = Decoder(VQVAESpec(latent_channels=lc, **common))
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar clipped to [-30, 20]), unscaled."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The mean latents, or with a `generator` a sample mean + std * eps,
        times the scaling factor."""
        mean, logvar = self.encode_moments(x)
        if generator is not None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                              dtype=mean.dtype)
            mean = mean + torch.exp(0.5 * logvar) * eps
        return mean * self.spec.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z / self.spec.scaling_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def load_sd_vae(spec: KLVAESpec, weights_path: Optional[str] = None, quiet: bool = False,
                device="cuda") -> AutoencoderKL:
    """The frozen SD VAE in eval mode on `device`: the JAX AutoencoderKL
    param tree in `weights_path` (``np.save`` of a dict), else the random
    init from SD_VAE_SEED, drawn on `device`: one tower for every consumer
    on that device (trainer latents, sampling), as the JAX package seeds
    its own."""
    from .convert_diffusers import kl_vae_params_from_jax

    device = resolve_device(str(device))
    with device:
        model = AutoencoderKL(spec)
    if weights_path:
        tree = np.load(weights_path, allow_pickle=True).item()
        model.load_state_dict(kl_vae_params_from_jax(tree))
    else:
        lecun_init_(model, torch.Generator(device=device).manual_seed(SD_VAE_SEED))
        if not quiet:
            print("WARNING: SD VAE running random-init (no weights); "
                  "outputs are not reference-comparable")
    return model.eval().requires_grad_(False)
