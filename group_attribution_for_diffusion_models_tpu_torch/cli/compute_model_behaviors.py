"""Model behaviors of text-to-image subset LoRAs: paired generation and scoring.

Port of the JAX package's ``cli/compute_model_behaviors.py`` (reference
text_to_image/compute_model_behaviors.py:167-516), the model-behavior
engine of the SD use case. The reference LoRA (``--reference_lora_dir``,
else the bare base) and the subset LoRA (``--lora_dir``), each merged into
the base weights, sample DDIM latents from one initial noise drawn once
from a generator seeded with ``--seed``: paired generation. The raw final
latents are decoded by the KL VAE (for ``synthetic*``, the channel mean of
the latents stands in) to ``clip(x / 2 + 0.5, 0, 1)``. Each image is scored:
SSIM and NRMSE of the pair, CLIP similarity of the pair's embeddings, the
CLIP prompt score, the aesthetic score, and the subset model's simple
diffusion loss on the reference latents over ``--n_noises`` draws of
timesteps and noise. One JSONL row takes the per-image behaviors, their
0.5/0.75/0.9 quantiles and mean, the seconds of each metric and the removal
indices of the sibling ``removal_idx.csv``; the duplicate guard skips a
(lora_dir, removal_dist, removal_seed, n_samples) already in the DB.

The prompt score compares the image embedding with ``ehs[:, 0, :emb_dim]``,
the text tower's first-token hidden state, as the JAX CLI does (under the
causal mask that state is the same for every prompt: ROADMAP C4). The same
flags as the JAX CLI plus ``--device``; runs on CUDA unless ``--device cpu``
is given, with TF32 off. `main` returns a summary: the row, the seconds of
each metric and the subset model's images.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..config.registry import (
    MINISD_SCHEDULER,
    MINISD_UNET,
    MINISD_VAE,
    PROMPTS_ARTBENCH,
    SchedulerSpec,
)
from ..diffusion import add_noise, make_schedule
from ..diffusion.sampling import sample_loop
from ..models.clip_vision import load_aesthetic_head, load_clip_vision, make_embed_fn
from ..models.lora import load_lora_npz, lora_merge
from ..models.unet2d import build_unet
from ..parallel.ensemble import derived_seed
from ..utils.device import resolve_device
from ..utils.image_metrics import nrmse, ssim
from ..utils.jsonl import append_record, has_record
from .common import add_sd_pretrained_args, provenance_row, sd_base_params, sd_text_params
from .train_text_to_image_lora import tiny_sd_spec

METRICS = ("ssim", "nrmse", "clip_similarity", "clip_prompt_score", "aesthetic_score",
           "simple_loss")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", type=str, default="artbench")
    parser.add_argument("--cls", type=str, default="post_impressionism")
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--db", type=str, required=True)
    parser.add_argument("--reference_lora_dir", type=str, default=None,
                        help="full-model LoRA npz (the paired reference)")
    parser.add_argument("--lora_dir", type=str, required=True,
                        help="subset LoRA npz to score")
    parser.add_argument("--method", type=str, default="retrain")
    parser.add_argument("--removal_dist", type=str, default="shapley")
    parser.add_argument("--removal_seed", type=int, default=0)
    parser.add_argument("--n_samples", type=int, default=50)
    parser.add_argument("--num_inference_steps", type=int, default=100)
    parser.add_argument("--n_noises", type=int, default=3)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no_duplicate", action="store_true", default=True)
    parser.add_argument("--clip_weights", type=str, default=None)
    parser.add_argument("--aesthetic_weights", type=str, default=None)
    parser.add_argument("--vae_weights", type=str, default=None,
                        help="converted AutoencoderKL params (.npy) for "
                             "decoding SD latents before image metrics")
    parser.add_argument("--device", type=str, default="cuda")
    add_sd_pretrained_args(parser)
    return parser.parse_args(argv)


def _unit(e: np.ndarray) -> np.ndarray:
    return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)


def pair_metrics(imgs_ref: torch.Tensor, imgs_sub: torch.Tensor) -> Dict[str, np.ndarray]:
    """SSIM and NRMSE of each pair of images (B, H, W, C) in [0, 1]."""
    return {"ssim": ssim(imgs_ref, imgs_sub).cpu().numpy(),
            "nrmse": nrmse(imgs_ref, imgs_sub).cpu().numpy()}


def clip_metrics(imgs_ref: torch.Tensor, imgs_sub: torch.Tensor,
                 embed: Callable[[np.ndarray], np.ndarray], head: torch.nn.Module,
                 text_emb: np.ndarray) -> Dict[str, np.ndarray]:
    """The cosine of each pair's CLIP embeddings (`embed`, numpy in and out),
    the cosine of the subset image's embedding with `text_emb` (1, D) cut to
    the embedding's width (zeros where D is narrower), and the aesthetic
    `head`'s score of the subset image."""
    emb_ref = embed(imgs_ref[..., :3].cpu().numpy())
    emb_sub = embed(imgs_sub[..., :3].cpu().numpy())
    text_emb = text_emb[:, :emb_sub.shape[1]]
    out = {"clip_similarity": (_unit(emb_ref) * _unit(emb_sub)).sum(axis=1),
           "clip_prompt_score": ((_unit(emb_sub) * _unit(text_emb)).sum(axis=1)
                                 if text_emb.shape[1] == emb_sub.shape[1]
                                 else np.zeros(len(emb_sub)))}
    device = next(head.parameters()).device
    with torch.no_grad():
        out["aesthetic_score"] = head(torch.from_numpy(emb_sub).to(device)).cpu().numpy()
    return out


def loss_draws(n_noises: int, shape: Tuple[int, ...], num_train_timesteps: int, seed: int,
               device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(timesteps (B,), noise of `shape`) of each of `n_noises` draws, draw i
    from a generator seeded from (seed, 77 + i) (the JAX CLI's
    fold_in(key, 77 + i))."""
    draws = []
    for i in range(n_noises):
        gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 77 + i))
        t = torch.randint(0, num_train_timesteps, (shape[0],), generator=gen, device=device)
        draws.append((t, torch.randn(shape, generator=gen, device=device)))
    return draws


def diffusion_loss(model: Callable, schedule, latents: torch.Tensor, context: torch.Tensor,
                   draws: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> np.ndarray:
    """The simple loss mean((eps - noise)^2) of each latent (B, C, h, w),
    averaged over `draws` of (timesteps, noise): `model(x_t, t, context)`
    predicts the noise."""
    losses = []
    with torch.no_grad():
        for t, noise in draws:
            eps = model(add_noise(schedule, latents, noise, t), t, context)
            losses.append(torch.mean((eps - noise) ** 2, dim=(1, 2, 3)).cpu().numpy())
    return np.mean(losses, axis=0)


def quantiles(v: np.ndarray) -> Dict[str, float]:
    return {
        "0.5": float(np.quantile(v, 0.5)),
        "0.75": float(np.quantile(v, 0.75)),
        "0.9": float(np.quantile(v, 0.9)),
        "avg": float(np.mean(v)),
    }


def behavior_fields(behaviors: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The row's per-image values (``generated_image_<i>_<metric>``) and each
    metric's quantiles and mean (``<metric>_<q>``), in the JAX row's order."""
    n = len(behaviors["ssim"])
    fields = {f"generated_image_{i}_{m}": float(behaviors[m][i])
              for i in range(n) for m in METRICS}
    for m in METRICS:
        fields.update({f"{m}_{k}": v for k, v in quantiles(behaviors[m]).items()})
    return fields


def removed_indices(lora_path: str) -> List[int]:
    """The indices of the sibling ``removal_idx.csv`` (header ``idx``), or []."""
    csv = os.path.join(os.path.dirname(lora_path), "removal_idx.csv")
    if not os.path.exists(csv):
        return []
    with open(csv) as f:
        return [int(line) for line in f.read().split()[1:]]


def main(argv=None) -> Dict:
    args = parse_args(argv)
    guard = {
        "lora_dir": args.lora_dir,
        "removal_dist": args.removal_dist,
        "removal_seed": args.removal_seed,
        "n_samples": args.n_samples,
    }
    if args.no_duplicate and has_record(args.db, guard):
        print("record already in DB; skipping (duplicate guard)")
        return {"skipped": True, "db": args.db}

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():  # host clocks read device-complete times
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    synthetic = args.dataset.startswith("synthetic")
    if synthetic:
        spec, sched_spec = tiny_sd_spec(8), SchedulerSpec()
        text_config = dict(width=spec.cross_attention_dim, layers=2, heads=2)
    else:
        spec, sched_spec, text_config = MINISD_UNET, MINISD_SCHEDULER, {}
    model = sd_base_params(args, build_unet(spec, seed=args.seed, device=device))
    model.eval().requires_grad_(False)
    text, tokenize = sd_text_params(args, device, **text_config)
    prompt = PROMPTS_ARTBENCH.get(args.cls, f"a painting, {args.cls}")
    with torch.no_grad():
        ehs = text(torch.from_numpy(tokenize([prompt])).long().to(device))
    del text

    base = model.state_dict()
    subset = lora_merge(base, load_lora_npz(args.lora_dir, device))
    reference = (lora_merge(base, load_lora_npz(args.reference_lora_dir, device))
                 if args.reference_lora_dir else base)

    schedule = make_schedule(sched_spec, device)
    size, ch = spec.sample_size, spec.in_channels
    shape = (args.n_samples, ch, size, size)
    ehs_b = ehs.expand(args.n_samples, *ehs.shape[1:])

    # SD diffuses KL-VAE latents: generate raw latents, decode them to pixels
    # for every image metric, keep them for the diffusion-loss behavior.
    if synthetic:
        def decode(z):  # the inverse of the trainer's channel-mean stand-in encode
            return z.mean(dim=1, keepdim=True).repeat(1, 3, 1, 1)
    else:
        from ..models.vqvae import load_sd_vae

        decode = load_sd_vae(MINISD_VAE, args.vae_weights, device=device).decode

    def unet(state):
        return lambda x, t, c: functional_call(model, state, (x, t, c))

    def generate(state, init):
        lat = sample_loop(unet(state), schedule, sched_spec, shape, device=device,
                          init_noise=init, num_inference_steps=args.num_inference_steps, kind="ddim",
                          encoder_hidden_states=ehs_b, postprocess=False)
        with torch.no_grad():
            imgs = torch.clamp(decode(lat) / 2.0 + 0.5, 0.0, 1.0)
        return lat, imgs.permute(0, 2, 3, 1)

    times = {}
    t0 = time.perf_counter()
    init = torch.randn(shape, generator=torch.Generator(device=device).manual_seed(args.seed),
                       device=device)
    lat_ref, imgs_ref = generate(reference, init)
    _, imgs_sub = generate(subset, init)  # the same initial noise: paired generation
    sync()
    times["generation"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    behaviors = pair_metrics(imgs_ref, imgs_sub)
    times["ssim_nrmse"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vis = load_clip_vision(args.clip_weights, tiny=synthetic, device=device)
    head = load_aesthetic_head(args.aesthetic_weights, dim=vis.proj_dim, device=device)
    behaviors.update(clip_metrics(imgs_ref, imgs_sub, make_embed_fn(vis), head,
                                  ehs[:, 0].cpu().numpy()))
    times["clip_aesthetic"] = time.perf_counter() - t0
    del vis

    t0 = time.perf_counter()
    draws = loss_draws(args.n_noises, lat_ref.shape, sched_spec.num_train_timesteps,
                       args.seed, device)
    behaviors["simple_loss"] = diffusion_loss(unet(subset), schedule, lat_ref, ehs_b, draws)
    sync()
    times["diffusion_loss"] = time.perf_counter() - t0

    row = provenance_row(args, **behavior_fields(behaviors),
                         removed_idx=removed_indices(args.lora_dir), metric_times=times)
    append_record(args.db, row)
    print(f"ssim_avg={np.mean(behaviors['ssim']):.4f} "
          f"aesthetic_avg={np.mean(behaviors['aesthetic_score']):.4f} "
          f"loss_avg={np.mean(behaviors['simple_loss']):.5f} -> {args.db}")
    return {"skipped": False, "db": args.db, "row": row, "seconds": times,
            "images": imgs_sub.cpu().numpy()}


if __name__ == "__main__":
    main()
