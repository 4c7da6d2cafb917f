"""Prompt-conditioned sample generation from a (LoRA-adapted) SD model.

Port of the JAX package's ``cli/generate_samples_tti.py`` (reference
text_to_image/generate_samples.py): DDIM samples per ArtBench style prompt,
``<sample_outdir>/<style>/<style>_NNNNN.png``, with the completed (style,
batch) units kept in ``generation_state.json`` so an interrupted run resumes
where it stopped. A batch's initial noise comes from a generator seeded by
(seed, style, batch index), so a resumed run draws what the first would
have. The LoRA of ``--lora_dir`` is merged into the base weights once
(`models.lora.lora_merge`).

As in the JAX CLI, a PNG holds the first three channels of the final
latents in [0, 1], not decoded by the VAE (the reference decodes through
its pipeline's VAE; ROADMAP C3). The JAX CLI seeds a batch with Python's
``hash(style)``, which changes from process to process; the port hashes the
style name with CRC-32.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import zlib
from typing import Dict

import numpy as np
import torch

from ..config.registry import MINISD_SCHEDULER, MINISD_UNET, PROMPTS_ARTBENCH, SchedulerSpec
from ..diffusion import make_schedule
from ..diffusion.sampling import sample_loop
from ..models.lora import load_lora_npz, lora_merge
from ..models.unet2d import build_unet
from ..parallel.ensemble import derived_seed
from ..utils.device import resolve_device
from .common import add_sd_pretrained_args, sd_base_params, sd_text_params
from .train_text_to_image_lora import tiny_sd_spec


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", type=str, default="artbench",
                        help="synthetic_* samples the tiny smoke-test towers, "
                             "anything else miniSD's")
    parser.add_argument("--styles", type=str, nargs="+", default=["post_impressionism"])
    parser.add_argument("--lora_dir", type=str, default=None)
    parser.add_argument("--n_samples_per_style", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_inference_steps", type=int, default=100)
    parser.add_argument("--sample_outdir", type=str, required=True)
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the random base U-Net and of the initial noise")
    parser.add_argument("--ckpt_freq", type=int, default=1,
                        help="batches between progress-state saves")
    parser.add_argument("--device", type=str, default="cuda")
    add_sd_pretrained_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> Dict:
    """Returns the PNGs written and each generated batch's seconds (host
    clock around sampling and writing, ended by a device synchronise)."""
    from PIL import Image

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.dataset.startswith("synthetic"):
        spec, sched_spec = tiny_sd_spec(8), SchedulerSpec()
        text_config = dict(width=spec.cross_attention_dim, layers=2, heads=2)
    else:
        spec, sched_spec, text_config = MINISD_UNET, MINISD_SCHEDULER, {}
    model = sd_base_params(args, build_unet(spec, seed=args.seed, device=device))
    if args.lora_dir:
        model.load_state_dict(lora_merge(model.state_dict(),
                                         load_lora_npz(args.lora_dir, device)))
    model.eval().requires_grad_(False)
    text, tokenize = sd_text_params(args, device, **text_config)
    schedule = make_schedule(sched_spec, device)

    os.makedirs(args.sample_outdir, exist_ok=True)
    state_path = os.path.join(args.sample_outdir, "generation_state.json")
    done = set()
    if os.path.exists(state_path):
        with open(state_path) as f:
            done = {tuple(x) for x in json.load(f)["done"]}
        print(f"resuming: {len(done)} (style, batch) units complete")

    batch = min(args.batch_size, args.n_samples_per_style)
    size, ch = spec.sample_size, spec.in_channels
    n_batches = -(-args.n_samples_per_style // batch)
    written, batch_seconds = [], []
    for style in args.styles:
        prompt = PROMPTS_ARTBENCH.get(style, f"a painting, {style}")
        with torch.no_grad():
            ehs = text(torch.from_numpy(tokenize([prompt])).long().to(device))
        ehs_b = ehs.expand(batch, *ehs.shape[1:])
        style_dir = os.path.join(args.sample_outdir, style)
        os.makedirs(style_dir, exist_ok=True)
        for b in range(n_batches):
            if (style, b) in done:
                continue
            t0 = time.perf_counter()
            gen = torch.Generator(device=device).manual_seed(
                derived_seed(args.seed, zlib.crc32(style.encode()), b))
            imgs = sample_loop(model, schedule, sched_spec, (batch, ch, size, size),
                               device=device, generator=gen,
                               num_inference_steps=args.num_inference_steps, kind="ddim",
                               encoder_hidden_states=ehs_b)
            u8 = (imgs[:, :3] * 255).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
            for i in range(len(u8)):
                idx = b * batch + i
                if idx >= args.n_samples_per_style:
                    break
                path = os.path.join(style_dir, f"{style}_{idx:05d}.png")
                Image.fromarray(np.ascontiguousarray(u8[i])).save(path)
                written.append(path)
            batch_seconds.append(time.perf_counter() - t0)
            done.add((style, b))
            if (b + 1) % args.ckpt_freq == 0 or b + 1 == n_batches:
                with open(state_path, "w") as f:
                    json.dump({"done": sorted(list(d) for d in done)}, f)
            print(f"{style}: batch {b + 1}/{n_batches}", flush=True)
    print(f"samples in {args.sample_outdir}")
    return {"written": written, "batch_seconds": batch_seconds}


if __name__ == "__main__":
    main()
