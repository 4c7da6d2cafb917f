"""Projected per-sample LoRA gradient features of the text-to-image tier.

Port of the JAX package's ``cli/grad_features_tti.py`` (reference
text_to_image/grad_text_to_image_lora.py:255-823): D-TRAK/TRAK features
differentiated with respect to the LoRA factors alone, the base held fixed,
under text conditioning, for three sources: the training set's latents
(each image with its artist unit's caption, ``<style prompt> by <unit>``),
latents freshly generated from the LoRA'd model, and the latents that
sampling visited (Journey TRAK). The per-sample gradient is
``torch.func.vmap(torch.func.grad(f))`` through the kernels' `vmap` rules
with a context for each sample (`attributions.methods.trak`, ``lora=``,
``conditional=True``), flattened in the JAX leaf order, and the timestep
mean is projected by the JL kernel. ``--grad_mode probe`` merges the LoRA
into the base and sketches every attention projection instead.

Outputs, as the JAX CLI writes them: an ``.npz`` store {train_features |
gen_features, group_labels}, merged into an existing one, for
``cli.traks``; the ``<save_path>_<source>_mm.npy`` memmap, filled a batch at
a time; and ``group.csv`` (row, unit) beside the store for the train
source. The train source reads the latents cache
``<outdir>/precomputed_emb/vae_latents.npy`` that the LoRA trainer writes,
when its tag (encoder, dataset, image count) matches, else encodes again.

Initial noise of sampling comes from a generator seeded with ``--seed``;
each batch's feature noise from one seeded from (seed + 1, batch), apart
from sampling's. The output function compares the prediction with the
whole noise, not the JAX CLI's first row of it (ROADMAP C3). The same flags
as the JAX CLI plus ``--device``; runs on CUDA unless ``--device cpu`` is
given, with TF32 off. `main` returns a summary: shapes, seconds per batch
split into gradients and projection, sampling seconds and launches.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.func import functional_call

from .. import ops
from ..attributions.methods.trak import (
    OUTPUT_FNS,
    make_grad_feature_fn,
    make_journey_feature_fn,
)
from ..config.registry import (
    MINISD_SCHEDULER,
    MINISD_UNET,
    MINISD_VAE,
    PROMPTS_ARTBENCH,
    SchedulerSpec,
)
from ..data import create_dataset
from ..data.groups import artist_from_filename
from ..diffusion import make_schedule, sample_loop, sample_with_trajectory
from ..models.lora import load_lora_npz, lora_merge, probe_sketch_init
from ..models.unet2d import build_unet
from ..ops.jl_projection import jl_project
from ..utils.device import resolve_device
from .common import add_sd_pretrained_args, sd_base_params, sd_text_params
from .generate_samples import batch_generator
from .grad_features import _save_store
from .train_text_to_image_lora import tiny_sd_spec


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", type=str, default="artbench")
    parser.add_argument("--cls", type=str, default="post_impressionism")
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--lora_dir", type=str, required=True,
                        help="trained LoRA .npz whose params are differentiated")
    parser.add_argument("--source", type=str, default="train",
                        choices=["train", "generated", "generated_journey"])
    parser.add_argument("--output_fn", type=str, default="loss",
                        choices=list(OUTPUT_FNS))
    parser.add_argument("--proj_dim", type=int, default=4096)
    parser.add_argument("--num_timesteps", type=int, default=10)
    parser.add_argument("--t_strategy", type=str, default="uniform",
                        choices=["uniform", "cumulative"])
    parser.add_argument("--proj_seed", type=int, default=0)
    parser.add_argument("--grad_mode", type=str, default="full",
                        choices=["full", "probe"],
                        help="probe = Kronecker-probe gradient sketching of "
                             "the merged model's attention projections "
                             "(per-sample grads sketched in the backward, "
                             "never materialized)")
    parser.add_argument("--sketch_k", type=int, default=64,
                        help="input-side sketch rows per projection "
                             "(--grad_mode probe)")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--n_samples", type=int, default=50)
    parser.add_argument("--num_inference_steps", type=int, default=100)
    parser.add_argument("--max_examples", type=int, default=None)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--vae_weights", type=str, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda")
    add_sd_pretrained_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {"source", "features_shape", "grad_dim",
    "batch_seconds", "grad_seconds", "jl_seconds", "sample_seconds",
    "launches", "save_path"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():  # host clocks read device-complete times
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    synthetic = args.dataset.startswith("synthetic")
    dataset = create_dataset(args.dataset, train=True, device=device)
    if synthetic:
        files = [f"artist-{lab}_work_{i}.jpg" for i, lab in enumerate(dataset.labels)]
        spec, sched_spec = tiny_sd_spec(dataset.images.shape[1]), SchedulerSpec()
        text_config = dict(width=spec.cross_attention_dim, layers=2, heads=2)
    else:
        if dataset.names is None:
            raise SystemExit(f"{args.dataset} needs per-image file names (the artists)")
        files = dataset.names
        spec, sched_spec, text_config = MINISD_UNET, MINISD_SCHEDULER, {}
    latent_shape = (4, spec.sample_size, spec.sample_size)

    units = sorted({artist_from_filename(f) for f in files})
    unit_index = {u: i for i, u in enumerate(units)}
    group_labels = np.asarray([unit_index[artist_from_filename(f)] for f in files], np.int64)

    model = sd_base_params(args, build_unet(spec, seed=args.seed, device=device))
    model.eval().requires_grad_(False)
    text, tokenize = sd_text_params(args, device, **text_config)
    lora = load_lora_npz(args.lora_dir, device)
    schedule = make_schedule(sched_spec, device)
    launches0 = ops.launch_counts()

    prompt = PROMPTS_ARTBENCH.get(args.cls, f"a painting, {args.cls}")
    with torch.no_grad():
        unit_emb = text(torch.from_numpy(tokenize([f"{prompt} by {u}" for u in units]))
                        .long().to(device))
        prompt_emb = text(torch.from_numpy(tokenize([prompt])).long().to(device))
    del text
    sample_s = 0.0

    def sample(fn, **kw):
        """`fn` (a sampler) of n_samples from the LoRA merged into the base,
        the prompt's context, initial noise from a generator seeded with
        --seed."""
        nonlocal sample_s
        t0 = time.perf_counter()
        merged = lora_merge(model.state_dict(), lora)
        ctx = prompt_emb.expand(args.n_samples, *prompt_emb.shape[1:])
        out = fn(lambda x, t, c: functional_call(model, merged, (x, t, c)), schedule,
                 sched_spec, (args.n_samples, *latent_shape),
                 device=device, generator=torch.Generator(device=device).manual_seed(args.seed),
                 num_inference_steps=args.num_inference_steps, encoder_hidden_states=ctx, **kw)
        sync()
        sample_s += time.perf_counter() - t0
        return out, ctx

    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
    if args.source == "generated_journey":
        (_, traj, ts), ctx = sample(sample_with_trajectory)
        journey_fn = make_journey_feature_fn(
            model, schedule, sched_spec, output_fn=args.output_fn, proj_dim=args.proj_dim,
            proj_seed=args.proj_seed, lora=lora, conditional=True)
        t0 = time.perf_counter()
        g = journey_fn.mean_gradients(traj, ts, generator=batch_generator(args.seed + 1, 0,
                                                                         device),
                                      encoder_hidden_states=ctx)
        sync()
        t1 = time.perf_counter()
        feats = jl_project(g, args.proj_dim, seed=args.proj_seed).cpu().numpy()
        t2 = time.perf_counter()
        del g
        _save_store(args.save_path, {"gen_features": feats})
        print(f"journey gen_features {feats.shape} -> {args.save_path}")
        return _summary(args, feats, journey_fn.dim, [t2 - t0], [t1 - t0], [t2 - t1],
                        sample_s, launches0)

    if args.source == "train":
        if synthetic:  # the trainer's stand-in encode: the channel mean
            latents = np.repeat(dataset.images.mean(axis=-1, keepdims=True), 4,
                                axis=-1).astype(np.float32)
        else:
            from ..models.vqvae import (
                SD_VAE_SEED, cached_latents, load_sd_vae, precompute_latents, save_latents)
            from ..utils.ckpt import weights_tag

            cache = os.path.join(args.outdir, "precomputed_emb", "vae_latents.npy")
            tag = {"encoder": weights_tag(args.vae_weights, SD_VAE_SEED),
                   "dataset": args.dataset}
            latents = cached_latents(cache, len(dataset.images), tag)
            if latents is None:
                latents = precompute_latents(
                    load_sd_vae(MINISD_VAE, args.vae_weights, device=device), dataset.images)
                save_latents(cache, latents, tag)
        latents = latents.transpose(0, 3, 1, 2)  # the JAX (N, h, w, c) layout -> NCHW
        context, labels = unit_emb, group_labels  # each row's unit's caption
        key_name = "train_features"
    else:
        lat, _ = sample(sample_loop, postprocess=False)
        latents = lat.cpu().numpy()
        context, labels = prompt_emb, np.zeros(len(latents), np.int64)
        key_name = "gen_features"

    if args.grad_mode == "probe":
        # The probe occupies the LoRA buffers, so the trained LoRA is merged
        # into the base first; the sketch then covers every attention
        # projection of the merged model.
        model.load_state_dict(lora_merge(model.state_dict(), lora))
        sketch_probe = probe_sketch_init(
            model, k=args.sketch_k, generator=torch.Generator().manual_seed(args.proj_seed))
        feat_fn = make_grad_feature_fn(
            model, schedule, sched_spec, output_fn=args.output_fn, proj_dim=args.proj_dim,
            num_timesteps=args.num_timesteps, t_strategy=args.t_strategy,
            proj_seed=args.proj_seed, sketch_probe=sketch_probe, conditional=True)
    else:
        feat_fn = make_grad_feature_fn(
            model, schedule, sched_spec, output_fn=args.output_fn, proj_dim=args.proj_dim,
            num_timesteps=args.num_timesteps, t_strategy=args.t_strategy,
            proj_seed=args.proj_seed, lora=lora, conditional=True)
    if args.max_examples:
        latents, labels = latents[: args.max_examples], labels[: args.max_examples]

    from numpy.lib.format import open_memmap

    mm_path = args.save_path.replace(".npz", "") + f"_{args.source}_mm.npy"
    feats = open_memmap(mm_path, mode="w+", dtype=np.float32,
                        shape=(len(latents), args.proj_dim))
    batch_seconds, grad_seconds, jl_seconds = [], [], []
    for b, i in enumerate(range(0, len(latents), args.batch_size)):
        t0 = time.perf_counter()
        batch = torch.from_numpy(np.ascontiguousarray(latents[i:i + args.batch_size]))
        rows = torch.from_numpy(labels[i:i + args.batch_size]).to(device)
        ctx = context[rows] if key_name == "train_features" else context.expand(
            len(batch), *context.shape[1:])
        g = feat_fn.mean_gradients(batch.to(device), generator=batch_generator(
            args.seed + 1, b, device), encoder_hidden_states=ctx)
        sync()
        t1 = time.perf_counter()
        feats[i:i + args.batch_size] = jl_project(g, args.proj_dim,
                                                  seed=args.proj_seed).cpu().numpy()
        del g
        t2 = time.perf_counter()
        batch_seconds.append(t2 - t0)
        grad_seconds.append(t1 - t0)
        jl_seconds.append(t2 - t1)
        print(f"{min(i + args.batch_size, len(latents))}/{len(latents)} examples "
              f"({batch_seconds[-1]:.3f} s)", flush=True)
    feats.flush()
    feats = np.asarray(feats)

    payload = {key_name: feats}
    if key_name == "train_features":
        payload["group_labels"] = labels
        with open(os.path.join(os.path.dirname(os.path.abspath(args.save_path)),
                               "group.csv"), "w") as f:
            f.write("row,unit\n")
            f.writelines(f"{i},{artist_from_filename(name)}\n"
                         for i, name in enumerate(files[: len(latents)]))
    _save_store(args.save_path, payload)
    print(f"{key_name} {feats.shape} -> {args.save_path}")
    return _summary(args, feats, feat_fn.dim, batch_seconds, grad_seconds, jl_seconds,
                    sample_s, launches0)


def _summary(args, feats, grad_dim, batch_seconds, grad_seconds, jl_seconds, sample_s,
             launches0) -> dict:
    launches = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    return {"source": args.source, "features_shape": feats.shape, "grad_dim": grad_dim,
            "batch_seconds": batch_seconds, "grad_seconds": grad_seconds,
            "jl_seconds": jl_seconds, "sample_seconds": sample_s, "launches": launches,
            "save_path": args.save_path}


if __name__ == "__main__":
    main()
