"""Score-level quality of probe-sketch TRAK features against exact gradients.

Port of the JAX package's ``cli/sketch_quality.py``. On a trained model it

1. extracts TRAK features four ways: full per-sample gradients (every
   parameter), attn_full (exact gradients of the attention projections
   only, the reference's own SD feature choice) and a probe sketch at each
   ``--sketch_ks``;
2. assembles TRAK scores of the training images against one shared set of
   ``--n_gen`` generated images (reference traks.py:140-186), aggregated per
   training example and per group;
3. reports the Spearman correlation of each variant with the full and the
   attn_full attributions, per example and per group, the extraction
   seconds of each, and, with ``--test_db``, the LDS of each variant's group
   attributions on datamodel-retrain rows (sign-flipped: TRAK scores are
   influence-like, the behavior loss-like; reference baseline_lds.py:150-153).
   The rows' masks come from the whole dataset's labels, which their
   ``remaining_idx`` index: the JAX CLI indexes the labels of the
   ``--max_examples`` it kept and fails there (ROADMAP C4).

The JSON summary has the JAX CLI's keys; `main` returns it. The generated
set is one DDIM batch from the EMA weights (``--seed``), mapped back to
[-1, 1]; feature batch b draws its noise from a generator seeded from
(seed, b). The JAX CLI feeds the dataset's pixels and pixel-rescaled samples
to the U-Net whatever the workload, which on a latent (VQ-VAE) workload
mixes pixels with latents (ROADMAP C4): the port exits there instead.
Runs on CUDA unless ``--device cpu`` is given, with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..attributions.lds import collect_data
from ..attributions.methods.trak import (
    aggregate_by_group,
    compute_gradient_scores,
    make_grad_feature_fn,
)
from ..data import create_dataset
from ..diffusion import make_schedule, sample_loop
from ..models import UNet2D
from ..models.lora import attention_params_filter, probe_sketch_init
from ..utils.ckpt import load_checkpoint
from ..utils.device import resolve_device
from .common import add_common_args, checkpoint_spec, config_for
from .generate_samples import batch_generator


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--load", type=str, required=True, help="model dir")
    parser.add_argument("--sketch_ks", type=int, nargs="+", default=[16, 64, 256])
    parser.add_argument("--proj_dim", type=int, default=512)
    parser.add_argument("--num_timesteps", type=int, default=10)
    parser.add_argument("--output_fn", type=str, default="loss")
    parser.add_argument("--n_gen", type=int, default=32,
                        help="generated images scores are computed against")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--max_examples", type=int, default=None)
    parser.add_argument("--lambda_reg", type=float, default=5e-1)
    parser.add_argument("--test_db", type=str, default=None,
                        help="optional datamodel-retrain JSONL: also report "
                             "LDS of each variant's group attributions")
    parser.add_argument("--model_behavior_key", type=str, default="eval_loss")
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def _spearman(a, b) -> float:
    from scipy.stats import spearmanr

    return float(spearmanr(a, b).statistic)


def variant_report(variants: dict, labels: np.ndarray, args, test_db=None) -> dict:
    """{name: {spearman_*, group_attributions[, lds]}} from each variant's
    (per-example, per-group) attributions, as the JAX CLI's ``variants``.
    `labels` are the whole dataset's: the test rows' ``remaining_idx`` index
    it, whatever ``--max_examples`` kept."""
    ref_ex, ref_grp = variants["full"]
    attn_ex, attn_grp = variants["attn_full"]
    out = {}
    for name, (ex, grp) in variants.items():
        out[name] = {
            "spearman_example_vs_full": _spearman(ex, ref_ex),
            "spearman_group_vs_full": _spearman(grp, ref_grp),
            "spearman_example_vs_attn_full": _spearman(ex, attn_ex),
            "spearman_group_vs_attn_full": _spearman(grp, attn_grp),
            "group_attributions": grp.tolist(),
        }
    if test_db:
        n_groups = int(np.asarray(labels).max()) + 1
        if len(ref_grp) != n_groups:
            raise SystemExit(f"--test_db: the {len(ref_grp)} groups of the examples kept "
                             f"are not the dataset's {n_groups}; keep more --max_examples")
        masks, behaviors, _ = collect_data(
            test_db, {"dataset": args.dataset, "removal_dist": "datamodel"},
            num_units=n_groups, behavior_key=args.model_behavior_key, by_class=True,
            labels=np.asarray(labels))
        for name, (_, grp) in variants.items():
            lds = _spearman(np.asarray(masks) @ (-grp), np.asarray(behaviors)) * 100
            out[name]["lds"] = lds
            print(f"[{name}] LDS = {lds:.1f}")
    return out


def main(argv=None):
    """Run the CLI; returns the report written to ``--save_path``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_for(args.dataset)
    if cfg.vqvae is not None:
        raise SystemExit(
            f"sketch_quality does not run on the latent workload {args.dataset!r}: the "
            "JAX CLI feeds the U-Net pixels and pixel-rescaled samples, not VQ latents "
            "(ROADMAP C4)")
    spec = checkpoint_spec(args.load, cfg.unet)
    state = load_checkpoint(args.load)
    model, ema = UNet2D(spec), UNet2D(spec)
    model.load_state_dict(state["params"])
    ema.load_state_dict(state["ema_params"])
    model, ema = model.to(device).eval(), ema.to(device).eval()
    schedule = make_schedule(cfg.scheduler, device)

    dataset = create_dataset(args.dataset, train=True, device=device)
    images, labels = dataset.images.transpose(0, 3, 1, 2), dataset.labels
    if args.max_examples:
        images, labels = images[: args.max_examples], labels[: args.max_examples]
    shape = (args.n_gen, spec.in_channels, spec.sample_size, spec.sample_size)
    gen_images = (sample_loop(
        ema, schedule, cfg.scheduler, shape, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        num_inference_steps=args.num_inference_steps) * 2.0 - 1.0).cpu().numpy()
    del ema

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def extract(feat_fn, imgs) -> np.ndarray:
        rows = []
        for b, i in enumerate(range(0, len(imgs), args.batch_size)):
            batch = torch.as_tensor(np.ascontiguousarray(imgs[i:i + args.batch_size]))
            rows.append(feat_fn(batch.to(device),
                                generator=batch_generator(args.seed, b, device)).cpu().numpy())
        return np.concatenate(rows)

    timings = {}

    def variant_scores(name, **feat_kwargs):
        feat_fn = make_grad_feature_fn(
            model, schedule, cfg.scheduler, output_fn=args.output_fn,
            proj_dim=args.proj_dim, num_timesteps=args.num_timesteps,
            proj_seed=args.seed, **feat_kwargs)
        # One warm batch first, so the recorded rate is the steady state.
        feat_fn(torch.as_tensor(np.ascontiguousarray(images[: args.batch_size])).to(device),
                generator=batch_generator(args.seed, 0, device))
        sync()
        t0 = time.perf_counter()
        phi_t = extract(feat_fn, images)
        dt = time.perf_counter() - t0
        timings[name] = {"train_extract_s": round(dt, 2),
                         "examples_per_s": round(len(images) / dt, 2)}
        phi_g = extract(feat_fn, gen_images)
        scores = compute_gradient_scores(phi_t, phi_g, method="trak",
                                         lambda_reg=args.lambda_reg)
        per_group = aggregate_by_group(scores, labels, mode="sum")
        print(f"[{name}] features {phi_t.shape} in {dt:.1f}s "
              f"({len(images) / dt:.1f} ex/s); per-group "
              f"{np.round(per_group, 4).tolist()}", flush=True)
        return scores.mean(axis=1), per_group

    variants = {"full": variant_scores("full")}
    attn_filter = attention_params_filter(model)
    if attn_filter is None:
        raise SystemExit(
            "this architecture has no attention projections; probe sketching "
            "does not apply (pick a *_big synthetic or an attention-bearing workload)")
    variants["attn_full"] = variant_scores("attn_full", params_filter=attn_filter)
    for k in args.sketch_ks:
        probe = probe_sketch_init(model, k=k, generator=torch.Generator().manual_seed(args.seed))
        variants[f"probe_k{k}"] = variant_scores(f"probe_k{k}", sketch_probe=probe)

    report = {
        "dataset": args.dataset, "proj_dim": args.proj_dim,
        "num_timesteps": args.num_timesteps, "n_train": int(len(images)),
        "n_gen": int(args.n_gen), "sketch_ks": list(args.sketch_ks),
        "variants": variant_report(variants, dataset.labels, args, args.test_db),
        "timings": timings,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
    with open(args.save_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(
        {n: {k: round(v, 4) for k, v in d.items() if not isinstance(v, list)}
         for n, d in report["variants"].items()}, indent=2))
    print(f"-> {args.save_path}")
    return report


if __name__ == "__main__":
    main()
