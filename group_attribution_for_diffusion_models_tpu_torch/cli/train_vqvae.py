"""Train a VQ-VAE for a latent-diffusion workload.

Port of the JAX package's ``cli/train_vqvae.py``: the standard VQ-VAE
objective, reconstruction MSE plus the codebook term plus beta times the
commitment term, with the straight-through estimator ``z + (zq - z).detach()``
(the decoder sees the quantized latents, the encoder gets the gradient as if
the quantizer were the identity), Adam at ``--lr`` with no clipping, the
whole dataset on the device and each step's batch drawn uniformly with
replacement. The log reports the codebook's perplexity. The weights save to
the JAX parameter tree as an ``.npy`` dict (``vqvae_weights.npy``), which
``--vqvae_weights`` of either package reads.

Runs on CUDA unless ``--device cpu`` is given; on CUDA, TF32 is off. The
batch draws come from a torch generator seeded from (``--opt_seed``, step),
not the JAX CLI's threefry keys.

Usage (smoke, CPU):
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.train_vqvae \\
        --dataset synthetic_64x16_ldm --outdir /tmp/vq --training_steps 20 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..data import create_dataset
from ..models.convert_diffusers import vqvae_params_to_jax
from ..models.vqvae import VQVAE, init_vqvae
from ..parallel.ensemble import derived_seed
from ..training.state import Optimizer, make_optimizer
from ..utils.device import resolve_device
from ..utils.jsonl import append_record
from .common import config_for, provenance_row


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", type=str, required=True,
                        help="an LDM dataset (config must carry a vqvae spec)")
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--weights_out", type=str, default=None,
                        help="default <outdir>/<dataset>/vqvae/vqvae_weights.npy")
    parser.add_argument("--training_steps", type=int, default=2000)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--beta", type=float, default=0.25,
                        help="commitment-loss weight")
    parser.add_argument("--opt_seed", type=int, default=0)
    parser.add_argument("--log_freq", type=int, default=100)
    parser.add_argument("--db", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def vqvae_loss(model: VQVAE, x: torch.Tensor, beta: float
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"recon", "perplexity"}) of NCHW images `x` in [-1, 1]."""
    z = model.encode(x)
    zq, idx = model.quantize(z)
    recon = model.decode(z + (zq - z).detach(), force_not_quantize=True)
    rec = torch.mean((recon - x) ** 2)
    codebook = torch.mean((z.detach() - zq) ** 2)
    commit = torch.mean((z - zq.detach()) ** 2)
    counts = torch.bincount(idx.reshape(-1), minlength=model.spec.num_vq_embeddings)
    p = counts.float() / idx.numel()
    perplexity = torch.exp(-torch.sum(torch.where(p > 0, p * torch.log(p), 0.0)))
    return rec + codebook + beta * commit, {"recon": rec.detach(), "perplexity": perplexity}


def make_vqvae_step(model: VQVAE, tx: Optimizer, beta: float):
    """step(x) -> {"loss", "recon", "perplexity"} (0-d tensors): one Adam step
    of `model` on the batch `x`, in place."""
    params = list(model.parameters())
    opt_state = tx.init(params)

    def step(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        loss, aux = vqvae_loss(model, x, beta)
        loss.backward()
        tx.update([p.grad for p in params], opt_state, params)
        return {"loss": loss.detach(), **aux}

    return step


def main(argv=None):
    """Run the CLI. Returns the last step's loss, recon and perplexity, the
    training seconds (ended by a device synchronise), the peak device
    memory in GiB (None on the CPU) and the weights path."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    cfg = config_for(args.dataset)
    if cfg.vqvae is None:
        raise SystemExit(f"dataset {args.dataset!r} has no vqvae spec (not an LDM workload)")
    dataset = create_dataset(args.dataset, train=True, device=device)
    images = torch.from_numpy(dataset.images).permute(0, 3, 1, 2).contiguous().to(device)
    n = images.shape[0]
    batch = min(args.batch_size, n)

    model = init_vqvae(cfg.vqvae, args.opt_seed).to(device).train()
    step = make_vqvae_step(model, make_optimizer("adam", lr=args.lr, grad_clip_norm=None),
                           args.beta)
    t0 = time.perf_counter()
    metrics = None
    for i in range(args.training_steps):
        gen = torch.Generator(device=device).manual_seed(derived_seed(args.opt_seed, i))
        ix = torch.randint(0, n, (batch,), generator=gen, device=device)
        metrics = step(images.index_select(0, ix))
        if (i + 1) % args.log_freq == 0 or i + 1 == args.training_steps:
            print(f"Step[{i + 1}/{args.training_steps}] loss={float(metrics['loss']):.5f} "
                  f"recon={float(metrics['recon']):.5f} "
                  f"perplexity={float(metrics['perplexity']):.1f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.perf_counter() - t0

    weights_out = args.weights_out or os.path.join(
        args.outdir, args.dataset, "vqvae", "vqvae_weights.npy")
    os.makedirs(os.path.dirname(os.path.abspath(weights_out)), exist_ok=True)
    np.save(weights_out, vqvae_params_to_jax(model.state_dict()), allow_pickle=True)
    print(f"saved VQ-VAE weights: {weights_out}")

    out = {k: float(v) for k, v in metrics.items()} if metrics else {
        "loss": None, "recon": None, "perplexity": None}
    db = args.db or os.path.join(args.outdir, f"{args.dataset}_vqvae_db.jsonl")
    append_record(db, provenance_row(args, **out, train_time=train_time,
                                     weights_out=weights_out))
    peak = (torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda"
            else None)
    return dict(out, train_seconds=train_time, peak_gib=peak, weights_out=weights_out)


if __name__ == "__main__":
    main()
