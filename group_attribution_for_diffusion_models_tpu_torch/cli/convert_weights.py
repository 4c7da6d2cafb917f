"""Convert locally-downloaded torch checkpoints into the formats the port reads.

Port of the JAX package's ``cli/convert_weights.py``, one entry point for
every tower converter (nothing is downloaded: fetch a checkpoint elsewhere,
then convert it here):

    unet       diffusers UNet2DModel .bin/.safetensors/state-dict .pt
               -> the port's checkpoint (``ckpt_steps_00000000/state.pt``
               and its meta, step 0) that cli.main --load and
               generate_samples --load read
    vqvae      diffusers VQModel state dict -> .npy params (--vqvae_weights)
    inception  pytorch_fid InceptionV3 .pt -> .npz variables
    clip_text / clip_vision   HF state dicts -> .npz params
    blip_vision  HF BlipVisionModel state dict -> .npy params (diversity CLI)
    ldm_bert   LDMBertModel state dict -> .npz (--text_encoder_weights)
    resnet18   torchvision resnet18 state dict -> .npz variables
    aesthetic  LAION linear head .pt -> .npz {kernel, bias}

Every kind but ``unet`` writes the file the JAX CLI writes, with its keys
and arrays, through the port's own copies of the converters; either package
reads it. ``unet`` and ``vqvae`` are shape-checked against the workload of
``--dataset`` on models built without an initialisation. A torch file is
read as a state dict of tensors (``weights_only``: no other object is
unpickled), a ``.safetensors`` file with the ``safetensors`` package,
imported on use.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict

import numpy as np
import torch

from ..models.convert_diffusers import _numpy


def _load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".safetensors"):
        from ..models.lora import _safetensors

        return dict(_safetensors("convert_weights").load_file(path))
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise SystemExit(f"{path}: not a state dict of tensors ({e})") from None
    if isinstance(sd, dict) and "unet" in sd and hasattr(sd["unet"], "items"):
        sd = sd["unet"]  # reference ckpt_steps_*.pt layout: {"unet": state_dict, ...}
    return {k: _numpy(v) for k, v in sd.items()}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _check_shapes(what: str, dataset: str, want: Dict, got: Dict) -> None:
    """Exit unless `got` has exactly the tensors of `want` at their shapes."""
    want = {k: tuple(v.shape) for k, v in want.items()}
    got = {k: tuple(v.shape) for k, v in got.items()}
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    mismatched = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or unexpected or mismatched:
        raise SystemExit(
            f"{what} conversion does not match the {dataset} spec: missing={missing[:5]} "
            f"unexpected={unexpected[:5]} mismatched={mismatched[:5]}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--kind", type=str, required=True,
                        choices=["unet", "inception", "clip_text",
                                 "clip_vision", "blip_vision", "vqvae",
                                 "aesthetic", "resnet18", "ldm_bert"])
    parser.add_argument("--src", type=str, required=True,
                        help="torch checkpoint / safetensors file")
    parser.add_argument("--dst", type=str, required=True)
    parser.add_argument("--dataset", type=str, default="cifar",
                        help="unet kind: workload whose spec to validate against")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    sd = _load_torch_state_dict(args.src)
    os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)

    if args.kind == "unet":
        from ..models.convert_diffusers import params_from_jax, params_to_jax
        from ..models.unet2d import empty_unet
        from ..utils.ckpt import save_checkpoint
        from .common import config_for

        # Through the JAX tree: diffusers' legacy attention names load too.
        params = params_from_jax(params_to_jax(sd))
        cfg = config_for(args.dataset)
        _check_shapes("unet", args.dataset, empty_unet(cfg.unet, device="meta").state_dict(),
                      params)
        save_checkpoint(args.dst, 0, params, params, unet_spec=cfg.unet)
        print(f"unet checkpoint -> {args.dst} (step 0)")
        return

    if args.kind == "inception":
        from ..attributions.global_scores.inception_v3 import convert_torch_state_dict

        np.savez(args.dst, **_flatten(convert_torch_state_dict(sd)))
    elif args.kind == "clip_text":
        from ..models.clip_text import convert_clip_text_state_dict

        np.savez(args.dst, **_flatten(convert_clip_text_state_dict(sd)))
    elif args.kind == "clip_vision":
        from ..models.clip_vision import convert_clip_vision_state_dict

        np.savez(args.dst, **_flatten(convert_clip_vision_state_dict(sd)))
    elif args.kind == "blip_vision":
        from ..models.blip_vision import convert_blip_vision_state_dict

        np.save(args.dst, convert_blip_vision_state_dict(sd))
    elif args.kind == "ldm_bert":
        from ..models.ldm_bert import convert_ldm_bert_state_dict

        np.savez(args.dst, **_flatten(convert_ldm_bert_state_dict(sd)))
    elif args.kind == "resnet18":
        from ..models.resnet import convert_resnet18_state_dict

        np.savez(args.dst, **_flatten(convert_resnet18_state_dict(sd)))
    elif args.kind == "vqvae":
        from ..models.convert_diffusers import vqvae_params_from_jax, vqvae_params_to_jax
        from ..models.vqvae import VQVAE
        from .common import config_for

        cfg = config_for(args.dataset)
        if cfg.vqvae is None:
            raise SystemExit(f"{args.dataset} is not a latent workload")
        params = vqvae_params_to_jax(sd)
        with torch.device("meta"):
            want = VQVAE(cfg.vqvae).state_dict()
        _check_shapes("vqvae", args.dataset, want, vqvae_params_from_jax(params))
        # .npy pickled dict: the format cli.main --vqvae_weights loads.
        np.save(args.dst, params)
    elif args.kind == "aesthetic":
        # LAION head: Linear(768 -> 1): weight (1, 768), bias (1,).
        w = sd.get("layers.0.weight", sd.get("weight"))
        b = sd.get("layers.0.bias", sd.get("bias"))
        if w is None or b is None:
            raise SystemExit(f"unrecognized aesthetic head keys: {list(sd)[:5]}")
        np.savez(args.dst, kernel=np.asarray(w).T, bias=np.asarray(b))
    print(f"{args.kind} params -> {args.dst}")


if __name__ == "__main__":
    main()
