"""Weight bridges between the JAX package's param trees and the port: the
UNet2D and, at the end of the file, the VQ-VAE.

The port's UNet2D state dict uses the diffusers v0.24 UNet2DModel keys, so
these are the port's own copies of the JAX package's
``export_unet_state_dict`` (`params_from_jax`) and
``convert_unet_state_dict`` (`params_to_jax`), working on numpy trees:

    diffusers / port                         JAX UNet2D
    conv_in, conv_out, conv_norm_out         conv_in, conv_out, conv_norm_out
    time_embedding.linear_{1,2}              time_embedding.linear_{1,2}
    down_blocks.I.resnets.J.*                down_I_res_J.*
    down_blocks.I.attentions.J.*             down_I_attn_J.*
    down_blocks.I.downsamplers.0.conv        down_I_downsample.conv
    mid_block.resnets.{0,1}.*                mid_res_{0,1}.*
    mid_block.attentions.0.*                 mid_attn.*
    up_blocks.I.resnets.J.*                  up_I_res_J.*
    up_blocks.I.attentions.J.*               up_I_attn_J.*
    up_blocks.I.upsamplers.0.conv            up_I_upsample.conv

Conv kernels transpose (kH, kW, I, O) <-> (O, I, kH, kW), linears
(I, O) <-> (O, I), and norm ``scale`` <-> ``weight``. Legacy diffusers
attention names (query/key/value/proj_attn) are accepted on the way in.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

_ATTN_ALIASES = {
    "query": "to_q",
    "key": "to_k",
    "value": "to_v",
    "proj_attn": "to_out",
    "to_out.0": "to_out",
}

_SUBMODULES = {
    "norm1", "conv1", "time_emb_proj", "norm2", "conv2", "conv_shortcut",
    "to_q", "to_k", "to_v", "to_out", "group_norm", "conv",
}


def _jax_leaf(v: np.ndarray, torch_leaf: str):
    """(JAX leaf name, array) for one torch-layout tensor."""
    if torch_leaf == "bias":
        return "bias", v
    if v.ndim == 4:  # conv
        return "kernel", v.transpose(2, 3, 1, 0)
    if v.ndim == 2:  # linear
        return "kernel", v.T
    return "scale", v  # norm


def params_to_jax(state_dict: Dict[str, Any]) -> Dict:
    """Port (diffusers-layout) state dict -> JAX UNet2D param tree of numpy."""
    params: Dict[str, Any] = {}

    def put(path: List[str], leaf: str, v):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(path[-1], {})[leaf] = v

    for key, value in state_dict.items():
        v = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        parts = key.split(".")
        torch_leaf, body = parts[-1], parts[:-1]
        if torch_leaf not in ("weight", "bias"):
            continue
        if body[0] in ("conv_in", "conv_out", "conv_norm_out"):
            put([body[0]], *_jax_leaf(v, torch_leaf))
        elif body[0] == "time_embedding":
            put(["time_embedding", body[1]], *_jax_leaf(v, torch_leaf))
        elif body[0] in ("down_blocks", "up_blocks", "mid_block"):
            if body[0] == "mid_block":
                kind, rest = body[1], body[2:]
                prefix = f"mid_res_{rest[0]}" if kind == "resnets" else "mid_attn"
            else:
                side = "down" if body[0] == "down_blocks" else "up"
                i, kind, rest = body[1], body[2], body[3:]
                if kind == "resnets":
                    prefix = f"{side}_{i}_res_{rest[0]}"
                elif kind == "attentions":
                    prefix = f"{side}_{i}_attn_{rest[0]}"
                else:
                    prefix = f"{side}_{i}_{'downsample' if kind == 'downsamplers' else 'upsample'}"
            sub = ".".join(rest[1:])
            sub = _ATTN_ALIASES.get(sub, sub)
            if sub not in _SUBMODULES:
                raise ValueError(f"unexpected state-dict key {key!r}")
            put([prefix, sub], *_jax_leaf(v, torch_leaf))
        else:
            raise ValueError(f"unexpected state-dict key {key!r}")
    return params


def _torch_module(name: str, sub: str) -> str:
    m = re.match(r"(down|up)_(\d+)_(res|attn)_(\d+)$", name)
    if m:
        side, i, kind, j = m.groups()
        coll = "resnets" if kind == "res" else "attentions"
        leaf = "to_out.0" if sub == "to_out" else sub
        return f"{side}_blocks.{i}.{coll}.{j}.{leaf}"
    m = re.match(r"(down|up)_(\d+)_(downsample|upsample)$", name)
    if m:
        side, i, kind = m.groups()
        return f"{side}_blocks.{i}.{kind}rs.0.{sub}"
    m = re.match(r"mid_res_(\d+)$", name)
    if m:
        return f"mid_block.resnets.{m.group(1)}.{sub}"
    if name == "mid_attn":
        return f"mid_block.attentions.0.{'to_out.0' if sub == 'to_out' else sub}"
    if name == "time_embedding":
        return f"time_embedding.{sub}"
    raise ValueError(f"unexpected JAX module {name!r}")


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX UNet2D param tree (numpy or JAX arrays) -> port state dict."""
    out: Dict[str, torch.Tensor] = {}

    def emit(torch_name: str, leaf: str, v):
        v = np.asarray(v, dtype=np.float32)
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        suffix = "bias" if leaf == "bias" else "weight"
        out[f"{torch_name}.{suffix}"] = torch.from_numpy(np.ascontiguousarray(v))

    for name, module in params.items():
        if any(k in module for k in ("kernel", "scale", "bias")):
            for leaf, v in module.items():  # conv_in / conv_out / conv_norm_out
                emit(name, leaf, v)
            continue
        for sub, leaves in module.items():
            for leaf, v in leaves.items():
                emit(_torch_module(name, sub), leaf, v)
    return out


# --- VQ-VAE (diffusers VQModel) ----------------------------------------------
#
#   diffusers / port                             JAX VQVAE
#   {encoder,decoder}.conv_in / conv_out         {encoder,decoder}/conv_in / conv_out
#   {encoder,decoder}.conv_norm_out              {encoder,decoder}/norm_out
#   encoder.down_blocks.I.resnets.J.*            encoder/down_I_res_J/*
#   encoder.down_blocks.I.downsamplers.0.conv    encoder/down_I_downsample
#   decoder.up_blocks.I.resnets.J.*              decoder/up_I_res_J/*
#   decoder.up_blocks.I.upsamplers.0.conv        decoder/up_I_upsample
#   {encoder,decoder}.mid_block.resnets.{0,1}.*  {encoder,decoder}/mid_res_{0,1}/*
#   {encoder,decoder}.mid_block.attentions.0.*   {encoder,decoder}/mid_attn/*
#   quant_conv / post_quant_conv                 quant_conv / post_quant_conv
#   quantize.embedding.weight                    codebook


def vqvae_params_to_jax(state_dict: Dict[str, Any]) -> Dict:
    """Port VQVAE state dict -> JAX VQVAE param tree of numpy (the port's copy
    of the JAX ``convert_vqvae_state_dict``, raising on an unknown key)."""
    params: Dict[str, Any] = {}

    def put(path: List[str], leaf: str, v):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(path[-1], {})[leaf] = v

    for key, value in state_dict.items():
        v = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        if key == "quantize.embedding.weight":
            params["codebook"] = v
            continue
        parts = key.split(".")
        torch_leaf, body = parts[-1], parts[:-1]
        if torch_leaf not in ("weight", "bias"):
            raise ValueError(f"unexpected state-dict key {key!r}")
        if body[0] in ("quant_conv", "post_quant_conv") and len(body) == 1:
            leaf, tv = _jax_leaf(v, torch_leaf)
            params.setdefault(body[0], {})[leaf] = tv
            continue
        if body[0] not in ("encoder", "decoder") or len(body) < 2:
            raise ValueError(f"unexpected state-dict key {key!r}")
        tower, body = body[0], body[1:]
        if body in (["conv_in"], ["conv_out"]):
            put([tower, body[0]], *_jax_leaf(v, torch_leaf))
        elif body == ["conv_norm_out"]:
            put([tower, "norm_out"], *_jax_leaf(v, torch_leaf))
        elif body[0] == "mid_block" and body[1] in ("resnets", "attentions"):
            prefix = f"mid_res_{body[2]}" if body[1] == "resnets" else "mid_attn"
            sub = _ATTN_ALIASES.get(".".join(body[3:]), ".".join(body[3:]))
            if sub not in _SUBMODULES:
                raise ValueError(f"unexpected state-dict key {key!r}")
            put([tower, prefix, sub], *_jax_leaf(v, torch_leaf))
        elif body[0] in ("down_blocks", "up_blocks"):
            side = "down" if body[0] == "down_blocks" else "up"
            i, kind, rest = body[1], body[2], body[3:]
            if kind == "resnets" and ".".join(rest[1:]) in _SUBMODULES:
                put([tower, f"{side}_{i}_res_{rest[0]}", ".".join(rest[1:])],
                    *_jax_leaf(v, torch_leaf))
            elif kind == f"{side}samplers" and rest == ["0", "conv"]:
                # The JAX towers attach the resampling conv's kernel directly.
                put([tower, f"{side}_{i}_{side}sample"], *_jax_leaf(v, torch_leaf))
            else:
                raise ValueError(f"unexpected state-dict key {key!r}")
        else:
            raise ValueError(f"unexpected state-dict key {key!r}")
    return params


def _vq_torch_module(tower: str, name: str, sub: str) -> str:
    if name == "norm_out":
        return f"{tower}.conv_norm_out"
    if name in ("conv_in", "conv_out"):
        return f"{tower}.{name}"
    if name.endswith(("_downsample", "_upsample")):
        return f"{tower}.{_torch_module(name, 'conv')}"
    return f"{tower}.{_torch_module(name, sub)}"


def vqvae_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX VQVAE param tree (numpy or JAX arrays) -> port state dict (the
    port's copy of the JAX ``export_vqvae_state_dict``)."""
    out: Dict[str, torch.Tensor] = {}

    def emit(torch_name: str, leaf: str, v):
        v = np.asarray(v, dtype=np.float32)
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        suffix = "bias" if leaf == "bias" else "weight"
        out[f"{torch_name}.{suffix}"] = torch.from_numpy(np.array(v, order="C"))

    for top, module in params.items():
        if top == "codebook":
            out["quantize.embedding.weight"] = torch.from_numpy(
                np.array(module, dtype=np.float32))
        elif top in ("quant_conv", "post_quant_conv"):
            for leaf, v in module.items():
                emit(top, leaf, v)
        else:
            for name, sub_tree in module.items():
                if any(k in sub_tree for k in ("kernel", "scale", "bias")):
                    for leaf, v in sub_tree.items():  # conv_in, norm_out, resampling convs
                        emit(_vq_torch_module(top, name, ""), leaf, v)
                    continue
                for sub, leaves in sub_tree.items():
                    for leaf, v in leaves.items():
                        emit(_vq_torch_module(top, name, sub), leaf, v)
    return out
