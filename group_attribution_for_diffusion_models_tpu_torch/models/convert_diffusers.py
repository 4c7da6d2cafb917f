"""Weight bridges between the JAX package's param trees and the port: the
UNet2D (unconditional and cross-attention), its LoRA trees, and, at the end
of the file, the VQ-VAE, the KL VAE and the CLIP and LDMBert text towers.

The port's UNet2D state dict uses the diffusers v0.24 UNet2DModel /
UNet2DConditionModel keys, so these are the port's own copies of the JAX
package's ``export_unet_state_dict`` (`params_from_jax`) and
``convert_unet_state_dict`` (`params_to_jax`), extended to the
cross-attention blocks, working on numpy trees:

    diffusers / port                         JAX UNet2D
    conv_in, conv_out, conv_norm_out         conv_in, conv_out, conv_norm_out
    time_embedding.linear_{1,2}              time_embedding.linear_{1,2}
    down_blocks.I.resnets.J.*                down_I_res_J.*
    down_blocks.I.attentions.J.*             down_I_attn_J.*  (self-attention)
    down_blocks.I.attentions.J.*             down_I_xattn_J.* (a transformer)
    down_blocks.I.downsamplers.0.conv        down_I_downsample.conv
    mid_block.resnets.{0,1}.*                mid_res_{0,1}.*
    mid_block.attentions.0.*                 mid_attn.* / mid_xattn.*
    up_blocks.I.resnets.J.*                  up_I_res_J.*
    up_blocks.I.attentions.J.*               up_I_attn_J.* / up_I_xattn_J.*
    up_blocks.I.upsamplers.0.conv            up_I_upsample.conv

and inside a transformer (diffusers Transformer2DModel):

    norm, proj_in, proj_out                  norm, proj_in, proj_out
    transformer_blocks.K.norm{1,2,3}         block_K.norm{1,2,3}
    transformer_blocks.K.attn{1,2}.to_q      block_K.attn{1,2}.to_q (k, v alike)
    transformer_blocks.K.attn{1,2}.to_out.0  block_K.attn{1,2}.to_out
    transformer_blocks.K.ff.net.0.proj       block_K.ff_geglu.proj
    transformer_blocks.K.ff.net.2            block_K.ff_out

Conv kernels transpose (kH, kW, I, O) <-> (O, I, kH, kW), linears
(I, O) <-> (O, I), and norm ``scale`` <-> ``weight``. Legacy diffusers
attention names (query/key/value/proj_attn) are accepted on the way in.
A LoRA tree is keyed by the JAX module path joined with "/" (the layout
of a ``lora_weights.npz``) in the JAX package and by the LoRADense module
name in the port; `lora_tree_{from,to}_jax` map one to the other.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, Tuple

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


_XATTN_HEADS = {"norm", "proj_in", "proj_out", "transformer_blocks"}
_XATTN_ENDS = ("norm", "proj_in", "proj_out")
_XATTN_RE = re.compile(r"(down|up)_(\d+)_xattn_(\d+)$")
_PROJS = ("to_q", "to_k", "to_v", "to_out")
# A transformer block's modules: port name below transformer_blocks.K -> JAX sub-path.
_BLOCK = {"norm1": ("norm1",), "norm2": ("norm2",), "norm3": ("norm3",),
          "ff.net.0.proj": ("ff_geglu", "proj"), "ff.net.2": ("ff_out",),
          **{f"{a}.{'to_out.0' if p == 'to_out' else p}": (a, p)
             for a in ("attn1", "attn2") for p in _PROJS}}
_BLOCK_INV = {v: k for k, v in _BLOCK.items()}


def _xattn_path(sub: List[str]) -> Tuple[str, ...]:
    """JAX SpatialTransformer sub-path of a port transformer's module name
    (split on dots, below ``attentions.J``)."""
    if len(sub) == 1 and sub[0] in _XATTN_ENDS:
        return (sub[0],)
    if len(sub) >= 3 and sub[0] == "transformer_blocks" and ".".join(sub[2:]) in _BLOCK:
        return (f"block_{sub[1]}",) + _BLOCK[".".join(sub[2:])]
    raise ValueError(f"unexpected transformer module {'.'.join(sub)!r}")


def _xattn_module(rest: Tuple[str, ...]) -> str:
    """Port module name below ``attentions.J`` of a JAX SpatialTransformer
    sub-path: the inverse of `_xattn_path`."""
    if len(rest) == 1 and rest[0] in _XATTN_ENDS:
        return rest[0]
    m = re.match(r"block_(\d+)$", rest[0])
    if m and tuple(rest[1:]) in _BLOCK_INV:
        return f"transformer_blocks.{m.group(1)}.{_BLOCK_INV[tuple(rest[1:])]}"
    raise ValueError(f"unexpected JAX transformer path {'/'.join(rest)!r}")


def unet_jax_path(module: str) -> Tuple[str, ...]:
    """The JAX UNet2D module path of a port (diffusers-layout) module name."""
    body = module.split(".")
    if len(body) == 1 and body[0] in ("conv_in", "conv_out", "conv_norm_out"):
        return (body[0],)
    if body[0] == "time_embedding" and len(body) == 2:
        return tuple(body)
    if body[0] == "mid_block" and len(body) >= 4:
        kind, j, sub = body[1], body[2], body[3:]
        side = "mid"
        prefix = {"resnets": f"mid_res_{j}", "attentions": "mid_attn"}.get(kind)
    elif body[0] in ("down_blocks", "up_blocks") and len(body) >= 5:
        side = "down" if body[0] == "down_blocks" else "up"
        i, kind, j, sub = body[1], body[2], body[3], body[4:]
        prefix = {"resnets": f"{side}_{i}_res_{j}", "attentions": f"{side}_{i}_attn_{j}",
                  f"{side}samplers": f"{side}_{i}_{side}sample"}.get(kind)
    else:
        prefix = None
    if prefix is None:
        raise ValueError(f"unexpected module {module!r}")
    if kind == "attentions" and sub[0] in _XATTN_HEADS:
        xprefix = "mid_xattn" if side == "mid" else f"{side}_{i}_xattn_{j}"
        return (xprefix,) + _xattn_path(sub)
    sub = _ATTN_ALIASES.get(".".join(sub), ".".join(sub))
    if sub not in _SUBMODULES:
        raise ValueError(f"unexpected module {module!r}")
    return (prefix, sub)


def unet_module_name(path: Tuple[str, ...]) -> str:
    """The port module name of a JAX UNet2D module path: the inverse of
    `unet_jax_path`."""
    head, rest = path[0], tuple(path[1:])
    if not rest and head in ("conv_in", "conv_out", "conv_norm_out"):
        return head
    m = _XATTN_RE.match(head)
    if m and rest:
        side, i, j = m.groups()
        return f"{side}_blocks.{i}.attentions.{j}.{_xattn_module(rest)}"
    if head == "mid_xattn" and rest:
        return f"mid_block.attentions.0.{_xattn_module(rest)}"
    if len(rest) != 1:
        raise ValueError(f"unexpected JAX module path {'/'.join(path)!r}")
    return _torch_module(head, rest[0])


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], str, Any]]:
    """(module path, leaf name, array) of every leaf of a nested param tree."""
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _flatten(sub, prefix + (name,))
        else:
            yield prefix, name, sub


def _put(params: Dict, path: Tuple[str, ...], leaf: str, v) -> None:
    node = params
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = v


def _numpy(value) -> np.ndarray:
    return value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)


def _torch_leaf(leaf: str, v) -> Tuple[str, torch.Tensor]:
    """(torch leaf name, tensor) of one JAX leaf: kernels transposed."""
    v = np.asarray(v, dtype=np.float32)
    if leaf == "kernel":
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
    return ("bias" if leaf == "bias" else "weight"), torch.from_numpy(np.array(v, order="C"))


def params_to_jax(state_dict: Dict[str, Any]) -> Dict:
    """Port (diffusers-layout) state dict -> JAX UNet2D param tree of numpy."""
    params: Dict[str, Any] = {}
    for key, value in state_dict.items():
        module, torch_leaf = key.rsplit(".", 1)
        if torch_leaf not in ("weight", "bias"):
            continue
        try:
            path = unet_jax_path(module)
        except ValueError:
            raise ValueError(f"unexpected state-dict key {key!r}") from None
        _put(params, path, *_jax_leaf(_numpy(value), torch_leaf))
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
    for path, leaf, v in _flatten(params):
        suffix, t = _torch_leaf(leaf, v)
        out[f"{unet_module_name(path)}.{suffix}"] = t
    return out


def lora_tree_from_jax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA tree ({"down_0_xattn_0/block_0/attn1/to_q": {"down", "up"}},
    numpy or JAX arrays) -> the port's, keyed by LoRADense module name, f32."""
    return {unet_module_name(tuple(name.split("/"))): {
        leaf: torch.from_numpy(np.array(v, dtype=np.float32)) for leaf, v in ab.items()}
        for name, ab in tree.items()}


def lora_tree_to_jax(tree: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's LoRA tree -> the JAX package's, numpy leaves."""
    return {"/".join(unet_jax_path(name)): {leaf: _numpy(v) for leaf, v in ab.items()}
            for name, ab in tree.items()}


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


# --- KL VAE (diffusers AutoencoderKL) ----------------------------------------
#
# The VQ-VAE's layout without the codebook: encoder, decoder, quant_conv
# (2 x latent channels: mean and logvar) and post_quant_conv.


def kl_vae_params_to_jax(state_dict: Dict[str, Any]) -> Dict:
    """Port AutoencoderKL state dict -> JAX AutoencoderKL param tree of numpy."""
    if "quantize.embedding.weight" in state_dict:
        raise ValueError("a KL VAE has no codebook (quantize.embedding.weight)")
    return vqvae_params_to_jax(state_dict)


def kl_vae_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL param tree -> port (diffusers AutoencoderKL) state dict."""
    if "codebook" in params:
        raise ValueError("a KL VAE has no codebook")
    return vqvae_params_from_jax(params)


# --- CLIP text tower (HF CLIPTextModel) ---------------------------------------
#
#   HF / port (under text_model.)                  JAX CLIPTextEncoder
#   embeddings.token_embedding.weight              token_embedding/embedding
#   embeddings.position_embedding.weight           position_embedding
#   encoder.layers.I.self_attn.{q,k,v,out}_proj.*  layer_I/self_attn/{q,k,v,out}_proj/*
#   encoder.layers.I.layer_norm{1,2}.*             layer_I/layer_norm{1,2}/*
#   encoder.layers.I.mlp.fc{1,2}.*                 layer_I/fc{1,2}/*
#   final_layer_norm.*                             final_layer_norm/*


def _clip_module(path: Tuple[str, ...]) -> str:
    if path in (("token_embedding",), ("final_layer_norm",)):
        prefix = "embeddings." if path[0] == "token_embedding" else ""
        return f"text_model.{prefix}{path[0]}"
    m = re.match(r"layer_(\d+)$", path[0])
    if m:
        layer = f"text_model.encoder.layers.{m.group(1)}"
        if len(path) == 3 and path[1] == "self_attn":
            return f"{layer}.self_attn.{path[2]}"
        if len(path) == 2 and path[1] in ("layer_norm1", "layer_norm2"):
            return f"{layer}.{path[1]}"
        if len(path) == 2 and path[1] in ("fc1", "fc2"):
            return f"{layer}.mlp.{path[1]}"
    raise ValueError(f"unexpected CLIP text path {'/'.join(path)!r}")


def clip_text_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX CLIPTextEncoder param tree (or the ``.npz`` of cli.convert_weights
    clip_text, unflattened) -> HF CLIPTextModel state dict, f32."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf, v in _flatten(params):
        if path == () and leaf == "position_embedding":
            out["text_model.embeddings.position_embedding.weight"] = torch.from_numpy(
                np.array(v, dtype=np.float32))
        elif leaf == "embedding":
            out[f"{_clip_module(path)}.weight"] = torch.from_numpy(np.array(v, dtype=np.float32))
        else:
            suffix, t = _torch_leaf(leaf, v)
            out[f"{_clip_module(path)}.{suffix}"] = t
    return out


# --- LDMBert text tower (diffusers LDMBertModel) -----------------------------
#
#   diffusers (under model.) / port              JAX LDMBertEncoder
#   embed_tokens.weight                          embed_tokens/embedding
#   embed_positions.weight                       embed_positions
#   layers.I.self_attn.{q,k,v,out}_proj.*        layer_I/self_attn/{q,k,v,out}_proj/*
#   layers.I.{self_attn,final}_layer_norm.*      layer_I/{self_attn,final}_layer_norm/*
#   layers.I.fc{1,2}.*                           layer_I/fc{1,2}/*
#   layer_norm.*                                 layer_norm/*


def _ldm_bert_module(path: Tuple[str, ...]) -> str:
    if path in (("embed_tokens",), ("layer_norm",)):
        return path[0]
    m = re.match(r"layer_(\d+)$", path[0])
    if m:
        layer = f"layers.{m.group(1)}"
        if len(path) == 3 and path[1] == "self_attn":
            return f"{layer}.self_attn.{path[2]}"
        if len(path) == 2 and path[1] in ("self_attn_layer_norm", "final_layer_norm",
                                          "fc1", "fc2"):
            return f"{layer}.{path[1]}"
    raise ValueError(f"unexpected LDMBert path {'/'.join(path)!r}")


def ldm_bert_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX LDMBertEncoder param tree (or the ``.npz`` of cli.convert_weights
    ldm_bert, unflattened) -> the port's LDMBertEncoder state dict, f32."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf, v in _flatten(params):
        if path == () and leaf == "embed_positions":
            out["embed_positions.weight"] = torch.from_numpy(np.array(v, dtype=np.float32))
        elif leaf == "embedding":
            out[f"{_ldm_bert_module(path)}.weight"] = torch.from_numpy(
                np.array(v, dtype=np.float32))
        else:
            suffix, t = _torch_leaf(leaf, v)
            out[f"{_ldm_bert_module(path)}.{suffix}"] = t
    return out
