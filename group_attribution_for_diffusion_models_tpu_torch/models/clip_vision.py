"""CLIP vision tower (ViT) and the LAION aesthetic head (torch.nn, NCHW in).

Port of the JAX package's ``models/clip_vision.py``, which backs the
CLIP-similarity, CLIP-prompt-score and aesthetic behaviors of the
text-to-image tier (reference text_to_image/compute_model_behaviors.py:
243-261, 419-430; src/aesthetics.py:8-27). ViT-L/14 geometry by default, SD
1.x's paired tower: 224 px, 14 px patches, width 1024, 24 layers, 16 heads,
projection to 768. The output is the projected, unnormalised image
embedding.

Module names are HF ``CLIPVisionModelWithProjection``'s
(``vision_model.embeddings.patch_embedding``, ``vision_model.pre_layrnorm``,
``vision_model.encoder.layers.I.self_attn.q_proj``, ``visual_projection``,
...), so a state dict of that model loads with `load_state_dict`. The layers
are the text tower's `CLIPEncoderLayer` with a zero mask, as the JAX tower
reuses ``clip_text.CLIPLayer``: a plain product and softmax, no kernel.

Images in [0, 1] are resized to the tower's size with bilinear
interpolation, antialiased when shrinking (``jax.image.resize``'s), then
normalised with the OpenAI CLIP statistics. Without weights the tower is a
seeded draw of the JAX init's distributions on the tower's device:
lecun_normal kernels, zero biases, unit LayerNorm scales, N(0, 0.02) class
and position embeddings.

The aesthetic model is the LAION linear head (768 -> 1) on the L2-normalised
embedding, as the reference's ``get_aesthetic_model`` loads it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..attributions.global_scores.inception_v3 import lecun_init_
from ..utils.device import resolve_device
from .clip_text import CLIPEncoderLayer

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
TINY = dict(image_size=32, patch_size=8, width=32, layers=2, heads=2, proj_dim=16)
CLIP_VISION_SEED = 0  # the random tower (JAX: PRNGKey(0))
AESTHETIC_SEED = 0


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, image_size: int, patch_size: int, width: int):
        super().__init__()
        n = (image_size // patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.patch_embedding = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.position_embedding = nn.Embedding(n + 1, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)  # (B, n, w), row-major
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionEncoder(nn.Module):
    """Images (B, 3, H, W) RGB in [0, 1] -> the projected embedding (B, proj_dim)."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, proj_dim: int = 768):
        super().__init__()
        self.image_size, self.proj_dim = image_size, proj_dim
        vm = self.vision_model = nn.Module()
        vm.embeddings = CLIPVisionEmbeddings(image_size, patch_size, width)
        vm.pre_layrnorm = nn.LayerNorm(width, eps=1e-5)  # HF's spelling
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList([CLIPEncoderLayer(width, heads)
                                           for _ in range(layers)])
        vm.post_layernorm = nn.LayerNorm(width, eps=1e-5)
        self.visual_projection = nn.Linear(width, proj_dim, bias=False)
        self.register_buffer("mean", torch.tensor(CLIP_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(CLIP_STD).view(1, 3, 1, 1), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        size = (self.image_size, self.image_size)
        if images.shape[-2:] != size:
            images = F.interpolate(images, size=size, mode="bilinear", align_corners=False,
                                   antialias=True)
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings((images - self.mean) / self.std))
        mask = x.new_zeros(())
        for layer in vm.encoder.layers:
            x = layer(x, mask)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


class AestheticHead(nn.Module):
    """LAION aesthetic predictor: Linear(dim -> 1) on the L2-normalised
    embedding; (B, dim) -> (B,)."""

    def __init__(self, dim: int = 768):
        super().__init__()
        self.linear = nn.Linear(dim, 1)

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        e = embeddings / torch.clamp(embeddings.norm(dim=-1, keepdim=True), min=1e-12)
        return self.linear(e)[:, 0]


def load_aesthetic_head(weights_path: Optional[str] = None, dim: int = 768,
                        device="cuda") -> AestheticHead:
    """The head in eval mode on `device`, with the LAION linear-probe weights:
    the original torch state dict (``sa_0_4_vit_l_14_linear.pth``,
    nn.Linear(768, 1): weight (1, 768), bias (1,)) or an ``.npz`` with kernel
    (768, 1) and bias (1,). Without a path, a seeded random init (lecun
    normal, zero bias): its scores then carry no aesthetic meaning."""
    device = resolve_device(str(device))
    with device:
        head = AestheticHead(dim)
    if weights_path is None:
        lecun_init_(head, torch.Generator(device=device).manual_seed(AESTHETIC_SEED))
        return head.eval().requires_grad_(False)
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as w:
            weight, bias = np.asarray(w["kernel"]).T, np.asarray(w["bias"])
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        weight, bias = np.asarray(sd["weight"]), np.asarray(sd["bias"])
    if weight.shape != (1, dim):
        raise ValueError(f"aesthetic head expects a ({dim}, 1) kernel, got {weight.T.shape}")
    head.load_state_dict({"linear.weight": torch.from_numpy(weight.astype(np.float32)),
                          "linear.bias": torch.from_numpy(bias.astype(np.float32))})
    return head.eval().requires_grad_(False)


def make_embed_fn(model: CLIPVisionEncoder, batch_size: int = 64):
    """Batched embedding extractor over an (N, H, W, 3) array in [0, 1]
    (numpy); returns numpy (N, proj_dim). Each batch runs on the model's
    device."""
    device = next(model.parameters()).device

    def embed(images) -> np.ndarray:
        outs = []
        with torch.no_grad():
            for i in range(0, len(images), batch_size):
                chunk = torch.from_numpy(np.ascontiguousarray(images[i:i + batch_size],
                                                              np.float32))
                outs.append(model(chunk.to(device).permute(0, 3, 1, 2)).cpu().numpy())
        return np.concatenate(outs)

    return embed


def read_clip_vision(weights_path: str) -> Dict[str, torch.Tensor]:
    """A torch state-dict file of HF ``CLIPVisionModelWithProjection`` (or of
    the port's tower) as the port's state dict: ``pre_layernorm`` spelled as
    HF spells it, the ``position_ids`` buffer dropped, f32."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for key, value in sd.items():
        if key.endswith("position_ids"):
            continue
        out[key.replace(".pre_layernorm.", ".pre_layrnorm.")] = torch.as_tensor(value).float()
    return out


def init_clip_vision(model: CLIPVisionEncoder, seed: int = CLIP_VISION_SEED) -> CLIPVisionEncoder:
    """Draw `model`'s parameters from the JAX init's distributions on the
    model's device, from a generator seeded with `seed`."""
    emb = model.vision_model.embeddings
    gen = torch.Generator(device=emb.class_embedding.device).manual_seed(seed)
    lecun_init_(model, gen)
    with torch.no_grad():
        emb.class_embedding.normal_(0.0, 0.02, generator=gen)
        emb.position_embedding.weight.normal_(0.0, 0.02, generator=gen)
    return model


def load_clip_vision(weights_path: Optional[str] = None, tiny: bool = False,
                     device="cuda") -> CLIPVisionEncoder:
    """The frozen tower in eval mode on `device`; `tiny` builds a small one
    for smoke tests (32 px, patch 8, width 32, 2 layers, 2 heads, projection
    16). Weights: a torch state-dict file in HF names (`read_clip_vision`),
    else the seeded random tower drawn on `device`."""
    device = resolve_device(str(device))
    with device:
        model = CLIPVisionEncoder(**TINY) if tiny else CLIPVisionEncoder()
    if weights_path is not None:
        model.load_state_dict(read_clip_vision(weights_path))
    else:
        init_clip_vision(model)
        print("WARNING: CLIP vision tower running random-init (no weights); "
              "embeddings are not reference-comparable")
    return model.eval().requires_grad_(False)


def params_from_jax(params: Mapping, head: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The JAX tower's param tree ({class_embedding, patch_embedding,
    position_embedding, pre_layernorm, layer_I/{self_attn/{q,k,v,out}_proj,
    layer_norm1, layer_norm2, fc1, fc2}, post_layernorm, visual_projection})
    -> the port's state dict; with `head` (the JAX AestheticHead's params,
    {linear: {kernel, bias}}) the head's state dict instead."""
    def f32(v) -> torch.Tensor:
        return torch.from_numpy(np.array(v, dtype=np.float32))

    if head is not None:
        return {"linear.weight": f32(np.asarray(head["linear"]["kernel"]).T),
                "linear.bias": f32(head["linear"]["bias"])}
    out: Dict[str, torch.Tensor] = {}
    vm = "vision_model"

    def dense(prefix: str, leaves: Mapping):
        out[f"{prefix}.weight"] = f32(np.asarray(leaves["kernel"]).T)
        if "bias" in leaves:
            out[f"{prefix}.bias"] = f32(leaves["bias"])

    def norm(prefix: str, leaves: Mapping):
        out[f"{prefix}.weight"] = f32(leaves["scale"])
        out[f"{prefix}.bias"] = f32(leaves["bias"])

    for name, tree in params.items():
        if name == "class_embedding":
            out[f"{vm}.embeddings.class_embedding"] = f32(tree)
        elif name == "position_embedding":
            out[f"{vm}.embeddings.position_embedding.weight"] = f32(tree)
        elif name == "patch_embedding":
            out[f"{vm}.embeddings.patch_embedding.weight"] = f32(
                np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
        elif name == "pre_layernorm":
            norm(f"{vm}.pre_layrnorm", tree)
        elif name == "post_layernorm":
            norm(f"{vm}.post_layernorm", tree)
        elif name == "visual_projection":
            dense("visual_projection", tree)
        elif name.startswith("layer_"):
            base = f"{vm}.encoder.layers.{name[len('layer_'):]}"
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                dense(f"{base}.self_attn.{proj}", tree["self_attn"][proj])
            norm(f"{base}.layer_norm1", tree["layer_norm1"])
            norm(f"{base}.layer_norm2", tree["layer_norm2"])
            dense(f"{base}.mlp.fc1", tree["fc1"])
            dense(f"{base}.mlp.fc2", tree["fc2"])
        else:
            raise KeyError(f"unknown CLIP vision param {name}")
    return out
