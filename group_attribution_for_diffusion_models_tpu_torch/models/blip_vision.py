"""BLIP vision tower: the diversity behavior's embedding extractor (NCHW in,
CLS embedding out).

Port of the JAX package's ``models/blip_vision.py``, the reference's
BLIP-VQA vision tower (reference src/attributions/global_scores/
diversity_score.py:89-91): a ViT with fused qkv attention, exact-GELU MLP and
a post-LayerNorm on the CLS token, layer for layer HF ``BlipVisionModel``
(blip-vqa-base geometry: 384 px, 16 px patches, width 768, 12 layers, 12
heads). Module names are HF's (``embeddings.patch_embedding``,
``encoder.layers.I.self_attn.qkv``, ``encoder.layers.I.mlp.fc1``,
``post_layernorm``, ...), so a raw torch state dict loads as it is;
`params_from_jax` carries the JAX tower's param tree over.

Images in [0, 1] are resized to the tower's size with bilinear interpolation,
antialiased when shrinking (``jax.image.resize``'s), then normalised with
the CLIP statistics. The attention is plain ``torch.matmul`` and softmax, as
the JAX tower's is plain jnp outside any Pallas kernel. Without weights the
tower is a seeded random init of the JAX init's distributions: lecun_normal
kernels, zero biases, unit LayerNorm scales, N(0, 0.02) class and position
embeddings.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..attributions.global_scores.inception_v3 import lecun_init_
from ..utils.device import resolve_device

# CLIP's image statistics, which BLIP shares (the JAX models/clip_vision.py's
# CLIP_MEAN and CLIP_STD).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
TINY = dict(image_size=32, patch_size=8, width=32, layers=2, heads=2, mlp_dim=64)


class BlipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.projection = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        hd = w // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        return self.projection((attn @ v).transpose(1, 2).reshape(b, n, w))


class BlipMLP(nn.Module):
    def __init__(self, width: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class BlipEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.self_attn = BlipAttention(width, heads)
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = BlipMLP(width, mlp_dim)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class BlipEmbeddings(nn.Module):
    def __init__(self, image_size: int, patch_size: int, width: int):
        super().__init__()
        n = (image_size // patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, width))
        self.patch_embedding = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.position_embedding = nn.Parameter(torch.zeros(1, n + 1, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)  # (B, n, w), row-major
        cls = self.class_embedding.expand(x.shape[0], -1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding


class BlipVisionTower(nn.Module):
    """Images (B, 3, H, W) RGB in [0, 1] -> the pooled CLS embedding (B, width)."""

    def __init__(self, image_size: int = 384, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_dim: int = 3072):
        super().__init__()
        self.image_size = image_size
        self.embeddings = BlipEmbeddings(image_size, patch_size, width)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [BlipEncoderLayer(width, heads, mlp_dim) for _ in range(layers)])
        self.post_layernorm = nn.LayerNorm(width, eps=1e-5)
        self.register_buffer("mean", torch.tensor(CLIP_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(CLIP_STD).view(1, 3, 1, 1), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        size = (self.image_size, self.image_size)
        if images.shape[-2:] != size:
            images = F.interpolate(images, size=size, mode="bilinear", align_corners=False,
                                   antialias=True)
        x = self.embeddings((images - self.mean) / self.std)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)[:, 0]


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX tower's param tree ({class_embedding, position_embedding,
    patch_embedding, layer_I/{self_attn/{qkv,projection}, layer_norm1,
    layer_norm2, fc1, fc2}, post_layernorm}) -> the port's state dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, v):
        out[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    def dense(prefix: str, leaves: Mapping):
        put(f"{prefix}.weight", np.asarray(leaves["kernel"]).T)
        put(f"{prefix}.bias", leaves["bias"])

    def norm(prefix: str, leaves: Mapping):
        put(f"{prefix}.weight", leaves["scale"])
        put(f"{prefix}.bias", leaves["bias"])

    for name, tree in params.items():
        if name == "class_embedding":
            put("embeddings.class_embedding", np.asarray(tree).reshape(1, 1, -1))
        elif name == "position_embedding":
            put("embeddings.position_embedding", np.asarray(tree)[None])
        elif name == "patch_embedding":
            put("embeddings.patch_embedding.weight",
                np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
            put("embeddings.patch_embedding.bias", tree["bias"])
        elif name == "post_layernorm":
            norm("post_layernorm", tree)
        elif name.startswith("layer_"):
            base = f"encoder.layers.{name[len('layer_'):]}"
            dense(f"{base}.self_attn.qkv", tree["self_attn"]["qkv"])
            dense(f"{base}.self_attn.projection", tree["self_attn"]["projection"])
            norm(f"{base}.layer_norm1", tree["layer_norm1"])
            norm(f"{base}.layer_norm2", tree["layer_norm2"])
            dense(f"{base}.mlp.fc1", tree["fc1"])
            dense(f"{base}.mlp.fc2", tree["fc2"])
        else:
            raise KeyError(f"unknown BLIP param {name}")
    return out


def load_blip_vision(weights_path: Optional[str] = None, tiny: bool = False,
                     device="cuda") -> BlipVisionTower:
    """The tower in eval mode on `device`; `tiny` builds a small one for smoke
    tests (32 px, patch 8, width 32, 2 layers, 2 heads). Weights: a JAX param
    tree saved as ``.npy``, or a torch state dict of HF ``BlipVisionModel``
    (its ``vision_model.`` prefix dropped where a whole BLIP model's was
    saved); without them a random init drawn from seed 0."""
    model = BlipVisionTower(**TINY) if tiny else BlipVisionTower()
    if weights_path is not None:
        if weights_path.endswith(".npy"):
            sd = params_from_jax(np.load(weights_path, allow_pickle=True).item())
        else:
            sd = torch.load(weights_path, map_location="cpu", weights_only=True)
            if any(k.startswith("vision_model.") for k in sd):
                sd = {k[len("vision_model."):]: v for k, v in sd.items()
                      if k.startswith("vision_model.")}
        model.load_state_dict(sd)
    else:
        gen = torch.Generator().manual_seed(0)
        lecun_init_(model, gen)
        with torch.no_grad():
            model.embeddings.class_embedding.normal_(0.0, 0.02, generator=gen)
            model.embeddings.position_embedding.normal_(0.0, 0.02, generator=gen)
        print("WARNING: BLIP tower running random-init (no weights); "
              "embeddings are not reference-comparable")
    return model.eval().requires_grad_(False).to(resolve_device(str(device)))


def make_blip_feature_fn(model: BlipVisionTower, batch_size: int = 64):
    """Batched CLS-embedding extractor over an (N, H, W, 3) array in [0, 1]
    (numpy); returns numpy (N, width). Each batch runs on the model's device."""
    device = next(model.parameters()).device

    def extract(images) -> np.ndarray:
        feats = []
        with torch.no_grad():
            for i in range(0, len(images), batch_size):
                chunk = torch.from_numpy(np.asarray(images[i:i + batch_size], np.float32))
                feats.append(model(chunk.to(device).permute(0, 3, 1, 2)).cpu().numpy())
        return np.concatenate(feats)

    return extract



def convert_blip_vision_state_dict(state_dict: Mapping) -> Dict:
    """An HF BlipVisionModel state dict -> the JAX package's param tree of
    numpy (the port's copy of its ``convert_blip_vision_state_dict``, which
    ``cli.convert_weights blip_vision`` writes)."""
    from .convert_diffusers import _numpy, _put

    p: Dict = {}
    for key, value in state_dict.items():
        v = _numpy(value)
        key = key.replace("vision_model.", "")
        if key == "embeddings.class_embedding":
            p["class_embedding"] = v.reshape(-1)
        elif key == "embeddings.position_embedding":
            p["position_embedding"] = v.reshape(v.shape[-2], v.shape[-1])
        elif key == "embeddings.patch_embedding.weight":
            _put(p, ("patch_embedding",), "kernel", v.transpose(2, 3, 1, 0))
        elif key == "embeddings.patch_embedding.bias":
            _put(p, ("patch_embedding",), "bias", v)
        elif key == "post_layernorm.weight":
            _put(p, ("post_layernorm",), "scale", v)
        elif key == "post_layernorm.bias":
            _put(p, ("post_layernorm",), "bias", v)
        elif key.startswith("encoder.layers."):
            parts = key.split(".")
            base, rest = (f"layer_{parts[2]}",), parts[3:]
            if rest[0] == "self_attn":
                leaf = "kernel" if rest[-1] == "weight" else "bias"
                _put(p, base + ("self_attn", rest[1]), leaf, v.T if leaf == "kernel" else v)
            elif rest[0] in ("layer_norm1", "layer_norm2"):
                _put(p, base + (rest[0],), "scale" if rest[1] == "weight" else "bias", v)
            elif rest[0] == "mlp":
                leaf = "kernel" if rest[-1] == "weight" else "bias"
                _put(p, base + (rest[1],), leaf, v.T if leaf == "kernel" else v)
    return p
