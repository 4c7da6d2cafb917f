"""VGG16 feature tower for precision/recall, in NCHW.

The port of the JAX package's ``attributions/global_scores/vgg16.py``: 13
3x3 convs in five max-pooled stages, then fc1 -> ReLU -> fc2, returning the
4096-d fc2 features that the reference's StyleGAN2 VGG16 extractor gives
precision and recall. Module names follow torchvision's ``vgg16``
(``features.N``, ``classifier.0`` and ``classifier.3``), so its state dict
loads with `load_state_dict` once the 1000-way head (``classifier.6``) is
dropped; `params_from_jax` carries the JAX tower's params over. The features
flatten in (C, H, W) order, as torch's and the JAX tower's do.

Preprocessing: "caffe" (the StyleGAN convention: x * 255 minus the ImageNet
mean pixel), "torchvision" (ImageNet mean/std on [0, 1]) or "none".
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.device import resolve_device
from .inception_v3 import lecun_init_, load_torch_weights

# Stage widths of VGG16; each stage is a run of 3x3 convs followed by a
# stride-2 max pool.
VGG16_STAGES: Tuple[Tuple[int, ...], ...] = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)
)
TINY_STAGES: Tuple[Tuple[int, ...], ...] = ((4,), (8,))

_CAFFE_MEAN = (123.68, 116.779, 103.939)
_TV_MEAN = (0.485, 0.456, 0.406)
_TV_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """Input (B, 3, H, W) RGB in [0, 1]; returns the fc2 feature vector."""

    def __init__(self, stages=VGG16_STAGES, fc_dim: int = 4096, input_size: int = 224,
                 preprocess: str = "caffe"):
        super().__init__()
        if preprocess not in ("caffe", "torchvision", "none"):
            raise ValueError(f"unknown preprocess {preprocess!r}")
        self.input_size = input_size
        self.preprocess = preprocess
        layers, in_ch, spatial = [], 3, input_size
        for stage in stages:
            for ch in stage:
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
                in_ch = ch
            layers.append(nn.MaxPool2d(2, 2))
            spatial //= 2
        self.features = nn.Sequential(*layers)
        # torchvision's indices: Linear 0, ReLU 1, Dropout 2, Linear 3.
        self.classifier = nn.Sequential(
            nn.Linear(in_ch * spatial * spatial, fc_dim), nn.ReLU(), nn.Identity(),
            nn.Linear(fc_dim, fc_dim))
        self.register_buffer("mean", torch.tensor(_CAFFE_MEAN if preprocess == "caffe"
                                                  else _TV_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_TV_STD).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2:] != (self.input_size, self.input_size):
            x = F.interpolate(x, size=(self.input_size, self.input_size), mode="bilinear",
                              align_corners=False, antialias=True)
        if self.preprocess == "caffe":
            x = x * 255.0 - self.mean
        elif self.preprocess == "torchvision":
            x = (x - self.mean) / self.std
        x = self.features(x)
        return self.classifier(torch.flatten(x, 1))


def load_vgg16(weights_path: Optional[str] = None, preprocess: str = "caffe",
               tiny: bool = False, seed: int = 0, device="cuda") -> VGG16Features:
    """The tower in eval mode on `device`. `tiny` builds a narrow one for
    smoke tests (stages (4,), (8,), fc 16, input 16). Without a weights file
    it starts from flax's default init drawn from `seed` (lecun_normal
    kernels, zero biases), as the JAX tower does: P&R numbers are then
    internally consistent but not comparable to the reference's."""
    device = resolve_device(str(device))
    if tiny:
        model = VGG16Features(TINY_STAGES, fc_dim=16, input_size=16, preprocess=preprocess)
    else:
        model = VGG16Features(preprocess=preprocess)
    if weights_path is not None:
        load_torch_weights(model, weights_path, drop=("classifier.6.",))
    else:
        lecun_init_(model, torch.Generator().manual_seed(seed))
    return model.eval().requires_grad_(False).to(device)


def make_vgg_feature_fn(model: nn.Module, batch_size: int = 64):
    """Batched fc2-feature extractor over an (N, H, W, C) array in [0, 1]
    (numpy); returns numpy (N, fc_dim). Each batch runs on the model's
    device."""
    device = next(model.parameters()).device

    def extract(images) -> np.ndarray:
        feats = []
        with torch.no_grad():
            for i in range(0, len(images), batch_size):
                chunk = np.asarray(images[i:i + batch_size], np.float32)
                feats.append(model(torch.from_numpy(chunk).to(device).permute(0, 3, 1, 2))
                             .cpu().numpy())
        return np.concatenate(feats)

    return extract


def params_from_jax(variables: Mapping, stages=VGG16_STAGES) -> Dict[str, torch.Tensor]:
    """The JAX tower's flax variables ({"params": {conv_i, fc1, fc2}}) -> the
    port's state dict for a tower of `stages`: conv_i -> the i-th conv of
    ``features`` (kernels (3, 3, I, O) -> (O, I, 3, 3)), fc1 and fc2 ->
    ``classifier.0`` and ``classifier.3`` (kernels transposed)."""
    conv_index, idx = [], 0
    for stage in stages:
        for _ in stage:
            conv_index.append(idx)
            idx += 2  # conv, ReLU
        idx += 1  # max pool
    names = {f"conv_{i}": f"features.{j}" for i, j in enumerate(conv_index)}
    names.update(fc1="classifier.0", fc2="classifier.3")
    out: Dict[str, torch.Tensor] = {}
    for name, leaves in variables["params"].items():
        if name not in names:
            raise KeyError(f"unknown VGG16 param {name}")
        for leaf, value in leaves.items():
            v = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            elif leaf != "bias":
                raise KeyError(f"unknown VGG16 leaf {name}/{leaf}")
            out[f"{names[name]}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                torch.from_numpy(np.ascontiguousarray(v)))
    return out
