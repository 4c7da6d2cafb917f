"""ResNet-18 feature tower (torchvision layout), for the cifar100_new regroup.

Port of the JAX package's ``models/resnet.py``. The reference's
CIFAR100_regroup embeds every image with torchvision's pretrained
``resnet18`` minus its fc head (reference src/datasets.py:198-235: resize to
224, ImageNet normalisation) and k-means the embeddings into 40 groups.

The graph is torchvision's v1 (He et al. 2015): a 7x7/2 stem conv, BN-ReLU,
a 3x3/2 max pool, four stages of two BasicBlocks at widths (64, 128, 256,
512), stages 2-4 opening with a stride-2 conv and a 1x1 projection shortcut,
then a global average pool to 512-d. Module names are torchvision's
(``conv1``, ``bn1``, ``layer<L>.<B>.{conv1,bn1,conv2,bn2}``,
``layer<L>.<B>.downsample.{0,1}``), so a torchvision state dict loads as it
is once its ``fc.`` head is dropped. BatchNorm runs in eval mode from its
running statistics. `load_resnet18` also reads the '/'-joined ``.npz`` that
the JAX package's ``cli.convert_weights --kind resnet18`` writes (flax
``params``/``batch_stats``; conv kernels HWIO), and `params_from_jax` carries
the JAX tower's variables over. The convolutions and BatchNorms are cuDNN's:
no TPU kernel of the JAX package runs in this tower.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

RESNET18_STAGES: Tuple[int, ...] = (64, 128, 256, 512)
RESNET18_BLOCKS: Tuple[int, ...] = (2, 2, 2, 2)
EMBED_SIZE = 224  # the reference's regroup transform resizes to 224

_TV_MEAN = (0.485, 0.456, 0.406)
_TV_STD = (0.229, 0.224, 0.225)


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN with an identity or projection shortcut."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, ch, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(ch)
        self.downsample = None
        if stride != 1 or in_ch != ch:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, ch, 1, stride, bias=False),
                                            nn.BatchNorm2d(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(h)) + identity)


class ResNet18Features(nn.Module):
    """Input (B, 3, H, W) RGB in [0, 1], normalised by the ImageNet mean/std;
    returns the pooled (B, 512) feature."""

    def __init__(self, stages: Tuple[int, ...] = RESNET18_STAGES,
                 blocks: Tuple[int, ...] = RESNET18_BLOCKS):
        super().__init__()
        self.conv1 = nn.Conv2d(3, stages[0], 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(stages[0])
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = stages[0]
        for i, (ch, n) in enumerate(zip(stages, blocks)):
            layer = []
            for b in range(n):
                layer.append(BasicBlock(in_ch, ch, 2 if (i > 0 and b == 0) else 1))
                in_ch = ch
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.num_stages = len(stages)
        self.register_buffer("mean", torch.tensor(_TV_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_TV_STD).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x - self.mean) / self.std
        h = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            h = getattr(self, f"layer{i + 1}")(h)
        return h.mean(dim=(2, 3))


def _module_name(path: Tuple[str, ...]) -> str:
    """A flax module path (``layer1_0``, ``downsample_conv``) -> torchvision's."""
    if path[0] in ("conv1", "bn1"):
        return path[0]
    layer, block = path[0].rsplit("_", 1)
    sub = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(
        path[1], path[1])
    return f"{layer}.{block}.{sub}"


def state_dict_from_flat(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX tower's variables as '/'-joined keys (``params/<module
    path>/{kernel,scale,bias}``, ``batch_stats/<module path>/{mean,var}``,
    the ``cli.convert_weights`` .npz layout) -> the torchvision state dict
    (conv kernels HWIO -> OIHW)."""
    leaf_names = {("params", "kernel"): "weight", ("params", "scale"): "weight",
                  ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
                  ("batch_stats", "var"): "running_var"}
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split("/")
        collection, path, leaf = parts[0], tuple(parts[1:-1]), parts[-1]
        if (collection, leaf) not in leaf_names:
            raise KeyError(f"unknown ResNet-18 variable {key}")
        v = np.array(value, dtype=np.float32)  # a writable copy
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1)
        out[f"{_module_name(path)}.{leaf_names[collection, leaf]}"] = (
            torch.from_numpy(np.ascontiguousarray(v)))
    return out


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX tower's nested flax variables ({"params", "batch_stats"}) ->
    the torchvision state dict."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(variables, "")
    return state_dict_from_flat(flat)


def init_resnet18(seed: int = 0) -> ResNet18Features:
    """torchvision's init drawn from `seed`: Kaiming-normal (fan_out, ReLU)
    conv kernels, BatchNorm scale 1 and shift 0, running mean 0, var 1."""
    model = ResNet18Features()
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = (2.0 / (m.out_channels * m.kernel_size[0] * m.kernel_size[1])) ** 0.5
            with torch.no_grad():
                m.weight.normal_(0.0, std, generator=gen)
    return model


def load_resnet18(weights_path: str, device="cuda") -> ResNet18Features:
    """The tower in eval mode on `device` with the weights of `weights_path`:
    the JAX layout's ``.npz``, else a torchvision ``resnet18`` state-dict
    file, its ``fc.`` head dropped."""
    device = resolve_device(str(device))
    model = ResNet18Features()
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as flat:
            sd = state_dict_from_flat(dict(flat))
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items()
              if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd)
    return model.eval().requires_grad_(False).to(device)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size), bilinear with half-pixel centers
    and no antialias: ``jax.image.resize(..., "bilinear")`` on an upscale."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=False)


def resnet18_embed(model: ResNet18Features, images01: np.ndarray, batch_size: int = 256,
                   input_size: int = EMBED_SIZE) -> np.ndarray:
    """Per-image (N, 512) float32 embeddings of NHWC images in [0, 1]
    (numpy), batch by batch on the model's device: the resize to
    `input_size`, then the tower (the reference's regroup transform)."""
    device = next(model.parameters()).device
    feats = []
    with torch.no_grad():
        for i in range(0, len(images01), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(images01[i:i + batch_size], np.float32))
            x = resize_bilinear(x.to(device).permute(0, 3, 1, 2), input_size)
            feats.append(model(x).cpu().numpy())
    return np.concatenate(feats)
