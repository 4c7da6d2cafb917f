"""InceptionV3 feature tower (pytorch_fid-compatible), in NCHW.

The port of the JAX package's ``attributions/global_scores/inception_v3.py``:
bilinear resize to 299, input scaling to [-1, 1], the conv tower, pool3
features (the mean over H and W) and logits. Two details of the FID network
are kept: average pools inside the blocks exclude the padding
(count_include_pad=False), and the last block (Mixed_7c) of the FID variant
max-pools its pool branch.

The module names and the state-dict layout are pytorch_fid's and
torchvision's (``Mixed_5b.branch1x1.conv.weight``, ``*.bn.running_var``,
``fc.weight``), so their state dicts load with `load_state_dict` once
``num_batches_tracked`` and the auxiliary head are dropped, as the JAX
converter drops them. `params_from_jax` carries the JAX tower's flax
variables over. Without a weights file the tower starts from a seeded random
init with the He factor, as the JAX package's does: FID values are then
deterministic and carry signal but are not comparable to published ones.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.ckpt import weights_tag
from ...utils.device import resolve_device

# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides its scale by it, so the truncated draw keeps the
# variance asked for.
TRUNC_STD = 0.87962566103423978


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm: running statistics only, never updated."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """Conv (no bias) + frozen BatchNorm(eps=1e-3) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = FrozenBatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_no_pad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool over the window's in-image cells."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avg_pool_no_pad(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    # (kH, kW) kernels with their (H, W) padding: the 1x7 convs pad W, the
    # 7x1 convs pad H.
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_no_pad(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, max_pool: bool = False):
        super().__init__()
        self.max_pool = max_pool  # FIDInceptionE_2 (the FID network's Mixed_7c)
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool else _avg_pool_no_pad(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """Pool3-feature + logits tower. Input (B, 3, H, W) in [0, 1], any H, W.

    num_classes=1008 matches the FID weights (TF-slim head); 1000 with
    fid_variant=False matches torchvision.
    """

    def __init__(self, num_classes: int = 1008, fid_variant: bool = True):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, max_pool=fid_variant)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        # Half-pixel bilinear, as jax.image.resize; antialiased when shrinking
        # (a no-op when growing), as jax.image.resize is.
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=True)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        pool3 = x.mean(dim=(2, 3))
        return {"pool3": pool3, "logits": self.fc(pool3)}


def lecun_init_(module: nn.Module, generator: torch.Generator, conv_gain: float = 1.0) -> None:
    """flax's default init, drawn from `generator` in module order: every
    conv and dense kernel from a normal truncated at two standard deviations
    with std sqrt(1 / fan_in) / TRUNC_STD (lecun_normal), conv kernels times
    `conv_gain`; biases 0."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if isinstance(m, nn.Conv2d):
                    m.weight.mul_(conv_gain)
                if m.bias is not None:
                    m.bias.zero_()


def inception_tag(weights_path: Optional[str] = None, seed: int = 0) -> str:
    """Names the FID tower `load_inception` builds from these arguments, for
    the tag of cached reference stats (`utils.ckpt.weights_tag`)."""
    return weights_tag(weights_path, seed)


def load_torch_weights(model: nn.Module, weights_path: str, drop=()) -> None:
    """Load a state dict saved with torch.save into `model`, strictly, after
    dropping ``num_batches_tracked`` and keys that start with a `drop` prefix."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked") and not k.startswith(tuple(drop))}
    model.load_state_dict(sd)


def load_inception(
    weights_path: Optional[str] = None, num_classes: int = 1008,
    fid_variant: bool = True, seed: int = 0, device="cuda",
) -> InceptionV3:
    """The tower in eval mode on `device`, from a pytorch_fid / torchvision
    state dict (its auxiliary head dropped) or, without one, from a seeded
    random init: flax's lecun_normal with the He factor sqrt(2) on every conv
    kernel, BatchNorm scale 1, bias 0, mean 0, var 1.

    The JAX package gives its random tower the He factor because without it
    ~90 conv+ReLU layers attenuate the activations until pool3 is nearly
    constant and every FID rounds to 0."""
    device = resolve_device(str(device))
    model = InceptionV3(num_classes=num_classes, fid_variant=fid_variant)
    if weights_path is not None:
        load_torch_weights(model, weights_path, drop=("AuxLogits.",))
    else:
        lecun_init_(model, torch.Generator().manual_seed(seed), conv_gain=math.sqrt(2.0))
    return model.eval().requires_grad_(False).to(device)


def make_feature_fn(model: nn.Module, batch_size: int = 256):
    """Batched pool3 + logits extractor over an (N, H, W, C) array in [0, 1]
    (numpy, the host layout of datasets and PNGs): returns numpy (pool3 (N,
    2048), logits (N, num_classes)). Each batch runs on the model's device."""
    device = next(model.parameters()).device

    def extract(images):
        feats, logits = [], []
        with torch.no_grad():
            for i in range(0, len(images), batch_size):
                chunk = np.asarray(images[i:i + batch_size], np.float32)
                x = torch.from_numpy(chunk).to(device).permute(0, 3, 1, 2)
                out = model(x)
                feats.append(out["pool3"].cpu().numpy())
                logits.append(out["logits"].cpu().numpy())
        return np.concatenate(feats), np.concatenate(logits)

    return extract


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX tower's flax variables ({"params", "batch_stats"}, numpy or
    JAX arrays) -> the port's state dict: conv kernels (kH, kW, I, O) ->
    (O, I, kH, kW), the dense kernel transposed, BatchNorm scale/mean/var ->
    weight/running_mean/running_var (the JAX ``convert_torch_state_dict``
    in reverse). Raises on a leaf it does not know."""
    names = {"params": {"scale": "weight", "bias": "bias", "kernel": "weight"},
             "batch_stats": {"mean": "running_mean", "var": "running_var"}}
    out: Dict[str, torch.Tensor] = {}
    for collection, leaves in names.items():
        for path, value in _flatten(variables.get(collection, {})):
            if path[-1] not in leaves:
                raise KeyError(f"unknown {collection} leaf {'/'.join(path)}")
            v = np.asarray(value, dtype=np.float32)
            if path[-1] == "kernel":
                v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            key = ".".join(path[:-1] + (leaves[path[-1]],))
            out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def convert_torch_state_dict(state_dict: Mapping) -> Dict:
    """A pytorch_fid / torchvision InceptionV3 state dict -> the JAX
    package's variables {"params", "batch_stats"} of numpy (the port's copy
    of its ``convert_torch_state_dict``, which ``cli.convert_weights
    inception`` writes): conv (O, I, kH, kW) -> (kH, kW, I, O), BatchNorm
    weight/bias -> scale/bias and running stats -> batch_stats mean/var; the
    aux classifier and num_batches_tracked are dropped."""
    from ...models.convert_diffusers import _numpy, _put

    params: Dict = {}
    batch_stats: Dict = {}
    for key, value in state_dict.items():
        v = _numpy(value)
        parts = key.split(".")
        if parts[-2] == "conv" and parts[-1] == "weight":
            _put(params, tuple(parts[:-1]), "kernel", v.transpose(2, 3, 1, 0))
        elif parts[-2] == "bn":
            leaf = {"weight": (params, "scale"), "bias": (params, "bias"),
                    "running_mean": (batch_stats, "mean"),
                    "running_var": (batch_stats, "var")}.get(parts[-1])
            if leaf:
                _put(leaf[0], tuple(parts[:-1]), leaf[1], v)
        elif parts[0] == "fc":
            if parts[-1] == "weight":
                _put(params, ("fc",), "kernel", v.T)
            else:
                _put(params, ("fc",), "bias", v)
    return {"params": params, "batch_stats": batch_stats}
