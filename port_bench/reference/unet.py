"""The plain reference U-Net: diffusers' UNet2DModel and UNet2DConditionModel
written from their published description in plain PyTorch, float32.

Parameter names are the diffusers state-dict keys, so one state dict made by
the benchmark loads into this module and into the program alike. Everything
runs through `torch.nn.functional`: `F.conv2d`, `F.linear`, `F.group_norm`,
`F.layer_norm` and a softmax attention written out as two products. Nothing
here imports the program.

Where the configuration file states a choice that differs from diffusers'
own defaults, the file wins: the GEGLU's GELU (``gelu``: "tanh" or "erf")
and the transformer blocks' LayerNorm epsilon (``transformer_layer_norm_eps``).

A projection may carry a LoRA side branch: set ``module.lora = (down, up)``
((in, r) and (r, out)) and the output gains ``(x @ down) @ up``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                       freq_shift: float, max_period: float = 10000.0) -> torch.Tensor:
    """diffusers' ``get_timestep_embedding``: (B,) -> (B, dim)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class Linear(nn.Linear):
    """nn.Linear with an optional LoRA side branch (`lora`, set per member)."""

    lora = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight, self.bias)
        if self.lora is not None:
            down, up = self.lora
            y = y + (x @ down) @ up
        return y


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """(B, N, C) queries over (B, M, C) keys and values, `heads` heads."""
    b, n, c = q.shape
    m, d = k.shape[1], c // heads
    q = q.reshape(b, n, heads, d).transpose(1, 2)
    k = k.reshape(b, m, heads, d).transpose(1, 2)
    v = v.reshape(b, m, heads, d).transpose(1, 2)
    p = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return (p @ v).transpose(1, 2).reshape(b, n, c)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.norm1 = nn.GroupNorm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def _norm(self, norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        return F.silu(F.group_norm(x, self.groups, norm.weight, norm.bias, self.eps))

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self._norm(self.norm1, x))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self._norm(self.norm2, h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class SelfAttention(nn.Module):
    """UNet2DModel's spatial attention: GroupNorm, one softmax attention over
    the H*W tokens, a residual."""

    def __init__(self, ch: int, head_dim: Optional[int], groups: int, eps: float):
        super().__init__()
        self.heads = 1 if head_dim is None else max(ch // head_dim, 1)
        self.groups, self.eps = groups, eps
        self.group_norm = nn.GroupNorm(groups, ch, eps)
        self.to_q, self.to_k, self.to_v = Linear(ch, ch), Linear(ch, ch), Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        b, c, h, w = x.shape
        y = F.group_norm(x, self.groups, self.group_norm.weight, self.group_norm.bias, self.eps)
        y = y.reshape(b, c, h * w).transpose(1, 2)
        y = softmax_attention(self.to_q(y), self.to_k(y), self.to_v(y), self.heads)
        return x + self.to_out[0](y).transpose(1, 2).reshape(b, c, h, w)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        context_dim = context_dim or dim
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(context_dim, dim, bias=False)
        self.to_v = Linear(context_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        y = softmax_attention(self.to_q(x), self.to_k(context), self.to_v(context), self.heads)
        return self.to_out[0](y)


class GEGLU(nn.Module):
    def __init__(self, dim: int, out: int, gelu: str):
        super().__init__()
        self.proj = nn.Linear(dim, out * 2)
        self.approximate = {"tanh": "tanh", "erf": "none"}[gelu]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate=self.approximate)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, ln_eps: float, gelu: str):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=ln_eps)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GEGLU(dim, dim * 4, gelu), nn.Identity(),
                                     nn.Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        h = self.norm3(x)
        for layer in self.ff.net:
            h = layer(h)
        return x + h


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GroupNorm, 1x1 proj_in, one transformer block over
    the H*W tokens, 1x1 proj_out, a residual."""

    def __init__(self, ch: int, heads: int, context_dim: int, groups: int, eps: float,
                 ln_eps: float, gelu: str):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.norm = nn.GroupNorm(groups, ch, eps)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, context_dim, ln_eps, gelu)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = F.group_norm(x, self.groups, self.norm.weight, self.norm.bias, self.eps)
        y = self.proj_in(y).reshape(b, c, h * w).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context)
        return x + self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))


class Downsample(nn.Module):
    def __init__(self, ch: int, padding: int):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.padding == 0 else x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNet(nn.Module):
    """The U-Net of a configuration file's ``unet`` group. forward(x (B, C, H,
    W), t (B,), context (B, S, D) or None) -> the noise prediction (B, C, H, W)."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        boc = list(cfg["block_out_channels"])
        groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        head_dim = cfg.get("attention_head_dim")
        ctx_dim = cfg.get("cross_attention_dim")
        ln_eps, gelu = cfg.get("transformer_layer_norm_eps", 1e-5), cfg.get("gelu", "erf")
        self.cfg, self.groups, self.eps = dict(cfg), groups, eps
        temb = boc[0] * 4

        def attention(kind: str, ch: int) -> Optional[nn.Module]:
            if kind.startswith("CrossAttn"):
                return SpatialTransformer(ch, head_dim or 8, ctx_dim, groups, eps, ln_eps, gelu)
            if kind.startswith("Attn"):
                return SelfAttention(ch, head_dim, groups, eps)
            return None

        self.conv_in = nn.Conv2d(cfg["in_channels"], boc[0], 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(boc[0], temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)
        skips, ch = [boc[0]], boc[0]
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["down_block_types"]):
            block = nn.Module()
            block.resnets, block.attentions = nn.ModuleList(), nn.ModuleList()
            for _ in range(cfg["layers_per_block"]):
                block.resnets.append(ResnetBlock(ch, boc[i], temb, groups, eps))
                ch = boc[i]
                if (att := attention(kind, ch)) is not None:
                    block.attentions.append(att)
                skips.append(ch)
            if i < len(boc) - 1:
                block.downsamplers = nn.ModuleList([Downsample(ch, cfg["downsample_padding"])])
                skips.append(ch)
            self.down_blocks.append(block)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock(ch, boc[-1], temb, groups, eps),
                                                ResnetBlock(boc[-1], boc[-1], temb, groups, eps)])
        ch = boc[-1]
        if ctx_dim is not None:
            mid = [attention("CrossAttn", ch)]
        else:
            mid = [attention("Attn", ch)] if cfg.get("add_attention", True) else []
        self.mid_block.attentions = nn.ModuleList(mid)
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["up_block_types"]):
            out = boc[::-1][i]
            block = nn.Module()
            block.resnets, block.attentions = nn.ModuleList(), nn.ModuleList()
            for _ in range(cfg["layers_per_block"] + 1):
                block.resnets.append(ResnetBlock(ch + skips.pop(), out, temb, groups, eps))
                ch = out
                if (att := attention(kind, ch)) is not None:
                    block.attentions.append(att)
            if i < len(boc) - 1:
                block.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(block)
        self.conv_norm_out = nn.GroupNorm(groups, ch, eps)
        self.conv_out = nn.Conv2d(ch, cfg["out_channels"], 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        emb = timestep_embedding(t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"],
                                 cfg["freq_shift"])
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(emb)))
        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                if len(block.attentions):
                    h = block.attentions[j](h, context)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        if len(self.mid_block.attentions):
            h = self.mid_block.attentions[0](h, context)
        h = self.mid_block.resnets[1](h, temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    h = block.attentions[j](h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        norm = self.conv_norm_out
        h = F.silu(F.group_norm(h, self.groups, norm.weight, norm.bias, self.eps))
        return self.conv_out(h)


def lora_targets(model: nn.Module, targets=("to_q", "to_k", "to_v", "to_out")):
    """(name, module) of every attention projection LoRA attaches to, in
    module order; ``to_out.0`` counts as ``to_out``."""
    found = []
    for name, module in model.named_modules():
        parts = [p for p in name.split(".") if not p.isdigit()]
        if isinstance(module, Linear) and parts and parts[-1] in targets:
            found.append((name, module))
    return found
