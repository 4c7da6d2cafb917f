"""U-Net building blocks (torch.nn, NCHW).

Port of the JAX package's ``models/layers.py``. Module and parameter names
follow the diffusers v0.24 layout (``norm1``, ``conv1``, ``time_emb_proj``,
``to_q``, ``to_out.0``, and for the cross-attention transformer
``proj_in``, ``transformer_blocks.0.attn2``, ``ff.net.0.proj``, ...) so a
diffusers UNet2DModel or UNet2DConditionModel state dict loads as it is. GroupNorm(+SiLU) and attention go through ``ops``: the CUDA
kernels on the card, their plain versions on the CPU. Convolutions and the
q/k/v/out projections are plain ``F.conv2d``/``F.linear``, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.group_norm import group_norm_silu


def sinusoidal_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = False,
    freq_shift: float = 1.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Transformer sinusoidal timestep embedding (diffusers
    get_timestep_embedding, including the downscale_freq_shift denominator)."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class LoRADense(nn.Linear):
    """Linear layer with an optional LoRA side branch, as the JAX module:
    y = x W^T + b + (x @ lora_down) @ lora_up when a (in, r) `lora_down` and a
    (r, out) `lora_up` are attached. They are non-persistent buffers, None by
    default, so the state dict keeps the nn.Linear keys; a caller attaches
    them per call through ``torch.func.functional_call`` (TRAK's probe
    sketch differentiates `lora_up` alone)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.register_buffer("lora_down", None, persistent=False)
        self.register_buffer("lora_up", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_down is not None:
            y = y + (x @ self.lora_down.to(y.dtype)) @ self.lora_up.to(y.dtype)
        return y


class Conv1x1(nn.Conv2d):
    """1x1 convolution (the JAX module's lowering knobs do not apply here)."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP lifting the sinusoidal embedding to time_embed_dim."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(temb)))


class GroupNormSiLU(nn.Module):
    """GroupNorm with an optional fused SiLU (parameters as nn.GroupNorm:
    weight, bias). Output in the input's dtype."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6,
                 silu: bool = True):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(
            x, self.weight, self.bias, groups=self.groups, eps=self.eps,
            silu=self.silu,
        )


class ResnetBlock(nn.Module):
    """GN-SiLU-Conv resnet block with additive time conditioning.

    `hidden_channels` (conv1 out / conv2 in) is separate from `out_channels`
    so structurally pruned specs keep the block interface. With
    `temb_channels=None` the block has no ``time_emb_proj`` (the VQ-VAE's
    blocks, which the JAX module runs with ``temb=None``).
    """

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 hidden_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-6, dropout: float = 0.0):
        super().__init__()
        hidden = hidden_channels or out_channels
        self.norm1 = GroupNormSiLU(in_channels, groups, eps)
        self.conv1 = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.time_emb_proj = (
            nn.Linear(temb_channels, hidden) if temb_channels is not None else None
        )
        self.norm2 = GroupNormSiLU(hidden, groups, eps)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(hidden, out_channels, 3, padding=1)
        self.conv_shortcut = (
            Conv1x1(in_channels, out_channels) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.dropout(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class SelfAttention2D(nn.Module):
    """Spatial self-attention over HxW tokens (row-major) with a residual.

    head_dim=None means a single head of full channel width (the diffusers
    UNet2DModel attention_head_dim=None convention the CIFAR config uses).
    """

    def __init__(self, channels: int, head_dim: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_heads = 1 if head_dim is None else max(channels // head_dim, 1)
        self.group_norm = GroupNormSiLU(channels, groups, eps, silu=False)
        self.to_q = LoRADense(channels, channels)
        self.to_k = LoRADense(channels, channels)
        self.to_v = LoRADense(channels, channels)
        self.to_out = nn.ModuleList([LoRADense(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        heads = self.num_heads
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)  # (B, HW, C)
        q = self.to_q(y).reshape(b, h * w, heads, c // heads)
        k = self.to_k(y).reshape(b, h * w, heads, c // heads)
        v = self.to_v(y).reshape(b, h * w, heads, c // heads)
        y = dot_product_attention(q, k, v).reshape(b, h * w, c)
        y = self.to_out[0](y)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    """Stride-2 conv downsample; padding=0 pads diffusers' asymmetric (0,1)."""

    def __init__(self, channels: int, out_channels: int, padding: int = 0):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample followed by a 3x3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class GEGLU(nn.Module):
    """Gated GELU projection (diffusers ``GEGLU``, parameters ``proj``): the
    tanh-approximated GELU of flax's ``nn.gelu``, as the JAX module uses."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU to 4x the width, then back (diffusers ``FeedForward``: ``net.0``
    and ``net.2``; ``net.1`` is its dropout, 0 here)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class CrossAttention(nn.Module):
    """Multi-head attention of (B, N, C) tokens over a (B, M, context_dim)
    context, or over themselves without one. `heads` is the head count (the
    UNet2DConditionModel reading of ``attention_head_dim``). to_q/to_k/to_v
    have no bias, to_out has one; all four are LoRADense, so LoRA attaches
    to each projection with its own rank."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        context_dim = context_dim or dim
        self.heads = heads
        self.to_q = LoRADense(dim, dim, bias=False)
        self.to_k = LoRADense(context_dim, dim, bias=False)
        self.to_v = LoRADense(context_dim, dim, bias=False)
        self.to_out = nn.ModuleList([LoRADense(dim, dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        b, n, c = x.shape
        m, heads = context.shape[1], self.heads
        q = self.to_q(x).reshape(b, n, heads, c // heads)
        k = self.to_k(context).reshape(b, m, heads, c // heads)
        v = self.to_v(context).reshape(b, m, heads, c // heads)
        return self.to_out[0](dot_product_attention(q, k, v).reshape(b, n, c))


class TransformerBlock(nn.Module):
    """BasicTransformerBlock: pre-LN self-attention, cross-attention over the
    context, GEGLU feed-forward, each with a residual. LayerNorm eps is
    flax's default 1e-6, as the JAX block uses."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GroupNorm (no SiLU), 1x1 proj_in, `depth`
    transformer blocks over the HxW tokens (row-major), 1x1 proj_out, and a
    residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, depth: int = 1,
                 groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm = GroupNormSiLU(channels, groups, eps, silu=False)
        self.proj_in = Conv1x1(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(channels, heads, context_dim) for _ in range(depth)])
        self.proj_out = Conv1x1(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, c, h * w).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context)
        return x + self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))
