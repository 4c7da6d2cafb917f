"""UNet2D noise-prediction model (torch.nn, NCHW), unconditional specs.

Port of the JAX package's ``models/unet2d.py`` for the unconditional
UNet2DModel configs (CIFAR, MNIST and the synthetic specs); cross-attention
blocks come with a later slice. ``remat=True`` recomputes each resnet and
attention block in the backward (``torch.utils.checkpoint``), as the JAX
``remat=True`` does; ``remat_policy`` is the JAX model's selective policy,
built on ``create_selective_checkpoint_contexts``: ``full`` (or None) saves
nothing a block computes, ``convs`` saves the outputs of its 3x3
convolutions (the JAX "remat_conv" tags), ``convs_dots`` also those of every
dense product (the JAX ``dots_with_no_batch_dims_saveable``: ``mm`` and
``addmm``, not the batched attention products).
``compute_dtype=torch.bfloat16`` is the JAX model's ``dtype=bfloat16``:
float32 parameters, convolutions, linears and activations in bf16 (under
``torch.autocast``), GroupNorm statistics and attention softmax in f32
inside the kernels, the output in float32. The skip wiring mirrors diffusers:
push after conv_in, after every resnet(+attention) and after every
downsample; up-blocks pop in reverse and concatenate [h, skip] on channels.
Submodule names are the diffusers state-dict keys (``down_blocks.I.resnets.J``,
``mid_block.attentions.0``, ``up_blocks.I.upsamplers.0.conv``, ...).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..config.registry import UNetSpec
from .layers import (
    Downsample,
    GroupNormSiLU,
    ResnetBlock,
    SelfAttention2D,
    TimestepEmbedding,
    Upsample,
    sinusoidal_embedding,
)

_DOWN_TYPES = {"DownBlock2D", "AttnDownBlock2D"}
_UP_TYPES = {"UpBlock2D", "AttnUpBlock2D"}
REMAT_POLICIES = ("full", "convs", "convs_dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _saves(policy: str, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy: which op outputs a block keeps for the
    backward under `policy`; everything else is recomputed."""
    if (op is torch.ops.aten.convolution.default and args[1].dim() == 4
            and tuple(args[1].shape[-2:]) == (3, 3)):
        return CheckpointPolicy.MUST_SAVE
    if policy == "convs_dots" and op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context_fn(policy: Optional[str]):
    """The checkpoint `context_fn` of a remat policy (None for ``full``)."""
    if policy is None or policy == "full":
        return None
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; expected full|convs|convs_dots")
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_saves, policy))


class UNet2D(nn.Module):
    """Noise-prediction U-Net. Input/output NCHW; timesteps shape (B,).

    The forward runs in `compute_dtype` when it is set (parameters stay in
    their own dtype, as the JAX model's ``dtype`` field keeps them f32), else
    in the dtype of the parameters (``model.to(dtype)``), and returns float32.
    """

    def __init__(self, spec: UNetSpec, remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat_policy: Optional[str] = None):
        super().__init__()
        if spec.conditional:
            raise NotImplementedError(
                "cross-attention U-Nets are not ported yet (unconditional specs only)"
            )
        self.spec = spec
        self.remat = remat
        self._remat_context = _remat_context_fn(remat_policy)
        self.compute_dtype = compute_dtype
        boc = spec.block_out_channels
        groups, eps = spec.norm_num_groups, spec.norm_eps
        temb_ch = boc[0] * 4

        def hidden(path: str):
            if spec.pruned_channels is None:
                return None
            return spec.pruned_channels.get(path)

        def resnet(path: str, cin: int, cout: int) -> ResnetBlock:
            return ResnetBlock(cin, cout, temb_ch, hidden(path), groups, eps, spec.dropout)

        def attention(ch: int) -> SelfAttention2D:
            return SelfAttention2D(ch, spec.attention_head_dim, groups, eps)

        self.conv_in = nn.Conv2d(spec.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb_ch)

        skip_ch = [boc[0]]
        ch = boc[0]
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(spec.down_block_types):
            if block_type not in _DOWN_TYPES:
                raise ValueError(f"unknown down block {block_type!r}")
            out_ch = boc[i]
            block = nn.Module()
            block.resnets = nn.ModuleList()
            block.attentions = nn.ModuleList()
            for j in range(spec.layers_per_block):
                block.resnets.append(resnet(f"down_{i}_res_{j}", ch, out_ch))
                ch = out_ch
                if block_type == "AttnDownBlock2D":
                    block.attentions.append(attention(ch))
                skip_ch.append(ch)
            if i < len(spec.down_block_types) - 1:
                block.downsamplers = nn.ModuleList(
                    [Downsample(ch, ch, padding=spec.downsample_padding)]
                )
                skip_ch.append(ch)
            self.down_blocks.append(block)

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [resnet("mid_res_0", ch, boc[-1]), resnet("mid_res_1", boc[-1], boc[-1])]
        )
        ch = boc[-1]
        self.mid_block.attentions = nn.ModuleList(
            [attention(ch)] if spec.add_attention else []
        )

        self.up_blocks = nn.ModuleList()
        for i, block_type in enumerate(spec.up_block_types):
            if block_type not in _UP_TYPES:
                raise ValueError(f"unknown up block {block_type!r}")
            out_ch = boc[::-1][i]
            block = nn.Module()
            block.resnets = nn.ModuleList()
            block.attentions = nn.ModuleList()
            for j in range(spec.layers_per_block + 1):
                block.resnets.append(resnet(f"up_{i}_res_{j}", ch + skip_ch.pop(), out_ch))
                ch = out_ch
                if block_type == "AttnUpBlock2D":
                    block.attentions.append(attention(ch))
            if i < len(spec.up_block_types) - 1:
                block.upsamplers = nn.ModuleList([Upsample(ch, ch)])
            self.up_blocks.append(block)

        self.conv_norm_out = GroupNormSiLU(ch, groups, eps)
        self.conv_out = nn.Conv2d(ch, spec.out_channels, 3, padding=1)

    def _run(self, block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        """block(*args), recomputed in the backward under remat (what the
        remat policy saves excepted)."""
        if self.remat and torch.is_grad_enabled():
            if self._remat_context is None:
                return checkpoint(block, *args, use_reentrant=False)
            return checkpoint(block, *args, use_reentrant=False,
                              context_fn=self._remat_context)
        return block(*args)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return self._forward(x, timesteps)
        with torch.autocast(x.device.type, dtype=self.compute_dtype):
            return self._forward(x, timesteps)

    def _forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        run = self._run
        dtype = self.conv_in.weight.dtype
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        temb = sinusoidal_embedding(
            timesteps, spec.block_out_channels[0],
            flip_sin_to_cos=spec.flip_sin_to_cos, freq_shift=spec.freq_shift,
        )
        temb = self.time_embedding(temb.to(dtype))

        h = self.conv_in(x.to(dtype))
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = run(res, h, temb)
                if len(block.attentions):
                    h = run(block.attentions[j], h)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)

        h = run(self.mid_block.resnets[0], h, temb)
        if len(self.mid_block.attentions):
            h = run(self.mid_block.attentions[0], h)
        h = run(self.mid_block.resnets[1], h, temb)

        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = run(res, torch.cat([h, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    h = run(block.attentions[j], h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        return self.conv_out(self.conv_norm_out(h)).float()


def build_unet(spec: UNetSpec, seed: int, remat: bool = False,
               compute_dtype: Optional[torch.dtype] = None,
               remat_policy: Optional[str] = None) -> UNet2D:
    """A UNet2D with torch's default initialisation drawn from `seed`, without
    touching the caller's global random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return UNet2D(spec, remat=remat, compute_dtype=compute_dtype,
                      remat_policy=remat_policy)
