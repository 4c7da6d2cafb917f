"""UNet2D noise-prediction model (torch.nn, NCHW).

Port of the JAX package's ``models/unet2d.py``: the unconditional
UNet2DModel configs (CIFAR, MNIST, CelebA and the synthetic specs) and the
cross-attention UNet2DConditionModel ones (miniSD, Imagenette), chosen by the
block-type strings of the spec. A conditional spec puts a
`SpatialTransformer` after each resnet of its ``CrossAttn*`` blocks and in
the mid block, with ``attention_head_dim or 8`` heads, attending over the
``encoder_hidden_states`` passed to `forward`. ``remat=True`` recomputes
each resnet, attention and transformer block in the backward (``torch.utils.checkpoint``), as the JAX
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

`members_forward` runs M members of one architecture in one pass, the
counterpart of ``jax.vmap(model.apply)`` over stacked parameters: every
submodule call is one ``torch.func.vmap`` of ``functional_call`` over the
members' weights, so each kernel launches once for all of them. The vmap is
per module, not around the whole forward, so that remat keeps working: the
checkpoint wraps the vmapped block, and its backward recomputes the block
outside any vmap (a checkpoint inside a vmap cannot replay the block once
the vmap has returned).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn
from torch.func import functional_call
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
    SpatialTransformer,
    TimestepEmbedding,
    Upsample,
    sinusoidal_embedding,
)

_DOWN_TYPES = {"DownBlock2D", "AttnDownBlock2D", "CrossAttnDownBlock2D"}
_UP_TYPES = {"UpBlock2D", "AttnUpBlock2D", "CrossAttnUpBlock2D"}
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
    """Noise-prediction U-Net. Input/output NCHW; timesteps shape (B,);
    for a conditional spec, encoder_hidden_states (B, M, cross_attention_dim).

    The forward runs in `compute_dtype` when it is set (parameters stay in
    their own dtype, as the JAX model's ``dtype`` field keeps them f32), else
    in the dtype of the parameters (``model.to(dtype)``), and returns float32.
    """

    def __init__(self, spec: UNetSpec, remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.spec = spec
        self.remat = remat
        self._remat_context = _remat_context_fn(remat_policy)
        self.compute_dtype = compute_dtype
        self._members: Optional[Callable] = None  # set by `members_forward`
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

        def cross_attention(ch: int) -> SpatialTransformer:
            # UNet2DConditionModel convention: attention_head_dim is the head count.
            return SpatialTransformer(ch, spec.attention_head_dim or 8,
                                      spec.cross_attention_dim, groups=groups, eps=eps)

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
                elif block_type == "CrossAttnDownBlock2D":
                    block.attentions.append(cross_attention(ch))
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
        if spec.conditional:
            mid_attention = [cross_attention(ch)]
        else:
            mid_attention = [attention(ch)] if spec.add_attention else []
        self.mid_block.attentions = nn.ModuleList(mid_attention)

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
                elif block_type == "CrossAttnUpBlock2D":
                    block.attentions.append(cross_attention(ch))
            if i < len(spec.up_block_types) - 1:
                block.upsamplers = nn.ModuleList([Upsample(ch, ch)])
            self.up_blocks.append(block)

        self.conv_norm_out = GroupNormSiLU(ch, groups, eps)
        self.conv_out = nn.Conv2d(ch, spec.out_channels, 3, padding=1)

    def _call(self, module: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        """module(*args); in `members_forward`, one vmapped call for every
        member."""
        return (self._members or _plain_call)(module, *args)

    def _run(self, block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        """block(*args), recomputed in the backward under remat (what the
        remat policy saves excepted)."""
        # Bound now: the backward's recompute runs after the forward returned.
        call = functools.partial(self._members or _plain_call, block)
        if self.remat and torch.is_grad_enabled():
            if self._remat_context is None:
                return checkpoint(call, *args, use_reentrant=False)
            return checkpoint(call, *args, use_reentrant=False,
                              context_fn=self._remat_context)
        return call(*args)

    def _attend(self, attention: nn.Module, h: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        if isinstance(attention, SpatialTransformer):
            if context is None:
                raise ValueError("a conditional U-Net needs encoder_hidden_states")
            return self._run(attention, h, context)
        return self._run(attention, h)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.compute_dtype is None:
            return self._forward(x, timesteps, encoder_hidden_states)
        with torch.autocast(x.device.type, dtype=self.compute_dtype):
            return self._forward(x, timesteps, encoder_hidden_states)

    def _forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                 context: Optional[torch.Tensor]) -> torch.Tensor:
        spec = self.spec
        call, run, attend = self._call, self._run, self._attend
        dtype = self.conv_in.weight.dtype
        if context is not None:
            context = context.to(dtype)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        temb = sinusoidal_embedding(
            timesteps.reshape(-1), spec.block_out_channels[0],
            flip_sin_to_cos=spec.flip_sin_to_cos, freq_shift=spec.freq_shift,
        ).reshape(timesteps.shape + (-1,))
        temb = call(self.time_embedding, temb.to(dtype))

        h = call(self.conv_in, x.to(dtype))
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = run(res, h, temb)
                if len(block.attentions):
                    h = attend(block.attentions[j], h, context)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = call(block.downsamplers[0], h)
                skips.append(h)

        h = run(self.mid_block.resnets[0], h, temb)
        if len(self.mid_block.attentions):
            h = attend(self.mid_block.attentions[0], h, context)
        h = run(self.mid_block.resnets[1], h, temb)

        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = run(res, torch.cat([h, skips.pop()], dim=-3), temb)
                if len(block.attentions):
                    h = attend(block.attentions[j], h, context)
            if hasattr(block, "upsamplers"):
                h = call(block.upsamplers[0], h)

        return call(self.conv_out, call(self.conv_norm_out, h)).float()


def _plain_call(module: nn.Module, *args: torch.Tensor) -> torch.Tensor:
    return module(*args)


def members_forward(model: UNet2D, weights: Mapping[str, torch.Tensor], x: torch.Tensor,
                    timesteps: torch.Tensor,
                    encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward of M members of `model`'s architecture in one pass.

    `weights` maps parameter and buffer names (the state dict's) to tensors
    with a leading member axis; a tensor of `model` not named there is the
    same for every member (the frozen base under stacked LoRA side
    branches). x is (M, B, C, H, W), timesteps (M, B), the context (M, B,
    S, D); returns (M, B, C_out, H, W) in float32."""
    names = {module: name for name, module in model.named_modules()}
    subsets: Dict[nn.Module, Dict[str, torch.Tensor]] = {}

    def call(module: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        if module not in subsets:
            prefix = names[module] + "."
            subsets[module] = {k[len(prefix):]: v for k, v in weights.items()
                               if k.startswith(prefix)}
        return torch.func.vmap(lambda w, *a: functional_call(module, w, a))(
            subsets[module], *args)

    model._members = call
    try:
        return model(x, timesteps, encoder_hidden_states)
    finally:
        model._members = None


def empty_unet(spec: UNetSpec, device="cpu", **kwargs) -> UNet2D:
    """A UNet2D on `device` whose parameters hold no values yet: nothing is
    drawn, for a model whose every weight `load_state_dict` fills next (a
    CelebA U-Net's initialisation takes seconds on the CPU). `kwargs` go to
    UNet2D."""
    with torch.device("meta"):
        model = UNet2D(spec, **kwargs)
    return model.to_empty(device=device)


def build_unet(spec: UNetSpec, seed: int, remat: bool = False,
               compute_dtype: Optional[torch.dtype] = None,
               remat_policy: Optional[str] = None, device="cpu") -> UNet2D:
    """A UNet2D with torch's default initialisation drawn from `seed`, without
    touching the caller's global random state. With a CUDA `device` the
    parameters are made and drawn there, from the card's generator (other
    values than the CPU's for one seed; miniSD's 860M parameters take
    seconds to draw on the CPU)."""
    device = torch.device(device)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with device:
            return UNet2D(spec, remat=remat, compute_dtype=compute_dtype,
                          remat_policy=remat_policy)
