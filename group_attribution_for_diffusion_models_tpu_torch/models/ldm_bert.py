"""LDMBert text tower of the LDM text-to-image path (torch.nn).

Port of the JAX package's ``models/ldm_bert.py``. The reference's
imagenette workload conditions its LDM U-Net on ``pipeline.bert`` of
CompVis/ldm-text2im-large-256 (reference src/diffusion_utils.py:215-223),
diffusers' ``LDMBertModel``: vocab 30522, 77 positions, 32 layers at
d_model 1280, attention 8 heads x 64 = 512 wide, projected down from and
back up to d_model with bias-free q/k/v, an exact-GELU MLP of 5120, and a
final LayerNorm (542,895,360 parameters at the defaults). The pipeline
calls it without an attention mask, so padding tokens attend here too.

Module names are the diffusers state dict's without the ``model.`` prefix
(``embed_tokens``, ``embed_positions``, ``layers.I.self_attn.q_proj``,
``layers.I.self_attn_layer_norm``, ``layers.I.fc1``, ``layer_norm``), so a
diffusers file loads with `load_state_dict` once that prefix and the
unused ``to_logits`` head are dropped (`read_ldm_bert`).

Two choices differ from the JAX module, which the port does not reproduce
(ROADMAP C4):

* **Pre-LN layers.** Each layer is ``x + attn(LN(x))`` then
  ``x + fc2(gelu(fc1(LN(x))))``, with the final LayerNorm after the last
  layer: diffusers' layer is MBart's, the layout of the x-transformers
  ``Encoder`` (pre-norm, one final norm) that the CompVis weights were
  trained in. The JAX module normalises after each residual sum (post-LN)
  and then again at the end.
* **LayerNorm epsilon 1e-5**, torch's default as diffusers builds it; the
  JAX module takes flax's 1e-6.

The attention is a plain product with an f32 softmax on cuBLAS, as the JAX
module computes it with ``einsum`` outside any Pallas kernel. Without
weights the tower is a seeded draw on its device: embeddings and positions
N(0, 0.02^2), lecun-normal kernels, zero biases, unit LayerNorm scales.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..attributions.global_scores.inception_v3 import lecun_init_
from ..utils.device import resolve_device

LN_EPS = 1e-5  # diffusers' LDMBertModel (torch's default); the JAX module's flax default is 1e-6
TEXT_TOWER_SEED = 11  # the random tower of cli.main's conditional path (JAX: PRNGKey(11))


class LDMBertAttention(nn.Module):
    """`num_heads` x `head_dim` self-attention at inner width
    head_dim * num_heads, no mask."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.q_proj = nn.Linear(d_model, inner, bias=False)
        self.k_proj = nn.Linear(d_model, inner, bias=False)
        self.v_proj = nn.Linear(d_model, inner, bias=False)
        self.out_proj = nn.Linear(inner, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = (self.q_proj(x) * self.head_dim ** -0.5).reshape(shape).transpose(1, 2)
        k = self.k_proj(x).reshape(shape).transpose(1, 2)
        v = self.v_proj(x).reshape(shape).transpose(1, 2)
        probs = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.out_proj((probs @ v).transpose(1, 2).reshape(b, s, -1))


class LDMBertLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, head_dim: int, ffn_dim: int):
        super().__init__()
        self.self_attn = LDMBertAttention(d_model, num_heads, head_dim)
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        h = nn.functional.gelu(self.fc1(self.final_layer_norm(x)), approximate="none")
        return x + self.fc2(h)


class LDMBertEncoder(nn.Module):
    """input_ids (B, S) -> hidden states (B, S, d_model), S <= max_positions."""

    def __init__(self, vocab_size: int = 30522, max_positions: int = 77, d_model: int = 1280,
                 layers: int = 32, num_heads: int = 8, head_dim: int = 64,
                 ffn_dim: int = 5120):
        super().__init__()
        self.d_model = d_model
        self.embed_tokens = nn.Embedding(vocab_size, d_model)
        self.embed_positions = nn.Embedding(max_positions, d_model)
        self.layers = nn.ModuleList(LDMBertLayer(d_model, num_heads, head_dim, ffn_dim)
                                    for _ in range(layers))
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        if int(input_ids.max()) >= self.embed_tokens.num_embeddings:
            raise ValueError(
                f"token id {int(input_ids.max())} is outside LDMBert's vocabulary of "
                f"{self.embed_tokens.num_embeddings}: tokenize with its WordPiece vocab.txt")
        h = self.embed_tokens(input_ids) + self.embed_positions.weight[None, :input_ids.shape[1]]
        for layer in self.layers:
            h = layer(h)
        return self.layer_norm(h)


def ldm_bert_spec(width: int) -> Dict[str, int]:
    """The tower cli.main conditions a U-Net of cross-attention width `width`
    on, as the JAX CLI sizes it: the full 32-layer tower at 1280 and over, a
    2-layer one of head dim max(width // 8, 4) for the small synthetic
    configs."""
    full = width >= 1280
    return dict(d_model=width, layers=32 if full else 2, num_heads=8,
                head_dim=64 if full else max(width // 8, 4), ffn_dim=width * 4)


def init_ldm_bert(model: LDMBertEncoder, seed: int) -> LDMBertEncoder:
    """Draw `model`'s parameters on its device from a generator seeded with
    `seed` (the module docstring's distributions)."""
    device = model.layer_norm.weight.device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        model.embed_tokens.weight.normal_(0.0, 0.02, generator=gen)
        model.embed_positions.weight.normal_(0.0, 0.02, generator=gen)
    lecun_init_(model, gen)
    return model


def read_ldm_bert(weights_path: str) -> Dict[str, torch.Tensor]:
    """The state dict in `weights_path`: the ``.npz`` of the JAX package's
    ``cli.convert_weights ldm_bert`` ('/'-joined flax paths), or a torch
    ``LDMBertModel`` state-dict file (keys under ``model.`` or bare; the
    ``to_logits`` head dropped), f32."""
    from .convert_diffusers import ldm_bert_params_from_jax

    if weights_path.endswith(".npz"):
        with np.load(weights_path) as store:
            tree: Dict = {}
            for key in store.files:
                node = tree
                parts = key.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = store[key]
        return ldm_bert_params_from_jax(tree)
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    out = {}
    for key, value in sd.items():
        key = key[len("model."):] if key.startswith("model.") else key
        if not key.startswith("to_logits.") and key != "embed_positions.position_ids":
            out[key] = value.float()
    return out


def load_ldm_bert(weights_path: Optional[str] = None, device="cuda", quiet: bool = False,
                  **config) -> LDMBertEncoder:
    """The frozen tower in eval mode on `device`: the weights in
    `weights_path` (`read_ldm_bert`; a file for a tower of other shapes
    exits with the first mismatches), else the seeded random tower
    TEXT_TOWER_SEED. `config` sizes the tower (`LDMBertEncoder`'s
    arguments)."""
    device = resolve_device(str(device))
    with device:
        model = LDMBertEncoder(**config)
    if weights_path:
        sd = read_ldm_bert(weights_path)
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))[:8]
            raise SystemExit(f"{weights_path} does not match the {model.d_model}-wide "
                             f"LDMBert text tower; first mismatches: {diff}")
        model.load_state_dict(sd)
    else:
        init_ldm_bert(model, TEXT_TOWER_SEED)
        if not quiet:
            print("WARNING: LDMBert text tower running random-init (no weights); "
                  "outputs are not reference-comparable")
    return model.eval().requires_grad_(False)


def convert_ldm_bert_state_dict(state_dict: Dict) -> Dict:
    """A torch ``LDMBertModel`` state dict (keys under ``model.`` or bare)
    -> the JAX package's param tree of numpy (the port's copy of its
    ``convert_ldm_bert_state_dict``, which ``cli.convert_weights ldm_bert``
    writes): linears transposed, embeddings as they are, LayerNorm weight ->
    scale, the ``to_logits`` head dropped."""
    from .convert_diffusers import _numpy, _put

    params: Dict = {}
    for key, value in state_dict.items():
        v = _numpy(value)
        parts = key.split(".")
        if parts[0] == "model":
            parts = parts[1:]
        if not parts or parts[0] == "to_logits":
            continue
        if parts[0] == "embed_tokens":
            _put(params, ("embed_tokens",), "embedding", v)
        elif parts[0] == "embed_positions":
            params["embed_positions"] = v
        elif parts[0] == "layers":
            mod, leaf = (f"layer_{parts[1]}", *parts[2:-1]), parts[-1]
            if leaf == "weight" and v.ndim == 2:
                _put(params, mod, "kernel", v.T)
            else:
                _put(params, mod, "scale" if leaf == "weight" else "bias", v)
        elif parts[0] == "layer_norm":
            _put(params, ("layer_norm",), "scale" if parts[-1] == "weight" else "bias", v)
    return params
