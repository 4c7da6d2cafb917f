"""CLIP text tower of the Stable-Diffusion (miniSD) path (torch.nn).

Port of the JAX package's ``models/clip_text.py``: the SD 1.x text tower
(CLIP ViT-L/14: vocab 49408, context 77, width 768, 12 layers, 12 heads),
token and learned position embeddings, pre-LN layers (eps 1e-5) with
quick-GELU MLPs and an additive causal mask of -1e9, and the final
LayerNorm; the output is the last hidden state (B, 77, width), the U-Net's
conditioning. Module names are HF ``CLIPTextModel``'s
(``text_model.encoder.layers.I.self_attn.q_proj``, ...), so a torch state
dict of that model loads as it is. Its attention is a plain product with
the mask and a softmax, as the JAX module computes it outside any kernel.

Tokenization: `load_tokenizer` gives the pure-Python CLIP BPE
(`models.clip_tokenizer`) for a directory with vocab.json + merges.txt,
else `HashTokenizer`, the JAX package's deterministic stand-in (md5 of each
whitespace token into the vocab range, between BOS and EOS, EOS-padded),
bit for bit. Without weights the tower is a seeded draw of the JAX init's
distributions: embeddings N(0, 1/width), positions N(0, 0.01^2), lecun
normal kernels, zero biases, unit LayerNorm scales.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..attributions.global_scores.inception_v3 import lecun_init_
from ..utils.device import resolve_device

TEXT_TOWER_SEED = 1  # the random tower both text-to-image CLIs share (JAX: PRNGKey(1))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        hd = w // self.heads
        q = self.q_proj(x) * hd ** -0.5
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2)
                   for t in (q, self.k_proj(x), self.v_proj(x)))
        attn = torch.softmax(q @ k.transpose(-1, -2) + mask, dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, n, w))


class CLIPMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, width * 4)
        self.fc2 = nn.Linear(width * 4, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.self_attn = CLIPAttention(width, heads)
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = CLIPMLP(width)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEncoder(nn.Module):
    """input_ids (B, n) -> last hidden state (B, n, width), n <= max_length."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77, width: int = 768,
                 layers: int = 12, heads: int = 12):
        super().__init__()
        self.width = width
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(vocab_size, width)
        tm.embeddings.position_embedding = nn.Embedding(max_length, width)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([CLIPEncoderLayer(width, heads)
                                           for _ in range(layers)])
        tm.final_layer_norm = nn.LayerNorm(width, eps=1e-5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        n = input_ids.shape[1]
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[None, :n])
        mask = torch.full((n, n), -1e9, dtype=x.dtype, device=x.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


def init_clip_text(model: CLIPTextEncoder, seed: int) -> CLIPTextEncoder:
    """Draw `model`'s parameters from the JAX init's distributions on the
    model's device, from a generator seeded with `seed`."""
    device = model.text_model.final_layer_norm.weight.device
    gen = torch.Generator(device=device).manual_seed(seed)
    emb = model.text_model.embeddings
    with torch.no_grad():
        emb.token_embedding.weight.normal_(0.0, 1.0 / math.sqrt(model.width), generator=gen)
        emb.position_embedding.weight.normal_(0.0, 0.01, generator=gen)
    lecun_init_(model, gen)
    return model


def read_clip_text(weights_path: str) -> Dict[str, torch.Tensor]:
    """The state dict in `weights_path`: the ``.npz`` of the JAX package's
    ``cli.convert_weights clip_text`` ('/'-joined JAX paths), or a torch
    CLIPTextModel state-dict file (keys with or without the ``text_model.``
    prefix; its ``position_ids`` buffer dropped)."""
    from .convert_diffusers import clip_text_params_from_jax

    if weights_path.endswith(".npz"):
        with np.load(weights_path) as store:
            tree: Dict = {}
            for key in store.files:
                node = tree
                parts = key.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = store[key]
        return clip_text_params_from_jax(tree)
    out = {}
    for key, value in torch.load(weights_path, map_location="cpu", weights_only=True).items():
        key = key if key.startswith("text_model.") else f"text_model.{key}"
        if key != "text_model.embeddings.position_ids":
            out[key] = value.float()
    return out


def load_clip_text(weights_path: Optional[str] = None, device="cuda", quiet: bool = False,
                   **config) -> CLIPTextEncoder:
    """The frozen text tower in eval mode on `device`: the weights in
    `weights_path` (`read_clip_text`; a tower of another shape raises), else
    the seeded random tower TEXT_TOWER_SEED. `config` sizes the tower
    (`CLIPTextEncoder`'s arguments)."""
    device = resolve_device(str(device))
    with device:
        model = CLIPTextEncoder(**config)
    if weights_path:
        sd = read_clip_text(weights_path)
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))[:8]
            raise SystemExit(f"{weights_path} does not match the {model.width}-wide CLIP "
                             f"text tower; first mismatches: {diff}")
        model.load_state_dict(sd)
    else:
        init_clip_text(model, TEXT_TOWER_SEED)
        if not quiet:
            print("WARNING: CLIP text tower running random-init (no weights); "
                  "outputs are not reference-comparable")
    return model.eval().requires_grad_(False)


class HashTokenizer:
    """Deterministic stand-in tokenizer: stable token hashing + BOS/EOS/pad."""

    bos_id = 49406
    eos_id = 49407

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos_id, np.int32)
        for row, text in enumerate(texts):
            ids = [self.bos_id]
            for word in text.lower().split()[: self.max_length - 2]:
                h = int(hashlib.md5(word.encode()).hexdigest(), 16)
                ids.append(h % (self.vocab_size - 2))
            ids.append(self.eos_id)
            out[row, : len(ids)] = ids
        return out


def load_tokenizer(vocab_dir: Optional[str] = None, max_length: int = 77):
    """The CLIP BPE of `vocab_dir` (vocab.json + merges.txt; an explicitly
    requested vocab must load), else `HashTokenizer`."""
    if vocab_dir is not None:
        from .clip_tokenizer import CLIPBPETokenizer

        return CLIPBPETokenizer.from_dir(vocab_dir, max_length=max_length)
    return HashTokenizer(max_length=max_length)


def convert_clip_text_state_dict(state_dict: Dict) -> Dict:
    """An HF CLIPTextModel state dict -> the JAX package's param tree of
    numpy (the port's copy of its ``convert_clip_text_state_dict``, which
    ``cli.convert_weights clip_text`` writes): linears transposed, LayerNorm
    weight -> scale, other keys dropped."""
    from .convert_diffusers import _numpy, _put

    p: Dict = {}
    for key, value in state_dict.items():
        v = _numpy(value)
        key = key.replace("text_model.", "")
        if key == "embeddings.token_embedding.weight":
            _put(p, ("token_embedding",), "embedding", v)
        elif key == "embeddings.position_embedding.weight":
            p["position_embedding"] = v
        elif key.startswith("encoder.layers."):
            parts = key.split(".")
            base, rest = (f"layer_{parts[2]}",), parts[3:]
            if rest[0] == "self_attn":
                leaf = "kernel" if rest[2] == "weight" else "bias"
                _put(p, base + ("self_attn", rest[1]), leaf, v.T if leaf == "kernel" else v)
            elif rest[0] in ("layer_norm1", "layer_norm2"):
                _put(p, base + (rest[0],), "scale" if rest[1] == "weight" else "bias", v)
            elif rest[0] == "mlp":
                leaf = "kernel" if rest[2] == "weight" else "bias"
                _put(p, base + (rest[1],), leaf, v.T if leaf == "kernel" else v)
        elif key == "final_layer_norm.weight":
            _put(p, ("final_layer_norm",), "scale", v)
        elif key == "final_layer_norm.bias":
            _put(p, ("final_layer_norm",), "bias", v)
    return p
