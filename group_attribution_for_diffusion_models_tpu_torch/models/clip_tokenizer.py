"""Pure-Python CLIP byte-pair-encoding tokenizer.

The port's own copy of the JAX package's ``models/clip_tokenizer.py`` (which
imports no JAX; the port imports nothing of that package). The reference
tokenizes every prompt with HF's CLIPTokenizer before SD LoRA training and
generation (reference text_to_image/train_text_to_image_lora.py:719-744).
This is a dependency-free reimplementation of that algorithm, byte-level
BPE over a vocab.json + merges.txt pair, so the text-to-image path produces
real CLIP token ids without transformers at runtime.

Normalization follows HF's ftfy-free path (BasicTokenizer with
do_lower_case=True, strip_accents=False, do_split_on_punc=False): control
chars dropped, whitespace collapsed, CJK split, NFC-normalized, lowercased.
The vocab/merges files are the user's to supply; `models.clip_text.
load_tokenizer` picks this implementation up whenever a directory with
vocab.json + merges.txt is given.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:  # transformers ships `regex`; fall back to `re` (ASCII-only classes)
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    import re as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[a-z]+|[0-9]|[^\sa-z0-9]+""",
        _re.IGNORECASE,
    )


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map (BPE runs on these)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _basic_clean(text: str) -> str:
    """HF BasicTokenizer(do_split_on_punc=False, strip_accents=False) +
    whitespace rejoin — the normalization CLIPTokenizer applies when ftfy is
    absent."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if ch.isspace() else ch)
    text = "".join(out)
    text = "".join(
        f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text
    )
    text = unicodedata.normalize("NFC", text)
    return " ".join(tok.lower() for tok in text.split())


class CLIPBPETokenizer:
    """Callable tokenizer: texts -> (B, max_length) int32 ids, CLIP-padded
    (BOS ... EOS, then EOS-pad, truncation keeps the final EOS)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        max_length: int = 77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos_id = self.encoder.get("<|startoftext|>", len(self.encoder) - 2)
        self.eos_id = self.encoder.get("<|endoftext|>", len(self.encoder) - 1)
        self.unk_id = self.eos_id  # CLIP's unk_token == eos_token
        self._cache: Dict[str, str] = {}

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, max_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines if line.strip()]
        return cls(vocab, merges, max_length=max_length)

    @classmethod
    def from_dir(cls, vocab_dir: str, max_length: int = 77):
        return cls.from_files(
            os.path.join(vocab_dir, "vocab.json"),
            os.path.join(vocab_dir, "merges.txt"),
            max_length=max_length,
        )

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids without BOS/EOS/padding."""
        ids: List[int] = []
        for token in _PAT.findall(_basic_clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for piece in self.bpe(mapped).split(" "):
                ids.append(self.encoder.get(piece, self.unk_id))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos_id, np.int32)
        for row, text in enumerate(texts):
            ids = [self.bos_id] + self.encode(text)[: self.max_length - 2]
            ids.append(self.eos_id)
            out[row, : len(ids)] = ids
        return out
