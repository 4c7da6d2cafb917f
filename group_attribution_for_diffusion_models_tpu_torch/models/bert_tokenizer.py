"""Pure-Python BERT WordPiece tokenizer for the LDM text-to-image path.

The port's own copy of the JAX package's ``models/bert_tokenizer.py`` (which
imports no JAX; the port imports nothing of that package), token ids bit
for bit (tests/test_torch_ldm_bert.py). CompVis/ldm-text2im-large-256's
``pipeline.tokenizer`` is an uncased ``BertTokenizer`` (the reference
tokenizes imagenette captions with it via LabelTokenizer, reference
src/diffusion_utils.py:74-108,223-226). This re-creates its two passes
from a ``vocab.txt``:

1. Basic tokenization: text cleanup (control-char strip, whitespace
   normalize), CJK-character spacing, lowercasing + accent stripping
   (NFD, drop Mn), punctuation splitting.
2. WordPiece: greedy longest-match-first over the vocab with "##"
   continuation pieces; words that cannot be covered become [UNK].

Encoding wraps with [CLS]/[SEP], pads with [PAD] to ``max_length`` and
truncates like ``padding="max_length", truncation=True``, the call the
LDM pipeline makes.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Sequence

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicodedata does not
    # (e.g. "$", "`").
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        out.append(" " if ch in ("\t", "\n", "\r") or unicodedata.category(ch) == "Zs" else ch)
    return "".join(out)


def _basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    text = _clean(text)
    text = "".join(
        f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text
    )
    tokens: List[str] = []
    for tok in text.split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(
                ch for ch in unicodedata.normalize("NFD", tok)
                if unicodedata.category(ch) != "Mn"
            )
        # split punctuation into standalone tokens
        cur: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class BertWordPieceTokenizer:
    """Uncased BERT tokenizer over a vocab.txt (one piece per line)."""

    def __init__(self, vocab: Dict[str, int], max_length: int = 77,
                 lowercase: bool = True):
        self.vocab = vocab
        self.max_length = max_length
        self.lowercase = lowercase
        for special in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
            if special not in vocab:
                raise ValueError(f"vocab is missing {special}")
        self.pad_id = vocab["[PAD]"]
        self.unk_id = vocab["[UNK]"]
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]

    @classmethod
    def from_file(cls, vocab_path: str, max_length: int = 77):
        vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, max_length=max_length)

    @classmethod
    def from_dir(cls, path: str, max_length: int = 77):
        return cls.from_file(os.path.join(path, "vocab.txt"), max_length)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk_id]
        pieces: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _basic_tokenize(text, self.lowercase):
            ids.extend(self._wordpiece(word))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """(B, max_length) int32 ids: [CLS] pieces [SEP] [PAD]*, truncated."""
        out = np.full((len(texts), self.max_length), self.pad_id, np.int32)
        for row, text in enumerate(texts):
            ids = self.tokenize_ids(text)[: self.max_length - 2]
            seq = [self.cls_id] + ids + [self.sep_id]
            out[row, : len(seq)] = seq
        return out
