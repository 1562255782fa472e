"""CLIP BPE tokenizer, a copy of ``mixdq_tpu/utils/tokenizer.py`` (plain
Python: the port imports nothing of the JAX package). Self-contained;
loads HF ``vocab.json``/``merges.txt`` when available (CLIP's byte-level
BPE, implemented directly), else falls back to ``HashTokenizer``, which
needs no vocabulary file. ``HashTokenizer`` hashes words with Python's
``hash``: its ids are stable within one process only (``PYTHONHASHSEED``).
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte->unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False else
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class CLIPTokenizer:
    """CLIP byte-level BPE. ``vocab_path``/``merges_path`` point at the HF
    tokenizer files; ``model_max_length`` 77 with BOS/EOS and EOS padding
    (CLIP pads with the EOS token)."""

    def __init__(self, vocab_path: str, merges_path: str,
                 model_max_length: int = 77):
        with open(vocab_path) as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_path) as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.model_max_length = model_max_length
        self.cache: Dict[str, str] = {}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize to a [B, 77] int32 array with BOS/EOS + EOS padding."""
        L = self.model_max_length
        out = np.full((len(texts), L), self.eos_token_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_token_id] + self.encode(t)[: L - 2] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic fallback for offline tests: hashes words into a small
    vocab. NOT a real tokenizer — only for shape/flow testing."""

    def __init__(self, vocab_size: int = 1000, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        L = self.model_max_length
        out = np.full((len(texts), L), self.eos_token_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_token_id] + [
                (hash(w) % (self.vocab_size - 2)) for w in t.split()[: L - 2]
            ] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(path: Optional[str] = None, vocab_size: int = 49408):
    """Load the real CLIP tokenizer from a directory containing
    vocab.json + merges.txt, else fall back to HashTokenizer."""
    if path is not None:
        v = os.path.join(path, "vocab.json")
        m = os.path.join(path, "merges.txt")
        if os.path.exists(v) and os.path.exists(m):
            return CLIPTokenizer(v, m)
    return HashTokenizer(vocab_size=min(vocab_size, 49408))
