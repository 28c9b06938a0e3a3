"""Tokenizer frontends (host-side, numpy only).

The reference uses ``transformers.T5Tokenizer`` with
``max_length=100, padding='max_length', truncation=True``
(src/inference.py:38-50).  Without network access:

  * ``HFTokenizerFrontend`` loads a local ``tokenizer.json`` (HF fast
    format) with the ``tokenizers`` library, imported only when used;
  * ``HashTokenizer`` is a deterministic, dependency-free fallback used by
    tests and demos (stable hash of whitespace tokens, T5 conventions:
    pad=0, eos=1 appended).  It gives the same ids as the JAX package's.

Both return ``(input_ids, attention_mask)`` numpy int32/bool arrays of
shape (B, max_length).
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import List, Sequence, Tuple

import numpy as np


class HashTokenizer:
    """Deterministic test/demo tokenizer following T5 id conventions."""

    pad_id = 0
    eos_id = 1

    def __init__(self, vocab_size: int = 32128):
        self.vocab_size = vocab_size

    def __call__(self, texts: Sequence[str], max_length: int = 100
                 ) -> Tuple[np.ndarray, np.ndarray]:
        B = len(texts)
        ids = np.full((B, max_length), self.pad_id, np.int32)
        mask = np.zeros((B, max_length), bool)
        for b, text in enumerate(texts):
            toks: List[int] = []
            for w in text.lower().split():
                h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
                toks.append(2 + h % (self.vocab_size - 2))
            toks = toks[: max_length - 1] + [self.eos_id]
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = True
        return ids, mask


class HFTokenizerFrontend:
    """Wrap a local HF-fast ``tokenizer.json`` (e.g. from a flan-t5 checkout)."""

    def __init__(self, tokenizer_json_path: str):
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(tokenizer_json_path)

    def __call__(self, texts: Sequence[str], max_length: int = 100
                 ) -> Tuple[np.ndarray, np.ndarray]:
        self.tok.enable_truncation(max_length)
        self.tok.enable_padding(length=max_length, pad_id=0, pad_token="<pad>")
        encs = self.tok.encode_batch(list(texts))
        ids = np.asarray([e.ids for e in encs], np.int32)
        mask = np.asarray([e.attention_mask for e in encs], bool)
        return ids, mask


def get_tokenizer(model_name_or_path: str | None = None, vocab_size: int = 32128):
    """A local tokenizer.json path (file or directory) if there is one,
    else the hash fallback (with a warning when a path was given)."""
    if model_name_or_path:
        path = model_name_or_path
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        if os.path.isfile(path):
            return HFTokenizerFrontend(path)
        warnings.warn(
            f"tokenizer not found at {model_name_or_path!r}; falling back "
            "to the hash demo tokenizer — text conditioning will be "
            "meaningless with real checkpoints", stacklevel=2)
    return HashTokenizer(vocab_size=vocab_size)
