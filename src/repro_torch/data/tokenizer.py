"""Byte-level tokenizer stub (vocab-mapped) for the runnable examples.

Real deployments plug a sentencepiece model in here; the interface is the
only contract the pipeline depends on.
"""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """Bytes + specials, folded into an arbitrary model vocab size."""

    BOS = 256
    EOS = 257
    PAD = 258

    def __init__(self, vocab_size: int):
        if vocab_size < 259:
            raise ValueError(
                f"need room for bytes + specials: vocab_size >= 259, got "
                f"{vocab_size}")
        self.vocab_size = vocab_size

    def encode(self, text: str, *, bos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in ids if int(i) < 256)
        return bs.decode("utf-8", errors="replace")
