"""Toy byte tokenizer: vocab = 256 raw bytes + BOS/EOS/PAD specials."""
from __future__ import annotations

from typing import List

import numpy as np


class ByteTokenizer:
    PAD, BOS, EOS = 0, 1, 2
    SPECIALS = 3

    def __init__(self):
        self.vocab_size = 256 + self.SPECIALS
        self.pad_id, self.bos_id, self.eos_id = self.PAD, self.BOS, self.EOS

    def encode(self, text: str, *, bos: bool = False, eos: bool = False) -> np.ndarray:
        ids = [b + self.SPECIALS for b in text.encode("utf-8")]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        out = bytearray()
        for i in np.asarray(ids).tolist():
            if i == self.EOS:
                break
            # skip non-byte ids: specials other than EOS, and ids a model
            # with vocab_size > 259 may sample from its padded tail
            if self.SPECIALS <= i < 256 + self.SPECIALS:
                out.append(i - self.SPECIALS)
        return out.decode("utf-8", errors="replace")

    def decode_batch(self, ids) -> List[str]:
        return [self.decode(row) for row in np.asarray(ids)]
