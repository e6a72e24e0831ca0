"""Datasets (the port's copy of ``repro.data.dataset``). Index-addressable
and deterministic: sample i is a pure function of (seed, i), so any worker
can materialize exactly its own rows — the property the Distributed
Dataloader (paper §6.1) relies on."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


class SyntheticMathDataset:
    """Fixed-length '<aa>+<bb>=' prompts with integer answers (the function-
    reward task standing in for DeepScaleR in the paper's experiments)."""

    PROMPT_LEN = 6  # "aa+bb="

    def __init__(self, size: int, *, seed: int = 0, max_operand: int = 99):
        self.size = size
        self.seed = seed
        self.max_operand = max_operand
        self.tok = ByteTokenizer()

    def __len__(self) -> int:
        return self.size

    def get_rows(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize ONLY the requested rows: (prompts (n, Lp), answers (n,))."""
        idx = np.asarray(idx, np.int64)
        rng_a = ((self.seed * 1_000_003 + idx) * 2654435761) % (self.max_operand + 1)
        rng_b = ((self.seed * 998_244_353 + idx) * 40503) % (self.max_operand + 1)
        prompts = np.zeros((len(idx), self.PROMPT_LEN), np.int32)
        for row, (a, b) in enumerate(zip(rng_a, rng_b)):
            prompts[row] = self.tok.encode(f"{a:02d}+{b:02d}=")
        return prompts, (rng_a + rng_b).astype(np.int32)


class SyntheticTextDataset:
    """Deterministic token streams for supervised / throughput workloads."""

    def __init__(self, size: int, seq_len: int, vocab: int, *, seed: int = 0):
        self.size, self.seq_len, self.vocab, self.seed = size, seq_len, vocab, seed

    def __len__(self):
        return self.size

    def get_rows(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        out = np.zeros((len(idx), self.seq_len), np.int32)
        for row, i in enumerate(idx):
            rng = np.random.default_rng(self.seed * 7_777_777 + int(i))
            out[row] = rng.integers(3, self.vocab, size=self.seq_len)
        return out
