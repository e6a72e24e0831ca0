"""Function rewards (port of ``repro.rl.reward``; the paper's PPO setup uses
a function reward in place of a reward model) + the synthetic math task used
by the examples and benchmarks. The prompts and the host-side reward are
copies; :func:`math_reward_tokens` is the tensor version.

Task: prompts are byte-tokenized "<a>+<b>=" strings; a correct completion is
the decimal digits of a+b followed by EOS. Reward 1.0 on exact match, partial
credit for digit prefix matches (keeps early training signal dense).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.data.tokenizer import ByteTokenizer


def make_math_prompts(
    rng: np.random.Generator, n: int, tok: ByteTokenizer, *, max_operand: int = 99
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (prompt_tokens (n, Lp), answers (n,)) with fixed prompt length."""
    a = rng.integers(0, max_operand + 1, size=n)
    b = rng.integers(0, max_operand + 1, size=n)
    prompts = [f"{x:02d}+{y:02d}=" for x, y in zip(a, b)]
    ids = np.stack([tok.encode(p) for p in prompts])
    return ids.astype(np.int32), (a + b).astype(np.int32)


def math_reward(
    response_text: List[str], answers: np.ndarray
) -> np.ndarray:
    """Host-side function reward: exact answer -> 1.0; prefix digits -> 0.1/digit."""
    out = np.zeros(len(response_text), np.float32)
    for i, (text, ans) in enumerate(zip(response_text, answers)):
        want = str(int(ans))
        got = ""
        for ch in text:
            if ch.isdigit():
                got += ch
            else:
                break
        if got == want:
            out[i] = 1.0
        else:
            match = 0
            for c1, c2 in zip(got, want):
                if c1 == c2:
                    match += 1
                else:
                    break
            out[i] = 0.1 * match
    return out


def math_reward_tokens(
    tokens: torch.Tensor,  # (B, L) full sequences
    mask: torch.Tensor,  # (B, L) response mask
    answers: torch.Tensor,  # (B,)
    tok: ByteTokenizer,
) -> torch.Tensor:
    """Tensor reward on the device (the REWARD stage's scorer): compares the
    first response digits against the decimal answer; 1.0 on an exact
    answer followed by EOS, else 0.1 per leading digit that matches."""
    B, L = tokens.shape
    digits0 = int(tok.encode("0")[0])
    answers = answers.long()
    # answer digits (up to 3): hundreds, tens, ones, without leading zeros
    h = answers // 100
    t = (answers // 10) % 10
    o = answers % 10
    n_digits = torch.where(answers >= 100, 3, torch.where(answers >= 10, 2, 1))
    d0 = torch.where(n_digits == 3, h, torch.where(n_digits == 2, t, o))
    d1 = torch.where(n_digits == 3, t, o)
    d2 = o
    # first response position of each row (the first maximum, as jnp.argmax)
    first = torch.argmax(mask.to(torch.int32), dim=1)
    idx = torch.arange(B, device=tokens.device)

    def tok_at(off):
        return tokens[idx, torch.clamp(first + off, 0, L - 1)].long()

    true = torch.ones(B, dtype=torch.bool, device=tokens.device)
    ok0 = tok_at(0) == d0 + digits0
    ok1 = torch.where(n_digits >= 2, tok_at(1) == d1 + digits0, true)
    ok2 = torch.where(n_digits >= 3, tok_at(2) == d2 + digits0, true)
    # the token after the digits must be EOS
    eos_ok = tok_at(n_digits) == tok.eos_id
    exact = ok0 & ok1 & ok2 & eos_ok
    partial = 0.1 * (
        ok0.float()
        + (ok0 & ok1 & (n_digits >= 2)).float()
        + (ok0 & ok1 & ok2 & (n_digits >= 3)).float()
    )
    return torch.where(exact, 1.0, partial)
