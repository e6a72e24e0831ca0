"""Built-in environments over the synthetic math task + the ``math`` reward:
a copy of ``repro.rl.envs.builtin`` whose ``math`` reward takes the port's
``rl.reward`` (the host function and the tensor ``math_reward_tokens``).

All three parse their task from the prompt itself (``"<aa>+<bb>="`` byte
tokens), so no answer side-channel flows through the engine — an env owns
its task end to end, exactly the contract a real tool-use environment needs.

* :class:`FunctionRewardEnv` (``function_reward``) — single turn: the
  response is the answer, scored by the registered :class:`RewardSpec`.
  Wraps the plain REWARD stage's path; generation is untouched, so a run with this
  env is token-identical to one without (test-asserted).
* :class:`CalculatorToolEnv` (``calculator``) — multi-turn tool use: a turn
  beginning ``CALL`` invokes the calculator (the env evaluates the called
  expression — or the prompt's own on a malformed call — and appends the
  result digits + ``=`` as observation tokens); a turn beginning with a
  digit is the final answer, scored and terminal; anything else is treated
  as a malformed tool exchange — the env re-asks by appending the original
  expression and the episode burns a turn.
* :class:`MultiTurnDialogEnv` (``dialog``) — fixed ``max_turns`` rounds of
  the same question with per-turn partial rewards: every turn's response is
  scored (earlier turns at half credit), and the env re-asks between turns.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.rl import reward as reward_mod
from repro_torch.rl.envs.base import (
    EnvSpec,
    RewardSpec,
    get_reward,
    register_env,
    register_reward,
)

_EXPR = re.compile(r"(\d+)\s*([+\-*])\s*(\d+)")


def _parse_expr(text: str):
    """First `<int><op><int>` expression in ``text``, or None."""
    m = _EXPR.search(text)
    if not m:
        return None
    a, op, b = int(m.group(1)), m.group(2), int(m.group(3))
    return a + b if op == "+" else a - b if op == "-" else a * b


class _MathEnvBase:
    """Shared prompt parsing / scoring for the math-task envs."""

    def __init__(self, tok: ByteTokenizer, cfg):
        self.tok = tok
        self.cfg = cfg
        self.answer = 0
        self.prompt_text = ""

    def reset(self, prompt: np.ndarray) -> np.ndarray:
        self.prompt_text = self.tok.decode(prompt)
        ans = _parse_expr(self.prompt_text)
        self.answer = 0 if ans is None else int(ans)
        return np.asarray(prompt, np.int32)

    def _score(self, response: np.ndarray) -> float:
        text = self.tok.decode(response)
        host = get_reward(self.cfg.reward).host_fn
        return float(host([text], np.asarray([self.answer]))[0])

    def _reask(self) -> np.ndarray:
        """Observation that re-poses the question (`;` separates turns)."""
        expr = self.prompt_text if self.prompt_text.endswith("=") else (
            self.prompt_text + "=")
        return self.tok.encode(";" + expr)


class FunctionRewardEnv(_MathEnvBase):
    """Single-turn function reward (the REWARD stage's path as an Environment)."""

    def step(
        self, response: np.ndarray
    ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        return np.zeros(0, np.int32), self._score(response), True, {}


class CalculatorToolEnv(_MathEnvBase):
    """Multi-turn tool use: CALL -> tool result observation; leading digit ->
    final answer; junk -> re-ask. The engine truncates at ``max_turns``, so
    an episode that never answers is scored by its last turn (0 unless it
    answered)."""

    def __init__(self, tok: ByteTokenizer, cfg):
        super().__init__(tok, cfg)
        self.turn = 0
        self.tool_calls = 0

    def step(
        self, response: np.ndarray
    ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        self.turn += 1
        text = self.tok.decode(response)
        if text and text[0].isdigit():
            # final answer turn
            return np.zeros(0, np.int32), self._score(response), True, {
                "answered": True, "tool_calls": self.tool_calls}
        if text.startswith("CALL"):
            result = _parse_expr(text[4:])
            if result is None:  # malformed call: evaluate the prompt's expr
                result = self.answer
            self.tool_calls += 1
            obs = self.tok.encode(f"{int(result)}=")
            return obs, 0.0, False, {"tool_call": True}
        # junk: the env re-asks; the episode burns the turn
        return self._reask(), 0.0, False, {"malformed": True}


class MultiTurnDialogEnv(_MathEnvBase):
    """Fixed-round dialog with per-turn partial rewards: every turn's
    response is scored against the answer — earlier turns at half credit,
    the final turn at full — and the env re-asks between turns. Always runs
    ``cfg.max_turns`` turns (the deterministic multi-turn workload for the
    engine's continuation path)."""

    def __init__(self, tok: ByteTokenizer, cfg):
        super().__init__(tok, cfg)
        self.turn = 0

    def step(
        self, response: np.ndarray
    ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        self.turn += 1
        last = self.turn >= self.cfg.max_turns
        reward = self._score(response) * (1.0 if last else 0.5)
        obs = np.zeros(0, np.int32) if last else self._reask()
        return obs, reward, last, {"turn": self.turn}


# --------------------------------------------------------------------------- #
# registrations
# --------------------------------------------------------------------------- #
MATH_REWARD = register_reward(RewardSpec(
    name="math",
    host_fn=reward_mod.math_reward,
    token_fn=reward_mod.math_reward_tokens,
    description="Exact-match digits -> 1.0; digit-prefix partial credit "
                "0.1/digit (the paper's function reward).",
))

FUNCTION_REWARD = register_env(EnvSpec(
    name="function_reward",
    factory=FunctionRewardEnv,
    multi_turn=False,
    description="Single-turn function reward over the synthetic math task "
                "(token-identical generation to the env-off path).",
))

CALCULATOR = register_env(EnvSpec(
    name="calculator",
    factory=CalculatorToolEnv,
    multi_turn=True,
    description="Multi-turn tool use: CALL <expr> invokes the calculator, a "
                "digit-leading turn is the scored final answer.",
))

DIALOG = register_env(EnvSpec(
    name="dialog",
    factory=MultiTurnDialogEnv,
    multi_turn=True,
    description="Fixed-round dialog: per-turn partial rewards, env re-asks "
                "between turns.",
))
