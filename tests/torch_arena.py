"""Shared by the tests that hold the port's continuous rollout engine against
the JAX package's: an fp32 cache arena for either package's model.

Both engines' cache arenas are bf16 (``init_caches``). On fp32 weights the
JAX engine cannot run on one at all (its decode writes turn the
``while_loop`` carry's caches fp32), and the port's would hold lockstep's
fp32 prefill caches rounded, so the fp32 comparisons give both engines an
fp32 arena. ``Recorded`` keeps an engine's rollouts of every call.
"""
import jax
import jax.numpy as jnp
import torch

from repro_torch import tree


class Fp32Arena:
    """``model`` (of either package) with its ``init_caches`` leaves cast
    from bf16 to fp32 by ``cast``; everything else is the model's."""

    def __init__(self, model, cast):
        self._model, self._cast = model, cast

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init_caches(self, batch, smax):
        return self._cast(self._model.init_caches(batch, smax))


def jax_fp32_arena(model):
    """A JAX package model whose cache arena is fp32."""
    return Fp32Arena(model, lambda c: jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, c))


def fp32_arena(model):
    """A port model whose cache arena is fp32."""
    return Fp32Arena(model, lambda c: tree.map(
        lambda t: t.float() if t.dtype == torch.bfloat16 else t, c))


class Recorded:
    """A generate engine of either package that keeps each call's tokens
    (``np_of`` of them) in ``seen``; every other attribute (``last_stats``,
    ``model``) is the engine's."""

    def __init__(self, engine, np_of):
        self.engine, self.np_of, self.seen = engine, np_of, []

    def __call__(self, params, prompts, key):
        res = self.engine(params, prompts, key)
        self.seen.append(self.np_of(res.tokens))
        return res

    def __getattr__(self, name):
        return getattr(self.engine, name)
