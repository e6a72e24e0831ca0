"""Every architecture of ``configs/registry.py`` through the port in reduced
form, as ``tests/test_arch_smoke.py`` runs the JAX package.

Each arch is built by ``get_model(reduced(cfg), device="cpu")`` (2-4
layers, d_model 64) on JAX's own bf16 weights, bridged: its loss is held to
JAX's at the bf16 tolerance (2e-2 of the loss), one AdamW step of
``trainer.make_lm_train_step`` moves the weights with a finite, nonzero
gradient, and one decode step after a prefill gives the logits of a
prefill one token longer (within 0.1, as the JAX smoke test holds JAX).
The batches carry each family's inputs: an enc-dec's frames, a VLM's prefix
embeddings (its labels ignored over the prefix).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro_torch import bridge, tree
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import get_model
from repro_torch.rl import trainer

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

B, S = 2, 16


def make_batch(cfg, seed):
    """tokens, labels [, frames | prefix_embeds] as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([tok[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    batch = {"tokens": tok, "labels": labels}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((B, cfg.encoder_len, cfg.d_model)).astype(
            np.float32)
    elif cfg.num_prefix_embeds > 1:
        P = cfg.num_prefix_embeds
        batch["prefix_embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
        batch["labels"] = np.concatenate([np.full((B, P), -1, np.int32), labels], axis=1)
    return batch


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    """(name, port model, port bf16 params on JAX's weights, JAX model, JAX
    params)."""
    name = request.param
    jmodel = jax_get_model(jax_reduced(JAX_ARCHS[name]))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = get_model(reduced(ARCHS[name]), device="cpu")
    params = bridge.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return name, model, params, jmodel, jparams


def test_every_arch_builds_through_get_model():
    """All 11 archs, none refused, each at its family's layout."""
    assert len(ARCHS) == 11
    for name, cfg in ARCHS.items():
        r = reduced(cfg)
        params = get_model(r, device="cpu").init(torch.Generator().manual_seed(0))
        stacks = (params["encoder"] + params["decoder"] if r.is_encoder_decoder
                  else params["blocks"])
        assert len(stacks) == r.num_encoder_layers + r.num_layers, name


def test_loss_matches_jax(arch):
    name, model, params, jmodel, jparams = arch
    batch = make_batch(model.cfg, 0)
    lj, _ = jax.jit(jmodel.loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lt, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(lt)) and float(lt) > 0, name
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-2, err_msg=name)


def test_train_step_updates_params(arch):
    name, model, params, _, _ = arch
    batch = {k: torch.from_numpy(v) for k, v in make_batch(model.cfg, 1).items()}
    start = tree.map(torch.clone, params)
    state, metrics = trainer.make_lm_train_step(model)(trainer.init_state(params), batch)
    gnorm = float(metrics["grad_norm"])
    assert np.isfinite(gnorm) and gnorm > 0, name
    moved = [not torch.equal(a, b) for a, b in zip(tree.leaves(start),
                                                    tree.leaves(state.params))]
    assert any(moved), name
    with torch.no_grad():
        loss2, _ = model.loss(state.params, batch)
    assert np.isfinite(float(loss2)), name


def test_prefill_decode_consistency(arch):
    """One decode step's logits against a prefill of the prompt plus the
    decoded token."""
    name, model, _, _, _ = arch
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(2))
    batch = make_batch(cfg, 2)
    tok = torch.from_numpy(batch["tokens"][:, :12])
    kw = {k: torch.from_numpy(batch[k]).to(torch.bfloat16)
          for k in ("frames", "prefix_embeds") if k in batch}
    with torch.inference_mode():
        logits, caches, clen = model.prefill(params, tok, smax=64, **kw)
        assert logits.shape == (B, cfg.padded_vocab)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        lg, _, _ = model.decode_step(params, nxt, caches, clen)
        want, _, _ = model.prefill(params, torch.cat([tok, nxt[:, None]], 1), smax=64, **kw)
    live = want > -1e29
    assert not bool(torch.isnan(lg).any()), name
    err = float((lg - want)[live].abs().max())
    assert err < 0.1, f"{name}: decode/prefill mismatch {err}"
