"""The PyTorch port's int8 KV cache against the JAX package on the CPU.

``quant_kv``/``dequant_kv`` are compared bit for bit. The plain version of
the fused-dequant decode kernel (``ops.decode_attention_quant`` on CPU
tensors) is held against the JAX Pallas ``decode_attention_quant`` in
interpret mode at the tolerances of ``tests/test_kernels.py`` (o 2e-2, lse
1e-2). The model runs reduced gemma-2b with ``kv_quant=True`` on JAX weights
bridged into the port, in fp32, with the JAX package on its reference kernel
path (its CPU default).

The prefill (which attends K/V that were never quantized) and
``prefill_chunk`` (which attends a dequantized cache asserted bit-equal to
JAX's) are held at the fp32 2e-5. The teacher-forced decode steps are held
at 2e-2 (the bf16 tolerance): a decoded K value that differs from JAX's by
an fp32 ulp (the products sum in another order) moves the row's max-abs
scale by an ulp, which can move a dequantized bf16 value by one bf16 step,
or move a value across a rounding boundary of the int8 grid. The caches are
asserted to differ from JAX's by at most one int8 step, and the test counts
the entries that do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.decode_attention import decode_attention as da_pallas
from repro.kernels.decode_attention import decode_attention_quant as daq_pallas
from repro.models import get_model as jax_get_model
from repro.models import lm as jlm
from repro.rl.rollout import generate as jax_generate
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import get_model, lm
from repro_torch.rl.rollout import generate

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

jax.config.update("jax_default_matmul_precision", "highest")

SMOKE = dict(vocab_size=260, num_layers=2, pad_heads_to=8, kv_quant=True)
TOL = dict(atol=2e-5, rtol=2e-5)  # fp32 logits on unquantized or bit-equal K/V
LOGITS_TOL = dict(atol=2e-2, rtol=2e-2)  # logits after int8 decode steps


def quantized_cache(rng, B, S, KVH, D):
    """A bf16-valued K/V pair quantized by both packages' ``quant_kv``:
    (JAX (kq, vq, ks, vs), port (kq, vq, ks, vs)); both are bit-equal (the
    first test holds that)."""
    kk, vv = (np.asarray(jnp.asarray(rng.standard_normal((B, S, KVH, D)), jnp.bfloat16),
                         np.float32) for _ in range(2))
    jk, jks = jlm.quant_kv(jnp.asarray(kk, jnp.bfloat16))
    jv, jvs = jlm.quant_kv(jnp.asarray(vv, jnp.bfloat16))
    tk, tks = lm.quant_kv(torch.from_numpy(kk).to(torch.bfloat16))
    tv, tvs = lm.quant_kv(torch.from_numpy(vv).to(torch.bfloat16))
    return (jk, jv, jks, jvs), (tk, tv, tks, tvs)


def test_quant_kv_and_dequant_kv_are_bit_equal_to_jax():
    """fp32 max-abs over hd, scale max(m, 1e-8) / 127, round half to even,
    clip: including all-zero rows (scale 1e-8 / 127) and values that land
    exactly on .5 of a step (a row of max 127 holds k + 0.5 for k = -3..2)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3
    x[0, 1] = 0.0  # zero rows
    ties = np.arange(-3, 3, dtype=np.float32) + 0.5
    x[1, 2, 0, :] = 0.0
    x[1, 2, 0, 0] = 127.0
    x[1, 2, 0, 1:1 + len(ties)] = ties
    x[2, 0, 1, :8] = np.array([-127, -126.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127], np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x, dtype)
        xt = torch.from_numpy(np.array(xj, np.float32)).to(
            torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        qj, sj = jlm.quant_kv(xj)
        qt, st = lm.quant_kv(xt)
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                      np.asarray(sj).view(np.uint32))
        dj = jlm.dequant_kv(qj, sj)
        dt = lm.dequant_kv(qt, st)
        assert dt.dtype == torch.bfloat16
        np.testing.assert_array_equal(dt.view(torch.int16).numpy(), np.asarray(dj).view(np.int16))
    q, _ = lm.quant_kv(torch.from_numpy(x))
    assert q[1, 2, 0, 1:1 + len(ties)].tolist() == [-2, -2, 0, 0, 2, 2]  # half to even
    assert float(lm.quant_kv(torch.from_numpy(x))[1][0, 1, 0]) == np.float32(1e-8) / 127


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("S,H,KVH,D,block", [
    (128, 4, 2, 32, 64),   # GQA, per-slot varied fills
    (256, 4, 4, 32, 64),   # MHA
    (512, 8, 2, 64, 128),  # larger cache
    (256, 16, 1, 32, 64),  # MQA
])
def test_decode_attention_quant_plain_matches_pallas(S, H, KVH, D, block, window):
    """The cases of ``tests/test_kernels.py::test_decode_attention_quant``:
    per-row cache_len of S/3, S and 1."""
    rng = np.random.default_rng(5)
    B = 3
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = quantized_cache(rng, B, S, KVH, D)
    lens = np.array([S // 3, S, 1], np.int32)
    o, lse = ops.decode_attention_quant(torch.from_numpy(q), tk, tv, tks, tvs,
                                        torch.from_numpy(lens), window=window)
    o_p, lse_p = daq_pallas(jnp.asarray(q), jk, jv, jks, jvs, jnp.asarray(lens),
                            window=window, block_s=block, interpret=True)
    assert o.shape == (B, H, D) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_p, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_p), atol=1e-2, rtol=1e-2)


def test_decode_attention_quant_matches_unfused():
    """The fused path agrees with dequantizing the whole cache and running
    the plain decode kernel (``tests/test_kernels.py:408-430``): the port's
    plain version is exactly that, and it agrees with the JAX Pallas decode
    kernel on the dequantized cache."""
    rng = np.random.default_rng(6)
    B, S, H, KVH, D = 2, 256, 4, 2, 32
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = quantized_cache(rng, B, S, KVH, D)
    lens = np.array([77, 200], np.int32)
    o, lse = ops.decode_attention_quant(q, tk, tv, tks, tvs, torch.from_numpy(lens))
    o_u, lse_u = ref.decode_attention(q, lm.dequant_kv(tk, tks), lm.dequant_kv(tv, tvs),
                                      torch.from_numpy(lens))
    assert torch.equal(o, o_u) and torch.equal(lse, lse_u)
    o_p, lse_p = da_pallas(jnp.asarray(q.numpy()), jlm.dequant_kv(jk, jks),
                           jlm.dequant_kv(jv, jvs), jnp.asarray(lens), block_s=64,
                           interpret=True)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_p, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_p), atol=1e-2, rtol=1e-2)


# --------------------------------------------------------------------------- #
# reduced gemma-2b with the int8 cache
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pair():
    """(JAX config, port config, fp32 JAX params, the port's fp32 params
    bridged from the same weights)."""
    jcfg = jax_reduced(jax_get_config("gemma-2b"), **SMOKE)
    cfg = reduced(get_config("gemma-2b"), **SMOKE)
    jp = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    jpf = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                       if jnp.issubdtype(a.dtype, jnp.floating) else jnp.asarray(a), jp)
    return jcfg, cfg, jpf, bridge.from_jax(jp, device="cpu", dtype=torch.float32)


def int8_cache_diff(caches_t, caches_j):
    """The number of int8 K/V entries that differ from JAX's; asserts none
    differs by more than one step and the scales agree at the logits'
    tolerance (a decoded row's scale follows K/V that went through bf16)."""
    differ = 0
    for i, c in enumerate(caches_t):
        for name in ("k", "v"):
            a = c[name].numpy().astype(np.int32)
            b = np.asarray(caches_j[0][name][i]).astype(np.int32)
            assert c[name].dtype == torch.int8 and int(np.abs(a - b).max()) <= 1
            differ += int((a != b).sum())
            np.testing.assert_allclose(c[f"{name}_scale"].numpy(),
                                       np.asarray(caches_j[0][f"{name}_scale"][i]),
                                       **LOGITS_TOL)
    return differ


def test_init_caches_hold_int8_and_scales(pair):
    jcfg, cfg, _, _ = pair
    want = jlm.init_caches(jcfg, 2, 8)[0]
    for c in lm.init_caches(cfg, 2, 8, device="cpu"):
        assert sorted(c) == sorted(want) == ["k", "k_scale", "v", "v_scale"]
        for name, leaf in c.items():
            assert tuple(leaf.shape) == tuple(want[name].shape[1:])
            assert str(leaf.dtype).split(".")[-1] == str(want[name].dtype)


def test_prefill_and_teacher_forced_decode_match_jax(pair):
    jcfg, cfg, jpf, tp = pair
    model = get_model(cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompt = rng.integers(3, 259, (3, 7)).astype(np.int32)
    forced = rng.integers(3, 259, (3, 4)).astype(np.int32)
    logits_j, caches_j, len_j = jlm.prefill(jcfg, jpf, jnp.asarray(prompt), smax=12)
    with torch.inference_mode():
        logits_t, caches_t, len_t = model.prefill(tp, torch.from_numpy(prompt), smax=12)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    differ = [int8_cache_diff(caches_t, caches_j)]
    # the zero-padded rows past the prompt are quantized too
    assert float(caches_t[0]["k_scale"][0, -1, 0]) == np.float32(1e-8) / 127
    for j in range(forced.shape[1]):
        logits_j, caches_j, len_j = jlm.decode_step(jcfg, jpf, jnp.asarray(forced[:, j]),
                                                    caches_j, len_j)
        with torch.inference_mode():
            logits_t, caches_t, len_t = model.decode_step(
                tp, torch.from_numpy(forced[:, j]), caches_t, len_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **LOGITS_TOL)
        differ.append(int8_cache_diff(caches_t, caches_j))
    total = caches_t[0]["k"].numel() * 2 * len(caches_t)
    assert differ[0] == 0, differ  # the prefill's caches are bit-equal
    assert differ[-1] <= total // 100, (differ, total)


def test_prefill_chunk_matches_jax(pair):
    """Two chunks of 8 into zero int8 caches: each chunk's rows are
    quantized in place and the chunk attends its prefix dequantized."""
    jcfg, cfg, jpf, tp = pair
    model = get_model(cfg, device="cpu")
    prompt = np.random.default_rng(3).integers(3, 259, (3, 16)).astype(np.int32)
    caches_j = jlm.init_caches(jcfg, 3, 24)
    caches_t = model.init_caches(3, 24)
    for off in (0, 8):
        chunk = prompt[:, off:off + 8]
        logits_j, caches_j = jlm.prefill_chunk(jcfg, jpf, jnp.asarray(chunk), caches_j,
                                               offset=off)
        with torch.inference_mode():
            logits_t, caches_t = model.prefill_chunk(tp, torch.from_numpy(chunk), caches_t,
                                                     offset=off)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
        assert int8_cache_diff(caches_t, caches_j) == 0
    assert caches_t[0]["k"].dtype == torch.int8 and not caches_t[0]["k"][:, 16:].any()


def test_greedy_generate_matches_jax(pair):
    jcfg, cfg, jpf, tp = pair
    prompt = np.random.default_rng(4).integers(3, 259, (4, 6)).astype(np.int32)
    want = jax_generate(jax_get_model(jcfg), jpf, jnp.asarray(prompt), jax.random.PRNGKey(0),
                        max_new=6, temperature=0.0)
    got = generate(get_model(cfg, device="cpu"), tp, torch.from_numpy(prompt),
                   torch.Generator().manual_seed(0), max_new=6, temperature=0.0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(want.response_mask))
    np.testing.assert_allclose(got.old_logprob.numpy(), np.asarray(want.old_logprob),
                               atol=2e-2, rtol=2e-2)


def test_kv_quant_is_refused_by_the_streaming_engine(pair):
    from repro_torch.configs import ServingConfig
    from repro_torch.serving import ServingEngine

    _, cfg, _, tp = pair
    with pytest.raises(ValueError, match="int8 caches"):
        ServingEngine(get_model(cfg, device="cpu"), ServingConfig(num_slots=2, max_len=32, max_new=8),
                      params=tp)
