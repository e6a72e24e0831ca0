"""The arithmetic of the port's split-KV contiguous decode kernels, held
against the JAX package on the CPU.

``csrc/decode_attention.cu`` and ``csrc/decode_attention_quant.cu`` cut the
S slots of a cache into splits of ``split_keys`` slots, attend each split's
live keys on their own and merge the splits' (o, lse) by their log-sum-exp.
No GPU exists here, so these tests check that decomposition with the plain
versions: split ``[lo, hi)`` is ``ref.decode_attention`` (or
``ref.decode_attention_quant``) over ``k[:, lo:hi]`` with ``pos_offset + lo``,
exactly a sequence shard, and the splits are merged by
``ref.combine_decode_shards``. That is held against the JAX Pallas
``decode_attention`` and ``decode_attention_quant`` in interpret mode: one
key, a length on a split boundary and one past it, a full cache, a window
across split boundaries and one on them, ``pos_offset`` with a row that has
no live key, KVH 1 and 2, groups of 4, 16 and 32 heads. Inputs are made with
numpy from a seed.

Tolerances: ``tests/test_kernels.py``'s fp32 2e-5 and bf16 2e-2 for o, 1e-3
for lse. The int8 cases hold o at bf16's 2e-2 whatever q's type: the port
dequantizes the cache to bf16 (its kernel's values) where the Pallas int8
kernel keeps fp32. That rounding moves a logit by up to a few 1e-3, so
against the Pallas int8 kernel lse is held at 1e-2, the tolerance
``tests/test_torch_kv_quant.py`` holds the one-pass plain version to; the
split arithmetic is held at lse 1e-3 against the Pallas ``decode_attention``
on the cache dequantized by JAX's ``dequant_kv`` (bit-equal to the port's).

A row with no live key: the Pallas kernel gives o = 0 and lse = NEG_INF +
log(1e-20) = -1e30 in fp32, the CUDA kernels too; the plain version, as the
JAX reference, clamps the max at NEG_INF / 2 and gives -5e29. Both are
asserted as they are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as da_pallas
from repro.kernels.decode_attention import decode_attention_quant as daq_pallas
from repro.models import lm as jlm
from repro_torch.kernels import ref
from repro_torch.kernels.split_rule import MIN_SPLIT_KEYS, split_keys
from repro_torch.models import lm

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

jax.config.update("jax_default_matmul_precision", "highest")

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 2e-5, "bf16": 2e-2}
LSE_TOL = 1e-3
QUANT_LSE_TOL = 1e-2  # against the Pallas int8 kernel's fp32 dequantization
D = 16
NEG_INF = np.float32(ref.NEG_INF)

CASES = {  # H, KVH, S, split keys, cache_len (4 rows), keywords
    "group4": (4, 1, 64, 16, [1, 16, 17, 64], {}),
    "group4_kvh2": (8, 2, 64, 16, [1, 16, 17, 64], {}),
    "group16": (16, 1, 48, 16, [1, 16, 17, 48], {}),
    "group32_split32": (32, 1, 96, 32, [1, 32, 33, 96], {}),
    "group16_kvh2_split32": (32, 2, 64, 32, [64, 32, 33, 1], {}),
    # row 2 attends [20, 40): both ends inside a split
    "window_across": (4, 1, 64, 16, [1, 16, 40, 64], {"window": 20}),
    # row 0 attends [16, 48): both ends on split boundaries
    "window_on_boundary": (8, 2, 64, 16, [48, 16, 33, 64], {"window": 32}),
    # row 0 (cache_len 8 <= pos_offset) has no live key
    "pos_offset": (8, 2, 64, 16, [8, 24, 25, 72], {"pos_offset": 8}),
    "pos_offset_window": (4, 1, 64, 16, [5, 30, 41, 72], {"pos_offset": 8, "window": 20}),
}


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def split_decode(attend, S: int, sk: int, pos_offset: int):
    """Each split [lo, hi) of S slots through ``attend(lo, hi, offset)``, a
    plain decode over the slice with ``pos_offset = offset``, merged by the
    port's combine; returns (o, lse)."""
    parts = [attend(lo, min(lo + sk, S), pos_offset + lo) for lo in range(0, S, sk)]
    return ref.combine_decode_shards(torch.stack([o for o, _ in parts]),
                                     torch.stack([lse for _, lse in parts]), return_lse=True)


def inputs(case: str, dtype: str, quant: bool):
    """(port args, JAX args, cache_len, S, split keys, keywords) of a case:
    q (B, H, D) and a cache (B, S, KVH, D), bf16 K/V or int8 K/V with their
    scales, quantized by both packages' ``quant_kv`` (bit-equal)."""
    H, KVH, S, sk, lens, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 10 * quant)
    B = len(lens)
    qj, qt = both(rng.standard_normal((B, H, D)), dtype)
    kk, vv = (rng.standard_normal((B, S, KVH, D)) for _ in range(2))
    if quant:
        kb, vb = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (kk, vv))
        jk, jks = jlm.quant_kv(jnp.asarray(kb, jnp.bfloat16))
        jv, jvs = jlm.quant_kv(jnp.asarray(vb, jnp.bfloat16))
        tk, tks = lm.quant_kv(torch.from_numpy(kb).to(torch.bfloat16))
        tv, tvs = lm.quant_kv(torch.from_numpy(vb).to(torch.bfloat16))
        port, jargs = (qt, tk, tv, tks, tvs), (qj, jk, jv, jks, jvs)
    else:
        (kj, kt), (vj, vt) = both(kk, dtype), both(vv, dtype)
        port, jargs = (qt, kt, vt), (qj, kj, vj)
    return port, jargs, np.asarray(lens, np.int32), S, sk, kw


def split_of(port, S, sk, n, kw):
    """The port's split decomposition of one case (bf16 or int8 cache)."""
    window, off = kw.get("window"), kw.get("pos_offset", 0)
    if len(port) == 3:
        q, k, v = port
        attend = lambda lo, hi, o: ref.decode_attention(  # noqa: E731
            q, k[:, lo:hi], v[:, lo:hi], n, window=window, pos_offset=o)
    else:
        q, k, v, ks, vs = port
        attend = lambda lo, hi, o: ref.decode_attention_quant(  # noqa: E731
            q, k[:, lo:hi], v[:, lo:hi], ks[:, lo:hi], vs[:, lo:hi], n, window=window,
            pos_offset=o)
    return split_decode(attend, S, sk, off)


def check(got, want, lens, kw, tol, lse_tol):
    """(o, lse) of the split decomposition against a Pallas kernel's: live
    rows within tol and lse_tol; a row with no live key o = 0 in both, the
    Pallas lse NEG_INF + log(1e-20) = -1e30 and the plain NEG_INF / 2."""
    o, lse = got[0].float().numpy(), got[1].numpy()
    o_want, lse_want = np.asarray(want[0], np.float32), np.asarray(want[1])
    live = lens > kw.get("pos_offset", 0)
    np.testing.assert_allclose(o[live], o_want[live], atol=tol, rtol=tol)
    np.testing.assert_allclose(lse[live], lse_want[live], atol=lse_tol, rtol=lse_tol)
    assert (o[~live] == 0).all() and (o_want[~live] == 0).all()
    assert (lse_want[~live] == NEG_INF).all()
    assert (lse[~live] == NEG_INF / 2).all()
    assert (lse[~live] <= NEG_INF / 2).all() and (lse_want[~live] <= NEG_INF / 2).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_decode_matches_pallas(case, quant, dtype):
    port, jargs, lens, S, sk, kw = inputs(case, dtype, quant)
    got = split_of(port, S, sk, torch.from_numpy(lens), kw)
    assert got[0].dtype == port[0].dtype and got[1].dtype == torch.float32
    jlens = jnp.asarray(lens)
    if not quant:
        check(got, da_pallas(*jargs, jlens, block_s=16, interpret=True, **kw), lens, kw,
              TOL[dtype], LSE_TOL)
        return
    check(got, daq_pallas(*jargs, jlens, block_s=16, interpret=True, **kw), lens, kw,
          TOL["bf16"], QUANT_LSE_TOL)
    q, k, v, ks, vs = jargs
    check(got, da_pallas(q, jlm.dequant_kv(k, ks), jlm.dequant_kv(v, vs), jlens, block_s=16,
                         interpret=True, **kw), lens, kw, TOL["bf16"], LSE_TOL)


@pytest.mark.parametrize("kw", [{}, {"window": 20}, {"pos_offset": 8}, {"pos_offset": 8,
                                                                        "window": 7}])
def test_split_decode_equals_one_pass_plain_version(kw):
    """In fp32 the split decomposition is the one-pass plain version up to
    rounding, for splits of 16, 32 and 48 slots (the last split ragged)."""
    rng = np.random.default_rng(7)
    B, H, KVH, S = 8, 4, 2, 80
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    lens = torch.tensor([1, 9, 16, 17, 33, 47, 80, 88], dtype=torch.int32)
    o1, lse1 = ref.decode_attention(q, k, v, lens, **kw)
    for sk in (16, 32, 48):
        o, lse = split_of((q, k, v), S, sk, lens, kw)
        live = (lens > kw.get("pos_offset", 0)).numpy()
        np.testing.assert_allclose(o.numpy(), o1.numpy(), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(lse.numpy()[live], lse1.numpy()[live], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape, want", [
    # the lockstep serving step: B=8, 16 heads on one KV head, 160 slots:
    # 10 splits of 16 keys, 80 blocks
    ((8, 16, 1, 160), 16),
    # 32 heads on one KV head: two 16-head tiles a row, 5 splits of 32
    ((8, 32, 1, 160), 32),
    # GQA 8 on 2 KV heads: 16 groups, splits of 32
    ((8, 8, 2, 160), 32),
    # one row: cut as finely as the 16-key minimum allows
    ((1, 16, 1, 160), 16),
    # many rows: two splits a row, of five pages each
    ((64, 16, 1, 160), 80),
    # a cache shorter than one split: one split of 16 keys
    ((4, 16, 1, 10), 16),
])
def test_split_keys_rule(shape, want):
    """The contiguous split is ``split_pages`` on pages of 16 keys: a
    function of the shapes alone, a multiple of 16 keys."""
    B, H, KVH, S = shape
    sk = split_keys(B, H, KVH, S)
    assert sk == want and sk % MIN_SPLIT_KEYS == 0
    if shape == (8, 16, 1, 160):
        assert -(-S // sk) == 10
