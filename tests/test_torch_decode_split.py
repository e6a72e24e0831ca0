"""The arithmetic of the port's split-KV paged decode, held against the JAX
package on the CPU.

``csrc/paged_decode_attention.cu`` cuts each row's keys into splits of whole
pages, attends each split on its own and merges the splits' (o, lse) by
their log-sum-exp. No GPU exists here, so these tests check that
decomposition with the plain versions: the port's ``combine_decode_shards``
against the JAX one, and a paged decode taken split by split
(``ref.decode_attention`` over a slice of the gathered cache, ``cache_len``
clamped to the slice) and merged by the port's combine against the JAX
Pallas ``paged_decode_attention`` in interpret mode, at the boundary
lengths: one key, a length on a split boundary and one past it, a full
table, and splits with no live key. Inputs are made with numpy from a seed.

Tolerances: ``tests/test_kernels.py``'s fp32 2e-5 and bf16 2e-2 for o, 1e-3
for lse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import paged_decode_attention as pda_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_decode_attention import split_pages

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

jax.config.update("jax_default_matmul_precision", "highest")

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 2e-5, "bf16": 2e-2}
LSE_TOL = 1e-3
PS, T = 8, 4  # page size and table width of the paged cases: 32 positions


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def assert_close(port, jax_out, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("empty", [False, True])
def test_combine_matches_jax(dtype, empty):
    """The port's combine against the JAX one; with ``empty``, one shard has
    no live key (lse far below the others, o zero), as a split past kv_len."""
    rng = np.random.default_rng(0)
    o_parts = rng.standard_normal((5, 3, 4, 16))
    lse_parts = rng.standard_normal((5, 3, 4)) * 4
    if empty:
        o_parts[2] = 0.0
        lse_parts[2] = -1e30
    oj, ot = both(o_parts, dtype)
    want = jops.combine_decode_shards(oj, jnp.asarray(lse_parts, jnp.float32))
    got = ops.combine_decode_shards(ot, torch.from_numpy(lse_parts.astype(np.float32)))
    assert got.dtype == ot.dtype and got.shape == ot.shape[1:]
    assert_close(got, want, TOL[dtype])


def test_combine_lse_is_the_lse_of_the_union():
    """The merged lse equals the lse of all the shards' logits together."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((3, 2, 5, 12)))  # (P, B, H, keys)
    o_parts = torch.from_numpy(rng.standard_normal((3, 2, 5, 16)))
    _, lse = ref.combine_decode_shards(o_parts, torch.logsumexp(logits, -1), return_lse=True)
    want = torch.logsumexp(logits.permute(1, 2, 0, 3).reshape(2, 5, -1), -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def paged_inputs(rng, kv_len, *, KVH=1, H=4, D=16, P=23):
    """A shuffled pool, the given lengths, and table entries past each live
    span that name pages of other rows (stale entries)."""
    B = len(kv_len)
    q = rng.standard_normal((B, H, D))
    pool_k = rng.standard_normal((P, PS, KVH, D))
    pool_v = rng.standard_normal((P, PS, KVH, D))
    tables = rng.permutation(P)[: B * T].reshape(B, T).astype(np.int32)
    kv_len = np.asarray(kv_len, np.int32)
    for b in range(B):
        live = -(-int(kv_len[b]) // PS)
        tables[b, live:] = rng.integers(0, P, T - live)
    return q, pool_k, pool_v, tables, kv_len


def split_decode(q, pool_k, pool_v, tables, kv_len, sp):
    """Paged decode split by split, as the kernel cuts it: each split of
    ``sp`` pages is a plain decode over its slice of the gathered cache with
    ``cache_len`` clamped to the slice, merged by the port's combine."""
    B = tables.shape[0]
    idx = tables.long().reshape(-1)
    kg = pool_k[idx].reshape((B, T * PS) + tuple(pool_k.shape[2:]))
    vg = pool_v[idx].reshape((B, T * PS) + tuple(pool_v.shape[2:]))
    sk = sp * PS
    o_parts, lse_parts = [], []
    for lo in range(0, T * PS, sk):
        hi = min(lo + sk, T * PS)
        n = torch.clamp(kv_len - lo, 0, hi - lo).to(torch.int32)
        o, lse = ref.decode_attention(q, kg[:, lo:hi], vg[:, lo:hi], n)
        o_parts.append(o)
        lse_parts.append(lse)
    return ref.combine_decode_shards(torch.stack(o_parts), torch.stack(lse_parts),
                                     return_lse=True)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("sp", [1, 2, 3])
@pytest.mark.parametrize("kvh", [1, 2])
def test_split_decode_matches_pallas(dtype, sp, kvh):
    """Rows of one key, a length on a split boundary, one past it, and a full
    table (with sp=3 the last split is ragged); every row but the full one
    has splits with no live key."""
    sk = sp * PS
    q, pk, pv, tables, kv_len = paged_inputs(np.random.default_rng(sp + 10 * kvh),
                                             [1, sk, sk + 1, T * PS], KVH=kvh)
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(pk, dtype), both(pv, dtype)
    o, lse = split_decode(qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(kv_len), sp)
    o_want, lse_want = pda_pallas(qj, kj, vj, jnp.asarray(tables), jnp.asarray(kv_len),
                                  interpret=True)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    assert_close(o, o_want, TOL[dtype])
    assert_close(lse, lse_want, LSE_TOL)


def test_split_decode_equals_one_pass_plain_version():
    """In fp32 the split decomposition is the one-pass plain version up to
    rounding, for every split size the table allows."""
    rng = np.random.default_rng(5)
    q, pk, pv, tables, kv_len = paged_inputs(rng, [1, 7, 8, 9, 16, 17, 31, 32], P=41)
    args = [torch.from_numpy(np.asarray(x, np.float32)) for x in (q, pk, pv)]
    args += [torch.from_numpy(tables), torch.from_numpy(kv_len)]
    o1, lse1 = ref.paged_decode_attention(*args)
    for sp in range(1, T + 1):
        o, lse = split_decode(*args, sp)
        np.testing.assert_allclose(o.numpy(), o1.numpy(), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(lse.numpy(), lse1.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape, want", [
    # the streaming serving slice: 8 slots, 16 heads on one KV head, 16 pages
    # of 16: one page a split, 16 splits, 128 blocks
    ((8, 16, 1, 16, 16), 1),
    # pages of 8: two pages, so a split is one 16-key step of the mma
    ((8, 16, 1, 32, 8), 2),
    # one row: the table is cut as finely as the 16-key minimum allows
    ((1, 16, 1, 16, 16), 1),
    # many rows: one split a row
    ((64, 32, 2, 16, 16), 16),
    # a table shorter than the minimum split
    ((2, 8, 2, 1, 4), 1),
])
def test_split_pages_rule(shape, want):
    """The split is a function of the shapes alone, a whole number of pages
    of at least 16 keys where the table holds that many, never more than
    the table."""
    B, H, KVH, T_, ps = shape
    sp = split_pages(B, H, KVH, T_, ps)
    assert sp == want
    assert 1 <= sp <= T_
    assert sp * ps >= min(16, T_ * ps)
