"""The PyTorch port's kernel functions against the JAX package on the CPU.

The port's plain versions (``repro_torch.kernels.ref``, which the CUDA
kernels are held against on the card by ``chip_smoke.py``) are compared with
the JAX Pallas kernels run in interpret mode, on the same inputs made with
numpy from a seed. Tolerances are those of ``tests/test_kernels.py``: fp32
2e-5, bf16 2e-2, decode lse 1e-3. The sampler's hash and its tokens are
compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as da_pallas
from repro.kernels.flash_attention import flash_attention as fa_pallas
from repro.kernels.rmsnorm import rmsnorm as rn_pallas
from repro.kernels.sampling import _hash_u32, _uniform_01
from repro.kernels.sampling import fused_sample as fs_pallas
from repro_torch.kernels import _build, ops, ref

jax.config.update("jax_default_matmul_precision", "highest")

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 2e-5, "bf16": 2e-2}


def both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def assert_close(port, jax_out, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rmsnorm_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((37, 64)), dtype)
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    out = ops.rmsnorm(xt, torch.from_numpy(w))
    assert out.dtype == xt.dtype
    assert_close(out, rn_pallas(xj, jnp.asarray(w), interpret=True), TOL[dtype])


FLASH_CASES = {
    "causal_mha": dict(H=4, KVH=4, Sq=32, Sk=32),
    "noncausal": dict(H=4, KVH=4, Sq=32, Sk=32, causal=False),
    "window": dict(H=4, KVH=2, Sq=32, Sk=32, window=8),
    "q_offset": dict(H=4, KVH=2, Sq=16, Sk=32, q_offset=16),
    "gqa_mqa": dict(H=4, KVH=1, Sq=32, Sk=32),
    "ragged_sq": dict(H=4, KVH=1, Sq=6, Sk=6),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_pallas(case, dtype):
    c = dict(FLASH_CASES[case])
    H, KVH, Sq, Sk = c.pop("H"), c.pop("KVH"), c.pop("Sq"), c.pop("Sk")
    rng = np.random.default_rng(1)
    qj, qt = both(rng.standard_normal((2, Sq, H, 16)), dtype)
    kj, kt = both(rng.standard_normal((2, Sk, KVH, 16)), dtype)
    vj, vt = both(rng.standard_normal((2, Sk, KVH, 16)), dtype)
    out = ops.flash_attention(qt, kt, vt, **c)
    want = fa_pallas(qj, kj, vj, block_q=min(16, Sq), block_k=min(16, Sk),
                     interpret=True, **c)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    assert_close(out, want, TOL[dtype])


DECODE_CASES = {
    "ragged": dict(lens=[24, 1, 9, 17]),
    "window": dict(lens=[24, 5, 13, 20], window=6),
    "pos_offset": dict(lens=[40, 17, 29, 33], pos_offset=16),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_matches_pallas(case, dtype):
    c = dict(DECODE_CASES[case])
    lens = np.asarray(c.pop("lens"), np.int32)
    rng = np.random.default_rng(2)
    qj, qt = both(rng.standard_normal((4, 4, 16)), dtype)
    kj, kt = both(rng.standard_normal((4, 24, 1, 16)), dtype)
    vj, vt = both(rng.standard_normal((4, 24, 1, 16)), dtype)
    o, lse = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens), **c)
    o_want, lse_want = da_pallas(qj, kj, vj, jnp.asarray(lens), block_s=8,
                                 interpret=True, **c)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    assert_close(o, o_want, TOL[dtype])
    assert_close(lse, lse_want, 1e-3)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "mixed"])
def test_fused_sample_matches_pallas(mode):
    """Same seeds and inverse temperatures: tokens bit-equal, logprobs 2e-5;
    the padded vocab (300 of 384) is never drawn."""
    rng = np.random.default_rng(3)
    B, d, Vp, vocab = 6, 32, 384, 300
    h = rng.standard_normal((B, d)).astype(np.float32)
    w = rng.standard_normal((d, Vp)).astype(np.float32)
    seeds = rng.integers(-2**31, 2**31, B, dtype=np.int64).astype(np.int32)
    inv_t = {"greedy": np.zeros(B), "sampled": np.full(B, 1 / 0.7),
             "mixed": np.array([0, 1, 0, 2.5, 1 / 0.7, 0])}[mode].astype(np.float32)
    tok, lp = ops.fused_sample(torch.from_numpy(h), torch.from_numpy(w),
                               torch.from_numpy(seeds), torch.from_numpy(inv_t),
                               vocab_size=vocab)
    tok_want, lp_want = fs_pallas(jnp.asarray(h), jnp.asarray(w), jnp.asarray(seeds),
                                  jnp.asarray(inv_t), vocab_size=vocab, block_v=128,
                                  interpret=True)
    assert tok.dtype == torch.int32 and bool((tok < vocab).all())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_want))
    assert_close(lp, lp_want, 2e-5)


def test_hash_and_uniform_bit_equal():
    rng = np.random.default_rng(4)
    x = np.concatenate([np.arange(4096), rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        [2**32 - 1, 2**31, 2**31 - 1]]).astype(np.uint32)
    got = ref.hash_u32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_hash_u32(jnp.asarray(x)), np.int64))

    seeds = rng.integers(-2**31, 2**31, 8, dtype=np.int64).astype(np.int32)
    pos = np.arange(0, 300_000, 37, dtype=np.int32)
    u = ref.uniform_01(torch.from_numpy(seeds)[:, None], torch.from_numpy(pos)[None, :])
    u_want = _uniform_01(jnp.asarray(seeds).astype(jnp.uint32)[:, None], jnp.asarray(pos)[None, :])
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  np.asarray(u_want, np.float32).view(np.uint32))
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    """On a CPU tensor each wrapper is its plain version and launches
    nothing; ``set_mode`` takes only None or "ref"."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    w = torch.zeros(8)
    before = dict(_build.LAUNCHES)
    assert torch.equal(ops.rmsnorm(x, w), ref.rmsnorm(x, w))
    ops.set_mode("ref")
    try:
        assert ops.current_mode() == "ref"
        assert torch.equal(ops.rmsnorm(x, w), ref.rmsnorm(x, w))
    finally:
        ops.set_mode(None)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.set_mode("triton")


def test_kernel_library_hash_follows_the_source(tmp_path, monkeypatch):
    """A source edit changes the library's name (so it is rebuilt); building
    is never triggered by importing or by hashing."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    (src / "rmsnorm.cu").write_text((src / "rmsnorm.cu").read_text() + "\n// edit\n")
    after = {n: _build.library_path(n) for n in _build.KERNELS}
    assert before["rmsnorm"] != after["rmsnorm"]
    assert all(before[n] == after[n] for n in _build.KERNELS if n != "rmsnorm")
    (src / "common.cuh").write_text((src / "common.cuh").read_text() + "\n// edit\n")
    assert all(_build.library_path(n) != after[n] for n in _build.KERNELS)
