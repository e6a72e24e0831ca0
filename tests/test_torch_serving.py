"""The PyTorch port's streaming serving slice on the CPU.

Against the JAX package: the plain paged decode attention against the JAX
Pallas kernel in interpret mode, chunked prefill and the paged decode step
against ``repro.models.lm``, and the greedy ``ServingEngine`` against the
JAX ``ServingEngine`` (its reference kernel path on the CPU), token for
token with equal counters, on bridged fp32 weights. Then twins of
``tests/test_serving.py`` on the port's own engine, the pool's sink page,
and the ``serve`` entry point's streaming default.

Tolerances: fp32 2e-5, bf16 2e-2, decode lse 1e-3 (``tests/test_kernels.py``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServingConfig as JaxServingConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.decode_attention import paged_decode_attention as pda_pallas
from repro.models import get_model as jax_get_model
from repro.models import lm as jlm
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import synthetic_requests as jax_synthetic_requests
from repro_torch import bridge
from repro_torch.configs import ServingConfig, get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import get_model, lm
from repro_torch.serving import (
    AdmissionQueue,
    ArenaOutOfPages,
    PagedKVArena,
    Request,
    RequestStream,
    ServingEngine,
    request_seed,
    synthetic_requests,
)

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

jax.config.update("jax_default_matmul_precision", "highest")

SMOKE = dict(vocab_size=260, num_layers=2, pad_heads_to=8)
TOL = {"fp32": 2e-5, "bf16": 2e-2}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
PS = 8  # page size of the engine tests, as in tests/test_serving.py


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def assert_close(port, jax_out, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, fp32 JAX params, port model on the CPU, the same params
    bridged in fp32): reduced gemma-2b, 2 layers, vocab 260, 4 heads padded
    to 8, one KV head."""
    jmodel = jax_get_model(jax_reduced(jax_get_config("gemma-2b"), **SMOKE))
    params = jmodel.init(jax.random.PRNGKey(3))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if jnp.issubdtype(a.dtype, jnp.floating) else a, params)
    tp = bridge.from_jax(jax.tree.map(np.asarray, params), device="cpu",
                         dtype=torch.float32)
    model = get_model(reduced(get_config("gemma-2b"), **SMOKE), device="cpu")
    return jmodel, jp, model, tp


# --------------------------------------------------------------------------- #
# (a) the plain paged decode attention against the Pallas kernel
# --------------------------------------------------------------------------- #
def paged_inputs(rng, *, B=4, H=4, KVH=1, D=16, ps=8, T=4, P=23):
    """A pool with shuffled page ids, ragged lengths, and table entries past
    each live span that name pages owned by other rows (stale entries)."""
    q = rng.standard_normal((B, H, D))
    pool_k = rng.standard_normal((P, ps, KVH, D))
    pool_v = rng.standard_normal((P, ps, KVH, D))
    tables = rng.permutation(P)[: B * T].reshape(B, T).astype(np.int32)
    kv_len = np.array([T * ps, 1, ps + 3, 2 * ps], np.int32)[:B]
    for b in range(B):
        live = -(-int(kv_len[b]) // ps)
        tables[b, live:] = rng.integers(0, P, T - live)
    return q, pool_k, pool_v, tables, kv_len


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kvh", [1, 2])
def test_paged_decode_attention_matches_pallas(dtype, kvh):
    q, pk, pv, tables, kv_len = paged_inputs(np.random.default_rng(0), KVH=kvh)
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(pk, dtype), both(pv, dtype)
    o, lse = ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                        torch.from_numpy(kv_len))
    o_want, lse_want = pda_pallas(qj, kj, vj, jnp.asarray(tables), jnp.asarray(kv_len),
                                  interpret=True)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    assert_close(o, o_want, TOL[dtype])
    assert_close(lse, lse_want, 1e-3)


def test_paged_decode_attention_ignores_stale_entries():
    """Rewriting every table entry past the live spans, and every page no
    live span names, changes nothing."""
    q, pk, pv, tables, kv_len = paged_inputs(np.random.default_rng(1))
    args = [torch.from_numpy(np.asarray(x, np.float32)) for x in (q, pk, pv)]
    o, lse = ops.paged_decode_attention(*args, torch.from_numpy(tables),
                                        torch.from_numpy(kv_len))
    live = set()
    t2 = tables.copy()
    for b in range(tables.shape[0]):
        n = -(-int(kv_len[b]) // 8)
        live.update(tables[b, :n].tolist())
        t2[b, n:] = 0
    dead = [p for p in range(pk.shape[0]) if p not in live]
    args[1][dead] = 1e3
    args[2][dead] = -1e3
    o2, lse2 = ops.paged_decode_attention(*args, torch.from_numpy(t2), torch.from_numpy(kv_len))
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


# --------------------------------------------------------------------------- #
# (b) chunked prefill and (c) the paged decode step against repro.models.lm
# --------------------------------------------------------------------------- #
def zero_caches(jcfg, batch, width, jdtype):
    """Zero caches of one dtype in both layouts: JAX's (N, B, W, KVH, hd)
    pattern stack and the port's per-layer list."""
    shape = (batch, width, jcfg.num_kv_heads, jcfg.head_dim)
    n = jcfg.num_layers
    jc = [{"k": jnp.zeros((n,) + shape, jdtype), "v": jnp.zeros((n,) + shape, jdtype)}]
    td = torch.float32 if jdtype == jnp.float32 else torch.bfloat16
    tc = [{"k": torch.zeros(shape, dtype=td), "v": torch.zeros(shape, dtype=td)}
          for _ in range(n)]
    return jc, tc


def assert_caches_close(tc, jc, tol, upto=None):
    for i, layer in enumerate(tc):
        for name in ("k", "v"):
            got = layer[name][:upto] if upto is not None else layer[name]
            assert_close(got, np.asarray(jc[0][name][i], np.float32)[:got.shape[0]], tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prefill_chunk_matches_jax(pair, dtype):
    """Three consecutive page chunks into fp32 caches (the algorithm, 2e-5)
    and into bf16 caches (the engine's layout, 2e-2)."""
    jmodel, jp, model, tp = pair
    jcfg = jmodel.cfg
    tokens = np.random.default_rng(2).integers(3, 259, (3, 3 * PS)).astype(np.int32)
    jc, tc = zero_caches(jcfg, 3, 4 * PS, DTYPES[dtype][0])
    for off in range(0, 3 * PS, PS):
        lj, jc = jlm.prefill_chunk(jcfg, jp, jnp.asarray(tokens[:, off:off + PS]), jc,
                                   offset=off)
        lt, tc = model.prefill_chunk(tp, torch.from_numpy(tokens[:, off:off + PS]), tc,
                                     offset=off)
        assert_close(lt, lj, TOL[dtype])
    assert float(lt[:, 260:].max()) < -1e29  # the padded vocab is masked
    assert_caches_close(tc, jc, TOL[dtype])


def paged_state(rng, B=4, P=12, T=3):
    tables = rng.permutation(P)[: B * T].reshape(B, T).astype(np.int32)
    cache_len = np.array([5, 0, 17, 23], np.int32)[:B]
    token = rng.integers(3, 259, B).astype(np.int32)
    return tables, cache_len, token


def test_decode_step_paged_matches_jax(pair):
    """Two fp32 paged decode steps from a random pool, one lane retired in
    the second: logits 2e-5, and the owned pages equal JAX's pool (the
    retired lane's write dropped there, sunk here)."""
    jmodel, jp, model, tp = pair
    jcfg = jmodel.cfg
    rng = np.random.default_rng(3)
    P = 12
    tables, cache_len, token = paged_state(rng, P=P)
    pool = rng.standard_normal((jcfg.num_layers, 2, P + 1, PS, 1, jcfg.head_dim)).astype(np.float32)
    jpool = [{"k": jnp.asarray(pool[:, 0, :P]), "v": jnp.asarray(pool[:, 1, :P])}]
    tpool = [{"k": torch.from_numpy(pool[i, 0].copy()), "v": torch.from_numpy(pool[i, 1].copy())}
             for i in range(jcfg.num_layers)]
    jlen, tlen = jnp.asarray(cache_len), torch.from_numpy(cache_len)
    for write in (None, np.array([True, False, True, True])):
        lj, jpool, jlen = jlm.decode_step_paged(
            jcfg, jp, jnp.asarray(token), jpool, jlen, jnp.asarray(tables),
            write_enable=None if write is None else jnp.asarray(write))
        lt, tpool, tlen = model.decode_step_paged(
            tp, torch.from_numpy(token), tpool, tlen, torch.from_numpy(tables),
            write_enable=None if write is None else torch.from_numpy(write))
        assert_close(lt, lj, 2e-5)
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        token = np.array(jnp.argmax(lj, axis=-1), np.int32)
    assert_caches_close(tpool, jpool, 2e-5, upto=P)


# --------------------------------------------------------------------------- #
# (f) the sink page
# --------------------------------------------------------------------------- #
def test_sink_page_takes_retired_lane_writes():
    """A retired lane's K/V write goes to the pool's last page; no page the
    arena hands out changes except the live lanes' current slots."""
    model = get_model(reduced(get_config("gemma-2b"), **SMOKE), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    arena = PagedKVArena(model, num_pages=12, page_size=PS)
    assert arena.sink_page == 12 and arena.pool[0]["k"].shape[0] == 13
    for layer in arena.pool:
        for leaf in layer.values():
            leaf.normal_(generator=torch.Generator().manual_seed(1))
    before = [{n: t.clone() for n, t in layer.items()} for layer in arena.pool]
    tables, cache_len, token = paged_state(np.random.default_rng(4))
    write = torch.tensor([True, False, True, False])
    model.decode_step_paged(params, torch.from_numpy(token), arena.pool,
                            torch.from_numpy(cache_len), torch.from_numpy(tables),
                            write_enable=write)
    written = {(int(tables[b, cache_len[b] // PS]), int(cache_len[b] % PS))
               for b in range(4) if write[b]}
    for layer, old in zip(arena.pool, before):
        for name, leaf in layer.items():
            changed = {(p, s) for p in range(13) for s in range(PS)
                       if not torch.equal(leaf[p, s], old[name][p, s])}
            assert changed - {(12, s) for s in range(PS)} == written
            assert any(p == 12 for p, _ in changed), "the retired lanes wrote the sink"


# --------------------------------------------------------------------------- #
# (d) the greedy engine against the JAX engine
# --------------------------------------------------------------------------- #
ENGINE_CASES = {
    "prefix_cache": dict(num_slots=4, max_len=64, max_new=12, page_size=PS, decode_burst=4),
    "parking": dict(num_slots=2, max_len=64, max_new=12, page_size=PS, decode_burst=2,
                    yield_quota=3),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_greedy_engine_matches_jax_engine(pair, case):
    jmodel, jp, model, tp = pair
    kw = ENGINE_CASES[case]
    make = dict(arrival_rate=20, page_size=PS, max_new=12, temperature=0.0, seed=5)
    jeng = JaxServingEngine(jmodel, JaxServingConfig(**kw), params=jp, eos_id=1)
    want = jeng.serve(jax_synthetic_requests(16, **make), realtime=False)
    eng = ServingEngine(model, ServingConfig(**kw), params=tp, eos_id=1)
    got = eng.serve(synthetic_requests(16, **make), realtime=False)
    assert [s.tokens for s in got] == [s.tokens for s in want]
    assert [s.finish_reason for s in got] == [s.finish_reason for s in want]
    assert [s.matched_prefix_tokens for s in got] == [s.matched_prefix_tokens for s in want]
    js, ts = jeng.stats(), eng.stats()
    for key in ("prefill_chunks", "decode_steps", "bursts", "parks", "resumes",
                "prefix_hit_tokens", "tokens", "pool_pages_used", "cached_pages"):
        assert ts[key] == js[key], key
    assert ts["requests_finished"] == 16 and (case != "parking" or ts["parks"] > 0)


# --------------------------------------------------------------------------- #
# the seed function
# --------------------------------------------------------------------------- #
def test_request_seed_is_a_pure_int32_function():
    pos = torch.arange(64, dtype=torch.int32)
    a = request_seed(0, 7, pos)
    assert a.dtype == torch.int32 and len(set(a.tolist())) == 64
    assert torch.equal(a, torch.stack([request_seed(0, 7, int(p)) for p in pos]))
    assert torch.equal(request_seed(0, torch.full((64,), 7), pos), a)
    assert not torch.equal(request_seed(1, 7, pos), a)
    assert not torch.equal(request_seed(0, 8, pos), a)
    # pinned values, so the streams cannot drift unnoticed
    assert int(request_seed(0, 0, 0)) == -1806715564
    assert int(request_seed(12345, 7, 3)) == 415386322


# --------------------------------------------------------------------------- #
# (e) twins of tests/test_serving.py on the port's engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny_model():
    cfg = reduced(get_config("gemma-2b"), vocab_size=260, num_layers=2)
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def _scfg(**kw):
    base = dict(num_slots=4, max_len=64, max_new=12, page_size=PS, decode_burst=4)
    base.update(kw)
    return ServingConfig(**base)


def _prompt(rng, n):
    return rng.integers(3, 200, n).astype(np.int32)


def test_serving_config_validation():
    assert _scfg().pool_pages == 3 * 4 * (64 // PS)
    with pytest.raises(ValueError):
        _scfg(max_len=60)  # not a page multiple
    with pytest.raises(ValueError):
        _scfg(max_new=64)  # no prompt room left
    with pytest.raises(ValueError):
        _scfg(num_slots=0)


def test_admission_queue_fifo_and_oldest_head():
    rng = np.random.default_rng(0)
    q = AdmissionQueue(bucket=PS, max_len=64)
    for rid, n in [(0, 5), (1, 6), (2, 12), (3, 7)]:
        q.push(Request(rid=rid, prompt=_prompt(rng, n), max_new=4))
    kind, lb, items = q.pop_work(2)
    assert kind == "fresh" and lb == PS
    assert [r.rid for r in items] == [0, 1], "FIFO within the bucket"
    _, lb2, items2 = q.pop_work(4)
    assert lb2 == 2 * PS and [r.rid for r in items2] == [2]
    _, _, items3 = q.pop_work(4)
    assert [r.rid for r in items3] == [3]
    assert len(q) == 0
    with pytest.raises(IndexError):
        q.pop_work(1)


def test_paged_arena_alloc_free_and_roundtrip(tiny_model):
    cfg, model, params = tiny_model
    arena = PagedKVArena(model, num_pages=6, page_size=PS)
    a = arena.alloc(4)
    assert arena.num_free == 2 and arena.num_used == 4
    with pytest.raises(ArenaOutOfPages):
        arena.alloc(3)
    arena.free(a[:2])
    assert arena.num_free == 4

    # KV roundtrip: prefill a slot row, save 2 pages out, wipe, load back
    caches = model.init_caches(2, 4 * PS)
    toks = torch.from_numpy(np.arange(2 * 2 * PS).reshape(2, 2 * PS) % 200 + 3)
    _, rows = model.prefill_chunk(params, toks, model.init_caches(2, 4 * PS), offset=0)
    caches = model.scatter_cache_rows(caches, rows, [0, 1])
    ids = arena.alloc(2)
    arena.save_rows(caches, 1, ids)
    loaded = arena.load_rows(model.init_caches(2, 4 * PS), [0], [ids])
    got = model.gather_cache_pages(loaded, [0], num_pages=2, page_size=PS)
    want = model.gather_cache_pages(caches, [1], num_pages=2, page_size=PS)
    for g, w in zip(got, want):
        for name in ("k", "v"):
            assert torch.equal(g[name], w[name])


def test_prefix_hit_bitwise_identical_to_cold(tiny_model):
    """A request admitted over a prefix-cache hit gives exactly the tokens
    it gives on a cold engine with the cache off: same seed, sampled."""
    cfg, model, params = tiny_model
    rng = np.random.default_rng(7)
    prefix = _prompt(rng, 3 * PS)
    prompt = np.concatenate([prefix, _prompt(rng, 5)])

    cold = ServingEngine(model, _scfg(prefix_cache=False), params=params, eos_id=2)
    s_cold = cold.serve([Request(rid=0, prompt=prompt, max_new=12, seed=42)],
                        realtime=False)[0]
    warm = ServingEngine(model, _scfg(), params=params, eos_id=2)
    sibling = np.concatenate([prefix, _prompt(rng, 7)])
    warm.serve([Request(rid=1, prompt=sibling, max_new=4, seed=9)], realtime=False)
    s_warm = warm.serve([Request(rid=0, prompt=prompt, max_new=12, seed=42)],
                        realtime=False)[0]

    assert s_warm.matched_prefix_tokens == 3 * PS, "hit expected"
    assert s_cold.matched_prefix_tokens == 0
    assert s_warm.tokens == s_cold.tokens, "prefix hit changed the output"
    warm.prefix_cache.check_invariants()


def test_full_prompt_match_still_computes_last_chunk(tiny_model):
    cfg, model, params = tiny_model
    rng = np.random.default_rng(3)
    prompt = _prompt(rng, 2 * PS)  # exactly 2 pages, no tail
    eng = ServingEngine(model, _scfg(), params=params, eos_id=2)
    a = eng.serve([Request(rid=0, prompt=prompt, max_new=4, seed=5)], realtime=False)[0]
    chunks_cold = eng.prefill_chunks
    b = eng.serve([Request(rid=1, prompt=prompt, max_new=4, seed=5)], realtime=False)[0]
    assert b.matched_prefix_tokens == PS, "match capped below full prompt"
    assert eng.prefill_chunks == chunks_cold + 1, "one chunk recomputed"
    assert a.tokens == b.tokens, "same seed, same prompt, same tokens"


def test_park_resume_and_placement_invariance(tiny_model):
    """yield_quota parks a long request under queue pressure; its resumed
    stream equals the uncontended run (sampled)."""
    cfg, model, params = tiny_model
    rng = np.random.default_rng(11)
    prompt = _prompt(rng, 10)
    solo = ServingEngine(model, _scfg(prefix_cache=False), params=params, eos_id=2)
    s_solo = solo.serve([Request(rid=0, prompt=prompt, max_new=12, seed=1)],
                        realtime=False)[0]
    cont = ServingEngine(model, _scfg(num_slots=2, decode_burst=2, yield_quota=3,
                                      prefix_cache=False), params=params, eos_id=2)
    reqs = [Request(rid=0, prompt=prompt, max_new=12, seed=1)] + [
        Request(rid=i, prompt=_prompt(rng, 9), max_new=12, seed=i) for i in range(1, 6)]
    s_cont = cont.serve(reqs, realtime=False)[0]
    assert cont.parks > 0, "contention must actually park something"
    assert cont.resumes == cont.parks
    assert s_cont.tokens == s_solo.tokens, "park/resume changed the output"
    assert cont.arena.num_used == 0, "parked pages must all recycle"


def test_resident_kv_outgrows_slot_arena(tiny_model):
    cfg, model, params = tiny_model
    scfg = _scfg(num_slots=1, max_len=32, max_new=4)
    assert scfg.pool_pages * PS > scfg.num_slots * scfg.max_len
    eng = ServingEngine(model, scfg, params=params, eos_id=2)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=_prompt(rng, 2 * PS + 3), max_new=2) for i in range(4)]
    eng.serve(reqs, realtime=False)
    slot_capacity_pages = (eng.scfg.num_slots * eng.scfg.max_len) // PS
    assert eng.arena.num_used > slot_capacity_pages, \
        "resident cached KV should exceed the whole slot arena"
    eng.prefix_cache.check_invariants()


def test_rejected_and_finish_reasons(tiny_model):
    cfg, model, params = tiny_model
    eng = ServingEngine(model, _scfg(), params=params, eos_id=2)
    rng = np.random.default_rng(9)
    too_long = eng.submit(Request(rid=0, prompt=_prompt(rng, 64), max_new=4))
    assert too_long.finished and too_long.finish_reason == "rejected"
    ok = eng.serve([Request(rid=1, prompt=_prompt(rng, 6), max_new=3)], realtime=False)[0]
    assert ok.finished and ok.finish_reason in ("eos", "budget")
    assert len(ok.tokens) <= 3
    assert ok.ttft is not None and ok.ttft >= 0


class StubStore:
    """The weight store's duck type: ``version`` and ``current.params``;
    ``publish`` refuses regressions, as ``WeightVersionStore`` does."""

    def __init__(self):
        self.version, self.current = 0, None

    def publish(self, params, version=None):
        version = self.version + 1 if version is None else version
        if self.current is not None and version <= self.version:
            raise ValueError(f"version {version} <= {self.version}")
        self.version, self.current = version, types.SimpleNamespace(params=params)


def test_hot_swap_mid_stream_keeps_streams_intact(tiny_model):
    cfg, model, params = tiny_model
    p1 = model.init(torch.Generator().manual_seed(1))
    store = StubStore()
    store.publish(params)
    eng = ServingEngine(model, _scfg(num_slots=2, max_new=24, decode_burst=2),
                        weight_store=store, eos_id=None)
    rng = np.random.default_rng(3)
    stream = eng.submit(Request(rid=0, prompt=_prompt(rng, 10), max_new=24))
    for _ in range(3):
        eng.step()
    before_swap = list(stream.tokens)
    assert 0 < len(before_swap) < 24, "swap must land mid-stream"
    store.publish(p1)
    while eng.step():
        pass
    assert stream.finished and len(stream.tokens) == 24
    assert stream.tokens[: len(before_swap)] == before_swap
    assert eng.weight_swaps == 1
    versions = stream.weight_versions
    assert versions == sorted(versions), "version tags must be monotone"
    assert len(set(versions)) == 2, "both versions must appear"
    with pytest.raises(ValueError):
        store.publish(params, version=0)


def test_hot_swap_clears_prefix_cache(tiny_model):
    cfg, model, params = tiny_model
    p1 = model.init(torch.Generator().manual_seed(1))
    store = StubStore()
    store.publish(params)
    eng = ServingEngine(model, _scfg(), weight_store=store, eos_id=2)
    rng = np.random.default_rng(8)
    prompt = _prompt(rng, 2 * PS + 4)
    eng.serve([Request(rid=0, prompt=prompt, max_new=2)], realtime=False)
    assert eng.prefix_cache.num_pages > 0
    store.publish(p1)
    s = eng.serve([Request(rid=1, prompt=prompt, max_new=2)], realtime=False)[0]
    assert s.matched_prefix_tokens == 0, "stale-version page served"
    assert eng.prefix_cache.num_pages > 0, "recommitted under new version"


def test_request_stream_metrics():
    r = Request(rid=0, prompt=np.array([5, 6, 7]), max_new=8, arrival=1.0)
    s = RequestStream(r)
    assert s.ttft is None and s.tpot is None
    s.append([11], 1.5, 0)
    s.append([12, 13], 2.5, 1)
    assert s.ttft == pytest.approx(0.5)
    assert s.tpot == pytest.approx(0.5)
    assert s.version_segments == [(0, 0), (1, 1)]
    assert s.tokens == [11, 12, 13]
    with pytest.raises(ValueError):
        Request(rid=1, prompt=np.array([]), max_new=4)
    with pytest.raises(ValueError):
        Request(rid=2, prompt=np.array([5]), max_new=0)


def test_engine_gates_unsupported_archs(tiny_model):
    """The gate reads the config, as in JAX: a sliding-window model (reduced
    mixtral, whose ring the page pool cannot address) is refused."""
    bad = reduced(get_config("mixtral-8x7b"), vocab_size=260, num_layers=2)
    assert bad.sliding_window is not None
    model = get_model(bad, device="cpu")
    with pytest.raises(ValueError, match="serving engine"):
        ServingEngine(model, _scfg(), params=model.init(torch.Generator().manual_seed(0)))


# --------------------------------------------------------------------------- #
# (g) the entry point's streaming default
# --------------------------------------------------------------------------- #
def test_serve_main_streams_by_default_on_cpu(capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--num-requests", "6", "--slots", "2",
                      "--max-len", "64", "--max-new", "8", "--rate", "200"])
    st, eng = out["stats"], out["engine"]
    assert isinstance(eng, ServingEngine) and st["requests_finished"] == 6
    assert all(s.finished for s in out["streams"]) and st["decode_steps"] > 0
    assert st["prefill_chunks"] > 0 and out["ttft"]["p99"] >= out["ttft"]["p50"] > 0
    printed = capsys.readouterr().out
    assert "tok/s on cpu" in printed and "prefix-cache hit rate" in printed
