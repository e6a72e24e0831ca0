"""The PyTorch port's SSD (Mamba2) slice against the JAX package on the CPU.

The kernel's plain version (``ops.ssd`` on CPU tensors, ``ref.ssd_chunked``)
is held against the JAX Pallas ``ssd`` in interpret mode and against the
sequential JAX oracle ``ref.ssd_scan``, at the tolerances of
``tests/test_kernels.py`` (fp32 1e-3, bf16 5e-2, state 1e-3: the chunked
form and the scan sum in different orders). The model runs reduced mamba2
and a reduced jamba without experts (attention and SSD layers mixed, dense
MLPs) on JAX weights bridged into the port, in fp32 at 2e-5, with the JAX
package on its reference kernel path (its CPU default).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd as ssd_pallas
from repro.models import get_model as jax_get_model
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.rl.rollout import generate as jax_generate
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import get_model, lm, ssm
from repro_torch.rl.rollout import generate

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=2e-5, rtol=2e-5)
MAMBA2 = ("mamba2-2.7b", dict(vocab_size=260, num_layers=2))
# attention at layers 1 and 5 of 8 (a pattern of 4 repeated twice), SSD elsewhere
JAMBA = ("jamba-v0.1-52b", dict(vocab_size=260, num_layers=8, num_experts=0))
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def fp32_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else jnp.asarray(a), tree)


def ssd_inputs(seed, b, s, nh, p, g, n, dtype="fp32"):
    """(JAX arrays, torch tensors) of one SSD call, made with numpy; x, dt,
    Bm and Cm in ``dtype``, A and D in fp32 (as ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh))))
    A = -np.exp(rng.standard_normal(nh))
    Bm, Cm = rng.standard_normal((b, s, g, n)), rng.standard_normal((b, s, g, n))
    D = rng.standard_normal(nh)
    jd, td = DTYPES[dtype]
    arrs = [x, dt, A, Bm, Cm, D]
    wide = (True, True, False, True, True, False)  # the ones in ``dtype``
    js = [jnp.asarray(a, jd if w else jnp.float32) for a, w in zip(arrs, wide)]
    ts = [torch.from_numpy(np.asarray(a, np.float32)).to(td if w else torch.float32)
          for a, w in zip(arrs, wide)]
    return js, ts


def as_np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


# --------------------------------------------------------------------------- #
# the kernel's plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s,nh,p,g,n,chunk", [
    (64, 2, 16, 1, 16, 16),
    (128, 4, 32, 2, 16, 32),
    (256, 4, 64, 4, 32, 64),
    (128, 8, 64, 1, 128, 128),  # mamba2-like (ngroups=1, N=128)
])
def test_ssd_plain_matches_pallas_and_scan(s, nh, p, g, n, chunk, dtype):
    js, ts = ssd_inputs(5, 2, s, nh, p, g, n, dtype)
    y, h = ops.ssd(*ts, chunk=chunk, return_state=True)
    assert y.dtype == ts[0].dtype and h.dtype == torch.float32 and h.shape == (2, nh, p, n)
    y_p, h_p = ssd_pallas(*js, chunk=chunk, interpret=True)
    y_r, h_r = jref.ssd_scan(*js, return_state=True)
    t = 5e-2 if dtype == "bf16" else 1e-3
    for want_y, want_h in ((y_p, h_p), (y_r, h_r)):
        np.testing.assert_allclose(as_np(y), as_np(want_y), atol=t, rtol=t)
        np.testing.assert_allclose(as_np(h), as_np(want_h), atol=1e-3, rtol=1e-3)


def test_ssd_carries_the_state_across_chunks():
    """S = 4 chunks: the chunked form equals the sequential scan (both
    packages'), and two calls over the halves, the second started from the
    first's state, equal one call over the whole."""
    js, ts = ssd_inputs(6, 2, 96, 4, 8, 2, 8)
    y, h = ops.ssd(*ts, chunk=24, return_state=True)
    y_scan, h_scan = ref.ssd_scan(*ts, return_state=True)
    y_jax, h_jax = jref.ssd_scan(*js, return_state=True)
    for want_y, want_h in ((y_scan, h_scan), (y_jax, h_jax)):
        np.testing.assert_allclose(as_np(y), as_np(want_y), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(as_np(h), as_np(want_h), atol=1e-4, rtol=1e-4)
    x, dt, A, Bm, Cm, D = ts
    half = lambda t, i: t[:, i * 48:(i + 1) * 48]  # noqa: E731
    y0, h0 = ref.ssd_chunked(*(half(t, 0) for t in (x, dt)), A,
                             *(half(t, 0) for t in (Bm, Cm)), D, chunk=24, return_state=True)
    y1, h1 = ref.ssd_chunked(*(half(t, 1) for t in (x, dt)), A,
                             *(half(t, 1) for t in (Bm, Cm)), D, chunk=24, h0=h0,
                             return_state=True)
    np.testing.assert_allclose(torch.cat([y0, y1], 1).numpy(), y.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h1.numpy(), h.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,nh,p,g,n,chunk", [
    (96, 4, 16, 2, 16, 24),  # four chunks of 24 (padded to 32), two groups
    (80, 2, 64, 2, 16, 40),  # two chunks of 40 (padded to 48)
    (64, 4, 64, 1, 32, 64),  # one chunk
])
def test_ssd_kernel_decomposition_matches_chunked_and_pallas(s, nh, p, g, n, chunk):
    """``ref.ssd_chunked_tiles``, the CUDA kernel's decomposition (padded
    chunks, chunk states recurred in order, G, h and W as bf16 hi + lo), on
    bf16 inputs against the plain version and the Pallas kernel in interpret
    mode, at the bf16 tolerances of ``tests/test_kernels.py``."""
    js, ts = ssd_inputs(14, 2, s, nh, p, g, n, "bf16")
    y, h = ref.ssd_chunked_tiles(*ts, chunk=chunk, return_state=True)
    assert y.dtype == torch.bfloat16 and h.shape == (2, nh, p, n)
    y_c, h_c = ref.ssd_chunked(*ts, chunk=chunk, return_state=True)
    y_p, h_p = ssd_pallas(*js, chunk=chunk, interpret=True)
    for want_y, want_h in ((y_c, h_c), (y_p, h_p)):
        np.testing.assert_allclose(as_np(y), as_np(want_y), atol=5e-2, rtol=5e-2)
        np.testing.assert_allclose(as_np(h), as_np(want_h), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("s", [128, 256])
def test_ssd_kernel_decomposition_at_mamba2_widths(s):
    """One row at mamba2-2.7b's SSD widths (80 heads of 64, one group of
    state 128, chunk 128), one chunk and two: the kernel's roundings keep y
    and the state within half of ``chip_smoke.py``'s SSD_Y_TOL (5e-2) and
    SSD_STATE_TOL (1e-3) of the plain version (one bf16 pass of G, h and W
    would not: ``repro_torch.tools.ssd_numerics``)."""
    _, ts = ssd_inputs(15, 1, s, 80, 64, 1, 128, "bf16")
    y, h = ref.ssd_chunked_tiles(*ts, chunk=128, return_state=True)
    y_c, h_c = ref.ssd_chunked(*ts, chunk=128, return_state=True)
    np.testing.assert_allclose(as_np(y), as_np(y_c), atol=2.5e-2, rtol=2.5e-2)
    np.testing.assert_allclose(as_np(h), as_np(h_c), atol=5e-4, rtol=5e-4)


def test_ssd_decode_step_matches_jax():
    b, s, nh, p, g, n = 2, 5, 4, 8, 2, 8
    js, ts = ssd_inputs(7, b, s, nh, p, g, n)
    hj = jnp.zeros((b, nh, p, n))
    ht = torch.zeros((b, nh, p, n))
    for t in range(s):
        yj, hj = jref.ssd_decode_step(js[0][:, t], js[1][:, t], js[2], js[3][:, t],
                                      js[4][:, t], js[5], hj)
        yt, ht = ops.ssd_decode_step(ts[0][:, t], ts[1][:, t], ts[2], ts[3][:, t],
                                     ts[4][:, t], ts[5], ht)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


def test_ssd_raises_when_the_chunk_does_not_divide_the_sequence():
    _, ts = ssd_inputs(8, 1, 40, 2, 8, 1, 8)
    assert ops.ssd(*ts, chunk=128).shape == ts[0].shape  # chunk = min(chunk, S)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd(*ts, chunk=16)
    ops.set_mode("ref")
    try:
        with pytest.raises(ValueError):
            ops.ssd(*ts, chunk=16)
    finally:
        ops.set_mode(None)


# --------------------------------------------------------------------------- #
# the SSD mixer and the models
# --------------------------------------------------------------------------- #
def configs(spec):
    arch, kw = spec
    return (jax_reduced(jax_get_config(arch), **kw), reduced(get_config(arch), **kw))


@pytest.fixture(scope="module", params=[MAMBA2, JAMBA], ids=["mamba2", "jamba"])
def family(request):
    """(JAX config, port config, JAX params as numpy, fp32 JAX params, the
    port's fp32 params bridged from them)."""
    jcfg, cfg = configs(request.param)
    jp = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, fp32_tree(jp), bridge.from_jax(jp, device="cpu", dtype=torch.float32)


def test_bridge_round_trips_bit_for_bit(family):
    """The SSD leaves keep their dtypes, and ``to_jax`` stacks the layers by
    the layer pattern: jamba's 8 layers into 4 positions of 2."""
    jcfg, cfg, jp, _, _ = family
    params = bridge.from_jax(jp, device="cpu")
    s = next(b["ssm"] for b in params["blocks"] if "ssm" in b)
    assert {k for k, v in s.items() if v.dtype == torch.float32} == {
        "A_log", "D", "dt_bias", "norm_w"}
    assert all(v.dtype == torch.bfloat16 for k, v in s.items()
               if k not in ("A_log", "D", "dt_bias", "norm_w"))
    back = bridge.to_jax(params)
    assert len(back["blocks"]) == lm.pattern_length(cfg) == jlm.pattern_length(jcfg)
    flat_a, tree_a = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_init_has_the_jax_layout(family):
    """The port's own init draws every leaf the JAX init has, with its shape
    and dtype, layer by layer."""
    jcfg, cfg, jp, _, _ = family
    params = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    back = bridge.to_jax(params)
    flat_a, tree_a = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    assert [(a.dtype, a.shape) for a in flat_a] == [(b.dtype, b.shape) for b in flat_b]
    s = next(b["ssm"] for b in params["blocks"] if "ssm" in b)
    sp = torch.nn.functional.softplus(s["dt_bias"])
    assert float(sp.min()) >= 1e-3 * (1 - 1e-5) and float(sp.max()) <= 0.1 * (1 + 1e-5)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for st in (None, state):
        yj, sj = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st))
        yt, stt = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))


def test_ssm_mixer_prefill_and_decode_match_jax():
    """``apply_ssm`` with its state, then ``apply_ssm_decode`` steps from
    that state, on one bridged fp32 layer of reduced mamba2."""
    jcfg, cfg = configs(MAMBA2)
    jp = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(1)))
    jl = fp32_tree(jax.tree.map(lambda a: a[0], jp["blocks"][0]["ssm"]))
    tl = bridge.from_jax(jp, device="cpu", dtype=torch.float32)["blocks"][0]["ssm"]
    rng = np.random.default_rng(10)
    u = rng.standard_normal((2, 16, 64)).astype(np.float32)
    oj, sj = jssm.apply_ssm(jcfg, jl, jnp.asarray(u), return_state=True)
    ot, st = ssm.apply_ssm(cfg, tl, torch.from_numpy(u), return_state=True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    for name in ("ssm", "conv_x", "conv_bc"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]), **TOL)
    for t in range(3):
        ut = rng.standard_normal((2, 1, 64)).astype(np.float32)
        oj, sj = jssm.apply_ssm_decode(jcfg, jl, jnp.asarray(ut), sj)
        ot, st = ssm.apply_ssm_decode(cfg, tl, torch.from_numpy(ut), st)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(sj["ssm"]), **TOL)


@pytest.mark.parametrize("chunk", [4, 8])
def test_ssm_mixer_at_another_chunk_length_matches_jax(chunk):
    """``apply_ssm(chunk=...)`` (four and two chunks over 16 positions)
    computes the JAX mixer's function (one chunk): only the order of the
    scan's fp32 sums changes; a chunk that does not divide the prompt raises."""
    jcfg, cfg = configs(MAMBA2)
    jp = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(1)))
    jl = fp32_tree(jax.tree.map(lambda a: a[0], jp["blocks"][0]["ssm"]))
    tl = bridge.from_jax(jp, device="cpu", dtype=torch.float32)["blocks"][0]["ssm"]
    u = np.random.default_rng(12).standard_normal((2, 16, 64)).astype(np.float32)
    oj, sj = jssm.apply_ssm(jcfg, jl, jnp.asarray(u), return_state=True)
    ot, st = ssm.apply_ssm(cfg, tl, torch.from_numpy(u), return_state=True, chunk=chunk)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(sj["ssm"]), **TOL)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssm.apply_ssm(cfg, tl, torch.from_numpy(u), chunk=chunk + 1)


def test_prefill_and_teacher_forced_decode_logits_match(family):
    jcfg, cfg, _, jpf, tp = family
    model = get_model(cfg, device="cpu")
    rng = np.random.default_rng(11)
    prompt = rng.integers(3, 259, (3, 16)).astype(np.int32)
    forced = rng.integers(3, 259, (3, 3)).astype(np.int32)
    logits_j, caches_j, len_j = jlm.prefill(jcfg, jpf, jnp.asarray(prompt), smax=19)
    with torch.inference_mode():
        logits_t, caches_t, len_t = model.prefill(tp, torch.from_numpy(prompt), smax=19)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert float(logits_t[:, cfg.vocab_size:].max()) < -1e29  # padded vocab masked
    for j in range(forced.shape[1]):
        logits_j, caches_j, len_j = jlm.decode_step(jcfg, jpf, jnp.asarray(forced[:, j]),
                                                    caches_j, len_j)
        with torch.inference_mode():
            logits_t, caches_t, len_t = model.decode_step(
                tp, torch.from_numpy(forced[:, j]), caches_t, len_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    # layer i's state is group i // P of pattern position i % P in JAX
    P = lm.pattern_length(cfg)
    for i, kind in enumerate(cfg.layer_kinds()):
        want = caches_j[i % P]
        for name, leaf in caches_t[i].items():
            np.testing.assert_allclose(leaf.float().numpy(),
                                       np.asarray(want[name][i // P], np.float32), **TOL)
        assert set(caches_t[i]) == ({"k", "v"} if kind[0] == "attn"
                                    else {"ssm", "conv_x", "conv_bc"})


def test_init_caches_have_the_jax_leaves(family):
    jcfg, cfg, _, _, _ = family
    want = jlm.init_caches(jcfg, 2, 8)
    got = lm.init_caches(cfg, 2, 8, device="cpu")
    P = lm.pattern_length(cfg)
    for i, c in enumerate(got):
        w = want[i % P]
        assert sorted(c) == sorted(w)
        for name, leaf in c.items():
            assert tuple(leaf.shape) == tuple(w[name].shape[1:])
            assert str(leaf.dtype).split(".")[-1] == str(w[name].dtype)
            assert not leaf.any()


def test_greedy_generate_matches_jax(family):
    jcfg, cfg, _, jpf, tp = family
    prompt = np.random.default_rng(12).integers(3, 259, (4, 8)).astype(np.int32)
    want = jax_generate(jax_get_model(jcfg), jpf, jnp.asarray(prompt), jax.random.PRNGKey(0),
                        max_new=6, temperature=0.0)
    got = generate(get_model(cfg, device="cpu"), tp, torch.from_numpy(prompt),
                   torch.Generator().manual_seed(0), max_new=6, temperature=0.0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(want.response_mask))
    np.testing.assert_allclose(got.old_logprob.numpy(), np.asarray(want.old_logprob), **TOL)


def test_chunked_prefill_raises_for_ssd_layers(family):
    _, cfg, _, _, tp = family
    model = get_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        model.prefill_chunk(tp, torch.zeros((1, 4), dtype=torch.int32),
                            model.init_caches(1, 8), offset=0)


def test_serve_lockstep_runs_mamba2_on_cpu(capsys):
    stats = serve.main(["--arch", "mamba2-2.7b", "--smoke", "--lockstep", "--device", "cpu",
                        "--batch", "2", "--max-new", "4", "--requests", "2",
                        "--prompt-len", "9"])
    assert len(stats["results"]) == 3  # warm-up + two timed batches
    assert stats["results"][0].tokens.shape == (2, 9 + 4)
    assert stats["tokens"] > 0
    assert "tok/s on cpu" in capsys.readouterr().out


def test_streaming_refuses_mamba2():
    """The streaming engine needs page-addressable KV: it refuses SSD
    mixers with the engine's ValueError, as the JAX engine does."""
    with pytest.raises(ValueError, match="page-addressable KV"):
        serve.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu"])


def test_cache_row_helpers_move_ssd_state_as_jax(family):
    """``gather_cache_rows`` and ``scatter_cache_rows`` take their batch size
    from any leaf, so they move SSD state rows as they move K/V rows, as the
    JAX helpers (a map over every leaf) do: out-of-range slot ids dropped.
    The page helpers take attention caches only and raise on SSD state."""
    jcfg, cfg, _, jpf, tp = family
    model = get_model(cfg, device="cpu")
    rng = np.random.default_rng(13)
    prompt, fresh = (rng.integers(3, 259, (3, 8)).astype(np.int32) for _ in range(2))
    _, caches_j, _ = jlm.prefill(jcfg, jpf, jnp.asarray(prompt), smax=12)
    _, rows_j, _ = jlm.prefill(jcfg, jpf, jnp.asarray(fresh), smax=12)
    with torch.inference_mode():
        _, caches_t, _ = model.prefill(tp, torch.from_numpy(prompt), smax=12)
        _, rows_t, _ = model.prefill(tp, torch.from_numpy(fresh), smax=12)
    P = lm.pattern_length(cfg)

    def assert_like_jax(got, want):
        assert len(got) == cfg.num_layers
        for i, c in enumerate(got):
            assert sorted(c) == sorted(want[i % P])
            for name, leaf in c.items():
                np.testing.assert_allclose(leaf.float().numpy(),
                                           np.asarray(want[i % P][name][i // P], np.float32),
                                           **TOL)

    slots = [1, 7, 0]  # 7 is past the batch of 3: dropped
    with torch.inference_mode():
        gathered = lm.gather_cache_rows(caches_t, [2, 0])
        scattered = lm.scatter_cache_rows(caches_t, rows_t, slots)
    assert_like_jax(gathered, jlm.gather_cache_rows(caches_j, jnp.asarray([2, 0])))
    assert_like_jax(scattered, jlm.scatter_cache_rows(caches_j, rows_j, jnp.asarray(slots)))
    with pytest.raises(ValueError, match="SSM state"):
        lm.gather_cache_pages(caches_t, [0], num_pages=1, page_size=4)
    with pytest.raises(ValueError, match="SSM state"):
        lm.scatter_cache_pages(caches_t, caches_t, [0])
