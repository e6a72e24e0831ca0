#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one card, no
arguments). It needs no JAX and no network, and builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use.

Phases (any mismatch or error raises, and the run exits non-zero):
  1. Device: the card's name and power limit (``nvidia-smi``), the build.
  2. Kernels: each of the five kernels against its plain PyTorch version on
     the card, at the full gemma-2b shapes of the serving paths (lockstep:
     B=8, prompt 128, max_new 32; streaming: 8 slots, pages of 16, 256
     positions, and prefill chunks of 16 queries at an offset), timed beside
     the plain version and one PyTorch call as a yardstick (never called by
     the port).
  3. Lockstep end to end: ``repro_torch.launch.serve --lockstep`` at full
     gemma-2b width and depth with random weights, greedy then temperature
     0.8; the launch counters must show every kernel of the path, the tokens
     must be in range and repeatable, and the kernel path must agree with
     the plain one.
  4. Streaming end to end: ``repro_torch.launch.serve`` (the streaming
     engine, the default path) on the same model, 32 synthetic requests,
     greedy then 0.8; the launch counters must match the engine's prefill
     chunks and decode steps, every stream must finish, the same seed must
     give the same streams, a prefix-cache hit must give the tokens of the
     cold run, and greedy first tokens must agree with the plain path.

Output: the nvidia-smi line, JSON lines per kernel and per phase, a
``{"kernels": [...]}`` line, and as the last line ``{"ok": true, "device":
{...}}``. Without CUDA, or outside a checkout, it exits non-zero before
printing any result.

``--profile`` also writes torch.profiler tables of one greedy generate and
of one greedy streaming replay to ``build/profile.txt`` and
``build/profile_streaming.txt``, and prints the device-busy share of each.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet):
# the bound of a kernel is the larger of its bytes over the memory rate and
# its operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

# the lockstep serving path at full gemma-2b width and depth
DEV = "cuda"
ARCH_FLAGS = ["--arch", "gemma-2b"]
B, PROMPT, MAX_NEW = 8, 128, 32
SMAX = PROMPT + MAX_NEW
D_MODEL, VOCAB, HEADS, REAL_HEADS, HEAD_DIM = 2048, 256_000, 16, 8, 256
TIMED_BATCHES = 4
# the streaming path: the engine's ServingConfig and its synthetic workload
SLOTS, MAX_LEN, STREAM_NEW, PAGE, N_REQUESTS = 8, 256, 64, 16, 32
STREAM_FLAGS = ["--slots", str(SLOTS), "--max-len", str(MAX_LEN), "--max-new", str(STREAM_NEW),
                "--page-size", str(PAGE), "--num-requests", str(N_REQUESTS), "--rate", "20",
                "--no-realtime"]

BF16_TOL = 2e-2
LSE_TOL = 1e-3
LOGPROB_TOL = 1e-3
SAMPLE_GAP = 1e-4


def bound_ms(nbytes: float, flops: float, flop_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of one call, from CUDA events around each call.

    The calls are queued behind a spin kernel, so the host has enqueued them
    all before the card reaches them: the events then time the card's work
    back to back, not the host's launch overhead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(int(max(2e7, 4 * reps * host_s * 2e9)))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def close(a, b, tol: float):
    """(ok, max |a - b|) with |a - b| <= tol + tol |b| elementwise."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return bool((err <= tol + tol * b.abs()).all()), float(err.max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def kernel_phase(torch, ops, ref, F):
    """Hold each kernel against its plain version at the serving path's
    shapes; returns one record per kernel (launch counts filled in later)."""
    gen = torch.Generator(device=DEV).manual_seed(1234)
    dev = DEV

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    ops.set_mode(None)
    records = {}

    def sdpa(q, k, v, **kw):  # the yardstick: one SDPA call, k/v heads shared
        return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)

    # ---- rmsnorm: prefill rows and decode rows of d_model 2048 ----
    D = D_MODEL
    w = randn(D, scale=0.1, dtype=torch.float32)
    wl = (1.0 + w).to(torch.bfloat16)
    rec = {}
    for tag, R in (("prefill", B * PROMPT), ("decode", B)):
        x = randn(R, D)
        ok, err = close(ops.rmsnorm(x, w), ref.rmsnorm(x, w), BF16_TOL)
        require(ok, f"rmsnorm {R}x{D}: max abs err {err}")
        nbytes = 2 * R * D * 2 + D * 4
        bms, by = bound_ms(nbytes, 4 * R * D, FP32_FLOP_PER_S)
        lib = device_ms(lambda: F.rms_norm(x, (D,), weight=wl, eps=1e-6))
        rec[tag] = {"shape": [R, D], "max_abs_err": err,
                    "ms": device_ms(lambda: ops.rmsnorm(x, w)),
                    "plain_ms": device_ms(lambda: ref.rmsnorm(x, w)),
                    "bound_ms": bms, "bound_by": by, "library_ms": lib}
        print(json.dumps({"check": f"rmsnorm/{tag}", **rec[tag]}), flush=True)
    records["rmsnorm"] = {**rec["prefill"], "decode": rec["decode"]}

    # ---- flash attention: the prefill, 16 padded heads (8..15 zero) ----
    H, KVH, HD = HEADS, 1, HEAD_DIM
    q = randn(B, PROMPT, H, HD)
    q[:, :, REAL_HEADS:] = 0
    k, v = randn(B, PROMPT, KVH, HD), randn(B, PROMPT, KVH, HD)
    ok, err = close(ops.flash_attention(q, k, v, causal=True),
                    ref.flash_attention(q, k, v, causal=True), BF16_TOL)
    require(ok, f"flash_attention: max abs err {err}")
    pairs = PROMPT * (PROMPT + 1) // 2
    nbytes = 2 * q.numel() * 2 + k.numel() * 2 + v.numel() * 2  # q, k, v in; o out
    bms, by = bound_ms(nbytes, 4 * B * H * HD * pairs, BF16_TENSOR_FLOP_PER_S)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    records["flash_attention"] = {
        "shape": {"q": list(q.shape), "kv": list(k.shape)}, "max_abs_err": err,
        "ms": device_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        "plain_ms": device_ms(lambda: ref.flash_attention(q, k, v, causal=True)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(sdpa(qt, kt, vt, is_causal=True))}
    # what the serving path does not use: no mask, window, q_offset, GQA,
    # a ragged Sq, and the other head widths the kernel is built for
    for kw, sq, hd in (({"causal": False}, PROMPT, 64), ({"window": 48}, PROMPT, 128),
                       ({"q_offset": 32}, 77, HD)):
        qq = randn(2, sq, 8, hd)
        kk, vv = randn(2, PROMPT, 2, hd), randn(2, PROMPT, 2, hd)
        ok, err2 = close(ops.flash_attention(qq, kk, vv, **kw),
                         ref.flash_attention(qq, kk, vv, **kw), BF16_TOL)
        require(ok, f"flash_attention {kw} Sq={sq} D={hd}: max abs err {err2}")
    # the streaming path's prefill chunk: 16 queries at q_offset 32 against
    # the first 48 positions of 256-wide admission rows (a strided view)
    R, C, OFF = SLOTS, PAGE, 2 * PAGE
    qc = randn(R, C, H, HD)
    qc[:, :, REAL_HEADS:] = 0
    rows_k, rows_v = randn(R, MAX_LEN, KVH, HD), randn(R, MAX_LEN, KVH, HD)
    kch, vch = rows_k[:, :OFF + C], rows_v[:, :OFF + C]
    ok, err_c = close(ops.flash_attention(qc, kch, vch, causal=True, q_offset=OFF),
                      ref.flash_attention(qc, kch, vch, causal=True, q_offset=OFF), BF16_TOL)
    require(ok, f"flash_attention chunk (Sq {C}, Sk {OFF + C}, q_offset {OFF}): "
                f"max abs err {err_c}")
    pairs_c = C * OFF + C * (C + 1) // 2
    nbytes = 2 * qc.numel() * 2 + 2 * R * (OFF + C) * KVH * HD * 2
    bms, by = bound_ms(nbytes, 4 * R * H * HD * pairs_c, BF16_TENSOR_FLOP_PER_S)
    cmask = (torch.arange(OFF + C, device=dev)[None, :]
             <= torch.arange(C, device=dev)[:, None] + OFF)
    records["flash_attention"]["chunk"] = {
        "shape": {"q": list(qc.shape), "kv": list(kch.shape), "q_offset": OFF,
                  "kv_batch_stride": kch.stride(0)},
        "max_abs_err": err_c,
        "ms": device_ms(lambda: ops.flash_attention(qc, kch, vch, causal=True, q_offset=OFF)),
        "plain_ms": device_ms(lambda: ref.flash_attention(qc, kch, vch, causal=True,
                                                          q_offset=OFF)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(sdpa(qc.transpose(1, 2), kch.transpose(1, 2),
                                     vch.transpose(1, 2), attn_mask=cmask))}
    print(json.dumps({"check": "flash_attention", **records["flash_attention"]}), flush=True)

    # ---- decode attention: one token against the cache, ragged lengths ----
    qd = randn(B, H, HD)
    qd[:, REAL_HEADS:] = 0
    kc, vc = randn(B, SMAX, KVH, HD), randn(B, SMAX, KVH, HD)
    lens = torch.randint(1, SMAX + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens[0], lens[1] = SMAX, 1
    o_k, lse_k = ops.decode_attention(qd, kc, vc, lens)
    o_r, lse_r = ref.decode_attention(qd, kc, vc, lens)
    ok, err = close(o_k, o_r, BF16_TOL)
    ok_l, err_l = close(lse_k, lse_r, LSE_TOL)
    require(ok and ok_l, f"decode_attention: o err {err}, lse err {err_l}")
    for n, kw, hd in ((lens, {"window": 40}, 64), (lens + 16, {"pos_offset": 16}, 128)):
        qq, kk, vv = randn(B, 8, hd), randn(B, SMAX, 2, hd), randn(B, SMAX, 2, hd)
        a, b = ops.decode_attention(qq, kk, vv, n, **kw), ref.decode_attention(
            qq, kk, vv, n, **kw)
        require(close(a[0], b[0], BF16_TOL)[0] and close(a[1], b[1], LSE_TOL)[0],
                f"decode_attention {kw} D={hd}")
    live = int(lens.sum())
    nbytes = 2 * qd.numel() * 2 + B * H * 4 + live * KVH * HD * 2 * 2
    bms, by = bound_ms(nbytes, 4 * H * HD * live, BF16_TENSOR_FLOP_PER_S)
    mask = (torch.arange(SMAX, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    qdt, kct, vct = qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    records["decode_attention"] = {
        "shape": {"q": list(qd.shape), "kv": list(kc.shape), "cache_len": lens.tolist()},
        "max_abs_err": err, "lse_max_abs_err": err_l,
        "ms": device_ms(lambda: ops.decode_attention(qd, kc, vc, lens)),
        "plain_ms": device_ms(lambda: ref.decode_attention(qd, kc, vc, lens)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(sdpa(qdt, kct, vct, attn_mask=mask))}
    print(json.dumps({"check": "decode_attention", **records["decode_attention"]}), flush=True)

    # ---- paged decode attention: the streaming burst's step, 8 slots over a
    # pool of 384 pages (+ the sink) in shuffled order, ragged lengths, and
    # stale table entries past each live span (pages no live span reads) ----
    T = MAX_LEN // PAGE
    P = 3 * SLOTS * T + 1
    pool_k, pool_v = randn(P, PAGE, KVH, HD), randn(P, PAGE, KVH, HD)
    qp = randn(SLOTS, H, HD)
    qp[:, REAL_HEADS:] = 0
    perm = torch.randperm(P - 1, generator=gen, device=dev)
    tables = perm[: SLOTS * T].reshape(SLOTS, T).to(torch.int32)
    kv_len = torch.randint(1, MAX_LEN + 1, (SLOTS,), generator=gen, device=dev,
                           dtype=torch.int32)
    kv_len[0], kv_len[1], kv_len[2] = MAX_LEN, 1, PAGE + 1
    live_pages = (kv_len.long() + PAGE - 1) // PAGE
    stale = torch.arange(T, device=dev)[None, :] >= live_pages[:, None]
    tables = torch.where(stale, perm[-SLOTS * T:].reshape(SLOTS, T).to(torch.int32), tables)
    o_k, lse_k = ops.paged_decode_attention(qp, pool_k, pool_v, tables, kv_len)
    o_r, lse_r = ref.paged_decode_attention(qp, pool_k, pool_v, tables, kv_len)
    ok, err = close(o_k, o_r, BF16_TOL)
    ok_l, err_l = close(lse_k, lse_r, LSE_TOL)
    require(ok and ok_l, f"paged_decode_attention: o err {err}, lse err {err_l}")
    for hd in (64, 128):  # the other head widths the kernel is built for
        qq, pk, pv = randn(SLOTS, 8, hd), randn(P, PAGE, 2, hd), randn(P, PAGE, 2, hd)
        a, b = (f(qq, pk, pv, tables, kv_len) for f in (ops.paged_decode_attention,
                                                        ref.paged_decode_attention))
        require(close(a[0], b[0], BF16_TOL)[0] and close(a[1], b[1], LSE_TOL)[0],
                f"paged_decode_attention D={hd}")
    live = int(kv_len.sum())
    nbytes = (2 * qp.numel() * 2 + SLOTS * H * 4 + tables.numel() * 4 + SLOTS * 4
              + live * KVH * HD * 2 * 2)
    bms, by = bound_ms(nbytes, 4 * H * HD * live, BF16_TENSOR_FLOP_PER_S)
    idx = tables.long().reshape(-1)  # SDPA reads pre-gathered K/V: the gather is not timed
    kg = pool_k[idx].reshape(SLOTS, T * PAGE, KVH, HD).transpose(1, 2)
    vg = pool_v[idx].reshape(SLOTS, T * PAGE, KVH, HD).transpose(1, 2)
    pmask = (torch.arange(T * PAGE, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    records["paged_decode_attention"] = {
        "shape": {"q": list(qp.shape), "pool": list(pool_k.shape), "tables": list(tables.shape),
                  "kv_len": kv_len.tolist()},
        "max_abs_err": err, "lse_max_abs_err": err_l,
        "ms": device_ms(lambda: ops.paged_decode_attention(qp, pool_k, pool_v, tables, kv_len)),
        "plain_ms": device_ms(lambda: ref.paged_decode_attention(qp, pool_k, pool_v, tables,
                                                                 kv_len)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(sdpa(qp[:, :, None], kg, vg, attn_mask=pmask)),
        "library_note": "SDPA on K/V gathered beforehand (the gather excluded)"}
    print(json.dumps({"check": "paged_decode_attention", **records["paged_decode_attention"]}),
          flush=True)

    # ---- fused sample: head = tied embedding (256000, 2048), never copied ----
    V = VOCAB
    embed = randn(V, D, scale=0.02)
    h = randn(B, D)
    seeds = torch.randint(-2**31, 2**31, (B,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    worst = 0.0
    for inv_t, vocab in ((0.0, V), (1.0, V), (0.0, V - 100), (1.0, V - 100)):
        it = torch.full((B,), inv_t, device=dev)
        tok_k, lp_k = ops.fused_sample(h, embed.t(), seeds, it, vocab_size=vocab)
        tok_r, lp_r = ref.fused_sample(h, embed.t(), seeds, it, vocab_size=vocab)
        require(bool((tok_k < vocab).all()), "fused_sample drew a padded-vocab token")
        if inv_t == 0.0:
            require(torch.equal(tok_k, tok_r), f"fused_sample greedy: {tok_k} vs {tok_r}")
        else:
            _, y = ref.sample_scores(h, embed.t(), seeds, it, vocab_size=vocab)
            top2 = y.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > SAMPLE_GAP
            require(bool((tok_k == tok_r)[clear].all()),
                    f"fused_sample inv_temp={inv_t}: {tok_k} vs {tok_r} (clear rows {clear})")
        ok, err = close(lp_k, lp_r, LOGPROB_TOL)
        require(ok, f"fused_sample logprob inv_temp={inv_t}: max abs err {err}")
        worst = max(worst, err)
    it = torch.ones(B, device=dev)
    nbytes = V * D * 2 + B * D * 2 + B * 8
    bms, by = bound_ms(nbytes, 2 * B * V * D, BF16_TENSOR_FLOP_PER_S)
    records["fused_sample"] = {
        "shape": {"h": [B, D], "embed": [V, D]}, "max_abs_err": worst,
        "ms": device_ms(lambda: ops.fused_sample(h, embed.t(), seeds, it, vocab_size=V)),
        "plain_ms": device_ms(lambda: ref.fused_sample(h, embed.t(), seeds, it, vocab_size=V),
                              reps=21),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(lambda: torch.matmul(h, embed.t()))}
    print(json.dumps({"check": "fused_sample", **records["fused_sample"]}), flush=True)
    return records


def serve_args(serve, temperature: float):
    return serve.parse_args([
        *ARCH_FLAGS, "--lockstep", "--device", DEV, "--seed", "0",
        "--batch", str(B), "--prompt-len", str(PROMPT), "--max-new", str(MAX_NEW),
        "--requests", str(TIMED_BATCHES), "--temperature", str(temperature)])


def build_model(torch, serve):
    """gemma-2b at full width and depth on the card, random bf16 weights
    from ``--seed 0``, through the serve entry point's own setup."""
    t0 = time.perf_counter()
    model, params, tok = serve.setup(serve_args(serve, 0.0))
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.padded_heads} heads (padded from {cfg.num_heads}) of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; weights drawn in "
          f"{time.perf_counter() - t0:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return model, params, tok


def busy_share(torch, fn, table_path: Path):
    """Profile one call of ``fn`` with torch.profiler: (device ms of the
    kernels, wall ms of the profiled call); writes the table to
    ``table_path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    # device time of the kernels themselves (the operator rows of the table
    # repeat their kernels' time, so they are not summed)
    busy_us = sum(e.device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    table_path.parent.mkdir(exist_ok=True)
    table_path.write_text(table)
    print(table[:8000], flush=True)
    return busy_us / 1e3, wall_s * 1e3


def end_to_end_phase(torch, ops, _build, serve, generate, model, params, tok):
    """Full gemma-2b lockstep serving on the card, through its entry points.
    Returns (launch counts of the greedy run, summary, a function that
    profiles one greedy generate)."""
    args = serve_args(serve, 0.0)
    cfg = model.cfg
    L, steps, gens = cfg.num_layers, MAX_NEW - 1, TIMED_BATCHES + 1
    expected = {"rmsnorm": gens * (2 * L + 1) * (1 + steps),
                "flash_attention": gens * L,
                "decode_attention": gens * L * steps,
                "paged_decode_attention": 0,
                "fused_sample": gens * steps}

    def checked_run(a):
        _build.reset_launches()
        stats = serve.run_lockstep(model, params, tok, a)
        counts = dict(_build.LAUNCHES)
        require(counts == expected, f"launches {counts}, expected {expected}")
        for res in stats["results"]:
            resp = res.tokens[:, PROMPT:]
            require(resp.shape == (B, MAX_NEW), f"response shape {tuple(resp.shape)}")
            require(bool(((resp >= 0) & (resp < cfg.vocab_size)).all()), "token out of range")
            require(bool(torch.isfinite(res.old_logprob).all()), "non-finite logprob")
        return stats, counts

    def same_tokens(a, b):
        return all(torch.equal(x.tokens, y.tokens) for x, y in zip(a["results"], b["results"]))

    ops.set_mode(None)
    sampled_args = serve_args(serve, 0.8)
    greedy, counts = checked_run(args)
    sampled, _ = checked_run(sampled_args)
    require(same_tokens(greedy, checked_run(args)[0]), "two greedy runs with one seed differ")
    require(same_tokens(sampled, checked_run(sampled_args)[0]),
            "two sampled runs with one seed differ")
    first = greedy["results"][0].tokens
    require(all(torch.equal(r.tokens, first) for r in greedy["results"]),
            "greedy batches of one run differ")

    # the kernel path against the plain path on the same weights and prompt
    _, ids = serve.prompts(tok, B, PROMPT)
    prompt = torch.from_numpy(ids).to(DEV)
    with torch.inference_mode():
        ops.set_mode("ref")
        logits_r, caches_r, len_r = model.prefill(params, prompt, smax=SMAX)
        tok0 = torch.argmax(logits_r, dim=-1).to(torch.int32)
        step_r, _, _ = model.decode_step(params, tok0, caches_r, len_r)
        ops.set_mode(None)
        logits_k, caches_k, len_k = model.prefill(params, prompt, smax=SMAX)
        zero = torch.zeros(B, dtype=torch.int32, device=DEV)
        tok1_k, _, _, _ = model.decode_step_sample(params, tok0, caches_k, len_k, zero, 0.0)
    real = slice(0, cfg.vocab_size)  # the padded vocab is -1e30 in both
    scale = float(logits_r[:, real].abs().max())
    err = float((logits_k[:, real] - logits_r[:, real]).abs().max())
    require(err <= 2e-2 * scale, f"prefill logits: max abs err {err} vs max |logit| {scale}")

    def agree(pred, logits, what):
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 0.05
        require(bool((pred == torch.argmax(logits, dim=-1))[clear].all()),
                f"{what}: kernel path disagrees with the plain path in a clear row")
        return int(clear.sum())

    clear0 = agree(torch.argmax(logits_k, dim=-1), logits_r, "first token")
    clear1 = agree(tok1_k, step_r, "first decoded token")
    print(f"[e2e] kernel vs plain path: prefill logits max abs err {err:.4g} "
          f"(max |logit| {scale:.4g}); first token agrees in {clear0}/{B} clear rows, "
          f"first decoded token in {clear1}/{B}", flush=True)

    # decode rate: a whole generate minus one that stops after the prefill
    def gen_s(max_new):
        g = torch.Generator(device=DEV).manual_seed(7)
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(model, params, prompt, g, max_new=max_new, temperature=0.0, eos_id=tok.eos_id)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    full = statistics.median(gen_s(MAX_NEW) for _ in range(5))
    prefill_only = statistics.median(gen_s(1) for _ in range(5))
    step_ms = (full - prefill_only) / (MAX_NEW - 1) * 1e3
    summary = {
        "greedy_tok_per_s": greedy["tok_per_s"], "greedy_p50_ms": greedy["p50_s"] * 1e3,
        "greedy_p99_ms": greedy["p99_s"] * 1e3,
        "sampled_tok_per_s": sampled["tok_per_s"], "sampled_p50_ms": sampled["p50_s"] * 1e3,
        "sampled_p99_ms": sampled["p99_s"] * 1e3,
        "generate_ms": full * 1e3, "prefill_and_first_token_ms": prefill_only * 1e3,
        "decode_step_ms": step_ms, "decode_tok_per_s": B / step_ms * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps({"e2e": summary}), flush=True)

    def profile_job():
        busy_ms, wall_ms = busy_share(torch, lambda: gen_s(MAX_NEW), ROOT / "build" / "profile.txt")
        print(json.dumps({"profile": {
            "device_busy_ms": busy_ms, "profiled_generate_ms": wall_ms,
            "generate_ms": full * 1e3, "device_busy_share": busy_ms / 1e3 / full}}),
              flush=True)

    return counts, summary, profile_job


def stream_args(serve, temperature: float):
    return serve.parse_args([*ARCH_FLAGS, "--device", DEV, "--seed", "0", *STREAM_FLAGS,
                             "--temperature", str(temperature)])


def streaming_phase(torch, ops, _build, serve, model, params, tok):
    """The streaming engine, the serve entry point's default path, at full
    gemma-2b width and depth. Returns (launch counts of the greedy run,
    summary, a function that profiles one greedy replay)."""
    import numpy as np

    from repro_torch.serving import Request, ServingEngine

    cfg = model.cfg
    L = cfg.num_layers

    def checked_run(a):
        _build.reset_launches()
        out = serve.run_streaming(model, params, tok, a)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        steps = int(out["warmup_stats"]["decode_steps"] + out["stats"]["decode_steps"])
        chunks = int(out["warmup_stats"]["prefill_chunks"] + out["stats"]["prefill_chunks"])
        expected = {"rmsnorm": (2 * L + 1) * (chunks + steps), "flash_attention": L * chunks,
                    "decode_attention": 0, "paged_decode_attention": L * steps,
                    "fused_sample": steps}
        require(counts == expected, f"launches {counts}, expected {expected}")
        require(out["stats"]["requests_finished"] == N_REQUESTS
                and all(st.finished for st in out["streams"]), "a stream did not finish")
        for st in out["streams"]:
            require(1 <= len(st.tokens) <= st.request.max_new, f"stream length {len(st.tokens)}")
            require(all(0 <= t < cfg.vocab_size for t in st.tokens), "token out of range")
        return out, counts

    ops.set_mode(None)
    greedy, counts = checked_run(stream_args(serve, 0.0))
    sampled, _ = checked_run(stream_args(serve, 0.8))
    tokens = lambda out: [st.tokens for st in out["streams"]]  # noqa: E731
    require(tokens(greedy) == tokens(checked_run(stream_args(serve, 0.0))[0]),
            "two greedy streaming runs with one seed differ")
    require(tokens(sampled) == tokens(checked_run(stream_args(serve, 0.8))[0]),
            "two sampled streaming runs with one seed differ")
    require(tokens(greedy) != tokens(sampled), "temperature 0.8 gave the greedy streams")

    # greedy first tokens against the plain path: each prompt zero-padded to
    # its page bucket and prefilled in page chunks, as the engine admits it
    clear = agree = 0
    with torch.inference_mode():
        ops.set_mode("ref")
        for st in greedy["streams"]:
            prompt = st.request.prompt
            lb = -(-len(prompt) // PAGE) * PAGE
            ids = torch.zeros((1, lb), dtype=torch.int32, device=DEV)
            ids[0, :len(prompt)] = torch.from_numpy(prompt).to(DEV)
            rows = model.init_caches(1, MAX_LEN)
            for off in range(0, lb, PAGE):
                logits, rows = model.prefill_chunk(params, ids[:, off:off + PAGE], rows, offset=off)
            top2 = logits[0].topk(2).values
            if float(top2[0] - top2[1]) > 0.05:
                clear += 1
                agree += int(int(torch.argmax(logits[0])) == st.tokens[0])
        ops.set_mode(None)
    require(agree == clear, f"greedy first tokens: {agree} of {clear} clear rows agree "
                            "with the plain path")

    # a prefix-cache hit gives the tokens of the cold run (sampled): the card
    # twin of tests/test_serving.py::test_prefix_hit_bitwise_identical_to_cold
    scfg = serve.serving_config(stream_args(serve, 0.8))
    hit = next(st for st in sampled["streams"] if st.matched_prefix_tokens > 0)
    m = hit.matched_prefix_tokens
    sib = next(st for st in sampled["streams"] if st is not hit
               and np.array_equal(st.request.prompt[:m], hit.request.prompt[:m]))

    def again(st, rid, max_new):
        r = st.request
        return Request(rid=rid, prompt=r.prompt, max_new=max_new,
                       temperature=r.temperature, seed=r.seed)

    warm = ServingEngine(model, scfg, params=params, eos_id=tok.eos_id, seed=0)
    warm.serve([again(sib, 0, 4)], realtime=False)
    s_warm = warm.serve([again(hit, 1, hit.request.max_new)], realtime=False)[0]
    cold = ServingEngine(model, dataclasses.replace(scfg, prefix_cache=False), params=params,
                         eos_id=tok.eos_id, seed=0)
    s_cold = cold.serve([again(hit, 1, hit.request.max_new)], realtime=False)[0]
    require(s_warm.matched_prefix_tokens == m and s_cold.matched_prefix_tokens == 0,
            f"prefix hit of {s_warm.matched_prefix_tokens} tokens, expected {m}")
    require(s_warm.tokens == s_cold.tokens, f"prefix hit {s_warm.tokens} vs cold {s_cold.tokens}")

    def summary_of(out):
        st = out["stats"]
        return {"goodput_tok_per_s": st["goodput_tokens_per_s"], "tokens": st["tokens"],
                "wall_s": st["wall_s"], "ttft_p50_ms": out["ttft"]["p50"] * 1e3,
                "ttft_p99_ms": out["ttft"]["p99"] * 1e3, "tpot_p50_ms": out["tpot"]["p50"] * 1e3,
                "tpot_p99_ms": out["tpot"]["p99"] * 1e3, "prefix_hit_rate": st["prefix_hit_rate"],
                "prefill_chunks": st["prefill_chunks"], "decode_steps": st["decode_steps"],
                "bursts": st["bursts"], "slot_occupancy": st["slot_occupancy"]}

    # whether the twin, admitted alone, also gave the tokens the request got
    # when it was served in a group of lanes (lane-count independence of the
    # products; reported, not required)
    summary = {"greedy": summary_of(greedy), "sampled": summary_of(sampled),
               "first_token_clear_rows": clear, "prefix_hit_twin_tokens": m,
               "hit_twin_equals_served_stream": s_warm.tokens == hit.tokens,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"[stream] first greedy token agrees with the plain path in {agree}/{clear} clear "
          f"rows of {N_REQUESTS}; a {m}-token prefix hit gave the cold run's "
          f"{len(s_cold.tokens)} tokens", flush=True)

    # where the host's time goes: one more greedy replay with the engine's
    # spans recorded (serving/admit holds serving/prefill; serving/burst
    # holds the decode steps, each ending in the host read of the exit rule)
    from repro_torch.obs import Tracer, set_tracer

    eng = greedy["engine"]
    eng.reset_stats()
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(serve.workload(stream_args(serve, 0.0)), realtime=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        set_tracer(prev)
    span_ms = {}
    for ev in tracer.to_events():
        if ev["ph"] == "X":
            span_ms[ev["name"]] = span_ms.get(ev["name"], 0.0) + ev["dur"] / 1e3
    summary["spans"] = {"replay_ms": wall_ms, **{f"{k}_ms": v for k, v in span_ms.items()},
                        "burst_ms_per_decode_step": span_ms["serving/burst"] / eng.decode_steps,
                        "prefill_ms_per_chunk": span_ms["serving/prefill"] / eng.prefill_chunks,
                        "decode_steps": eng.decode_steps, "prefill_chunks": eng.prefill_chunks,
                        "bursts": eng.bursts}

    print(json.dumps({"streaming": summary}), flush=True)

    def profile_job():
        reqs = serve.workload(stream_args(serve, 0.0), rid_offset=10 * N_REQUESTS)
        eng.reset_stats()
        busy_ms, prof_ms = busy_share(torch, lambda: eng.serve(reqs, realtime=False),
                                      ROOT / "build" / "profile_streaming.txt")
        print(json.dumps({"profile_streaming": {
            "device_busy_ms": busy_ms, "profiled_replay_ms": prof_ms, "replay_ms": wall_ms,
            "device_busy_share": busy_ms / wall_ms, "decode_steps": eng.decode_steps}}),
              flush=True)

    return counts, summary, profile_job


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.rl.rollout import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device and build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    build_s = _build.build_all()
    for name in _build.KERNELS:
        log = (_build.BUILD_DIR / f"{name}.log")
        lines = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln] if log.exists() else []
        print(f"[build] {name}: " + " | ".join(lines), flush=True)
    print(f"[build] {len(_build.KERNELS)} kernels built in {build_s:.1f}s (nvcc, sm_90a)",
          flush=True)

    # ---- phase 2: kernels against their plain versions ----
    records = kernel_phase(torch, ops, ref, F)

    # ---- phases 3 and 4: the two serving paths end to end, each with the
    # launch counters set to 0 just before it and read just after ----
    model, params, tok = build_model(torch, serve)
    lockstep = end_to_end_phase(torch, ops, _build, serve, generate, model, params, tok)
    streaming = streaming_phase(torch, ops, _build, serve, model, params, tok)
    paths = {"lockstep": lockstep[0], "streaming": streaming[0]}
    if opts.profile:
        # last, so that no timed phase runs in a process that
        # torch.profiler has traced
        lockstep[2]()
        streaming[2]()
    on_path = {"lockstep": ("rmsnorm", "flash_attention", "decode_attention", "fused_sample"),
               "streaming": ("rmsnorm", "flash_attention", "paged_decode_attention",
                             "fused_sample")}
    for path, names in on_path.items():
        require(all(paths[path][n] > 0 for n in names),
                f"a kernel of the {path} path was not launched: {paths[path]}")

    sources = {"rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:42"),
               "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:135"),
               "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:349"),
               "paged_decode_attention": ("paged_decode_attention.cu",
                                          "src/repro/kernels/decode_attention.py:453"),
               "fused_sample": ("sampling.cu", "src/repro/kernels/sampling.py:181")}
    kernels = []
    for name, rec in records.items():
        src, replaces = sources[name]
        # launches: the streaming path's count (the system's default path)
        # where it runs the kernel, else the lockstep path's
        path = "streaming" if name in on_path["streaming"] else "lockstep"
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
                 "launches": paths[path][name], "launches_path": path,
                 "launches_by_path": {p: c[name] for p, c in paths.items()}, **rec}
        print(json.dumps(entry), flush=True)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
