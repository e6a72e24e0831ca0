#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one card, no
arguments). It needs no JAX and no network, and builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use.

Phases (any mismatch or error raises, and the run exits non-zero):
  1. Device: the card's name and power limit (``nvidia-smi``), the build.
  2. Kernels: each of the four kernels of the lockstep serving path against
     its plain PyTorch version on the card, at the full gemma-2b shapes of
     that path (B=8, prompt 128, max_new 32), timed beside the plain version
     and one PyTorch call as a yardstick (never called by the port).
  3. End to end: ``repro_torch.launch.serve`` lockstep at full gemma-2b width
     and depth with random weights, greedy then temperature 0.8; the launch
     counters must show every kernel on the path, the tokens must be in
     range and repeatable, and the kernel path must agree with the plain one.

Output: the nvidia-smi line, JSON lines per kernel, a ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``. Without CUDA,
or outside a checkout, it exits non-zero before printing any result.

``--profile`` also writes a torch.profiler table of one greedy generate to
``build/profile.txt``.
"""
from __future__ import annotations

import argparse
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


def end_to_end_phase(torch, ops, _build, serve, generate, profile: bool):
    """Full gemma-2b lockstep serving on the card, through its entry points.
    Returns (launch counts of the greedy run, summary)."""
    args = serve_args(serve, 0.0)
    t0 = time.perf_counter()
    model, params, tok = serve.setup(args)
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"[e2e] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.padded_heads} heads (padded from {cfg.num_heads}) of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; weights drawn in "
          f"{time.perf_counter() - t0:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    L, steps, gens = cfg.num_layers, MAX_NEW - 1, TIMED_BATCHES + 1
    expected = {"rmsnorm": gens * (2 * L + 1) * (1 + steps),
                "flash_attention": gens * L,
                "decode_attention": gens * L * steps,
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

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_s = gen_s(MAX_NEW)
        # device time of the kernels themselves (the operator rows of the
        # table repeat their kernels' time, so they are not summed)
        busy_us = sum(e.device_time_total for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        events = prof.key_averages()
        table = events.table(sort_by="self_device_time_total", row_limit=40)
        (ROOT / "build").mkdir(exist_ok=True)
        (ROOT / "build" / "profile.txt").write_text(table)
        print(table[:8000], flush=True)
        print(json.dumps({"profile": {
            "device_busy_ms": busy_us / 1e3, "profiled_generate_ms": wall_s * 1e3,
            "generate_ms": full * 1e3, "device_busy_share": busy_us / 1e6 / full}}),
              flush=True)
    return counts, summary


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

    # ---- phase 3: the serving path end to end ----
    counts, _ = end_to_end_phase(torch, ops, _build, serve, generate, opts.profile)
    require(all(counts[n] > 0 for n in records), f"a kernel was not launched: {counts}")

    sources = {"rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:42"),
               "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:135"),
               "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:349"),
               "fused_sample": ("sampling.cu", "src/repro/kernels/sampling.py:181")}
    kernels = []
    for name, rec in records.items():
        src, replaces = sources[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
                 "launches": counts[name], **rec}
        print(json.dumps(entry), flush=True)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
