"""Serving entry point of the PyTorch port (port of ``repro.launch.serve``):
the request-streaming server by default, lockstep batches with
``--lockstep``.

The default path runs :class:`repro_torch.serving.ServingEngine` over a
synthetic Poisson arrival stream: requests stream token deltas as they
decode, share prompt KV through the radix prefix cache, and decode on the
page pool through the paged flash-decode kernel. One untimed replay of the
same workload first builds the kernels and warms the allocator, then the
counters reset and the second replay is timed. ``--lockstep`` groups
requests into one-shape batches answered by ``generate()`` (one untimed
warm-up batch, then timed batches for the p50/p99 report).

The weights are random, drawn from ``--seed`` (gemma-2b at its full width
and depth by default), on ``--device`` (``cuda`` unless the CPU is asked
for; without CUDA it raises).

Usage:
  python -m repro_torch.launch.serve --num-requests 32 --slots 8 --max-len 256 --max-new 64
  python -m repro_torch.launch.serve --smoke --device cpu
  python -m repro_torch.launch.serve --lockstep --batch 8 --prompt-len 128 --max-new 32
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import ServingConfig, get_config, reduced
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import get_model
from repro_torch.models.api import resolve_device
from repro_torch.obs import MetricsRegistry
from repro_torch.rl.rollout import generate
from repro_torch.serving import ServingEngine, synthetic_requests


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (2 layers, d_model 64) for a CPU run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--max-new", type=int, default=16)
    # streaming knobs
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--burst", type=int, default=8)
    ap.add_argument("--yield-quota", type=int, default=0)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--no-realtime", action="store_true",
                    help="enqueue all arrivals up front (max pressure)")
    # lockstep knobs
    ap.add_argument("--lockstep", action="store_true",
                    help="fixed-batch driver instead of the streaming engine")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=3,
                    help="timed batches to serve (lockstep)")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="repeat each byte prompt to this many tokens (0: as is)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(model, params, tokenizer) for the parsed flags: random weights drawn
    from ``--seed`` on ``--device``."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg, vocab_size=260, num_layers=2)
    model = get_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    return model, params, ByteTokenizer()


def prompts(tok: ByteTokenizer, batch: int, prompt_len: int):
    """The byte prompts ``"00+01="``, ``"01+02="``, ...; with ``prompt_len``
    each is repeated (and cut) to that many tokens."""
    texts = [f"{i:02d}+{i + 1:02d}=" for i in range(batch)]
    ids = [tok.encode(t) for t in texts]
    if prompt_len:
        ids = [np.resize(x, prompt_len) for x in ids]
    return texts, np.stack(ids)


def run_lockstep(model, params, tok: ByteTokenizer, args) -> Dict[str, Any]:
    """Serve ``args.requests`` timed batches after one warm-up batch. Returns
    the counted tokens, the rate, the batch-latency percentiles and every
    batch's ``RolloutResult`` (the warm-up's first)."""
    device, cfg = model.device, model.cfg
    texts, ids = prompts(tok, args.batch, args.prompt_len)
    prompt = torch.from_numpy(ids).to(device)
    # zero modality inputs, as the JAX package's launch.serve passes: an
    # enc-dec model's frames (generate refuses it: it has no fused sampler)
    # and a VLM's prefix embeddings
    kw = {}
    if cfg.is_encoder_decoder:
        kw["frames"] = torch.zeros((args.batch, cfg.encoder_len, cfg.d_model),
                                   dtype=torch.bfloat16, device=device)
    if cfg.num_prefix_embeds > 1:
        kw["prefix_embeds"] = torch.zeros((args.batch, cfg.num_prefix_embeds, cfg.d_model),
                                          dtype=torch.bfloat16, device=device)

    def one_batch(r: int):
        gen = torch.Generator(device=device).manual_seed(args.seed + r + 1)
        res = generate(model, params, prompt, gen, max_new=args.max_new,
                       temperature=args.temperature, eos_id=tok.eos_id, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return res

    results = [one_batch(-1)]  # warm-up, untimed
    Lp = prompt.shape[1]
    for text, row in zip(texts, results[0].tokens.cpu().numpy()):
        print(f"[serve] {text!r} -> {tok.decode(row[Lp:])!r}")

    served = 0
    hist = MetricsRegistry().histogram("serve/batch_latency_s")
    t0 = time.perf_counter()
    for r in range(args.requests):
        tb = time.perf_counter()
        res = one_batch(r)
        hist.record(time.perf_counter() - tb)
        served += int(res.lengths.sum())
        results.append(res)
    dt = time.perf_counter() - t0
    p = hist.percentiles((50, 99))
    print(f"[serve] {served} tokens in {dt:.3f}s ({served / dt:.1f} tok/s on "
          f"{device}, warm-up excluded; batch latency p50 {p['p50'] * 1e3:.2f}ms "
          f"p99 {p['p99'] * 1e3:.2f}ms)")
    return {"tokens": served, "seconds": dt, "tok_per_s": served / dt,
            "p50_s": p["p50"], "p99_s": p["p99"], "results": results}


def serving_config(args) -> ServingConfig:
    return ServingConfig(
        num_slots=args.slots, max_len=args.max_len, max_new=args.max_new,
        page_size=args.page_size, prefix_cache=not args.no_prefix_cache,
        decode_burst=args.burst, yield_quota=args.yield_quota)


def workload(args, rid_offset: int = 0):
    """The synthetic request stream of the flags (numpy, from ``--seed``)."""
    reqs = synthetic_requests(
        args.num_requests, arrival_rate=args.rate, page_size=args.page_size,
        max_new=args.max_new, temperature=args.temperature, seed=args.seed)
    for r in reqs:
        r.rid += rid_offset
    return reqs


def run_streaming(model, params, tok: ByteTokenizer, args) -> Dict[str, Any]:
    """Request-streaming serving over a synthetic Poisson arrival stream:
    one untimed replay of the workload (kernel builds, allocator), a reset,
    then the timed replay. Returns the engine's stats of the timed replay
    and of the warm-up, the TTFT/TPOT percentiles of the timed replay, its
    streams and the engine."""
    eng = ServingEngine(model, serving_config(args), params=params, eos_id=tok.eos_id,
                        seed=args.seed, registry=MetricsRegistry())
    eng.serve(workload(args, rid_offset=-args.num_requests), realtime=False)
    warmup_stats = eng.stats()
    eng.reset_stats()
    eng.registry = MetricsRegistry()  # drop the warm-up's latencies too

    streams = eng.serve(workload(args), realtime=not args.no_realtime)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    st = eng.stats()
    ttft = eng.registry.histogram("serving/ttft_s").percentiles((50, 99))
    tpot = eng.registry.histogram("serving/tpot_s").percentiles((50, 99))
    print(f"[serve] {int(st['requests_finished'])} requests, "
          f"{int(st['tokens'])} tokens, "
          f"goodput {st['goodput_tokens_per_s']:.1f} tok/s on {model.device}")
    print(f"[serve] TTFT p50 {ttft['p50'] * 1e3:.1f}ms "
          f"p99 {ttft['p99'] * 1e3:.1f}ms | per-token p50 "
          f"{tpot['p50'] * 1e3:.1f}ms p99 {tpot['p99'] * 1e3:.1f}ms")
    print(f"[serve] prefix-cache hit rate {st['prefix_hit_rate']:.0%} "
          f"({int(st['prefix_hit_tokens'])} of {int(st['prompt_tokens'])} "
          f"prompt tokens), occupancy {st['slot_occupancy']:.0%}, "
          f"parks {int(st['parks'])}, pool pages {int(st['pool_pages_used'])}")
    done = sum(s.finished for s in streams)
    if done != len(streams):
        print(f"[serve] WARNING: {len(streams) - done} streams unfinished")
    return {"stats": st, "warmup_stats": warmup_stats, "ttft": ttft, "tpot": tpot,
            "streams": streams, "engine": eng}


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    model, params, tok = setup(args)
    if args.lockstep:
        return run_lockstep(model, params, tok, args)
    return run_streaming(model, params, tok, args)


if __name__ == "__main__":
    main()
