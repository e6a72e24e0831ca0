"""Serving entry point of the PyTorch port: lockstep batches (port of the
``--lockstep`` path of ``repro.launch.serve``).

Requests are grouped into one-shape batches and answered by ``generate()``:
prefill, then fused decode + sample steps, with the kernels of
``repro_torch.kernels`` on the GPU. One untimed warm-up batch builds the
kernels and warms the allocator; the timed batches feed a batch-latency
histogram for the p50/p99 report. The weights are random, drawn from
``--seed`` (gemma-2b at its full width and depth by default).

The streaming engine (``ServingEngine``) is not ported yet: without
``--lockstep`` this raises.

Usage:
  python -m repro_torch.launch.serve --lockstep --batch 8 --prompt-len 128 --max-new 32
  python -m repro_torch.launch.serve --smoke --lockstep --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import get_model
from repro_torch.obs import MetricsRegistry
from repro_torch.rl.rollout import generate


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (2 layers, d_model 64) for a CPU run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--lockstep", action="store_true",
                    help="fixed-batch serving (the only mode ported)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=3,
                    help="timed batches to serve")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="repeat each byte prompt to this many tokens (0: as is)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    return ap.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available here; pass --device cpu "
            "to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def setup(args: argparse.Namespace):
    """(model, params, tokenizer) for the parsed flags: random weights drawn
    from ``--seed`` on ``--device``."""
    if not args.lockstep:
        raise NotImplementedError(
            "streaming engine not yet ported (ROADMAP queue 1, item 6: streaming serving); "
            "pass --lockstep")
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
    device = model.device
    texts, ids = prompts(tok, args.batch, args.prompt_len)
    prompt = torch.from_numpy(ids).to(device)

    def one_batch(r: int):
        gen = torch.Generator(device=device).manual_seed(args.seed + r + 1)
        res = generate(model, params, prompt, gen, max_new=args.max_new,
                       temperature=args.temperature, eos_id=tok.eos_id)
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


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    model, params, tok = setup(args)
    return run_lockstep(model, params, tok, args)


if __name__ == "__main__":
    main()
