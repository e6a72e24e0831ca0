#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one card, no
arguments). It needs no JAX and no network, and builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use.

Phases (any mismatch or error raises, and the run exits non-zero):
  1. Device: the card's name and power limit (``nvidia-smi``), the build of
     the seven kernels.
  2. Kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the serving paths, timed beside the plain version and
     one PyTorch call as a yardstick (never called by the port): gemma-2b
     (lockstep: B=8, prompt 128, max_new 32; streaming: 8 slots, pages of
     16, 256 positions, prefill chunks of 16 queries at an offset; the int8
     cache of 160 slots), and mamba2-2.7b (the SSD scan of an 8 x 128
     prefill and of a four-chunk sequence, norms over 2560 and 5120 at the
     prefill's rows and the decode step's, the sampler over a 50,432-row
     head). The norm is also held at even widths that are not multiples of
     8 and at widths too wide for its registers; the SSD scan at jamba's
     widths (state 16), in two groups, at other states and chunk lengths,
     under a strongly decaying dt, and on two launches. The three split-KV
     decode kernels are
     also held at the edges of their splits (lengths around split
     boundaries, windows, a row with no live key), and every attention
     kernel must give the same bits on two launches. The sampler is also
     held at B = 1, 5, 13, 64 and 100, on exact greedy ties placed across
     its warps, tiles and blocks, at vocab tails, and on two launches, and
     timed at B = 64 as well; and on qwen2.5-7b's untied head as it lies,
     (3584, 152,064) with the vocab contiguous, at B = 8 and 64: tokens
     bit-equal to the plain version's, greedy ties across tiles and
     blocks, two launches bit-identical, timed beside ``h @ lm_head``.
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
  5. The int8 KV cache: phase 3 on the same weights with ``kv_quant=True``
     (``generate`` through ``serve.run_lockstep``); the decode steps must go
     through the fused-dequant kernel and never the bf16 one.
  6. mamba2-2.7b end to end: ``serve --arch mamba2-2.7b --lockstep`` at full
     width on 16 of its 64 SSD layers (``MAMBA2_LAYERS``; the depths of
     phases 6, 9, 13 and 14 are cut to keep the script inside its time
     limit), the checks of phase 3; the scan kernel
     once per layer and prefill, no attention kernel. The gemma-2b weights
     are freed before mamba2's are drawn.
  7. Training, on full gemma-2b again (mamba2 freed), in the order of
     ``rl.algorithms.grpo_dag``: 3 GRPO iterations (2 math prompts x 8
     rollouts of 16 new tokens, the default ``RLConfig``: generate ->
     reference logprobs -> math reward -> GRPO advantage -> actor step),
     each iteration's launches held to its expected count (the actor step's
     remat recompute included); then on the lockstep shape's rollouts
     (B=8, prompt 128, 32 new) the training engine's logprobs against the
     sampler's (step-0 ratio_mean within 1 +- 0.02), the gradient check
     (kernel path against ``ops.set_mode("ref")``: a finite, nonzero grad on
     every leaf; the loss at 2e-2; each leaf's relative L2 error and cosine
     within 2x the plain path's own drift when its attention keeps the
     probabilities in fp32), a decode kernel refusing an input that
     requires grad, one actor step timed in parts (forward with remat,
     backward, clip + AdamW) with tokens/s and peak memory, and
     ``flash_attention`` and ``rmsnorm`` at the training shapes, with the
     plain-VJP backwards beside SDPA's and ``F.rms_norm``'s.
  8. The GRPO pipeline, phase 7's model freed: ``repro_torch.launch.train``
     called in-process at full gemma-2b width and depth, random weights from
     ``--seed 0``, phase 7's shape (2 prompts x 8 rollouts of 16 new
     tokens), one warm-up iteration then 2 timed ones, through the DAG
     worker over the databuffer and the dataloader. One experiment file
     (``--dump-experiment``, then ``--experiment``): the default
     ``RLConfig`` but an entropy bonus of 0.01 and lr 1e-4, so that every
     actor step has a gradient and moves the weights. Three coordinator
     arms, their flags layered on the file, one after another, each
     pipeline freed before the next: distributed (run twice, for the
     run-to-run spread), double buffer + prefetch 1, and the centralized
     baseline. Every iteration's launches must equal phase 7's count, every
     metric be finite, ratio_mean within 1 +- 0.02, the gradient nonzero,
     the KL against the reference nonzero from iteration 1 and some actor
     weights changed; iteration 0 must be bitwise equal across the arms and
     later iterations within the distributed arm's own spread; the buffer
     counts must equal a CPU run's of the same DAG and iterations. Prints
     each arm's synchronised iteration time, the worker's ``time/<node>``
     medians, the controller bytes of the centralized arm and the
     dataloader's prefetch hits, beside phase 7's hand-composed iteration.
     Then one arm more on the same file: ``--rollout-slots 4``, the
     continuous rollout engine at the GENERATE stage (16 rollouts over 4
     slots), its first iteration held to plain and every iteration's
     launches equal to the engine's prefills and decode steps.
  9. mamba2-2.7b training at full width on 16 layers (gemma freed): GRPO through
     ``launch.train --arch mamba2-2.7b`` with phase 8's experiment file and
     checks, distributed twice then centralized (the scan under autograd in
     every actor step and its remat recompute); then on lockstep rollouts of
     B=8 x (96 + 32) the gradient check (kernel path against
     ``ops.set_mode("ref")``, within 2x the plain path's drift at chunk 64
     against chunk 128; step-0 ratio within 1 +- 0.02), one actor step at
     B=2 x S=2,048 (16 chunks; its warm-up held to plain) timed in parts,
     and the scan at both training shapes with ``SSDFn``'s plain-VJP
     backward, and the norms at mamba2's training shapes.
 10. PPO on gemma-2b: ``launch.train --algorithm ppo`` with phase 8's file
     and a critic lr of 1e-4, distributed twice then centralized, with
     phase 8's checks and a finite critic loss, a nonzero critic gradient
     and some critic weights changed; reports the critic's stage times and
     the peak memory of actor, reference, critic and two sets of moments.
 11. The continuous rollout engine on qwen2.5-7b at full width on 4 of its
     28 layers (28 query heads on 4 KV heads of 128, an untied head;
     PPO's models freed): with one slot a prompt and one bucket, sampled,
     its tokens, masks and lengths bit-equal to lockstep ``generate``'s
     from one seed; then 32 ragged prompts (true lengths 32-128, padded to
     128; budgets 8-128; 128 new at most; buckets of 32) through lockstep,
     the engine with one slot a prompt (early exit only) and with 16 slots
     (refill): response tokens/s, decode steps, ``lockstep_waste``, slot
     occupancy and wall ms, medians of 2 after a warm-up (3 until phase 18
     came, to keep the script inside its time); the kernel path
     against the plain path; the refill arm's launches equal to its
     prefills and decode steps.
 12. The async off-policy pipeline and multi-turn episodes (qwen freed):
     ``launch.train`` at full gemma-2b width on phase 8's experiment file
     and RL settings, one warm-up and 2 timed iterations an arm, each arm's
     warm-up held to plain and its launches checked per iteration: a
     synchronous arm and ``--max-staleness 0``, bitwise equal (metrics,
     rollouts, a bit checksum of every actor leaf); ``--max-staleness 1``,
     its staleness and weight versions, and each dispatch's behaviour
     weights byte for byte the copy saved at the previous publish, not the
     live weights an in-place AdamW step wrote; a GRPO variant with the
     truncated-IS correction at staleness 1, its recomputed ``old_logprob``
     held to the plain path's and its IS weights in (0, ``is_rho_max``];
     and ``--env dialog --max-turns 3 --turn-budget 8 --rollout-slots 4
     --max-staleness 1``: exact turn, observation and carried-token counts,
     observation tokens out of ``response_mask``, continuations through
     ``decode_attention`` at each row's own offset.
 13. The MoE family (the async models freed), each model freed before the
     next is drawn: granite-moe-3b-a800m at full width on 8 of its 32
     layers (40 experts of 512, top-8, 24 heads padded to 32 on 8 KV heads
     of 64, a tied head of 49,408) through ``serve --arch
     granite-moe-3b-a800m --lockstep`` with phase 3's checks (routes flip
     between the kernel and the plain path and the flips compound, so the
     routes that flip are counted per layer, the free-running logits are
     held to 2x the plain path's drift from itself row by row, and the
     kernel path to the plain path layer by layer, as mamba2's), one
     generate held to plain call by call,
     each kernel timed on its own inputs at the path's shapes, one MoE
     layer at decode (8 tokens) and prefill (1,024) beside its bounds, and
     ``model.loss`` at 8 x 160 (finite ``moe_aux``, the plain path's loss
     at 2e-2); GRPO through ``launch.train --arch granite-moe-3b-a800m`` on
     phase 8's experiment file, distributed arm (warm-up held to plain, 3
     timed iterations, phase 8's checks, peak GiB); then mixtral-8x7b at
     full width and 4 of its 32 layers (its 93 GB of bf16 weights exceed
     the card): two greedy generates of B = 2 with the window of 4,096,
     a prompt of 4,080 (the ring wraps at decode step 16) and of 4,352 (the
     prefill keeps the last 4,096 tokens, the window cuts the last 256
     queries), held to plain call by call, and ``logprobs_fn`` over each
     whole sequence against the sampler's logprobs (step-0 ratio within
     1 +- 0.02; the full forward's argmax equal to the greedy token where
     the top two are clear by 0.05 and no route of the row flipped up to
     that position).
 14. The remaining families (the MoE models freed), each model freed before
     the next is drawn: nemotron-4-15b at full width on 8 of its 32 layers, command-r-
     plus-104b at full width on 4 of its 64 layers, seamless-m4t-medium
     (serving and one training step) and llava-next-34b on 8 of its 60
     layers at B = 1 behind
     2,880 prefix embeddings (``families_phase`` says what each is held to).
 15. Checkpoints and telemetry (``ckpt_phase``): ``launch.train`` at full
     gemma-2b width on 2 of its 18 layers (phase 8's experiment file cut to
     that depth, to keep the script inside its time limit) saves its
     ``TrainState`` after 2 iterations with the trace and the metrics file
     on (run A), resumes from it (run B, and run C at ``--max-staleness
     1``): the restored state bit for bit A's in the template's own tensors,
     the resumed iteration held to phase 8's checks, the async worker's
     first dispatch on the restored weights, the JSONL and the Chrome trace
     complete; save and restore timed, the peak host RSS.
 16. The data-parallel fleet (``fleet_phase``, gemma freed): ``launch.train``
     on phase 8's experiment file at gemma-2b's full width on 2 of its 18
     layers (two full-depth hosts do not fit one card), each host a process
     of its own on the card (``chip_smoke.py --fleet-host``), 3 iterations:
     a solo run, 2 hosts exchanging exact fp32 gradients over a coordinator
     directory under ``build/`` (params bit for bit the solo run's, metrics
     equal but the fleet's and the wall times, the trace's fleet spans and
     the straggler report over both hosts), and 2 hosts on int8 with error
     feedback (bit for bit each other, the last loss within 5e-3 of the
     exact arm's, under 0.3 of its wire bytes, the encode on the card bit
     for bit the CPU's); every host launches the solo run's kernels. Prints
     the iteration and exchange ms, wire GB/s and peaks of each host.
 17. The sharding layer over ``torch.distributed`` (``sharding_phase``):
     two ranks on the card in one gloo group, each a process of its own
     (``chip_smoke.py --shard-rank``). A: ``launch.train --coordinator
     127.0.0.1:PORT --num-hosts 2 --process-id r`` on phase 16's file,
     data-parallel GRPO with FSDP state for 3 iterations (launches of every
     iteration, no byte through a controller, the final params against
     phase 16's solo run); C: ``publish(mesh=, target_specs=)`` of the final
     shards (bit for bit, the bytes ``switch_bytes`` counts); B: the
     sequence-sharded ``decode_attention`` at deepseek-67b's decode widths
     (64 heads on 8 of 128, 32,768 slots over the ranks, B = 8, bf16)
     against the one-rank kernel and the plain version. Prints the
     iteration, all-gather and reduce-scatter ms and bytes, the peaks, and
     the decode's kernel, gather and merge ms, beside the plain version's
     and one SDPA call's ms at a rank's slots and at the whole cache.
 18. Tensor-parallel model stages (``tp_phase``). A: the vocab-sharded
     ``fused_sample`` on 2 shards of gemma-2b's tied head (B = 8 and 64)
     and qwen2.5-7b's untied head (B = 8), each shard's state (``col_offset``,
     ``state=True``) merged in rank order, against the one-device kernel:
     tokens bit for bit, with a tie across the shard boundary. B: two ranks
     of one gloo group on the card (``chip_smoke.py --tp-rank``) on a
     (data 1, model 2) mesh: ``launch.train --coordinator 127.0.0.1:PORT``
     on phase 16's file with ``"mesh_shape": [1, 2]``, 3 GRPO iterations
     (launches of every iteration; against phase 16's solo run; the
     replicated leaves bit for bit across the ranks; a fixed batch's
     logprobs and every leaf's gradient on the shards against one device).
     Prints each rank's iteration ms, collectives' calls, ms and bytes, the
     peaks, and the sampler's kernel, gather and merge ms.
 19. Tensor-parallel MoE and SSD layers (``tp_moe_ssd_phase``). A: the
     sharded gated norm's two entries (``rmsnorm_sumsq``, ``rmsnorm_scaled``)
     at mamba2's and jamba's shard widths, and the scan on 40 and 64 heads,
     each against its plain version and timed. B: granite-moe-3b and then
     mamba2-2.7b at full width on 2 layers, each a solo run and two ranks of
     one gloo group on the card on a (data 1, model 2) mesh (both models'
     worlds at once), 3 GRPO
     iterations, held as phase 18 holds its run (granite's tokens whose
     route flips left out of the logprob hold, and counted).
 20. Tensor-parallel stages of the remaining families (``tp20_phase``):
     gemma-2b's int8 cache through ``launch.train``, then mixtral's ring,
     llava's prefix, seamless's encoder-decoder and nemotron's ``top_p`` in
     the same two ranks.
 21. The continuous rollout engine on tensor-parallel ranks
     (``tp21_phase``): qwen2.5-7b's GRPO with chunked refills, the engine's
     calls directly and a dialog iteration, against solo runs.
 22. The staleness-bounded async pipeline on a rank mesh (``tp22_phase``):
     in one world of two ranks (``chip_smoke.py --tp22-rank``), phase 18's
     gemma-2b synchronous and at ``--max-staleness`` 0 and 1 (and under
     truncated IS) on a (1, 2) mesh, then granite-moe-3b at staleness 1 on
     a (2, 1) mesh: staleness 0 bit for bit the synchronous arm, versions
     exact on both ranks, generation on the published copies, the
     recompute and the logprobs against one device, every consume on its
     own rows, launches of every iteration.

Output: the nvidia-smi line, JSON lines per kernel and per phase, a
``{"kernels": [...]}`` line, and as the last line ``{"ok": true, "device":
{...}}``. Without CUDA, or outside a checkout, it exits non-zero before
printing any result.

``--profile`` also writes torch.profiler tables of one greedy generate of
each lockstep path, of one greedy streaming replay and of one actor step to
``build/profile*.txt``, and prints the device-busy share of each. The
profiles run last, and keep the serving models alive until then; the
actor step's profile draws its training state again when it runs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
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
MAMBA2_FLAGS = ["--arch", "mamba2-2.7b"]
B, PROMPT, MAX_NEW = 8, 128, 32
SMAX = PROMPT + MAX_NEW
D_MODEL, VOCAB, HEADS, REAL_HEADS, HEAD_DIM = 2048, 256_000, 16, 8, 256
# timed batches a lockstep run (a warm-up first; 4 before the script outgrew
# its time limit, cut with the depths below)
TIMED_BATCHES = 2
# the streaming path: the engine's ServingConfig and its synthetic workload
SLOTS, MAX_LEN, STREAM_NEW, PAGE, N_REQUESTS = 8, 256, 64, 16, 32
STREAM_FLAGS = ["--slots", str(SLOTS), "--max-len", str(MAX_LEN), "--max-new", str(STREAM_NEW),
                "--page-size", str(PAGE), "--num-requests", str(N_REQUESTS), "--rate", "20",
                "--no-realtime"]

# the mamba2-2.7b lockstep path (configs/mamba2_2_7b.py): 64 SSD layers of
# 80 heads of 64, state 128, one group, vocab 50,280 tied
M_D_MODEL, M_HEADS, M_HEADDIM, M_STATE, M_VOCAB = 2560, 80, 64, 128, 50_280
# the depths at which phases 6, 9, 13 and 14 draw their models (full width;
# full depth before the script outgrew its time limit): mamba2-2.7b on 16
# of its 64 layers, granite-moe-3b on 8 of 32,
# nemotron-4-15b on 8 of 32, llava-next-34b on 8 of 60
MAMBA2_LAYERS, GRANITE_LAYERS, NEMOTRON_LAYERS, LLAVA_LAYERS = 16, 8, 8, 8
# qwen2.5-7b (configs/qwen2_5_7b.py): 28 layers, d_model 3584, 28 query heads
# on 4 KV heads of 128, d_ff 18,944, an untied lm_head (3584, 152,064)
QWEN_FLAGS = ["--arch", "qwen2.5-7b"]
Q_D_MODEL, Q_VOCAB = 3584, 152_064

BF16_TOL = 2e-2
SSD_Y_TOL = 5e-2  # y is bf16: tests/test_kernels.py's bf16 tolerance for ssd
SSD_STATE_TOL = 1e-3
LSE_TOL = 1e-3
LOGPROB_TOL = 1e-3
SAMPLE_GAP = 1e-4
# mamba2's free-running kernel-path logits may drift from the plain path's at
# most this many times as far as the plain path drifts from itself at chunk
# 64 (the full model on an H100 measured 0.258 against 0.242, a ratio of 1.07);
# granite-moe-3b's as far as the plain path drifts from itself row by row
# (0.2031 against 0.1797, a ratio of 1.13)
DRIFT_FACTOR = 2.0


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
    # the edge cases of the tensor-core flash and split-KV bodies draw from
    # their own generator, so that every timed input keeps its draw from gen
    edge_gen = torch.Generator(device=DEV).manual_seed(4321)
    dev = DEV

    def randn(*shape, scale=1.0, dtype=torch.bfloat16, g=gen):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

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
    # the mamba2-2.7b prefill: block norms over d_model 2560, gated norms over
    # d_inner 5120, 8 x 128 rows each
    for width in (M_D_MODEL, 2 * M_D_MODEL):
        R = B * PROMPT
        x, wm = randn(R, width), randn(width, scale=0.1, dtype=torch.float32)
        wml = (1.0 + wm).to(torch.bfloat16)
        ok, err = close(ops.rmsnorm(x, wm), ref.rmsnorm(x, wm), BF16_TOL)
        require(ok, f"rmsnorm {R}x{width}: max abs err {err}")
        bms, by = bound_ms(2 * R * width * 2 + width * 4, 4 * R * width, FP32_FLOP_PER_S)
        entry = {"shape": [R, width], "max_abs_err": err,
                 "ms": device_ms(lambda: ops.rmsnorm(x, wm)),
                 "plain_ms": device_ms(lambda: ref.rmsnorm(x, wm)),
                 "bound_ms": bms, "bound_by": by,
                 "library_ms": device_ms(lambda: F.rms_norm(x, (width,), weight=wml, eps=1e-6))}
        records["rmsnorm"][f"mamba2_d{width}"] = entry
        print(json.dumps({"check": f"rmsnorm/mamba2_d{width}", **entry}), flush=True)
    # from their own generator, so that every later input keeps its draw:
    # mamba2's decode rows (8 of 2560 and of 5120, timed), an odd row count,
    # even widths that are not multiples of 8 (the kernel's bf16-pair body),
    # and rows too wide for the registers (read twice)
    norm_gen = torch.Generator(device=DEV).manual_seed(2718)
    for R, width, timed in ((B, M_D_MODEL, True), (B, 2 * M_D_MODEL, True), (1001, 2054, False),
                            (8, 2050, False), (16, 13_000, False), (6, 6002, False)):
        x = randn(R, width, g=norm_gen)
        wm = randn(width, scale=0.1, dtype=torch.float32, g=norm_gen)
        ok, err = close(ops.rmsnorm(x, wm), ref.rmsnorm(x, wm), BF16_TOL)
        require(ok, f"rmsnorm {R}x{width}: max abs err {err}")
        if timed:
            wml = (1.0 + wm).to(torch.bfloat16)
            bms, by = bound_ms(2 * R * width * 2 + width * 4, 4 * R * width, FP32_FLOP_PER_S)
            entry = {"shape": [R, width], "max_abs_err": err,
                     "ms": device_ms(lambda: ops.rmsnorm(x, wm)),
                     "plain_ms": device_ms(lambda: ref.rmsnorm(x, wm)),
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": device_ms(lambda: F.rms_norm(x, (width,), weight=wml,
                                                                eps=1e-6))}
            records["rmsnorm"][f"mamba2_decode_d{width}"] = entry
            print(json.dumps({"check": f"rmsnorm/mamba2_decode_d{width}", **entry}), flush=True)
    print(json.dumps({"check": "rmsnorm/edges", "ok": True}), flush=True)

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
    # what the serving path does not use: no mask, a window, q_offset with Sk
    # past Sq + q_offset (the keys after the last query causally hidden), GQA,
    # a ragged Sq, the other head widths the kernel is built for (the first
    # three, from gen); then Sq ragged against the 64-row block (1, 77, 130),
    # GQA groups of 4 and 16, windows that start mid-tile, and q_offset with
    # K/V a strided view of longer rows, Sk short of Sq + q_offset (edge_gen)
    for sq, sk, h, kvh, hd, kw, strided, g in (
            (PROMPT, PROMPT, 8, 2, 64, {"causal": False}, False, gen),
            (PROMPT, PROMPT, 8, 2, 128, {"window": 48}, False, gen),
            (77, PROMPT, 8, 2, HD, {"q_offset": 32}, False, gen),
            (1, 40, 16, 1, HD, {"q_offset": 39}, True, edge_gen),
            (77, 96, 8, 2, HD, {"q_offset": 32}, True, edge_gen),
            (130, 130, 16, 1, 128, {}, False, edge_gen),
            (130, 130, 4, 1, HD, {"window": 40}, False, edge_gen),
            (PAGE, 3 * PAGE, 16, 1, 64, {"q_offset": 2 * PAGE}, True, edge_gen)):
        qq = randn(2, sq, h, hd, g=g)
        width = sk + 24 if strided else sk
        kk, vv = randn(2, width, kvh, hd, g=g)[:, :sk], randn(2, width, kvh, hd, g=g)[:, :sk]
        ok, err2 = close(ops.flash_attention(qq, kk, vv, **kw),
                         ref.flash_attention(qq, kk, vv, **kw), BF16_TOL)
        require(ok, f"flash_attention {kw} Sq={sq} Sk={sk} H={h} KVH={kvh} D={hd} "
                    f"strided={strided}: max abs err {err2}")
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
    # two launches on the same inputs give the same bits
    for args, kw in (((q, k, v), {}), ((qc, kch, vch), {"q_offset": OFF})):
        require(torch.equal(ops.flash_attention(*args, **kw), ops.flash_attention(*args, **kw)),
                f"flash_attention {kw}: two launches differ")
    print(json.dumps({"check": "flash_attention", **records["flash_attention"]}), flush=True)

    from repro_torch.kernels.split_rule import split_keys

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
    require(same_bits(lambda: ops.decode_attention(qd, kc, vc, lens)),
            "decode_attention: two launches differ")
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
    # the keys per split are the wrapper's own choice for this shape, shown on
    # the check line only (a computed number, not a measurement)
    print(json.dumps({"check": "decode_attention", **records["decode_attention"],
                      "split_keys": split_keys(B, H, KVH, SMAX)}), flush=True)

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
    # the split-KV edges, at each head width's own split: one key, a length
    # on a split boundary and one past it, the full table (stale entries
    # past every live span, as above)
    from repro_torch.kernels.split_rule import split_pages

    for hd, h, kvh in ((HD, H, KVH), (128, 8, 2), (64, 8, 2)):
        sk = split_pages(SLOTS, h, kvh, T, PAGE) * PAGE
        edge = torch.tensor([1, sk, sk + 1, T * PAGE, 2 * sk, 2 * sk + 1, sk - 1, 2],
                            dtype=torch.int32, device=dev)
        qq, pk, pv = (randn(SLOTS, h, hd, g=edge_gen), randn(P, PAGE, kvh, hd, g=edge_gen),
                      randn(P, PAGE, kvh, hd, g=edge_gen))
        a, b = (f(qq, pk, pv, tables, edge) for f in (ops.paged_decode_attention,
                                                      ref.paged_decode_attention))
        ok, err2 = close(a[0], b[0], BF16_TOL)
        ok_l, err2_l = close(a[1], b[1], LSE_TOL)
        require(ok and ok_l, f"paged_decode_attention D={hd} H={h} KVH={kvh} split {sk} keys, "
                             f"kv_len {edge.tolist()}: o err {err2}, lse err {err2_l}")
    # two launches on the same inputs give the same bits
    a = ops.paged_decode_attention(qp, pool_k, pool_v, tables, kv_len)
    b = ops.paged_decode_attention(qp, pool_k, pool_v, tables, kv_len)
    require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
            "paged_decode_attention: two launches differ")
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
    # the pages per split are the wrapper's own choice for this shape, shown
    # on the check line only (a computed number, not a measurement)
    print(json.dumps({"check": "paged_decode_attention", **records["paged_decode_attention"],
                      "split_pages": split_pages(SLOTS, H, KVH, T, PAGE)}), flush=True)

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
    records["fused_sample"]["mamba2"] = sampler_at(torch, ops, ref, randn, gen,
                                                    M_VOCAB, M_D_MODEL)
    # the new checks draw from their own generator, so every later kernel
    # keeps its inputs
    sample_gen = torch.Generator(device=DEV).manual_seed(777)
    records["fused_sample"]["b64"] = sampler_edges(
        torch, ops, ref, embed, lambda *shape: randn(*shape, g=sample_gen), sample_gen)
    untied_gen = torch.Generator(device=DEV).manual_seed(2121)
    records["fused_sample"].update(untied_sampler(
        torch, ops, ref, lambda *shape, **kw: randn(*shape, g=untied_gen, **kw), untied_gen))
    print(json.dumps({"check": "fused_sample", **records["fused_sample"]}), flush=True)

    # ---- decode attention over the int8 cache: the int8-KV lockstep step,
    # B=8, 16 padded heads, one KV head of 256, 160 slots, ragged lengths ----
    from repro_torch.models.lm import quant_kv

    kq, ksc = quant_kv(randn(B, SMAX, KVH, HD))
    vq, vsc = quant_kv(randn(B, SMAX, KVH, HD))
    lens_q = torch.randint(2, SMAX, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens_q[:4] = torch.tensor([1, SMAX // 2, PROMPT + 1, SMAX], device=dev)
    o_k, lse_k = ops.decode_attention_quant(qd, kq, vq, ksc, vsc, lens_q)
    o_r, lse_r = ref.decode_attention_quant(qd, kq, vq, ksc, vsc, lens_q)
    ok, err = close(o_k, o_r, BF16_TOL)
    ok_l, err_l = close(lse_k, lse_r, LSE_TOL)
    require(ok and ok_l, f"decode_attention_quant: o err {err}, lse err {err_l}")
    for n, kw, hd in ((lens_q, {"window": 40}, 64), (lens_q + 16, {"pos_offset": 16}, 128)):
        qq = randn(B, 8, hd)
        (kk, ks2), (vv, vs2) = quant_kv(randn(B, SMAX, 2, hd)), quant_kv(randn(B, SMAX, 2, hd))
        a = ops.decode_attention_quant(qq, kk, vv, ks2, vs2, n, **kw)
        b = ref.decode_attention_quant(qq, kk, vv, ks2, vs2, n, **kw)
        require(close(a[0], b[0], BF16_TOL)[0] and close(a[1], b[1], LSE_TOL)[0],
                f"decode_attention_quant {kw} D={hd}")
    require(same_bits(lambda: ops.decode_attention_quant(qd, kq, vq, ksc, vsc, lens_q)),
            "decode_attention_quant: two launches differ")
    live = int(lens_q.sum())
    nbytes = 2 * qd.numel() * 2 + B * H * 4 + live * KVH * (HD + 4) * 2
    bms, by = bound_ms(nbytes, 4 * H * HD * live, BF16_TENSOR_FLOP_PER_S)
    kdq = (kq.float() * ksc[..., None]).to(torch.bfloat16).transpose(1, 2)
    vdq = (vq.float() * vsc[..., None]).to(torch.bfloat16).transpose(1, 2)
    qmask = (torch.arange(SMAX, device=dev)[None, :] < lens_q[:, None])[:, None, None, :]
    records["decode_attention_quant"] = {
        "shape": {"q": list(qd.shape), "kv": list(kq.shape), "cache_len": lens_q.tolist()},
        "max_abs_err": err, "lse_max_abs_err": err_l,
        "ms": device_ms(lambda: ops.decode_attention_quant(qd, kq, vq, ksc, vsc, lens_q)),
        "plain_ms": device_ms(lambda: ref.decode_attention_quant(qd, kq, vq, ksc, vsc, lens_q)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(sdpa(qd[:, :, None], kdq, vdq, attn_mask=qmask)),
        "library_note": "SDPA on K/V dequantized beforehand (the dequantization not timed)"}
    print(json.dumps({"check": "decode_attention_quant", **records["decode_attention_quant"],
                      "split_keys": split_keys(B, H, KVH, SMAX)}), flush=True)
    split_decode_edges(torch, ops, ref, quant_kv, lambda *shape: randn(*shape, g=edge_gen))

    # ---- ssd: the mamba2-2.7b prefill (8 x 128 positions, one chunk) and a
    # four-chunk sequence that exercises the carried state ----
    rec = {}
    for tag, (Bs, S) in (("prefill", (B, PROMPT)), ("multi_chunk", (2, 512))):
        x = randn(Bs, S, M_HEADS, M_HEADDIM)
        dt = F.softplus(randn(Bs, S, M_HEADS, dtype=torch.float32))
        A = -torch.exp(randn(M_HEADS, dtype=torch.float32))
        Dd = randn(M_HEADS, dtype=torch.float32)
        Bm, Cm = randn(Bs, S, 1, M_STATE), randn(Bs, S, 1, M_STATE)
        y_k, h_k = ops.ssd(x, dt, A, Bm, Cm, Dd, return_state=True)
        y_r, h_r = ref.ssd_chunked(x, dt, A, Bm, Cm, Dd, chunk=min(128, S), return_state=True)
        ok, err = close(y_k, y_r, SSD_Y_TOL)
        ok_h, err_h = close(h_k, h_r, SSD_STATE_TOL)
        require(ok and ok_h, f"ssd {tag} {tuple(x.shape)}: y err {err}, state err {err_h}")
        L = min(128, S)
        blocks = Bs * M_HEADS * (S // L)
        flops = blocks * (L * (L + 1) // 2 * (2 * M_STATE + 2 * M_HEADDIM)
                          + 4 * L * M_STATE * M_HEADDIM)
        nbytes = (2 * x.numel() * 2 + h_k.numel() * 4 + dt.numel() * 4
                  + 2 * Bm.numel() * 2 + 2 * M_HEADS * 4)
        bms, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOP_PER_S)
        rec[tag] = {"shape": {"x": list(x.shape), "Bm": list(Bm.shape), "chunk": L},
                    "max_abs_err": err, "state_max_abs_err": err_h,
                    "ms": device_ms(lambda: ops.ssd(x, dt, A, Bm, Cm, Dd, return_state=True)),
                    "plain_ms": device_ms(lambda: ref.ssd_chunked(
                        x, dt, A, Bm, Cm, Dd, chunk=L, return_state=True)),
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "library_note": "no single PyTorch call computes the chunked scan"}
        require(same_bits(lambda: ops.ssd(x, dt, A, Bm, Cm, Dd, return_state=True)),
                f"ssd {tag}: two launches differ")
        print(json.dumps({"check": f"ssd/{tag}", **rec[tag], "flops": flops, "bytes": nbytes}),
              flush=True)
    records["ssd"] = {**rec["prefill"], "multi_chunk": rec["multi_chunk"]}
    ssd_edges(torch, ops, ref, F)
    return records


def ssd_edges(torch, ops, ref, F):
    """The SSD scan beyond mamba2's prefill, from its own generator: jamba's
    widths (128 heads, state 16) at one chunk and at four chunks of 64 in two
    groups, states 32 and 64, chunks of 40 and 24 (not multiples of the
    kernel's 16-position tiles), and mamba2's widths under a strongly decaying
    dt (exp(a_cum[i] - a_cum[j]) underflows to 0 far below the diagonal); each
    against the plain version, and on two launches."""
    gen = torch.Generator(device=DEV).manual_seed(1618)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    for Bs, S, nh, g, n, L, dt_shift in ((1, 128, 128, 1, 16, 128, 0.0),
                                         (1, 256, 128, 2, 16, 64, 0.0),
                                         (2, 256, 8, 2, 32, 128, 0.0),
                                         (2, 120, 16, 1, 64, 40, 0.0),
                                         (1, 96, 4, 2, 128, 24, 0.0),
                                         (1, 256, M_HEADS, 1, M_STATE, 128, 4.0)):
        x = randn(Bs, S, nh, M_HEADDIM)
        dt = F.softplus(randn(Bs, S, nh, dtype=torch.float32) + dt_shift)
        A = -torch.exp(randn(nh, dtype=torch.float32))
        Dd = randn(nh, dtype=torch.float32)
        Bm, Cm = randn(Bs, S, g, n), randn(Bs, S, g, n)
        y_k, h_k = ops.ssd(x, dt, A, Bm, Cm, Dd, chunk=L, return_state=True)
        y_r, h_r = ref.ssd_chunked(x, dt, A, Bm, Cm, Dd, chunk=L, return_state=True)
        ok, err = close(y_k, y_r, SSD_Y_TOL)
        ok_h, err_h = close(h_k, h_r, SSD_STATE_TOL)
        what = f"ssd x {tuple(x.shape)}, {g} groups of {n}, chunk {L}, dt shift {dt_shift}"
        require(ok and ok_h, f"{what}: y err {err}, state err {err_h}")
        require(same_bits(lambda: ops.ssd(x, dt, A, Bm, Cm, Dd, chunk=L, return_state=True)),
                f"{what}: two launches differ")
    print(json.dumps({"check": "ssd/edges", "ok": True}), flush=True)


def same_bits(fn) -> bool:
    """Two calls of fn (a kernel on the same inputs) give the same bits."""
    a, b = fn(), fn()
    return all(x.equal(y) for x, y in zip(a, b))


def check_decode(torch, ref, got, want, cache_len, pos_offset: int, what: str):
    """A decode kernel's (o, lse) against its plain version's. A row with no
    live key (cache_len <= pos_offset) is o = 0 in both and lse at or below
    NEG_INF / 2 in both (the kernel, as the TPU kernel, gives NEG_INF +
    log(1e-20); the plain version, as the JAX reference, NEG_INF / 2); every
    other row within BF16_TOL (o) and LSE_TOL (lse). Returns max |o - o'|
    over the live rows."""
    empty = cache_len <= pos_offset
    live = ~empty
    ok, err, ok_l, err_l = True, 0.0, True, 0.0
    if bool(live.any()):  # a rank's slot shard may hold no live key of any row
        ok, err = close(got[0][live], want[0][live], BF16_TOL)
        ok_l, err_l = close(got[1][live], want[1][live], LSE_TOL)
    floor = torch.tensor(ref.NEG_INF / 2, dtype=torch.float32)
    ok_e = all(bool((o[empty] == 0).all()) and bool((lse[empty].cpu() <= floor).all())
               for o, lse in (got, want))
    require(ok and ok_l and ok_e, f"{what}: o err {err}, lse err {err_l}, "
                                  f"empty rows {empty.tolist()} as specified: {ok_e}")
    return err


def split_decode_edges(torch, ops, ref, quant_kv, randn):
    """Both contiguous decode kernels at the edges of their splits, each head
    shape at its own split (``split_rule.split_keys``): one key, a length on
    a split boundary, one past it, the full cache, two splits and a key,
    two splits, one short of a split, three splits; no window, window 40
    (across split boundaries), a window of two splits (rows of three splits
    start and end on a boundary), pos_offset 16 with one row of cache_len
    16 (no live key), and pos_offset with a window. ``randn`` draws from the
    edge cases' own generator."""
    from repro_torch.kernels.split_rule import split_keys

    for hd, h, kvh in ((HEAD_DIM, HEADS, 1), (HEAD_DIM, 32, 1), (128, 8, 2), (64, 8, 2)):
        sk = split_keys(B, h, kvh, SMAX)
        lens = torch.tensor([1, sk, sk + 1, SMAX, 2 * sk + 1, 2 * sk, sk - 1, 3 * sk],
                            dtype=torch.int32, device=DEV)
        shifted = lens + 16
        shifted[0] = 16
        q, k, v = randn(B, h, hd), randn(B, SMAX, kvh, hd), randn(B, SMAX, kvh, hd)
        (kq, ks), (vq, vs) = quant_kv(k), quant_kv(v)
        for n, kw in ((lens, {}), (lens, {"window": 40}), (lens, {"window": 2 * sk}),
                      (shifted, {"pos_offset": 16}), (shifted, {"pos_offset": 16, "window": 40})):
            what = f"D={hd} H={h} KVH={kvh} split {sk} keys, cache_len {n.tolist()}, {kw}"
            check_decode(torch, ref, ops.decode_attention(q, k, v, n, **kw),
                         ref.decode_attention(q, k, v, n, **kw), n, kw.get("pos_offset", 0),
                         f"decode_attention {what}")
            check_decode(torch, ref, ops.decode_attention_quant(q, kq, vq, ks, vs, n, **kw),
                         ref.decode_attention_quant(q, kq, vq, ks, vs, n, **kw), n,
                         kw.get("pos_offset", 0), f"decode_attention_quant {what}")
        require(same_bits(lambda: ops.decode_attention(q, k, v, shifted, pos_offset=16))
                and same_bits(lambda: ops.decode_attention_quant(q, kq, vq, ks, vs, shifted,
                                                                 pos_offset=16)),
                f"D={hd} H={h} KVH={kvh}: two launches of a decode kernel differ")
    print(json.dumps({"check": "split_decode_edges", "ok": True}), flush=True)


def check_sample(torch, ref, got, h, head, seeds, it, vocab, what: str,
                 col_offset: int = 0) -> float:
    """fused_sample's (tokens, logprobs) ``got`` against its plain version's:
    no token past the vocab, greedy rows equal, sampled rows equal where the
    top two scores are clear by SAMPLE_GAP, logprobs at LOGPROB_TOL. ``head``
    may be a vocab shard that starts at the head's column ``col_offset``,
    and the tokens its own column indices. Returns the max logprob error."""
    tok_k, lp_k = got
    tok_r, lp_r = ref.fused_sample(h, head, seeds, it, vocab_size=vocab, col_offset=col_offset)
    _, y = ref.sample_scores(h, head, seeds, it, vocab_size=vocab, col_offset=col_offset)
    top2 = y.topk(2, dim=-1).values
    must = (it == 0) | ((top2[:, 0] - top2[:, 1]) > SAMPLE_GAP)
    require(bool((tok_k + col_offset < (vocab or col_offset + head.shape[1])).all()),
            f"fused_sample {what}: a token past the vocab")
    require(bool((tok_k == tok_r)[must].all()),
            f"fused_sample {what}: {tok_k.tolist()} vs {tok_r.tolist()}")
    ok, err = close(lp_k, lp_r, LOGPROB_TOL)
    require(ok, f"fused_sample {what}: logprob max abs err {err}")
    return err


def sampler_at(torch, ops, ref, randn, gen, V, D):
    """fused_sample against its plain version at one head shape (tied head
    (V, D) padded to a multiple of 256 rows): greedy tokens bit-equal, sampled
    tokens equal where the top two scores are clear, logprobs at 1e-3."""
    Vp = -(-V // 256) * 256
    embed = randn(Vp, D, scale=0.02)
    h = randn(B, D)
    seeds = torch.randint(-2**31, 2**31, (B,), generator=gen, device=DEV,
                          dtype=torch.int64).to(torch.int32)
    worst = 0.0
    for inv_t in (0.0, 1.0 / 0.8):
        it = torch.full((B,), inv_t, device=DEV)
        tok_k, lp_k = ops.fused_sample(h, embed.t(), seeds, it, vocab_size=V)
        tok_r, lp_r = ref.fused_sample(h, embed.t(), seeds, it, vocab_size=V)
        require(bool((tok_k < V).all()), "fused_sample drew a padded-vocab token")
        _, y = ref.sample_scores(h, embed.t(), seeds, it, vocab_size=V)
        top2 = y.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > SAMPLE_GAP
        require(bool((tok_k == tok_r)[clear].all()) and (inv_t > 0 or torch.equal(tok_k, tok_r)),
                f"fused_sample d={D} Vp={Vp} inv_temp={inv_t}: {tok_k} vs {tok_r}")
        ok, err = close(lp_k, lp_r, LOGPROB_TOL)
        require(ok, f"fused_sample d={D} Vp={Vp} logprob: max abs err {err}")
        worst = max(worst, err)
    it = torch.ones(B, device=DEV)
    bms, by = bound_ms(Vp * D * 2 + B * D * 2 + B * 8, 2 * B * Vp * D, BF16_TENSOR_FLOP_PER_S)
    return {"shape": {"h": [B, D], "embed": [Vp, D], "vocab": V}, "max_abs_err": worst,
            "ms": device_ms(lambda: ops.fused_sample(h, embed.t(), seeds, it, vocab_size=V)),
            "plain_ms": device_ms(lambda: ref.fused_sample(h, embed.t(), seeds, it,
                                                           vocab_size=V), reps=21),
            "bound_ms": bms, "bound_by": by,
            "library_ms": device_ms(lambda: torch.matmul(h, embed.t()))}


def sampler_edges(torch, ops, ref, embed, randn, gen):
    """fused_sample at gemma's head (V, D) beyond the lockstep batch: every
    instantiation of the kernel (B = 1, 5, 13, 64, and 100, which tiles the
    batch by 64), exact greedy ties placed in one thread's rows, in one scan
    lane's, across lanes, across a tile boundary, across two blocks' tile
    ranges and between the first and last block (the lower index must win;
    the tile rows and tiles per block come from the wrapper's
    ``sampling.grid``), vocab tails (V - 100, and a vocab that
    ends inside the fourth tile, so that most blocks hold no sampled row),
    and the same bits on two launches.
    Returns the record of B = 64 (time, bound, plain and library times)."""
    from repro_torch.kernels import sampling

    V, D = embed.shape
    head = embed.t()

    def seeds_for(n):
        return torch.randint(-2**31, 2**31, (n,), generator=gen, device=DEV,
                             dtype=torch.int64).to(torch.int32)

    def held(h, seeds, it, vocab, what):
        """Kernel against plain: greedy rows equal, sampled rows equal where
        the top two scores are clear, logprobs at LOGPROB_TOL, two launches
        bit-identical; returns (kernel tokens, max logprob error)."""
        got = ops.fused_sample(h, head, seeds, it, vocab_size=vocab)
        err = check_sample(torch, ref, got, h, head, seeds, it, vocab, what)
        require(same_bits(lambda: ops.fused_sample(h, head, seeds, it, vocab_size=vocab)),
                f"fused_sample {what}: two launches differ")
        return got[0], err

    worst, grids = 0.0, {}
    for Bs in (1, 5, 13, 64, 100):
        h = randn(Bs, D)
        it = torch.where(torch.arange(Bs, device=DEV) % 2 == 0, 0.0, 1 / 0.8)
        worst = max(worst, held(h, seeds_for(Bs), it, V, f"B={Bs}")[1])
        grids[Bs] = sampling.grid(Bs, V, embed.device.index)
    for Bs in (8, 64):  # 128-row and 256-row tiles
        blocks, tiles, tv = grids.get(Bs) or sampling.grid(Bs, V, embed.device.index)
        span = tiles * tv
        require(blocks > 1 and tiles > 1, f"B={Bs}: {blocks} blocks of {tiles} tiles")
        # one thread's two accumulator rows, one scan lane's, two lanes', a tile
        # boundary, a boundary of two blocks' ranges, the first and last block
        pairs = ((51, 59), (40, 72), (82, 86), (tv - 1, tv), (span - 1, span), (7, V - 9))
        hs = torch.randint(-1, 2, (Bs, D), generator=gen, device=DEV).to(torch.bfloat16)
        idx = torch.tensor([i for p in pairs for i in p], device=DEV)
        saved = embed[idx].clone()
        for k, (i, j) in enumerate(pairs):  # |z| = sum |h| on both rows: exact
            embed[i] = embed[j] = torch.sign(hs[k])
        tok, err = held(hs, seeds_for(Bs), torch.zeros(Bs, device=DEV), V, f"ties B={Bs}")
        embed[idx] = saved
        require(tok[:len(pairs)].tolist() == [i for i, _ in pairs],
                f"fused_sample ties B={Bs}: {tok[:len(pairs)].tolist()} for pairs {pairs}")
        worst = max(worst, err)
        for vocab in (V - 100, 3 * tv + 5):
            h = randn(Bs, D)
            it = torch.where(torch.arange(Bs, device=DEV) % 2 == 0, 0.0, 1 / 0.8)
            worst = max(worst, held(h, seeds_for(Bs), it, vocab, f"B={Bs} vocab={vocab}")[1])
    print(json.dumps({"check": "fused_sample/edges", "max_abs_err": worst,
                      "grid": {str(b): dict(zip(("blocks", "tiles", "tile_rows"), g))
                               for b, g in grids.items()}}), flush=True)
    Bs = 64
    h, seeds, it = randn(Bs, D), seeds_for(Bs), torch.ones(Bs, device=DEV)
    bms, by = bound_ms(V * D * 2 + Bs * D * 2 + Bs * 8, 2 * Bs * V * D, BF16_TENSOR_FLOP_PER_S)
    return {"shape": {"h": [Bs, D], "embed": [V, D]}, "max_abs_err": worst,
            "ms": device_ms(lambda: ops.fused_sample(h, head, seeds, it, vocab_size=V)),
            "plain_ms": device_ms(lambda: ref.fused_sample(h, head, seeds, it, vocab_size=V),
                                  reps=11),
            "bound_ms": bms, "bound_by": by,
            "library_ms": device_ms(lambda: torch.matmul(h, head))}


def untied_sampler(torch, ops, ref, randn, gen):
    """fused_sample on qwen2.5-7b's untied head as it lies, (d, Vp) with the
    vocab contiguous (never transposed or copied), at B = 8 and B = 64:
    greedy and sampled tokens bit-equal to the plain version's, logprobs at
    LOGPROB_TOL, exact greedy ties across a tile boundary, across two blocks'
    tile ranges and between the first and last block (the lower index must
    win; the grid from ``sampling.grid`` for this layout), and the same bits
    on two launches; each batch timed beside ``h @ lm_head`` and its bytes
    bound. Returns {"qwen_untied_b8": record, "qwen_untied_b64": record}."""
    from repro_torch.kernels import sampling

    D, V = Q_D_MODEL, Q_VOCAB
    head = randn(D, V, scale=0.02)
    require(sampling.head_layout(head) is True, "the untied head is not read as (d, Vp)")
    out = {}
    for Bs in (8, 64):
        h = randn(Bs, D)
        seeds = torch.randint(-2**31, 2**31, (Bs,), generator=gen, device=DEV,
                              dtype=torch.int64).to(torch.int32)
        worst = 0.0
        for inv_t in (0.0, 1 / 0.8):
            it = torch.full((Bs,), inv_t, device=DEV)
            got = ops.fused_sample(h, head, seeds, it, vocab_size=V)
            what = f"untied B={Bs} inv_temp={inv_t}"
            worst = max(worst, check_sample(torch, ref, got, h, head, seeds, it, V, what))
            want, _ = ref.fused_sample(h, head, seeds, it, vocab_size=V)
            require(torch.equal(got[0], want), f"fused_sample {what}: tokens "
                                               f"{got[0].tolist()} vs {want.tolist()}")
            require(same_bits(lambda: ops.fused_sample(h, head, seeds, it, vocab_size=V)),
                    f"fused_sample {what}: two launches differ")
        blocks, tiles, tv = sampling.grid(Bs, V, head.device.index, cols=True)
        span = tiles * tv
        require(blocks > 1 and tiles > 1, f"untied B={Bs}: {blocks} blocks of {tiles} tiles")
        pairs = ((tv - 1, tv), (span - 1, span), (7, V - 9))
        hs = torch.randint(-1, 2, (Bs, D), generator=gen, device=DEV).to(torch.bfloat16)
        idx = torch.tensor([i for p in pairs for i in p], device=DEV)
        saved = head[:, idx].clone()
        for k, (i, j) in enumerate(pairs):  # |z| = sum |h| in both columns: exact
            head[:, i] = head[:, j] = torch.sign(hs[k])
        zero = torch.zeros(Bs, device=DEV)
        got = ops.fused_sample(hs, head, seeds, zero, vocab_size=V)
        worst = max(worst, check_sample(torch, ref, got, hs, head, seeds, zero, V,
                                        f"untied ties B={Bs}"))
        head[:, idx] = saved
        require(got[0][:len(pairs)].tolist() == [i for i, _ in pairs],
                f"fused_sample untied ties B={Bs}: {got[0][:len(pairs)].tolist()} for {pairs}")
        it = torch.ones(Bs, device=DEV)
        bms, by = bound_ms(V * D * 2 + Bs * D * 2 + Bs * 8, 2 * Bs * V * D,
                           BF16_TENSOR_FLOP_PER_S)
        out[f"qwen_untied_b{Bs}"] = {
            "shape": {"h": [Bs, D], "lm_head": [D, V]}, "max_abs_err": worst,
            "grid": [blocks, tiles, tv],
            "ms": device_ms(lambda: ops.fused_sample(h, head, seeds, it, vocab_size=V)),
            "plain_ms": device_ms(lambda: ref.fused_sample(h, head, seeds, it, vocab_size=V),
                                  reps=11),
            "bound_ms": bms, "bound_by": by,
            "library_ms": device_ms(lambda: torch.matmul(h, head))}
    return out


def serve_args(serve, temperature: float, arch_flags=ARCH_FLAGS, batches=TIMED_BATCHES):
    return serve.parse_args([
        *arch_flags, "--lockstep", "--device", DEV, "--seed", "0",
        "--batch", str(B), "--prompt-len", str(PROMPT), "--max-new", str(MAX_NEW),
        "--requests", str(batches), "--temperature", str(temperature)])


def build_model(torch, serve, arch_flags=ARCH_FLAGS, layers=None):
    """A model at full width on the card, random bf16 weights from ``--seed
    0``, through the serve entry point's own setup: at full depth, or on its
    first ``layers`` layers."""
    t0 = time.perf_counter()
    args = serve_args(serve, 0.0, arch_flags)
    if layers is None:
        model, params, tok = serve.setup(args)
    else:
        full = serve.get_config
        with patched(serve, "get_config",
                     lambda name: dataclasses.replace(full(name), num_layers=layers)):
            model, params, tok = serve.setup(args)
    torch.cuda.synchronize()
    cfg = model.cfg
    if cfg.ssm_state:
        shape = (f"{cfg.ssm_nheads} SSD heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, "
                 f"{cfg.ssm_ngroups} group, conv {cfg.ssm_conv}")
    else:
        shape = (f"{cfg.padded_heads} heads (padded from {cfg.num_heads}) of {cfg.head_dim}, "
                 f"d_ff {cfg.d_ff}")
    print(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {shape}, "
          f"vocab {cfg.vocab_size}; weights drawn in {time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    return model, params, tok


def norm_launches(cfg) -> int:
    """``rmsnorm`` launches of one forward: a norm before every mixer and
    every MLP (one shared norm in a parallel block), a gated norm in every
    SSD mixer, and the final norm; none where the norm is layernorm (plain
    torch, as in JAX)."""
    if cfg.norm_type != "rmsnorm":
        return 0
    kinds = cfg.layer_kinds()
    mlps = 0 if cfg.parallel_block else sum(k[1] != "none" for k in kinds)
    return len(kinds) + mlps + sum(k[0] == "ssm" for k in kinds) + 1


def forward_launches(cfg, names, prefills: int, steps: int):
    """Launch counts of ``prefills`` whole-prompt prefills and ``steps``
    decode steps: per forward a norm before every mixer and every MLP, a
    gated norm in every SSD mixer, and the final norm; per prefill one flash
    attention per attention layer and one scan per SSD layer; per decode step
    one decode attention (the int8 kernel under ``kv_quant``) per attention
    layer and one sampler call. A layernorm model launches no norm kernel
    (``norm_launches``)."""
    kinds = cfg.layer_kinds()
    attn = sum(k[0] == "attn" for k in kinds)
    ssd = len(kinds) - attn
    out = dict.fromkeys(names, 0)
    out.update({"rmsnorm": norm_launches(cfg) * (prefills + steps),
                "flash_attention": prefills * attn, "ssd": prefills * ssd,
                "fused_sample": steps,
                ("decode_attention_quant" if cfg.kv_quant else "decode_attention"):
                    attn * steps})
    return out


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


def plain_logits(torch, ops, model, params, prompt, chunk: int):
    """Last-position logits of the plain path over the prompt of an SSD stack
    without MLPs, with the scan's chunk length ``chunk``: the operations of
    ``model.prefill`` in ref mode, which at another chunk length compute the
    same function with another order of the scan's fp32 sums."""
    from repro_torch.models import layers, lm, ssm

    cfg = model.cfg
    require(all(k == ("ssm", "none") for k in cfg.layer_kinds()),
            "the plain drift is measured on SSD stacks without MLPs")
    ops.set_mode("ref")
    with torch.inference_mode():
        h = lm.embed_tokens(cfg, params, prompt)
        for block in params["blocks"]:
            hn = layers.apply_norm(cfg, block["norm1"], h)
            h = h + ssm.apply_ssm(cfg, block["ssm"], hn, return_state=True, chunk=chunk)[0]
        h = layers.apply_norm(cfg, params["final_norm"], h)
        logits = lm.mask_padded_vocab(cfg, (h[:, -1] @ lm._head_matrix(cfg, params)).float())
    ops.set_mode(None)
    return logits


def layerwise_agreement(torch, ops, model, params, prompt, caches_r, len_r, tok0,
                        smax: int, prefix=None):
    """Every layer on the plain path's input of that layer, kernel path
    against plain path, over the prompt and for the one-token step from the
    plain prefill's caches: norm1, the mixer (the SSD mixer with its scan
    and gated norm, or attention with its cache), and where the layer has an
    MLP, norm2 and the MLP, each within 2e-2 of its max |output|. An MoE
    layer's tokens whose top-k experts differ between the two paths (route
    flips: the two norms' roundings move a token whose k-th and (k+1)-th
    router logits lie that close) are counted and left out, and every token
    beyond the limit must be one of them. Returns the kernel and plain
    prefill logits from the plain last hidden state, the kernel sampler's
    greedy token and the plain logits of the decode step, the worst layer's
    error over its max, and the route flips of each MoE layer (prefill,
    decode). A parallel block feeds norm1's output to its MLP too and adds
    both outputs to the residual; ``prefix`` embeddings run ahead of the
    prompt."""
    from repro_torch.models import layers, lm, moe

    cfg = model.cfg
    worst, flips = 0.0, []

    def both(fn):  # (kernel path, plain path) of fn
        ops.set_mode("ref")
        plain = fn()
        ops.set_mode(None)
        return fn(), plain

    def check(a, b, what, skip=None):
        nonlocal worst
        s, e = float(b.float().abs().max()), (a.float() - b.float()).abs()
        e = e.reshape(-1, e.shape[-1]).amax(dim=-1)
        if skip is not None:
            require(not bool((e > 2e-2 * s)[~skip].any()),
                    f"{what}: a token whose route did not flip is off by more than 2e-2 of "
                    f"max |out| {s}: {float(e[~skip].max())}")
            e = e[~skip]
        e = float(e.max()) if e.numel() else 0.0
        require(e <= 2e-2 * s, f"{what}: max abs err {e} vs max |out| {s}")
        worst = max(worst, e / s)

    head = lm._head_matrix(cfg, params)
    with torch.inference_mode():
        h = lm.assemble_input(cfg, params, prompt, prefix)
        positions = torch.arange(h.shape[1], device=DEV)[None, :]
        hd = lm.embed_tokens(cfg, params, tok0.reshape(-1, 1))
        for i, (block, kind, cache_r) in enumerate(zip(params["blocks"], cfg.layer_kinds(),
                                                       caches_r)):
            for mode in ("prefill", "decode"):
                x, cache = (h, None) if mode == "prefill" else (hd, cache_r)
                hn_k, hn = both(lambda: layers.apply_norm(cfg, block["norm1"], x))
                check(hn_k, hn, f"layer {i} norm1 ({mode})")
                if kind[0] == "ssm":
                    (mk, _), (mr, _) = both(
                        lambda: lm._ssm_mixer(cfg, block["ssm"], hn, mode, cache))
                else:
                    (mk, _), (mr, _) = both(lambda: lm._attn_mixer(
                        cfg, block["attn"], hn, positions, mode, cache, len_r, smax))
                check(mk, mr, f"layer {i} {kind[0]} mixer ({mode})")
                x_in, x = x, x + mr
                if kind[1] != "none" and cfg.parallel_block:
                    hn2_k, hn2 = hn_k, hn
                elif kind[1] != "none":
                    hn2_k, hn2 = both(lambda: layers.apply_norm(cfg, block["norm2"], x))
                    check(hn2_k, hn2, f"layer {i} norm2 ({mode})")
                if kind[1] != "none":
                    if kind[1] == "dense":
                        ok_, or_ = both(lambda: layers.apply_mlp(cfg, block["mlp"], hn2))
                        skip = None
                    else:
                        # the MoE on each path's own normed input, as the model runs it
                        with routes_recorded(torch) as routes:
                            ops.set_mode("ref")
                            or_, _ = moe.apply_moe(cfg, block["moe"], hn2)
                            ops.set_mode(None)
                            ok_, _ = moe.apply_moe(cfg, block["moe"], hn2_k)
                        skip = (routes[0] != routes[1]).any(dim=-1)
                        flips.append((i, mode, int(skip.sum())))
                    check(ok_, or_, f"layer {i} {kind[1]} MLP ({mode})", skip)
                    x = x_in + mr + or_ if cfg.parallel_block else x + or_
                if mode == "prefill":
                    h = x
                else:
                    hd = x
        fk, fr = both(lambda: layers.apply_norm(cfg, params["final_norm"], h[:, -1].contiguous()))
        logits_k = lm.mask_padded_vocab(cfg, (fk @ head).float())
        logits_r = lm.mask_padded_vocab(cfg, (fr @ head).float())
        ops.set_mode("ref")
        hdf = layers.apply_norm(cfg, params["final_norm"], hd[:, 0])
        step_r = lm.mask_padded_vocab(cfg, (hdf @ head).float())
        ops.set_mode(None)
        zero = torch.zeros(hdf.shape[0], dtype=torch.int32, device=DEV)
        tok1_k, _ = ops.fused_sample(hdf, head, zero, zero.float(), vocab_size=cfg.vocab_size)
    return logits_k, logits_r, tok1_k, step_r, worst, flips


@contextlib.contextmanager
def routes_recorded(torch):
    """While open, the expert ids of every MoE routing (``moe.route``) are
    kept in call order, each (T, k) sorted along k. Yields the list."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def recording(cfg, router, xt):
        out = route(cfg, router, xt)
        seen.append(out[2].sort(dim=-1).values)
        return out

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route


def flipped(torch, a, b, rows: int):
    """(rows, positions) bool: the tokens whose experts differ between two
    routings of the same layers (lists of (rows * positions, k))."""
    out = None
    for x, y in zip(a, b):
        f = (x != y).any(dim=-1).reshape(rows, -1)
        out = f if out is None else out | f
    return out


def fp32_attention(ref):
    """A context in which the plain attention keeps its probabilities in
    fp32 for the value product: another, equally valid rounding of the same
    function (the plain path rounds them to bf16, as the JAX package
    does)."""
    plain_flash = ref.flash_attention
    return patched(ref, "flash_attention", lambda q, k, v, **kw: plain_flash(
        q.float(), k.float(), v.float(), **kw).to(q.dtype))


def plain_agreement(torch, ops, model, params, prompt, smax: int, label: str,
                    layerwise: bool = False, prefix=None):
    """The kernel path of ``model`` against its plain path
    (``ops.set_mode("ref")``) on the same weights and ``prompt``: the prefill
    logits within 2e-2 of their max, and the first token and the first
    decoded token (the fused sampler, greedy) equal in every row whose top
    two logits are clear by 0.05. With ``layerwise``, the kernel path
    is held against the plain path layer by layer (``layerwise_agreement``)
    and the first tokens on the plain path's last hidden states; an SSD
    stack's free-running logits are also held against the plain path's
    drift from itself (``plain_logits`` at chunk 64), a deep MoE stack's
    against the plain path's drift from itself between a batched prefill
    and one row at a time: its free-running paths part wherever a route
    flips (each path routes its own hidden states, and a token whose k-th
    and (k+1)-th router logits lie within the paths' rounding takes another
    expert), and the flips compound through the layers; a deep dense stack's
    against the plain path's drift from itself when its attention keeps the
    probabilities in fp32 (``fp32_attention``). ``prefix`` embeddings run
    ahead of the prompt. Returns the checks' numbers."""
    from repro_torch.kernels import ref

    B = prompt.shape[0]
    cfg = model.cfg
    n = sum(k[1] == "moe" for k in cfg.layer_kinds())
    ssd = any(k[0] == "ssm" for k in cfg.layer_kinds())
    require(layerwise or not n, "an MoE stack is held to the plain path layer by layer")
    kw = {} if prefix is None else {"prefix_embeds": prefix}
    with torch.inference_mode():
        ops.set_mode("ref")
        logits_r, caches_r, len_r = model.prefill(params, prompt, smax=smax, **kw)
        tok0 = torch.argmax(logits_r, dim=-1).to(torch.int32)
        step_r, _, _ = model.decode_step(params, tok0, caches_r, len_r)
        ops.set_mode(None)
        logits_k, caches_k, len_k = model.prefill(params, prompt, smax=smax, **kw)
        zero = torch.zeros(B, dtype=torch.int32, device=DEV)
        tok1_k, _, _, _ = model.decode_step_sample(params, tok0, caches_k, len_k, zero, 0.0)
    real = slice(0, cfg.vocab_size)  # the padded vocab is -1e30 in both
    scale = float(logits_r[:, real].abs().max())
    err = float((logits_k[:, real] - logits_r[:, real]).abs().max())
    checks = {"prefill_logits_max_abs_err": err, "max_abs_logit": scale}
    if layerwise and n:
        # the plain path against itself, one prompt row at a time (another
        # shape of every product, so another order of its sums)
        ops.set_mode("ref")
        with torch.inference_mode():
            rows = torch.cat([model.prefill(params, prompt[b:b + 1], smax=smax)[0]
                              for b in range(B)])
        ops.set_mode(None)
        drift = float((rows[:, real] - logits_r[:, real]).abs().max())
        checks.update(
            plain_row_by_row_logits_max_abs_err=drift,
            free_running_first_token_equal_rows=int(
                (torch.argmax(logits_k, dim=-1) == torch.argmax(logits_r, dim=-1)).sum()))
        print(f"[{label}] free-running: prefill logits max abs err {err:.4g} (the plain "
              f"path row by row against itself {drift:.4g}, max |logit| {scale:.4g}); first "
              f"token equal in {checks['free_running_first_token_equal_rows']}/{B} rows",
              flush=True)
        require(err <= DRIFT_FACTOR * drift,
                f"free-running prefill logits: max abs err {err}, more than {DRIFT_FACTOR} "
                f"x the plain path's drift against itself row by row ({drift})")
    if layerwise and not n and not ssd:
        # a deep random bf16 stack carries each layer's rounding into every
        # later layer; the plain path with fp32 attention probabilities
        # measures how far two correct paths drift apart
        ops.set_mode("ref")
        with torch.inference_mode(), fp32_attention(ref):
            other = model.prefill(params, prompt, smax=smax, **kw)[0]
        ops.set_mode(None)
        drift = float((other[:, real] - logits_r[:, real]).abs().max())
        del other
        own0 = int((torch.argmax(logits_k, dim=-1) == torch.argmax(logits_r, dim=-1)).sum())
        checks.update(plain_fp32_attention_logits_max_abs_err=drift,
                      free_running_first_token_equal_rows=own0)
        print(f"[{label}] free-running: prefill logits max abs err {err:.4g}, the plain path "
              f"with fp32 attention probabilities {drift:.4g} (max |logit| {scale:.4g}); first "
              f"token equal in {own0}/{B} rows", flush=True)
        require(err <= DRIFT_FACTOR * drift,
                f"free-running prefill logits: max abs err {err}, more than {DRIFT_FACTOR} "
                f"x the plain path's drift with fp32 attention probabilities ({drift})")
    if layerwise and ssd:
        # 64 random SSD layers in bf16 carry a rounding difference of one
        # layer's output into every later layer: the free-running logits of
        # two correct paths drift apart with depth. The plain path against
        # itself at chunk 64 (an equally valid order of the scan's fp32
        # sums) measures that drift, and the kernel path may drift at most
        # DRIFT_FACTOR times as far. Then each layer is held on the plain
        # path's own input at 2e-2, and the first tokens on the plain path's
        # last hidden state.
        drift = float((plain_logits(torch, ops, model, params, prompt, 64)[:, real]
                       - logits_r[:, real]).abs().max())
        checks["plain_chunk64_logits_max_abs_err"] = drift
        require(err <= DRIFT_FACTOR * drift,
                f"free-running prefill logits: max abs err {err}, more than {DRIFT_FACTOR} "
                f"x the plain path's drift against itself at chunk 64 ({drift})")
        own0 = int((torch.argmax(logits_k, dim=-1) == torch.argmax(logits_r, dim=-1)).sum())
        checks["free_running_first_token_equal_rows"] = own0
        print(f"[{label}] free-running: prefill logits max abs err {err:.4g}, the plain path "
              f"at chunk 64 {drift:.4g} (max |logit| {scale:.4g}); first token equal in "
              f"{own0}/{B} rows", flush=True)
    if layerwise:
        logits_k, logits_r, tok1_k, step_r, worst, flips = layerwise_agreement(
            torch, ops, model, params, prompt, caches_r, len_r, tok0, smax, prefix)
        checks["worst_layer_err_over_max"] = worst
        if flips:
            checks["layerwise_route_flips"] = flips
        err = float((logits_k[:, real] - logits_r[:, real]).abs().max())
        scale = float(logits_r[:, real].abs().max())
        checks.update({"teacher_forced_logits_max_abs_err": err,
                       "teacher_forced_max_abs_logit": scale})
    require(err <= 2e-2 * scale, f"prefill logits: max abs err {err} vs max |logit| {scale}")

    def agree(pred, logits, what):
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 0.05
        require(bool((pred == torch.argmax(logits, dim=-1))[clear].all()),
                f"{what}: kernel path disagrees with the plain path in a clear row")
        return int(clear.sum())

    clear0 = agree(torch.argmax(logits_k, dim=-1), logits_r, "first token")
    clear1 = agree(tok1_k, step_r, "first decoded token")
    print(f"[{label}] kernel vs plain path{' (layer by layer)' if layerwise else ''}: "
          f"prefill logits max abs err {err:.4g} (max |logit| {scale:.4g}); first token "
          f"agrees in {clear0}/{B} clear rows, first decoded token in {clear1}/{B}", flush=True)

    checks.update(first_token_clear_rows=clear0, first_decoded_clear_rows=clear1)
    return checks


def end_to_end_phase(torch, ops, _build, serve, generate, model, params, tok,
                     label="e2e", profile_name="profile.txt", layerwise=False,
                     batches=TIMED_BATCHES, reps=3):
    """Lockstep serving of ``model`` (full width) on the card,
    through ``serve.run_lockstep`` (a warm-up and ``batches`` timed
    batches a run; the decode rate from ``reps`` generates of each length).
    With ``layerwise``, the kernel path's free-running logits are held
    against the plain path's drift from itself (``plain_logits`` at chunk
    64), and the kernel path against the plain path layer by layer (see
    ``layerwise_agreement``). Returns (launch counts of the greedy run,
    summary, a function that profiles one greedy generate)."""
    # run_lockstep reads the batch flags only, not --arch
    args = serve_args(serve, 0.0, batches=batches)
    cfg = model.cfg
    steps, gens = MAX_NEW - 1, batches + 1
    expected = forward_launches(cfg, _build.LAUNCHES, gens, gens * steps)

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
    sampled_args = serve_args(serve, 0.8, batches=batches)
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
    checks = plain_agreement(torch, ops, model, params, prompt, SMAX, label, layerwise)

    # decode rate: a whole generate minus one that stops after the prefill
    def gen_s(max_new):
        g = torch.Generator(device=DEV).manual_seed(7)
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(model, params, prompt, g, max_new=max_new, temperature=0.0, eos_id=tok.eos_id)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    full = statistics.median(gen_s(MAX_NEW) for _ in range(reps))
    prefill_only = statistics.median(gen_s(1) for _ in range(reps))
    step_ms = (full - prefill_only) / (MAX_NEW - 1) * 1e3
    summary = {
        "greedy_tok_per_s": greedy["tok_per_s"], "greedy_p50_ms": greedy["p50_s"] * 1e3,
        "greedy_p99_ms": greedy["p99_s"] * 1e3,
        "sampled_tok_per_s": sampled["tok_per_s"], "sampled_p50_ms": sampled["p50_s"] * 1e3,
        "sampled_p99_ms": sampled["p99_s"] * 1e3,
        "generate_ms": full * 1e3, "prefill_and_first_token_ms": prefill_only * 1e3,
        "decode_step_ms": step_ms, "decode_tok_per_s": B / step_ms * 1e3,
        **checks,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps({label: summary}), flush=True)

    def profile_job():
        busy_ms, wall_ms = busy_share(torch, lambda: gen_s(MAX_NEW), ROOT / "build" / profile_name)
        print(json.dumps({f"profile_{label}": {
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
        expected = dict.fromkeys(_build.LAUNCHES, 0)
        expected.update({"rmsnorm": (2 * L + 1) * (chunks + steps), "flash_attention": L * chunks,
                         "paged_decode_attention": L * steps, "fused_sample": steps})
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


# the training phase: GRPO on full gemma-2b (configs/gemma_2b.py), 2 math
# prompts x 8 rollouts of 16 new tokens, the default RLConfig
GRPO_ITERS, GRPO_PROMPTS = 3, 2
# the gradient check: the kernel path's loss and grads may stray from the
# plain path's at most this many times as far as the plain path strays from
# itself under another, equally valid rounding of the same function (gemma:
# attention probabilities in fp32; mamba2: the scan in chunks of 64)
GRAD_DRIFT_FACTOR = 2.0
RATIO_TOL = 0.02  # ratio_mean of an actor step on rollouts just sampled: 1 +- this
# a parameter's drift counts as no less than one bf16 rounding step relative
# to the leaf: the grads of bf16 weights are bf16, and two of them closer
# than this are the same gradient to their precision
GRAD_FLOOR = 2.0 ** -8
# one actor step at an RL response length: 2 sequences of 2,048 positions,
# the last 1,792 of them the response
LONG_B, LONG_PROMPT, LONG_S = 2, 256, 2048


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp(min=1e-30))


def leaf_names(t, prefix="params"):
    """The path of every leaf of a params tree, in ``tree.leaves`` order."""
    if isinstance(t, dict):
        return [n for k, v in t.items() for n in leaf_names(v, f"{prefix}.{k}")]
    if isinstance(t, (list, tuple)):
        return [n for i, v in enumerate(t) for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


@contextlib.contextmanager
def held_to_plain(torch, ops, ref, names):
    """While open, every call of a kernel of ``names`` through ``ops`` is
    held against the kernel's plain version on that call's own inputs, at
    the kernel checks' tolerances (norm and flash BF16_TOL, both decode
    kernels ``check_decode``, the sampler ``check_sample``, the scan SSD_Y_TOL and
    SSD_STATE_TOL); the caller gets the kernel's result. ``fused_sample_shard``
    holds each vocab shard's kernel call of ``ops.fused_sample_shard`` (the
    shard's own draw from its online state, by ``check_sample``'s rule),
    counted among ``fused_sample``'s launches. Yields {name: {"calls",
    "max_abs_err"}}."""
    seen = {n: {"calls": 0, "max_abs_err": 0.0} for n in names}
    attr = {n: {"fused_sample_shard": "_fused_sample"}.get(n, n) for n in names}
    kernel = {n: getattr(ops, attr[n]) for n in names}

    def note(name, err):
        seen[name]["calls"] += 1
        seen[name]["max_abs_err"] = max(seen[name]["max_abs_err"], err)

    def rmsnorm(x, w, *, eps=1e-6, **whole):
        # the norms of one device's path: a row whole on its rank (the
        # gated norm passes its whole width, which is then the row's)
        width = whole.get("width", x.shape[-1])
        require(width == x.shape[-1], f"rmsnorm of {x.shape[-1]} of {width} columns")
        out = kernel["rmsnorm"](x, w, eps=eps, **whole)
        with torch.no_grad():
            ok, err = close(out, ref.rmsnorm(x, w, eps=eps), BF16_TOL)
        require(ok, f"rmsnorm {tuple(x.shape)} on the path: max abs err {err}")
        note("rmsnorm", err)
        return out

    def flash_attention(q, k, v, **kw):
        out = kernel["flash_attention"](q, k, v, **kw)
        with torch.no_grad():
            ok, err = close(out, ref.flash_attention(q, k, v, **kw), BF16_TOL)
        require(ok, f"flash_attention q {tuple(q.shape)} {kw} on the path: max abs err {err}")
        note("flash_attention", err)
        return out

    def decode_attention(q, k, v, cache_len, **kw):
        got = kernel["decode_attention"](q, k, v, cache_len, **kw)
        note("decode_attention", check_decode(
            torch, ref, got, ref.decode_attention(q, k, v, cache_len, **kw), cache_len,
            kw.get("pos_offset", 0), f"decode_attention q {tuple(q.shape)} on the path"))
        return got

    def decode_attention_quant(q, k, v, k_scale, v_scale, cache_len, **kw):
        got = kernel["decode_attention_quant"](q, k, v, k_scale, v_scale, cache_len, **kw)
        note("decode_attention_quant", check_decode(
            torch, ref, got, ref.decode_attention_quant(q, k, v, k_scale, v_scale, cache_len,
                                                        **kw),
            cache_len, kw.get("pos_offset", 0),
            f"decode_attention_quant q {tuple(q.shape)} on the path"))
        return got

    def fused_sample(h, w_head, seeds, inv_temp, *, vocab_size=None, top_p=1.0):
        got = kernel["fused_sample"](h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                                     top_p=top_p)
        if top_p >= 1.0:  # below 1 the call takes the plain sampler itself
            note("fused_sample", check_sample(torch, ref, got, h, w_head, seeds, inv_temp,
                                              vocab_size, f"B={h.shape[0]} on the path"))
        return got

    def fused_sample_shard(h, w_head, seeds, inv_temp, *, vocab_size=None, col_offset=0,
                           state=False):
        got = kernel["fused_sample_shard"](h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                                           col_offset=col_offset, state=state)
        if state:  # a vocab shard's online state: the shard's own draw
            floats, idx = got
            tok, lp = ref.merge_sample_states([tuple(floats[:, k] for k in range(4))
                                               + (idx.long(),)])
            note("fused_sample_shard", check_sample(
                torch, ref, (tok - col_offset, lp), h, w_head, seeds, inv_temp, vocab_size,
                f"shard at {col_offset} B={h.shape[0]} on the path", col_offset=col_offset))
        return got

    def ssd(x, dt, A, Bm, Cm, D, *, chunk=128, return_state=False):
        y, h = kernel["ssd"](x, dt, A, Bm, Cm, D, chunk=chunk, return_state=True)
        with torch.no_grad():
            y_r, h_r = ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=min(chunk, x.shape[1]),
                                       return_state=True)
            (ok, err), (ok_h, err_h) = close(y, y_r, SSD_Y_TOL), close(h, h_r, SSD_STATE_TOL)
        require(ok and ok_h, f"ssd x {tuple(x.shape)} on the path: y err {err}, "
                             f"state err {err_h}")
        note("ssd", err)
        return (y, h) if return_state else y

    checked = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
               "decode_attention": decode_attention,
               "decode_attention_quant": decode_attention_quant, "fused_sample": fused_sample,
               "fused_sample_shard": fused_sample_shard, "ssd": ssd}
    for n in names:
        setattr(ops, attr[n], checked[n])
    try:
        yield seen
    finally:
        for n in names:
            setattr(ops, attr[n], kernel[n])


def path_kernels(cfg):
    """The kernels an RL iteration of ``cfg`` launches: the norm (unless it
    is layernorm) and the sampler; flash and decode attention with
    attention layers; the scan with SSD layers."""
    mixers = {k[0] for k in cfg.layer_kinds()}
    return ((("rmsnorm",) if cfg.norm_type == "rmsnorm" else ())
            + (("flash_attention", "decode_attention") if "attn" in mixers else ())
            + (("ssd",) if "ssm" in mixers else ()) + ("fused_sample",))


def iteration_launches(cfg, names, max_new_tokens: int, dag):
    """Launch counts of one RL iteration of ``dag``: each GENERATE node a
    lockstep generate of ``max_new_tokens - 1`` decode steps, each
    MODEL_INFERENCE node (the reference's or the critic's values) a forward,
    and each MODEL_TRAIN node (the actor's or the critic's step) the forward,
    then the layers again in the backward (remat) with the final norm outside
    the checkpoint; the backward itself is the plain VJP and launches
    nothing. A forward runs a norm before every mixer and every MLP, a gated
    norm in every SSD mixer and the final norm, one flash attention per
    attention layer and one scan per SSD layer. Returns (per iteration, per
    actor step)."""
    from repro_torch.core.dag import NodeType

    kinds = cfg.layer_kinds()
    attn = sum(k[0] == "attn" for k in kinds)
    ssd = len(kinds) - attn
    fwd = {"rmsnorm": norm_launches(cfg), "flash_attention": attn, "ssd": ssd}
    step = {n: 2 * c - (n == "rmsnorm" and c > 0) for n, c in fwd.items()}
    types = [node.type for node in dag.nodes.values()]
    gens = types.count(NodeType.GENERATE)
    per_iter = forward_launches(cfg, names, gens, gens * (max_new_tokens - 1))
    for n in fwd:
        per_iter[n] += (types.count(NodeType.MODEL_INFERENCE) * fwd[n]
                        + types.count(NodeType.MODEL_TRAIN) * step[n])
    return per_iter, step


def sync_ms(torch, fn):
    """(fn's result, its synchronised wall ms)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def split_step(torch, trainer, model, rl, state, batch):
    """One actor step as ``make_actor_step`` takes it, marked between the
    forward (with remat), the backward and clip + AdamW. Returns (the new
    state, (forward, backward, clip + AdamW ms))."""
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    _, grads = trainer.value_and_grad(
        lambda p: trainer.actor_loss_fn(model, rl, p, batch), state.params, on_loss=mark)
    mark()
    (state, _), t_opt = sync_ms(torch, lambda: trainer.make_actor_apply_fn(rl)(state, grads))
    return state, ((marks[1] - marks[0]) * 1e3, (marks[2] - marks[1]) * 1e3, t_opt)


def timed_steps(torch, trainer, model, rl, state, batch, label):
    """3 split actor steps, then 3 whole ones: the medians, tokens/s and the
    peak memory since they began. Returns (the new state, summary)."""
    actor_step = trainer.make_actor_step(model, rl)
    torch.cuda.reset_peak_memory_stats()
    splits = []
    for _ in range(3):
        state, split = split_step(torch, trainer, model, rl, state, batch)
        splits.append(split)
    fwd, bwd, opt = (statistics.median(x) for x in zip(*splits))
    wholes = []
    for _ in range(3):
        (state, _), t = sync_ms(torch, lambda: actor_step(state, batch))
        wholes.append(t)
    whole = statistics.median(wholes)
    summary = {"batch": list(batch["tokens"].shape), "forward_ms": fwd,
               "backward_ms": bwd, "clip_adamw_ms": opt, "step_ms": whole,
               "trained_tokens_per_s": batch["tokens"].numel() / whole * 1e3,
               "response_tokens_per_s": int(batch["response_mask"].sum()) / whole * 1e3,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps({label: summary}), flush=True)
    return state, summary


@contextlib.contextmanager
def patched(obj, name: str, value):
    """While open, ``obj.<name>`` is ``value``."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def grad_check(torch, ops, _build, trainer, loss_fn, params, step_launches, control, label,
               zero_grad=()):
    """A loss (``loss_fn(params) -> (loss, metrics)``: the actor's on a
    batch, or a model's own) and its gradient through the kernels against
    ``ops.set_mode("ref")``. The launches of the loss + grad equal
    ``step_launches``; an actor loss's step-0 ratio_mean lies within 1 +-
    RATIO_TOL; every leaf is finite and nonzero; the loss lies within GRAD_DRIFT_FACTOR
    x the plain path's own drift. The drift is the plain path against
    itself under ``control`` (a context that makes it another, equally
    valid rounding of the same function). The leaves are held per
    parameter (a kind: one parameter in every block where it recurs): each
    leaf's relative L2 error and cosine within GRAD_DRIFT_FACTOR x the
    largest drift of its kind, and the kind's median error within
    GRAD_DRIFT_FACTOR x its median drift (drifts no less than GRAD_FLOOR).
    A leaf of 80 elements (A_log, D, dt_bias) draws a noisy drift, so its
    own drift alone makes no limit: the kind's leaves pool it. Every leaf's
    numbers go to build/<label>_leaves.json. The leaves whose names end
    with one of ``zero_grad`` have a gradient that is zero in exact
    arithmetic (a cross-attention's key bias: it adds the same to every
    score of a query, which the softmax cancels): they are held finite, and
    their largest |grad| is reported, not held to a drift. Prints and
    returns {label: summary}."""
    from repro_torch import tree

    def loss_and_grads():
        _build.reset_launches()
        (loss, metrics), grads = trainer.value_and_grad(loss_fn, params)
        torch.cuda.synchronize()
        return float(loss), metrics, grads, dict(_build.LAUNCHES)

    loss_k, metrics_k, g_k, launched = loss_and_grads()
    require(all(launched[n] == step_launches.get(n, 0) for n in launched),
            f"{label}: launches per loss + grad {launched}, expected {step_launches}")
    ratio0 = float(metrics_k["ratio_mean"]) if "ratio_mean" in metrics_k else None
    require(ratio0 is None or abs(ratio0 - 1.0) <= RATIO_TOL,
            f"{label}: step-0 ratio_mean {ratio0}: the training engine disagrees with the "
            f"sampler")
    names = leaf_names(g_k)
    zero = {name: float(g.float().abs().max()) for name, g in zip(names, tree.leaves(g_k))
            if name.endswith(tuple(zero_grad))}
    for name, g in zip(names, tree.leaves(g_k)):
        require(bool(torch.isfinite(g).all()) and (name in zero or bool((g != 0).any())),
                f"{label}: {name} {tuple(g.shape)}: a gradient that is not finite or is zero")
    ops.set_mode("ref")
    try:
        loss_r, _, g_r, plain_launched = loss_and_grads()
        with control:
            loss_v, _, g_v, _ = loss_and_grads()
    finally:
        ops.set_mode(None)
    require(not any(plain_launched.values()), f"ref mode launched kernels: {plain_launched}")
    leaves = [{"leaf": name, "numel": r.numel(), "rel_l2": rel_l2(k, r),
               "cosine": cosine(k, r), "drift_rel_l2": rel_l2(v, r), "drift_cosine": cosine(v, r)}
              for name, k, r, v in zip(names, tree.leaves(g_k), tree.leaves(g_r),
                                       tree.leaves(g_v)) if name not in zero]
    del g_k, g_r, g_v
    kinds = {}
    for e in leaves:
        kinds.setdefault(re.sub(r"\[\d+\]", "", e["leaf"]), []).append(e)
    by_kind, bad = {}, []
    for kind, es in kinds.items():
        drift = max(max(e["drift_rel_l2"] for e in es), GRAD_FLOOR)
        drift_c = max(max(1.0 - e["drift_cosine"] for e in es), GRAD_FLOOR ** 2 / 2)
        for e in es:
            e.update(rel_l2_limit=GRAD_DRIFT_FACTOR * drift,
                     cosine_limit=1.0 - GRAD_DRIFT_FACTOR * drift_c,
                     ratio=e["rel_l2"] / drift, cosine_ratio=(1.0 - e["cosine"]) / drift_c,
                     own_ratio=e["rel_l2"] / max(e["drift_rel_l2"], GRAD_FLOOR))
            if e["rel_l2"] > e["rel_l2_limit"] or e["cosine"] < e["cosine_limit"]:
                bad.append(e["leaf"])
        med, med_drift = (statistics.median(e[k] for e in es) for k in ("rel_l2", "drift_rel_l2"))
        med_limit = GRAD_DRIFT_FACTOR * max(med_drift, GRAD_FLOOR)
        if med > med_limit:
            bad.append(f"{kind} (median)")
        by_kind[kind] = {"leaves": len(es), "drift_rel_l2_median": med_drift,
                         "drift_rel_l2_max": drift, "rel_l2_median": med,
                         "rel_l2_max": max(e["rel_l2"] for e in es),
                         "rel_l2_limit": GRAD_DRIFT_FACTOR * drift, "median_limit": med_limit,
                         "ratio_max": max(e["ratio"] for e in es),
                         "cosine_ratio_max": max(e["cosine_ratio"] for e in es),
                         "own_ratio_max": max(e["own_ratio"] for e in es)}
    out = ROOT / "build" / f"{label}_leaves.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(leaves))
    worst = max(leaves, key=lambda e: e["ratio"])
    worst_c = max(leaves, key=lambda e: e["cosine_ratio"])
    loss_limit = GRAD_DRIFT_FACTOR * abs(loss_v - loss_r)
    summary = {
        "step0_ratio_mean": ratio0,
        "loss_kernel": loss_k, "loss_plain": loss_r, "loss_plain_control": loss_v,
        "loss_limit": loss_limit, "leaves": len(leaves), "leaves_beyond_limit": len(bad),
        "worst_ratio": worst["ratio"], "worst_ratio_leaf": worst["leaf"],
        "worst_ratio_rel_l2": worst["rel_l2"], "worst_ratio_drift": worst["drift_rel_l2"],
        "worst_cosine_ratio": worst_c["cosine_ratio"], "worst_cosine_ratio_leaf": worst_c["leaf"],
        "worst_rel_l2": max(e["rel_l2"] for e in leaves),
        "worst_cosine": min(e["cosine"] for e in leaves),
        "plain_drift_rel_l2": max(e["drift_rel_l2"] for e in leaves),
        "plain_drift_worst_leaf": max(leaves, key=lambda e: e["drift_rel_l2"])["leaf"],
        "by_kind": by_kind, "launches_per_loss_and_grad": launched,
        "zero_in_exact_arithmetic_max_abs_grad": zero}
    print(json.dumps({label: summary}), flush=True)
    require(abs(loss_k - loss_r) <= loss_limit,
            f"{label}: loss: kernel path {loss_k}, plain path {loss_r} (limit {loss_limit})")
    require(not bad, f"{label}: {len(bad)} leaves or kinds beyond {GRAD_DRIFT_FACTOR}x their "
                     f"kind's drift, e.g. {bad[:4]}; worst ratio {worst['ratio']} at "
                     f"{worst['leaf']}")
    return summary


def long_step(torch, ops, ref, trainer, model, rl, state, ref_params, names, step_launches,
              label):
    """One actor step at LONG_B x LONG_S (random tokens, the last LONG_S -
    LONG_PROMPT positions the response, random advantages): a warm-up step
    with every call of the kernels ``names`` held against its plain version
    (the calls equal ``step_launches``), then ``timed_steps``. Returns (the
    new state, summary)."""
    g_long = torch.Generator(device=DEV).manual_seed(3)
    tokens = torch.randint(3, model.cfg.vocab_size, (LONG_B, LONG_S), generator=g_long,
                           device=DEV, dtype=torch.int32)
    mask = (torch.arange(LONG_S, device=DEV) >= LONG_PROMPT).expand(LONG_B, -1).clone()
    with torch.no_grad():
        old = model.logprobs(state.params, tokens)[0] * mask
        ref_lp = model.logprobs(ref_params, tokens)[0] * mask
    batch = {"tokens": tokens, "response_mask": mask, "old_logprob": old,
             "ref_logprob": ref_lp,
             "advantages": torch.randn((LONG_B, 1), generator=g_long, device=DEV) * mask}
    with held_to_plain(torch, ops, ref, names) as held:
        state, _ = split_step(torch, trainer, model, rl, state, batch)
    require(all(held[n]["calls"] == step_launches.get(n, 0) for n in names),
            f"{label} held to plain: calls {held}, expected {step_launches}")
    print(json.dumps({"check": f"{label}_held_to_plain", "kernels": held}), flush=True)
    return timed_steps(torch, trainer, model, rl, state, batch, label)


def norm_record(torch, ops, ref, F, randn, R, D):
    """``rmsnorm`` over R rows of D at a training shape: the kernel against
    its plain version, timed beside it and ``F.rms_norm``, and the plain-VJP
    backward (``RMSNormFn``'s) beside ``F.rms_norm``'s; the bounds."""
    x, w = randn(R, D), randn(D, scale=0.1, dtype=torch.float32)
    gy = randn(R, D)
    ok, err_n = close(ops.rmsnorm(x, w), ref.rmsnorm(x, w), BF16_TOL)
    require(ok, f"rmsnorm {R} x {D}: max abs err {err_n}")
    n_bound, n_by = bound_ms(2 * R * D * 2 + D * 4, 4 * R * D, FP32_FLOP_PER_S)
    nb_bound, nb_by = bound_ms(3 * R * D * 2 + 2 * D * 4, 10 * R * D, FP32_FLOP_PER_S)
    wl = (1.0 + w).to(torch.bfloat16)
    xl, wll = x.detach().requires_grad_(), wl.detach().requires_grad_()
    ln_out = F.rms_norm(xl, (D,), weight=wll, eps=1e-6)
    return {
        "shape": [R, D], "max_abs_err": err_n,
        "ms": device_ms(lambda: ops.rmsnorm(x, w)),
        "plain_ms": device_ms(lambda: ref.rmsnorm(x, w)),
        "bound_ms": n_bound, "bound_by": n_by,
        "library_ms": device_ms(lambda: F.rms_norm(x, (D,), weight=wl, eps=1e-6)),
        "backward": {"plain_vjp_ms": device_ms(lambda: ref.vjp(ref.rmsnorm, (x, w), gy)),
                     "bound_ms": nb_bound, "bound_by": nb_by,
                     "library_ms": device_ms(lambda: torch.autograd.grad(
                         ln_out, (xl, wll), gy, retain_graph=True)),
                     "library": "F.rms_norm's backward (retained graph)"}}


def training_phase(torch, ops, ref, F, _build, serve, generate, records, profile: bool):
    """One synchronous GRPO iteration in the order of ``rl.algorithms.grpo_dag``
    on full gemma-2b: generate -> reference logprobs -> math reward -> GRPO
    advantage -> actor step (loss -> grad -> clip -> AdamW), 3 times, and
    once more with every kernel call held against its plain version; then on
    the lockstep rollouts (B=8, prompt 128, 32 new) the training engine's
    logprobs against the sampler's, the gradient check against the plain
    path and the split time of one actor step; the split time of one actor
    step at LONG_B x LONG_S; the kernels at both training shapes. Adds
    ``training`` and ``training_long`` entries to the rmsnorm and flash
    records. Returns (launch counts of the GRPO iterations, summary, profile
    job)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.rl import algorithms, reward, trainer

    model, params, tok = build_model(torch, serve)
    cfg = model.cfg
    rl = trainer.RLConfig()
    ref_params = tree.map(torch.clone, params)
    state = trainer.init_state(params)
    del params
    torch.cuda.synchronize()
    print(f"[train] actor, reference and fp32 AdamW moments: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    spec = algorithms.get_algorithm(rl.algorithm)
    advantage = spec.make_advantage(rl)
    actor_step = trainer.make_actor_step(model, rl)
    per_iter, step_launches = iteration_launches(cfg, _build.LAUNCHES, rl.max_new_tokens,
                                                 spec.dag_factory())
    names = path_kernels(cfg)

    def as_batch(res):
        # the stage boundary: rollouts leave inference mode as ordinary tensors
        return {"tokens": res.tokens.clone(), "response_mask": res.response_mask.clone(),
                "old_logprob": res.old_logprob.clone()}

    def ref_logprobs(tokens):
        with torch.no_grad():
            return model.logprobs(ref_params, tokens)[0]

    # ---- 1. the GRPO iteration, 3 times ----
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=DEV).manual_seed(0)

    def iteration(it):
        nonlocal state
        before = dict(_build.LAUNCHES)
        ids, answers = reward.make_math_prompts(rng, GRPO_PROMPTS, tok)
        prompts = torch.from_numpy(np.repeat(ids, rl.group_size, axis=0)).to(DEV)
        answers = torch.from_numpy(np.repeat(answers, rl.group_size)).to(DEV)
        ms = {}
        res, ms["generate"] = sync_ms(torch, lambda: generate(
            model, state.params, prompts, gen, max_new=rl.max_new_tokens,
            temperature=rl.temperature, eos_id=tok.eos_id))
        batch = as_batch(res)
        batch["ref_logprob"], ms["reference"] = sync_ms(
            torch, lambda: ref_logprobs(batch["tokens"]))
        rewards, ms["reward"] = sync_ms(torch, lambda: reward.math_reward_tokens(
            batch["tokens"], batch["response_mask"], answers, tok))
        batch["advantages"], ms["advantage"] = sync_ms(
            torch, lambda: advantage(rewards, batch["response_mask"]))
        (state, metrics), ms["actor_step"] = sync_ms(torch, lambda: actor_step(state, batch))
        got = {n: _build.LAUNCHES[n] - before[n] for n in _build.LAUNCHES}
        require(got == per_iter, f"GRPO iteration {it}: launches {got}, expected {per_iter}")
        row = {"iteration": it, "reward/mean": float(rewards.mean()),
               **{f"actor/{k}": float(metrics[k]) for k in
                  ("loss", "grad_norm", "entropy", "kl", "clipfrac", "ratio_mean")},
               "ms": ms, "response_tokens": int(batch["response_mask"].sum())}
        require(all(np.isfinite(v) for k, v in row.items() if k.startswith(("actor/", "reward"))),
                f"GRPO iteration {it}: non-finite metric {row}")
        require(abs(row["actor/ratio_mean"] - 1.0) <= RATIO_TOL,
                f"GRPO iteration {it}: ratio_mean {row['actor/ratio_mean']}: the training "
                f"engine disagrees with the sampler")
        require(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
                "GRPO rollout token out of range")
        return row

    iters = []
    _build.reset_launches()
    for it in range(GRPO_ITERS):
        iters.append(iteration(it))
        print(json.dumps({"grpo": iters[-1]}), flush=True)
    counts = dict(_build.LAUNCHES)
    # once more, every kernel call held against its plain version on the
    # call's own inputs (not counted in the path's launches, timed slower)
    with held_to_plain(torch, ops, ref, names) as held:
        row = iteration(GRPO_ITERS)
    require(all(held[n]["calls"] == per_iter[n] for n in names),
            f"GRPO iteration held to plain: calls {held}, expected {per_iter}")
    print(json.dumps({"check": "grpo_iteration_held_to_plain", "kernels": held,
                      "ratio_mean": row["actor/ratio_mean"]}), flush=True)

    # ---- 2. engine agreement on the lockstep cell's rollouts ----
    _, ids = serve.prompts(tok, B, PROMPT)
    prompt = torch.from_numpy(ids).to(DEV)
    res = generate(model, state.params, prompt, torch.Generator(device=DEV).manual_seed(1),
                   max_new=MAX_NEW, temperature=rl.temperature, eos_id=tok.eos_id)
    batch = as_batch(res)
    mask = batch["response_mask"]
    with torch.no_grad():
        lp_train = model.logprobs(state.params, batch["tokens"])[0]
    delta = (lp_train - batch["old_logprob"])[mask].abs()
    agreement = {"logprob_max_abs_diff": float(delta.max()),
                 "logprob_mean_abs_diff": float(delta.mean()),
                 "response_tokens": int(mask.sum())}
    batch["ref_logprob"] = ref_logprobs(batch["tokens"])
    seq_rewards = torch.rand(B, generator=torch.Generator(device=DEV).manual_seed(2),
                             device=DEV)
    batch["advantages"] = advantage(seq_rewards, mask)  # one group of 8: never all equal

    # ---- 3. the gradient check at full width: the drift of the plain path
    # with the attention probabilities kept in fp32 ----
    gcheck = grad_check(
        torch, ops, _build, trainer, lambda p: trainer.actor_loss_fn(model, rl, p, batch),
        state.params, step_launches, fp32_attention(ref), "grad_check")
    agreement["step0_ratio_mean"] = gcheck["step0_ratio_mean"]
    print(json.dumps({"engine_agreement": agreement}), flush=True)
    # a kernel without a backward refuses an input that requires grad
    qd = torch.zeros((B, HEADS, HEAD_DIM), dtype=torch.bfloat16, device=DEV, requires_grad=True)
    kc = torch.zeros((B, SMAX, 1, HEAD_DIM), dtype=torch.bfloat16, device=DEV)
    try:
        ops.decode_attention(qd, kc, kc, torch.full((B,), 4, dtype=torch.int32, device=DEV))
        raise AssertionError("decode_attention took an input that requires grad")
    except RuntimeError as e:
        require("no backward" in str(e), f"decode_attention raised {e}")
    print(json.dumps({"check": "no_backward_raises", "kernel": "decode_attention"}), flush=True)

    # ---- 4. one actor step, split; tokens/s and peak memory ----
    state, _ = split_step(torch, trainer, model, rl, state, batch)  # warm
    state, step_summary = timed_steps(torch, trainer, model, rl, state, batch, "actor_step")

    # ---- 5. one actor step at an RL response length ----
    state, long_summary = long_step(torch, ops, ref, trainer, model, rl, state, ref_params,
                                    names, step_launches, "actor_step_long")

    # ---- the kernels at the training shapes, and the plain-VJP backwards ----
    g = torch.Generator(device=DEV).manual_seed(99)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=DEV) * scale).to(dtype)

    for tag, Bt, S_T in (("training", B, PROMPT + MAX_NEW), ("training_long", LONG_B, LONG_S)):
        q = randn(Bt, S_T, HEADS, HEAD_DIM)
        q[:, :, REAL_HEADS:] = 0
        k, v = randn(Bt, S_T, 1, HEAD_DIM), randn(Bt, S_T, 1, HEAD_DIM)
        go = randn(Bt, S_T, HEADS, HEAD_DIM)
        ok, err_f = close(ops.flash_attention(q, k, v), ref.flash_attention(q, k, v), BF16_TOL)
        require(ok, f"flash_attention at the {tag} shape: max abs err {err_f}")
        pairs = S_T * (S_T + 1) // 2
        f_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
        f_bound, f_by = bound_ms(f_bytes, 4 * Bt * HEADS * HEAD_DIM * pairs,
                                 BF16_TENSOR_FLOP_PER_S)
        # backward: q, k, v, o's cotangent in; dq, dk, dv out; the products of
        # the recomputed logits, dP, dQ, dK, dV: 2.5x the forward's
        b_bound, b_by = bound_ms(2 * f_bytes, 10 * Bt * HEADS * HEAD_DIM * pairs,
                                 BF16_TENSOR_FLOP_PER_S)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sd_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        got_t = go.transpose(1, 2)
        records["flash_attention"][tag] = {
            "shape": {"q": list(q.shape), "kv": list(k.shape)}, "max_abs_err": err_f,
            "ms": device_ms(lambda: ops.flash_attention(q, k, v)),
            "plain_ms": device_ms(lambda: ref.flash_attention(q, k, v)),
            "bound_ms": f_bound, "bound_by": f_by,
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True)),
            "backward": {"plain_vjp_ms": device_ms(lambda: ref.vjp(ref.flash_attention,
                                                                    (q, k, v), go)),
                         "bound_ms": b_bound, "bound_by": b_by,
                         "library_ms": device_ms(lambda: torch.autograd.grad(
                             sd_out, (qt, kt, vt), got_t, retain_graph=True)),
                         "library": "SDPA's backward (retained graph)"}}
        print(json.dumps({"check": f"flash_attention/{tag}",
                          **records["flash_attention"][tag]}), flush=True)
        records["rmsnorm"][tag] = norm_record(torch, ops, ref, F, randn, Bt * S_T, D_MODEL)
        print(json.dumps({"check": f"rmsnorm/{tag}", **records["rmsnorm"][tag]}), flush=True)
        del sd_out

    summary = {"iterations": iters, "engine_agreement": agreement, "grad_check": gcheck,
               "actor_step": step_summary, "actor_step_long": long_summary,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    def profile_job():
        # the training state is drawn again here, not kept alive until the
        # profiles run, so that phase 8 has the card's memory
        _, params_p, _ = build_model(torch, serve)
        state_p, _ = actor_step(trainer.init_state(params_p), batch)  # warm-up
        busy_ms, wall_ms = busy_share(torch, lambda: actor_step(state_p, batch),
                                      ROOT / "build" / "profile_train.txt")
        whole = step_summary["step_ms"]
        print(json.dumps({"profile_actor_step": {
            "device_busy_ms": busy_ms, "profiled_step_ms": wall_ms, "step_ms": whole,
            "device_busy_share": busy_ms / whole}}), flush=True)

    return counts, summary, (profile_job if profile else None)


# phase 8: the GRPO pipeline through the training entry point
# (repro_torch.launch.train) at phase 7's shape: one warm-up iteration, then
# PIPE_TIMED timed ones, in each coordinator arm (3 before the script
# outgrew its time limit; phases 9, 10, 12 and 13's GRPO too)
PIPE_TIMED = 2
PIPE_FLAGS = ["--seed", "0", "--prompts-per-iter", str(GRPO_PROMPTS),
              "--group-size", "8", "--max-new-tokens", "16"]
PIPE_ITERS = ["--iters", str(1 + PIPE_TIMED)]
# RLConfig's defaults but two, so that every actor step moves the weights:
# random weights score 0 (advantages 0) and the actor starts as the
# reference (KL 0), so only an entropy bonus gives the step a gradient; and
# at RLConfig's lr of 1e-6 the first AdamW step (+-lr a weight) is below
# half a bf16 ulp of every weight above 2^-11 in magnitude, so the
# entry point's own default lr is taken
PIPE_RL = {"entropy_coef": 0.01, "lr": 1e-4}
# phases 9 and 10: the distributed arm twice (its spread), then the centralized one
PIPE_ARMS_SHORT = (("distributed", 0), ("distributed", 1), ("centralized", 0))
# PPO: the critic's lr as the actor's, so that its AdamW steps survive bf16
# rounding as the actor's do
PPO_RL = {**PIPE_RL, "critic_lr": 1e-4}
PIPE_ARMS = {"distributed": [],
             "double_buffer_prefetch": ["--double-buffer", "--prefetch", "1"],
             "centralized": ["--centralized-baseline"]}
# BufferStats fields that count operations (the others count bytes, which
# depend on the shapes)
BUFFER_COUNTS = ("puts", "fast_path_hits", "redistributions", "overlap_hits", "sync_waits",
                 "rotations")


@contextlib.contextmanager
def observed_iterations(torch, _build, hold=None):
    """While open, every ``run_iteration`` of the DAG worker and of the async
    worker is bracketed by ``torch.cuda.synchronize`` (its synchronised wall
    time and its kernel launches are recorded with its metrics), the tokens
    of every rollout of ``rl.rollout.generate`` are kept, and so is every
    result of the continuous engine. With ``hold`` (a function that returns
    a context such as ``held_to_plain``'s), the first iteration runs inside
    that context, and what it yields is kept. Yields {"iterations",
    "tokens", "engine", "held"}."""
    from repro_torch.core import async_worker as async_mod
    from repro_torch.core import worker as worker_mod
    from repro_torch.rl import rollout as rollout_mod
    from repro_torch.rl.rollout_engine import ContinuousRolloutEngine

    seen = {"iterations": [], "tokens": [], "engine": [], "held": None}
    workers = (worker_mod.DAGWorker, async_mod.AsyncDAGWorker)
    run_iterations = [cls.__dict__["run_iteration"] for cls in workers]
    generate, engine_call = rollout_mod.generate, ContinuousRolloutEngine.__call__

    def timed(run_iteration):
        def run(self):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t = time.perf_counter()
            if hold is not None and not seen["iterations"]:
                with hold() as seen["held"]:
                    metrics = run_iteration(self)
            else:
                metrics = run_iteration(self)
            torch.cuda.synchronize()
            seen["iterations"].append({
                "ms": (time.perf_counter() - t) * 1e3, "metrics": metrics,
                "launches": {n: _build.LAUNCHES[n] - before[n] for n in _build.LAUNCHES}})
            return metrics
        return run

    def kept(*args, **kw):
        res = generate(*args, **kw)
        seen["tokens"].append(res.tokens)
        return res

    def engine_kept(self, *args, **kw):
        res = engine_call(self, *args, **kw)
        seen["engine"].append({"result": res, "stats": dict(self.last_stats)})
        return res

    for cls, run_iteration in zip(workers, run_iterations):
        cls.run_iteration = timed(run_iteration)
    rollout_mod.generate = kept
    ContinuousRolloutEngine.__call__ = engine_kept
    try:
        yield seen
    finally:
        for cls, run_iteration in zip(workers, run_iterations):
            cls.run_iteration = run_iteration
        rollout_mod.generate = generate
        ContinuousRolloutEngine.__call__ = engine_call


def experiment_file(label: str, flags, rl, layers=None) -> Path:
    """``build/<label>_experiment.json``: the spec ``launch.train`` dumps for
    ``flags`` (the arch, the algorithm, the env) and PIPE_FLAGS, with ``rl``
    written over its RLConfig (and the model cut to ``layers`` layers)."""
    from repro_torch.launch import train

    path = ROOT / "build" / f"{label}_experiment.json"
    path.parent.mkdir(exist_ok=True)
    train.main(flags + PIPE_FLAGS + ["--dump-experiment", str(path)])
    spec = json.loads(path.read_text())
    spec["rl"].update(rl)
    if layers is not None:
        spec["model"]["num_layers"] = layers
    path.write_text(json.dumps(spec))
    return path


def pipeline_phase(torch, ops, ref, _build, *, label="pipeline", flags=ARCH_FLAGS, rl=PIPE_RL,
                   arms=(("distributed", 0), ("distributed", 1),
                         ("double_buffer_prefetch", 0), ("centralized", 0)),
                   hand_rows=None, layers=None):
    """An RL algorithm through ``launch.train.main`` at full width and depth,
    or on ``layers`` layers (``flags``: the arch and the algorithm), in the
    coordinator ``arms`` one
    after another (each pipeline freed before the next is built), the
    distributed arm twice to measure the run-to-run spread. Every arm runs
    one experiment file (``rl`` on top of the flags' spec) with the arm's
    flags layered on. The first run's warm-up iteration is held to plain
    (``held_to_plain``: every call of the path's kernels against its plain
    version on the call's own inputs; the calls equal the launches of an
    iteration). Checks each iteration's launches against
    ``iteration_launches`` of the run's DAG, every metric finite, ratio_mean within
    1 +- RATIO_TOL, a nonzero gradient in every iteration, a nonzero KL from
    iteration 1 where the loss has one, some actor weights changed (and under
    PPO a finite critic loss, a nonzero critic gradient and some critic
    weights changed), iteration 0 bitwise equal across arms and later
    iterations within the distributed arm's own spread, and the buffer
    counts against a CPU run of the same DAG and iterations (with the
    distributed arm alone in ``arms``, its per-iteration checks and the
    buffer counts). ``hand_rows``
    are phase 7's hand-composed iterations, where the path has them. Prints
    ``{label + "_arm": ...}`` lines and ``{label: ...}``. Returns (the
    launch counts of the first run, the summary)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.api import ExperimentSpec
    from repro_torch.core.dag import DAG
    from repro_torch.core.pipeline import _seeds
    from repro_torch.launch import train
    from repro_torch.rl import algorithms
    from repro_torch.rl import critic as critic_mod

    t_phase = time.perf_counter()
    exp_path = experiment_file(label, flags, rl, layers)
    exp = ExperimentSpec.from_json(exp_path.read_text())
    cfg, algorithm = exp.model, algorithms.get_algorithm(exp.rl.algorithm)
    critic = algorithm.uses_critic
    dag = DAG.from_spec(exp.dag) if exp.dag is not None else algorithm.dag_factory()
    per_iter, _ = iteration_launches(cfg, _build.LAUNCHES, exp.rl.max_new_tokens, dag)
    names = path_kernels(cfg)
    runs, main_counts, held = {}, None, None
    for arm, rep in arms:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        hold = None if runs else (lambda: held_to_plain(torch, ops, ref, names))
        with observed_iterations(torch, _build, hold) as seen:
            out = train.main(["--experiment", str(exp_path), "--device", DEV] + PIPE_ITERS
                             + PIPE_ARMS[arm])
        if main_counts is None:
            main_counts, held = dict(_build.LAUNCHES), seen["held"]
            require(all(held[n]["calls"] == per_iter[n] for n in names),
                    f"{label} iteration held to plain: calls {held}, expected {per_iter}")
            print(json.dumps({"check": f"{label}_iteration_held_to_plain", "kernels": held}),
                  flush=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        pipe = out["pipeline"]
        stats = pipe.buffer.stats

        def moved_share(pairs):  # the share of the weights that the run's steps changed
            return (sum(int((a != b).sum()) for a, b in pairs)
                    / sum(a.numel() for a, _ in pairs))

        moved = moved_share(list(zip(tree.leaves(pipe.ctx.actor_state.params),
                                     tree.leaves(pipe.ctx.ref_params))))
        critic_moved = None
        if critic:  # the critic's initial weights, drawn again from the run's seed
            start = critic_mod.init(cfg, torch.Generator(device=DEV).manual_seed(
                _seeds(exp.seed)[1]), device=DEV)
            critic_moved = moved_share(list(zip(tree.leaves(pipe.ctx.critic_state.params),
                                                tree.leaves(start))))
            del start
        run = {"iterations": seen["iterations"], "tokens": seen["tokens"],
               "counts": {k: getattr(stats, k) for k in BUFFER_COUNTS},
               "bytes_moved": stats.bytes_moved,
               "bytes_through_controller": stats.bytes_through_controller,
               "controller_resident_bytes": getattr(pipe.buffer, "controller_resident_bytes", 0),
               "prefetch_hits": pipe.ctx.dataloader.prefetch_hits, "peak_gib": peak}
        del out, pipe, stats
        runs[(arm, rep)] = run
        require(len(run["iterations"]) == 1 + PIPE_TIMED == len(run["tokens"]),
                f"{label} {arm}: {len(run['iterations'])} iterations")
        for it, row in enumerate(run["iterations"]):
            m = row["metrics"]
            require(row["launches"] == per_iter,
                    f"{label} {arm} iteration {it}: launches {row['launches']}, "
                    f"expected {per_iter}")
            require(all(np.isfinite(v) for v in m.values()),
                    f"{label} {arm} iteration {it}: non-finite metric {m}")
            require(abs(m["actor/ratio_mean"] - 1.0) <= RATIO_TOL,
                    f"{label} {arm} iteration {it}: ratio_mean {m['actor/ratio_mean']}")
            require(m["actor/grad_norm"] > 0, f"{label} {arm} iteration {it}: zero gradient")
            require(it == 0 or m.get("actor/kl", 1.0) > 0,
                    f"{label} {arm} iteration {it}: KL {m.get('actor/kl')}, "
                    f"the weights did not move")
            if critic:
                require("critic/loss" in m and m["critic/grad_norm"] > 0,
                        f"{label} {arm} iteration {it}: critic metrics {m}")
            toks = run["tokens"][it]
            require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                    f"{label} token out of range")
        require(moved > 0, f"{label} {arm}: no weight of the actor moved")
        require(not critic or critic_moved > 0, f"{label} {arm}: no weight of the critic moved")
        timed = run["iterations"][1:]
        nodes = sorted(k for k in timed[0]["metrics"] if k.startswith("time/"))
        run["summary"] = {
            "arm": arm, "repeat": rep,
            "iteration_ms": [r["ms"] for r in run["iterations"]],
            "iteration_ms_median": statistics.median(r["ms"] for r in timed),
            "node_ms_median": {k[5:]: statistics.median(r["metrics"][k] * 1e3 for r in timed)
                               for k in nodes},
            "buffer_counts": run["counts"], "bytes_through_controller":
                run["bytes_through_controller"], "controller_resident_bytes":
                run["controller_resident_bytes"], "prefetch_hits": run["prefetch_hits"],
            "weights_moved_share": moved, "critic_weights_moved_share": critic_moved,
            "peak_gib": run["peak_gib"],
            "kl": [r["metrics"].get("actor/kl") for r in run["iterations"]],
            "grad_norm": [r["metrics"]["actor/grad_norm"] for r in run["iterations"]],
            "critic_loss": [r["metrics"].get("critic/loss") for r in run["iterations"]],
            "critic_grad_norm": [r["metrics"].get("critic/grad_norm")
                                 for r in run["iterations"]]}
        print(json.dumps({f"{label}_arm": run["summary"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    def values(run, it):
        return {k: v for k, v in run["iterations"][it]["metrics"].items()
                if not k.startswith("time/")}

    base = runs[("distributed", 0)]
    if len(runs) == 1:  # the distributed arm alone: no spread and no other arm
        cpu = train.main(["--smoke", "--device", "cpu"] + flags + PIPE_FLAGS + PIPE_ITERS)
        want = {k: getattr(cpu["pipeline"].buffer.stats, k) for k in BUFFER_COUNTS}
        require(base["counts"] == want and base["bytes_moved"] == 0
                and base["bytes_through_controller"] == 0,
                f"{label}: buffer counts {base['counts']}, the CPU run's {want}")
        summary = {"iteration_ms": {"distributed": base["summary"]["iteration_ms_median"]},
                   "launches_per_iteration": per_iter, "held_to_plain": held,
                   "node_ms_median": base["summary"]["node_ms_median"],
                   "peak_gib": base["peak_gib"], "phase_s": time.perf_counter() - t_phase}
        print(json.dumps({label: summary}), flush=True)
        return main_counts, summary
    # iteration 0: same seed, values that pass through the buffer unchanged
    for key, run in runs.items():
        require(torch.equal(run["tokens"][0], base["tokens"][0]),
                f"{label} {key}: iteration 0 rollouts differ from the distributed arm's")
        for k in ("reward/mean", "actor/loss"):
            require(values(run, 0)[k] == values(base, 0)[k],
                    f"{label} {key}: iteration 0 {k} {values(run, 0)[k]} != "
                    f"{values(base, 0)[k]}")
    # later iterations: the distributed arm against itself gives the spread
    # of each metric (the largest over the later iterations) and whether the
    # rollouts repeat; the other arms are held to it
    again = runs[("distributed", 1)]
    later = range(1, 1 + PIPE_TIMED)
    spread = {k: max(abs(values(again, it)[k] - values(base, it)[k]) for it in later)
              for k in values(base, 1)}
    tokens_repeat = all(torch.equal(again["tokens"][it], base["tokens"][it]) for it in later)
    others = sorted({arm for arm, _ in arms} - {"distributed"})
    for arm in others:
        run = runs[(arm, 0)]
        for it in later:
            if tokens_repeat:
                require(torch.equal(run["tokens"][it], base["tokens"][it]),
                        f"{label} {arm}: iteration {it} rollouts differ, and the "
                        f"distributed arm's repeat does not")
            for k, v in values(run, it).items():
                d = abs(v - values(base, it)[k])
                require(d <= spread[k], f"{label} {arm}: iteration {it} {k} differs by {d}, "
                                        f"beyond the run-to-run spread {spread[k]}")
    # the buffer counts of a CPU run of the same DAG, arms and iterations
    for arm in ["distributed", *others]:
        cpu = train.main(["--smoke", "--device", "cpu"] + flags + PIPE_FLAGS + PIPE_ITERS
                         + PIPE_ARMS[arm])
        want = {k: getattr(cpu["pipeline"].buffer.stats, k) for k in BUFFER_COUNTS}
        require(runs[(arm, 0)]["counts"] == want,
                f"{label} {arm}: buffer counts {runs[(arm, 0)]['counts']}, the CPU run's {want}")
        require(runs[(arm, 0)]["bytes_moved"] == 0, f"{label} {arm}: bytes moved on one device")
        require((runs[(arm, 0)]["bytes_through_controller"] > 0) == (arm == "centralized"),
                f"{label} {arm}: bytes through the controller")
    if ("double_buffer_prefetch", 0) in runs:
        require(runs[("double_buffer_prefetch", 0)]["prefetch_hits"] == PIPE_TIMED,
                f"{label}: the dataloader's look-ahead served no batch")

    arms_ms = {arm: runs[(arm, 0)]["summary"]["iteration_ms_median"]
               for arm in ["distributed", *others]}
    summary = {
        "iteration_ms": arms_ms,
        "distributed_repeat_iteration_ms": again["summary"]["iteration_ms_median"],
        "centralized_extra_ms": arms_ms["centralized"] - arms_ms["distributed"],
        "bytes_through_controller": runs[("centralized", 0)]["bytes_through_controller"],
        "controller_resident_bytes": runs[("centralized", 0)]["controller_resident_bytes"],
        "run_to_run_spread": spread, "rollouts_repeat": tokens_repeat,
        "launches_per_iteration": per_iter, "held_to_plain": held,
        "node_ms_median": base["summary"]["node_ms_median"],
        "peak_gib": max(r["peak_gib"] for r in runs.values()),
        "phase_s": time.perf_counter() - t_phase}
    if hand_rows is not None:
        hand = statistics.median(sum(r["ms"].values()) for r in hand_rows[1:])
        summary.update(hand_composed_iteration_ms=hand,
                       worker_and_buffer_ms=arms_ms["distributed"] - hand)
    if ("double_buffer_prefetch", 0) in runs:
        summary["prefetch_hits"] = runs[("double_buffer_prefetch", 0)]["prefetch_hits"]
    print(json.dumps({label: summary}), flush=True)
    return main_counts, summary


# phase 8's continuous-engine arm: the same experiment file through
# launch.train --rollout-slots ENGINE_SLOTS (16 rollouts over 4 slots)
ENGINE_SLOTS = 4


def engine_pipeline_arm(torch, ops, ref, _build, label="pipeline"):
    """GRPO through ``launch.train --rollout-slots ENGINE_SLOTS`` on the
    experiment file of ``pipeline_phase(label=label)``: the GENERATE stage
    runs the continuous engine. Its first iteration is held to plain
    (``held_to_plain``; the calls equal the iteration's launches), and every
    iteration's launches equal ``iteration_launches`` with the lockstep
    generate replaced by the engine's prefills and decode steps (its
    ``rollout/refills`` and ``rollout/decode_steps``); every metric finite,
    ratio_mean within 1 +- RATIO_TOL, a nonzero gradient, a nonzero KL from
    iteration 1, the slot pool's counts in the metrics, some actor weights
    changed. Prints ``{label + "_engine_arm": ...}``. Returns the launch
    counts of the run."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.api import ExperimentSpec
    from repro_torch.core.dag import DAG
    from repro_torch.launch import train
    from repro_torch.rl import algorithms
    from repro_torch.rl.rollout_engine import ContinuousRolloutEngine

    t_arm = time.perf_counter()
    exp_path = ROOT / "build" / f"{label}_experiment.json"
    exp = ExperimentSpec.from_json(exp_path.read_text())
    cfg, max_new = exp.model, exp.rl.max_new_tokens
    algorithm = algorithms.get_algorithm(exp.rl.algorithm)
    dag = DAG.from_spec(exp.dag) if exp.dag is not None else algorithm.dag_factory()
    per_iter, _ = iteration_launches(cfg, _build.LAUNCHES, max_new, dag)
    lockstep = forward_launches(cfg, _build.LAUNCHES, 1, max_new - 1)
    names = path_kernels(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with observed_iterations(torch, _build, lambda: held_to_plain(torch, ops, ref, names)) as seen:
        out = train.main(["--experiment", str(exp_path), "--device", DEV] + PIPE_ITERS
                         + ["--rollout-slots", str(ENGINE_SLOTS)])
    counts = dict(_build.LAUNCHES)
    pipe = out["pipeline"]
    require(isinstance(pipe.ctx.engines["generate"], ContinuousRolloutEngine),
            f"{label} engine arm: the GENERATE engine is not the continuous one")
    rows = seen["iterations"]
    require(len(rows) == 1 + PIPE_TIMED, f"{label} engine arm: {len(rows)} iterations")
    rollouts = exp.prompts_per_iter * algorithm.group_size(exp.rl)
    for it, row in enumerate(rows):
        m = row["metrics"]
        engine = forward_launches(cfg, _build.LAUNCHES, int(m["rollout/refills"]),
                                  int(m["rollout/decode_steps"]))
        want = {n: per_iter[n] - lockstep[n] + engine[n] for n in per_iter}
        require(row["launches"] == want, f"{label} engine arm iteration {it}: launches "
                                         f"{row['launches']}, expected {want}")
        require(all(np.isfinite(v) for v in m.values()),
                f"{label} engine arm iteration {it}: non-finite metric {m}")
        require(abs(m["actor/ratio_mean"] - 1.0) <= RATIO_TOL,
                f"{label} engine arm iteration {it}: ratio_mean {m['actor/ratio_mean']}")
        require(m["actor/grad_norm"] > 0 and (it == 0 or m["actor/kl"] > 0),
                f"{label} engine arm iteration {it}: grad {m['actor/grad_norm']}, "
                f"KL {m['actor/kl']}")
        require(m["rollout/num_slots"] == ENGINE_SLOTS
                and m["rollout/refills"] >= rollouts / ENGINE_SLOTS
                and 0.0 < m["rollout/slot_occupancy"] <= 1.0,
                f"{label} engine arm iteration {it}: slot counts {m}")
    held = seen["held"]
    require(all(held[n]["calls"] == rows[0]["launches"][n] for n in names),
            f"{label} engine arm iteration held to plain: calls {held}, launches "
            f"{rows[0]['launches']}")
    print(json.dumps({"check": f"{label}_engine_iteration_held_to_plain", "kernels": held}),
          flush=True)
    moved = sum(int((a != b).sum()) for a, b in zip(tree.leaves(pipe.ctx.actor_state.params),
                                                   tree.leaves(pipe.ctx.ref_params)))
    require(moved > 0, f"{label} engine arm: no weight of the actor moved")
    timed = rows[1:]
    stat_keys = ("decode_steps", "bursts", "refills", "slot_occupancy", "padding_waste",
                 "tokens", "tokens_per_s")
    summary = {
        "rollout_slots": ENGINE_SLOTS,
        "iteration_ms": [r["ms"] for r in rows],
        "iteration_ms_median": statistics.median(r["ms"] for r in timed),
        "node_ms_median": {k[5:]: statistics.median(r["metrics"][k] * 1e3 for r in timed)
                           for k in sorted(timed[0]["metrics"]) if k.startswith("time/")},
        "rollout": {k: [r["metrics"][f"rollout/{k}"] for r in rows] for k in stat_keys},
        "launches_per_iteration": [r["launches"] for r in rows], "held_to_plain": held,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "arm_s": time.perf_counter() - t_arm}
    print(json.dumps({f"{label}_engine_arm": summary}), flush=True)
    del out, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# phase 9: mamba2-2.7b training at full width on MAMBA2_LAYERS layers. The GRPO pipeline
# runs through launch.train (pipeline_phase); then the gradient check on
# lockstep rollouts of M_GRAD_PROMPT + M_GRAD_NEW positions (one chunk of the
# scan), one actor step at LONG_B x LONG_S (16 chunks), and the scan and the
# norms at both training shapes
M_GRAD_PROMPT, M_GRAD_NEW = 96, 32
M_D_INNER = M_HEADS * M_HEADDIM


def ssd_inputs(torch, F, randn, Bs, S):
    """One SSD call at mamba2's widths (80 heads of 64, one group of 128):
    x, dt > 0, A < 0, Bm, Cm, D."""
    return (randn(Bs, S, M_HEADS, M_HEADDIM),
            F.softplus(randn(Bs, S, M_HEADS, dtype=torch.float32)),
            -torch.exp(randn(M_HEADS, dtype=torch.float32)),
            randn(Bs, S, 1, M_STATE), randn(Bs, S, 1, M_STATE),
            randn(M_HEADS, dtype=torch.float32))


def ssd_work(Bs, S, L):
    """(bytes, bf16 tensor-core operations) of one scan at mamba2's widths:
    x read and y written (bf16), dt read (f32), B and C read (bf16), A and D,
    the final state written (f32); per chunk C·Bᵀ and its product with dt·x
    over the causal half, and the state's two products."""
    blocks = Bs * M_HEADS * (S // L)
    flops = blocks * (L * (L + 1) // 2 * (2 * M_STATE + 2 * M_HEADDIM)
                      + 4 * L * M_STATE * M_HEADDIM)
    nbytes = (2 * Bs * S * M_D_INNER * 2 + Bs * M_HEADS * M_HEADDIM * M_STATE * 4
              + Bs * S * M_HEADS * 4 + 2 * Bs * S * M_STATE * 2 + 2 * M_HEADS * 4)
    return nbytes, flops


def decay_reading(torch, ops, ssd_mod, trainer, model, rl, params, batch):
    """The terms of every SSD layer's A_log gradient on the plain path, at
    chunk 128 and at chunk 64 (the grad check's drift). The scan runs on
    (x / u, dt u) with u = 1 and D = 0, D x added after it as the plain
    version adds it: bitwise the same forward, and the gradient of u at (b,
    s, h) is the term A_h dt ∂L/∂a of the log-decay a = dt A there, whose
    sum over (b, s) is the A_log gradient of head h (A = -exp(A_log)).
    Reports, over the layers, the median and at the layer whose sum drifts
    most: the cancellation (sum of |term| over |sum|, median over the
    heads), the terms' relative L2 drift and their sums' drift; and how far
    the sums lie from autograd's A_log gradient."""
    from repro_torch import tree

    plain = ssd_mod.plain
    blocks = [i for i, k in enumerate(model.cfg.layer_kinds()) if k[0] == "ssm"]

    def terms(at):
        us = []

        def probed(x, dt, A, Bm, Cm, D, *, chunk=128):
            u = torch.ones_like(dt, requires_grad=True)
            us.append(u)
            y, h = plain(x / u[..., None], dt * u, A, Bm, Cm, torch.zeros_like(D),
                         chunk=min(at, chunk))
            return (y + D[:, None] * x).to(x.dtype), h

        p = tree.map(lambda t: t, params)
        a_logs = []
        for i in blocks:
            p["blocks"][i]["ssm"]["A_log"] = params["blocks"][i]["ssm"]["A_log"].detach(
                ).requires_grad_()
            a_logs.append(p["blocks"][i]["ssm"]["A_log"])
        ops.set_mode("ref")
        try:
            with patched(ssd_mod, "plain", probed):
                loss, _ = trainer.actor_loss_fn(model, rl, p, batch)
                forward = list(us)  # the remat recompute adds its own
                got = torch.autograd.grad(loss, forward + a_logs)
        finally:
            ops.set_mode(None)
        return got[:len(blocks)], got[len(blocks):]

    t128, g128 = terms(128)
    t64, _ = terms(64)
    rows = []
    for a, b, g in zip(t128, t64, g128):
        sums_a, sums_b = a.sum(dim=(0, 1)), b.sum(dim=(0, 1))
        rows.append({"cancellation": float((a.abs().sum(dim=(0, 1)) / sums_a.abs()).median()),
                     "term_drift": rel_l2(b, a), "sum_drift": rel_l2(sums_b, sums_a),
                     "sum_vs_grad": rel_l2(sums_a, g)})
    worst = max(range(len(rows)), key=lambda i: rows[i]["sum_drift"])
    return {"layers": len(rows), "terms_per_head": int(t128[0][..., 0].numel()),
            **{f"{k}_median": statistics.median(r[k] for r in rows) for k in rows[0]},
            "sum_vs_grad_max": max(r["sum_vs_grad"] for r in rows),
            "worst_layer": {"block": blocks[worst], **rows[worst]}}


def mamba2_training_phase(torch, ops, ref, F, _build, serve, generate, records):
    """Full mamba2-2.7b under autograd (its GRPO pipeline has run before):
    the gradient check on lockstep rollouts (B x 128 positions: the kernel
    path against ``ops.set_mode("ref")`` per leaf and for the loss, within
    GRAD_DRIFT_FACTOR x the plain path's drift at chunk 64 against chunk
    128; the step-0 ratio within 1 +- RATIO_TOL; a finite, nonzero grad on
    every leaf), one actor step at LONG_B x LONG_S (its warm-up held to
    plain; forward, backward, clip + AdamW ms, tokens/s, peak), and the scan
    and the norms at both training shapes with their plain-VJP backwards.
    Adds ``training`` and ``training_long`` entries to the ssd record and
    ``mamba2_*`` entries to the rmsnorm record. Returns the summary."""
    from repro_torch import tree
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.rl import algorithms, trainer

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, params, tok = build_model(torch, serve, MAMBA2_FLAGS, MAMBA2_LAYERS)
    cfg = model.cfg
    rl = trainer.RLConfig()
    ref_params = tree.map(torch.clone, params)
    state = trainer.init_state(params)
    del params
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    print(f"[train mamba2] actor, reference and fp32 AdamW moments: {resident:.2f} GiB",
          flush=True)
    names = path_kernels(cfg)
    spec = algorithms.get_algorithm(rl.algorithm)
    _, step_launches = iteration_launches(cfg, _build.LAUNCHES, rl.max_new_tokens,
                                          spec.dag_factory())

    def ref_logprobs(tokens):
        with torch.no_grad():
            return model.logprobs(ref_params, tokens)[0]

    # ---- 1. the gradient check on lockstep rollouts ----
    _, ids = serve.prompts(tok, B, M_GRAD_PROMPT)
    res = generate(model, state.params, torch.from_numpy(ids).to(DEV),
                   torch.Generator(device=DEV).manual_seed(1), max_new=M_GRAD_NEW,
                   temperature=rl.temperature, eos_id=tok.eos_id)
    batch = {"tokens": res.tokens.clone(), "response_mask": res.response_mask.clone(),
             "old_logprob": res.old_logprob.clone()}
    del res
    require(tuple(batch["tokens"].shape) == (B, M_GRAD_PROMPT + M_GRAD_NEW),
            f"rollouts {tuple(batch['tokens'].shape)}")
    batch["ref_logprob"] = ref_logprobs(batch["tokens"])
    seq_rewards = torch.rand(B, generator=torch.Generator(device=DEV).manual_seed(2),
                             device=DEV)
    batch["advantages"] = spec.make_advantage(rl)(
        seq_rewards, batch["response_mask"])  # one group of 8: never all equal

    # the scan runs under autograd: ssd() refuses an input that requires
    # grad, so each of the step's scan launches comes through SSDFn. The
    # drift: the plain path with the scan's fp32 sums in chunks of 64
    plain_ssd = ssd_mod.plain
    chunk64 = patched(ssd_mod, "plain",
                      lambda *a, chunk=128: plain_ssd(*a, chunk=min(64, chunk)))
    gcheck = grad_check(torch, ops, _build, trainer,
                        lambda p: trainer.actor_loss_fn(model, rl, p, batch), state.params,
                        step_launches, chunk64, "mamba2_grad_check")
    # why A_log's gradient drifts most: its terms at both chunks
    decay = decay_reading(torch, ops, ssd_mod, trainer, model, rl, state.params, batch)
    print(json.dumps({"mamba2_a_log_terms": decay}), flush=True)
    del batch

    # ---- 2. one actor step at an RL response length: 16 chunks of the scan ----
    state, long_summary = long_step(torch, ops, ref, trainer, model, rl, state, ref_params,
                                    names, step_launches, "mamba2_actor_step_long")
    del state, ref_params, model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3. the scan and the norms at the training shapes, and their
    # plain-VJP backwards (SSDFn's and RMSNormFn's) ----
    g = torch.Generator(device=DEV).manual_seed(98)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=DEV) * scale).to(dtype)

    for tag, Bt, S_T in (("training", B, M_GRAD_PROMPT + M_GRAD_NEW),
                         ("training_long", LONG_B, LONG_S)):
        L = min(128, S_T)
        ins = ssd_inputs(torch, F, randn, Bt, S_T)
        y_k, h_k = ops.ssd(*ins, return_state=True)
        y_r, h_r = ref.ssd_chunked(*ins, chunk=L, return_state=True)
        (ok, err), (ok_h, err_h) = close(y_k, y_r, SSD_Y_TOL), close(h_k, h_r, SSD_STATE_TOL)
        require(ok and ok_h, f"ssd at the {tag} shape: y err {err}, state err {err_h}")
        # SSDFn's forward is the kernel: one launch under autograd
        _build.reset_launches()
        leaves = [t.detach().requires_grad_() for t in ins]
        y_fn, _ = ops.ssd(*leaves, return_state=True)
        require(type(y_fn.grad_fn).__name__ == "SSDFnBackward" and _build.LAUNCHES["ssd"] == 1
                and torch.equal(y_fn, y_k), f"ssd at the {tag} shape: SSDFn's forward")
        gy = randn(*y_k.shape)
        grads = ref.vjp(ssd_mod.plain, ins, (gy, None), chunk=L)
        got = torch.autograd.grad(y_fn, leaves, gy)
        require(all(torch.equal(a, b) for a, b in zip(got, grads)),
                f"ssd at the {tag} shape: SSDFn's backward is not the plain VJP")
        del y_fn, leaves, got, grads
        nbytes, flops = ssd_work(Bt, S_T, L)
        bms, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOP_PER_S)
        # backward: the inputs and y's cotangent read, a grad of every input
        # written; the products 2.5x the forward's
        in_bytes = nbytes - Bt * S_T * M_D_INNER * 2 - Bt * M_HEADS * M_HEADDIM * M_STATE * 4
        b_bms, b_by = bound_ms(2 * in_bytes + Bt * S_T * M_D_INNER * 2, 2.5 * flops,
                               BF16_TENSOR_FLOP_PER_S)
        records["ssd"][tag] = {
            "shape": {"x": list(ins[0].shape), "Bm": list(ins[3].shape), "chunk": L},
            "max_abs_err": err, "state_max_abs_err": err_h,
            "ms": device_ms(lambda: ops.ssd(*ins, return_state=True)),
            "plain_ms": device_ms(lambda: ref.ssd_chunked(*ins, chunk=L, return_state=True)),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "backward": {"plain_vjp_ms": device_ms(lambda: ref.vjp(ssd_mod.plain, ins,
                                                                    (gy, None), chunk=L)),
                         "bound_ms": b_bms, "bound_by": b_by, "library_ms": None,
                         "library": "none: no PyTorch call differentiates the chunked scan"}}
        print(json.dumps({"check": f"ssd/{tag}", **records["ssd"][tag]}), flush=True)
        del ins, y_k, h_k, y_r, h_r, gy
        for D in (M_D_MODEL, M_D_INNER):  # the block norms and the gated norms
            rec = norm_record(torch, ops, ref, F, randn, Bt * S_T, D)
            records["rmsnorm"][f"mamba2_{tag}_{D}"] = rec
            print(json.dumps({"check": f"rmsnorm/mamba2_{tag}_{D}", **rec}), flush=True)

    summary = {"resident_gib": resident, "grad_check": gcheck, "a_log_terms": decay,
               "actor_step_long": long_summary,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"mamba2_training": summary}), flush=True)
    return summary


# phase 11: the continuous rollout engine at qwen2.5-7b's full width on
# Q_LAYERS of its 28 layers (cut from full depth, then from 10 layers, to
# keep the whole script inside its time as phases 20 and 21 came). The
# ragged comparison: Q_PROMPTS prompts of true lengths
# Q_MIN_PROMPT..Q_PROMPT tokens (padded to Q_PROMPT), Q_NEW new tokens at
# most, prefill buckets of Q_BUCKET, per-row budgets of Q_MIN_BUDGET..Q_NEW,
# all drawn from Q_SEED; lockstep generate against the engine with one slot
# a prompt (early exit only) and with Q_SLOTS slots (refill), each arm one
# warm-up then Q_TIMED timed runs
Q_PROMPTS, Q_MIN_PROMPT, Q_PROMPT, Q_NEW, Q_BUCKET = 32, 32, 128, 128, 32
Q_MIN_BUDGET, Q_SLOTS, Q_TIMED, Q_SEED = 8, 16, 2, 11
Q_TEMPERATURE = 1.0  # RLConfig's default: rollouts are sampled
Q_LAYERS = 4


def ragged_inputs(torch, tok, n_prompts=Q_PROMPTS, new=Q_NEW):
    """(prompts (n_prompts, Q_PROMPT) on the card, budgets (n_prompts,)
    int32 of Q_MIN_BUDGET..new on the card, true lengths of
    Q_MIN_PROMPT..Q_PROMPT) from Q_SEED: byte tokens up to each row's true
    length, PAD after."""
    import numpy as np

    rng = np.random.default_rng(Q_SEED)
    true_len = rng.integers(Q_MIN_PROMPT, Q_PROMPT + 1, n_prompts)
    prompts = np.full((n_prompts, Q_PROMPT), tok.pad_id, np.int32)
    for i, n in enumerate(true_len):
        prompts[i, :n] = rng.integers(tok.SPECIALS, 256 + tok.SPECIALS, n)
    budgets = rng.integers(Q_MIN_BUDGET, new + 1, n_prompts).astype(np.int32)
    return (torch.from_numpy(prompts).to(DEV), torch.from_numpy(budgets).to(DEV),
            true_len)


class ReadEachStep:
    """``model`` with a host read of a count after every
    ``decode_step_sample``, as the continuous engine's burst reads its done
    count (``int(new_done.sum())``), each read's host time kept in
    ``wait_s``; everything else is the model's."""

    def __init__(self, model, eos_id: int):
        self._model, self._eos = model, eos_id
        self.wait_s = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step_sample(self, *args, **kw):
        out = self._model.decode_step_sample(*args, **kw)
        t = time.perf_counter()
        int((out[0] == self._eos).sum())
        self.wait_s.append(time.perf_counter() - t)
        return out


def done_read_cost(torch, generate, model, params, prompts, budgets, seed, kw):
    """The cost of the burst's per-step host read, alone, on the ragged
    inputs: lockstep ``generate`` as it is (no host read in its loop) and
    with ``ReadEachStep``, Q_TIMED runs each, interleaved, after a warm-up
    of the read. Returns both arms' walls, their medians' difference a
    decode step, and the read's own host time a step (each run's mean over
    its steps, and the median of those). In a host-bound loop the read's
    own time is what it adds to the wall: the card is idle after it either
    way, and a wall difference carries the host's noise between runs."""
    reads = ReadEachStep(model, kw["eos_id"])
    runs = {m: (lambda m=m: generate(m, params, prompts, seed(), max_new=Q_NEW,
                                     temperature=Q_TEMPERATURE, budgets=budgets, **kw))
            for m in (model, reads)}
    sync_ms(torch, runs[reads])
    walls = {"no_read_ms": [], "read_ms": []}
    waits = []
    for _ in range(Q_TIMED):
        walls["no_read_ms"].append(sync_ms(torch, runs[model])[1])
        reads.wait_s.clear()
        walls["read_ms"].append(sync_ms(torch, runs[reads])[1])
        waits.append(sum(reads.wait_s) / len(reads.wait_s) * 1e3)
    med = {k: statistics.median(v) for k, v in walls.items()}
    return {**walls, "decode_steps": Q_NEW - 1,
            "wall_diff_per_step_ms": (med["read_ms"] - med["no_read_ms"]) / (Q_NEW - 1),
            "read_ms_per_step_runs": waits, "read_ms_per_step": statistics.median(waits)}


def qwen_engine_phase(torch, ops, ref, _build, serve, generate, label="qwen_engine"):
    """qwen2.5-7b at full width on Q_LAYERS layers (random bf16 weights from
    seed 0) with the continuous rollout engine:

    1. parity: lockstep ``generate`` and the engine with one slot a prompt
       and one bucket, sampled at 0.8 from one seed, with per-row budgets,
       on phase 3's prompt shape: tokens, masks and lengths bit-equal (the
       engine consumes lockstep's seed stream), logprobs within LOGPROB_TOL;
    2. the ragged comparison (the constants above): response tokens/s,
       decode steps, lockstep_waste, slot occupancy and wall ms of each arm,
       medians of Q_TIMED runs after a warm-up. Each arm's warm-up run is
       held to plain call by call (``held_to_plain``: every kernel call at
       the shapes this phase gives it, its calls equal to the run's
       launches), and then the cost of a host read of a count after every
       decode step, the read the engine's burst takes, is timed on its own:
       lockstep ``generate`` with and without that read, Q_TIMED runs each,
       interleaved (``done_read``);
    3. the kernel path against the plain path (``plain_agreement``);
    4. the launch counters of the refill arm's warm-up run (set to 0 just
       before it, read just after), equal to ``forward_launches`` of its
       prefills and decode steps.

    Prints ``{label: ...}``. Returns the launch counts of the path."""
    from repro_torch.rl.rollout_engine import ContinuousRolloutEngine, lockstep_waste

    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import get_model

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(QWEN_FLAGS[1]), num_layers=Q_LAYERS)
    model, tok = get_model(cfg, device=DEV), ByteTokenizer()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    kw = dict(eos_id=tok.eos_id, pad_id=tok.pad_id)

    # ---- 1. a fixed schedule is lockstep, bit for bit ----
    _, ids = serve.prompts(tok, B, PROMPT)
    prompt = torch.from_numpy(ids).to(DEV)
    budgets = torch.randint(1, MAX_NEW + 1, (B,), generator=torch.Generator().manual_seed(5),
                            dtype=torch.int32).to(DEV)
    seed = lambda: torch.Generator(device=DEV).manual_seed(Q_SEED)  # noqa: E731
    want = generate(model, params, prompt, seed(), max_new=MAX_NEW, temperature=0.8,
                    budgets=budgets, **kw)
    fixed = ContinuousRolloutEngine(model, max_new=MAX_NEW, temperature=0.8, num_slots=B, **kw)
    got = fixed(params, prompt, seed(), budgets=budgets)
    for field in ("tokens", "response_mask", "lengths"):
        require(torch.equal(getattr(got, field), getattr(want, field)),
                f"{label}: the fixed-schedule engine's {field} differ from lockstep's")
    ok, lp_err = close(got.old_logprob, want.old_logprob, LOGPROB_TOL)
    require(ok, f"{label}: fixed-schedule logprobs differ from lockstep's by {lp_err}")
    parity = {"batch": B, "max_new": MAX_NEW, "lengths": got.lengths.tolist(),
              "tokens_equal": True, "old_logprob_max_abs_err": lp_err,
              "decode_steps": fixed.last_stats["decode_steps"]}
    print(json.dumps({"check": f"{label}_fixed_schedule_equals_lockstep", **parity}), flush=True)

    # ---- 3. the kernel path against the plain path ----
    agreement = plain_agreement(torch, ops, model, params, prompt, SMAX, label)

    # ---- 2. the ragged comparison, and 4. the path's launch counters ----
    prompts, budgets, true_len = ragged_inputs(torch, tok)
    engines = {f"engine_slots_{n}": ContinuousRolloutEngine(
        model, max_new=Q_NEW, temperature=Q_TEMPERATURE, num_slots=n,
        prefill_bucket=Q_BUCKET, **kw) for n in (0, Q_SLOTS)}
    arms = {"lockstep": lambda: generate(model, params, prompts, seed(), max_new=Q_NEW,
                                         temperature=Q_TEMPERATURE, budgets=budgets, **kw)}
    arms.update({name: (lambda e=e: e(params, prompts, seed(), budgets=budgets))
                 for name, e in engines.items()})
    names = path_kernels(cfg)
    launches, held, rows = {}, {}, {}
    for name, run in arms.items():
        # the warm-up run, held to plain; the refill arm's is the path's run
        _build.reset_launches()
        with held_to_plain(torch, ops, ref, names) as held[name]:
            res = run()
        torch.cuda.synchronize()
        launches[name] = dict(_build.LAUNCHES)
        require(all(held[name][n]["calls"] == launches[name][n] for n in names),
                f"{label} {name} held to plain: calls {held[name]}, launches {launches[name]}")
        walls = []
        for _ in range(Q_TIMED):
            res, ms = sync_ms(torch, run)
            walls.append(ms)
        lens = res.lengths
        require(bool((lens >= 1).all() and (lens <= budgets).all()),
                f"{label} {name}: lengths {lens.tolist()} past the budgets")
        resp = res.tokens[:, Q_PROMPT:]
        require(bool(((resp >= 0) & (resp < cfg.vocab_size)).all())
                and bool(torch.isfinite(res.old_logprob).all()),
                f"{label} {name}: token out of range or non-finite logprob")
        wall = statistics.median(walls)
        n_tok = int(lens.sum())
        waste = lockstep_waste(lens.cpu().numpy(), Q_NEW)
        row = {"wall_ms": wall, "wall_ms_runs": walls, "response_tokens": n_tok,
               "response_tok_per_s": n_tok / wall * 1e3, "lockstep_waste": waste}
        if name == "lockstep":
            row.update(decode_steps=Q_NEW - 1, slot_occupancy=1.0 - waste, num_slots=Q_PROMPTS)
        else:
            st = engines[name].last_stats
            row.update({k: st[k] for k in ("decode_steps", "bursts", "refills", "num_slots",
                                           "slot_occupancy", "padding_waste",
                                           "prefill_lane_tokens", "prefill_true_tokens",
                                           "prefill_waste")})
        rows[name] = row
        print(json.dumps({f"{label}_arm": {"arm": name, **row}}), flush=True)
    print(json.dumps({"check": f"{label}_held_to_plain", "arms": held}), flush=True)
    done_read = done_read_cost(torch, generate, model, params, prompts, budgets, seed, kw)
    print(json.dumps({f"{label}_done_read": done_read}), flush=True)
    counts = launches[f"engine_slots_{Q_SLOTS}"]
    refill = engines[f"engine_slots_{Q_SLOTS}"].last_stats
    want_counts = forward_launches(cfg, _build.LAUNCHES, int(refill["refills"]),
                                   int(refill["decode_steps"]))
    require(counts == want_counts, f"{label}: launches {counts}, expected {want_counts} "
                                   f"from the refill arm's prefills and decode steps")
    summary = {"model": cfg.name, "layers": cfg.num_layers, "parity": parity,
               "agreement": agreement,
               "ragged": {"prompts": Q_PROMPTS, "true_prompt_tokens": int(true_len.sum()),
                          "prompt_width": Q_PROMPT, "max_new": Q_NEW, "bucket": Q_BUCKET,
                          "budget_tokens": int(budgets.sum()), "arms": rows},
               "held_to_plain": held, "done_read": done_read, "launches": counts,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({label: summary}), flush=True)
    del model, params, engines, arms
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# phase 12: the async off-policy pipeline and multi-turn environments through
# launch.train at full gemma-2b width and depth, on phase 8's experiment file
# and RL settings (2 prompts x 8 rollouts of 16 new tokens, --seed 0, one
# warm-up iteration then PIPE_TIMED timed ones an arm)
TIS_ALGORITHM = "grpo_tis"  # GRPO with the truncated-IS correction, registered here
MT_FLAGS = ["--env", "dialog", "--max-turns", "3", "--turn-budget", "8"]
MT_SLOTS = 4
MT_TURNS = 3
# arm -> (experiment file, flags on top of it)
ASYNC_ARMS = {"sync": ("async", []),
              "async_s0": ("async", ["--max-staleness", "0"]),
              "async_s1": ("async", ["--max-staleness", "1"]),
              "async_tis": ("async_tis", ["--max-staleness", "1"]),
              "multiturn": ("multiturn", ["--rollout-slots", str(MT_SLOTS),
                                          "--max-staleness", "1"])}


def bit_checksum(torch, params) -> list:
    """Per leaf of ``params``, a position-weighted sum of its bits (int64 on
    the card, in chunks): equal weights give equal sums, and one flipped bit
    changes its leaf's."""
    from repro_torch import tree

    out = []
    for leaf in tree.leaves(params):
        bits = leaf.detach().contiguous().view(
            torch.int16 if leaf.element_size() == 2 else torch.int32).flatten()
        total, step = 0, 1 << 26
        for i in range(0, bits.numel(), step):
            b = bits[i:i + step].to(torch.int64)
            w = torch.arange(i, i + b.numel(), device=b.device) % 65521 + 1
            total += int((b * w).sum())
        out.append(total)
    return out


def pick_leaf(params):
    """The leaf the in-place checks read: the final norm's weight (every
    AdamW step of the arms moves it)."""
    from repro_torch import tree

    return tree.leaves(params["final_norm"])[0]


@contextlib.contextmanager
def observed_versions(torch):
    """While open, the async worker's weight versions are observed: a copy
    of ``pick_leaf`` of every published version; for each dispatch the
    behaviour version it took and that version's own leaf (a reference to
    the store's tensor, so its later bytes are what the store then holds;
    the rest of the copy is not kept alive); a copy of the leaf that each
    generation ran; a copy of the live leaf after each update; and each
    publish's synchronised wall ms (the copy of the weights). Yields those
    lists."""
    from repro_torch.core.async_worker import AsyncDAGWorker
    from repro_torch.distributed.weight_sync import WeightVersionStore
    from repro_torch.rl import rollout as rollout_mod

    seen = {"published": {}, "behaviour": [], "ran": [], "live_after_update": [],
            "publish_ms": []}
    publish, behavior = WeightVersionStore.publish, AsyncDAGWorker._behavior_weights
    consume, generate = AsyncDAGWorker.consume_and_train, rollout_mod.generate

    def publish_kept(self, params, **kw):
        out, ms = sync_ms(torch, lambda: publish(self, params, **kw))
        seen["publish_ms"].append(ms)
        seen["published"][out.version] = pick_leaf(out.params).clone()
        return out

    def behavior_kept(self):
        out = behavior(self)
        seen["behaviour"].append((out.version, pick_leaf(out.params)))
        return out

    def consume_kept(self, metrics=None):
        out = consume(self, metrics)
        seen["live_after_update"].append(
            (len(seen["behaviour"]) - 1, pick_leaf(self.ctx.actor_state.params).clone()))
        return out

    def generate_kept(model, params, *args, **kw):
        seen["ran"].append(pick_leaf(params).clone())
        return generate(model, params, *args, **kw)

    WeightVersionStore.publish, AsyncDAGWorker._behavior_weights = publish_kept, behavior_kept
    AsyncDAGWorker.consume_and_train, rollout_mod.generate = consume_kept, generate_kept
    try:
        yield seen
    finally:
        WeightVersionStore.publish, AsyncDAGWorker._behavior_weights = publish, behavior
        AsyncDAGWorker.consume_and_train, rollout_mod.generate = consume, generate


@contextlib.contextmanager
def observed_recompute(torch, ops, rho_max: float):
    """While open, every ``logprobs`` call of the async worker's truncated
    correction (inside ``consume_and_train``) is also run on the plain path
    (``ops.set_mode("ref")``) on the same weights and tokens. Yields a list
    of {"ratio_mean", "max_abs_diff", "rho_min", "rho_max", "tokens",
    "plain_ms"}: the masked mean of exp(kernel - plain), the largest
    |kernel - plain|, the range of the truncated IS weights
    min(exp(recomputed - behaviour), rho_max) over the response tokens, and
    the synchronised ms of the plain recompute (a check, inside the timed
    iteration: the arm reports its iterations without it too)."""
    from repro_torch.core.async_worker import AsyncDAGWorker

    seen = []
    consume = AsyncDAGWorker.consume_and_train

    def consume_checked(self, metrics=None):
        pending = self._inflight[0] if self._inflight else None
        engine = self.ctx.engines["logprobs"]

        def logprobs(params, tokens):
            lp, ent = engine(params, tokens)
            ops.set_mode("ref")
            try:
                (lp_ref, _), plain_ms = sync_ms(torch, lambda: engine(params, tokens))
            finally:
                ops.set_mode(None)
            m = pending.data["response_mask"]
            d = (lp - lp_ref)[m].float()
            rho = torch.exp(lp[m].float() - pending.data["old_logprob"][m].float()).clamp(
                max=rho_max)
            seen.append({"ratio_mean": float(torch.exp(d).mean()),
                         "max_abs_diff": float(d.abs().max()), "rho_min": float(rho.min()),
                         "rho_max": float(rho.max()), "tokens": int(m.sum()),
                         "plain_ms": plain_ms})
            return lp, ent

        self.ctx.engines["logprobs"] = logprobs
        try:
            return consume(self, metrics)
        finally:
            self.ctx.engines["logprobs"] = engine

    AsyncDAGWorker.consume_and_train = consume_checked
    try:
        yield seen
    finally:
        AsyncDAGWorker.consume_and_train = consume


def continuation_launches(cfg, names, steps: int):
    """Launch counts of ``steps`` teacher-forced ``decode_step`` calls (a
    continuation's feed): a decode step's norms and decode attention, no
    sampler (the head is a plain product)."""
    out = forward_launches(cfg, names, 0, steps)
    out["fused_sample"] = 0
    return out


def async_phase(torch, ops, ref, _build, label="async"):
    """Phase 12: the async pipeline and multi-turn episodes through
    ``launch.train.main`` at gemma-2b's full width and depth, arm after arm
    (each pipeline freed before the next is built), the launch counters set
    to 0 just before each arm and read just after it, each arm's warm-up
    iteration held to plain (calls equal to its launches):

    - ``sync`` and ``async_s0`` (``--max-staleness 0``) on phase 8's file:
      every iteration's metrics bitwise equal (clock keys and the
      scheduler's own accounting aside), the rollouts equal, and the bit
      checksums of every actor leaf after the last iteration equal;
    - ``async_s1`` (``--max-staleness 1``): the first tick only generates,
      the second trains the warm-up batch at staleness 0 (version 0 is
      published lazily, at the first dispatch), every later tick at
      staleness 1, the weight version rising by 1 a tick; each dispatch ran
      the copy published at the previous update, byte for byte, which an
      in-place AdamW step did not change and which differs from the live
      weights after the tick's update;
    - ``async_tis``: GRPO with the truncated-IS correction (``--algorithm
      grpo_tis`` in its file) at ``--max-staleness 1``: every stale batch
      corrected, its recomputed ``old_logprob`` held to the plain path's on
      the same tokens (masked mean of exp(kernel - plain) within 1 +-
      RATIO_TOL), its IS weights in (0, rl.is_rho_max];
    - ``multiturn`` (``--env dialog --max-turns 3 --turn-budget 8`` in its
      file, ``--rollout-slots 4 --max-staleness 1``): every episode runs 3
      turns (48 a tick), the role-2 tokens are ``obs_tokens``, the later
      turns' prefill is ``obs_tokens`` + 32 carried tokens, no observation
      token is in ``response_mask`` (which is role 1 exactly), and every
      launch is the engine's prefills, decode steps and continuation feed
      steps.

    Every iteration: every metric finite, the launches as expected, and
    where it trains a nonzero gradient and ratio_mean within 1 +- RATIO_TOL.
    Prints ``{label + "_arm": ...}`` per arm and ``{label: ...}``. Returns
    {path: the arm's launch counts}."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.api import ExperimentSpec
    from repro_torch.core.async_worker import AsyncDAGWorker
    from repro_torch.launch import train
    from repro_torch.rl import algorithms

    t_phase = time.perf_counter()
    grpo = algorithms.get_algorithm("grpo")
    algorithms.register_algorithm(dataclasses.replace(grpo, name=TIS_ALGORITHM,
                                                      is_correction="truncated"), override=True)
    files = {"async": experiment_file(label, ARCH_FLAGS, PIPE_RL),
             "async_tis": experiment_file(f"{label}_tis", ARCH_FLAGS
                                          + ["--algorithm", TIS_ALGORITHM], PIPE_RL),
             "multiturn": experiment_file(f"{label}_multiturn", ARCH_FLAGS + MT_FLAGS, PIPE_RL)}
    exp = ExperimentSpec.from_json(files["async"].read_text())
    cfg, rl = exp.model, exp.rl
    rollouts = exp.prompts_per_iter * grpo.group_size(rl)
    per_iter, step = iteration_launches(cfg, _build.LAUNCHES, rl.max_new_tokens,
                                        grpo.dag_factory())
    lockstep = forward_launches(cfg, _build.LAUNCHES, 1, rl.max_new_tokens - 1)
    fwd = forward_launches(cfg, _build.LAUNCHES, 1, 0)
    names = path_kernels(cfg)
    runs, counts, summary = {}, {}, {}
    for arm, (file_key, flags) in ASYNC_ARMS.items():
        t_arm = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(observed_iterations(
                torch, _build, lambda: held_to_plain(torch, ops, ref, names)))
            versions = stack.enter_context(observed_versions(torch))
            recompute = stack.enter_context(observed_recompute(torch, ops, rl.is_rho_max))
            out = train.main(["--experiment", str(files[file_key]), "--device", DEV]
                             + PIPE_ITERS + flags)
        counts[arm] = dict(_build.LAUNCHES)
        pipe = out["pipeline"]
        rows = seen["iterations"]
        require(len(rows) == 1 + PIPE_TIMED, f"{label} {arm}: {len(rows)} iterations")
        require(isinstance(pipe.worker, AsyncDAGWorker) == (arm != "sync"),
                f"{label} {arm}: worker {type(pipe.worker).__name__}")
        held = seen["held"]
        require(all(held[n]["calls"] == rows[0]["launches"][n] for n in names),
                f"{label} {arm} warm-up held to plain: calls {held}, launches "
                f"{rows[0]['launches']}")
        print(json.dumps({"check": f"{label}_{arm}_warmup_held_to_plain", "kernels": held}),
              flush=True)
        for it, row in enumerate(rows):
            m = row["metrics"]
            require(all(np.isfinite(v) for v in m.values()),
                    f"{label} {arm} iteration {it}: non-finite metric {m}")
            trains = "actor/loss" in m
            if arm in ("sync", "async_s0"):
                require(trains, f"{label} {arm} iteration {it} did not train")
            else:
                require(trains == (it > 0), f"{label} {arm} iteration {it}: trains {trains}")
            if trains:
                # the step-0 ratio holds the sampler's logprobs to the training
                # forward's on an on-policy batch; on a stale one it is
                # exp(new - old policy) and measures the last update instead
                if m.get("async/staleness", 0.0) == 0.0:
                    require(abs(m["actor/ratio_mean"] - 1.0) <= RATIO_TOL,
                            f"{label} {arm} iteration {it}: ratio_mean {m['actor/ratio_mean']}")
                require(m["actor/grad_norm"] > 0, f"{label} {arm} iteration {it}: zero gradient")
            want = dict(per_iter)
            if arm == "multiturn":
                st = seen["engine"][it]["stats"]
                gen = forward_launches(cfg, _build.LAUNCHES, int(st["refills"]),
                                       int(st["decode_steps"]))
                # every continuation of a dialog tick feeds one width (the
                # carried token and the re-asked question), and a refill of
                # any lane count runs that many teacher-forced steps
                width = st["prefill_tokens_turn2plus"] / (st["turns"] - rollouts)
                require(width == int(width), f"{label} {arm}: feed widths differ: {st}")
                cont = continuation_launches(cfg, _build.LAUNCHES,
                                             int(width) * int(st["cont_refills"]))
                want = {n: per_iter[n] - lockstep[n] + gen[n] + cont[n] for n in per_iter}
            if not trains:
                want = {n: want[n] - step.get(n, 0) for n in want}
            if m.get("async/is_corrected"):
                want = {n: want[n] + fwd[n] for n in want}
            require(row["launches"] == want, f"{label} {arm} iteration {it}: launches "
                                             f"{row['launches']}, expected {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        timed = rows[1:]
        run = {
            "iteration_ms": [r["ms"] for r in rows],
            "iteration_ms_median": statistics.median(r["ms"] for r in timed),
            "node_ms_median": {k[5:]: statistics.median(r["metrics"][k] * 1e3 for r in timed)
                               for k in sorted(timed[-1]["metrics"]) if k.startswith("time/")},
            "async": {k: [r["metrics"].get(k) for r in rows]
                      for k in sorted({k for r in rows for k in r["metrics"]})
                      if k.startswith("async/") or k == "pipeline/staleness"},
            **{k[6:]: [r["metrics"].get(k) for r in rows]
               for k in ("actor/ratio_mean", "actor/kl", "actor/entropy", "actor/grad_norm",
                         "actor/loss", "actor/clipfrac")},
            "launches_per_iteration": [r["launches"] for r in rows], "held_to_plain": held,
            "peak_gib": peak}
        if arm in ("sync", "async_s0"):
            runs[arm] = {"values": [{k: v for k, v in r["metrics"].items()
                                     if not k.startswith(("time/", "async/"))
                                     and k != "pipeline/staleness"} for r in rows],
                         "tokens": [t.clone() for t in seen["tokens"]],
                         "checksum": bit_checksum(torch, pipe.ctx.actor_state.params)}
        if arm != "sync":
            run["publish_ms"] = versions["publish_ms"]
        if arm in ("async_s1", "async_tis", "multiturn"):
            stale = [r["metrics"].get("async/staleness") for r in rows]
            require(stale == [None, 0.0] + [1.0] * (PIPE_TIMED - 1),
                    f"{label} {arm}: staleness {stale}")
            ver = [r["metrics"].get("async/weight_version") for r in rows]
            require(ver == [None] + [float(v) for v in range(1, 1 + PIPE_TIMED)],
                    f"{label} {arm}: weight versions {ver}")
        if arm == "async_s1":
            # tick t >= 1 dispatches under version t - 1 and then updates
            ran, beh = versions["ran"], versions["behaviour"]
            after = dict(versions["live_after_update"])
            require(len(ran) == len(beh) == 1 + PIPE_TIMED,
                    f"{label} {arm}: {len(ran)} generations, {len(beh)} dispatches")
            checks = []
            for t in range(1, 1 + PIPE_TIMED):
                version, now = beh[t]
                saved = versions["published"][version]
                c = {"tick": t, "behaviour_version": version,
                     "ran_equals_saved": torch.equal(ran[t], saved),
                     "snapshot_unchanged": torch.equal(now, saved),
                     "differs_from_live": not torch.equal(now, after[t])}
                checks.append(c)
                require(c["behaviour_version"] == t - 1 and c["ran_equals_saved"]
                        and c["snapshot_unchanged"] and c["differs_from_live"],
                        f"{label} {arm}: in-place check {c}")
            run["in_place_checks"] = checks
            print(json.dumps({"check": f"{label}_{arm}_behaviour_weights", "ticks": checks}),
                  flush=True)
        if arm == "async_tis":
            corrected = [r["metrics"].get("async/is_corrected") for r in rows]
            require(corrected == [None, 0.0] + [1.0] * (PIPE_TIMED - 1),
                    f"{label} {arm}: is_corrected {corrected}")
            require(len(recompute) == PIPE_TIMED - 1, f"{label} {arm}: {len(recompute)} "
                                                      f"recomputes")
            for rc in recompute:
                require(abs(rc["ratio_mean"] - 1.0) <= RATIO_TOL
                        and 0.0 < rc["rho_min"] and rc["rho_max"] <= rl.is_rho_max,
                        f"{label} {arm}: recompute {rc}")
            for r in rows[2:]:
                require(0.0 < r["metrics"]["actor/rho_mean"] <= rl.is_rho_max,
                        f"{label} {arm}: rho_mean {r['metrics']['actor/rho_mean']}")
            run["recompute"] = recompute
            checks_ms = [0.0, 0.0] + [rc["plain_ms"] for rc in recompute]
            less = [r["ms"] - c for r, c in zip(rows, checks_ms)]
            run["iteration_ms_less_check"] = less
            run["iteration_ms_median_less_check"] = statistics.median(less[1:])
            run["rho_mean"] = [r["metrics"].get("actor/rho_mean") for r in rows]
        if arm == "multiturn":
            require(len(seen["engine"]) == 1 + PIPE_TIMED,
                    f"{label} {arm}: {len(seen['engine'])} engine calls")
            episodes = []
            for it, (row, call) in enumerate(zip(rows, seen["engine"])):
                m, res, st = row["metrics"], call["result"], call["stats"]
                roles, mask = res.role_mask, res.response_mask
                obs = int((roles == 2).sum())
                ep = {k: st[k] for k in ("prefill_tokens_turn1", "prefill_tokens_turn2plus",
                                         "obs_tokens", "cont_refills", "turns", "turns_mean",
                                         "tool_calls", "refills", "decode_steps", "bursts",
                                         "slot_occupancy")}
                ep["role2_tokens"] = obs
                episodes.append(ep)
                require(m["env/turns_mean"] == MT_TURNS and st["turns"] == MT_TURNS * rollouts
                        and obs == st["obs_tokens"]
                        and st["prefill_tokens_turn2plus"] == obs + (MT_TURNS - 1) * rollouts
                        and not bool((mask & (roles == 2)).any())
                        and torch.equal(mask, roles == 1),
                        f"{label} {arm} iteration {it}: episode counts {ep}")
            run["episodes"] = episodes
        summary[arm] = run
        run["launches"] = counts[arm]
        run["arm_s"] = time.perf_counter() - t_arm
        print(json.dumps({f"{label}_arm": {"arm": arm, **run}}), flush=True)
        del out, pipe, seen, versions, recompute
        gc.collect()
        torch.cuda.empty_cache()
    algorithms._ALGORITHMS.pop(TIS_ALGORITHM)

    sync, s0 = runs["sync"], runs["async_s0"]
    for it, (a, b) in enumerate(zip(sync["values"], s0["values"])):
        diff = {k: (a.get(k), b.get(k)) for k in set(a) | set(b) if a.get(k) != b.get(k)}
        require(not diff, f"{label}: async_s0 iteration {it} metrics differ from sync: {diff}")
    require(len(sync["tokens"]) == len(s0["tokens"]) == 1 + PIPE_TIMED
            and all(torch.equal(a, b) for a, b in zip(sync["tokens"], s0["tokens"])),
            f"{label}: async_s0 rollouts differ from sync")
    require(sync["checksum"] == s0["checksum"],
            f"{label}: async_s0 actor weights differ from sync after the last iteration")
    out = {"arms": {arm: {"iteration_ms_median": r["iteration_ms_median"],
                          "peak_gib": r["peak_gib"]} for arm, r in summary.items()},
           "s0_bitwise_equal_to_sync": True, "checksum_leaves": len(sync["checksum"]),
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({label: out}), flush=True)
    return {f"{'async_' if arm == 'sync' else ''}{arm}_pipeline": c for arm, c in counts.items()}


# phase 13: the MoE family. granite-moe-3b-a800m at full width on
# GRANITE_LAYERS layers (configs/granite_moe_3b.py: 32 layers, d_model 1536, 24 query heads padded
# to 32 on 8 KV heads of 64, 40 SwiGLU experts of 512, top-8, vocab 49,155
# tied); mixtral-8x7b (configs/mixtral_8x7b.py: d_model 4096, 32 query heads
# on 8 KV heads of 128, 8 SwiGLU experts of 14,336, top-2, a window of 4,096,
# an untied head of 32,000) at full width and 4 of its 32 layers: its 93 GB
# of bf16 weights exceed the card's 80 GB, 4 layers hold 12.1 GB
GRANITE_FLAGS = ["--arch", "granite-moe-3b-a800m"]
MIXTRAL_LAYERS, MIXTRAL_B = 4, 2
# prompt lengths: a prompt of 4,080 wraps the ring of 4,096 at decode step
# 16; one of 4,352 fills the ring from its last 4,096 tokens and the window
# cuts its last 256 queries
MIXTRAL_PROMPTS = {"ring_wraps": 4080, "prefill_past_window": 4352}
LOSS_B, LOSS_S = 8, 160  # the actor step's shape of phase 7


@contextlib.contextmanager
def first_calls(torch, ops, names):
    """While open, keeps a copy of the inputs of the first call of each
    kernel of ``names`` through ``ops`` for each of its shapes (a decode
    step's caches change in place after the call). Yields {(name, shapes of
    the tensor inputs, the flags): (args, kwargs)}."""
    seen = {}
    kernel = {n: getattr(ops, n) for n in names}

    def keep(name):
        def call(*args, **kw):
            key = (name, tuple(tuple(a.shape) for a in args if hasattr(a, "shape")),
                   tuple(sorted((k, v) for k, v in kw.items() if not hasattr(v, "shape"))))
            if key not in seen:
                seen[key] = (tuple(a.clone() if hasattr(a, "clone") else a for a in args),
                             dict(kw))
            return kernel[name](*args, **kw)
        return call

    for n in names:
        setattr(ops, n, keep(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(ops, n, kernel[n])


def attended_pairs(sq: int, sk: int, q_offset: int, window, causal: bool = True) -> int:
    """(query, key) pairs of a prefill: causally the query at position p
    sees the keys at positions (p - window, p] below sk; without the causal
    mask every query sees every key."""
    if not causal:
        return sq * sk
    return sum(min(p + 1, sk, window or sk) for p in range(q_offset, q_offset + sq))


def path_records(torch, ops, ref, F, calls, label: str):
    """Each kernel call of ``calls`` (``first_calls``) again on its own
    inputs: the kernel's time, its plain version's, one PyTorch call's as a
    yardstick (``F.rms_norm``, SDPA, ``h @ W``) and the bound of the work of
    these inputs. Prints a ``{"check": "<label>/<kernel>"}`` line each and
    returns {kernel: {shape tag: record}}."""
    out = {}
    for (name, _, _), (args, kw) in calls.items():
        if name == "rmsnorm":
            x, w = args
            R, D = x.shape
            bms, by = bound_ms(2 * R * D * 2 + D * 4, 4 * R * D, FP32_FLOP_PER_S)
            wl = (1.0 + w).to(torch.bfloat16)
            lib = lambda: F.rms_norm(x, (D,), weight=wl, eps=1e-6)  # noqa: E731
            tag = f"{R}x{D}"
        elif name == "flash_attention":
            q, k, v = args
            Bq, Sq, H, HD = q.shape
            Sk, KVH = k.shape[1], k.shape[2]
            win, off = kw.get("window"), kw.get("q_offset", 0)
            causal = kw.get("causal", True)
            pairs = attended_pairs(Sq, Sk, off, win, causal)
            nbytes = 2 * q.numel() * 2 + 2 * Bq * Sk * KVH * HD * 2
            bms, by = bound_ms(nbytes, 4 * Bq * H * HD * pairs, BF16_TENSOR_FLOP_PER_S)
            i = torch.arange(Sq, device=q.device)[:, None] + off
            j = torch.arange(Sk, device=q.device)[None, :]
            mask = (j <= i) if causal else None
            if win:
                mask &= i - j < win
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            tag = (f"B{Bq}_S{Sq}" + (f"_Sk{Sk}" if Sk != Sq else "") + f"_H{H}_KVH{KVH}_D{HD}"
                   + (f"_window{win}" if win else "") + ("" if causal else "_noncausal")
                   + (f"_qoffset{off}" if off else ""))
        elif name == "decode_attention":
            q, k, v, n = args
            Bq, H, HD = q.shape
            S, KVH = k.shape[1], k.shape[2]
            live = int(n.sum())
            nbytes = 2 * q.numel() * 2 + Bq * H * 4 + live * KVH * HD * 2 * 2
            bms, by = bound_ms(nbytes, 4 * H * HD * live, BF16_TENSOR_FLOP_PER_S)
            mask = (torch.arange(S, device=q.device)[None, :] < n[:, None])[:, None, None, :]
            qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            tag = f"B{Bq}_slots{S}_H{H}_KVH{KVH}_D{HD}"
        elif name == "decode_attention_quant":
            q, k, v, ks, vs, n = args
            Bq, H, HD = q.shape
            S, KVH = k.shape[1], k.shape[2]
            live = int(n.sum())
            # int8 K and V and their f32 scales of the live slots
            nbytes = 2 * q.numel() * 2 + Bq * H * 4 + live * KVH * (2 * HD + 2 * 4)
            bms, by = bound_ms(nbytes, 4 * H * HD * live, BF16_TENSOR_FLOP_PER_S)
            mask = (torch.arange(S, device=q.device)[None, :] < n[:, None])[:, None, None, :]
            # SDPA on K/V dequantized beforehand (the dequantization not timed)
            kd = (k.float() * ks[..., None]).to(torch.bfloat16).transpose(1, 2)
            vd = (v.float() * vs[..., None]).to(torch.bfloat16).transpose(1, 2)
            qt = q[:, :, None]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kd, vd, attn_mask=mask, enable_gqa=True)
            tag = f"B{Bq}_slots{S}_H{H}_KVH{KVH}_D{HD}_int8"
        else:  # fused_sample
            h, head = args[0], args[1]
            Bq, D = h.shape
            V = head.shape[1]
            bms, by = bound_ms(V * D * 2 + Bq * D * 2 + Bq * 8, 2 * Bq * V * D,
                               BF16_TENSOR_FLOP_PER_S)
            lib = lambda: torch.matmul(h, head)  # noqa: E731
            tag = f"B{Bq}_head{D}x{V}_{'tied' if head.stride(0) == 1 else 'untied'}"
        with torch.inference_mode():
            rec = {"inputs": [list(a.shape) for a in args if hasattr(a, "shape")], **{
                k_: v_ for k_, v_ in kw.items() if v_ is not None},
                "ms": device_ms(lambda: getattr(ops, name)(*args, **kw), reps=11),
                "plain_ms": device_ms(lambda: getattr(ref, name)(*args, **kw), reps=5),
                "bound_ms": bms, "bound_by": by, "library_ms": device_ms(lib, reps=11)}
        out.setdefault(name, {})[tag] = rec
        print(json.dumps({"check": f"{label}/{name}/{tag}", **rec}), flush=True)
    return out


def moe_layer_record(torch, cfg, p, T: int, label: str):
    """One MoE layer (``moe.apply_moe``, the dense dispatch) on T random
    bf16 tokens: its device time beside two bounds, the dense dispatch's
    (every expert's weights once, every expert on every token) and the work
    the routing of these tokens needs (the experts they reach, top-k on
    each token); the router's fp32 product counts at the fp32 rate."""
    from repro_torch.models import moe

    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.num_experts_per_tok
    x = (torch.randn((1, T, d), generator=torch.Generator(device=DEV).manual_seed(T),
                     device=DEV) * 0.5).to(torch.bfloat16)
    with torch.inference_mode():
        # the memory one call takes beyond its inputs: a copy of an expert
        # stack (a permute and reshape of "td,edf->etf" into one GEMM) would
        # take d * f * E * 2 bytes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        moe.apply_moe(cfg, p, x)
        transient = torch.cuda.max_memory_allocated() - base
        ms = device_ms(lambda: moe.apply_moe(cfg, p, x), reps=11)
        _, _, idx = moe.route(cfg, p["router"], x[0])
    stack = E * d * f * 2
    activations = 4 * E * T * f * 2 + 2 * T * d * 4  # h, g and their products; fp32 out
    require(transient < stack / 4 or transient <= 2 * activations,
            f"{label} MoE layer at T={T}: {transient} bytes beyond its inputs, an expert "
            f"stack is {stack}")
    expert_bytes = 3 * d * f * 2
    router_bytes = d * E * 4
    io = 2 * T * d * 2
    router_s = 2 * T * d * E / FP32_FLOP_PER_S
    reached = int(torch.unique(idx).numel())

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOP_PER_S + router_s
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    dense, dense_by = bound(E * expert_bytes + router_bytes + io, 3 * 2 * T * d * f * E)
    topk, topk_by = bound(reached * expert_bytes + router_bytes + io, 3 * 2 * T * d * f * k)
    rec = {"tokens": T, "ms": ms, "dense_bound_ms": dense, "dense_bound_by": dense_by,
           "transient_mb": transient / 1e6, "expert_stack_mb": stack / 1e6,
           "dense_tflop": 6 * T * d * f * E / 1e12, "topk_bound_ms": topk,
           "topk_bound_by": topk_by, "experts_reached": reached,
           "weight_mb": (E * expert_bytes + router_bytes) / 1e6}
    print(json.dumps({"check": f"{label}/moe_layer/T{T}", **rec}), flush=True)
    return rec


def route_flips(torch, ops, model, params, prompt, smax: int):
    """Per MoE layer, the tokens whose top-k experts differ between the
    plain path's prefill and the kernel path's on ``prompt`` (free running:
    each path routes its own hidden states, so a rounding difference moves
    a token whose k-th and (k+1)-th router logits lie that close)."""
    with torch.inference_mode(), routes_recorded(torch) as seen:
        for mode in ("ref", None):
            ops.set_mode(mode)
            model.prefill(params, prompt, smax=smax)
    ops.set_mode(None)
    n = len(seen) // 2
    return [int((a != b).any(dim=-1).sum()) for a, b in zip(seen[:n], seen[n:])]


def held_generate(torch, ops, ref, _build, generate, model, params, prompt, label: str,
                  **kw):
    """One greedy ``generate`` with the launch counters set to 0 just before
    it and read just after, every kernel call held to plain, the first call
    of each shape kept and the routings recorded. Returns (result, launches,
    held, first calls, routings)."""
    names = path_kernels(model.cfg)
    _build.reset_launches()
    with first_calls(torch, ops, names) as calls, \
            held_to_plain(torch, ops, ref, names) as held, routes_recorded(torch) as routes:
        res = generate(model, params, prompt, torch.Generator(device=DEV).manual_seed(7),
                       max_new=MAX_NEW, temperature=0.0, **kw)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = forward_launches(model.cfg, _build.LAUNCHES, 1, MAX_NEW - 1)
    require(launches == want, f"{label}: launches {launches}, expected {want}")
    require(all(held[n]["calls"] == launches[n] for n in names),
            f"{label} held to plain: calls {held}, launches {launches}")
    print(json.dumps({"check": f"{label}_held_to_plain", "kernels": held}), flush=True)
    return res, launches, held, calls, routes


def moe_phase(torch, ops, ref, F, _build, serve, generate, records, label="moe"):
    """The MoE family at full width (random bf16 weights from ``--seed 0``),
    each model freed before the next is drawn:

    1. granite-moe-3b lockstep on GRANITE_LAYERS layers (``serve --arch
       granite-moe-3b-a800m --lockstep``, phase 3's shape and checks): the
       launch counters, tokens in range and repeatable, the plain path's
       agreement, with the route flips between the two paths per layer;
       one greedy generate with every kernel call held to plain and each
       kernel timed on the inputs of its first call of each shape; one MoE
       layer at decode (8 tokens) and at prefill (1,024) beside its bounds;
       ``model.loss`` at 8 x 160 (a finite ``moe_aux``, the loss within
       2e-2 of the plain path's);
    2. GRPO through ``launch.train --arch granite-moe-3b-a800m`` on phase
       8's experiment file, distributed arm: the warm-up iteration held to
       plain, then 2 timed ones, each with phase 8's checks;
    3. mixtral-8x7b at 4 of its 32 layers: two greedy generates of B = 2
       (``MIXTRAL_PROMPTS``, 32 new tokens) with every kernel call held to
       plain and timed as in 1, then ``logprobs_fn`` over each whole
       sequence (windowed full attention): the step-0 ratio against the
       sampler's logprobs within 1 +- RATIO_TOL, and the argmax of its
       logits equal to the greedy token wherever their top two are clear by
       0.05 and no token of the row up to that position took other experts
       in the two forwards (route flips, counted and printed); one MoE layer
       at decode (2 tokens) and at the 2 x 4,352 prefill.

    The kernels' records at the new shapes join ``records`` (under each
    kernel's ``"phase13"``). Prints ``{label: ...}``. Returns {path: launch
    counts}."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.models import get_model, lm

    t_phase = time.perf_counter()
    counts, summary = {}, {}
    # ---- 1. granite lockstep ----
    torch.cuda.reset_peak_memory_stats()
    model, params, tok = build_model(torch, serve, GRANITE_FLAGS, GRANITE_LAYERS)
    cfg = model.cfg
    # the route flips first: they are what an agreement check would miss on
    _, ids = serve.prompts(tok, B, PROMPT)
    prompt = torch.from_numpy(ids).to(DEV)
    flips = route_flips(torch, ops, model, params, prompt, SMAX)
    print(json.dumps({"check": "granite_route_flips", "tokens": B * PROMPT,
                      "flipped_per_layer": flips}), flush=True)
    counts["granite_lockstep"], e2e, _ = end_to_end_phase(
        torch, ops, _build, serve, generate, model, params, tok, label="e2e_granite",
        layerwise=True, batches=1, reps=3)
    _, _, held, calls, _ = held_generate(torch, ops, ref, _build, generate, model, params,
                                         prompt, "granite_generate", eos_id=tok.eos_id)
    kernels = {"granite": path_records(torch, ops, ref, F, calls, "granite")}
    layer = {T: moe_layer_record(torch, cfg, params["blocks"][0]["moe"], T, "granite")
             for T in (B, 1024)}
    gen = torch.Generator(device=DEV).manual_seed(11)
    tokens = torch.randint(3, cfg.vocab_size, (LOSS_B, LOSS_S), generator=gen, device=DEV,
                           dtype=torch.int32)
    labels = torch.cat([tokens[:, 1:], torch.full((LOSS_B, 1), lm.IGNORE, device=DEV,
                                                  dtype=torch.int32)], dim=1)
    batch = {"tokens": tokens, "labels": labels}
    with torch.no_grad():
        loss_k, m_k = model.loss(params, batch)
        ops.set_mode("ref")
        loss_r, m_r = model.loss(params, batch)
        ops.set_mode(None)
    aux_k, aux_r = float(m_k["moe_aux"]), float(m_r["moe_aux"])
    require(bool(torch.isfinite(m_k["moe_aux"])) and aux_k > 0,
            f"granite loss: moe_aux {aux_k}")
    err = abs(float(loss_k) - float(loss_r))
    require(err <= 2e-2 * abs(float(loss_r)),
            f"granite loss {float(loss_k)} against the plain path's {float(loss_r)}")
    summary["granite_lockstep"] = {
        "decode_step_ms": e2e["decode_step_ms"], "decode_tok_per_s": e2e["decode_tok_per_s"],
        "prefill_and_first_token_ms": e2e["prefill_and_first_token_ms"],
        "route_flips_per_layer": flips, "held_to_plain": held, "moe_layer": layer,
        "loss": {"kernel": float(loss_k), "plain": float(loss_r), "abs_err": err,
                 "moe_aux": aux_k, "plain_moe_aux": aux_r},
        "peak_gib": e2e["peak_gib"]}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 2. granite GRPO through launch.train ----
    counts["granite_grpo_pipeline"], summary["granite_pipeline"] = pipeline_phase(
        torch, ops, ref, _build, label="granite_pipeline", flags=GRANITE_FLAGS,
        arms=(("distributed", 0),), layers=GRANITE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 3. mixtral-8x7b at 4 layers, across its window ----
    torch.cuda.reset_peak_memory_stats()
    mcfg = dc.replace(get_config("mixtral-8x7b"), num_layers=MIXTRAL_LAYERS)
    model = get_model(mcfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    print(f"[model] {mcfg.name} at {MIXTRAL_LAYERS} of 32 layers: d_model {mcfg.d_model}, "
          f"{mcfg.num_heads} heads on {mcfg.num_kv_heads} KV heads of {mcfg.head_dim}, "
          f"{mcfg.num_experts} experts of {mcfg.d_ff}, window {mcfg.sliding_window}; weights "
          f"drawn in {time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    head = lm._head_matrix(mcfg, params)
    arms = {}
    for arm, L in MIXTRAL_PROMPTS.items():
        _, ids = serve.prompts(tok, MIXTRAL_B, L)
        prompt = torch.from_numpy(ids).to(DEV)
        res, launches, held, calls, gen_routes = held_generate(
            torch, ops, ref, _build, generate, model, params, prompt, f"mixtral_{arm}")
        counts.setdefault("mixtral_ring", dict.fromkeys(launches, 0))
        for n, c in launches.items():
            counts["mixtral_ring"][n] += c
        kernels[f"mixtral_{arm}"] = path_records(torch, ops, ref, F, calls, f"mixtral_{arm}")
        W = lm.ring_width(mcfg, L + MAX_NEW)
        require(W == mcfg.sliding_window, f"mixtral ring width {W}")
        resp = res.tokens[:, L:]
        require(bool(((resp >= 0) & (resp < mcfg.vocab_size)).all()), "mixtral token range")
        with torch.inference_mode():
            with routes_recorded(torch) as full_routes:
                lp, _ = model.logprobs(params, res.tokens)
            h, _ = lm._full_hidden(mcfg, params, res.tokens, False)
            # the logits that predict positions L .., the padded vocab masked
            logits = lm.mask_padded_vocab(mcfg, (h[:, L - 1:-1] @ head).float())
        mask = res.response_mask[:, L:]
        ratio = float((torch.exp(lp[:, L:] - res.old_logprob[:, L:]) * mask).sum() / mask.sum())
        require(abs(ratio - 1.0) <= RATIO_TOL,
                f"mixtral {arm}: step-0 ratio {ratio} of logprobs_fn against the sampler")
        # route flips between generate (the prefill, then one token a step)
        # and the full forward, by row and position (the last token is never
        # fed to generate); the prediction of position t reads positions < t
        n = len(full_routes)

        def at(routes, lo, hi):  # the routings of positions [lo, hi) of each row
            return [r.reshape(MIXTRAL_B, -1, r.shape[-1])[:, lo:hi].reshape(-1, r.shape[-1])
                    for r in routes]

        gen_flip = torch.cat(
            [flipped(torch, gen_routes[:n], at(full_routes, 0, L), MIXTRAL_B)]
            + [flipped(torch, gen_routes[n * (1 + j):n * (2 + j)],
                       at(full_routes, L + j, L + j + 1), MIXTRAL_B) for j in range(MAX_NEW - 1)],
            dim=1)
        before = torch.cumsum(gen_flip.int(), dim=1) > 0  # a flip at or before position p
        explained = before[:, L - 1:]  # for the predictions of positions L ..
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 0.05
        agree = logits.argmax(dim=-1) == resp
        require(bool(agree[clear & ~explained].all()),
                f"mixtral {arm}: the windowed full forward's argmax differs from a greedy "
                f"token in a clear position with no route flip before it")
        _, ms = sync_ms(torch, lambda: generate(
            model, params, prompt, torch.Generator(device=DEV).manual_seed(7),
            max_new=MAX_NEW, temperature=0.0))
        arms[arm] = {"prompt": L, "ring_slots": W, "step0_ratio": ratio,
                     "clear_positions": int(clear.sum()), "positions": int(mask.sum()),
                     "route_flips": int(gen_flip.sum()),
                     "clear_disagreeing": int((clear & ~agree).sum()),
                     "clear_disagreeing_after_a_flip": int((clear & ~agree & explained).sum()),
                     "max_abs_dlogprob": float(((lp[:, L:] - res.old_logprob[:, L:]) * mask)
                                               .abs().max()),
                     "generate_ms": ms, "held_to_plain": held}
        print(json.dumps({"mixtral_arm": {"arm": arm, **arms[arm]}}), flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    mlayer = {T: moe_layer_record(torch, mcfg, params["blocks"][0]["moe"], T, "mixtral")
              for T in (MIXTRAL_B, MIXTRAL_B * MIXTRAL_PROMPTS["prefill_past_window"])}
    summary["mixtral"] = {"arms": arms, "moe_layer": mlayer, "peak_gib": peak}
    for where, recs in kernels.items():
        for name, by_shape in recs.items():
            records.setdefault(name, {}).setdefault("phase13", {})[where] = by_shape
    summary["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: summary}), flush=True)
    del model, params, head
    gc.collect()
    torch.cuda.empty_cache()
    return counts


NEMOTRON_FLAGS = ["--arch", "nemotron-4-15b"]
SEAMLESS_FLAGS = ["--arch", "seamless-m4t-medium"]
LLAVA_FLAGS = ["--arch", "llava-next-34b"]
COMMAND_R_LAYERS = 4  # of 64: the full model's 208 GB of bf16 weights exceed the card
SEAMLESS_B = 2  # frames (2, 4,096, 1,024): the memory of the encoder_len of the config
LLAVA_B = 1
TOP_P, TINY_TOP_P, TOP_P_TEMPERATURE = 0.9, 1e-6, 0.8


def top_p_checks(torch, ops, ref, _build, generate, model, params, prompt, label: str):
    """Nucleus sampling on ``model``: a generate at ``TOP_P`` and
    temperature 0.8 (its sampler calls recorded), in which ``fused_sample``
    launches 0 times while the attention kernels launch as in a greedy
    generate, and every drawn token (the prefill's, through
    ``rollout.sample_token``, and every decode step's) lies in its row's
    nucleus recomputed from that step's plain logits; then a generate at
    ``TINY_TOP_P``, whose streams must equal the kernel path's greedy
    streams bit for bit: only each row's top token survives the filter. If
    they part, the step where they first part must be a near tie of the
    plain logits (top two within SAMPLE_GAP), as the sampler checks allow.
    Returns the numbers."""
    from repro_torch.models import lm
    from repro_torch.rl import rollout as rollout_mod

    cfg = model.cfg
    head = lm._head_matrix(cfg, params)
    steps, first = [], []
    fused, sample_token = ops.fused_sample, rollout_mod.sample_token

    def recording_fused(h, w_head, seeds, inv_temp, *, vocab_size=None, top_p=1.0):
        tok, lp = fused(h, w_head, seeds, inv_temp, vocab_size=vocab_size, top_p=top_p)
        steps.append((h.clone(), seeds.clone(), inv_temp.clone(), tok.clone()))
        return tok, lp

    def recording_first(logits, seeds, temperature, top_p=1.0):
        tok = sample_token(logits, seeds, temperature, top_p)
        first.append((logits.clone(), tok.clone()))
        return tok

    def run(top_p, temperature):
        steps.clear()
        first.clear()
        _build.reset_launches()
        with patched(ops, "fused_sample", recording_fused), \
                patched(rollout_mod, "sample_token", recording_first):
            res, ms = sync_ms(torch, lambda: generate(
                model, params, prompt, torch.Generator(device=DEV).manual_seed(5),
                max_new=MAX_NEW, temperature=temperature, top_p=top_p))
        return res, ms, dict(_build.LAUNCHES)

    res, ms, launches = run(TOP_P, TOP_P_TEMPERATURE)
    want = forward_launches(cfg, _build.LAUNCHES, 1, MAX_NEW - 1)
    want["fused_sample"] = 0
    require(launches == want, f"{label} top_p: launches {launches}, expected {want}")
    kept, inside, outside = [], 0, []

    def hold(step, scaled, tok):
        nonlocal inside
        keep = ref.nucleus(scaled, TOP_P)
        ok = keep.gather(1, tok[:, None].long())[:, 0]
        inside += int(ok.sum())
        kept.append(keep.sum(dim=1))
        for row in (~ok).nonzero()[:, 0].tolist():  # where a draw left it: its place
            x, t = scaled[row], int(tok[row])
            first_ = (x > x[t]) | ((x == x[t]) & (torch.arange(x.numel(), device=DEV) < t))
            outside.append({"step": step, "row": row, "token": t, "rank": int(first_.sum()),
                            "nucleus": int(keep[row].sum()),
                            "mass_before": float(torch.softmax(x, -1)[first_].sum())})

    with torch.inference_mode():
        logits, tok = first[0]
        hold(0, logits.float() * (1.0 / TOP_P_TEMPERATURE), tok)
        for j, (h, seeds, it, tok) in enumerate(steps):
            z, _ = ref.sample_scores(h, head, seeds, it, vocab_size=cfg.vocab_size)
            hold(j + 1, z * it[:, None], tok)
    drawn = prompt.shape[0] * (1 + len(steps))
    require(len(steps) == MAX_NEW - 1 and inside == drawn,
            f"{label} top_p: {drawn - inside} of {drawn} drawn tokens outside their nucleus: "
            f"{outside}")
    kept = torch.stack(kept).float()
    out = {"top_p": TOP_P, "temperature": TOP_P_TEMPERATURE, "drawn_tokens": drawn,
           "inside_nucleus": inside, "nucleus_size_median": float(kept.median()),
           "nucleus_size_max": float(kept.max()), "generate_ms": ms, "launches": launches}
    tiny, tiny_ms, _ = run(TINY_TOP_P, TOP_P_TEMPERATURE)
    tiny_steps = list(steps)
    greedy, greedy_ms, _ = run(1.0, 0.0)
    same = torch.equal(tiny.tokens, greedy.tokens)
    out.update(tiny_top_p=TINY_TOP_P, tiny_equals_greedy=same, tiny_generate_ms=tiny_ms,
               greedy_generate_ms=greedy_ms)
    if not same:
        # the first response position where a row parts, and its decode step
        col = int((tiny.tokens != greedy.tokens).any(dim=0).nonzero()[0])
        r = col - prompt.shape[1]
        require(r >= 1, f"{label}: the tiny top_p stream parts from greedy at the prefill")
        h, seeds, it, _ = tiny_steps[r - 1]
        with torch.inference_mode():
            z, _ = ref.sample_scores(h, head, seeds, it, vocab_size=cfg.vocab_size)
            top2 = z.topk(2, dim=-1).values
        rows = tiny.tokens[:, col] != greedy.tokens[:, col]
        gap = float((top2[:, 0] - top2[:, 1])[rows].max())
        out.update(first_parting_position=r, first_parting_gap=gap)
        require(gap < SAMPLE_GAP, f"{label}: the tiny top_p stream parts from greedy at "
                                  f"response position {r}, top-two gap {gap}")
    print(json.dumps({"check": f"{label}_top_p", **out}), flush=True)
    return out


def seamless_serving(torch, ops, ref, _build, model, params, prompt, frames):
    """``Model.prefill`` over ``prompt`` with ``frames``, then MAX_NEW steps
    of ``Model.decode_step`` with the caller's argmax (enc-dec has no fused
    sampler, as in JAX): once with every kernel call held to plain and the
    first call of each shape kept, then timed. The kernel path's prefill
    logits against the plain path's, within DRIFT_FACTOR x the plain path's
    drift with fp32 attention probabilities. Returns (launches, held, first
    calls, summary)."""
    names = ("flash_attention", "decode_attention")
    cfg = model.cfg
    Bq, S = prompt.shape

    def serve_once():
        logits, caches, clen = model.prefill(params, prompt, smax=S + MAX_NEW, frames=frames)
        toks = [torch.argmax(logits, dim=-1).to(torch.int32)]
        for _ in range(MAX_NEW):
            logits, caches, clen = model.decode_step(params, toks[-1], caches, clen)
            toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
        return torch.stack(toks, dim=1), logits

    with torch.inference_mode():
        _build.reset_launches()
        with first_calls(torch, ops, names) as calls, \
                held_to_plain(torch, ops, ref, names) as held:
            toks, last = serve_once()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want = dict.fromkeys(launches, 0)
        want.update(flash_attention=cfg.num_encoder_layers + 2 * cfg.num_layers,
                    decode_attention=2 * cfg.num_layers * MAX_NEW)
        require(launches == want, f"seamless serving: launches {launches}, expected {want}")
        require(all(held[n]["calls"] == launches[n] for n in names),
                f"seamless held to plain: calls {held}, launches {launches}")
        print(json.dumps({"check": "seamless_serving_held_to_plain", "kernels": held}),
              flush=True)
        require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
                and bool(torch.isfinite(last[:, :cfg.vocab_size]).all()),
                "seamless serving: a token out of range or a non-finite logit")
        real = slice(0, cfg.vocab_size)
        logits_k = model.prefill(params, prompt, smax=S + MAX_NEW, frames=frames)[0]
        ops.set_mode("ref")
        logits_r = model.prefill(params, prompt, smax=S + MAX_NEW, frames=frames)[0]
        with fp32_attention(ref):
            logits_v = model.prefill(params, prompt, smax=S + MAX_NEW, frames=frames)[0]
        ops.set_mode(None)
        err = float((logits_k - logits_r)[:, real].abs().max())
        drift = float((logits_v - logits_r)[:, real].abs().max())
        scale = float(logits_r[:, real].abs().max())
        require(err <= DRIFT_FACTOR * drift,
                f"seamless prefill logits: max abs err {err}, more than {DRIFT_FACTOR} x the "
                f"plain path's drift with fp32 attention probabilities ({drift})")

    def timed(fn):
        return statistics.median(sync_ms(torch, fn)[1] for _ in range(3))

    with torch.inference_mode():
        whole = timed(serve_once)
        prefill = timed(lambda: model.prefill(params, prompt, smax=S + MAX_NEW, frames=frames))
    step = (whole - prefill) / MAX_NEW
    summary = {"batch": Bq, "prompt": S, "frames": list(frames.shape), "decode_steps": MAX_NEW,
               "serve_ms": whole, "prefill_ms": prefill, "decode_step_ms": step,
               "decode_tok_per_s": Bq / step * 1e3, "prefill_logits_max_abs_err": err,
               "plain_fp32_attention_logits_max_abs_err": drift, "max_abs_logit": scale,
               "held_to_plain": held}
    return launches, held, calls, summary


def families_phase(torch, ops, ref, F, _build, serve, generate, records, label="families"):
    """The remaining families at full width (random bf16 weights from
    ``--seed 0``), each model freed before the next is drawn:

    1. nemotron-4-15b at full width on NEMOTRON_LAYERS of its 32 layers (layernorm, squared
       ReLU, 48 heads on 8 KV heads of 128, an untied 6,144 x 256,000 head)
       through ``serve --arch nemotron-4-15b --lockstep``, phase 3's shape
       and checks, held to the plain path as a deep dense stack is (the
       free-running logits within DRIFT_FACTOR x the plain path's drift with
       fp32 attention probabilities, then layer by layer); one greedy
       generate held to plain call by call, each kernel timed on the inputs
       of its first call of each shape; then ``top_p_checks``;
    2. command-r-plus-104b at full width on 4 of its 64 layers (parallel
       blocks, 96 heads on 8 KV heads of 128), as 1 without the ``top_p``
       checks;
    3. seamless-m4t-medium at full width and depth (12 + 12 layers, 16 MHA
       heads of 64, layernorm, biases, the GELU MLP) on random frames (2,
       4,096, 1,024): ``seamless_serving``, then ``Model.loss`` at 2 x 128
       decoder tokens held by ``grad_check`` (the fp32-attention drift; the
       loss also within 2e-2 of plain) and one AdamW step of
       ``trainer.make_lm_train_step``;
    4. llava-next-34b at full width on LLAVA_LAYERS of its 60 layers, B = 1: random prefix
       embeddings (1, 2,880, 7,168) ahead of a 128-token prompt, 32 new
       tokens through ``generate(prefix_embeds=...)`` held to plain call by
       call; the agreement of 1 with the prefix; ``logprobs_fn`` with the
       prefix against the sampler's logprobs (step-0 ratio within 1 +-
       RATIO_TOL).

    The kernels' records at the new shapes join ``records`` (under each
    kernel's ``"phase14"``). Prints ``{label: ...}``. Returns {path: launch
    counts}."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.rl import trainer

    t_phase = time.perf_counter()
    counts, summary, kernels = {}, {}, {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def lockstep(model, params, tok, name):
        counts[f"{name}_lockstep"], e2e, _ = end_to_end_phase(
            torch, ops, _build, serve, generate, model, params, tok, label=f"e2e_{name}",
            layerwise=True, batches=1, reps=3)
        _, ids = serve.prompts(tok, B, PROMPT)
        prompt = torch.from_numpy(ids).to(DEV)
        _, _, held, calls, _ = held_generate(torch, ops, ref, _build, generate, model, params,
                                             prompt, f"{name}_generate", eos_id=tok.eos_id)
        kernels[name] = path_records(torch, ops, ref, F, calls, name)
        keys = ("decode_step_ms", "decode_tok_per_s", "prefill_and_first_token_ms",
                "greedy_tok_per_s", "sampled_tok_per_s", "peak_gib",
                "prefill_logits_max_abs_err", "plain_fp32_attention_logits_max_abs_err",
                "worst_layer_err_over_max", "free_running_first_token_equal_rows")
        return prompt, {**{k: e2e.get(k) for k in keys}, "held_to_plain": held}

    # ---- 1. nemotron-4-15b ----
    free()
    model, params, tok = build_model(torch, serve, NEMOTRON_FLAGS, NEMOTRON_LAYERS)
    prompt, summary["nemotron"] = lockstep(model, params, tok, "nemotron")
    summary["nemotron"]["top_p"] = top_p_checks(torch, ops, ref, _build, generate, model,
                                                params, prompt, "nemotron")
    del model, params
    free()
    # ---- 2. command-r-plus-104b at 4 layers ----
    ccfg = dc.replace(get_config("command-r-plus-104b"), num_layers=COMMAND_R_LAYERS)
    model = get_model(ccfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    print(f"[model] {ccfg.name} at {COMMAND_R_LAYERS} of 64 layers: d_model {ccfg.d_model}, "
          f"{ccfg.num_heads} heads on {ccfg.num_kv_heads} KV heads of {ccfg.head_dim}, "
          f"SwiGLU {ccfg.d_ff}, parallel blocks; weights drawn in "
          f"{time.perf_counter() - t0:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    _, summary["command_r"] = lockstep(model, params, tok, "command_r")
    del model, params
    free()
    # ---- 3. seamless-m4t-medium: serving, then one training step ----
    model, params, tok = build_model(torch, serve, SEAMLESS_FLAGS)
    cfg = model.cfg
    gen = torch.Generator(device=DEV).manual_seed(13)
    frames = torch.randn((SEAMLESS_B, cfg.encoder_len, cfg.d_model), generator=gen,
                         device=DEV).to(torch.bfloat16)
    _, ids = serve.prompts(tok, SEAMLESS_B, PROMPT)
    prompt = torch.from_numpy(ids).to(DEV)
    counts["seamless_serving"], _, calls, serving = seamless_serving(
        torch, ops, ref, _build, model, params, prompt, frames)
    serving["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    kernels["seamless"] = path_records(torch, ops, ref, F, calls, "seamless")
    tokens = torch.randint(3, cfg.vocab_size, (SEAMLESS_B, PROMPT), generator=gen, device=DEV,
                           dtype=torch.int32)
    labels = torch.cat([tokens[:, 1:], torch.full((SEAMLESS_B, 1), -1, device=DEV,
                                                  dtype=torch.int32)], dim=1)
    batch = {"frames": frames, "tokens": tokens, "labels": labels}
    torch.cuda.reset_peak_memory_stats()
    # the forward's flash calls, then the layers again in the backward (remat)
    step_launches = {"flash_attention": 2 * (cfg.num_encoder_layers + 2 * cfg.num_layers)}
    gcheck = grad_check(torch, ops, _build, trainer, lambda p: model.loss(p, batch), params,
                        step_launches, fp32_attention(ref), "seamless_grad_check",
                        zero_grad=("cross_attn.b_k",))
    loss_k, loss_r = gcheck["loss_kernel"], gcheck["loss_plain"]
    require(abs(loss_k - loss_r) <= 2e-2 * abs(loss_r),
            f"seamless loss {loss_k} against the plain path's {loss_r}")
    counts["seamless_training"] = gcheck["launches_per_loss_and_grad"]
    leaf = params["decoder"][0]["self_attn"]["w_q"]
    before = leaf.clone()
    state = trainer.init_state(params)
    (state, metrics), step_ms = sync_ms(
        torch, lambda: trainer.make_lm_train_step(model)(state, batch))
    require(bool(torch.isfinite(metrics["loss"])) and float(metrics["grad_norm"]) > 0
            and not torch.equal(before, leaf), "seamless AdamW step: no finite move")
    summary["seamless"] = {
        "serving": serving,
        "training": {"batch": [SEAMLESS_B, PROMPT], "loss_kernel": loss_k, "loss_plain": loss_r,
                     "grad_check_worst_ratio": gcheck["worst_ratio"],
                     "grad_check_worst_leaf": gcheck["worst_ratio_leaf"],
                     "leaves_beyond_limit": gcheck["leaves_beyond_limit"],
                     "first_step_ms": step_ms, "grad_norm": float(metrics["grad_norm"]),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}}
    print(json.dumps({"seamless": summary["seamless"]}), flush=True)
    del model, params, state, batch, frames, before, leaf
    free()
    # ---- 4. llava-next-34b, B = 1, with its prefix ----
    model, params, tok = build_model(torch, serve, LLAVA_FLAGS, LLAVA_LAYERS)
    cfg = model.cfg
    P = cfg.num_prefix_embeds
    prefix = (torch.randn((LLAVA_B, P, cfg.d_model), generator=torch.Generator(
        device=DEV).manual_seed(17), device=DEV) * 0.02).to(torch.bfloat16)
    _, ids = serve.prompts(tok, LLAVA_B, PROMPT)
    prompt = torch.from_numpy(ids).to(DEV)
    res, launches, held, calls, _ = held_generate(
        torch, ops, ref, _build, generate, model, params, prompt, "llava_generate",
        prefix_embeds=prefix)
    counts["llava_generate"] = launches
    resp = res.tokens[:, PROMPT:]
    require(bool(((resp >= 0) & (resp < cfg.vocab_size)).all()), "llava token range")
    kernels["llava"] = path_records(torch, ops, ref, F, calls, "llava")
    with torch.inference_mode():
        lp, _ = model.logprobs(params, res.tokens, prefix_embeds=prefix)
    mask = res.response_mask[:, PROMPT:]
    ratio = float((torch.exp(lp[:, PROMPT:] - res.old_logprob[:, PROMPT:]) * mask).sum()
                  / mask.sum())
    require(abs(ratio - 1.0) <= RATIO_TOL,
            f"llava: step-0 ratio {ratio} of logprobs_fn against the sampler")
    checks = plain_agreement(torch, ops, model, params, prompt, P + PROMPT + MAX_NEW, "llava",
                             layerwise=True, prefix=prefix)

    def gen_ms(max_new):
        return statistics.median(sync_ms(torch, lambda: generate(
            model, params, prompt, torch.Generator(device=DEV).manual_seed(7),
            max_new=max_new, temperature=0.0, prefix_embeds=prefix))[1] for _ in range(3))

    whole, prefill = gen_ms(MAX_NEW), gen_ms(1)
    step = (whole - prefill) / (MAX_NEW - 1)
    summary["llava"] = {"batch": LLAVA_B, "prefix": P, "prompt": PROMPT, "generate_ms": whole,
                        "prefill_and_first_token_ms": prefill, "decode_step_ms": step,
                        "decode_tok_per_s": LLAVA_B / step * 1e3, "step0_ratio": ratio,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "held_to_plain": held, **checks}
    print(json.dumps({"llava": summary["llava"]}), flush=True)
    del model, params, res, lp, prefix
    free()
    for where, recs in kernels.items():
        for name, by_shape in recs.items():
            records.setdefault(name, {}).setdefault("phase14", {})[where] = by_shape
    summary["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: summary}), flush=True)
    return counts


# phase 15: checkpoints and telemetry through launch.train at gemma-2b's full
# width and depth, on phase 8's experiment file
CKPT_ITERS = 2  # run A: a warm-up held to plain, a timed iteration, then the save
# the state's depth: 2 of gemma-2b's 18 layers (7.6 GB of state), cut from the
# full 26.6 GB to keep the whole script inside its time limit
CKPT_LAYERS = 2
CKPT_RESUMED_ITERS = 3  # runs B and C: iteration 2 after the restore


def state_bytes(torch, cfg) -> int:
    """Bytes of the actor's TrainState of ``cfg`` (bf16 and fp32 params,
    fp32 AdamW moments, the int32 step), from shapes on the meta device."""
    from repro_torch import tree
    from repro_torch.models import lm
    from repro_torch.rl import trainer

    state = trainer.init_state(lm.init(cfg, torch.Generator(), device="meta"))
    return sum(x.numel() * x.element_size() for x in tree.leaves(state))


@contextlib.contextmanager
def rss_sampled(interval_s: float = 0.05):
    """While open, a thread reads this process's resident set size every
    ``interval_s``; yields {"start_gib", "peak_gib"} (the first reading and
    the largest so far)."""
    import os
    import threading

    page = os.sysconf("SC_PAGE_SIZE")

    def rss_gib():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page / 2**30

    seen = {"start_gib": rss_gib()}
    seen["peak_gib"] = seen["start_gib"]
    stop = threading.Event()

    def sample():
        while not stop.wait(interval_s):
            seen["peak_gib"] = max(seen["peak_gib"], rss_gib())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        stop.set()
        thread.join()


@contextlib.contextmanager
def observed_checkpoints(torch):
    """While open, every ``checkpoint.save`` and ``checkpoint.restore`` is
    bracketed by ``torch.cuda.synchronize`` and timed; a restore also keeps
    the bit checksums of what it restored (``bit_checksum``, params and
    optimizer apart) and whether every leaf kept its template's storage.
    Yields {"save": [...], "restore": [...]}."""
    from repro_torch import tree
    from repro_torch.ft import checkpoint

    seen = {"save": [], "restore": []}
    save, restore = checkpoint.save, checkpoint.restore

    def timed_save(ckpt_dir, state, **kw):
        nbytes = sum(x.numel() * x.element_size() for x in tree.leaves(state))
        _, ms = sync_ms(torch, lambda: save(ckpt_dir, state, **kw))
        seen["save"].append({"s": ms / 1e3, "state_bytes": nbytes, "file_bytes":
                             (Path(ckpt_dir) / checkpoint.FILE).stat().st_size})
        return None

    def timed_restore(ckpt_dir, template, **kw):
        ptrs = [x.data_ptr() for x in tree.leaves(template)]
        (state, step), ms = sync_ms(torch, lambda: restore(ckpt_dir, template, **kw))
        seen["restore"].append({
            "s": ms / 1e3, "step": step,
            "file_bytes": (Path(ckpt_dir) / checkpoint.FILE).stat().st_size,
            "same_storage": [x.data_ptr() for x in tree.leaves(state)] == ptrs,
            "checksum": {"params": bit_checksum(torch, state.params),
                         "opt": bit_checksum(torch, state.opt)}})
        return state, step

    checkpoint.save, checkpoint.restore = timed_save, timed_restore
    try:
        yield seen
    finally:
        checkpoint.save, checkpoint.restore = save, restore


@contextlib.contextmanager
def observed_first_generation(torch):
    """While open, the bit checksums of the params that the async worker
    publishes first (its version 0) and that the first ``generate`` runs.
    Yields {"published", "generated"}."""
    from repro_torch.distributed.weight_sync import WeightVersionStore
    from repro_torch.rl import rollout as rollout_mod

    seen = {"published": None, "generated": None}
    publish, generate = WeightVersionStore.publish, rollout_mod.generate

    def publish_kept(self, params, **kw):
        out = publish(self, params, **kw)
        if seen["published"] is None:
            seen["published"] = bit_checksum(torch, out.params)
        return out

    def generate_kept(model, params, *args, **kw):
        if seen["generated"] is None:
            seen["generated"] = bit_checksum(torch, params)
        return generate(model, params, *args, **kw)

    WeightVersionStore.publish, rollout_mod.generate = publish_kept, generate_kept
    try:
        yield seen
    finally:
        WeightVersionStore.publish, rollout_mod.generate = publish, generate


def ckpt_phase(torch, ops, ref, _build, label="ckpt", pipeline_ms=None):
    """Phase 15: checkpoints and telemetry through ``launch.train.main`` at
    gemma-2b's full width on CKPT_LAYERS of its layers, on phase 8's
    experiment file cut to that depth (``build/ckpt_experiment.json``; sync
    GRPO, the distributed arm), the launch counters set to 0 just before each run
    and read just after it, each pipeline freed before the next is built:

    - run A: ``--iters 2 --ckpt-dir build/ckpt15 --ckpt-every 2 --obs-trace
      --obs-metrics``: the warm-up iteration held to plain (calls equal to
      its launches), every iteration's launches as phase 8's, phase 8's
      per-iteration checks (finite metrics, ratio_mean within 1 +- RATIO_TOL,
      a nonzero gradient, a nonzero KL after iteration 0); the save after
      iteration 1 synchronised and timed (seconds, GB, GB/s); the JSONL holds 2 records whose metrics are the
      returned history, the Chrome trace parses and holds a ``node/<id>``
      span for every node of each iteration, the registry's ``train/step_s``
      counts 2; a bit checksum of the final state (params, m, v, step);
    - run B: ``--resume build/ckpt15 --iters 3``: the restore (timed) gives
      A's checksums leaf for leaf in the template's own tensors, iteration 2
      runs with phase 8's checks, and the AdamW step reads 3 after it;
    - run C: B with ``--max-staleness 1``: the weights that the async worker
      publishes first and that its first generation runs carry A's params
      checksums; the tick only generates.

    Before A, the free space under ``build/`` must hold twice the state (it
    raises with the figures, never skips). Prints run A's timed iteration ms
    beside phase 8's distributed arm (``pipeline_ms``, when phase 8 ran), the
    peak host RSS over the phase and ``phase_s``; the checkpoint is deleted
    at the end. The global tracer that run A installs is restored after it.
    Returns {path: the run's launch counts}."""
    import shutil

    import numpy as np

    from repro_torch.api import ExperimentSpec
    from repro_torch.launch import train
    from repro_torch.obs import get_tracer, set_tracer
    from repro_torch.rl import algorithms

    t_phase = time.perf_counter()
    spec = json.loads(experiment_file("pipeline", ARCH_FLAGS, PIPE_RL).read_text())
    spec["model"]["num_layers"] = CKPT_LAYERS
    exp_path = ROOT / "build" / "ckpt_experiment.json"
    exp_path.write_text(json.dumps(spec))
    exp = ExperimentSpec.from_json(exp_path.read_text())
    cfg, grpo = exp.model, algorithms.get_algorithm(exp.rl.algorithm)
    per_iter, step = iteration_launches(cfg, _build.LAUNCHES, exp.rl.max_new_tokens,
                                        grpo.dag_factory())
    names = path_kernels(cfg)
    build = ROOT / "build"
    ckpt, trace, jsonl = build / "ckpt15", build / "trace15.json", build / "metrics15.jsonl"
    for p in (trace, jsonl):
        p.unlink(missing_ok=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    nbytes = state_bytes(torch, cfg)
    free = shutil.disk_usage(build).free
    require(free >= 2 * nbytes, f"{label}: {free / 1e9:.2f} GB free under build/, the "
                                f"checkpoint needs {nbytes / 1e9:.2f} GB and twice that is "
                                f"asked for")

    def checked(run, row, it, trains=True):
        m = row["metrics"]
        want = per_iter if trains else {n: per_iter[n] - step.get(n, 0) for n in per_iter}
        require(row["launches"] == want, f"{label} {run} iteration {it}: launches "
                                         f"{row['launches']}, expected {want}")
        require(all(np.isfinite(v) for v in m.values()),
                f"{label} {run} iteration {it}: non-finite metric {m}")
        require(("actor/loss" in m) == trains, f"{label} {run} iteration {it}: trains "
                                               f"{'actor/loss' in m}")
        if trains:
            require(abs(m["actor/ratio_mean"] - 1.0) <= RATIO_TOL,
                    f"{label} {run} iteration {it}: ratio_mean {m['actor/ratio_mean']}")
            require(m["actor/grad_norm"] > 0, f"{label} {run} iteration {it}: zero gradient")
            require(it == 0 or m["actor/kl"] > 0, f"{label} {run} iteration {it}: KL "
                                                   f"{m['actor/kl']}, the weights did not move")

    base = ["--experiment", str(exp_path), "--device", DEV]
    runs = {"A": base + ["--iters", str(CKPT_ITERS), "--ckpt-dir", str(ckpt), "--ckpt-every",
                         str(CKPT_ITERS), "--obs-trace", str(trace), "--obs-metrics",
                         str(jsonl)],
            "B": base + ["--iters", str(CKPT_RESUMED_ITERS), "--resume", str(ckpt)],
            "C": base + ["--iters", str(CKPT_RESUMED_ITERS), "--resume", str(ckpt),
                         "--max-staleness", "1"]}
    counts, out = {}, {"state_gb": nbytes / 1e9, "free_gb": free / 1e9}
    saved = None
    try:
        with rss_sampled() as rss:
            for run, argv in runs.items():
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                _build.reset_launches()
                hold = (lambda: held_to_plain(torch, ops, ref, names)) if run == "A" else None
                prev = get_tracer()
                with contextlib.ExitStack() as stack:
                    seen = stack.enter_context(observed_iterations(torch, _build, hold))
                    ckpt_io = stack.enter_context(observed_checkpoints(torch))
                    # run C's first dispatch (the bit checksums are not timed
                    # iterations' work anywhere else)
                    first = (stack.enter_context(observed_first_generation(torch))
                             if run == "C" else None)
                    try:
                        res = train.main(argv)
                    finally:
                        set_tracer(prev)  # run A installed its tracer
                counts[run] = dict(_build.LAUNCHES)
                pipe, rows = res["pipeline"], seen["iterations"]
                state = pipe.ctx.actor_state
                peak = torch.cuda.max_memory_allocated() / 2**30
                if run == "A":
                    require(len(rows) == CKPT_ITERS, f"{label} A: {len(rows)} iterations")
                    held = seen["held"]
                    require(all(held[n]["calls"] == per_iter[n] for n in names),
                            f"{label} A held to plain: calls {held}, expected {per_iter}")
                    print(json.dumps({"check": f"{label}_iteration_held_to_plain",
                                      "kernels": held}), flush=True)
                    for it, row in enumerate(rows):
                        checked(run, row, it)
                    (sv,) = ckpt_io["save"]
                    saved = {"params": bit_checksum(torch, state.params),
                             "opt": bit_checksum(torch, state.opt)}
                    records = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
                    require([r["metrics"] for r in records]
                            == [{k: float(v) for k, v in m.items()} for m in res["history"]]
                            and [r["iteration"] for r in records] == list(range(CKPT_ITERS)),
                            f"{label} A: the JSONL records {records}")
                    events = json.loads(trace.read_text())["traceEvents"]
                    spans = [e["name"] for e in events if e["ph"] == "X"]
                    missing = {n: spans.count(f"node/{n}") for n in pipe.plan.order
                               if spans.count(f"node/{n}") != CKPT_ITERS}
                    require(not missing, f"{label} A: node spans {missing} in the trace, "
                                         f"{CKPT_ITERS} of each expected")
                    step_hist = pipe.ctx.obs.registry.histograms["train/step_s"]
                    require(step_hist.count == CKPT_ITERS,
                            f"{label} A: train/step_s counted {step_hist.count}")
                    out["A"] = {
                        "iteration_ms": [r["ms"] for r in rows],
                        "timed_iteration_ms": rows[-1]["ms"],
                        "phase8_distributed_iteration_ms": pipeline_ms,
                        "save_s": sv["s"], "save_gb": sv["file_bytes"] / 1e9,
                        "save_gb_per_s": sv["file_bytes"] / 1e9 / sv["s"],
                        "state_gb": sv["state_bytes"] / 1e9, "trace_events": len(events),
                        "jsonl_records": len(records), "peak_gib": peak}
                else:
                    (rs,) = ckpt_io["restore"]
                    require(len(rows) == CKPT_RESUMED_ITERS - CKPT_ITERS,
                            f"{label} {run}: {len(rows)} iterations")
                    require(rs["step"] == CKPT_ITERS and rs["checksum"] == saved
                            and rs["same_storage"],
                            f"{label} {run}: restored step {rs['step']}, checksums equal "
                            f"{rs['checksum'] == saved}, same storage {rs['same_storage']}")
                    checked(run, rows[0], CKPT_ITERS, trains=run == "B")
                    if run == "B":
                        require(int(state.opt.step) == CKPT_RESUMED_ITERS,
                                f"{label} B: AdamW step {int(state.opt.step)}")
                    else:
                        require(first["published"] == saved["params"]
                                and first["generated"] == saved["params"],
                                f"{label} C: the first dispatch did not run the restored "
                                f"weights")
                        print(json.dumps({"check": f"{label}_C_first_dispatch_restored",
                                          "leaves": len(saved["params"])}), flush=True)
                    out[run] = {"restore_s": rs["s"], "restore_gb": rs["file_bytes"] / 1e9,
                                "restore_gb_per_s": rs["file_bytes"] / 1e9 / rs["s"],
                                "iteration_ms": rows[0]["ms"],
                                "adamw_step": int(state.opt.step), "peak_gib": peak}
                print(json.dumps({f"{label}_run": {"run": run, **out[run],
                                                   "launches": counts[run]}}), flush=True)
                del res, pipe, state, seen, ckpt_io, first
        out["host_rss_gib"] = {"phase_start": rss["start_gib"], "peak": rss["peak_gib"]}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: out}), flush=True)
    return {"ckpt_train": counts["A"], "ckpt_resume": counts["B"],
            "ckpt_resume_async": counts["C"]}


# phase 16: the data-parallel fleet, each host its own process on the card,
# at gemma-2b's full width on FLEET_LAYERS of its 18 layers (two full-depth
# hosts, 49.42 GiB each, do not fit one card)
FLEET_LAYERS = 2
FLEET_ITERS = 3  # one warm-up iteration, then two timed
FLEET_ARMS = {"solo": (1, None), "exact": (2, "none"), "int8_ef": (2, "int8_ef")}
FLEET_HOST_TIMEOUT_S = 600
LOSS_TOL_INT8 = 5e-3  # tests/test_fleet.py's bound on the last loss against the exact arm
SOLO_PARAMS = ROOT / "build" / "fleet16" / "solo" / "final_params.pt"


def fleet_host(torch, args_path: str) -> int:
    """The body of ``chip_smoke.py --fleet-host ARGS``: one host of a fleet
    arm (or the solo run) through ``launch.train.main`` on the card. ARGS is
    a json file: {"argv", "artifact", "check_int8"}. The launch counters
    start at 0 in the fresh process and are read after the run; each
    iteration is synchronised and timed (``observed_iterations``), and so is
    each gradient exchange as a whole. With ``check_int8``, in the warm-up
    iteration (not timed): the first encode of an owned gradient slice on
    the card, and an encode of the same slice with its residual as the
    error-feedback term, are held bit for bit to the same encodes on the CPU
    (``encode_check``); and the first exchange's rebuilt gradient is held to
    the exact gradient it was rebuilt from, block by block of each slice,
    within ``max |g_block| / 126``, or within ``max |g_block|`` where the
    block's scale is under the quantizer's floor (``decode_check``: the
    card's decode and where each slice lands). That host's peak device
    memory is read from its second exchange on (the third iteration whole),
    since the check holds the exact and the rebuilt gradient at once.
    Writes the artifact: a bit checksum of the final params,
    every iteration's metrics, ms and launches, the exchange's ms and stats,
    both checks, the membership view, the buffer's controller bytes, the
    peak device memory and the peak host RSS (sampled by ``rss_sampled``:
    ``ru_maxrss`` would carry the parent's across the fork and exec)."""
    from repro_torch import tree
    from repro_torch.distributed import compression
    from repro_torch.distributed import fleet as fleet_mod
    from repro_torch.kernels import _build
    from repro_torch.launch import train

    spec = json.loads(Path(args_path).read_text())
    exchange_ms, encodes, decodes = [], [], []
    GX = fleet_mod.GradExchange
    saved = (GX.__call__, compression.encode)
    call, encode = saved

    def jax_leaves(t):
        """The leaves of ``t`` in the exchange's order (JAX's: dict keys
        sorted), without the empty ``None`` subtrees."""
        leaves = tree.leaves(t)
        return [leaves[i] for i in tree.jax_order(t) if leaves[i] is not None]

    def block_max(x):
        """max |x| over each quantization block of a slice (the last block
        may be short, as in ``compression.encode``)."""
        full = x.numel() // compression.BLOCK * compression.BLOCK
        parts = [x[:full].view(-1, compression.BLOCK).abs().amax(dim=1)]
        if full < x.numel():
            parts.append(x[full:].abs().amax().reshape(1))
        return torch.cat(parts)

    def check_decode(grads, out, num_hosts):
        """Every block of every slice of the rebuilt gradient within
        max |g_block| / 126 of the exact gradient, and a block whose scale
        falls under ``compression.SCALE_FLOOR`` within its max; the largest
        |rebuilt - exact| / max |g_block| over the blocks above the floor."""
        err = torch.cat([g.detach().reshape(-1).to(torch.float32) for g in jax_leaves(grads)])
        base, extra = divmod(err.numel(), num_hosts)
        bounds, lo = [], 0
        for i in range(num_hosts):
            bounds.append((lo, lo + base + (1 if i < extra else 0)))
            lo = bounds[-1][1]
        gmax = torch.cat([block_max(err[lo:hi]) for lo, hi in bounds])
        pos = 0
        for leaf in jax_leaves(out):
            err[pos:pos + leaf.numel()] -= leaf.reshape(-1).to(torch.float32)
            pos += leaf.numel()
        dmax = torch.cat([block_max(err[lo:hi]) for lo, hi in bounds])
        floored = gmax / torch.tensor(127.0, device=gmax.device) < compression.SCALE_FLOOR
        within = torch.where(floored, dmax <= gmax, dmax <= gmax / 126)
        ratio = torch.where(floored, 0.0, dmax / gmax.clamp(min=torch.finfo(torch.float32).tiny))
        return {"blocks": gmax.numel(), "blocks_under_floor": int(floored.sum()),
                "within": bool(within.all()), "max_err_over_block_max": float(ratio.max())}

    def timed_exchange(self, grads):
        if decodes and len(exchange_ms) == 1:
            # the check held the exact and the rebuilt gradient at once
            torch.cuda.reset_peak_memory_stats()
        (out, metrics), ms = sync_ms(torch, lambda: call(self, grads))
        exchange_ms.append(ms)
        if spec["check_int8"] and not decodes:
            decodes.append(check_decode(grads, out, self.fleet.num_hosts))
        return out, metrics

    def checked_encode(x, error=None):
        out = encode(x, error)
        if spec["check_int8"] and x.is_cuda and not encodes:
            for err in (None, out[2]):
                got = [t.cpu() for t in (out if err is None else encode(x, err))]
                want = encode(x.cpu(), None if err is None else err.cpu())
                encodes.append({
                    "elements": x.numel(), "with_error": err is not None,
                    "equal": all(torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                                             w.view(torch.int32) if w.is_floating_point() else w)
                                 for g, w in zip(got, want))})
        return out

    GX.__call__, compression.encode = timed_exchange, checked_encode
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        with rss_sampled() as rss, observed_iterations(torch, _build) as seen:
            res = train.main(spec["argv"])
    finally:
        GX.__call__, compression.encode = saved
    pipe = res["pipeline"]
    fleet_ctx, exchange = pipe.ctx.fleet, pipe.ctx.grad_exchange
    art = {
        "params": sum(x.numel() for x in tree.leaves(pipe.ctx.actor_state.params)),
        "checksum": bit_checksum(torch, pipe.ctx.actor_state.params),
        "history": [{k: float(v) for k, v in m.items()} for m in res["history"]],
        "seconds": res["seconds"],
        "iterations": [{"ms": r["ms"], "launches": r["launches"]} for r in seen["iterations"]],
        "exchange_ms": exchange_ms,
        "encode_check": encodes,
        "decode_check": decodes,
        "stats": dict(exchange.stats) if exchange is not None else None,
        "members": fleet_ctx.members if fleet_ctx is not None else [0],
        "epoch": fleet_ctx.epoch if fleet_ctx is not None else 0,
        "bytes_through_controller": pipe.buffer.stats.bytes_through_controller,
        "launches": dict(_build.LAUNCHES),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "peak_rss_gib": rss["peak_gib"],
    }
    if spec.get("save_params"):
        # the solo run's final params, which phase 17's data-parallel run is
        # held against
        torch.save([t.cpu() for t in tree.leaves(pipe.ctx.actor_state.params)],
                   spec["save_params"])
    Path(spec["artifact"]).write_text(json.dumps(art))
    return 0


# host and rank processes started ahead of the arm that takes them
# (``chip_smoke.py --pooled``): each has imported torch and the port and made
# its CUDA context while the arm before it ran (seconds of a fresh process's
# start); POOL_SIZE are kept waiting from phase 15 on
POOL_SIZE = 2
_POOL: list = []


def pool_fill() -> None:
    """Start pooled processes until POOL_SIZE wait (their output, until they
    take an arm, to ``build/pool.log``)."""
    import atexit

    if not _POOL:
        atexit.register(pool_stop)
    (ROOT / "build").mkdir(exist_ok=True)
    while len(_POOL) < POOL_SIZE:
        with open(ROOT / "build" / "pool.log", "ab") as f:
            _POOL.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--pooled"],
                stdin=subprocess.PIPE, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT))


def pool_stop() -> None:
    """End the pooled processes that took no arm."""
    while _POOL:
        proc = _POOL.pop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def host_process(mode: str, args_path, log):
    """A process running ``chip_smoke.py <mode> <args_path>`` into ``log``: a
    pooled one where one waits, else a new one."""
    while _POOL:
        proc = _POOL.pop(0)
        if proc.poll() is None:
            proc.stdin.write(f"{mode}\n{args_path}\n{log}\n".encode())
            proc.stdin.close()
            return proc
    with open(log, "wb") as f:
        return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), mode,
                                 str(args_path)], stdout=f, stderr=subprocess.STDOUT, cwd=ROOT)


def pooled(torch) -> int:
    """The body of ``chip_smoke.py --pooled``: the port imported and a CUDA
    context made, wait for "mode, ARGS, log" on stdin (``host_process``),
    then write to the log and run that host or rank (``fleet_host``,
    ``shard_rank``, ``tp_rank`` or ``tp22_rank``). Exits 0 where stdin closes first."""
    import torch.distributed  # noqa: F401  (what every rank imports, ahead)

    from repro_torch.launch import train  # noqa: F401

    x = torch.ones((64, 64), device=DEV)
    (x @ x).sum().item()
    words = [sys.stdin.readline().strip() for _ in range(3)]
    if not all(words):
        return 0
    mode, args_path, log = words
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    body = {"--fleet-host": fleet_host, "--shard-rank": shard_rank, "--tp-rank": tp_rank,
            "--tp22-rank": tp22_rank}[mode]
    return body(torch, args_path)


def run_hosts(label: str, arm: str, host_args, mode: str = "--fleet-host",
              refill: bool = True) -> list:
    """Start one ``chip_smoke.py --fleet-host`` (or ``mode``) process a host,
    all at once (pooled ones first, ``host_process``), and join them; once
    they run, start the pool's next processes (unless not ``refill``: the
    last phase's). A host that exits non-zero
    (or outlives FLEET_HOST_TIMEOUT_S) fails the arm with the tail of its
    log; the others are killed. Returns the hosts' artifacts."""
    procs = []
    try:
        pooling = bool(_POOL)
        for args_path, log in host_args:
            procs.append(host_process(mode, args_path, log))
        if pooling and refill:
            pool_fill()
        deadline = time.monotonic() + FLEET_HOST_TIMEOUT_S
        for h, (proc, (_, log)) in enumerate(zip(procs, host_args)):
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                tail = "".join(Path(log).read_text(errors="replace").splitlines(True)[-40:])
                raise AssertionError(f"{label} {arm}: host {h} exited {rc}\n{tail}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [json.loads(Path(json.loads(Path(a).read_text())["artifact"]).read_text())
            for a, _ in host_args]


def fleet_phase(torch, _build, label="fleet"):
    """Phase 16: the data-parallel fleet through ``launch.train`` on phase
    8's experiment file at FLEET_LAYERS layers (gemma-2b's full width), in
    three arms one after another, each host a process of its own on the
    card (``fleet_host``), FLEET_ITERS iterations each:

    - solo: ``--num-hosts 1``;
    - exact: 2 hosts, ``--grad-compression none``, with ``--obs-trace`` and
      ``--obs-metrics``: both hosts' params bit for bit the solo run's,
      every metric equal to the solo run's but the ``fleet/`` and ``time/``
      keys, a nonzero gradient at every iteration, 3 exchanges of exactly
      4 P bytes on the wire, no byte through a controller, members [0, 1]
      at epoch 0, ``dag`` and ``fleet`` spans in each host's trace, and the
      straggler report over the published snapshots listing both hosts;
    - int8_ef: 2 hosts: bit for bit each other, not the exact arm's params,
      the last loss within LOSS_TOL_INT8 of the exact arm's, the wire equal
      to ``compression.wire_bytes`` of the two slices and under 0.3 of the
      exact bytes, host 0's encode on the card bit for bit the CPU's, and
      host 0's first rebuilt gradient within max |g_block| / 126 of the
      exact one in every block of every slice (within max |g_block| under
      the quantizer's scale floor).

    Every host's launches equal the solo run's, and each of the solo run's
    iterations launches ``iteration_launches``. The free space under
    ``build/`` must hold twice the exact arm's payloads (3 exchanges of 4 P
    bytes are kept until the arm ends); each coordinator directory is
    removed after its arm. Prints per arm and host the iteration and
    exchange ms, the wire GB and GB/s of an exchange, the peak device GiB
    and the peak host RSS, then ``phase_s``. Returns {path: launch
    counts}."""
    import shutil
    import statistics as stats

    from repro_torch import tree
    from repro_torch.api import ExperimentSpec
    from repro_torch.distributed import compression
    from repro_torch.models import lm
    from repro_torch.obs.aggregate import collect_snapshots, straggler_report
    from repro_torch.rl import algorithms

    t_phase = time.perf_counter()
    src = experiment_file("pipeline", ARCH_FLAGS, PIPE_RL)
    spec = json.loads(src.read_text())
    spec["model"]["num_layers"] = FLEET_LAYERS
    # one host in the file (the flags layer the fleet over it); a peer's
    # first iteration on a shared card is slow, not dead
    spec["distributed"] = {"num_hosts": 1, "exchange_timeout_s": 600.0, "dead_after_s": 120.0}
    exp_path = ROOT / "build" / "fleet_experiment.json"
    exp_path.write_text(json.dumps(spec))
    exp = ExperimentSpec.from_json(exp_path.read_text())
    cfg = exp.model
    per_iter, _ = iteration_launches(cfg, _build.LAUNCHES, exp.rl.max_new_tokens,
                                     algorithms.get_algorithm(exp.rl.algorithm).dag_factory())
    P = sum(x.numel() for x in tree.leaves(lm.init(cfg, torch.Generator(), device="meta")))
    work = ROOT / "build" / "fleet16"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    kept = FLEET_ITERS * 4 * P
    free = shutil.disk_usage(work).free
    require(free >= 2 * kept, f"{label}: {free / 1e9:.2f} GB free under build/, the exact "
                              f"arm keeps {kept / 1e9:.2f} GB of payloads and twice that is "
                              f"asked for")
    base = ["--experiment", str(exp_path), "--device", DEV, "--iters", str(FLEET_ITERS)]
    arts, counts, out = {}, {}, {"params": P, "layers": FLEET_LAYERS, "free_gb": free / 1e9}
    for arm, (hosts, mode) in FLEET_ARMS.items():
        d = work / arm
        coord = d / "coord"
        d.mkdir()
        host_args = []
        for h in range(hosts):
            argv = base + ["--num-hosts", str(hosts)]
            if hosts > 1:
                argv += ["--process-id", str(h), "--coordinator", str(coord),
                         "--grad-compression", mode]
            if arm == "exact":
                argv += ["--obs-trace", str(d / f"trace.host{h}.json"),
                         "--obs-metrics", str(d / f"metrics.host{h}.jsonl")]
            args_path = d / f"host{h}.args.json"
            args_path.write_text(json.dumps({
                "argv": argv, "artifact": str(d / f"host{h}.artifact.json"),
                "check_int8": arm == "int8_ef" and h == 0,
                "save_params": str(SOLO_PARAMS) if arm == "solo" else None}))
            host_args.append((args_path, d / f"host{h}.log"))
        t_arm = time.perf_counter()
        try:
            arts[arm] = run_hosts(label, arm, host_args)
            if arm == "exact":
                report = straggler_report(collect_snapshots(str(coord)))
                require(report["hosts"] == [0, 1], f"{label} exact: the straggler report "
                                                   f"lists hosts {report['hosts']}")
                spans = []
                for h in range(hosts):
                    events = json.loads((d / f"trace.host{h}.json").read_text())["traceEvents"]
                    cats = {e["cat"] for e in events if e["ph"] == "X"}
                    require({"dag", "fleet"} <= cats, f"{label} exact host {h}: span "
                                                      f"categories {cats}")
                    spans.append([e["dur"] / 1e3 for e in events
                                  if e["name"] == "fleet/grad_exchange"])
                out["exact_exchange_span_ms"] = spans
        finally:
            shutil.rmtree(coord, ignore_errors=True)
        for h, a in enumerate(arts[arm]):
            timed = [r["ms"] for r in a["iterations"][1:]]
            row = {"arm": arm, "host": h, "params": a["params"],
                   "iteration_ms": [r["ms"] for r in a["iterations"]],
                   "timed_iteration_ms": stats.median(timed),
                   "peak_gib": a["peak_gib"], "peak_rss_gib": a["peak_rss_gib"]}
            if a["stats"] is not None:
                xms = stats.median(a["exchange_ms"][1:])
                wire = a["stats"]["wire_bytes"] / a["stats"]["exchanges"]
                row.update({"exchange_ms": a["exchange_ms"], "timed_exchange_ms": xms,
                            "exchange_share": xms / row["timed_iteration_ms"],
                            "wire_gb_per_exchange": wire / 1e9,
                            "wire_gb_per_s": wire / 1e9 / (xms / 1e3)})
            if a["encode_check"]:
                row["encode_check"] = a["encode_check"]
                row["decode_check"] = a["decode_check"]
            counts[f"fleet_{arm}" if hosts == 1 else f"fleet_{arm}_host{h}"] = a["launches"]
            print(json.dumps({f"{label}_arm": row}), flush=True)
        out[arm] = {"arm_s": time.perf_counter() - t_arm,
                    "peak_gib_hosts": sum(a["peak_gib"] for a in arts[arm]),
                    "peak_rss_gib_hosts": [a["peak_rss_gib"] for a in arts[arm]]}

    def clean(history):
        return [{k: v for k, v in m.items() if "fleet/" not in k and not k.startswith("time/")}
                for m in history]

    (solo,) = arts["solo"]
    require(solo["params"] == P, f"{label}: {solo['params']} params, {P} expected")
    require(all(r["launches"] == per_iter for r in solo["iterations"]),
            f"{label} solo: launches {[r['launches'] for r in solo['iterations']]}, "
            f"expected {per_iter} an iteration")
    for arm in ("exact", "int8_ef"):
        for h, a in enumerate(arts[arm]):
            require(a["launches"] == solo["launches"],
                    f"{label} {arm} host {h}: launches {a['launches']}, the solo run's "
                    f"{solo['launches']}")
            require(a["members"] == [0, 1] and a["epoch"] == 0,
                    f"{label} {arm} host {h}: members {a['members']} at epoch {a['epoch']}")
            require(a["bytes_through_controller"] == 0,
                    f"{label} {arm} host {h}: {a['bytes_through_controller']} bytes through "
                    f"a controller")
            require(a["stats"]["exchanges"] == FLEET_ITERS,
                    f"{label} {arm} host {h}: {a['stats']['exchanges']} exchanges")
    for h, a in enumerate(arts["exact"]):
        require(a["checksum"] == solo["checksum"],
                f"{label} exact host {h}: params differ from the solo run's")
        require(clean(a["history"]) == clean(solo["history"]),
                f"{label} exact host {h}: metrics differ from the solo run's")
        require(all(m["actor/grad_norm"] > 0 for m in a["history"]),
                f"{label} exact host {h}: a zero gradient")
        st = a["stats"]
        require(st["wire_bytes"] == st["exact_bytes"] == FLEET_ITERS * 4 * P,
                f"{label} exact host {h}: wire {st['wire_bytes']}, exact {st['exact_bytes']}, "
                f"{FLEET_ITERS} x 4 x {P} expected")
    c0, c1 = arts["int8_ef"]
    require(c0["checksum"] == c1["checksum"] and clean(c0["history"]) == clean(c1["history"]),
            f"{label} int8_ef: the hosts differ from each other")
    require(c0["checksum"] != arts["exact"][0]["checksum"],
            f"{label} int8_ef: params equal the exact arm's")
    loss_gap = abs(c0["history"][-1]["actor/loss"] - arts["exact"][0]["history"][-1]["actor/loss"])
    require(loss_gap < LOSS_TOL_INT8, f"{label} int8_ef: last loss {loss_gap} from the exact "
                                      f"arm's")
    sizes = [P // 2 + P % 2, P // 2]
    want_wire = FLEET_ITERS * sum(compression.wire_bytes(torch.empty(n, device="meta"))[1]
                                  for n in sizes)
    for h, a in enumerate(arts["int8_ef"]):
        st = a["stats"]
        require(st["wire_bytes"] == want_wire and st["wire_bytes"] < 0.3 * st["exact_bytes"],
                f"{label} int8_ef host {h}: wire {st['wire_bytes']}, {want_wire} expected, "
                f"exact {st['exact_bytes']}")
    enc = c0["encode_check"]
    require([e["with_error"] for e in enc] == [False, True] and all(e["equal"] for e in enc),
            f"{label} int8_ef: the encode on the card differs from the CPU's: {enc}")
    print(json.dumps({"check": f"{label}_encode_on_card_equals_cpu", "encodes": enc}),
          flush=True)
    dec = c0["decode_check"]
    require(len(dec) == 1 and dec[0]["within"],
            f"{label} int8_ef: host 0's rebuilt gradient is not within its block bound of "
            f"the exact gradient in every block: {dec}")
    print(json.dumps({"check": f"{label}_int8_rebuilt_gradient_within_block_bound",
                      "decode": dec[0]}), flush=True)
    out["int8_ef_last_loss_gap"] = loss_gap
    out["int8_ef_wire_ratio"] = c0["stats"]["wire_bytes"] / c0["stats"]["exact_bytes"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: out}), flush=True)
    return counts


# phase 17: the sharding layer over torch.distributed, two ranks on the card
# in one gloo group (NCCL refuses two ranks on one device): data-parallel
# GRPO through launch.train on phase 16's experiment file, the train -> serve
# switch of its final params, and deepseek-67b's sequence-sharded decode
SHARD_RANKS = 2
SHARD_ITERS = FLEET_ITERS  # one warm-up iteration, then two timed
# deepseek-67b's decode widths (configs/deepseek_67b.py): 64 query heads on 8
# KV heads of 128; a 32,768-slot cache split over the ranks, 8 rows, bf16
DS_HEADS, DS_KV_HEADS, DS_HEAD_DIM, DS_SLOTS, DS_B = 64, 8, 128, 32_768, 8
DECODE_REPS = 5
# the sharded decode's o against the one-rank kernel's and the plain
# version's, absolute: a few times the plain version's own readings (4.88e-4
# from the sharded decode, PR 27's final run), far under the scale of o
# itself (max |o| is printed beside it, and so is the error of two planted
# faults the hold must reject: an all-zero o, and a merge that averages the
# shards' o without their lse weights); lse absolute LSE_TOL
DS_O_TOL = 2e-3
# the data-parallel run against the solo run of phase 16 from the same init:
# the update directions agree (cosine of the two displacements), the runs lie
# close (their distance over the solo run's displacement), and each
# iteration's actor/grad_norm and actor/loss agree to a relative
# SHARD_METRIC_RTOL. Set between the sound run's readings and those of two
# faults planted in the grads' reduce-scatter (--shard-faults; PERF.md)
SHARD_MIN_COSINE = 0.99
SHARD_MAX_REL_DISTANCE = 0.15
SHARD_METRIC_RTOL = 0.02
SHARD_METRICS = ("actor/grad_norm", "actor/loss")
# faults planted in the grads' reduce-scatter, for --shard-faults: each
# rank's own rows' grads, not summed over the ranks; the sum counted twice
# (what weight 1 for every rank's loss, not its token share, gives where the
# ranks hold equal token counts)
SHARD_FAULTS = ("unsummed", "scaled")


def shard_rank(torch, args_path: str) -> int:
    """The body of ``chip_smoke.py --shard-rank ARGS``: rank r of phase 17's
    two-rank world on the card. ARGS is a json file {"argv", "artifact",
    "rank", "solo_params", "fault"}.

    A: ``launch.train.main(argv)`` (``--coordinator 127.0.0.1:PORT``) inside
    ``observed_iterations``; the generation's train -> serve switch
    (``weight_sync.switch``, whose params the step reads too) and the step's
    reduce-scatter of the grads (``collectives.reduce_scatter``) are each
    synchronised, timed and their bytes counted, and any call of
    ``trainer.gather_params`` (a second all-gather) is recorded. The init
    params are kept as ``shard_state`` receives them, and rank 0 holds the
    final params (gathered) against ``solo_params``. With ``"fault"`` in
    ARGS (one of SHARD_FAULTS) the reduce-scatter is replaced by the planted
    fault and the rank stops after A. C: ``publish(mesh=, target_specs=)``
    of the final shards, timed, its received bytes beside ``switch_bytes``,
    its values bit for bit the gathered params. B: the sequence-sharded
    decode at deepseek-67b's decode widths, held against the one-rank kernel
    and the plain version on the whole cache, each part timed, with the
    plain version's drift from its fp32 self and two planted merge faults
    measured beside. Writes the artifact."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed import weight_sync
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.rl import trainer

    spec = json.loads(Path(args_path).read_text())
    rank = spec["rank"]
    coll = {"gather": [], "reduce": [], "switch": []}
    saved = (trainer.gather_params, collectives.reduce_scatter, weight_sync.switch,
             trainer.shard_state, collectives.all_gather)
    init = {}
    received = [0]

    def counted_gather(mesh, local, spec_, **kw):
        # bytes this rank receives: (n - 1) shards of each axis it gathers over
        out = saved[4](mesh, local, spec_, **kw)
        if mesh.torch_mesh is not None:
            received[0] += (out.numel() - local.numel()) * local.element_size()
        return out

    def timed(kind, fn):
        def run(*args, **kw):
            before = received[0]
            out, ms = sync_ms(torch, lambda: fn(*args, **kw))
            coll[kind].append({"ms": ms, "received_bytes": received[0] - before})
            return out
        return run

    def reduce(mesh, tensors, specs, axes=None):
        fault = spec.get("fault")
        if fault == "unsummed":
            return [collectives.shard(mesh, t.float(), s).clone() for t, s in zip(tensors, specs)]
        out = saved[1](mesh, tensors, specs, axes=axes)
        return [g * mesh.num_ranks for g in out] if fault == "scaled" else out

    def timed_reduce(mesh, tensors, specs, axes=None):
        out, ms = sync_ms(torch, lambda: reduce(mesh, tensors, specs, axes))
        coll["reduce"].append({"ms": ms, "buffer_bytes": 4 * sum(t.numel() for t in tensors)})
        return out

    def kept_init(mesh, params, specs):
        init["params"] = [t.detach().cpu() for t in tree.leaves(params)]
        return saved[3](mesh, params, specs)

    trainer.gather_params = timed("gather", saved[0])
    collectives.reduce_scatter = timed_reduce
    weight_sync.switch = timed("switch", saved[2])
    trainer.shard_state = kept_init
    collectives.all_gather = counted_gather
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        with rss_sampled() as rss, observed_iterations(torch, _build) as seen:
            res = train.main(spec["argv"])
    finally:
        (trainer.gather_params, collectives.reduce_scatter, weight_sync.switch,
         trainer.shard_state) = saved[:4]
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pipe = res["pipeline"]
    ctx, mesh = pipe.ctx, pipe.ctx.mesh
    final = trainer.gather_params(mesh, ctx.actor_state.params, ctx.param_specs)
    art = {"rank": rank, "mesh": mesh.shape, "coords": mesh.coords,
           "backend": dist.get_backend(),
           "params": sum(t.numel() for t in tree.leaves(final)),
           "history": [{k: float(v) for k, v in m.items()} for m in res["history"]],
           "iterations": [{"ms": r["ms"], "launches": r["launches"]} for r in seen["iterations"]],
           "collectives": coll, "launches": launches, "peak_gib": peak_gib,
           "peak_rss_gib": rss["peak_gib"], "stats": dataclasses.asdict(pipe.buffer.stats),
           "rows_loaded": int(ctx.dataloader.rows_loaded)}
    if rank == 0:
        solo = torch.load(spec["solo_params"])
        d_run = dot = n_solo = n_run = 0.0
        for p0, ps, pr in zip(init["params"], solo, tree.leaves(final)):
            p0, ps, pr = (t.to(DEV).float() for t in (p0, ps, pr.detach()))
            a, b = ps - p0, pr - p0
            d_run += float(torch.sum(torch.square(pr - ps)))
            n_solo += float(torch.sum(a * a))
            n_run += float(torch.sum(b * b))
            dot += float(torch.sum(a * b))
        art["vs_solo"] = {
            "cosine": dot / max((n_solo * n_run) ** 0.5, 1e-30),
            "rel_distance": (d_run / max(n_solo, 1e-30)) ** 0.5,
            "solo_displacement": n_solo ** 0.5, "run_displacement": n_run ** 0.5,
            "max_abs_diff": max(float((pr.detach().float() - ps.to(DEV).float()).abs().max())
                                for ps, pr in zip(solo, tree.leaves(final)))}
        del solo
    del init["params"]
    if spec.get("fault"):
        Path(spec["artifact"]).write_text(json.dumps(art))
        return 0
    # ---- C: the train -> serve switch of the final params, published ----
    from repro_torch.distributed.weight_sync import WeightVersionStore

    store = WeightVersionStore()
    received[0] = 0
    dist.barrier()  # rank 0's comparison above is not the publish's time
    pub, ms = sync_ms(torch, lambda: store.publish(
        ctx.actor_state.params, mesh=mesh, target_specs=ctx.serve_specs, specs=ctx.param_specs))
    shapes = tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), final)
    art["switch"] = {"ms": ms, "received_bytes": received[0], "version": pub.version,
                     "switch_bytes": weight_sync.switch_bytes(res["experiment"].model, mesh,
                                                              shapes)["recv_bytes_per_device"],
                     "bit_equal": bit_checksum(torch, pub.params) == bit_checksum(torch, final)}
    collectives.all_gather = saved[4]
    del pub, store, final, res, pipe, ctx
    gc.collect()
    torch.cuda.empty_cache()
    # ---- B: the sequence-sharded decode at deepseek-67b's decode widths ----
    m12 = make_local_mesh((1, SHARD_RANKS), ("data", "model"), device=DEV)
    g = torch.Generator(device=DEV).manual_seed(1717)
    q = torch.randn((DS_B, DS_HEADS, DS_HEAD_DIM), generator=g, device=DEV).to(torch.bfloat16)
    k, v = (torch.randn((DS_B, DS_SLOTS, DS_KV_HEADS, DS_HEAD_DIM), generator=g,
                        device=DEV).to(torch.bfloat16) for _ in range(2))
    shard_s = DS_SLOTS // SHARD_RANKS
    cl = torch.randint(1, DS_SLOTS + 1, (DS_B,), generator=g, device=DEV).to(torch.int32)
    cl[0] = shard_s // 3  # rank 1's slots hold no live key of row 0
    cl[1] = DS_SLOTS  # row 1 fills the cache
    ks, vs = (collectives.shard(m12, t, (None, "model")).contiguous() for t in (k, v))
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    o, lse = collectives.seq_sharded_decode_attention(m12, q, ks, vs, cl, return_lse=True)
    torch.cuda.synchronize()
    dec_launches = {n: _build.LAUNCHES[n] - before[n] for n in _build.LAUNCHES}
    o1, lse1 = ops.decode_attention(q, k, v, cl)
    o_ref, lse_ref = ref.decode_attention(q, k, v, cl)
    checks = {}

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    for name, (oo, ll) in {"one_rank_kernel": (o1, lse1), "plain": (o_ref, lse_ref)}.items():
        err_o, err_l = max_err(o, oo), max_err(lse, ll)
        checks[name] = {"o_ok": err_o <= DS_O_TOL, "o_max_abs_err": err_o,
                        "lse_ok": err_l <= LSE_TOL, "lse_max_abs_err": err_l}
    o_fp32, _ = ref.decode_attention(q.float(), k.float(), v.float(), cl)
    scale = {"o_max_abs": float(o_ref.float().abs().max()),
             "plain_drift_from_fp32": max_err(o_ref, o_fp32)}
    del o_fp32
    eff = torch.clamp(cl - m12.coords["model"] * shard_s, 0, shard_s).to(torch.int32)
    kernel_ms = device_ms(lambda: ops.decode_attention(q, ks, vs, eff))
    o_p, lse_p = ops.decode_attention(q, ks, vs, eff)
    gather_ms = []
    for _ in range(DECODE_REPS):
        (o_all, lse_all), t = sync_ms(torch, lambda: (
            collectives.all_gather(m12, o_p[None], ("model",)),
            collectives.all_gather(m12, lse_p[None], ("model",))))
        gather_ms.append(t)
    merge_ms = device_ms(lambda: ops.combine_decode_shards(o_all, lse_all, return_lse=True))
    whole_ms = device_ms(lambda: ops.decode_attention(q, k, v, cl))
    # the yardsticks of the same (o, lse) work: the plain version, and one
    # SDPA call (o only) with the lengths as a mask, at a rank's slots and at
    # the whole cache
    import torch.nn.functional as F

    def sdpa_call(kk, vv, lens):
        mask = (torch.arange(kk.shape[1], device=DEV)[None, :] < lens[:, None])[:, None, None]
        qt, kt, vt = q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

    yardsticks = {"shard_plain_ms": device_ms(lambda: ref.decode_attention(q, ks, vs, eff)),
                  "shard_sdpa_ms": device_ms(sdpa_call(ks, vs, eff)),
                  "whole_plain_ms": device_ms(lambda: ref.decode_attention(q, k, v, cl)),
                  "whole_sdpa_ms": device_ms(sdpa_call(k, v, cl))}
    # what the o hold must reject: no output at all, and the shards' o
    # averaged without their lse weights
    faults = {"zero_o": max_err(torch.zeros_like(o_ref), o_ref),
              "unweighted_merge": max_err(o_all.float().mean(0), o_ref)}
    art["decode"] = {"launches": dec_launches, "checks": checks, "o_tol": DS_O_TOL,
                     "lse_tol": LSE_TOL, **scale, "fault_errs": faults,
                     "rows_cache_len": cl.tolist(), "shard_slots": shard_s,
                     "rank1_empty_rows": int((cl <= shard_s).sum()),
                     "kernel_ms": kernel_ms, "gather_ms": statistics.median(gather_ms),
                     "merge_ms": merge_ms, "one_rank_whole_cache_ms": whole_ms, **yardsticks}
    Path(spec["artifact"]).write_text(json.dumps(art))
    return 0


def sharding_phase(torch, _build, label="shard", faults=(), keep_solo=False):
    """Phase 17: the sharding layer over ``torch.distributed`` with two
    ranks on the card in a gloo group, each rank a ``chip_smoke.py
    --shard-rank`` process (``shard_rank``) of ``launch.train --coordinator
    127.0.0.1:PORT --num-hosts 2 --process-id r`` on phase 16's experiment
    file (gemma-2b at full width on FLEET_LAYERS layers, SHARD_ITERS
    iterations). Held:

    - A: every iteration of each rank launches ``iteration_launches`` (the
      solo run's count: launches do not depend on the rows a rank holds);
      both ranks print the same metrics; no byte through a controller and
      some redistributions; each rank read half of each step's rows; the
      step made no all-gather of its own (it reads the serve switch's
      params); against phase 16's solo run from the same init, each
      iteration's SHARD_METRICS within SHARD_METRIC_RTOL, and the final
      params' displacement: cosine at least SHARD_MIN_COSINE, distance at
      most SHARD_MAX_REL_DISTANCE of the solo displacement;
    - B: the sequence-sharded decode's o within DS_O_TOL and lse within
      LSE_TOL (both absolute) of the one-rank kernel on the whole cache and
      of the plain version, with a row that rank 1's slots do not reach and
      a row that fills the cache; one ``decode_attention`` launch a rank;
      both planted merge faults over DS_O_TOL;
    - C: the published serve-layout params bit for bit the gathered ones,
      the bytes each rank received equal to ``switch_bytes``' count.

    ``faults`` (names of SHARD_FAULTS) runs A again with each fault planted
    in the reduce-scatter, prints its readings and fails unless A's hold
    rejects it. Phase 16's solo params and history are read beside
    SOLO_PARAMS (its solo arm runs first when they are missing, as with
    ``--only-phase 17``) and removed after, unless ``keep_solo`` (phase 18
    reads them next). Prints per rank the iteration
    ms, the collectives' ms and bytes per step, the peak device GiB, the
    buffer stats, the decode and switch numbers, then ``phase_s``. Returns
    {path: launch counts}."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.rl import algorithms

    t_phase = time.perf_counter()
    work = ROOT / "build" / "shard17"
    work.mkdir(parents=True, exist_ok=True)
    exp_path, solo_history = ensure_solo(label, work)
    exp = ExperimentSpec.from_json(exp_path.read_text())
    per_iter, _ = iteration_launches(exp.model, _build.LAUNCHES, exp.rl.max_new_tokens,
                                     algorithms.get_algorithm(exp.rl.algorithm).dag_factory())
    import socket

    def world(name, fault=None):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        host_args = []
        for r in range(SHARD_RANKS):
            args = work / f"{name}{r}.args.json"
            args.write_text(json.dumps({
                "argv": ["--experiment", str(exp_path), "--device", DEV, "--iters",
                         str(SHARD_ITERS), "--num-hosts", str(SHARD_RANKS), "--process-id",
                         str(r), "--coordinator", f"127.0.0.1:{port}"],
                "artifact": str(work / f"{name}{r}.artifact.json"), "rank": r,
                "solo_params": str(SOLO_PARAMS), "fault": fault}))
            host_args.append((args, work / f"{name}{r}.log"))
        return run_hosts(label, name, host_args, mode="--shard-rank")

    def against_solo(arts):
        """A's hold on rank 0's readings: (held, readings)."""
        vs = dict(arts[0]["vs_solo"])
        vs["metric_rel_errs"] = {
            k: [abs(m[k] - s[k]) / max(abs(s[k]), 1e-30)
                for m, s in zip(arts[0]["history"], solo_history)] for k in SHARD_METRICS}
        held = (vs["cosine"] >= SHARD_MIN_COSINE and vs["rel_distance"] <= SHARD_MAX_REL_DISTANCE
                and all(e <= SHARD_METRIC_RTOL for es in vs["metric_rel_errs"].values()
                        for e in es))
        return held, vs

    try:
        arts = world("rank")
        fault_arts = {f: world(f"fault_{f}", f) for f in faults}
    finally:
        if not keep_solo:
            SOLO_PARAMS.unlink(missing_ok=True)
    counts, out = {}, {"layers": FLEET_LAYERS, "ranks": SHARD_RANKS}

    def clean(history):
        return [{k: v for k, v in m.items() if not k.startswith("time/")} for m in history]

    for r, a in enumerate(arts):
        require(a["backend"] == "gloo" and a["mesh"] == {"pod": 2, "data": 1, "model": 1}
                and a["coords"]["pod"] == r,
                f"{label} rank {r}: backend {a['backend']}, mesh {a['mesh']}, {a['coords']}")
        require(all(it["launches"] == per_iter for it in a["iterations"]),
                f"{label} rank {r}: launches {[it['launches'] for it in a['iterations']]}, "
                f"expected {per_iter} an iteration")
        st = a["stats"]
        require(st["bytes_through_controller"] == 0 and st["redistributions"] > 0,
                f"{label} rank {r}: buffer stats {st}")
        require(not a["collectives"]["gather"],
                f"{label} rank {r}: the step all-gathered the params itself "
                f"({len(a['collectives']['gather'])} times) beside the serve switch")
        require(a["switch"]["bit_equal"] and a["switch"]["version"] == 0,
                f"{label} rank {r}: the published params differ from the gathered ones")
        require(a["switch"]["received_bytes"] == a["switch"]["switch_bytes"],
                f"{label} rank {r}: the switch received {a['switch']['received_bytes']} bytes, "
                f"switch_bytes counts {a['switch']['switch_bytes']}")
        dec = a["decode"]
        require(dec["launches"]["decode_attention"] == 1,
                f"{label} rank {r}: the sharded decode launched {dec['launches']}")
        for name, c in dec["checks"].items():
            require(c["o_ok"] and c["lse_ok"], f"{label} rank {r}: the sharded decode against "
                                               f"the {name}: {c}")
        require(all(e > DS_O_TOL for e in dec["fault_errs"].values()),
                f"{label} rank {r}: the o hold ({DS_O_TOL}) cannot see a planted merge fault: "
                f"{dec['fault_errs']}")
        # prompts and answers: this rank's half of the rows of every step
        require(a["rows_loaded"] == SHARD_ITERS * exp.prompts_per_iter,
                f"{label} rank {r}: {a['rows_loaded']} rows loaded")
        timed = [it["ms"] for it in a["iterations"][1:]]
        reduces = a["collectives"]["reduce"]
        switches = a["collectives"]["switch"]
        row = {"rank": r, "params": a["params"],
               "iteration_ms": [it["ms"] for it in a["iterations"]],
               "timed_iteration_ms": statistics.median(timed),
               "reduce_scatter_ms": [c["ms"] for c in reduces],
               "reduce_scatter_buffer_bytes_per_step": reduces[-1]["buffer_bytes"],
               "serve_switch_ms": [c["ms"] for c in switches],
               "serve_switch_bytes_per_step": switches[-1]["received_bytes"],
               "peak_gib": a["peak_gib"], "peak_rss_gib": a["peak_rss_gib"],
               "buffer_stats": st, "launches": a["launches"],
               "launches_implied": {n: SHARD_ITERS * c for n, c in per_iter.items()}}
        print(json.dumps({f"{label}_rank": row}), flush=True)
        print(json.dumps({f"{label}_decode": {"rank": r, **dec}}), flush=True)
        print(json.dumps({f"{label}_switch": {"rank": r, **a["switch"]}}), flush=True)
        counts[f"shard_grpo_rank{r}"] = a["launches"]
        counts[f"shard_decode_rank{r}"] = {n: dec["launches"].get(n, 0) for n in _build.LAUNCHES}
    require(clean(arts[0]["history"]) == clean(arts[1]["history"]),
            f"{label}: the ranks' metrics differ")
    require(all(m["actor/grad_norm"] > 0 for m in arts[0]["history"]), f"{label}: a zero gradient")
    limits = {"min_cosine": SHARD_MIN_COSINE, "max_rel_distance": SHARD_MAX_REL_DISTANCE,
              "metric_rtol": SHARD_METRIC_RTOL}
    held, vs = against_solo(arts)
    print(json.dumps({"check": f"{label}_against_the_solo_run", **vs, **limits}), flush=True)
    require(held, f"{label}: the data-parallel run against the solo run's: {vs}")
    for fault, fa in fault_arts.items():
        held, vs = against_solo(fa)
        print(json.dumps({"check": f"{label}_fault_{fault}_against_the_solo_run", "held": held,
                          **vs, **limits}), flush=True)
        require(not held, f"{label}: the hold does not reject the planted fault {fault}")
    out["solo_history"] = solo_history
    out["history"] = arts[0]["history"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: out}), flush=True)
    return counts


# ---- phase 18: tensor-parallel model stages ----
TP_RANKS = 2
TP_ITERS = FLEET_ITERS  # one warm-up iteration, then two timed
# holds of the (1, 2) run against phase 16's solo run (set between the sound
# run and the planted faults of --tp-faults; PERF.md). They are looser than
# phase 17's: the ranks sum the bf16 forward in another order, and Adam
# turns noise-level differences of the entropy bonus's gradient into
# whole-lr steps, so the trajectories part (on an H100 80GB HBM3 at 700 W:
# cosine 0.974, distance 0.232); the fixed batch's gradient is the tight hold
TP_MIN_COSINE = 0.95
TP_MAX_REL_DISTANCE = 0.35
TP_METRIC_RTOL = 0.3
# the leaves replicated over `model` (norms, gemma's K/V projections) end
# with the same bits on both ranks
TP_MAX_REPLICA_DIFF = 0.0
# the last rollout as an actor batch: every leaf's gradient on the ranks'
# shards, gathered, against one device's (relative L2, the worst leaf)
TP_MAX_GRAD_REL_ERR = 0.05
# faults planted for --tp-faults: the K/V projection's copy_to_model dropped
# (each rank's replicated w_k / w_v takes only its own query heads' share of
# the gradient), and the MLP's reduce_from_model dropped (each rank keeps its
# own d_ff columns' partial output)
TP_FAULTS = ("kv_copy", "mlp_reduce")
TP_SAMPLER_B = (8, 64)


def tp_sampler_phase(torch, ops, ref):
    """Phase 18 A: the vocab-sharded ``fused_sample`` kernel on TP_RANKS
    shards of gemma-2b's tied (256,000, 2,048) head at B = 8 and 64, and of
    qwen2.5-7b's untied (3,584, 152,064) head at B = 8: each shard's launch
    (``col_offset``, ``state=True``) merged in shard order
    (``ref.merge_sample_states``) against the one-device kernel on the same
    h and head, greedy and sampled rows, with two equal logits placed across
    the shard boundary in greedy row 0: the tokens bit for bit (row 0 the
    lower index), the logprobs within LOGPROB_TOL, and the shards' tokens
    against the plain version by ``check_sample``'s rule. The shard's kernel
    and the merge are timed (the gather is timed in B's ranks). Returns
    {case: record}."""
    from repro_torch.kernels import sampling

    gen = torch.Generator(device=DEV).manual_seed(1818)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(torch.bfloat16)

    out = {}
    for case, (d, V, tied) in {"gemma_tied": (D_MODEL, VOCAB, True),
                               "qwen_untied": (Q_D_MODEL, Q_VOCAB, False)}.items():
        w = randn(V, d, scale=0.02) if tied else randn(d, V, scale=d ** -0.5)
        n = V // TP_RANKS
        if tied:
            w[n] = w[n - 1]
            col = w[n - 1].float()
        else:
            w[:, n] = w[:, n - 1]
            col = w[:, n - 1].float()
        head = w.t() if tied else w
        shards = [(w[r * n:(r + 1) * n].t() if tied else w[:, r * n:(r + 1) * n].contiguous())
                  for r in range(TP_RANKS)]
        for Bs in TP_SAMPLER_B if tied else TP_SAMPLER_B[:1]:
            h = randn(Bs, d)
            h[0] = (col * (8.0 / col.norm())).to(torch.bfloat16)  # row 0's best: the tie
            seeds = torch.randint(-2**31, 2**31, (Bs,), generator=gen, device=DEV,
                                  dtype=torch.int64).to(torch.int32)
            it = torch.where(torch.arange(Bs, device=DEV) % 3 == 0, 0.0, 1.0 / 0.8)

            def sharded():
                states = []
                for r, sh in enumerate(shards):
                    f, i = sampling.fused_sample(h, sh, seeds, it, vocab_size=V,
                                                 col_offset=r * n, state=True)
                    states.append((f[:, 0], f[:, 1], f[:, 2], f[:, 3], i.long()))
                return ref.merge_sample_states(states)

            tok_s, lp_s = sharded()
            tok_1, lp_1 = ops.fused_sample(h, head, seeds, it, vocab_size=V)
            require(torch.equal(tok_s, tok_1),
                    f"tp sampler {case} B={Bs}: {tok_s.tolist()} vs one device {tok_1.tolist()}")
            require(int(tok_s[0]) == n - 1,
                    f"tp sampler {case} B={Bs}: the boundary tie took {int(tok_s[0])}, not {n - 1}")
            ok, err = close(lp_s, lp_1, LOGPROB_TOL)
            require(ok, f"tp sampler {case} B={Bs}: logprob max abs err {err}")
            plain_err = check_sample(torch, ref, (tok_s, lp_s), h, head, seeds, it, V,
                                     f"tp {case} B={Bs}")
            f0, i0 = sampling.fused_sample(h, shards[0], seeds, it, vocab_size=V, state=True)
            st = [(f0[:, 0], f0[:, 1], f0[:, 2], f0[:, 3], i0.long())] * TP_RANKS
            bms, by = bound_ms(n * d * 2 + Bs * d * 2 + Bs * 20, 2 * Bs * n * d,
                               BF16_TENSOR_FLOP_PER_S)
            rec = {"shape": {"h": [Bs, d], "head": list(head.shape), "shards": TP_RANKS,
                             "tied": tied},
                   "tokens_equal_one_device": True, "tie_token": int(tok_s[0]),
                   "max_abs_err": err, "plain_logprob_err": plain_err,
                   "shard_ms": device_ms(lambda: sampling.fused_sample(
                       h, shards[0], seeds, it, vocab_size=V, col_offset=0, state=True)),
                   "shard_bound_ms": bms, "shard_bound_by": by,
                   "merge_ms": device_ms(lambda: ref.merge_sample_states(st)),
                   "one_device_ms": device_ms(lambda: ops.fused_sample(h, head, seeds, it,
                                                                       vocab_size=V)),
                   "shard_library_ms": device_ms(lambda: torch.matmul(h, shards[0]))}
            out[f"{case}_b{Bs}"] = rec
            print(json.dumps({"check": f"tp_sampler/{case}/B{Bs}", **rec}), flush=True)
        del w, head, shards
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def observed_collectives(torch):
    """While open, every ``collectives.all_reduce`` and ``all_gather`` that
    moves data is synchronised, timed and its bytes counted, one record a
    ``run_iteration`` of either worker (as ``tp_rank`` counts them), but
    while ``"paused"`` is set. Yields {"iters": the records, "paused"}."""
    from repro_torch.core import async_worker as async_mod
    from repro_torch.core import worker as worker_mod
    from repro_torch.distributed import collectives

    rec = {"iters": [], "paused": False}
    iters = rec["iters"]
    saved = {"all_reduce": collectives.all_reduce, "all_gather": collectives.all_gather}
    workers = (worker_mod.DAGWorker, async_mod.AsyncDAGWorker)
    run_iterations = [cls.__dict__["run_iteration"] for cls in workers]

    def counted(kind):
        def run(mesh, x, *args, **kw):
            out, ms = sync_ms(torch, lambda: saved[kind](mesh, x, *args, **kw))
            if kind == "all_reduce":
                axes = kw.get("axes", args[0] if args else None)
                names = [a for a in mesh.axis_names if axes is None or a in axes]
                moved = any(mesh.shape[a] > 1 for a in names) * x.numel() * x.element_size()
            else:
                moved = (out.numel() - x.numel()) * x.element_size()
            if moved and iters and not rec["paused"]:
                c = iters[-1][kind]
                c["calls"] += 1
                c["ms"] += ms
                c["bytes"] += moved
            return out
        return run

    def opened(run_iteration):
        def run(self):
            iters.append({k: {"calls": 0, "ms": 0.0, "bytes": 0} for k in saved})
            return run_iteration(self)
        return run

    collectives.all_reduce, collectives.all_gather = counted("all_reduce"), counted("all_gather")
    for cls, run_iteration in zip(workers, run_iterations):
        cls.run_iteration = opened(run_iteration)
    try:
        yield rec
    finally:
        collectives.all_reduce, collectives.all_gather = saved["all_reduce"], saved["all_gather"]
        for cls, run_iteration in zip(workers, run_iterations):
            cls.run_iteration = run_iteration


def tp_rank(torch, args_path: str) -> int:
    """The body of ``chip_smoke.py --tp-rank ARGS``: rank r of phase 18's or
    phase 19's (data 1, model 2) world on the card (``tp_world``). ARGS is a
    json file {"argv", "artifact", "rank", "solo_params", "fault",
    "sampler"}.

    ``launch.train.main(argv)`` (``--coordinator 127.0.0.1:PORT``, the
    experiment file's ``mesh_shape`` [1, 2]) inside ``observed_iterations``;
    every collective (``collectives.all_reduce`` and ``all_gather``, which
    the region operators, the head's sums, the sampler's states and the
    sharded decode call) synchronised, timed and its bytes counted. The init
    params are kept as ``shard_state`` receives them. After the run: each
    rank's final params gathered (a leaf replicated over ``model`` from its
    own copy) against ``solo_params`` (cosine and distance of the
    displacements), the largest difference between the two ranks' copies of
    each replicated leaf, the last rollout's logprobs on the ranks' shards
    against the one-device model on the gathered params (with MoE layers,
    without the tokens whose route flips between the two), and with
    ``"sampler"`` the vocab-sharded sampler's kernel, gather and merge on
    the rank's own shard of the head. With ``"fault"`` (one of TP_FAULTS or
    TP19_FAULTS) the fault is planted for the run and the readings after
    it. Writes the artifact."""
    from repro_torch import tree
    from repro_torch.models import layers
    from repro_torch.rl import trainer

    spec = json.loads(Path(args_path).read_text())
    init = {}

    kept_shard_state = trainer.shard_state

    def kept_init(mesh, params, specs):
        init["params"] = [t.detach().cpu() for t in tree.leaves(params)]
        return kept_shard_state(mesh, params, specs)

    fault = spec.get("fault")
    from repro_torch.models import lm

    spec["quant"] = lm.quant_kv  # the int8 check's reference, whatever fault is planted
    observers = [(trainer, "shard_state", kept_init)]
    patches = []  # the fault, planted for the run and every reading after it
    if fault == "kv_copy":
        def local_kv(cfg, p, k, v):
            sl = layers.kv_heads_of(cfg, layers.local_heads(cfg, p))
            return k[..., sl, :], v[..., sl, :]
        patches.append((layers, "local_kv", local_kv))
    elif fault == "mlp_reduce":
        apply_mlp = layers.apply_mlp

        def unreduced_mlp(cfg, p, x):
            with patched(layers.tpc, "reduce_from_model", lambda y: y):
                return apply_mlp(cfg, p, x)
        patches.append((layers, "apply_mlp", unreduced_mlp))
    elif fault == "moe_gate_copy":
        from repro_torch.models import moe

        patches.append((moe, "combine_to_model", lambda combine: combine))
    elif fault == "ssd_norm_local":
        import torch.nn.functional as F

        from repro_torch.kernels import ops
        from repro_torch.models import ssm

        def local_gated_out(cfg, p, y, z):
            yz = y * F.silu(z)
            yn = ops.rmsnorm(yz.reshape(-1, yz.shape[-1]), p["norm_w"]).reshape(yz.shape)
            return ssm.tpc.reduce_from_model(yn @ p["w_out"])
        patches.append((ssm, "_gated_out", local_gated_out))
    elif fault in TP20_FAULTS:
        patches.append({"ring_rank_residue": (lm, "_tp_ring_slot", tp20_rank_residue),
                        "quant_before_gather": (lm, "quant_kv", tp20_quant_half)}[fault])
    elif fault in TP21_FAULTS:
        patches.append({"chunk_own_prefix": (lm, "_tp_gather_slots", tp21_own_prefix),
                        "chunk_write_everywhere": (lm, "_tp_chunk_span",
                                                   tp21_write_everywhere)}[fault])
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches + observers]
    for obj, name, value in patches + observers:
        setattr(obj, name, value)
    try:
        return tp_rank_body(torch, spec, originals[len(patches):], init)
    finally:
        for obj, name, value in originals:
            setattr(obj, name, value)


def tp_rank_body(torch, spec, observed, init) -> int:
    """``tp_rank`` with its patches in place: the run, then every reading,
    the observers (``observed``: their original attributes) taken out and a
    planted fault left in."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.distributed import collectives, constraint
    from repro_torch.distributed import sharding as shr
    from repro_torch.kernels import _build, ops, ref, sampling
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.rl import trainer

    rank, fault = spec["rank"], spec.get("fault")
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    # with "held": the first iteration's calls of those kernels held to plain
    hold = ((lambda: held_to_plain(torch, ops, ref, spec["held"])) if spec.get("held")
            else None)
    try:
        with (rss_sampled() as rss, observed_iterations(torch, _build, hold) as seen,
              observed_collectives(torch) as colls):
            res = train.main(spec["argv"])
    finally:
        for obj, name, value in observed:
            setattr(obj, name, value)
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pipe = res["pipeline"]
    ctx, mesh = pipe.ctx, pipe.ctx.mesh
    model = get_model(res["experiment"].model, device=DEV)
    final = trainer.gather_params(mesh, ctx.actor_state.params, ctx.param_specs)
    art = {"rank": rank, "mesh": mesh.shape, "coords": mesh.coords, "fault": fault,
           "backend": dist.get_backend(),
           "params": sum(t.numel() for t in tree.leaves(final)),
           "local_params": sum(t.numel() for t in tree.leaves(ctx.actor_state.params)),
           "history": [{k: float(v) for k, v in m.items()} for m in res["history"]],
           "iterations": [{"ms": r["ms"], "launches": r["launches"], "collectives": c}
                          for r, c in zip(seen["iterations"], colls["iters"])],
           "launches": launches, "peak_gib": peak_gib, "peak_rss_gib": rss["peak_gib"],
           "stats": dataclasses.asdict(pipe.buffer.stats),
           "rows_loaded": int(ctx.dataloader.rows_loaded), "held": seen["held"]}
    # ---- against the solo run, from this rank's own copies ----
    solo = torch.load(spec["solo_params"])
    d_run = dot = n_solo = n_run = 0.0
    for p0, ps, pr in zip(init["params"], solo, tree.leaves(final)):
        p0, ps, pr = (t.to(DEV).float() for t in (p0, ps, pr.detach()))
        a, b = ps - p0, pr - p0
        d_run += float(torch.sum(torch.square(pr - ps)))
        n_solo += float(torch.sum(a * a))
        n_run += float(torch.sum(b * b))
        dot += float(torch.sum(a * b))
    art["vs_solo"] = {"cosine": dot / max((n_solo * n_run) ** 0.5, 1e-30),
                      "rel_distance": (d_run / max(n_solo, 1e-30)) ** 0.5,
                      "solo_displacement": n_solo ** 0.5, "run_displacement": n_run ** 0.5}
    del solo, init["params"]
    # ---- the replicated leaves: the same bits on both model ranks ----
    diffs = {}
    for key, leaf, sp in zip([k for k, _ in tree.leaves_with_keys(ctx.actor_state.params)],
                             tree.leaves(ctx.actor_state.params),
                             shr.spec_leaves(ctx.param_specs, ctx.actor_state.params)):
        if "model" in [a for axes in shr.dim_axes(sp, leaf.dim()) for a in axes]:
            continue
        both = collectives.all_gather(mesh, leaf.detach()[None], ("model",), axes=("model",))
        diffs[key] = float((both[0].float() - both[1].float()).abs().max())
    art["replicas"] = {"leaves": len(diffs), "max_abs_diff": max(diffs.values()),
                       "worst": max(diffs, key=diffs.get)}
    # ---- the last rollout's logprobs: the ranks' shards against one device;
    # with MoE layers, a token whose predicting position routes to other
    # experts in the two (bf16 sums in another order) is left out and
    # counted ----
    tokens = (seen["tokens"] or [c["result"].tokens for c in seen["engine"]])[-1].clone()
    with torch.no_grad():
        with constraint.use_mesh(mesh), routes_recorded(torch) as routes_tp:
            lp_tp, _ = model.logprobs(ctx.model_params(), tokens)
        with routes_recorded(torch) as routes_one:
            lp_one, _ = model.logprobs(final, tokens)
    keep = torch.ones_like(lp_one[:, 1:], dtype=torch.bool)
    if routes_one:
        keep = ~flipped(torch, routes_tp, routes_one, tokens.shape[0])[:, :-1]
    ok, err = close(lp_tp[:, 1:][keep], lp_one[:, 1:][keep], BF16_TOL)
    art["logprobs"] = {"held": ok, "max_abs_err": err, "shape": list(tokens.shape),
                       "route_flipped_tokens": int((~keep).sum())}
    # ---- the same rollout as an actor batch: the loss and every leaf's
    # gradient on the ranks' shards (gathered) against one device, without
    # the tokens whose route flips ----
    rl = res["experiment"].rl
    g = torch.Generator(device=DEV).manual_seed(1820)
    mask = torch.zeros(tokens.shape, dtype=torch.bool, device=DEV)
    mask[:, tokens.shape[1] - rl.max_new_tokens:] = True
    mask[:, 1:] &= keep
    batch = {"tokens": tokens, "response_mask": mask,
             "old_logprob": (lp_one * mask).detach(), "ref_logprob": (lp_one * mask).detach(),
             "advantages": torch.randn((tokens.shape[0], 1), generator=g, device=DEV) * mask}
    with constraint.use_mesh(mesh):
        (loss_tp, _), g_tp = trainer.value_and_grad(
            lambda p: trainer.actor_loss_fn(model, rl, p, batch), ctx.model_params())
    g_tp = trainer.gather_params(mesh, g_tp, ctx.param_specs)
    (loss_one, _), g_one = trainer.value_and_grad(
        lambda p: trainer.actor_loss_fn(model, rl, p, batch), final)
    num = den = 0.0
    leaf_errs = {}
    for (key, a), b in zip(tree.leaves_with_keys(g_tp), tree.leaves(g_one)):
        d2 = float(torch.sum(torch.square(a.float() - b.float())))
        n2 = float(torch.sum(torch.square(b.float())))
        num, den = num + d2, den + n2
        leaf_errs[key] = (d2 / max(n2, 1e-30)) ** 0.5
    worst = max(leaf_errs, key=leaf_errs.get)
    art["gradient"] = {"loss_rel_err": abs(float(loss_tp) - float(loss_one))
                       / max(abs(float(loss_one)), 1e-30),
                       "rel_err": (num / max(den, 1e-30)) ** 0.5,
                       "leaf_max_rel_err": leaf_errs[worst], "worst_leaf": worst,
                       "leaf_median_rel_err": statistics.median(leaf_errs.values())}
    del final, g_tp, g_one
    gc.collect()
    torch.cuda.empty_cache()
    if "tp20" in spec:
        # phase 20: the int8 cache of this rank's slots, then arm B's models
        # in this world, the pipeline freed first
        cfg, serve = res["experiment"].model, ctx.serve_params()
        art["int8"] = tp20_int8(torch, mesh, cfg, serve, tokens[:, :tokens.shape[1] - rl.max_new_tokens],
                                rl.max_new_tokens, spec["quant"])
        del res, pipe, ctx, model, serve, batch, tokens, lp_tp, lp_one, seen
        gc.collect()
        torch.cuda.empty_cache()
        art["arms"] = {}
        for name in spec["tp20"]:
            art["arms"][name] = tp20_arm(torch, mesh, name)
            gc.collect()
            torch.cuda.empty_cache()
        Path(spec["artifact"]).write_text(json.dumps(art))
        return 0
    if "tp21" in spec:
        # phase 21: the engine's calls on these ranks directly, A's pipeline
        # freed but its serve shards, then the dialog iteration
        cfg, serve = res["experiment"].model, ctx.serve_params()
        art["engine"] = tp21_engine_readings(seen["engine"], rl.max_new_tokens)
        del res, pipe, ctx, model, batch, tokens, lp_tp, lp_one, seen
        gc.collect()
        torch.cuda.empty_cache()
        art["direct"] = tp21_direct(torch, mesh, cfg, serve, short=fault is not None)
        del serve
        gc.collect()
        torch.cuda.empty_cache()
        if fault is None:
            art["dialog"] = tp21_dialog(torch, _build, spec)
        Path(spec["artifact"]).write_text(json.dumps(art))
        return 0
    if fault or not spec.get("sampler", True):
        Path(spec["artifact"]).write_text(json.dumps(art))
        return 0
    # ---- the vocab-sharded sampler on this rank's shard of the head ----
    head = ctx.serve_params()["embed"].t()
    cfg = res["experiment"].model
    n = head.shape[1]
    g = torch.Generator(device=DEV).manual_seed(1819)
    samp = {}
    for Bs in TP_SAMPLER_B:
        h = torch.randn((Bs, head.shape[0]), generator=g, device=DEV).to(torch.bfloat16)
        seeds = torch.randint(-2**31, 2**31, (Bs,), generator=g, device=DEV,
                              dtype=torch.int64).to(torch.int32)
        it = torch.full((Bs,), 1.0 / 0.8, device=DEV)
        f, i = sampling.fused_sample(h, head, seeds, it, vocab_size=cfg.vocab_size,
                                     col_offset=mesh.coords["model"] * n, state=True)
        wire = torch.cat([f.double(), i.double()[:, None]], dim=1)[None]
        gather = []
        for _ in range(DECODE_REPS):
            every, t = sync_ms(torch, lambda: collectives.all_gather(
                mesh, wire, ("model",), axes=("model",)))
            gather.append(t)
        states = [tuple(part[:, k].float() for k in range(4)) + (part[:, 4].long(),)
                  for part in every]
        tok, _ = ref.merge_sample_states(states)
        tok2, _ = ops.fused_sample_shard(mesh, h, head, seeds, it, vocab_size=cfg.vocab_size,
                                         col_offset=mesh.coords["model"] * n)
        require(torch.equal(tok, tok2), f"tp rank {rank}: the shard sampler's two merges differ")
        samp[f"b{Bs}"] = {
            "kernel_ms": device_ms(lambda: sampling.fused_sample(
                h, head, seeds, it, vocab_size=cfg.vocab_size,
                col_offset=mesh.coords["model"] * n, state=True)),
            "gather_ms": statistics.median(gather),
            "merge_ms": device_ms(lambda: ref.merge_sample_states(states))}
    art["sampler"] = samp
    Path(spec["artifact"]).write_text(json.dumps(art))
    return 0


def ensure_solo(label: str, work: Path):
    """Phase 16's solo run on its experiment file (FLEET_LAYERS layers):
    its final params beside SOLO_PARAMS (run again when missing, as with
    ``--only-phase 17`` or 18) and its history. Returns (the experiment
    file, the history)."""
    exp_path = ROOT / "build" / "fleet_experiment.json"
    solo_artifact = SOLO_PARAMS.parent / "host0.artifact.json"
    if not SOLO_PARAMS.exists():
        src = experiment_file("pipeline", ARCH_FLAGS, PIPE_RL)
        spec = json.loads(src.read_text())
        spec["model"]["num_layers"] = FLEET_LAYERS
        spec["distributed"] = {"num_hosts": 1, "exchange_timeout_s": 600.0, "dead_after_s": 120.0}
        exp_path.write_text(json.dumps(spec))
        SOLO_PARAMS.parent.mkdir(parents=True, exist_ok=True)
        args = work / "solo.args.json"
        args.write_text(json.dumps({
            "argv": ["--experiment", str(exp_path), "--device", DEV, "--iters", str(FLEET_ITERS),
                     "--num-hosts", "1"],
            "artifact": str(solo_artifact), "check_int8": False,
            "save_params": str(SOLO_PARAMS)}))
        run_hosts(label, "solo", [(args, work / "solo.log")])
    return exp_path, json.loads(solo_artifact.read_text())["history"]


def tp_world_args(work: Path, arm: str, exp_path: Path, solo_params: Path, iters: int,
                  fault=None, sampler: bool = True, extra=None, flags=()) -> list:
    """The ``run_hosts`` arguments of TP_RANKS ``chip_smoke.py --tp-rank``
    processes of ``launch.train --experiment exp_path --coordinator
    127.0.0.1:PORT`` (a free port) and ``flags``, each held against
    ``solo_params`` (``tp_rank``), with ``fault`` planted and the sampler
    read unless ``sampler`` is False; ``extra`` joins each rank's
    arguments."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    host_args = []
    for r in range(TP_RANKS):
        args = work / f"{arm}{r}.args.json"
        args.write_text(json.dumps({
            "argv": ["--experiment", str(exp_path), "--device", DEV, "--iters", str(iters),
                     "--num-hosts", str(TP_RANKS), "--process-id", str(r),
                     "--coordinator", f"127.0.0.1:{port}", *flags],
            "artifact": str(work / f"{arm}{r}.artifact.json"), "rank": r,
            "solo_params": str(solo_params), "fault": fault, "sampler": sampler,
            **(extra or {})}))
        host_args.append((args, work / f"{arm}{r}.log"))
    return host_args


def tp_readings(arts, solo_history, limits):
    """The holds of a tensor-parallel run (both ranks' ``tp_rank``
    artifacts) against its solo run's history, under ``limits``
    ({"min_cosine", "max_rel_distance", "metric_rtol", "max_replica_diff",
    "max_grad_rel_err", "logprob_tol"}; logprobs are held in ``tp_rank`` at
    BF16_TOL): (held, readings)."""
    vs = {"cosine": min(a["vs_solo"]["cosine"] for a in arts),
          "rel_distance": max(a["vs_solo"]["rel_distance"] for a in arts),
          "replica_max_abs_diff": max(a["replicas"]["max_abs_diff"] for a in arts),
          "replica_worst": arts[0]["replicas"]["worst"],
          "logprob_max_abs_err": max(a["logprobs"]["max_abs_err"] for a in arts),
          "logprobs_held": all(a["logprobs"]["held"] for a in arts),
          "route_flipped_tokens": max(a["logprobs"]["route_flipped_tokens"] for a in arts),
          "grad_rel_err": max(a["gradient"]["rel_err"] for a in arts),
          "grad_leaf_max_rel_err": max(a["gradient"]["leaf_max_rel_err"] for a in arts),
          "grad_worst_leaf": arts[0]["gradient"]["worst_leaf"],
          "grad_leaf_median_rel_err": max(a["gradient"]["leaf_median_rel_err"] for a in arts),
          "fixed_batch_loss_rel_err": max(a["gradient"]["loss_rel_err"] for a in arts),
          "metric_rel_errs": {
              k: [abs(m[k] - s[k]) / max(abs(s[k]), 1e-30)
                  for m, s in zip(arts[0]["history"], solo_history)] for k in SHARD_METRICS},
          # the rollouts: sampled from bf16 logits that the ranks sum in
          # another order, a token may flip, and the batches part
          "rollouts_vs_solo": {k: [(m[k], s[k]) for m, s in zip(arts[0]["history"],
                                                               solo_history)]
                               for k in ("rollout/tokens", "reward/mean")}}
    held = (vs["cosine"] >= limits["min_cosine"]
            and vs["rel_distance"] <= limits["max_rel_distance"]
            and vs["replica_max_abs_diff"] <= limits["max_replica_diff"] and vs["logprobs_held"]
            and vs["grad_leaf_max_rel_err"] <= limits["max_grad_rel_err"]
            and vs["fixed_batch_loss_rel_err"] <= limits["logprob_tol"]
            and all(e <= limits["metric_rtol"] for es in vs["metric_rel_errs"].values()
                    for e in es))
    return held, vs


def tp_phase(torch, ops, ref, _build, records, label="tp", faults=()):
    """Phase 18: tensor-parallel model stages on the card. A: the
    vocab-sharded sampler (``tp_sampler_phase``). B: two ranks of one gloo
    group on ``cuda:0``, each a ``chip_smoke.py --tp-rank`` process
    (``tp_rank``) of ``launch.train --coordinator 127.0.0.1:PORT
    --num-hosts 2 --process-id r`` on phase 16's experiment file with
    ``"mesh_shape": [1, 2]`` (gemma-2b at full width on FLEET_LAYERS layers,
    TP_ITERS GRPO iterations, the (data 1, model 2) rank mesh). Held:

    - every iteration of each rank launches ``iteration_launches`` (the
      solo run's count: the tensor-parallel step launches each kernel as
      often as one device), both ranks print the same metrics, no byte
      through a controller and some redistributions;
    - each rank's final params against phase 16's solo run: each
      iteration's SHARD_METRICS within TP_METRIC_RTOL, the displacement's
      cosine at least TP_MIN_COSINE and distance at most
      TP_MAX_REL_DISTANCE; every leaf replicated over ``model`` differs
      between the ranks by at most TP_MAX_REPLICA_DIFF;
    - the last rollout's logprobs on the ranks' shards within BF16_TOL of
      the one-device model on the gathered params.

    ``faults`` (names of TP_FAULTS) runs B again with each fault planted,
    prints its readings and fails unless a hold rejects it. Prints per rank
    the iteration ms, the collectives' calls, ms and bytes an iteration, the
    peak device GiB and the launches, then ``phase_s``; the sampler's
    records go into ``records["fused_sample"]["vocab_shard"]``. Removes
    SOLO_PARAMS. Returns {path: launch counts}."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.rl import algorithms

    t_phase = time.perf_counter()
    work = ROOT / "build" / "tp18"
    work.mkdir(parents=True, exist_ok=True)
    sampler = tp_sampler_phase(torch, ops, ref)
    try:
        fleet_path, solo_history = ensure_solo(label, work)
        spec = json.loads(fleet_path.read_text())
        spec["mesh_shape"] = [1, TP_RANKS]
        exp_path = ROOT / "build" / "tp_experiment.json"
        exp_path.write_text(json.dumps(spec))
        exp = ExperimentSpec.from_json(exp_path.read_text())
        per_iter, _ = iteration_launches(exp.model, _build.LAUNCHES, exp.rl.max_new_tokens,
                                         algorithms.get_algorithm(exp.rl.algorithm).dag_factory())
        def world(arm, fault=None):
            return run_hosts(label, arm, tp_world_args(work, arm, exp_path, SOLO_PARAMS,
                                                       TP_ITERS, fault=fault), mode="--tp-rank")

        arts = world("rank")
        fault_arts = {f: world(f"fault_{f}", f) for f in faults}
    finally:
        SOLO_PARAMS.unlink(missing_ok=True)

    counts, out = {}, {"layers": FLEET_LAYERS, "ranks": TP_RANKS, "mesh": [1, TP_RANKS]}

    def clean(history):
        return [{k: v for k, v in m.items() if not k.startswith("time/")} for m in history]

    for r, a in enumerate(arts):
        require(a["backend"] == "gloo" and a["mesh"] == {"data": 1, "model": TP_RANKS}
                and a["coords"]["model"] == r,
                f"{label} rank {r}: backend {a['backend']}, mesh {a['mesh']}, {a['coords']}")
        require(all(it["launches"] == per_iter for it in a["iterations"]),
                f"{label} rank {r}: launches {[it['launches'] for it in a['iterations']]}, "
                f"expected {per_iter} an iteration")
        st = a["stats"]
        require(st["bytes_through_controller"] == 0 and st["redistributions"] > 0,
                f"{label} rank {r}: buffer stats {st}")
        # the ranks of the one data row read every row of every step (its
        # prompts and its answers)
        require(a["rows_loaded"] == 2 * TP_ITERS * exp.prompts_per_iter,
                f"{label} rank {r}: {a['rows_loaded']} rows loaded")
        timed = a["iterations"][1:]
        row = {"rank": r, "params": a["params"], "local_params": a["local_params"],
               "iteration_ms": [it["ms"] for it in a["iterations"]],
               "timed_iteration_ms": statistics.median(it["ms"] for it in timed),
               "collectives_per_timed_iteration": {
                   k: {f: statistics.median(it["collectives"][k][f] for it in timed)
                       for f in ("calls", "ms", "bytes")} for k in ("all_reduce", "all_gather")},
               "collectives_warmup": a["iterations"][0]["collectives"],
               "peak_gib": a["peak_gib"], "peak_rss_gib": a["peak_rss_gib"],
               "buffer_stats": st, "launches": a["launches"],
               "launches_implied": {n: TP_ITERS * c for n, c in per_iter.items()},
               "vs_solo": a["vs_solo"], "replicas": a["replicas"], "logprobs": a["logprobs"],
               "gradient": a["gradient"], "sampler_on_rank": a["sampler"]}
        print(json.dumps({f"{label}_rank": row}), flush=True)
        counts[f"tp_grpo_rank{r}"] = a["launches"]
    limits = {"min_cosine": TP_MIN_COSINE, "max_rel_distance": TP_MAX_REL_DISTANCE,
              "metric_rtol": TP_METRIC_RTOL, "max_replica_diff": TP_MAX_REPLICA_DIFF,
              "max_grad_rel_err": TP_MAX_GRAD_REL_ERR, "logprob_tol": BF16_TOL}
    # every reading first, the sound run's and the faults', then the holds
    held, vs = tp_readings(arts, solo_history, limits)
    print(json.dumps({"check": f"{label}_against_the_solo_run", **vs, **limits}), flush=True)
    fault_held = {}
    for fault, fa in fault_arts.items():
        fault_held[fault], fvs = tp_readings(fa, solo_history, limits)
        print(json.dumps({"check": f"{label}_fault_{fault}_against_the_solo_run",
                          "held": fault_held[fault], **fvs, **limits}), flush=True)
    require(clean(arts[0]["history"]) == clean(arts[1]["history"]),
            f"{label}: the ranks' metrics differ")
    require(all(m["actor/grad_norm"] > 0 for m in arts[0]["history"]), f"{label}: a zero gradient")
    require(held, f"{label}: the tensor-parallel run against the solo run's: {vs}")
    for fault, fheld in fault_held.items():
        require(not fheld, f"{label}: the holds do not reject the planted fault {fault}")
    for case, rec in sampler.items():
        rec["on_ranks"] = {f"rank{a['rank']}": a["sampler"].get(case.split("_")[-1])
                           for a in arts} if case.startswith("gemma") else None
    records.setdefault("fused_sample", {})["vocab_shard"] = sampler
    print(json.dumps({f"{label}_sampler": sampler}), flush=True)
    out["solo_history"] = solo_history
    out["history"] = arts[0]["history"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: out}), flush=True)
    return counts


# ---- phase 19: tensor-parallel MoE and SSD layers ----
TP19_MODELS = {"granite": GRANITE_FLAGS, "mamba2": MAMBA2_FLAGS}
TP19_LAYERS = 2
TP19_ITERS = 3  # one warm-up iteration, then two timed
# holds of each (1, 2) run against its own solo run, set between the sound
# runs and the planted faults of --tp-faults (on an H100 80GB HBM3 at 700 W,
# sound granite / mamba2 against the worse fault: cosine 0.985 / 0.986
# against 0.952, distance 0.174 / 0.166 against 0.308, grad_norm and loss
# 0.0070 / 0.0064 against 0.055, the fixed batch's worst leaf 0.030 / 0.015
# against 0.318; PERF.md)
TP19_MIN_COSINE = 0.97
TP19_MAX_REL_DISTANCE = 0.25
TP19_METRIC_RTOL = 0.03
TP19_MAX_GRAD_REL_ERR = 0.05
# faults planted for --tp-faults with --only-phase 19: the MoE combine
# weights' copy_to_model dropped (granite's router then takes each rank's
# partial gradient through the gates), and mamba2's gated norm over the
# rank's own width instead of the whole d_inner
TP19_FAULTS = {"moe_gate_copy": "granite", "ssd_norm_local": "mamba2"}
# the sharded gated norm: (rows, a rank's columns, the whole width) at a
# training step's 1,280 rows and a decode step's 8, mamba2's d_inner of 5,120
# and jamba's of 8,192 over two ranks
TP19_NORMS = {"mamba2_training": (1280, 2560, 5120), "mamba2_decode": (8, 2560, 5120),
              "jamba_training": (1280, 4096, 8192), "jamba_decode": (8, 4096, 8192)}
SUMSQ_TOL = 1e-5  # fp32 sums of 2,560 or 4,096 squares in another order
# the scan on a rank's heads: (heads, state) of mamba2 and jamba over two
# ranks, at 8 rows of one 128-position chunk
TP19_SSD = {"mamba2": (M_HEADS // 2, M_STATE), "jamba": (64, 16)}
TP19_SSD_B, TP19_SSD_S = 8, 128


def tp19_kernel_records(torch, ref, F):
    """Phase 19 A, each kernel alone on the card against its plain version
    on the same inputs, by CUDA events (median of 25). The sharded norm at
    TP19_NORMS: each rank's ``rmsnorm_sumsq`` (within SUMSQ_TOL) and
    ``rmsnorm_scaled`` on the ranks' summed sums (within BF16_TOL), the
    ranks' outputs side by side against the plain norm of the whole row, each
    entry's bound, and ``F.rms_norm`` of the whole row on one device as the
    library yardstick. The scan at TP19_SSD's heads a rank (y within
    SSD_Y_TOL, the state within SSD_STATE_TOL), with its bound. Returns
    ({case: norm record}, {model: scan record})."""
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssd_mod

    gen = torch.Generator(device=DEV).manual_seed(1919)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)

    norms = {}
    for case, (R, D, width) in TP19_NORMS.items():
        ranks = width // D
        xs = [randn(R, D, scale=1.0 + r) for r in range(ranks)]  # the halves differ
        ws = [randn(D, scale=0.1, dtype=torch.float32) for _ in range(ranks)]
        x, w = xs[0], ws[0]
        ok, err_ss = close(rn.rmsnorm_sumsq(x), ref.rmsnorm_sumsq(x), SUMSQ_TOL)
        require(ok, f"rmsnorm_sumsq {case}: max abs err {err_ss}")
        ss = sum(rn.rmsnorm_sumsq(t) for t in xs)
        ok, err_y = close(rn.rmsnorm_scaled(x, ss, w, width=width),
                          ref.rmsnorm_scaled(x, ss, w, width=width), BF16_TOL)
        require(ok, f"rmsnorm_scaled {case}: max abs err {err_y}")
        whole = torch.cat([rn.rmsnorm_scaled(t, ss, wt, width=width)
                           for t, wt in zip(xs, ws)], dim=-1)
        xw, ww = torch.cat(xs, dim=-1), torch.cat(ws)
        ok, err_whole = close(whole, ref.rmsnorm(xw, ww), BF16_TOL)
        require(ok, f"sharded rmsnorm {case}: the ranks' rows against the whole row, {err_whole}")
        ss_bound, ss_by = bound_ms(R * D * 2 + R * 4, 2 * R * D, FP32_FLOP_PER_S)
        sc_bound, sc_by = bound_ms(2 * R * D * 2 + R * 4 + D * 4, 4 * R * D, FP32_FLOP_PER_S)
        wl = (1.0 + ww).to(torch.bfloat16)
        rec = {"shape": {"rows": R, "columns": D, "width": width},
               "sumsq": {"max_abs_err": err_ss, "ms": device_ms(lambda: rn.rmsnorm_sumsq(x)),
                         "plain_ms": device_ms(lambda: ref.rmsnorm_sumsq(x)),
                         "bound_ms": ss_bound, "bound_by": ss_by},
               "scaled": {"max_abs_err": err_y,
                          "ms": device_ms(lambda: rn.rmsnorm_scaled(x, ss, w, width=width)),
                          "plain_ms": device_ms(lambda: ref.rmsnorm_scaled(x, ss, w,
                                                                           width=width)),
                          "bound_ms": sc_bound, "bound_by": sc_by},
               "ranks_against_whole_row_max_abs_err": err_whole,
               "library_ms": device_ms(lambda: F.rms_norm(xw, (width,), weight=wl, eps=1e-6)),
               "library": "F.rms_norm of the whole row on one device"}
        norms[case] = rec
        print(json.dumps({"check": f"tp19/rmsnorm_split/{case}", **rec}), flush=True)
        del xs, ws, x, w, ss, whole, xw, ww
    scans = {}
    Bs, S = TP19_SSD_B, TP19_SSD_S
    for model, (H, N) in TP19_SSD.items():
        args = (randn(Bs, S, H, M_HEADDIM), F.softplus(randn(Bs, S, H, dtype=torch.float32)),
                -torch.exp(randn(H, dtype=torch.float32)), randn(Bs, S, 1, N),
                randn(Bs, S, 1, N), randn(H, dtype=torch.float32))
        y, h = ssd_mod.ssd(*args)
        y_p, h_p = ssd_mod.plain(*args)
        ok_y, err_y = close(y, y_p, SSD_Y_TOL)
        ok_h, err_h = close(h, h_p, SSD_STATE_TOL)
        require(ok_y and ok_h, f"ssd {model} {H} heads: y err {err_y}, state err {err_h}")
        flops = Bs * H * (S * (S + 1) // 2 * (2 * N + 2 * M_HEADDIM) + 4 * S * N * M_HEADDIM)
        nbytes = (2 * Bs * S * H * M_HEADDIM * 2 + Bs * H * M_HEADDIM * N * 4 + Bs * S * H * 4
                  + 2 * Bs * S * N * 2 + 2 * H * 4)
        bms, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOP_PER_S)
        rec = {"shape": {"x": [Bs, S, H, M_HEADDIM], "state": N}, "max_abs_err": err_y,
               "state_max_abs_err": err_h, "ms": device_ms(lambda: ssd_mod.ssd(*args)),
               "plain_ms": device_ms(lambda: ssd_mod.plain(*args)),
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        scans[model] = rec
        print(json.dumps({"check": f"tp19/ssd/{model}_{H}_heads", **rec}), flush=True)
        del args, y, h, y_p, h_p
    torch.cuda.empty_cache()
    return norms, scans


def gated_norm_launches(cfg, max_new_tokens: int, dag) -> int:
    """The gated norms of one RL iteration: one for each SSD layer in every
    forward, which is each GENERATE node's prefill and its
    ``max_new_tokens - 1`` decode steps, each MODEL_INFERENCE node's forward,
    and each MODEL_TRAIN node's forward and its remat in the backward. On a
    tensor-parallel mesh each launches ``rmsnorm_sumsq`` and
    ``rmsnorm_scaled`` once, where one device launches ``rmsnorm``."""
    from repro_torch.core.dag import NodeType

    types = [node.type for node in dag.nodes.values()]
    forwards = (types.count(NodeType.GENERATE) * max_new_tokens
                + types.count(NodeType.MODEL_INFERENCE) + 2 * types.count(NodeType.MODEL_TRAIN))
    return sum(k[0] == "ssm" for k in cfg.layer_kinds()) * forwards


def tp_moe_ssd_phase(torch, ref, F, _build, records, label="tp19", faults=()):
    """Phase 19: tensor-parallel MoE and SSD layers on the card. A: the
    sharded gated norm's two entries and the scan on a rank's heads, alone
    (``tp19_kernel_records``). B: for granite-moe-3b and then mamba2-2.7b,
    each at full width on TP19_LAYERS layers (phase 8's experiment file of
    its arch, cut), a solo run (``launch.train.main`` in this process) and
    two ranks of one gloo group on ``cuda:0``
    (``chip_smoke.py --tp-rank``, ``launch.train --coordinator
    127.0.0.1:PORT --num-hosts 2 --process-id r`` on the file with
    ``"mesh_shape": [1, 2]``; one model's world after the other's),
    TP19_ITERS GRPO iterations each. Held, as in phase 18:

    - every iteration of each rank launches each kernel as often as the solo
      run's iteration, but for the gated norms (``gated_norm_launches``):
      each launches ``rmsnorm_sumsq`` and ``rmsnorm_scaled`` once in place of
      one ``rmsnorm``; both ranks print the same metrics; no byte through a
      controller and some redistributions;
    - against the solo run: the metrics within TP19_METRIC_RTOL, the
      displacement's cosine and distance (TP19_MIN_COSINE,
      TP19_MAX_REL_DISTANCE), every leaf replicated over ``model`` (router,
      ``w_B``, ``w_C``, ``conv_bc``, the block norms) bit for bit equal on
      both ranks, a fixed batch's gradient of every leaf, gathered, within
      TP19_MAX_GRAD_REL_ERR of one device's, and the last rollout's
      logprobs within BF16_TOL (granite's tokens whose route flips left out,
      and counted).

    ``faults`` (names of TP19_FAULTS) runs its model's world again with the
    fault planted (one fault's world after the other's), prints its
    readings and fails unless the holds reject it. Prints per rank the
    iteration ms, the collectives' calls, ms and bytes an iteration and the
    peak device GiB, then ``phase_s``. The norm entries' records go into
    ``records["rmsnorm_sumsq"]`` and ``records["rmsnorm_scaled"]`` (rows of
    the kernels line, each at mamba2's training shape with every case under
    ``by_case``), the scan's into ``records["ssd"]["head_shards"]``.
    Returns {path: launch counts}."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.rl import algorithms

    t_phase = time.perf_counter()
    work = ROOT / "build" / "tp19"
    work.mkdir(parents=True, exist_ok=True)
    norms, scans = tp19_kernel_records(torch, ref, F)
    train_norm = norms["mamba2_training"]
    for entry in ("sumsq", "scaled"):
        records[f"rmsnorm_{entry}"] = {**train_norm[entry], **train_norm["shape"],
                                       "library_ms": train_norm["library_ms"],
                                       "library": train_norm["library"],
                                       "by_case": {case: {**rec["shape"], **rec[entry]}
                                                   for case, rec in norms.items()}}
    records.setdefault("ssd", {})["head_shards"] = scans
    from repro_torch import tree
    from repro_torch.launch import train

    files, solos = {}, {}
    for name, flags in TP19_MODELS.items():
        spec = json.loads(experiment_file(f"{label}_{name}", flags, PIPE_RL).read_text())
        spec["model"]["num_layers"] = TP19_LAYERS
        spec["distributed"] = {"num_hosts": 1, "exchange_timeout_s": 600.0, "dead_after_s": 120.0}
        solo_path = work / f"{name}_solo_experiment.json"
        solo_path.write_text(json.dumps(spec))
        spec["mesh_shape"] = [1, TP_RANKS]
        tp_path = work / f"{name}_tp_experiment.json"
        tp_path.write_text(json.dumps(spec))
        files[name] = (tp_path, work / f"{name}_solo_params.pt")
        # the solo run in this process (its kernels and context are up), each
        # iteration synchronised with its launches; its final params saved
        # for the ranks to be held against
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with observed_iterations(torch, _build) as seen:
            res = train.main(["--experiment", str(solo_path), "--device", DEV, "--iters",
                              str(TP19_ITERS), "--num-hosts", "1"])
        torch.save([t.cpu() for t in tree.leaves(res["pipeline"].ctx.actor_state.params)],
                   files[name][1])
        solos[name] = {"history": [{k: float(v) for k, v in m.items()} for m in res["history"]],
                       "iterations": [{"ms": r["ms"], "launches": r["launches"]}
                                      for r in seen["iterations"]],
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del res, seen
        gc.collect()
        torch.cuda.empty_cache()

    def worlds(runs):
        """The worlds of ``runs`` ({key: (model, fault)}) at once, each
        its own gloo group on the card: {key: its ranks' artifacts}."""
        host_args = [a for key, (name, fault) in runs.items()
                     for a in tp_world_args(work, key, files[name][0], files[name][1],
                                            TP19_ITERS, fault=fault, sampler=False)]
        arts = run_hosts(label, "+".join(runs), host_args, mode="--tp-rank")
        return {key: arts[i * TP_RANKS:(i + 1) * TP_RANKS] for i, key in enumerate(runs)}

    try:
        # both models' worlds at once (one after the other before the script
        # outgrew its time limit): a rank's peak is its
        # own process's, its ms shares the card and the host with the other
        # world's ranks
        arts, fault_arts = worlds({name: (name, None) for name in TP19_MODELS}), {}
        for f in faults:
            fault_arts.update(worlds({f: (TP19_FAULTS[f], f)}))
    finally:
        for _, params_path in files.values():
            params_path.unlink(missing_ok=True)

    def clean(history):
        return [{k: v for k, v in m.items() if not k.startswith("time/")} for m in history]

    counts = {}
    limits = {"min_cosine": TP19_MIN_COSINE, "max_rel_distance": TP19_MAX_REL_DISTANCE,
              "metric_rtol": TP19_METRIC_RTOL, "max_replica_diff": TP_MAX_REPLICA_DIFF,
              "max_grad_rel_err": TP19_MAX_GRAD_REL_ERR, "logprob_tol": BF16_TOL}
    out = {"layers": TP19_LAYERS, "ranks": TP_RANKS, "mesh": [1, TP_RANKS], "models": {}}
    held_by = {}
    for name, ranks in arts.items():
        exp = ExperimentSpec.from_json(files[name][0].read_text())
        solo = solos[name]
        sumsq = gated_norm_launches(exp.model, exp.rl.max_new_tokens,
                                    algorithms.get_algorithm(exp.rl.algorithm).dag_factory())
        for r, a in enumerate(ranks):
            require(a["backend"] == "gloo" and a["mesh"] == {"data": 1, "model": TP_RANKS}
                    and a["coords"]["model"] == r,
                    f"{label} {name} rank {r}: backend {a['backend']}, mesh {a['mesh']}, "
                    f"{a['coords']}")
            for i, (it, sit) in enumerate(zip(a["iterations"], solo["iterations"])):
                want = dict(sit["launches"], rmsnorm=sit["launches"]["rmsnorm"] - sumsq,
                            rmsnorm_sumsq=sumsq, rmsnorm_scaled=sumsq)
                require(it["launches"] == want,
                        f"{label} {name} rank {r} iteration {i}: launches {it['launches']}, "
                        f"expected {want}")
            st = a["stats"]
            require(st["bytes_through_controller"] == 0 and st["redistributions"] > 0,
                    f"{label} {name} rank {r}: buffer stats {st}")
            timed = a["iterations"][1:]
            row = {"model": name, "rank": r, "params": a["params"],
                   "local_params": a["local_params"],
                   "iteration_ms": [it["ms"] for it in a["iterations"]],
                   "timed_iteration_ms": statistics.median(it["ms"] for it in timed),
                   "solo_iteration_ms": [it["ms"] for it in solo["iterations"]],
                   "collectives_per_timed_iteration": {
                       k: {f: statistics.median(it["collectives"][k][f] for it in timed)
                           for f in ("calls", "ms", "bytes")}
                       for k in ("all_reduce", "all_gather")},
                   "peak_gib": a["peak_gib"], "solo_peak_gib": solo["peak_gib"],
                   "peak_rss_gib": a["peak_rss_gib"], "buffer_stats": st,
                   "launches": a["launches"], "vs_solo": a["vs_solo"],
                   "replicas": a["replicas"], "logprobs": a["logprobs"],
                   "gradient": a["gradient"]}
            print(json.dumps({f"{label}_rank": row}), flush=True)
            counts[f"tp_{name}_grpo_rank{r}"] = a["launches"]
        require(clean(ranks[0]["history"]) == clean(ranks[1]["history"]),
                f"{label} {name}: the ranks' metrics differ")
        require(all(m["actor/grad_norm"] > 0 for m in ranks[0]["history"]),
                f"{label} {name}: a zero gradient")
        held_by[name], vs = tp_readings(ranks, solo["history"], limits)
        print(json.dumps({"check": f"{label}_{name}_against_the_solo_run", "held": held_by[name],
                          **vs, **limits}), flush=True)
        out["models"][name] = {"history": ranks[0]["history"], "solo_history": solo["history"]}
    fault_held = {}
    for fault, fa in fault_arts.items():
        fault_held[fault], fvs = tp_readings(fa, solos[TP19_FAULTS[fault]]["history"], limits)
        print(json.dumps({"check": f"{label}_fault_{fault}_against_the_solo_run",
                          "held": fault_held[fault], **fvs, **limits}), flush=True)
    for name, held in held_by.items():
        require(held, f"{label} {name}: the tensor-parallel run against the solo run's")
    for fault, fheld in fault_held.items():
        require(not fheld, f"{label}: the holds do not reject the planted fault {fault}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: out}), flush=True)
    return counts


# ---- phase 20: tensor-parallel model stages of the remaining families ----
TP20_LAYERS = 2
TP20_ITERS = 3  # one warm-up iteration held to plain, then two timed
# arm A's kernels held to plain in each rank's warm-up iteration (the
# vocab-sharded sampler is held in phase 18)
TP20_HELD = ("rmsnorm", "flash_attention", "decode_attention_quant")
# arm B, model level in arm A's world: (flags, layers or None for the full
# depth, batch, prompt, new tokens). mixtral's 4,080-token prompt and 32 new
# tokens wrap its 4,096-slot ring (phase 13's shape) and run 16 past it (272
# new and 256 past, and seamless at its full 12 decoder layers, before the
# script outgrew its time limit)
TP20_ARMS = {"mixtral": (["--arch", "mixtral-8x7b"], 2, 2, 4080, MAX_NEW),
             "llava": (LLAVA_FLAGS, 2, LLAVA_B, PROMPT, MAX_NEW),
             "seamless": (SEAMLESS_FLAGS, 2, SEAMLESS_B, PROMPT, MAX_NEW),
             "nemotron": (NEMOTRON_FLAGS, 2, B, PROMPT, MAX_NEW)}
TP20_GAP = 0.05  # tokens equal where the solo run's top-two gap exceeds this
TP20_SAMPLED = 8  # new tokens of the greedy generate that runs the sharded sampler
# faults planted for --tp-faults with --only-phase 20: the ring's residue
# taken modulo the rank's width (mixtral's arm), and gemma's K/V rows
# quantized with the scale of each rank's half of the head (arm A)
TP20_FAULTS = {"ring_rank_residue": "mixtral", "quant_before_gather": None}


def tp20_rank_residue(cfg, cache_len, w):
    """``lm._tp_ring_slot`` with the ring's residue and live count taken
    modulo this rank's width (the ``ring_rank_residue`` fault)."""
    import torch

    if cfg.sliding_window is None:
        return cache_len, cache_len + 1
    return cache_len % w, torch.clamp(cache_len + 1, max=w)


def tp20_quant_half(x):
    """``lm.quant_kv`` with each row's scale taken over this rank's half of
    the head only (the ``quant_before_gather`` fault)."""
    import torch

    from repro_torch.distributed import constraint

    hd, r, m = x.shape[-1], constraint.tp_rank(), constraint.tp_size()
    part = x[..., r * hd // m:(r + 1) * hd // m].float()
    scale = torch.clamp(part.abs().amax(dim=-1), min=1e-8) / 127.0
    return torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127).to(torch.int8), scale


def tp20_int8(torch, mesh, cfg, serve, prompt, new: int, quant):
    """Arm A's int8 cache on this rank: the prefill cache of ``prompt`` on
    the rank mesh, every rank's slots gathered, against ``quant`` (the
    port's ``quant_kv``) of the same mesh's prefill cache with kv_quant off:
    the int8 values and scales must be equal bit for bit, slot for slot,
    past the prompt and past W too. Then a greedy generate of ``new``
    tokens with the first ``decode_attention_quant`` call of each shape
    kept, and on rank 0 that call timed on its own inputs (``path_records``:
    this rank's slot shard of the int8 cache). Returns the readings."""
    import torch.nn.functional as F

    from repro_torch.distributed import collectives, constraint
    from repro_torch.kernels import ops, ref
    from repro_torch.models import get_model
    from repro_torch.rl import rollout

    smax = prompt.shape[1] + new
    model = get_model(cfg, device=DEV)
    plain = get_model(dataclasses.replace(cfg, kv_quant=False), device=DEV)

    def gather(t):
        return collectives.all_gather(mesh, t, (None, "model"), axes=("model",))

    with torch.inference_mode(), constraint.use_mesh(mesh):
        got = model.prefill(serve, prompt, smax=smax)[1]
        kv = plain.prefill(serve, prompt, smax=smax)[1]
        unequal = []
        for g, f in zip(got, kv):
            (kq, ks), (vq, vs) = quant(gather(f["k"])), quant(gather(f["v"]))
            want = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            unequal.append({k: int((gather(g[k]) != w).sum()) for k, w in want.items()})
        slots = gather(got[0]["k"]).shape[1]
        del got, kv
        with first_calls(torch, ops, ("decode_attention_quant",)) as calls:
            rollout.generate(model, serve, prompt, torch.Generator(device=DEV).manual_seed(2),
                             max_new=new, temperature=0.0)
    out = {"equal": all(v == 0 for layer in unequal for v in layer.values()),
           "unequal": unequal, "width": smax, "slots": slots, "prompt": list(prompt.shape)}
    if mesh.coords["model"] == 0:
        out["records"] = path_records(torch, ops, ref, F, calls, "tp20/gemma_int8_rank0")
    return out


@contextlib.contextmanager
def block_io(torch):
    """While open, the (input, output) hidden states of every decoder layer
    that runs in prefill mode (``lm._apply_block``) are kept in call order.
    Yields the list."""
    from repro_torch.models import lm

    seen, apply = [], lm._apply_block

    def recording(cfg, p, kind, h, positions, mode, *args, **kw):
        out = apply(cfg, p, kind, h, positions, mode, *args, **kw)
        if mode == "prefill":
            seen.append((h, out[0]))
        return out

    with patched(lm, "_apply_block", recording):
        yield seen


def tp20_drift_rule(names, g_t, g_k, g_r, g_v, zero):
    """Phase 14's drift rule for the rank mesh's gradient ``g_t`` against
    the solo kernel path's ``g_k``: a leaf's drift is the solo plain path
    (``g_r``) against itself with fp32 attention probabilities (``g_v``);
    each leaf's relative L2 error within GRAD_DRIFT_FACTOR x the largest
    drift of its kind (one parameter over the blocks), and each kind's
    median error within GRAD_DRIFT_FACTOR x its median drift (drifts no less
    than GRAD_FLOOR). The cosine's ratio to its drift is reported, not held:
    it grows as the square of the L2 error, and the ranks' sums in another
    order move a bias's gradient by up to 1.6 of its kind's drift on the CPU
    (2.6 in 1 - cosine). The leaves named with one of ``zero`` have a
    gradient that is zero in exact arithmetic and are reported only.
    Returns (the leaves or kinds beyond their limit, summary)."""
    from repro_torch import tree

    leaves, zero_max = [], {}
    for name, t, k, r, v in zip(names, tree.leaves(g_t), tree.leaves(g_k), tree.leaves(g_r),
                                tree.leaves(g_v)):
        if name.endswith(zero):
            zero_max[name] = max(float(t.float().abs().max()), float(k.float().abs().max()))
            continue
        leaves.append({"leaf": name, "rel_l2": rel_l2(t, k), "cosine": cosine(t, k),
                       "drift_rel_l2": rel_l2(v, r), "drift_cosine": cosine(v, r)})
    kinds, bad = {}, []
    for e in leaves:
        kinds.setdefault(re.sub(r"\[\d+\]", "", e["leaf"]), []).append(e)
    worst, worst_c = {"ratio": 0.0}, 0.0
    for kind, es in kinds.items():
        drift = max(max(e["drift_rel_l2"] for e in es), GRAD_FLOOR)
        drift_c = max(max(1.0 - e["drift_cosine"] for e in es), GRAD_FLOOR ** 2 / 2)
        for e in es:
            ratio = e["rel_l2"] / drift
            if ratio > worst["ratio"]:
                worst = {"ratio": ratio, "leaf": e["leaf"], "rel_l2": e["rel_l2"],
                         "drift_rel_l2": drift}
            worst_c = max(worst_c, (1.0 - e["cosine"]) / drift_c)
            if e["rel_l2"] > GRAD_DRIFT_FACTOR * drift:
                bad.append({"leaf": e["leaf"], "rel_l2": e["rel_l2"], "drift": drift})
        med = statistics.median(e["rel_l2"] for e in es)
        med_drift = max(statistics.median(e["drift_rel_l2"] for e in es), GRAD_FLOOR)
        if med > GRAD_DRIFT_FACTOR * med_drift:
            bad.append({"kind": kind, "median_rel_l2": med, "median_drift": med_drift})
    return bad, {"leaves": len(leaves), "kinds": len(kinds), "beyond_limit": bad[:8],
                 "worst_ratio": worst, "worst_cosine_ratio": worst_c,
                 "worst_rel_l2": max(e["rel_l2"] for e in leaves),
                 "worst_drift_rel_l2": max(e["drift_rel_l2"] for e in leaves),
                 "zero_in_exact_arithmetic_max_abs_grad": zero_max}


def tp20_arm(torch, mesh, name):
    """One model of arm B on this rank of the (1, 2) world (TP20_ARMS): the
    weights drawn from seed 0 on both ranks and cut to this rank's shards.
    Rank 0 runs the solo model first: prefill with every layer's input and
    output kept, then greedy decode steps (each step's token fed back). The
    rank mesh then runs, under ``constraint.use_mesh`` with every kernel
    call held to plain (``held_to_plain``) and its launches counted: the
    prefill, the same decode steps fed the solo run's tokens, every layer
    again on the solo run's input of that layer, and a greedy generate of
    TP20_SAMPLED tokens through the vocab-sharded sampler (nemotron: a
    generate at TOP_P, TOP_P_TEMPERATURE instead, whose draws must lie in
    their nucleus and which launches no ``fused_sample``). seamless: the
    encoder's memory, then one loss and gradient on the train shards,
    against the solo kernel path by ``tp20_drift_rule``. Rank 0 also runs
    the plain path (``ops.set_mode("ref")``) fed the solo run's tokens.
    Rank 0 holds the readings: the prefill logits within BF16_TOL x the solo
    run's max |logit| and the first tokens equal where its top-two gap
    exceeds TP20_GAP; every step's logits within the larger of BF16_TOL and
    DRIFT_FACTOR x the plain path's drift from the solo run (rows whose MoE
    route flips in either left out, and counted; the steps' argmax agreement
    counted); every layer within BF16_TOL x its max |output| (an MoE layer's
    tokens whose route flips left out, and counted); the first layer's cache
    after the last step (a ring: wrapped) within BF16_TOL x its max, slot for
    slot; seamless's memory within DRIFT_FACTOR x the larger of the plain
    path's drifts from the kernel path and from its fp32-attention self, its
    loss within BF16_TOL. Returns {"held", "failed", the
    readings, the launches, the kernels' records}."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import constraint
    from repro_torch.distributed import sharding as shr
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import encdec, get_model, lm
    from repro_torch.rl import rollout, trainer

    t_arm = time.perf_counter()
    flags, depth, Bs, L, new = TP20_ARMS[name]
    cfg = get_config(flags[1])
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    model = get_model(cfg, device=DEV)
    rank, MODEL = mesh.coords["model"], ("model",)
    full = model.init(torch.Generator(device=DEV).manual_seed(0))

    def shards(specs):
        return shr.map_with_specs(lambda p, s: C.shard(mesh, p, s, axes=MODEL).clone(), full,
                                  specs)

    serve = shards(shr.param_specs(cfg, mesh, full, "serve"))
    train_specs = shr.param_specs(cfg, mesh, full, "train") if cfg.is_encoder_decoder else None
    train = shards(train_specs) if train_specs is not None else None
    if rank:
        full = None
        gc.collect()
        torch.cuda.empty_cache()
    g = torch.Generator(device=DEV).manual_seed(20)
    prompt = torch.randint(3, cfg.vocab_size, (Bs, L), generator=g, device=DEV,
                           dtype=torch.int32)
    extra, P = {}, 0
    if cfg.num_prefix_embeds > 1 and not cfg.is_encoder_decoder:
        P = cfg.num_prefix_embeds
        extra["prefix_embeds"] = (torch.randn((Bs, P, cfg.d_model), generator=g, device=DEV)
                                  * 0.02).to(torch.bfloat16)
    if cfg.is_encoder_decoder:
        extra["frames"] = torch.randn((Bs, cfg.encoder_len, cfg.d_model), generator=g,
                                      device=DEV).to(torch.bfloat16)
    smax, V = P + L + new, cfg.vocab_size

    def from0(t):  # rank 0's tensor on every rank
        return C.all_gather(mesh, t[None], MODEL, axes=MODEL)[0]

    # ---- the solo run, on rank 0 ----
    solo = {}
    with torch.inference_mode():
        if rank == 0:
            with routes_recorded(torch) as routes, block_io(torch) as io:
                logits, caches, cl = model.prefill(full, prompt, smax=smax, **extra)
                steps, toks = [logits], [logits.argmax(-1).to(torch.int32)]
                for _ in range(new - 1):
                    logits, caches, cl = model.decode_step(full, toks[-1], caches, cl)
                    steps.append(logits)
                    toks.append(logits.argmax(-1).to(torch.int32))
            solo = {"steps": steps, "cache0": caches[0], "routes": list(routes), "io": io}
            forced = torch.stack(toks, 1)
            del caches
            # the plain path fed the same tokens: the drift of an equally
            # valid rounding of the same model, step by step
            ops.set_mode("ref")
            try:
                with routes_recorded(torch) as routes_p:
                    logits, caches, cl = model.prefill(full, prompt, smax=smax, **extra)
                    solo["plain_steps"] = [logits]
                    for j in range(new - 1):
                        logits, caches, cl = model.decode_step(full, forced[:, j], caches, cl)
                        solo["plain_steps"].append(logits)
                del caches
                if cfg.is_encoder_decoder:
                    solo["memory_plain"] = encdec.encode(cfg, full, extra["frames"])
                    with fp32_attention(ref):
                        solo["memory_fp32"] = encdec.encode(cfg, full, extra["frames"])
            finally:
                ops.set_mode(None)
            solo["plain_routes"] = list(routes_p)
            if cfg.is_encoder_decoder:
                solo["memory"] = encdec.encode(cfg, full, extra["frames"])
        else:
            forced = torch.zeros((Bs, new), dtype=torch.int32, device=DEV)
        forced = from0(forced)
    # ---- the rank mesh ----
    names = (("rmsnorm",) if cfg.norm_type == "rmsnorm" else ()) + ("flash_attention",
                                                                     "decode_attention")
    first = {"mixtral": ("decode_attention",), "seamless": ("flash_attention",)}.get(name, ())
    _build.reset_launches()
    with torch.inference_mode(), constraint.use_mesh(mesh), \
            held_to_plain(torch, ops, ref, names) as held, \
            first_calls(torch, ops, first) as calls, routes_recorded(torch) as routes_tp:
        (logits, caches, cl), prefill_ms = sync_ms(
            torch, lambda: model.prefill(serve, prompt, smax=smax, **extra))
        steps_tp = [logits]
        t0 = time.perf_counter()
        for j in range(new - 1):
            logits, caches, cl = model.decode_step(serve, forced[:, j], caches, cl)
            steps_tp.append(logits)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / max(new - 1, 1)
        cache0 = {k: C.all_gather(mesh, v, (None, "model"), axes=MODEL)
                  for k, v in caches[0].items() if k in ("k", "v")}
        del caches
        layer_out, n_steps = [], len(routes_tp)
        if not cfg.is_encoder_decoder:
            positions = torch.arange(P + L, device=DEV)[None, :]
            for i, (blk, kind) in enumerate(zip(serve["blocks"], cfg.layer_kinds())):
                h_in = solo["io"][i][0] if rank == 0 else torch.zeros(
                    (Bs, P + L, cfg.d_model), dtype=torch.bfloat16, device=DEV)
                layer_out.append(lm._apply_block(cfg, blk, kind, from0(h_in), positions,
                                                 "prefill", None, None, smax)[0])
        else:
            memory = encdec.encode(cfg, serve, extra["frames"])
    routes_steps, routes_layers = routes_tp[:n_steps], routes_tp[n_steps:]
    launches = dict(_build.LAUNCHES)
    # ---- the sampler on the rank mesh ----
    drawn = []
    _build.reset_launches()
    with torch.inference_mode(), constraint.use_mesh(mesh):
        if name == "nemotron":
            sample = ops.sample_logits

            def recording(z, seeds, inv_temp, **kw):
                tok, lp = sample(z, seeds, inv_temp, **kw)
                drawn.append((z.clone(), inv_temp.clone(), tok.clone()))
                return tok, lp
            with patched(ops, "sample_logits", recording):
                gen_tp = rollout.generate(model, serve, prompt,
                                          torch.Generator(device=DEV).manual_seed(5),
                                          max_new=new, temperature=TOP_P_TEMPERATURE,
                                          top_p=TOP_P)
        elif not cfg.is_encoder_decoder:
            gen_tp = rollout.generate(model, serve, prompt,
                                      torch.Generator(device=DEV).manual_seed(5),
                                      max_new=TP20_SAMPLED, temperature=0.0, **extra)
    sampler_launches = dict(_build.LAUNCHES)
    # ---- seamless: one loss and gradient ----
    grads = None
    if cfg.is_encoder_decoder:
        labels = torch.cat([prompt[:, 1:], torch.full((Bs, 1), -1, dtype=torch.int32,
                                                      device=DEV)], dim=1)
        batch = {"frames": extra["frames"], "tokens": prompt, "labels": labels}
        with constraint.use_mesh(mesh):
            (loss_t, _), g_t = trainer.value_and_grad(lambda p: model.loss(p, batch), train)
        grads = trainer.gather_params(mesh, g_t, train_specs)
        del g_t
    out = {"batch": Bs, "prompt": L, "prefix": P, "new": new, "layers": cfg.num_layers,
           "launches": launches, "sampler_launches": sampler_launches,
           "held_to_plain": held, "prefill_ms": prefill_ms, "decode_step_ms": step_ms}
    if rank:
        return dict(out, held=True, failed=[])
    # ---- the readings, on rank 0 ----
    failed = []

    def hold(ok, what):
        if not ok:
            failed.append(what)

    n_routes = len(solo["routes"])
    moe_layers = sum(k[1] == "moe" for k in cfg.layer_kinds())

    def flips(j, other):
        """Rows of step j (0: the prefill's last position) whose route in
        ``other`` differs from the solo run's in any MoE layer."""
        rows = torch.zeros(Bs, dtype=torch.bool, device=DEV)
        for m in range(moe_layers):
            a, b = solo["routes"][j * moe_layers + m], other[j * moe_layers + m]
            if j == 0:  # the prefill routes every position: its last
                a, b = a.reshape(Bs, -1, a.shape[-1])[:, -1], b.reshape(Bs, -1, b.shape[-1])[:, -1]
            rows |= (a != b).any(dim=-1)
        return rows

    require(n_routes == len(routes_steps) == len(solo["plain_routes"]),
            f"tp20 {name}: {n_routes} routings solo, {len(routes_steps)} on the mesh, "
            f"{len(solo['plain_routes'])} on the plain path")

    def row_err(a, b, keep):
        e = (a - b).abs().amax(dim=-1)
        return float(e[keep].max()) if bool(keep.any()) else 0.0

    step_errs, drifts, flipped, parted = [], [], 0, []
    for j, (a, b, c) in enumerate(zip(steps_tp, solo["steps"], solo["plain_steps"])):
        a, b, c = a[:, :V].float(), b[:, :V].float(), c[:, :V].float()
        keep = ~flips(j, routes_steps) & ~flips(j, solo["plain_routes"])
        flipped += int((~keep).sum())
        scale = float(b.abs().max())
        step_errs.append(row_err(a, b, keep) / scale)
        drifts.append(row_err(c, b, keep) / scale)
        top2 = b.topk(2, dim=-1).values
        must = keep & ((top2[:, 0] - top2[:, 1]) > TP20_GAP)
        if not bool((a.argmax(-1) == b.argmax(-1))[must].all()):
            parted.append(j)
    step_limit = max(BF16_TOL, DRIFT_FACTOR * max(drifts))
    hold(step_errs[0] <= BF16_TOL, "prefill logits")
    hold(0 not in parted, "first tokens")
    hold(max(step_errs) <= step_limit, "decode step logits")
    # every layer on the solo run's input of that layer: an MoE layer's
    # tokens whose route differs from the solo run's are left out (the
    # attention's roundings move a token whose k-th and (k+1)-th router
    # logits lie that close), and counted
    layer_errs, layer_flips = [], []
    for i, got in enumerate(layer_out):
        want = solo["io"][i][1]
        keep = torch.ones(got.shape[:2], dtype=torch.bool, device=DEV)
        if cfg.layer_kinds()[i][1] == "moe":
            m = sum(k[1] == "moe" for k in cfg.layer_kinds()[:i])
            keep = ~(solo["routes"][m] != routes_layers[m]).any(dim=-1).reshape(got.shape[:2])
        layer_flips.append(int((~keep).sum()))
        layer_errs.append(row_err(got.float(), want.float(), keep)
                          / float(want.float().abs().max()))
    hold(all(e <= BF16_TOL for e in layer_errs), "layer by layer")
    W = solo["cache0"]["k"].shape[1]
    cache_errs = {k: float((cache0[k][:, :W].float() - solo["cache0"][k].float()).abs().max())
                  / float(solo["cache0"][k].float().abs().max()) for k in ("k", "v")}
    padding = {k: int(bool(cache0[k][:, W:].any())) for k in ("k", "v")}
    hold(max(cache_errs.values()) <= BF16_TOL and not any(padding.values()),
         "first layer's cache")
    out.update(step_rel_errs_max=max(step_errs), prefill_rel_err=step_errs[0],
               plain_drift_rel_max=max(drifts), step_limit=step_limit,
               steps_argmax_parted=len(parted), first_parted_steps=parted[:8],
               route_flipped_rows=flipped, layer_rel_errs=layer_errs,
               layer_route_flipped_tokens=layer_flips,
               cache_rel_errs=cache_errs, cache_slots=[W, cache0["k"].shape[1]],
               nonzero_padding=padding)
    if name == "nemotron":
        inside = sum(int(ref.nucleus(lm.mask_padded_vocab(cfg, z) * it[:, None], TOP_P)
                         .gather(1, tok[:, None].long()).sum()) for z, it, tok in drawn)
        draws = sum(int(t.numel()) for _, _, t in drawn)
        with torch.inference_mode():
            gen_one = rollout.generate(model, full, prompt,
                                       torch.Generator(device=DEV).manual_seed(5),
                                       max_new=new, temperature=TOP_P_TEMPERATURE, top_p=TOP_P)
        hold(len(drawn) == new - 1 and inside == draws == Bs * (new - 1), "top_p nucleus")
        hold(sampler_launches["fused_sample"] == 0, "top_p launches no fused_sample")
        out["top_p"] = {"top_p": TOP_P, "temperature": TOP_P_TEMPERATURE, "draws": draws,
                        "inside_nucleus": inside, "gathered_width": int(drawn[0][0].shape[1]),
                        "rows_equal_solo": int((gen_tp.tokens == gen_one.tokens).all(1).sum())}
    elif not cfg.is_encoder_decoder:
        hold(sampler_launches["fused_sample"] == TP20_SAMPLED - 1, "the sharded sampler")
        resp = gen_tp.tokens[:, L:]
        out["sampled"] = {"tokens": TP20_SAMPLED,
                          "equal_solo_prefix": int((resp == forced[:, :TP20_SAMPLED])
                                                   .all(1).sum())}
    if cfg.is_encoder_decoder:
        # the memory within DRIFT_FACTOR x the larger drift of two equally
        # valid roundings: the plain path against the kernel path and
        # against its fp32-attention self
        mem = solo["memory"].float()
        m_err = float((memory.float() - mem).abs().max())
        m_drift = max(float((solo["memory_plain"].float() - mem).abs().max()),
                      float((solo["memory_fp32"].float()
                             - solo["memory_plain"].float()).abs().max()))
        hold(m_err <= DRIFT_FACTOR * m_drift, "encoder memory")
        (loss_k, _), g_k = trainer.value_and_grad(lambda p: model.loss(p, batch), full)
        ops.set_mode("ref")
        try:
            (loss_r, _), g_r = trainer.value_and_grad(lambda p: model.loss(p, batch), full)
            with fp32_attention(ref):
                (loss_v, _), g_v = trainer.value_and_grad(lambda p: model.loss(p, batch), full)
        finally:
            ops.set_mode(None)
        bad, rule = tp20_drift_rule(leaf_names(grads), grads, g_k, g_r, g_v, ("cross_attn.b_k",))
        # the loss within 2e-2 of the solo run's, as phase 14 holds it to
        # the plain path's; its ratio to the fp32-attention drift reported
        loss_err = abs(float(loss_t) - float(loss_k))
        hold(loss_err <= BF16_TOL * abs(float(loss_k)), "seamless loss")
        hold(not bad, "seamless gradient")
        out["seamless"] = {"memory_max_abs_err": m_err, "memory_drift": m_drift,
                           "memory_max_abs": float(mem.abs().max()),
                           "loss_tp": float(loss_t), "loss_solo": float(loss_k),
                           "loss_plain": float(loss_r),
                           "loss_plain_fp32_attention": float(loss_v),
                           "loss_err_over_drift": loss_err / max(abs(float(loss_v)
                                                                   - float(loss_r)), 1e-30),
                           "gradient": rule}
        del g_k, g_r, g_v, grads
    out["records"] = path_records(torch, ops, ref, F, calls, f"tp20/{name}_rank0")
    out["arm_s"] = time.perf_counter() - t_arm
    return dict(out, held=not failed, failed=failed)


def tp20_phase(torch, _build, records, label="tp20", faults=()):
    """Phase 20: tensor-parallel model stages of the remaining families, in
    one (data 1, model 2) world of two ``chip_smoke.py --tp-rank`` processes
    on ``cuda:0`` (one gloo group). Arm A: gemma-2b at full width on
    TP20_LAYERS layers with the int8 KV cache (phase 8's experiment file,
    ``kv_quant`` on) through ``launch.train --coordinator 127.0.0.1:PORT``,
    TP20_ITERS GRPO iterations against its solo run in this process, held as
    in phase 18 (launches an iteration equal the solo run's; metrics,
    displacement, replicas, a fixed batch's gradient, logprobs) with each
    rank's warm-up iteration held to plain (``decode_attention_quant`` on
    the rank's slot shard among them), then each rank's int8 prefill cache
    bit for bit the quantization of the gathered K/V (``tp20_int8``). Arm B:
    in the same ranks, the pipeline freed, ``tp20_arm`` for each model of
    TP20_ARMS in turn. ``faults`` (names of TP20_FAULTS) runs the world
    again with each fault planted (arm A, and the arm B model the fault
    touches), prints its readings and fails unless some hold rejects it.
    The kernels' records at the new shapes join ``records`` (under
    ``"phase20"``). Returns {path: launch counts}."""
    from repro_torch import tree
    from repro_torch.api import ExperimentSpec
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    work = ROOT / "build" / "tp20"
    work.mkdir(parents=True, exist_ok=True)
    spec = json.loads(experiment_file(f"{label}_gemma", ARCH_FLAGS, PIPE_RL).read_text())
    spec["model"].update(num_layers=TP20_LAYERS, kv_quant=True)
    spec["distributed"] = {"num_hosts": 1, "exchange_timeout_s": 600.0, "dead_after_s": 120.0}
    solo_path = work / "solo_experiment.json"
    solo_path.write_text(json.dumps(spec))
    spec["mesh_shape"] = [1, TP_RANKS]
    tp_path = work / "tp_experiment.json"
    tp_path.write_text(json.dumps(spec))
    solo_params = work / "solo_params.pt"
    # the solo run in this process, each iteration synchronised with its
    # launches; its final params saved for the ranks to be held against
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with observed_iterations(torch, _build) as seen:
        res = train.main(["--experiment", str(solo_path), "--device", DEV, "--iters",
                          str(TP20_ITERS), "--num-hosts", "1"])
    torch.save([t.cpu() for t in tree.leaves(res["pipeline"].ctx.actor_state.params)],
               solo_params)
    solo = {"history": [{k: float(v) for k, v in m.items()} for m in res["history"]],
            "iterations": [{"ms": r["ms"], "launches": r["launches"]}
                           for r in seen["iterations"]],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del res, seen
    gc.collect()
    torch.cuda.empty_cache()

    def world(arm, fault=None, arms=tuple(TP20_ARMS)):
        return run_hosts(label, arm, tp_world_args(
            work, arm, tp_path, solo_params, TP20_ITERS, fault=fault, sampler=False,
            extra={"tp20": list(arms), "held": list(TP20_HELD)}), mode="--tp-rank")

    try:
        arts = world("rank")
        fault_arts = {f: world(f"fault_{f}", f, [a for a in (TP20_FAULTS[f],) if a])
                      for f in faults}
    finally:
        solo_params.unlink(missing_ok=True)

    def clean(history):
        return [{k: v for k, v in m.items() if not k.startswith("time/")} for m in history]

    exp = ExperimentSpec.from_json(tp_path.read_text())
    limits = {"min_cosine": TP_MIN_COSINE, "max_rel_distance": TP_MAX_REL_DISTANCE,
              "metric_rtol": TP_METRIC_RTOL, "max_replica_diff": TP_MAX_REPLICA_DIFF,
              "max_grad_rel_err": TP_MAX_GRAD_REL_ERR, "logprob_tol": BF16_TOL}

    def readings(ranks):
        """(held, the failed holds, the readings) of one world's ranks."""
        held, vs = tp_readings(ranks, solo["history"], limits)
        failed = [] if held else ["arm A against the solo run"]
        if not all(a["int8"]["equal"] for a in ranks):
            failed.append("arm A int8 cache")
        for name, arm in ranks[0]["arms"].items():
            failed += [f"{name}: {f}" for f in arm["failed"]]
        return not failed, failed, vs

    counts, out = {}, {"layers": TP20_LAYERS, "ranks": TP_RANKS, "mesh": [1, TP_RANKS],
                       "arms": {}}
    for r, a in enumerate(arts):
        require(a["backend"] == "gloo" and a["mesh"] == {"data": 1, "model": TP_RANKS}
                and a["coords"]["model"] == r,
                f"{label} rank {r}: backend {a['backend']}, mesh {a['mesh']}, {a['coords']}")
        for i, (it, sit) in enumerate(zip(a["iterations"], solo["iterations"])):
            require(it["launches"] == sit["launches"],
                    f"{label} rank {r} iteration {i}: launches {it['launches']}, solo "
                    f"{sit['launches']}")
        require(all(a["iterations"][0]["launches"][n] == a["held"][n]["calls"] > 0
                    for n in TP20_HELD),
                f"{label} rank {r}: held calls {a['held']}, launches "
                f"{a['iterations'][0]['launches']}")
        st = a["stats"]
        require(st["bytes_through_controller"] == 0 and st["redistributions"] > 0,
                f"{label} rank {r}: buffer stats {st}")
        timed = a["iterations"][1:]
        row = {"rank": r, "params": a["params"], "local_params": a["local_params"],
               "iteration_ms": [it["ms"] for it in a["iterations"]],
               "timed_iteration_ms": statistics.median(it["ms"] for it in timed),
               "solo_iteration_ms": [it["ms"] for it in solo["iterations"]],
               "collectives_per_timed_iteration": {
                   k: {f: statistics.median(it["collectives"][k][f] for it in timed)
                       for f in ("calls", "ms", "bytes")} for k in ("all_reduce", "all_gather")},
               "peak_gib": a["peak_gib"], "solo_peak_gib": solo["peak_gib"],
               "peak_rss_gib": a["peak_rss_gib"], "launches": a["launches"],
               "held_to_plain": a["held"], "vs_solo": a["vs_solo"], "replicas": a["replicas"],
               "logprobs": a["logprobs"], "gradient": a["gradient"],
               "int8": {k: v for k, v in a["int8"].items() if k != "records"}}
        print(json.dumps({f"{label}_rank": row}), flush=True)
        counts[f"tp20_gemma_int8_rank{r}"] = a["launches"]
        for name, arm in a["arms"].items():
            # the forced steps' launches and the sampler's generate's
            counts[f"tp20_{name}_rank{r}"] = {k: v + arm["sampler_launches"][k]
                                              for k, v in arm["launches"].items()}
            print(json.dumps({f"{label}_arm": {"arm": name, "rank": r,
                                               **{k: v for k, v in arm.items()
                                                  if k != "records"}}}), flush=True)
    require(clean(arts[0]["history"]) == clean(arts[1]["history"]),
            f"{label}: the ranks' metrics differ")
    require(all(m["actor/grad_norm"] > 0 for m in arts[0]["history"]), f"{label}: a zero gradient")
    held, failed, vs = readings(arts)
    print(json.dumps({"check": f"{label}_against_the_solo_runs", "held": held, "failed": failed,
                      **vs, **limits}), flush=True)
    fault_held = {}
    for fault, fa in fault_arts.items():
        fault_held[fault], ffailed, fvs = readings(fa)
        print(json.dumps({"check": f"{label}_fault_{fault}_against_the_solo_runs",
                          "held": fault_held[fault], "failed": ffailed, **fvs}), flush=True)
    require(held, f"{label}: the tensor-parallel runs against the solo runs: {failed}")
    for fault, fheld in fault_held.items():
        require(not fheld, f"{label}: the holds do not reject the planted fault {fault}")
    rec0 = arts[0]
    kernel_recs = {"decode_attention_quant": rec0["int8"]["records"].get("decode_attention_quant",
                                                                          {})}
    for name, arm in rec0["arms"].items():
        for kname, by_shape in arm["records"].items():
            kernel_recs.setdefault(kname, {}).update(
                {f"{name}_{tag}": r for tag, r in by_shape.items()})
    for kname, by_shape in kernel_recs.items():
        records.setdefault(kname, {})["phase20"] = by_shape
    out["solo_history"] = solo["history"]
    out["history"] = arts[0]["history"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: out}), flush=True)
    return counts


# ---- phase 21: the continuous rollout engine on tensor-parallel ranks ----
# qwen2.5-7b at full width (28 heads padded to 32 on 4 KV heads: 16 query
# heads and 2 KV heads a rank; the untied 152,064-column head split by
# vocab) on TP21_LAYERS of its 28 layers, random bf16 weights from --seed 0,
# in a (data 1, model 2) world of two gloo ranks on cuda:0. A: GRPO through
# launch.train on the
# continuous engine, TP_ITERS iterations (one warm-up held to plain, two
# timed) against its solo run; the loader's prompts have 6 tokens, so each
# refill runs two chunks of TP21_CHUNK
TP21_LAYERS = 2
TP21_SLOTS = 8
TP21_CHUNK = 4
TP21_HELD = ("rmsnorm", "flash_attention", "decode_attention", "fused_sample_shard")
# B, on the same ranks: the fixed schedule (phase 3's B and prompt, TP21_NEW
# new tokens, per-row budgets) against lockstep generate; a chunked refill
# of TP21_CHUNK_B prompts of TP21_CHUNK_L tokens in chunks of TP21_CHUNK_C
# into caches of TP21_CHUNK_SMAX slots (96 a rank: the last chunk lands on
# rank 1) against whole-prompt prefill; the ragged arm (phase 11's inputs cut
# to TP21_RAGGED prompts and budgets of at most TP21_RAGGED_NEW, 8 slots,
# buckets and chunks of Q_BUCKET) against lockstep, one warm-up and one
# timed run each
TP21_NEW = 16
TP21_CHUNK_B, TP21_CHUNK_L, TP21_CHUNK_C, TP21_CHUNK_SMAX = 4, 128, 32, 192
TP21_RAGGED, TP21_RAGGED_NEW = 16, 64
# A is held against its solo run by phase 18's limits (TP_MIN_COSINE and
# the rest), which sit between the sound run and the planted faults of
# --tp-faults here too (on an H100 80GB HBM3 at 700 W: cosine 0.994 against
# 0.535 under chunk_own_prefix; PERF.md)
# faults planted for --tp-faults with --only-phase 21: a chunk attends only
# the prefix slots its own rank holds (the others read as zeros), and every
# rank writes the chunk's K/V at its local index instead of only the slot's
# owner at the slot's
TP21_FAULTS = ("chunk_own_prefix", "chunk_write_everywhere")
# C: one 3-turn dialog iteration through launch.train (phase 12's env
# flags) on the ranks against its solo run: the episodes and these counts
# exact
TP21_DIALOG_COUNTS = ("env/turns_mean", "rollout/turns", "rollout/tool_calls")


def tp21_own_prefix(c):
    """``lm._tp_gather_slots`` with every slot that another rank holds read
    as zeros (the ``chunk_own_prefix`` fault)."""
    import torch

    from repro_torch.distributed import constraint

    w, r = c.shape[1], constraint.tp_rank()
    out = torch.zeros((c.shape[0], w * constraint.tp_size()) + tuple(c.shape[2:]),
                      dtype=c.dtype, device=c.device)
    out[:, r * w:(r + 1) * w] = c
    return out


def tp21_write_everywhere(off, hi, w):
    """``lm._tp_chunk_span`` with every rank writing the chunk's positions
    at the local index of their position (the ``chunk_write_everywhere``
    fault)."""
    b = max(min(hi, w), off)
    return slice(off, b), slice(0, b - off)


def tp21_engine_readings(calls, max_new: int):
    """The continuous engine's calls of A's iterations (``observed_iterations``'
    ``engine``): the prompts' true lengths seen, the refills' chunks and the
    slot counts of each call."""
    out = []
    for call in calls:
        res, st = call["result"], call["stats"]
        Lp = res.tokens.shape[1] - max_new
        lens = (res.tokens[:, :Lp] != 0).sum(1)
        out.append({"prompt_width": Lp, "prompt_lengths": sorted(set(lens.tolist())),
                    "chunks_per_refill": -(-Lp // TP21_CHUNK),
                    **{k: st[k] for k in ("refills", "decode_steps", "bursts", "num_slots",
                                          "slot_occupancy", "tokens")}})
    return out


def tp21_direct(torch, mesh, cfg, serve, short: bool = False):
    """Part B of phase 21 on this rank, on A's serve shards, every call made
    on both ranks in the same order. The chunked refill of TP21_CHUNK_B
    prompts against whole-prompt ``prefill`` on the same ranks, every kernel
    call held to plain (the chunks' ``flash_attention`` at ``q_offset``
    against the gathered prefix kept for ``path_records``): the last chunk's
    logits within BF16_TOL of max |logit|, this rank's slot shard of the
    first layer's cache within BF16_TOL of its max. Unless ``short`` (a
    planted fault's run): the engine under a fixed schedule (one slot a
    prompt, one bucket), greedy and then sampled at 0.8 from one seed,
    against the ranks' lockstep ``generate``: tokens, masks and lengths bit
    for bit, logprobs within LOGPROB_TOL; then the ragged arm, the engine
    with chunked refills against lockstep, one warm-up and one timed run
    each (wall ms, response tokens/s, decode steps, slot occupancy). Returns
    {"held", "failed", the readings; on rank 0 "records"}."""
    import torch.nn.functional as F

    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.distributed import constraint
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import get_model
    from repro_torch.rl.rollout import generate
    from repro_torch.rl.rollout_engine import ContinuousRolloutEngine, lockstep_waste

    t0 = time.perf_counter()
    model, tok = get_model(cfg, device=DEV), ByteTokenizer()
    kw = dict(eos_id=tok.eos_id, pad_id=tok.pad_id)
    rank, failed, out = mesh.coords["model"], [], {}

    def hold(ok, what):
        if not ok:
            failed.append(what)

    def seed(s):
        return torch.Generator(device=DEV).manual_seed(s)

    # ---- the chunked refill against whole-prompt prefill ----
    prompt = torch.randint(tok.SPECIALS, 256 + tok.SPECIALS, (TP21_CHUNK_B, TP21_CHUNK_L),
                           generator=seed(21), device=DEV, dtype=torch.int32)
    names = ("rmsnorm", "flash_attention")
    with torch.inference_mode(), constraint.use_mesh(mesh):
        want, want_caches, _ = model.prefill(serve, prompt, smax=TP21_CHUNK_SMAX)
        caches = model.init_caches(TP21_CHUNK_B, TP21_CHUNK_SMAX)
        with held_to_plain(torch, ops, ref, names) as held, \
                first_calls(torch, ops, ("flash_attention",)) as calls:
            for off in range(0, TP21_CHUNK_L, TP21_CHUNK_C):
                logits, caches = model.prefill_chunk(serve, prompt[:, off:off + TP21_CHUNK_C],
                                                     caches, offset=off)
    V = cfg.vocab_size
    logit_err = (float((logits[:, :V] - want[:, :V]).abs().max())
                 / float(want[:, :V].abs().max()))
    cache_err = {k: float((caches[0][k].float() - want_caches[0][k].float()).abs().max())
                 / max(float(want_caches[0][k].float().abs().max()), 1e-30) for k in ("k", "v")}
    hold(logit_err <= BF16_TOL, "chunked refill logits")
    hold(max(cache_err.values()) <= BF16_TOL, "chunked refill cache shard")
    last = max(calls, key=lambda key: calls[key][1].get("q_offset", 0))
    out["chunked_refill"] = {"prompts": TP21_CHUNK_B, "prompt": TP21_CHUNK_L,
                             "chunk": TP21_CHUNK_C, "slots": TP21_CHUNK_SMAX,
                             "slots_a_rank": int(caches[0]["k"].shape[1]),
                             "logit_rel_err": logit_err, "cache_rel_err": cache_err,
                             "held_to_plain": held}
    del want, want_caches, caches, logits
    if rank == 0:
        out["records"] = path_records(torch, ops, ref, F, {last: calls[last]},
                                      "tp21/qwen_chunk_rank0")
    if short:
        return dict(out, held=not failed, failed=failed, direct_s=time.perf_counter() - t0)

    # ---- a fixed schedule is the ranks' lockstep generate, bit for bit ----
    _, ids = serve_mod.prompts(tok, B, PROMPT)
    prompt = torch.from_numpy(ids).to(DEV)
    budgets = torch.randint(1, TP21_NEW + 1, (B,), generator=torch.Generator().manual_seed(5),
                            dtype=torch.int32).to(DEV)
    out["parity"] = {}
    for temp in (0.0, 0.8):
        with torch.inference_mode(), constraint.use_mesh(mesh):
            lock = generate(model, serve, prompt, seed(Q_SEED), max_new=TP21_NEW,
                            temperature=temp, budgets=budgets, **kw)
            fixed = ContinuousRolloutEngine(model, max_new=TP21_NEW, temperature=temp,
                                            num_slots=B, **kw)
            got = fixed(serve, prompt, seed(Q_SEED), budgets=budgets)
        equal = all(torch.equal(getattr(got, f), getattr(lock, f))
                    for f in ("tokens", "response_mask", "lengths"))
        ok, lp_err = close(got.old_logprob, lock.old_logprob, LOGPROB_TOL)
        hold(equal and ok, f"fixed schedule at temperature {temp}")
        out["parity"][str(temp)] = {"bits_equal": equal, "old_logprob_max_abs_err": lp_err,
                                    "lengths": got.lengths.tolist(),
                                    "decode_steps": fixed.last_stats["decode_steps"]}

    # ---- the ragged arm: the engine with chunked refills against lockstep ----
    prompts, budgets, true_len = ragged_inputs(torch, tok, TP21_RAGGED, TP21_RAGGED_NEW)
    engine = ContinuousRolloutEngine(model, max_new=TP21_RAGGED_NEW, temperature=Q_TEMPERATURE,
                                     num_slots=TP21_SLOTS, prefill_bucket=Q_BUCKET,
                                     prefill_chunk=Q_BUCKET, **kw)
    arms = {"lockstep": lambda: generate(model, serve, prompts, seed(Q_SEED),
                                         max_new=TP21_RAGGED_NEW, temperature=Q_TEMPERATURE,
                                         budgets=budgets, **kw),
            "engine": lambda: engine(serve, prompts, seed(Q_SEED), budgets=budgets)}
    out["ragged"] = {"prompts": TP21_RAGGED, "true_prompt_tokens": int(true_len.sum()),
                     "budget_tokens": int(budgets.sum()), "max_new": TP21_RAGGED_NEW,
                     "slots": TP21_SLOTS, "bucket": Q_BUCKET, "chunk": Q_BUCKET, "arms": {}}
    for name, run in arms.items():
        with torch.inference_mode(), constraint.use_mesh(mesh):
            sync_ms(torch, run)
            res, wall = sync_ms(torch, run)
        lens = res.lengths
        hold(bool((lens >= 1).all() and (lens <= budgets).all()), f"ragged {name} lengths")
        n_tok = int(lens.sum())
        row = {"wall_ms": wall, "response_tokens": n_tok, "response_tok_per_s": n_tok / wall * 1e3}
        if name == "lockstep":
            waste = lockstep_waste(lens.cpu().numpy(), TP21_RAGGED_NEW)
            row.update(decode_steps=TP21_RAGGED_NEW - 1, slot_occupancy=1.0 - waste)
        else:
            row.update({k: engine.last_stats[k] for k in (
                "decode_steps", "bursts", "refills", "slot_occupancy", "padding_waste",
                "prefill_lane_tokens", "prefill_true_tokens")})
        out["ragged"]["arms"][name] = row
    return dict(out, held=not failed, failed=failed, direct_s=time.perf_counter() - t0)


def tp21_dialog(torch, _build, spec):
    """Part C of phase 21 on this rank: one 3-turn dialog iteration through
    ``launch.train`` on the experiment file ``spec["tp21"]["dialog"]``, the
    rank's own argv otherwise (the world is up already). Returns the
    iteration's metrics, its engine's counts, its launches and ms."""
    from repro_torch.launch import train

    argv = list(spec["argv"])
    argv[argv.index("--experiment") + 1] = spec["tp21"]["dialog"]
    argv[argv.index("--iters") + 1] = "1"
    _build.reset_launches()
    with observed_iterations(torch, _build) as seen:
        res = train.main(argv)
    call = seen["engine"][0]
    out = {"history": [{k: float(v) for k, v in m.items()} for m in res["history"]],
           "episodes": int(call["result"].lengths.shape[0]), "stats": call["stats"],
           "ms": seen["iterations"][0]["ms"], "launches": dict(_build.LAUNCHES)}
    del res, seen, call
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp21_phase(torch, _build, records, label="tp21", faults=()):
    """Phase 21: the continuous rollout engine on tensor-parallel ranks, two
    ``chip_smoke.py --tp-rank`` processes on ``cuda:0`` (one gloo group) of
    ``launch.train --coordinator 127.0.0.1:PORT --rollout-slots
    TP21_SLOTS`` on qwen2.5-7b at full width on TP21_LAYERS layers with
    ``mesh_shape`` [1, 2] and ``prefill_chunk`` TP21_CHUNK. The solo runs of
    A and C first, in this process. A: TP_ITERS GRPO iterations held as phase
    18's, but each iteration's launches against ``iteration_launches`` with
    the lockstep generate replaced by the engine's chunked refills and decode
    steps (its own ``rollout/refills`` and ``rollout/decode_steps``), and the
    warm-up's calls of TP21_HELD held to plain (the sampler's on the rank's
    vocab shard). B: ``tp21_direct``. C: ``tp21_dialog`` against its solo
    run, TP21_DIALOG_COUNTS and the episodes exact. ``faults`` (names of
    TP21_FAULTS) runs A and B's chunked refill again with each fault planted,
    and fails unless a hold rejects it. The chunked ``flash_attention``
    record joins ``records`` (under ``"phase21"``). Returns {path: launch
    counts}."""
    from repro_torch import tree
    from repro_torch.api import ExperimentSpec
    from repro_torch.launch import train
    from repro_torch.rl import algorithms

    t_phase = time.perf_counter()
    work = ROOT / "build" / "tp21"
    work.mkdir(parents=True, exist_ok=True)
    flags = ["--rollout-slots", str(TP21_SLOTS)]
    paths = {}
    for name, env_flags in (("qwen", []), ("dialog", MT_FLAGS)):
        spec = json.loads(experiment_file(f"{label}_{name}", QWEN_FLAGS + env_flags,
                                          PIPE_RL).read_text())
        spec["model"]["num_layers"] = TP21_LAYERS
        spec["rollout"].update(engine="continuous", num_slots=TP21_SLOTS,
                               prefill_chunk=TP21_CHUNK)
        spec["distributed"] = {"num_hosts": 1, "exchange_timeout_s": 600.0,
                               "dead_after_s": 120.0}
        paths[f"{name}_solo"] = work / f"{name}_solo_experiment.json"
        paths[f"{name}_solo"].write_text(json.dumps(spec))
        spec["mesh_shape"] = [1, TP_RANKS]
        paths[name] = work / f"{name}_tp_experiment.json"
        paths[name].write_text(json.dumps(spec))
    solo_params = work / "solo_params.pt"
    # the solo runs in this process, each iteration synchronised with its
    # launches; A's final params saved for the ranks to be held against
    solo = {}
    for name, iters in (("qwen", TP_ITERS), ("dialog", 1)):
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with observed_iterations(torch, _build) as seen:
            res = train.main(["--experiment", str(paths[f"{name}_solo"]), "--device", DEV,
                              "--iters", str(iters), "--num-hosts", "1", *flags])
        if name == "qwen":
            torch.save([t.cpu() for t in tree.leaves(res["pipeline"].ctx.actor_state.params)],
                       solo_params)
        solo[name] = {"history": [{k: float(v) for k, v in m.items()} for m in res["history"]],
                      "iterations": [{"ms": r["ms"], "launches": r["launches"]}
                                     for r in seen["iterations"]],
                      "episodes": int(seen["engine"][0]["result"].lengths.shape[0]),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del res, seen
        gc.collect()
        torch.cuda.empty_cache()

    def world(arm, fault=None):
        return run_hosts(label, arm, tp_world_args(
            work, arm, paths["qwen"], solo_params, TP_ITERS, fault=fault, sampler=False,
            extra={"tp21": {"dialog": str(paths["dialog"])}, "held": list(TP21_HELD)},
            flags=flags), mode="--tp-rank")

    try:
        arts = world("rank")
        fault_arts = {f: world(f"fault_{f}", f) for f in faults}
    finally:
        solo_params.unlink(missing_ok=True)

    exp = ExperimentSpec.from_json(paths["qwen"].read_text())
    cfg, max_new = exp.model, exp.rl.max_new_tokens
    per_iter, _ = iteration_launches(cfg, _build.LAUNCHES, max_new,
                                     algorithms.get_algorithm(exp.rl.algorithm).dag_factory())
    lockstep = forward_launches(cfg, _build.LAUNCHES, 1, max_new - 1)

    def expected(m, chunks):
        """An iteration's launches: the lockstep generate's replaced by the
        engine's chunked refills and decode steps."""
        engine = forward_launches(cfg, _build.LAUNCHES, int(m["rollout/refills"]) * chunks,
                                  int(m["rollout/decode_steps"]))
        return {n: per_iter[n] - lockstep[n] + engine[n] for n in per_iter}

    limits = {"min_cosine": TP_MIN_COSINE, "max_rel_distance": TP_MAX_REL_DISTANCE,
              "metric_rtol": TP_METRIC_RTOL, "max_replica_diff": TP_MAX_REPLICA_DIFF,
              "max_grad_rel_err": TP_MAX_GRAD_REL_ERR, "logprob_tol": BF16_TOL}

    def readings(ranks):
        """(held, the failed holds, the readings) of one world's ranks."""
        held, vs = tp_readings(ranks, solo["qwen"]["history"], limits)
        failed = [] if held else ["A against the solo run"]
        for a in ranks:
            failed += [f"rank {a['rank']} B: {f}" for f in a["direct"]["failed"]]
        return not failed, failed, vs

    def clean(history):
        """The metrics but the host clock's (the stages' and the engine's)."""
        return [{k: v for k, v in m.items() if not k.startswith("time/")
                 and k not in ("rollout/wall_s", "rollout/tokens_per_s")} for m in history]

    counts, out = {}, {"layers": TP21_LAYERS, "ranks": TP_RANKS, "mesh": [1, TP_RANKS],
                       "slots": TP21_SLOTS, "prefill_chunk": TP21_CHUNK,
                       "solo": {k: {f: v[f] for f in ("iterations", "peak_gib")}
                                for k, v in solo.items()}}
    held_calls = {n: ("fused_sample" if n == "fused_sample_shard" else n) for n in TP21_HELD}
    for r, a in enumerate(arts):
        require(a["backend"] == "gloo" and a["mesh"] == {"data": 1, "model": TP_RANKS}
                and a["coords"]["model"] == r,
                f"{label} rank {r}: backend {a['backend']}, mesh {a['mesh']}, {a['coords']}")
        for i, (it, m, e) in enumerate(zip(a["iterations"], a["history"], a["engine"])):
            want = expected(m, e["chunks_per_refill"])
            require(it["launches"] == want and e["chunks_per_refill"] >= 2,
                    f"{label} rank {r} iteration {i}: launches {it['launches']}, expected "
                    f"{want} ({e})")
        first = a["iterations"][0]["launches"]
        require(all(first[c] == a["held"][n]["calls"] > 0 for n, c in held_calls.items()),
                f"{label} rank {r}: held calls {a['held']}, launches {first}")
        st = a["stats"]
        require(st["bytes_through_controller"] == 0 and st["redistributions"] > 0,
                f"{label} rank {r}: buffer stats {st}")
        timed = a["iterations"][1:]
        row = {"rank": r, "params": a["params"], "local_params": a["local_params"],
               "iteration_ms": [it["ms"] for it in a["iterations"]],
               "timed_iteration_ms": statistics.median(it["ms"] for it in timed),
               "node_ms_median": {k[5:]: statistics.median(m[k] * 1e3 for m in a["history"][1:])
                                  for k in sorted(a["history"][0]) if k.startswith("time/")},
               "collectives_per_timed_iteration": {
                   k: {f: statistics.median(it["collectives"][k][f] for it in timed)
                       for f in ("calls", "ms", "bytes")} for k in ("all_reduce", "all_gather")},
               "peak_gib": a["peak_gib"], "peak_rss_gib": a["peak_rss_gib"],
               "launches": a["launches"], "engine": a["engine"], "held_to_plain": a["held"],
               "vs_solo": a["vs_solo"], "replicas": a["replicas"], "logprobs": a["logprobs"],
               "gradient": a["gradient"]}
        print(json.dumps({f"{label}_rank": row}), flush=True)
        print(json.dumps({f"{label}_direct": {"rank": r, **{k: v for k, v in a["direct"].items()
                                                           if k != "records"}}}), flush=True)
        counts[f"tp21_qwen_rank{r}"] = a["launches"]
    require(clean(arts[0]["history"]) == clean(arts[1]["history"]),
            f"{label}: the ranks' metrics differ")
    require(all(m["actor/grad_norm"] > 0 for m in arts[0]["history"]), f"{label}: a zero gradient")
    held, failed, vs = readings(arts)
    print(json.dumps({"check": f"{label}_against_the_solo_runs", "held": held, "failed": failed,
                      **vs, **limits}), flush=True)
    # C: the dialog iteration's counts against its solo run's
    dialogs = [a["dialog"] for a in arts]
    sm = solo["dialog"]["history"][0]
    counts_equal = all(d["episodes"] == solo["dialog"]["episodes"]
                       and all(d["history"][0][k] == sm[k] for k in TP21_DIALOG_COUNTS)
                       for d in dialogs)
    shown = TP21_DIALOG_COUNTS + ("rollout/cont_refills", "rollout/obs_tokens",
                                  "rollout/decode_steps")
    print(json.dumps({"check": f"{label}_dialog_counts_equal_the_solo_run", "held": counts_equal,
                      "episodes": [d["episodes"] for d in dialogs],
                      "solo": {k: sm[k] for k in shown},
                      "ranks": [{k: d["history"][0][k] for k in shown} for d in dialogs],
                      "iteration_ms": [d["ms"] for d in dialogs],
                      "solo_iteration_ms": solo["dialog"]["iterations"][0]["ms"]}), flush=True)
    fault_held = {}
    for fault, fa in fault_arts.items():
        fault_held[fault], ffailed, fvs = readings(fa)
        print(json.dumps({"check": f"{label}_fault_{fault}_against_the_solo_runs",
                          "held": fault_held[fault], "failed": ffailed, **fvs,
                          "direct": [{k: v for k, v in f["direct"].items() if k != "records"}
                                     for f in fa]}), flush=True)
    require(held, f"{label}: the tensor-parallel runs against the solo runs: {failed}")
    require(counts_equal, f"{label}: the dialog iteration's counts differ from the solo run's")
    for fault, fheld in fault_held.items():
        require(not fheld, f"{label}: the holds do not reject the planted fault {fault}")
    print(json.dumps({f"{label}_records": arts[0]["direct"]["records"]}), flush=True)
    for kname, by_shape in arts[0]["direct"]["records"].items():
        records.setdefault(kname, {})["phase21"] = by_shape
    out["history"] = arts[0]["history"]
    out["solo_history"] = solo["qwen"]["history"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: out}), flush=True)
    return counts


# ---- phase 22: the staleness-bounded async pipeline on a rank mesh ----
TP22_ITERS = 3  # A: one warm-up iteration, then two timed
TP22_B_ITERS = 4
# B at 2 layers took 3.5-4.3 s an iteration on an H100 80GB HBM3 at 700 W,
# over the 3 s it may take: its data-parallel step moves the params and the
# fp32 grads through gloo (PERF.md)
TP22_B_LAYERS = 1
# arm -> (experiment, flags on top of it); A's on a (1, 2) mesh, B's on (2, 1)
TP22_ARMS = {"sync": ("A", []), "s0": ("A", ["--max-staleness", "0"]),
             "s1": ("A", ["--max-staleness", "1"]),
             "tis": ("A_tis", ["--max-staleness", "1"]),
             "B": ("B", ["--max-staleness", "1"])}
# faults planted for --tp-faults with --only-phase 22, each with the arms that
# show it: the consume puts the popped keys back without their specs (on a
# mesh whose data axis splits the rows, a key then reads as held whole), and
# generation reads the live params instead of the published copy
TP22_FAULTS = {"async_spec_dropped": ("B",), "async_live_generation": ("s1",)}
# the scheduler's counts, exact and equal on both ranks
TP22_COUNTS = ("async/staleness", "async/weight_version", "async/is_corrected",
               "async/inflight", "pipeline/staleness")


@contextlib.contextmanager
def observed_consumes(torch, model, colls):
    """While open, every ``consume_and_train`` of the async worker records
    whether the actor step trained on the rows its batch was dispatched with
    (this rank's tokens, bit for bit), and for a corrected batch the
    truncated-IS recompute against ``model.logprobs`` on one device, on the
    live params gathered whole and the same tokens: the largest
    |difference| over the response tokens, and the check's synchronised ms
    (``check_ms``; its gather is not counted in ``colls``, the
    ``observed_collectives`` record; its launches are not counted). Yields
    the list of records, the last one's tokens kept."""
    from repro_torch import tree
    from repro_torch.core.async_worker import AsyncDAGWorker
    from repro_torch.kernels import _build
    from repro_torch.rl import algorithms, trainer

    seen = []
    consume = AsyncDAGWorker.consume_and_train

    def consume_checked(self, metrics=None):
        pending = self._inflight[0] if self._inflight else None
        if pending is None:
            return consume(self, metrics)
        ctx = self.ctx
        engines = dict(ctx.engines)
        rec = {"dispatched_rows": int(pending.data["tokens"].shape[0])}
        tokens = pending.data["tokens"].clone()
        live = None
        if (algorithms.resolve(ctx).is_correction == "truncated"
                and self.weights.version > pending.behavior_version):
            # every rank takes part in the gather: the ranks consume alike
            colls["paused"] = True
            # a copy: the leaves no axis splits come back as the live tensors
            # themselves, which the step then writes in place
            live, rec["check_ms"] = sync_ms(torch, lambda: tree.map(torch.clone, (
                trainer.gather_params(ctx.mesh, ctx.actor_state.params, ctx.param_specs))))
            colls["paused"] = False

        def step(state, batch):
            rec["step_rows"] = int(batch["tokens"].shape[0])
            rec["step_is_the_batch"] = bool(torch.equal(batch["tokens"], tokens))
            return engines["actor_step"](state, batch)

        def logprobs(params, toks):
            lp, ent = engines["logprobs"](params, toks)
            rec["recomputed"] = lp.detach().clone()
            return lp, ent

        ctx.engines["actor_step"], ctx.engines["logprobs"] = step, logprobs
        try:
            out = consume(self, metrics)
        finally:
            ctx.engines["actor_step"], ctx.engines["logprobs"] = (engines["actor_step"],
                                                                 engines["logprobs"])
        if "recomputed" in rec:
            counted = dict(_build.LAUNCHES)
            with torch.no_grad():
                (want, _), ms = sync_ms(torch, lambda: model.logprobs(live, tokens))
            _build.LAUNCHES.update(counted)
            rec["check_ms"] += ms
            mask = pending.data["response_mask"].bool()
            got = rec.pop("recomputed")
            ok, err = close(got[mask], want[mask], BF16_TOL)
            rec["recompute"] = {"held": ok, "max_abs_err": err, "tokens": int(mask.sum())}
        del live
        for r in seen:
            r.pop("tokens", None)
        rec["tokens"] = tokens
        seen.append(rec)
        return out

    AsyncDAGWorker.consume_and_train = consume_checked
    try:
        yield seen
    finally:
        AsyncDAGWorker.consume_and_train = consume


def tp22_trainer_ahead(torch, pipe):
    """After an A arm at staleness 1 (one batch still queued): one actor step
    on the live state that the scheduler does not publish (a trainer running
    ahead of generation), then one dispatch. Returns whether that dispatch
    generated on the published copy, which the in-place step did not reach,
    and not on the live params, which it moved (``pick_leaf`` of each)."""
    from repro_torch.distributed import constraint

    w, ctx = pipe.worker, pipe.ctx
    p = w._inflight[0]
    keys = ("tokens", "response_mask", "old_logprob", "ref_logprob", "advantages")
    with constraint.use_mesh(ctx.mesh):
        batch = {k: w._rows(p.data, p.specs, k, w._model_spec()) for k in keys}
        ctx.actor_state, _ = ctx.engines["actor_step"](ctx.actor_state, batch)
    ctx.drop_switched()
    del batch
    published = pick_leaf(w.weights.current.params).clone()
    live = pick_leaf(ctx.actor_state.params).clone()
    with observed_versions(torch) as versions:
        w.dispatch_generation({})
    ran = versions["ran"][0]
    return {"behaviour_version": versions["behaviour"][0][0],
            "live_moved": not torch.equal(live, published),
            "ran_equals_published": torch.equal(ran, published),
            "ran_differs_from_live": not torch.equal(ran, live)}


def tp22_rank(torch, args_path: str) -> int:
    """The body of ``chip_smoke.py --tp22-rank ARGS``: rank r of phase 22's
    world on the card. ARGS is a json file {"argv", "files", "arms",
    "artifact", "rank", "fault"}. Each arm of TP22_ARMS in ``"arms"`` runs
    ``launch.train.main`` on its experiment file (A: (1, 2); B: (2, 1)) in
    this one world, inside ``observed_iterations``,
    ``observed_collectives``, ``observed_versions`` and ``observed_consumes``,
    the launch counters at 0 and the peak reset before it. Then per arm: the
    history, each iteration's ms, launches and collectives, the publish ms,
    the peak, a bit checksum of the rank's final shards (and, for B, of the
    params gathered whole), the rollouts' equality with the sync arm's, the
    versions each dispatch ran, the consumes' rows and recomputes; after s1
    ``tp22_trainer_ahead``; after B the last consumed batch's logprobs on
    this rank's rows against the one-device model on the gathered params.
    With ``"fault"`` (one of TP22_FAULTS) the fault is planted for every arm.
    Writes the artifact."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.api import ExperimentSpec
    from repro_torch.core.async_worker import AsyncDAGWorker
    from repro_torch.distributed import constraint
    from repro_torch.distributed.weight_sync import VersionedWeights
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.rl import algorithms, trainer

    spec = json.loads(Path(args_path).read_text())
    fault = spec.get("fault")
    algorithms.register_algorithm(dataclasses.replace(
        algorithms.get_algorithm("grpo"), name=TIS_ALGORITHM, is_correction="truncated"),
        override=True)
    patches = []
    if fault == "async_spec_dropped":
        consume = AsyncDAGWorker.consume_and_train

        def dropped(self, metrics=None):
            for p in self._inflight:
                p.specs.clear()
            return consume(self, metrics)
        patches.append((AsyncDAGWorker, "consume_and_train", dropped))
    elif fault == "async_live_generation":
        behavior = AsyncDAGWorker._behavior_weights

        def live(self):
            out = behavior(self)
            return VersionedWeights(params=self.ctx.actor_state.params, version=out.version)
        patches.append((AsyncDAGWorker, "_behavior_weights", live))
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    art = {"rank": spec["rank"], "fault": fault, "arms": {}}
    sync = {}
    try:
        for arm in spec["arms"]:
            file_key, flags = TP22_ARMS[arm]
            argv = list(spec["argv"])
            argv[argv.index("--experiment") + 1] = spec["files"][file_key]
            if arm == "B":
                argv[argv.index("--iters") + 1] = str(TP22_B_ITERS)
            exp = ExperimentSpec.from_json(Path(spec["files"][file_key]).read_text())
            model = get_model(exp.model, device=DEV)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t_arm = time.perf_counter()
            with contextlib.ExitStack() as stack:
                seen = stack.enter_context(observed_iterations(torch, _build))
                colls = stack.enter_context(observed_collectives(torch))
                versions = stack.enter_context(observed_versions(torch))
                consumes = stack.enter_context(observed_consumes(torch, model, colls))
                res = train.main(argv + flags)
            run_s = time.perf_counter() - t_arm
            pipe = res["pipeline"]
            ctx, mesh = pipe.ctx, pipe.ctx.mesh
            checks = iter([c.get("check_ms", 0.0) for c in consumes])
            a = {"mesh": mesh.shape, "coords": mesh.coords, "run_s": run_s,
                 "iteration_ms_less_check": [
                     r["ms"] - (next(checks, 0.0) if "actor/loss" in m else 0.0)
                     for r, m in zip(seen["iterations"], res["history"])],
                 "launches": dict(_build.LAUNCHES),
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "history": [{k: float(v) for k, v in m.items()} for m in res["history"]],
                 "iterations": [{"ms": r["ms"], "launches": r["launches"], "collectives": c}
                                for r, c in zip(seen["iterations"], colls["iters"])],
                 "publish_ms": versions["publish_ms"],
                 "checksum": bit_checksum(torch, ctx.actor_state.params),
                 "local_params": sum(t.numel() for t in tree.leaves(ctx.actor_state.params)),
                 "consumes": [{k: v for k, v in c.items() if k != "tokens"} for c in consumes],
                 "stats": dataclasses.asdict(pipe.buffer.stats)}
            tokens = [t.clone() for t in seen["tokens"]]
            if arm == "sync":
                sync["tokens"] = tokens
            else:
                a["rollouts_equal_sync"] = (len(tokens) == len(sync.get("tokens", ()))
                                            and all(torch.equal(x, y) for x, y in
                                                    zip(tokens, sync["tokens"])))
            if arm in ("s1", "tis", "B"):
                # each dispatch t >= 1 ran the copy published at the update
                # before it, unchanged by the in-place steps since, and unlike
                # the live leaf after the tick's update
                after = dict(versions["live_after_update"])
                checks = []
                for t, ((version, now), ran) in enumerate(zip(versions["behaviour"],
                                                              versions["ran"])):
                    if t == 0:
                        continue
                    saved = versions["published"][version]
                    checks.append({"tick": t, "behaviour_version": version,
                                   "ran_equals_saved": torch.equal(ran, saved),
                                   "snapshot_unchanged": torch.equal(now, saved),
                                   "differs_from_live": (t not in after
                                                         or not torch.equal(now, after[t]))})
                a["versions"] = checks
            if arm == "s1":
                a["trainer_ahead"] = tp22_trainer_ahead(torch, pipe)
            if arm == "B":
                full = trainer.gather_params(mesh, ctx.actor_state.params, ctx.param_specs)
                a["gathered_checksum"] = bit_checksum(torch, full)
                rows = consumes[-1]["tokens"]
                with torch.no_grad():
                    with constraint.use_mesh(mesh):
                        lp_tp, _ = model.logprobs(ctx.model_params(), rows)
                    lp_one, _ = model.logprobs(full, rows)
                ok, err = close(lp_tp[:, 1:], lp_one[:, 1:], BF16_TOL)
                a["logprobs"] = {"held": ok, "max_abs_err": err, "shape": list(rows.shape)}
                del full, lp_tp, lp_one
            art["arms"][arm] = a
            del res, pipe, ctx, seen, versions, consumes, tokens, model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for obj, name, value in originals:
            setattr(obj, name, value)
    art["backend"] = dist.get_backend()  # the world the first arm's launch.train started
    Path(spec["artifact"]).write_text(json.dumps(art))
    return 0


def tp22_phase(torch, _build, records, label="tp22", faults=()):
    """Phase 22: the staleness-bounded async pipeline on a rank mesh. Two
    ``chip_smoke.py --tp22-rank`` processes on ``cuda:0`` (one gloo group),
    each running every arm of TP22_ARMS through ``launch.train --coordinator
    127.0.0.1:PORT --num-hosts 2 --process-id r`` in the one world
    (``tp22_rank``). A: phase 18's experiment (gemma-2b at full width on
    FLEET_LAYERS layers) on a (1, 2) mesh, TP22_ITERS iterations synchronous,
    at ``--max-staleness`` 0 and 1, and at 1 under phase 12's truncated-IS
    algorithm. B: granite-moe-3b-a800m at full width on TP22_B_LAYERS layers
    on a (2, 1) mesh (the data axis splits the rows), TP22_B_ITERS iterations
    at staleness 1. Held, every hold hard:

    - A at staleness 0: every iteration's metrics (the clock's and the
      scheduler's own aside), the rollouts and each rank's final shards (a
      bit checksum) equal the synchronous arm's;
    - every async arm: the staleness and the weight versions exact and
      equal on both ranks, each dispatch from the second on generated on the
      copy published at the update before it, which no in-place step
      changed; after s1, a step the scheduler does not publish, then a
      dispatch: it generates on the published copy, not the live params;
    - tis: each corrected batch's recomputed ``old_logprob`` within BF16_TOL
      of the one-device model on the live params gathered whole;
    - every consume: the step trains on the rows its batch was dispatched
      with (this rank's, bit for bit);
    - launches: every A iteration the synchronous arm's, less the actor
      step in a tick that only generates, plus a forward where a batch is
      corrected; every B iteration ``iteration_launches`` of granite, so;
    - B: the params that the ranks gather bit for bit equal, and the last
      consumed batch's logprobs on each rank's rows within BF16_TOL of the
      one-device model on the gathered params and rows.

    ``faults`` (names of TP22_FAULTS) runs the world again with each fault
    planted, in the arms that show it, and fails unless a hold rejects it.
    Prints per arm and rank the iteration ms (median after the warm-up), the
    publish ms, the collectives an iteration, the peak GiB, then ``phase_s``.
    Returns {path: launch counts}."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.rl import algorithms

    t_phase = time.perf_counter()
    work = ROOT / "build" / "tp22"
    work.mkdir(parents=True, exist_ok=True)
    files = {}
    for key, (flags, layers, shape, algo) in {
            "A": (ARCH_FLAGS, FLEET_LAYERS, [1, TP_RANKS], None),
            "A_tis": (ARCH_FLAGS, FLEET_LAYERS, [1, TP_RANKS], TIS_ALGORITHM),
            "B": (GRANITE_FLAGS, TP22_B_LAYERS, [TP_RANKS, 1], None)}.items():
        spec = json.loads(experiment_file(f"{label}_{key}", flags, PIPE_RL, layers).read_text())
        spec["mesh_shape"] = shape
        if algo is not None:
            spec["rl"]["algorithm"] = algo
        files[key] = work / f"{key}_experiment.json"
        files[key].write_text(json.dumps(spec))

    def world(name, arms, fault=None):
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        host_args = []
        for r in range(TP_RANKS):
            args = work / f"{name}{r}.args.json"
            args.write_text(json.dumps({
                "argv": ["--experiment", "", "--device", DEV, "--iters", str(TP22_ITERS),
                         "--num-hosts", str(TP_RANKS), "--process-id", str(r),
                         "--coordinator", f"127.0.0.1:{port}"],
                "files": {k: str(v) for k, v in files.items()}, "arms": list(arms),
                "artifact": str(work / f"{name}{r}.artifact.json"), "rank": r,
                "fault": fault}))
            host_args.append((args, work / f"{name}{r}.log"))
        return run_hosts(label, name, host_args, mode="--tp22-rank", refill=False)

    arts = world("rank", TP22_ARMS)
    fault_arts = {f: world(f"fault_{f}", TP22_FAULTS[f], f) for f in faults}

    def launches_of(key):
        exp = ExperimentSpec.from_json(files[key].read_text())
        dag = algorithms.get_algorithm("grpo").dag_factory()
        per_iter, step = iteration_launches(exp.model, _build.LAUNCHES, exp.rl.max_new_tokens,
                                            dag)
        return per_iter, step, forward_launches(exp.model, _build.LAUNCHES, 1, 0)

    expected = {"A": launches_of("A"), "B": launches_of("B")}

    def counts_of(history):
        return [{k: m.get(k) for k in TP22_COUNTS} for m in history]

    def clean(history):
        return [{k: v for k, v in m.items() if not k.startswith(("time/", "async/"))
                 and k != "pipeline/staleness"} for m in history]

    def readings(ranks):
        """(the failed holds, per arm the readings) of one world's ranks."""
        failed, out = [], {}
        for arm in ranks[0]["arms"]:
            per = [r["arms"][arm] for r in ranks]
            a0 = per[0]
            n = len(a0["history"])
            rd = {"iterations": n,
                  "counts": counts_of(a0["history"]),
                  "counts_equal_on_ranks": all(counts_of(a["history"]) == counts_of(
                      a0["history"]) for a in per),
                  "metrics_equal_on_ranks": all(clean(a["history"]) == clean(a0["history"])
                                                for a in per),
                  "steps_on_their_rows": all(c["step_is_the_batch"]
                                             and c["step_rows"] == c["dispatched_rows"]
                                             for a in per for c in a["consumes"])}
            if arm == "sync":
                rd["trains"] = all("actor/loss" in m for m in a0["history"])
            else:
                w = 0 if arm == "s0" else 1
                stale = [m.get("async/staleness") for m in a0["history"]]
                want = ([0.0] * n if w == 0 else [None] + [float(min(i, 1)) for i in range(n - 1)])
                rd["staleness_exact"] = stale == want
                ver = [m.get("async/weight_version") for m in a0["history"]]
                rd["versions_exact"] = ver == ([float(i + 1) for i in range(n)] if w == 0 else
                                               [None] + [float(i) for i in range(1, n)])
            if arm == "s0":
                sync = [r["arms"]["sync"] for r in ranks]
                rd["bitwise_sync"] = all(
                    clean(a["history"]) == clean(s["history"]) and a["rollouts_equal_sync"]
                    and a["checksum"] == s["checksum"] for a, s in zip(per, sync))
            if "versions" in a0:
                rd["versions_ran"] = [c for a in per for c in a["versions"]]
                rd["behaviour_copies_held"] = all(
                    c["behaviour_version"] == c["tick"] - 1 and c["ran_equals_saved"]
                    and c["snapshot_unchanged"] and c["differs_from_live"]
                    for c in rd["versions_ran"])
            if "trainer_ahead" in a0:
                rd["trainer_ahead"] = [a["trainer_ahead"] for a in per]
                rd["generates_on_the_published_copy"] = all(
                    t["live_moved"] and t["ran_equals_published"] and t["ran_differs_from_live"]
                    for t in rd["trainer_ahead"])
            if arm == "tis":
                rc = [c["recompute"] for a in per for c in a["consumes"] if "recompute" in c]
                rd["recomputes"] = rc
                rd["recompute_held"] = len(rc) == TP_RANKS * (n - 2) and all(
                    c["held"] for c in rc)
                rd["corrected"] = [m.get("async/is_corrected") for m in a0["history"]]
            if arm == "B":
                rd["gathered_equal_on_ranks"] = all(a["gathered_checksum"]
                                                    == a0["gathered_checksum"] for a in per)
                rd["logprobs"] = [a["logprobs"] for a in per]
                rd["logprobs_held"] = all(a["logprobs"]["held"] for a in per)
            # the launches of every iteration
            per_iter, step, fwd = expected["B" if arm == "B" else "A"]
            base = ([it["launches"] for it in ranks[0]["arms"]["sync"]["iterations"]]
                    if arm != "B" and "sync" in ranks[0]["arms"] else [per_iter] * n)
            ok = True
            for a in per:
                for i, (it, m) in enumerate(zip(a["iterations"], a["history"])):
                    want = dict(base[min(i, len(base) - 1)])
                    if "actor/loss" not in m:
                        want = {k: v - step.get(k, 0) for k, v in want.items()}
                    if m.get("async/is_corrected"):
                        want = {k: v + fwd.get(k, 0) for k, v in want.items()}
                    ok &= it["launches"] == want
            rd["launches_as_expected"] = ok
            holds = [k for k, v in rd.items() if isinstance(v, bool)]
            failed += [f"{arm}: {k}" for k in holds if not rd[k]]
            out[arm] = rd
        return failed, out

    failed, vs = readings(arts)
    counts, out = {}, {"A": {"layers": FLEET_LAYERS, "mesh": [1, TP_RANKS],
                             "iterations": TP22_ITERS},
                       "B": {"layers": TP22_B_LAYERS, "mesh": [TP_RANKS, 1],
                             "iterations": TP22_B_ITERS}}
    for r, art in enumerate(arts):
        require(art["backend"] == "gloo", f"{label} rank {r}: backend {art['backend']}")
        for arm, a in art["arms"].items():
            timed = a["iterations"][1:]
            row = {"arm": arm, "rank": r, "mesh": a["mesh"], "coords": a["coords"],
                   "iteration_ms": [it["ms"] for it in a["iterations"]],
                   "timed_iteration_ms": statistics.median(it["ms"] for it in timed),
                   "timed_iteration_ms_less_check": statistics.median(
                       a["iteration_ms_less_check"][1:]),
                   "publish_ms": a["publish_ms"],
                   "collectives_per_timed_iteration": {
                       k: {f: statistics.median(it["collectives"][k][f] for it in timed)
                           for f in ("calls", "ms", "bytes")}
                       for k in ("all_reduce", "all_gather")},
                   "peak_gib": a["peak_gib"], "local_params": a["local_params"],
                   "run_s": a["run_s"], "buffer_stats": a["stats"], "launches": a["launches"]}
            print(json.dumps({f"{label}_arm": row}), flush=True)
            counts[f"tp22_{arm}_rank{r}"] = a["launches"]
    print(json.dumps({"check": f"{label}_holds", "held": not failed, "failed": failed,
                      **vs}), flush=True)
    fault_failed = {}
    for fault, fa in fault_arts.items():
        fault_failed[fault], fvs = readings(fa)
        print(json.dumps({"check": f"{label}_fault_{fault}", "rejected": bool(fault_failed[fault]),
                          "failed": fault_failed[fault], **fvs}), flush=True)
    require(not failed, f"{label}: {failed}")
    for fault, ff in fault_failed.items():
        require(bool(ff), f"{label}: the holds do not reject the planted fault {fault}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({label: out}), flush=True)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--only-phase", type=int,
                    choices=[12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22],
                    default=None,
                    help="build the kernels, run this phase alone and stop, without "
                         "the kernels line and the last line (a quick check of one "
                         "phase; the full run takes no argument)")
    # one host of phase 16's fleet, started by fleet_phase
    ap.add_argument("--fleet-host", default=None, help=argparse.SUPPRESS)
    # one rank of phase 17's world, started by sharding_phase
    ap.add_argument("--shard-rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shard-faults", default="",
                    help="with --only-phase 17: comma-separated faults of SHARD_FAULTS to "
                         "plant in the grads' reduce-scatter after the sound run, each of "
                         "which phase 17's hold must reject (how its limits were set)")
    # one rank of phase 18's world, started by tp_phase
    ap.add_argument("--tp-rank", default=None, help=argparse.SUPPRESS)
    # one rank of phase 22's world, started by tp22_phase
    ap.add_argument("--tp22-rank", default=None, help=argparse.SUPPRESS)
    # a host or rank process started ahead of its arm, by pool_fill
    ap.add_argument("--pooled", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tp-faults", default="",
                    help="with --only-phase 18 (19, 20, 21, 22): comma-separated faults of "
                         "TP_FAULTS (TP19_FAULTS, TP20_FAULTS, TP21_FAULTS, TP22_FAULTS) to "
                         "plant in the tensor-parallel model or the async pipeline "
                         "after the sound run, each of which the phase's holds must reject "
                         "(how its limits were set)")
    opts = ap.parse_args(argv)
    faults = [f for f in opts.shard_faults.split(",") if f]
    if faults and (opts.only_phase != 17 or not set(faults) <= set(SHARD_FAULTS)):
        ap.error(f"--shard-faults takes {', '.join(SHARD_FAULTS)}, with --only-phase 17")
    tp_faults = [f for f in opts.tp_faults.split(",") if f]
    known = {18: TP_FAULTS, 19: tuple(TP19_FAULTS), 20: tuple(TP20_FAULTS),
             21: TP21_FAULTS, 22: tuple(TP22_FAULTS)}.get(opts.only_phase, ())
    if tp_faults and not set(tp_faults) <= set(known):
        ap.error(f"--tp-faults takes {', '.join(TP_FAULTS)} with --only-phase 18, "
                 f"{', '.join(TP19_FAULTS)} with --only-phase 19, "
                 f"{', '.join(TP20_FAULTS)} with --only-phase 20, "
                 f"{', '.join(TP21_FAULTS)} with --only-phase 21, or "
                 f"{', '.join(TP22_FAULTS)} with --only-phase 22")

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
    if opts.fleet_host is not None:
        return fleet_host(torch, opts.fleet_host)
    if opts.shard_rank is not None:
        return shard_rank(torch, opts.shard_rank)
    if opts.tp_rank is not None:
        return tp_rank(torch, opts.tp_rank)
    if opts.tp22_rank is not None:
        return tp22_rank(torch, opts.tp22_rank)
    if opts.pooled:
        return pooled(torch)

    t_start = time.perf_counter()
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

    if opts.only_phase is not None:
        phase = {12: lambda: async_phase(torch, ops, ref, _build),
                 13: lambda: moe_phase(torch, ops, ref, F, _build, serve, generate, {}),
                 14: lambda: families_phase(torch, ops, ref, F, _build, serve, generate, {}),
                 15: lambda: ckpt_phase(torch, ops, ref, _build),
                 16: lambda: fleet_phase(torch, _build),
                 17: lambda: sharding_phase(torch, _build, faults=faults),
                 18: lambda: tp_phase(torch, ops, ref, _build, {}, faults=tp_faults),
                 19: lambda: tp_moe_ssd_phase(torch, ref, F, _build, {}, faults=tp_faults),
                 20: lambda: tp20_phase(torch, _build, {}, faults=tp_faults),
                 21: lambda: tp21_phase(torch, _build, {}, faults=tp_faults),
                 22: lambda: tp22_phase(torch, _build, {}, faults=tp_faults)}
        counts = phase[opts.only_phase]()
        print(json.dumps({"only_phase": opts.only_phase, "launches": counts,
                          "script_s": time.perf_counter() - t_start}), flush=True)
        return 0

    # ---- phase 2: kernels against their plain versions ----
    records = kernel_phase(torch, ops, ref, F)

    # ---- phases 3 to 6: the serving paths end to end, each with the launch
    # counters set to 0 just before it and read just after ----
    model, params, tok = build_model(torch, serve)
    lockstep = end_to_end_phase(torch, ops, _build, serve, generate, model, params, tok)
    streaming = streaming_phase(torch, ops, _build, serve, model, params, tok)
    end_counts = {"lockstep": lockstep[0], "streaming": streaming[0]}
    # the int8 KV cache: the same gemma-2b weights with kv_quant on (no config
    # file and no serve flag turns it on: generate on the replaced config,
    # through serve.run_lockstep)
    from repro_torch.models import get_model

    int8_model = get_model(dataclasses.replace(model.cfg, kv_quant=True), device=DEV)
    int8 = end_to_end_phase(torch, ops, _build, serve, generate, int8_model, params, tok,
                            label="e2e_int8", profile_name="profile_int8.txt")
    end_counts["int8_lockstep"] = int8[0]
    jobs = [lockstep[2], streaming[2], int8[2]] if opts.profile else []
    del model, int8_model, params, lockstep, streaming, int8
    gc.collect()
    torch.cuda.empty_cache()
    # mamba2-2.7b at full width on MAMBA2_LAYERS layers, through `serve --arch mamba2-2.7b --lockstep`
    model, params, tok = build_model(torch, serve, MAMBA2_FLAGS, MAMBA2_LAYERS)
    mamba2 = end_to_end_phase(torch, ops, _build, serve, generate, model, params, tok,
                              label="e2e_mamba2", profile_name="profile_mamba2.txt",
                              layerwise=True)
    paths = {**end_counts, "mamba2_lockstep": mamba2[0]}
    if opts.profile:
        jobs.append(mamba2[2])
    del model, params, mamba2
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 7: training, GRPO on full gemma-2b ----
    train_counts, train_summary, train_job = training_phase(
        torch, ops, ref, F, _build, serve, generate, records, opts.profile)
    paths["grpo_training"] = train_counts
    # ---- phase 8: the GRPO pipeline through launch.train, phase 7's model
    # freed (the counts set to 0 just before its first run, read just after) ----
    paths["grpo_pipeline"], pipeline_summary = pipeline_phase(
        torch, ops, ref, _build, hand_rows=train_summary["iterations"])
    # and its continuous-engine arm (the counts set to 0 just before it, read
    # just after)
    paths["grpo_engine_pipeline"] = engine_pipeline_arm(torch, ops, ref, _build)
    # ---- phase 9: mamba2-2.7b training: GRPO through launch.train --arch
    # mamba2-2.7b (gemma freed; the counts set to 0 just before its first
    # run, read just after), then the gradient check, the long actor step and
    # the scan under autograd ----
    paths["mamba2_grpo_pipeline"], _ = pipeline_phase(
        torch, ops, ref, _build, label="mamba2_pipeline", flags=MAMBA2_FLAGS, arms=PIPE_ARMS_SHORT,
        layers=MAMBA2_LAYERS)
    mamba2_training_phase(torch, ops, ref, F, _build, serve, generate, records)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 10: PPO on gemma-2b through launch.train --algorithm ppo, the
    # critic's values and steps on the card ----
    paths["ppo_pipeline"], _ = pipeline_phase(
        torch, ops, ref, _build, label="ppo_pipeline", flags=ARCH_FLAGS + ["--algorithm", "ppo"],
        rl=PPO_RL, arms=PIPE_ARMS_SHORT)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 11: the continuous rollout engine at qwen2.5-7b's full width
    # and depth (the counts set to 0 just before the refill arm's first run,
    # read just after) ----
    paths["qwen_engine"] = qwen_engine_phase(torch, ops, ref, _build, serve, generate)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 12: the async pipeline and multi-turn episodes through
    # launch.train at gemma-2b's full width (qwen freed; the counts set to 0
    # just before each arm, read just after) ----
    paths.update(async_phase(torch, ops, ref, _build))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 13: the MoE family, granite-moe-3b lockstep and GRPO at full
    # width on GRANITE_LAYERS layers, mixtral-8x7b's ring at full width (the counts set to 0
    # just before each path, read just after) ----
    paths.update(moe_phase(torch, ops, ref, F, _build, serve, generate, records))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 14: the remaining families, nemotron-4-15b, command-r-plus's
    # parallel blocks, seamless-m4t's encoder-decoder and llava-next's prefix
    # (the counts set to 0 just before each path, read just after) ----
    paths.update(families_phase(torch, ops, ref, F, _build, serve, generate, records))
    gc.collect()
    torch.cuda.empty_cache()
    # the processes of phase 16's first arm, started while phase 15 runs
    pool_fill()
    # ---- phase 15: checkpoints and telemetry through launch.train at gemma-2b's
    # full width (the counts set to 0 just before each run, read just after) ----
    paths.update(ckpt_phase(torch, ops, ref, _build,
                            pipeline_ms=pipeline_summary["iteration_ms"]["distributed"]))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 16: the data-parallel fleet, each host a process of its own on
    # the card (each host's counts start at 0 in its process and are read
    # after its run) ----
    paths.update(fleet_phase(torch, _build))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 17: the sharding layer over torch.distributed, two ranks on
    # the card (each rank's counts start at 0 in its process and are read
    # after its run; the sharded decode's just before and after it) ----
    paths.update(sharding_phase(torch, _build, keep_solo=True))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 18: tensor-parallel model stages, the vocab-sharded sampler
    # and two ranks of a (data 1, model 2) mesh on the card (each rank's
    # counts start at 0 in its process and are read after its run) ----
    paths.update(tp_phase(torch, ops, ref, _build, records))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 19: tensor-parallel MoE and SSD layers, the sharded norm's
    # entries alone, then granite-moe-3b and mamba2-2.7b on two ranks of a
    # (data 1, model 2) mesh on the card (each rank's counts start at 0 in its
    # process and are read after its run) ----
    paths.update(tp_moe_ssd_phase(torch, ref, F, _build, records))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 20: tensor-parallel model stages of the remaining families:
    # gemma-2b's int8 KV cache through launch.train, then mixtral's ring,
    # llava's prefix, seamless's encoder-decoder and nemotron's top_p in the
    # same two ranks of a (data 1, model 2) mesh (each rank's counts start at
    # 0 in its process and are read after each run) ----
    paths.update(tp20_phase(torch, _build, records))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 21: the continuous rollout engine on tensor-parallel ranks:
    # qwen2.5-7b's GRPO with chunked refills through launch.train, the
    # engine's calls directly and a dialog iteration in the same two ranks of
    # a (data 1, model 2) mesh (each rank's counts start at 0 in its process
    # and are read after its GRPO run) ----
    paths.update(tp21_phase(torch, _build, records))
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 22: the staleness-bounded async pipeline on a rank mesh:
    # gemma-2b synchronous and at staleness 0 and 1 (and under truncated IS)
    # on a (data 1, model 2) mesh, then granite-moe-3b at staleness 1 on a
    # (data 2, model 1) mesh, all in one world of two ranks (each rank's
    # counts set to 0 in its process just before each arm, read just after)
    paths.update(tp22_phase(torch, _build, records))
    if opts.profile:
        # last, so that no timed phase runs in a process that torch.profiler
        # has traced (the profiles keep their models alive until then)
        for job in [*jobs, train_job]:
            job()
    on_path = {"streaming": ("rmsnorm", "flash_attention", "paged_decode_attention",
                             "fused_sample"),
               "lockstep": ("rmsnorm", "flash_attention", "decode_attention", "fused_sample"),
               "int8_lockstep": ("rmsnorm", "flash_attention", "decode_attention_quant",
                                 "fused_sample"),
               "mamba2_lockstep": ("rmsnorm", "ssd", "fused_sample"),
               "grpo_training": ("rmsnorm", "flash_attention", "decode_attention",
                                 "fused_sample"),
               "grpo_pipeline": ("rmsnorm", "flash_attention", "decode_attention",
                                 "fused_sample"),
               "mamba2_grpo_pipeline": ("rmsnorm", "ssd", "fused_sample"),
               "ppo_pipeline": ("rmsnorm", "flash_attention", "decode_attention",
                                "fused_sample"),
               "grpo_engine_pipeline": ("rmsnorm", "flash_attention", "decode_attention",
                                        "fused_sample"),
               "qwen_engine": ("rmsnorm", "flash_attention", "decode_attention",
                               "fused_sample"),
               **{f"{arm}_pipeline": ("rmsnorm", "flash_attention", "decode_attention",
                                      "fused_sample")
                  for arm in ("async_sync", "async_s0", "async_s1", "async_tis", "multiturn")},
               **{path: ("rmsnorm", "flash_attention", "decode_attention", "fused_sample")
                  for path in ("granite_lockstep", "granite_grpo_pipeline", "mixtral_ring",
                               "llava_generate")},
               # layernorm models launch no norm kernel, enc-dec no sampler
               **{path: ("flash_attention", "decode_attention", "fused_sample")
                  for path in ("nemotron_lockstep", "command_r_lockstep")},
               **{path: ("rmsnorm", "flash_attention", "decode_attention", "fused_sample")
                  for path in ("ckpt_train", "ckpt_resume", "ckpt_resume_async")},
               **{f"fleet_{arm}_host{h}": ("rmsnorm", "flash_attention", "decode_attention",
                                             "fused_sample")
                  for arm in ("exact", "int8_ef") for h in (0, 1)},
               **{f"shard_grpo_rank{r}": ("rmsnorm", "flash_attention", "decode_attention",
                                          "fused_sample") for r in range(SHARD_RANKS)},
               **{f"shard_decode_rank{r}": ("decode_attention",) for r in range(SHARD_RANKS)},
               **{f"tp_grpo_rank{r}": ("rmsnorm", "flash_attention", "decode_attention",
                                       "fused_sample") for r in range(TP_RANKS)},
               **{f"tp_granite_grpo_rank{r}": ("rmsnorm", "flash_attention", "decode_attention",
                                               "fused_sample") for r in range(TP_RANKS)},
               **{f"tp_mamba2_grpo_rank{r}": ("rmsnorm", "ssd", "fused_sample", "rmsnorm_sumsq",
                                              "rmsnorm_scaled") for r in range(TP_RANKS)},
               **{f"tp20_gemma_int8_rank{r}": ("rmsnorm", "flash_attention",
                                               "decode_attention_quant", "fused_sample")
                  for r in range(TP_RANKS)},
               **{f"tp20_{arm}_rank{r}": ("rmsnorm", "flash_attention", "decode_attention",
                                          "fused_sample")
                  for arm in ("mixtral", "llava") for r in range(TP_RANKS)},
               **{f"tp20_{arm}_rank{r}": ("flash_attention", "decode_attention")
                  for arm in ("seamless", "nemotron") for r in range(TP_RANKS)},
               **{f"tp21_qwen_rank{r}": ("rmsnorm", "flash_attention", "decode_attention",
                                         "fused_sample") for r in range(TP_RANKS)},
               **{f"tp22_{arm}_rank{r}": ("rmsnorm", "flash_attention", "decode_attention",
                                          "fused_sample")
                  for arm in TP22_ARMS for r in range(TP_RANKS)},
               "seamless_serving": ("flash_attention", "decode_attention"),
               "seamless_training": ("flash_attention",)}
    for path, names in on_path.items():
        require(all(paths[path][n] > 0 for n in names),
                f"a kernel of the {path} path was not launched: {paths[path]}")

    sources = {"rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:42"),
               "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:135"),
               "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:349"),
               "paged_decode_attention": ("paged_decode_attention.cu",
                                          "src/repro/kernels/decode_attention.py:453"),
               "fused_sample": ("sampling.cu", "src/repro/kernels/sampling.py:181"),
               "decode_attention_quant": ("decode_attention_quant.cu",
                                          "src/repro/kernels/decode_attention.py:282"),
               "ssd": ("ssd.cu", "src/repro/kernels/ssd.py:121"),
               # the sharded norm's sum of squares and its forward from the
               # summed sums: the same TPU kernel's work where its row is
               # split over ranks
               "rmsnorm_sumsq": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:42"),
               "rmsnorm_scaled": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:42")}
    kernels = []
    for name, rec in records.items():
        src, replaces = sources[name]
        # launches: the first path of on_path that runs the kernel (the
        # streaming path, the system's default, first)
        path = next(p for p, names in on_path.items() if name in names)
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
                 "launches": paths[path][name], "launches_path": path,
                 "launches_by_path": {p: c[name] for p, c in paths.items()}, **rec}
        print(json.dumps(entry), flush=True)
        kernels.append(entry)
    print(json.dumps({"script_s": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
