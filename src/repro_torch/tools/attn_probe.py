"""Where the time of the port's tensor-core kernels goes, on one
NVIDIA GPU: ``PYTHONPATH=src python3 -m repro_torch.tools.attn_probe`` from
the root of a checkout (no JAX, no network; builds into ``build/``).

It reads the kernels' own device durations from torch.profiler (CUPTI),
which leaves out the gaps between launches that ``chip_smoke.py``'s
event timings include, and prints one JSON line each:

  per_tile    the steady-state cost of one key tile: flash over one block of
              rows against 512 and 4096 keys (32-key tiles), the split body
              over one row of 4096 keys in one split and in eight (16-key
              tiles), each as the difference over the added tiles;
  breakdown   ``flash_attention`` at the lockstep prompt (B=8, 128
              positions, 16 heads on one KV head of 256, causal) and at the
              streaming chunk (16 queries at q_offset 32 against a strided
              48-key view), as the port builds it and built again with the
              probe macros of ``csrc/flash_attention.cu``: copies only (no
              products, no softmax), products only (no K/V copies), and
              blocks of 2 and of 8 warps in place of 4. Each build is timed
              in two interleaved rounds. The warp variants compute the same
              rows in the same key order, so their outputs must equal the
              port's bit for bit;
  decode_us   ``decode_attention`` and ``decode_attention_quant`` at the
              lockstep decode step (B=8, 16 heads on one KV head of 256, 160
              slots, ragged lengths): the split kernel and the merge each
              (``decode_split_kernel``, ``decode_quant_split_kernel``,
              ``combine_kernel``), in two interleaved rounds;
  sample_us   ``fused_sample`` (one launch: the tile pass and the last
              block's merge) at gemma-2b's head (256,000 x 2048) for B=8 and
              B=64 and at mamba2-2.7b's (50,432 x 2560) for B=8, sampled
              rows, and at B=64 greedy, in two interleaved rounds, with the
              head read rate: the head's bytes over the kernel's own
              duration; built again with the probe macros of
              ``csrc/sampling.cu``: copies only (the TMA stream without
              products or scans), no L2 promotion, and 64-wide stages at
              every batch size. The no-promotion build keeps the port's
              grid and every row's order of sums, so its samples must equal
              the port's bit for bit;
  ssd_us      ``ssd`` at mamba2-2.7b's widths (80 heads of 64, one group of
              state 128, chunk 128): the lockstep prefill (B=8, 128
              positions; ``ssd_chunk_kernel``) and a four-chunk sequence
              (B=2, 512 positions; ``ssd_state_kernel``, ``ssd_pass_kernel``,
              ``ssd_y_kernel``), each kernel of a call, as the port builds
              ``csrc/ssd.cu`` and built again with its probe macros: copies
              only (tiles in, y and the state out, no products) and products
              only (nothing read into the tiles), in two interleaved rounds;
  norm_us     ``rmsnorm`` at the serving paths' shapes: 1024 rows (the
              prefills) and 8 rows (the decode steps) of gemma-2b's 2048 and
              mamba2-2.7b's 2560 and 5120, in two interleaved rounds, with
              the bytes over the kernel's own duration (TB/s), and again
              with w out of L2 and x in it, as a layer's norm finds them.

The card's name and power limit come first, as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

VARIANTS = {  # build name -> nvcc defines
    "copies_only": ("-DFA_PROBE_COPIES_ONLY",),
    "products_only": ("-DFA_PROBE_PRODUCTS_ONLY",),
    "warps2": ("-DFA_WARPS=2",),
    "warps8": ("-DFA_WARPS=8",),
}
SAMPLE_VARIANTS = {  # csrc/sampling.cu builds: name -> nvcc defines
    "copies_only": ("-DSAMPLE_PROBE_COPIES_ONLY",),
    "no_l2_promotion": ("-DSAMPLE_PROBE_NO_L2_PROMOTION",),
    "kc64": ("-DSAMPLE_KC=64",),
}
SSD_VARIANTS = {  # csrc/ssd.cu builds: name -> nvcc defines
    "copies_only": ("-DSSD_PROBE_COPIES_ONLY",),
    "products_only": ("-DSSD_PROBE_PRODUCTS_ONLY",),
}
# the variant that keeps the port's grid and every row's order of sums: its
# samples must equal the port's bit for bit (64-wide stages change the grid,
# whose merge tree sets the logprob's last bits)
SAMPLE_SAME_BITS = ("no_l2_promotion",)


def cupti_us(torch, fn, n: int = 30):
    """Mean device duration (us) of each kernel one call of fn launches
    (the instantiations of one template summed)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            name = ev.key.split("<")[0].split("::")[-1].split("(")[0]
            out[name] = out.get(name, 0.0) + ev.device_time_total / n
    return out


def build_variants(_build, source: str, variants):
    """``csrc/<source>.cu`` built with each of ``variants``' defines, all nvcc
    processes at once, into ``build/probe/``: {name: (library, ptxas log)}."""
    out_dir = _build.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *defs, "-o", str(out_dir / f"{source}-{name}.so"),
         str(_build.CSRC / f"{source}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in variants.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {source}.cu ({name}):\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{source}-{name}.so"))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, log)
    return libs


def flash_variants(_build, argtypes):
    """ctypes entry points of ``csrc/flash_attention.cu`` built with each of
    VARIANTS' defines."""
    fns = {}
    for name, (lib, _) in build_variants(_build, "flash_attention", VARIANTS).items():
        fn = lib.flash_attention_fwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = (lib, fn)
    return fns


def sample_call(torch, _build, lib, h, head, seeds, it, V):
    """One launch of ``fused_sample_fwd`` from ``lib`` (a build of
    ``csrc/sampling.cu``), set up as the wrapper sets it up."""
    from repro_torch.kernels import sampling

    c = ctypes
    B, d = h.shape
    Vp = head.shape[1]
    cols = int(sampling.head_layout(head))
    dev, stream = _build.launch_site(h)
    grid = lib.fused_sample_grid
    grid.argtypes, grid.restype = [c.c_int] * 4 + [c.POINTER(c.c_int)] * 3, c.c_int
    out = [c.c_int() for _ in range(3)]
    _build.check(lib, grid(B, Vp, cols, dev, *(c.byref(x) for x in out)), "fused_sample grid")
    blocks, tiles, _ = (x.value for x in out)
    fwd = lib.fused_sample_fwd
    fwd.argtypes, fwd.restype = sampling._fwd().argtypes, c.c_int
    part = torch.empty((blocks, B, 4), dtype=torch.float32, device=h.device)
    part_idx = torch.empty((blocks, B), dtype=torch.int32, device=h.device)
    ticket = torch.zeros((1,), dtype=torch.int32, device=h.device)
    tok = torch.empty((B,), dtype=torch.int32, device=h.device)
    lp = torch.empty((B,), dtype=torch.float32, device=h.device)

    def call():
        _build.check(lib, fwd(h.data_ptr(), head.data_ptr(), seeds.data_ptr(), it.data_ptr(),
                              part.data_ptr(), part_idx.data_ptr(), ticket.data_ptr(),
                              tok.data_ptr(), lp.data_ptr(), B, d, Vp, V, cols, blocks, tiles,
                              None, None, 0, dev, stream), "fused_sample (probe build)")
        return tok, lp
    return call


def decode_probe(torch, gen):
    """The two contiguous decode kernels at the lockstep step (B=8, 16
    heads, 8..15 zero, on one KV head of 256, 160 slots, ragged lengths):
    the split kernel and the merge each, in two interleaved rounds."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_quant as daq
    from repro_torch.models.lm import quant_kv

    B, H, S, D = 8, 16, 160, 256
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    q[:, 8:] = 0
    k, v = (torch.randn((B, S, 1, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    (kq, ks), (vq, vs) = quant_kv(k), quant_kv(v)
    lens = torch.tensor([160, 1, 17, 80, 129, 150, 33, 100], dtype=torch.int32, device="cuda")
    calls = {"bf16": lambda: da.decode_attention(q, k, v, lens),
             "int8": lambda: daq.decode_attention_quant(q, kq, vq, ks, vs, lens)}
    rec = {tag: [] for tag in calls}
    for _ in range(2):
        for tag, fn in calls.items():
            rec[tag].append(cupti_us(torch, fn))
    return rec


def sample_probe(torch, gen):
    """The sampler's device duration per launch at the three serving
    shapes, as the port builds it and built again with each of
    SAMPLE_VARIANTS' defines, in two interleaved rounds, with the head read
    rate (TB/s) of each; the variants in SAMPLE_SAME_BITS must give the
    port's tokens and logprobs bit for bit."""
    from repro_torch.kernels import _build, sampling

    shapes = {"gemma_b8": (8, 256_000, 2048), "gemma_b64": (64, 256_000, 2048),
              "mamba2_b8": (8, 50_432, 2560), "gemma_b64_greedy": (64, 256_000, 2048)}
    heads = {(V, d): (torch.randn((V, d), generator=gen, device="cuda") * 0.02
                      ).to(torch.bfloat16) for _, V, d in shapes.values()}
    libs = build_variants(_build, "sampling", SAMPLE_VARIANTS)
    calls = {}
    for tag, (B, V, d) in shapes.items():
        h = torch.randn((B, d), generator=gen, device="cuda").to(torch.bfloat16)
        seeds = torch.arange(B, dtype=torch.int32, device="cuda") * 7919
        it = torch.full((B,), 0.0 if tag.endswith("greedy") else 1.0, device="cuda")
        head = heads[V, d].t()
        calls["kernel", tag] = (lambda h=h, head=head, seeds=seeds, it=it, V=V:
                                sampling.fused_sample(h, head, seeds, it, vocab_size=V))
        for name, (lib, _) in libs.items():
            calls[name, tag] = sample_call(torch, _build, lib, h, head, seeds, it, V)
    rec = {name: {tag: [] for tag in shapes} for name in ("kernel", *libs)}
    for _ in range(2):
        for (name, tag), fn in calls.items():
            rec[name][tag].append(cupti_us(torch, fn)["sample_kernel"])
    rate = {name: {tag: [V * d * 2 / (us * 1e-6) / 1e12 for us in rec[name][tag]]
                   for tag, (_, V, d) in shapes.items()} for name in rec}
    same = {f"{name}/{tag}": all(a.equal(b) for a, b in zip(calls[name, tag](),
                                                           calls["kernel", tag]()))
            for name in SAMPLE_SAME_BITS for tag in shapes}
    regs = {name: [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln] for name, (_, log) in libs.items()}
    dev = torch.cuda.current_device()
    return {"us": rec, "head_read_tb_per_s": rate, "variants_bit_equal": same,
            "grid": {tag: sampling.grid(B, V, dev) for tag, (B, V, _) in shapes.items()},
            "ptxas": regs}


def ssd_probe(torch, gen):
    """``ssd`` at mamba2-2.7b's widths, the prefill and a four-chunk
    sequence, as the port builds it and with each of SSD_VARIANTS' defines,
    in two interleaved rounds: the device duration (us) of each kernel a
    call launches, and the registers, shared memory and spills of each
    build."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ssd

    NH, P, N = 80, 64, 128
    libs = build_variants(_build, "ssd", SSD_VARIANTS)
    shapes = {"prefill": (8, 128), "multi_chunk": (2, 512)}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    calls = {}
    for tag, (B, S) in shapes.items():
        x, Bm, Cm = randn(B, S, NH, P), randn(B, S, 1, N), randn(B, S, 1, N)
        dt = F.softplus(randn(B, S, NH, dtype=torch.float32))
        A, D = -torch.exp(randn(NH, dtype=torch.float32)), randn(NH, dtype=torch.float32)
        args = (x, dt, A, Bm, Cm, D)
        calls["kernel", tag] = lambda args=args: ssd.ssd(*args)
        for name, (lib, _) in libs.items():
            fwd = lib.ssd_fwd
            fwd.argtypes, fwd.restype = ssd._fwd().argtypes, ctypes.c_int
            calls[name, tag] = (lambda args=args, fwd=fwd, lib=lib:
                                ssd.launch(fwd, lib, *args, chunk=128))
    rec = {name: {tag: [] for tag in shapes} for name in ("kernel", *libs)}
    for _ in range(2):
        for (name, tag), fn in calls.items():
            rec[name][tag].append(cupti_us(torch, fn))
    logs = {"kernel": (_build.BUILD_DIR / "ssd.log").read_text(),
            **{name: log for name, (_, log) in libs.items()}}
    regs = {name: [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln] for name, log in logs.items()}
    return {"us": rec, "ptxas": regs}


def norm_probe(torch, gen):
    """``rmsnorm`` at the serving paths' shapes, in two interleaved rounds:
    the kernel's device duration (us) and the bytes it must move (x read,
    y written, w read) over that duration (TB/s); and the duration with w
    out of L2 and x in it, as a layer's norm finds them (``cold_w_us``: a
    96 MB buffer is written, then x, before each call)."""
    from repro_torch.kernels import rmsnorm

    shapes = {f"{R}x{D}": (R, D) for R in (1024, 8) for D in (2048, 2560, 5120)}
    flush = torch.empty((96 << 20) // 4, device="cuda")
    calls, cold, evict = {}, {}, {}
    for tag, (R, D) in shapes.items():
        x = torch.randn((R, D), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((D,), generator=gen, device="cuda") * 0.1
        calls[tag] = lambda x=x, w=w: rmsnorm.rmsnorm(x, w)
        evict[tag] = lambda x=x: (flush.zero_(), x.mul_(1))
        cold[tag] = lambda x=x, w=w, e=evict[tag]: (e(), rmsnorm.rmsnorm(x, w))
    us = {tag: [] for tag in shapes}
    cold_us = {tag: [] for tag in shapes}
    for _ in range(2):
        for tag in shapes:
            us[tag].append(sum(cupti_us(torch, calls[tag]).values()))
            other = cupti_us(torch, evict[tag])  # the kernels that evict w
            cold_us[tag].append(sum(t for k, t in cupti_us(torch, cold[tag]).items()
                                    if k not in other))
    rate = {tag: [(4 * R * D + 4 * D) / (t * 1e-6) / 1e12 for t in us[tag]]
            for tag, (R, D) in shapes.items()}
    return {"us": us, "tb_per_s": rate, "cold_w_us": cold_us}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_probe: CUDA is not available; this tool runs on a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # steady state: one flash block (4 positions x 16 heads) against long keys
    ql, kl, vl = randn(1, 4, 16, 256), randn(1, 4096, 1, 256), randn(1, 4096, 1, 256)
    fl = {sk: sum(cupti_us(torch, lambda: fa.flash_attention(
        ql, kl[:, :sk], vl[:, :sk], causal=False)).values()) for sk in (512, 4096)}
    # one row of 4096 keys through the split entry point at a forced split
    PL, PS = 300, 16
    pk_l, pv_l, qpl = randn(PL, PS, 1, 256), randn(PL, PS, 1, 256), randn(1, 16, 256)
    tl = torch.randperm(PL, generator=gen, device="cuda")[:256].reshape(1, 256).to(torch.int32)
    lens = torch.tensor([4096], dtype=torch.int32, device="cuda")
    o, lse = torch.empty_like(qpl), torch.empty((1, 16), dtype=torch.float32, device="cuda")
    parts = torch.empty((256, 1, 16, 256), dtype=torch.float32, device="cuda")
    lparts = torch.empty((256, 1, 16), dtype=torch.float32, device="cuda")
    dev, stream = _build.launch_site(qpl)

    def split_at(pages):
        return lambda: pda._fwd()(qpl.data_ptr(), pk_l.data_ptr(), pv_l.data_ptr(), tl.data_ptr(),
                                  lens.data_ptr(), o.data_ptr(), lse.data_ptr(), parts.data_ptr(),
                                  lparts.data_ptr(), 1, 256, PS, 16, 1, 256, pages, 1 / 16, dev,
                                  stream)
    sp = {keys: cupti_us(torch, split_at(keys // PS)) for keys in (512, 4096)}
    split_key = next(n for n in sp[4096] if "split" in n)
    print(json.dumps({"per_tile": {
        "flash_us_per_32_keys": (fl[4096] - fl[512]) / ((4096 - 512) / 32),
        "flash_one_block_us": fl,
        "split_us_per_16_keys": (sp[4096][split_key] - sp[512][split_key]) / ((4096 - 512) / 16),
        "split_one_row_4096_keys_us": {"one split": sp[4096], "eight splits": sp[512]}}}),
          flush=True)

    print(json.dumps({"decode_us": decode_probe(torch, gen)}), flush=True)
    sample = sample_probe(torch, gen)
    print(json.dumps({"sample_us": sample}), flush=True)
    print(json.dumps({"ssd_us": ssd_probe(torch, gen)}), flush=True)
    print(json.dumps({"norm_us": norm_probe(torch, gen)}), flush=True)

    # the serving shapes: padded heads 8..15 are zero, as the model passes them
    q, k, v = randn(8, 128, 16, 256), randn(8, 128, 1, 256), randn(8, 128, 1, 256)
    qc, rows_k, rows_v = randn(8, 16, 16, 256), randn(8, 256, 1, 256), randn(8, 256, 1, 256)
    q[:, :, 8:] = 0
    qc[:, :, 8:] = 0
    kc, vc = rows_k[:, :48], rows_v[:, :48]
    shapes = {  # (q, k, v, Sq, Sk, q_offset)
        "prompt": (q, k, v, 128, 128, 0),
        "chunk": (qc, kc, vc, 16, 48, 32),
    }
    builds = {"kernel": (_build.library("flash_attention"), fa._fwd()),
              **flash_variants(_build, fa._fwd().argtypes)}
    outs = {(name, tag): torch.empty_like(a[0]) for name in builds for tag, a in shapes.items()}

    def call(name, tag):
        lib, fn = builds[name]
        qq, kk, vv, sq, sk, off = shapes[tag]
        out = outs[name, tag]
        return lambda: _build.check(lib, fn(
            qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), out.data_ptr(), 8, sq, sk, 16, 1, 256,
            kk.stride(0), 1 / 16, 1, 0, off, dev, stream), f"flash_attention ({name})")

    breakdown = {name: {tag: [] for tag in shapes} for name in builds}
    for _ in range(2):
        for name in builds:
            for tag in shapes:
                breakdown[name][tag].append(sum(cupti_us(torch, call(name, tag)).values()))
    torch.cuda.synchronize()
    same = {f"{name}/{tag}": torch.equal(outs[name, tag], outs["kernel", tag])
            for name in ("warps2", "warps8") for tag in shapes}
    print(json.dumps({"breakdown_us": breakdown, "warp_variants_bit_equal": same}), flush=True)
    if not all(same.values()) or not all(sample["variants_bit_equal"].values()):
        print(f"attn_probe: a variant differs from the port's kernel: {same} "
              f"{sample['variants_bit_equal']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
