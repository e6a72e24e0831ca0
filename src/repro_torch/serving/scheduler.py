"""Request admission + streaming: the host-side front half of the server (a
copy of ``repro.serving.scheduler``; numpy only, so ``synthetic_requests``
gives both packages the same request list for one seed).

A :class:`Request` is one user call: prompt tokens, a response budget, a
temperature, and the arrival timestamp the TTFT clock starts from. Submitting
it yields a :class:`RequestStream` immediately — token deltas are appended as
decode bursts flush, each tagged with the weight version that decoded it, so
a caller can stream partial output while the request is still in flight (and
an RL trainer can attribute every token to the policy version that produced
it, the per-token-version hook ROADMAP item 2 needs).

The :class:`AdmissionQueue` holds work that owns no KV yet (fresh requests)
or owns KV only as pooled pages (parked requests). Fresh requests are
length-bucketed — page-aligned widths, so every admission batch prefills
through the same per-chunk executables — and FIFO within a bucket. Across
the fresh buckets and the parked lane, ``pop_work`` serves whichever head
item has waited longest: oldest-head scheduling is starvation-free by
construction (a deferred bucket's head only grows older until it *is* the
oldest), unlike fullest-bucket-first, and keeps global service order close
to arrival order while still batching same-shape prefills.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request. ``seed`` drives the per-request sampling seed
    stream (``engine.request_seed(base_seed, seed, position)``) —
    positional keys make output tokens independent of slot placement,
    co-resident requests, and park/resume timing. Defaults to ``rid``."""

    rid: int
    prompt: np.ndarray  # (L,) true-length token ids (no padding)
    max_new: int
    temperature: float = 1.0
    arrival: float = 0.0
    seed: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).ravel()
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.seed is None:
            self.seed = self.rid


class RequestStream:
    """Per-request output stream: token deltas with flush timestamps and
    weight-version tags, plus the finished-response metrics."""

    def __init__(self, req: Request):
        self.request = req
        self.tokens: List[int] = []
        # (first_token_index, weight_version) segment starts; contiguous
        # tokens[start:next_start] were decoded under that version
        self.version_segments: List[Tuple[int, int]] = []
        self.token_times: List[float] = []  # flush time per token
        self.finished = False
        self.finish_reason = ""  # "eos" | "budget" | "rejected"
        self.matched_prefix_tokens = 0  # prefix-cache hit size at admission

    def append(self, toks, when: float, version: int) -> None:
        if toks is None or len(toks) == 0:
            return
        if (not self.version_segments
                or self.version_segments[-1][1] != version):
            self.version_segments.append((len(self.tokens), version))
        self.tokens.extend(int(t) for t in toks)
        self.token_times.extend([when] * len(toks))

    def finish(self, reason: str) -> None:
        self.finished = True
        self.finish_reason = reason

    # ---- metrics ------------------------------------------------------ #
    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, from arrival to its flush."""
        if not self.token_times:
            return None
        return self.token_times[0] - self.request.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Mean per-output-token latency after the first token."""
        if len(self.token_times) < 2:
            return None
        return ((self.token_times[-1] - self.token_times[0])
                / (len(self.token_times) - 1))

    @property
    def weight_versions(self) -> List[int]:
        return [v for _, v in self.version_segments]


class _Parked:
    """A preempted request waiting to resume: its block table plus the
    device-free resume state (current token, lengths, budget left)."""

    __slots__ = ("req", "stream", "page_ids", "cache_len", "resp_len",
                 "cur_tok", "budget_left", "enqueued")

    def __init__(self, req, stream, page_ids, cache_len, resp_len, cur_tok,
                 budget_left, enqueued):
        self.req = req
        self.stream = stream
        self.page_ids = page_ids
        self.cache_len = int(cache_len)
        self.resp_len = int(resp_len)
        self.cur_tok = int(cur_tok)
        self.budget_left = int(budget_left)
        self.enqueued = enqueued


class AdmissionQueue:
    """Length-bucketed FIFO admission with an oldest-head service policy."""

    def __init__(self, *, bucket: int, max_len: int):
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        self.bucket = bucket
        self.max_len = max_len
        self._fresh: Dict[int, Deque[Tuple[int, Request]]] = {}
        self._parked: Deque[Tuple[int, _Parked]] = deque()
        self._seq = itertools.count()  # global enqueue order (age proxy)
        self._neg = itertools.count(-1, -1)  # requeue ages: older than live

    def __len__(self) -> int:
        return (sum(len(q) for q in self._fresh.values())
                + len(self._parked))

    @property
    def num_parked(self) -> int:
        return len(self._parked)

    def bucket_len(self, prompt_len: int) -> int:
        return min(-(-prompt_len // self.bucket) * self.bucket, self.max_len)

    def push(self, req: Request) -> None:
        lb = self.bucket_len(len(req.prompt))
        self._fresh.setdefault(lb, deque()).append((next(self._seq), req))

    def push_parked(self, parked: _Parked) -> None:
        self._parked.append((next(self._seq), parked))

    def pop_work(self, n: int):
        """Up to ``n`` homogeneous items from the longest-waiting head:
        ``("parked", 0, [_Parked, ...])`` or ``("fresh", bucket_len,
        [Request, ...])``. Oldest head wins across all lanes, so neither
        parked resumes nor any fresh bucket can be deferred indefinitely;
        within a bucket, arrival (enqueue) order is preserved exactly."""
        best_key, best = None, None
        if self._parked:
            best_key, best = self._parked[0][0], "parked"
        for lb, q in self._fresh.items():
            if q and (best_key is None or q[0][0] < best_key):
                best_key, best = q[0][0], lb
        if best is None:
            raise IndexError("pop_work on an empty queue")
        if best == "parked":
            take = [self._parked.popleft()[1]
                    for _ in range(min(n, len(self._parked)))]
            return "parked", 0, take
        q = self._fresh[best]
        take = [q.popleft()[1] for _ in range(min(n, len(q)))]
        if not q:
            del self._fresh[best]
        return "fresh", best, take

    def pop_parked(self, n: int) -> List[_Parked]:
        """Up to ``n`` parked items out of age order — the page-stall escape
        hatch: a parked resume needs ZERO new pool pages (its KV already
        lives in pages it owns), so when fresh admission stalls on pool
        pages the engine drains parked work instead of deadlocking."""
        return [self._parked.popleft()[1]
                for _ in range(min(n, len(self._parked)))]

    def requeue(self, reqs: List[Request]) -> None:
        """Return popped-but-unadmitted fresh requests to the head of their
        buckets with priority preserved (negative ages sort older than any
        live enqueue) after an admission stall."""
        for r in reversed(reqs):
            lb = self.bucket_len(len(r.prompt))
            self._fresh.setdefault(lb, deque()).appendleft(
                (next(self._neg), r))


# --------------------------------------------------------------------------- #
# percentile helpers + synthetic workloads (shared by launch/serve.py and
# benchmarks/serving.py)
# --------------------------------------------------------------------------- #
def record_stream_latency(registry, stream: RequestStream) -> None:
    """Feed one finished stream's TTFT/TPOT into the ``serving/ttft_s`` and
    ``serving/tpot_s`` histograms of a :class:`repro_torch.obs.MetricsRegistry`
    (the engine calls this at every stream finish when built with one).
    Rejected streams and missing values are skipped."""
    if registry is None or stream.finish_reason == "rejected":
        return
    ttft, tpot = stream.ttft, stream.tpot
    if ttft is not None:
        registry.histogram("serving/ttft_s").record(ttft)
    if tpot is not None:
        registry.histogram("serving/tpot_s").record(tpot)


def percentiles(values, ps=(50, 99)) -> Dict[str, float]:
    vals = [v for v in values if v is not None]
    if not vals:
        return {f"p{p}": 0.0 for p in ps}
    return {f"p{p}": float(np.percentile(vals, p)) for p in ps}


def synthetic_requests(
    n: int,
    *,
    arrival_rate: float,
    page_size: int,
    shared_prefix_pages: int = 2,
    num_prefixes: int = 2,
    shared_frac: float = 0.8,
    suffix_len: Tuple[int, int] = (4, 12),
    max_new: int = 64,
    budget_mix: Tuple[float, float] = (0.7, 0.9),
    temperature: float = 1.0,
    seed: int = 0,
) -> List[Request]:
    """A Poisson-arrival, shared-prefix-heavy request stream.

    ``shared_frac`` of requests open with one of ``num_prefixes`` fixed
    system prompts of ``shared_prefix_pages`` pages (the million-users-one-
    system-prompt shape); the rest are fully unique. Response budgets follow
    the skewed 70/20/10 short/medium/full mix of ``benchmarks/rollout.py``.
    """
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(3, 200, shared_prefix_pages * page_size)
                .astype(np.int32) for _ in range(num_prefixes)]
    t = 0.0
    out: List[Request] = []
    for rid in range(n):
        t += float(rng.exponential(1.0 / arrival_rate))
        suffix = rng.integers(
            3, 200, int(rng.integers(suffix_len[0], suffix_len[1] + 1))
        ).astype(np.int32)
        if rng.random() < shared_frac:
            prompt = np.concatenate(
                [prefixes[int(rng.integers(num_prefixes))], suffix])
        else:
            prompt = np.concatenate(
                [rng.integers(3, 200, shared_prefix_pages * page_size)
                 .astype(np.int32), suffix])
        u = rng.random()
        if u < budget_mix[0]:
            budget = int(rng.integers(4, 9))
        elif u < budget_mix[1]:
            budget = int(rng.integers(12, 21))
        else:
            budget = max_new
        out.append(Request(rid=rid, prompt=prompt, max_new=budget,
                           temperature=temperature, arrival=t))
    return out
