"""The streaming serving engine (port of ``repro.serving.engine``): slot pool +
paged arena + prefix cache + live weight hot-swap, behind a submit/step/serve
host loop.

Per scheduler visit (one ``step()``):

  1. **poll weights**: if the weight store has published a newer version,
     swap to it between decode bursts; in-flight requests keep their KV and
     continue under the new weights, every flushed token delta is tagged
     with the version that decoded it, and the prefix cache is cleared
     (cached KV is version-scoped);
  2. **admit**: parked requests resume by pointing a free slot's block-table
     row back at the pages they never stopped owning; fresh requests are
     matched against the radix prefix cache, their cached pages are loaded,
     and only the uncached tail of the prompt is prefilled, in
     ``page_size`` chunks, so a cache hit runs the very chunk calls the cold
     path runs for the same offsets (it only skips leading ones). The
     prefilled KV is then copied once into pool pages the request owns for
     its whole lifetime (copy-on-admit);
  3. **decode burst**: up to ``decode_burst`` steps over every slot, ending
     early when any slot newly finishes. Decode runs on the page pool
     through each slot's block-table row (the paged flash-decode kernel and
     the fused per-row sampler behind ``model.decode_step_paged_sample``);
  4. **flush**: new tokens go to each request's :class:`RequestStream` with a
     timestamp and the weight version; finished slots free; under
     ``yield_quota``, long-running requests are parked to let arrivals in.

What differs from the JAX engine, on purpose:

* The burst is a Python loop, not a ``lax.while_loop``: its exit rule (all
  slots done, ``decode_burst`` steps, or a slot newly finished) is read on
  the host after every step, one small device-to-host copy per step. The
  rule itself is the JAX engine's, so token streams and the admission
  schedule are the same.
* Sampling seeds: JAX folds the request seed and the response position into
  a threefry key; here :func:`request_seed` hashes the same three values
  into the int32 seed of the fused sampler's hash Gumbel-max draw, and the
  first token is drawn by the same rule from the prefill logits. A
  request's tokens depend on nothing but its seed, prompt and the weights:
  not on its slot, its co-residents, or park/resume timing. Greedy streams
  equal the JAX engine's; sampled ones follow the same distribution.
* Retired lanes write their K/V to the pool's sink page (see
  ``serving/paged_arena.py``), not to a dropped out-of-range page.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ServingConfig
from repro_torch.kernels.ref import hash_u32
from repro_torch.models.api import Model
from repro_torch.obs.trace import get_tracer
from repro_torch.rl.rollout import sample_token_rows
from repro_torch.serving.paged_arena import ArenaOutOfPages, PagedKVArena
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.scheduler import (
    AdmissionQueue,
    Request,
    RequestStream,
    _Parked,
    percentiles,
    record_stream_latency,
)

_U32 = 0xFFFFFFFF


def request_seed(base_seed, req_seed, position) -> torch.Tensor:
    """The int32 sampler seed of response position ``position`` of the
    request seeded ``req_seed``, under the engine seed ``base_seed``:
    ``hash(hash(hash(base ^ 0x9E3779B9) ^ req) ^ position)`` with the
    splitmix32 hash of the fused sampler (``ref.hash_u32``), each value
    taken mod 2**32; the constant keeps (0, 0, 0) off the hash's fixed
    point 0. Ints or int tensors, broadcast; int64 arithmetic, so it gives
    the same bits on the CPU and on CUDA. ``hash_u32`` is a bijection of
    uint32, so one request's positions never share a seed."""
    dev = next((x.device for x in (req_seed, position) if isinstance(x, torch.Tensor)), None)
    b, r, p = (torch.as_tensor(x, device=dev).to(torch.int64) & _U32
               for x in (base_seed, req_seed, position))
    x = hash_u32(hash_u32(hash_u32(b ^ 0x9E3779B9) ^ r) ^ p)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


class _Active:
    """Host record of the request occupying a slot."""

    __slots__ = ("req", "stream", "flushed", "since_admit")

    def __init__(self, req: Request, stream: RequestStream, flushed: int = 0):
        self.req = req
        self.stream = stream
        self.flushed = flushed  # out-row tokens already streamed
        self.since_admit = 0  # tokens decoded since (re)admission (quota)


class ServingEngine:
    """Request-streaming server over one persistent page pool."""

    def __init__(
        self,
        model: Model,
        scfg: ServingConfig,
        *,
        params=None,
        weight_store=None,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        seed: int = 0,
        clock=time.perf_counter,
        registry=None,
    ):
        kinds = model.cfg.layer_kinds()
        if (model.is_encdec or model.cfg.num_prefix_embeds
                or any(k[0] != "attn" for k in kinds)
                or model.cfg.sliding_window is not None
                or model.cfg.kv_quant):
            raise ValueError(
                "the serving engine needs page-addressable KV and chunked "
                "prefill: attention-only text decoders without SWA rings or "
                f"int8 caches ({model.cfg.name!r} doesn't qualify)")
        if params is None:
            if weight_store is None or weight_store.current is None:
                raise ValueError("need params or a published weight store")
            params = weight_store.current.params
        self.model = model
        self.scfg = scfg
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.clock = clock
        # a MetricsRegistry: every finished stream's TTFT/TPOT lands in its
        # serving/* histograms (None = keep stats() as the only view)
        self.registry = registry
        self.weight_store = weight_store
        self._params = params
        self._weight_version = (
            weight_store.version if weight_store is not None
            and weight_store.current is not None else 0)
        self.seed = seed
        self._t0 = clock()

        S, W, ps = scfg.num_slots, scfg.max_len, scfg.page_size
        self.arena = PagedKVArena(model, num_pages=scfg.pool_pages, page_size=ps)
        self.prefix_cache = RadixPrefixCache(page_size=ps) if scfg.prefix_cache else None
        self.queue = AdmissionQueue(bucket=ps, max_len=W)
        self.streams: Dict[int, RequestStream] = {}

        # device slot state: decode attends the page pool through per-slot
        # block-table rows (T_max = the most pages a request can span)
        dev = model.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.T_max = W // ps
        self.tables_dev = torch.zeros((S, self.T_max), **i32)
        self.cur_tok = torch.zeros((S,), **i32)
        self.cache_len = torch.zeros((S,), **i32)
        self.resp_len = torch.zeros((S,), **i32)
        self.done = torch.ones((S,), dtype=torch.bool, device=dev)  # every slot starts free
        self.budget = torch.zeros((S,), **i32)
        self.temp = torch.zeros((S,), dtype=torch.float32, device=dev)
        self.req_seed = torch.zeros((S,), dtype=torch.int64, device=dev)
        # response tokens; the last column takes the writes the JAX engine
        # drops (lanes that are done or past max_new)
        self.out_tok = torch.full((S, scfg.max_new + 1), pad_id, **i32)

        # host slot state
        self.active: List[Optional[_Active]] = [None] * S
        # pool pages each busy slot owns exclusively (admission -> finish;
        # parked requests keep theirs in the arena's park table meanwhile)
        self._slot_pages: List[List[int]] = [[] for _ in range(S)]

        # counters
        self.total_tokens = 0
        self.decode_steps = 0
        self.active_lane_steps = 0
        self.bursts = 0
        self.parks = 0
        self.resumes = 0
        self.weight_swaps = 0
        self.prefill_chunks = 0
        self.prompt_tokens = 0

    # ------------------------------------------------------------------ #
    def now(self) -> float:
        return self.clock() - self._t0

    def reset_stats(self, *, clear_cache: bool = True) -> None:
        """Zero every counter, drop finished streams, and restart the wall
        clock. With ``clear_cache`` the prefix cache empties too (pages back
        to the pool). Replaying a workload once, resetting, then timing the
        second pass keeps the kernel builds and allocator warm-up out of
        TTFT. Only valid when drained."""
        assert self.num_active == 0 and len(self.queue) == 0, \
            "reset_stats on a busy engine"
        if clear_cache and self.prefix_cache is not None:
            self.arena.free(self.prefix_cache.clear())
            self.prefix_cache.hits = self.prefix_cache.misses = 0
            self.prefix_cache.hit_tokens = self.prefix_cache.evicted_pages = 0
        self.streams.clear()
        self.total_tokens = self.decode_steps = self.active_lane_steps = 0
        self.bursts = self.parks = self.resumes = self.weight_swaps = 0
        self.prefill_chunks = self.prompt_tokens = 0
        self._t0 = self.clock()

    @property
    def weight_version(self) -> int:
        return self._weight_version

    @property
    def num_active(self) -> int:
        return sum(a is not None for a in self.active)

    # ------------------------------------------------------------------ #
    # the decode burst
    # ------------------------------------------------------------------ #
    def _burst(self):
        """Up to ``decode_burst`` steps over every slot, ending the moment
        any slot newly finishes (so its pages and lane recycle at once) or
        everything is done; the JAX engine's ``lax.while_loop`` rule, read
        on the host once per step. Retired lanes keep stepping: they write
        to the sink page and their tokens go to the sink column. Returns
        (steps, active lane-steps)."""
        S, W_out, cap = self.scfg.num_slots, self.scfg.max_new, self.scfg.decode_burst
        lane = torch.arange(S, device=self.model.device)
        n_entry = n_done = int(self.done.sum())
        t = occ = 0
        while n_done < S and t < cap and n_done == n_entry:
            occ += S - n_done
            done = self.done
            seeds = request_seed(self.seed, self.req_seed, self.resp_len)
            nxt, self.arena.pool, self.cache_len = self.model.decode_step_paged_sample(
                self._params, self.cur_tok, self.arena.pool, self.cache_len,
                self.tables_dev, seeds, self.temp, write_enable=~done)
            nxt = torch.where(done, self.pad_id, nxt)
            wr = ~done & (self.resp_len < W_out)
            self.out_tok[lane, torch.where(wr, self.resp_len, W_out).long()] = nxt
            self.resp_len = self.resp_len + wr.to(torch.int32)
            new_done = done
            if self.eos_id is not None:
                new_done = new_done | (~done & (nxt == self.eos_id))
            self.done = new_done | (self.resp_len >= self.budget)
            self.cur_tok = nxt
            t += 1
            n_done = int(self.done.sum())
        return t, occ

    # ------------------------------------------------------------------ #
    # page bookkeeping helpers
    # ------------------------------------------------------------------ #
    def _alloc_pages(self, n: int) -> List[int]:
        """Allocate from the arena, evicting LRU prefix-cache pages under
        pressure (freed pages recycle immediately)."""
        try:
            return self.arena.alloc(n)
        except ArenaOutOfPages:
            if self.prefix_cache is not None:
                need = n - self.arena.num_free
                self.arena.free(self.prefix_cache.evict(need))
            return self.arena.alloc(n)  # may still raise: pool truly full

    def _commit_prompt_pages(self, rows, lane: int, prompt: np.ndarray, matched: int) -> None:
        """Commit the prompt's uncached full pages (beyond the ``matched``
        prefix) into the radix cache, copying their KV out of the lane's
        freshly prefilled admission rows. Pool pressure stops the commit
        early: serving never fails because the cache is full."""
        ps = self.scfg.page_size
        n_full = len(prompt) // ps
        if self.prefix_cache is None or n_full * ps <= matched:
            return
        new_pages: List[tuple] = []

        def make_page(p: int) -> int:
            (pid,) = self._alloc_pages(1)
            new_pages.append((p, pid))
            return pid

        try:
            self.prefix_cache.insert(prompt[: n_full * ps], make_page)
        except ArenaOutOfPages:
            pass  # partial commit: attached nodes all have ids in new_pages
        if new_pages:
            start = new_pages[0][0]
            ids = [pid for _, pid in new_pages]
            self.arena.save_rows(rows, lane, ids, start_page=start)

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> RequestStream:
        """Enqueue a request; returns its stream immediately."""
        stream = RequestStream(req)
        self.streams[req.rid] = stream
        if len(req.prompt) > self.scfg.max_len - 1:
            stream.finish("rejected")
            return stream
        self.queue.push(req)
        return stream

    def _admit_fresh(self, reqs: List[Request], lb: int, lanes: List[int]) -> bool:
        """Admit one length bucket of fresh requests: prefix-match each,
        then prefill sub-groups that share a matched length (identical chunk
        schedules) as one lane batch padded to a power of two.

        Copy-on-admit page ownership: before prefilling, each lane allocates
        every pool page its lifetime can touch (``ceil((lb + budget - 1) /
        page_size)``) and owns them until it finishes. The prefilled KV,
        matched prefix included, is copied into them once, so prefix pins
        release at once and park/resume needs no copies and no allocations.
        Returns False on a pool-page stall (the stalled group and every
        group not yet admitted return to the queue head; the caller falls
        back to parked work, which needs no new pages)."""
        ps, S, W = self.scfg.page_size, self.scfg.num_slots, self.scfg.max_len
        dev = self.model.device
        groups: Dict[int, List[Request]] = {}
        matches: Dict[int, tuple] = {}
        for r in reqs:
            if self.prefix_cache is not None:
                m, ids = self.prefix_cache.acquire(r.prompt)
            else:
                m, ids = 0, []
            matches[r.rid] = (m, ids)
            groups.setdefault(m, []).append(r)

        pending = list(groups.items())
        for gi, (m, group) in enumerate(pending):
            n = len(group)
            budgets = [min(r.max_new, self.scfg.max_new, W - lb) for r in group]
            n_own = [-(-(lb + b - 1) // ps) for b in budgets]
            try:
                flat = self._alloc_pages(sum(n_own))
            except ArenaOutOfPages:
                stalled: List[Request] = []
                for m2, g2 in pending[gi:]:
                    for r in g2:
                        if self.prefix_cache is not None:
                            self.prefix_cache.release(r.prompt, m2)
                        stalled.append(r)
                self.queue.requeue(stalled)
                return False
            own = []
            for k in n_own:
                own.append(flat[:k])
                flat = flat[k:]

            # the lane count is a power of two: a prefix hit runs the chunk
            # calls at the lane count the cold path ran them at
            R = 1
            while R < n:
                R *= 2
            R = min(R, S)
            gl, lanes = lanes[:n], lanes[n:]
            batch = np.zeros((R, lb), np.int32)
            lane_tables = np.zeros((n, self.T_max), np.int32)
            for j, r in enumerate(group):
                batch[j, : len(r.prompt)] = r.prompt
                lane_tables[j, : n_own[j]] = own[j]
                self.prompt_tokens += len(r.prompt)
                self.streams[r.rid].matched_prefix_tokens = m

            rows = self.model.init_caches(R, W)
            if m:
                tables = np.stack([matches[r.rid][1] for r in group]
                                  + [matches[group[0].rid][1]] * (R - n))
                rows = self.arena.load_rows(rows, np.arange(R), tables)
            tokens = torch.from_numpy(batch).to(dev)
            logits = None
            with get_tracer().span("serving/prefill", cat="serving",
                                   lanes=R, bucket=lb, matched=m):
                for off in range(m, lb, ps):
                    logits, rows = self.model.prefill_chunk(
                        self._params, tokens[:, off:off + ps], rows, offset=off)
                    self.prefill_chunks += 1
            # copy every lane's prefilled span into its own pool pages in
            # one indexed copy per leaf: from here the requests' KV lives
            # only in the pool (the admission rows are scratch), and decode
            # writes continue at page lb/ps, offset 0
            self.arena.save_rows(rows, np.arange(n), [own[j][: lb // ps] for j in range(n)])

            # admission epilogue: the first token (response position 0) and
            # the slots' device state
            seeds_np = np.array([r.seed for r in group], np.int64)
            temps = torch.tensor([r.temperature for r in group], dtype=torch.float32, device=dev)
            tok0 = sample_token_rows(logits[:n], request_seed(
                self.seed, torch.from_numpy(seeds_np).to(dev), 0), temps)
            lane_budget = torch.tensor(budgets, dtype=torch.int32, device=dev)
            done0 = lane_budget <= 1
            if self.eos_id is not None:
                done0 = done0 | (tok0 == self.eos_id)
            slots = torch.tensor(gl, dtype=torch.long, device=dev)
            self.cur_tok[slots] = tok0
            self.cache_len[slots] = lb
            self.resp_len[slots] = 1
            self.done[slots] = done0
            self.budget[slots] = lane_budget
            self.temp[slots] = temps
            self.req_seed[slots] = torch.from_numpy(seeds_np).to(dev)
            self.tables_dev[slots] = torch.from_numpy(lane_tables).to(dev)
            self.out_tok[slots] = self.pad_id
            self.out_tok[slots, 0] = tok0

            tok0_h, done0_h = tok0.cpu().numpy(), done0.cpu().numpy()
            when = self.now()
            for j, r in enumerate(group):
                st = self.streams[r.rid]
                st.append([tok0_h[j]], when, self._weight_version)
                self.total_tokens += 1
                self.active[gl[j]] = _Active(r, st, flushed=1)
                self._slot_pages[gl[j]] = own[j]
                self._commit_prompt_pages(rows, j, r.prompt, m)
                if self.prefix_cache is not None:
                    self.prefix_cache.release(r.prompt, m)
                if done0_h[j]:
                    reason = ("eos" if self.eos_id is not None
                              and tok0_h[j] == self.eos_id else "budget")
                    st.finish(reason)
                    record_stream_latency(self.registry, st)
                    self.active[gl[j]] = None
                    self.arena.free(self._slot_pages[gl[j]])
                    self._slot_pages[gl[j]] = []
        return True

    def _resume_parked(self, items: List[_Parked], lanes: List[int]) -> None:
        """Resume parked requests: metadata only. The request's KV never
        left its own pool pages, so resuming points a free slot's
        block-table row back at them and restores the slot's scalars: no
        recompute, no device copy of KV, no new pages."""
        for p, slot in zip(items, lanes):
            ids = self.arena.unpark(p.req.rid)
            self._slot_pages[slot] = ids
            row = np.zeros(self.T_max, np.int32)
            row[: len(ids)] = ids
            self.tables_dev[slot] = torch.from_numpy(row).to(self.tables_dev.device)
            self.cur_tok[slot] = p.cur_tok
            self.cache_len[slot] = p.cache_len
            self.resp_len[slot] = p.resp_len
            self.done[slot] = False
            self.budget[slot] = p.resp_len + p.budget_left
            self.temp[slot] = p.req.temperature
            self.req_seed[slot] = p.req.seed
            self.active[slot] = _Active(p.req, p.stream, flushed=p.resp_len)
            self.resumes += 1

    def _admit(self) -> None:
        with get_tracer().span("serving/admit", cat="serving", queued=len(self.queue)):
            self._admit_inner()

    def _admit_inner(self) -> None:
        stalled = False
        while len(self.queue):
            # recompute each round: immediately-done admissions (EOS or a
            # one-token budget on the first sample) free their lane again
            free = [s for s in range(self.scfg.num_slots) if self.active[s] is None]
            if not free:
                return
            if stalled:
                # fresh admission ran out of pool pages this visit; only
                # parked work (which already owns its pages) can still come
                # in. Finishing it returns pages, unsticking fresh admission
                # on the next visit.
                items = self.queue.pop_parked(len(free))
                if not items:
                    if self.num_active == 0:
                        raise ArenaOutOfPages(
                            "admission stalled on an idle engine: the pool "
                            "cannot hold one request's pages even after "
                            "evicting the prefix cache (raise "
                            "ServingConfig.pool_pages)")
                    return
                self._resume_parked(items, free[: len(items)])
                continue
            kind, lb, items = self.queue.pop_work(len(free))
            if kind == "parked":
                self._resume_parked(items, free[: len(items)])
            else:
                stalled = not self._admit_fresh(items, lb, free[: len(items)])

    # ------------------------------------------------------------------ #
    # the scheduler visit
    # ------------------------------------------------------------------ #
    def poll_weights(self) -> bool:
        """Hot-swap to the newest published weights (between bursts; never
        drops in-flight requests). The store is duck-typed: ``.version`` and
        ``.current.params``. Clears the prefix cache: cached KV is scoped to
        the weight version that prefilled it."""
        if (self.weight_store is None or not self.scfg.poll_weights
                or self.weight_store.current is None
                or self.weight_store.version <= self._weight_version):
            return False
        self._params = self.weight_store.current.params
        self._weight_version = self.weight_store.version
        self.weight_swaps += 1
        if self.prefix_cache is not None:
            self.arena.free(self.prefix_cache.clear())
        return True

    def _flush(self) -> None:
        """One bundled copy to the host: stream new tokens, retire finished
        slots, park over-quota slots when arrivals are waiting."""
        done_h, resp_h, out_h, cur_h, clen_h, budget_h = (
            t.cpu().numpy() for t in (self.done, self.resp_len, self.out_tok,
                                      self.cur_tok, self.cache_len, self.budget))
        when = self.now()
        quota = self.scfg.yield_quota
        fresh_waiting = len(self.queue) - self.queue.num_parked
        for s in range(self.scfg.num_slots):
            a = self.active[s]
            if a is None:
                continue
            n = int(resp_h[s])
            new = out_h[s, a.flushed: n]
            a.stream.append(new, when, self._weight_version)
            self.total_tokens += len(new)
            a.since_admit += len(new)
            a.flushed = n
            if done_h[s]:
                last = a.stream.tokens[-1] if a.stream.tokens else None
                reason = ("eos" if self.eos_id is not None
                          and last == self.eos_id else "budget")
                a.stream.finish(reason)
                record_stream_latency(self.registry, a.stream)
                self.active[s] = None
                if self._slot_pages[s]:
                    self.arena.free(self._slot_pages[s])
                    self._slot_pages[s] = []
            elif quota and fresh_waiting > 0 and a.since_admit >= quota:
                self._park(s, a, cur_h[s], clen_h[s], n, int(budget_h[s]))
                fresh_waiting -= 1

    def _park(self, slot: int, a: _Active, cur_tok: int, cache_len: int,
              resp_len: int, budget: int) -> None:
        """Fair-share preemption, metadata only: the slot's KV already lives
        in pool pages the request owns, so parking hands those pages to the
        arena's park table and frees the lane. No allocation, no copy:
        parking cannot fail."""
        ids = self._slot_pages[slot]
        self._slot_pages[slot] = []
        self.arena.park(a.req.rid, ids)
        self.queue.push_parked(_Parked(
            a.req, a.stream, ids, cache_len, resp_len, cur_tok,
            budget - resp_len, self.now()))
        self.done[slot] = True
        self.active[slot] = None
        self.parks += 1
        get_tracer().instant("serving/park", cat="serving", rid=a.req.rid, resp_len=resp_len)

    def step(self) -> bool:
        """One scheduler visit: poll weights, admit, decode, flush.
        Returns True while any work remains (active or queued)."""
        self.poll_weights()
        self._admit()
        if self.num_active:
            with get_tracer().span("serving/burst", cat="serving", active=self.num_active):
                t, occ = self._burst()
                self.bursts += 1
                self.decode_steps += t
                self.active_lane_steps += occ
            with get_tracer().span("serving/flush", cat="serving"):
                self._flush()
        return bool(self.num_active or len(self.queue))

    def serve(self, requests: List[Request], *, realtime: bool = True) -> List[RequestStream]:
        """Drive a whole request stream to completion. ``requests`` carry
        arrival offsets (seconds from call time); with ``realtime`` the
        engine waits for arrivals, otherwise everything is enqueued up front
        (max-pressure replay, arrival stamps kept for TTFT)."""
        t_in = self.now()
        pending = sorted(requests, key=lambda r: r.arrival)
        for r in pending:
            r.arrival += t_in
        i = 0
        while i < len(pending) or self.num_active or len(self.queue):
            while i < len(pending) and (not realtime or pending[i].arrival <= self.now()):
                self.submit(pending[i])
                i += 1
            if not self.step() and i < len(pending) and realtime:
                time.sleep(max(0.0, min(pending[i].arrival - self.now(), 0.01)))
        return [self.streams[r.rid] for r in requests]

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, float]:
        """Aggregate serving metrics over everything streamed so far."""
        finished = [s for s in self.streams.values() if s.finished
                    and s.finish_reason != "rejected"]
        ttft = percentiles([s.ttft for s in finished])
        tpot = percentiles([s.tpot for s in finished])
        wall = self.now()
        lane_steps = self.scfg.num_slots * self.decode_steps
        hit_tokens = self.prefix_cache.hit_tokens if self.prefix_cache else 0
        return {
            "requests_finished": float(len(finished)),
            "tokens": float(self.total_tokens),
            "wall_s": wall,
            "goodput_tokens_per_s": self.total_tokens / wall if wall else 0.0,
            "ttft_p50_s": ttft["p50"],
            "ttft_p99_s": ttft["p99"],
            "tpot_p50_s": tpot["p50"],
            "tpot_p99_s": tpot["p99"],
            "prefix_hit_tokens": float(hit_tokens),
            "prompt_tokens": float(self.prompt_tokens),
            "prefix_hit_rate": (hit_tokens / self.prompt_tokens
                                if self.prompt_tokens else 0.0),
            "prefill_chunks": float(self.prefill_chunks),
            "decode_steps": float(self.decode_steps),
            "bursts": float(self.bursts),
            "slot_occupancy": (self.active_lane_steps / lane_steps
                               if lane_steps else 0.0),
            "parks": float(self.parks),
            "resumes": float(self.resumes),
            "weight_swaps": float(self.weight_swaps),
            "cached_pages": float(self.prefix_cache.num_pages
                                  if self.prefix_cache else 0),
            "pool_pages_used": float(self.arena.num_used),
            "weight_version": float(self._weight_version),
        }
