"""Continuous-batching rollout engine of the PyTorch port (port of the
single-turn engine of ``repro.rl.rollout_engine``): slot-refill generation
for the GENERATE stage.

The lockstep path (:func:`repro_torch.rl.rollout.generate`) pads every
prompt to a common length and runs all ``max_new - 1`` decode steps even
after every sequence has emitted EOS. This engine instead:

  * keeps a fixed pool of ``num_slots`` decode slots over ONE persistent
    cache arena (``model.init_caches(num_slots, smax)``); slot *i* is batch
    row *i* of every cache leaf and carries its own ``cache_len``;
  * frees a slot when its sequence hits EOS or its token budget, and refills
    it with the next prompt of the :class:`PromptQueue`: a fresh prefill is
    scattered over the slot's cache rows (``model.scatter_cache_rows``)
    while the other slots' state is untouched;
  * buckets the refills by true prompt length (``prefill_bucket``), so a
    refill batch prefills at its bucket width, and optionally chunks them
    (``model.prefill_chunk``);
  * leaves the decode loop as soon as every slot is done, or as soon as
    ``refill_threshold`` slots have newly finished while prompts pend.

The slot state lives in device tensors. The refill and the burst are
methods over them; the burst is a host loop of ``model.decode_step_sample``
that reads the slots' done count back before its first step and after
each step, to take the JAX ``lax.while_loop``'s exit decision, so the
slot schedule is the JAX engine's.

Seed contract: sampling draws hash seeds from the caller's
``torch.Generator`` (``rollout.row_seeds``), one draw of the refill's lane
count for every refill prefill and one of ``num_slots`` for every decode
step, in schedule order. Under a *fixed slot schedule* (one length bucket,
``num_slots >= batch``: every prompt prefilled at once, no refill) that is
exactly the stream lockstep ``generate`` consumes (one ``row_seeds(gen, B)``
for the prefill sample, then one per decode step) on the same shapes, so
the engine is token for token equal to lockstep ``generate``, sampled as
well as greedy (``tests/test_torch_rollout_engine.py``). The JAX engine's
draws come from threefry keys, so sampled parity with it holds in
distribution only; greedy streams match it token for token.

Multi-turn episodes (``env=``) are ROADMAP queue 1, item 5, and raise.
:class:`PromptQueue`'s continuation lane (``push`` and ``pop_work``'s
``"cont"`` branch) is ported with the queue but has no caller yet: the
single-turn engine pushes nothing, so its ``pop_work`` is ``pop``; the
episode loop of item 5 is the lane's caller.

Metrics (``engine.last_stats``, surfaced by the GENERATE stage as
``rollout/*``): tokens/s, padding waste, slot occupancy, decode steps,
bursts and refills, and the prefill token accounting.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.obs.trace import get_tracer
from repro_torch.rl.rollout import RolloutResult, row_seeds, sample_token


def _true_lengths(prompts: np.ndarray, pad_id: int) -> np.ndarray:
    """Per-row count of tokens up to and including the last non-pad token
    (right-padded prompts; a fully-pad row counts 1 so it still prefills)."""
    nonpad = prompts != pad_id
    rev = nonpad[:, ::-1]
    last = prompts.shape[1] - np.argmax(rev, axis=1)  # index after last non-pad
    return np.where(nonpad.any(axis=1), last, 1).astype(np.int64)


class PromptQueue:
    """Length-bucketed FIFO over one iteration's pending work.

    Fresh prompts: each prompt's true (non-pad) length is rounded up to a
    multiple of ``bucket`` (0 = a single bucket at the batch's padded
    length, the lockstep-equivalent schedule); refills pop from one bucket
    at a time so every prefill batch shares a padded length. Within a
    bucket, dataset order (or ``order``) is preserved.

    Continuations (:meth:`push`, any item with a ``feed`` of tokens) re-enter
    the queue in exact-feed-length buckets. ``pop_work`` prefers them, but
    only for ``STARVATION_LIMIT`` consecutive pops while fresh prompts wait.
    The single-turn engine pushes none; the multi-turn episode loop that
    does is ROADMAP queue 1, item 5.

    Both lanes pick the *fullest* bucket; a pass counter ages each non-empty
    bucket that loses the selection and force-serves any bucket passed over
    ``STARVATION_LIMIT`` times, so every pending item is served within a
    bounded number of pops.
    """

    STARVATION_LIMIT = 4  # max times a non-empty lane/bucket is passed over

    def __init__(self, prompts: np.ndarray, *, pad_id: int, bucket: int = 0,
                 order=None):
        self.prompts = prompts
        B, Lp = prompts.shape
        self.true_len = _true_lengths(prompts, pad_id)
        if bucket <= 0:
            blens = np.full(B, Lp, np.int64)
        else:
            blens = np.minimum(-(-self.true_len // bucket) * bucket, Lp)
        self.bucket_len = blens
        self._buckets: Dict[int, deque] = {}
        self._cont: Dict[int, deque] = {}
        self._passes: Dict[int, int] = {}  # fresh-bucket aging
        self._cont_passes: Dict[int, int] = {}  # cont-bucket aging
        self._cont_streak = 0  # cont pops in a row while fresh waited
        for i in (range(B) if order is None else order):
            self._buckets.setdefault(int(blens[i]), deque()).append(int(i))

    def __len__(self) -> int:
        return (sum(len(q) for q in self._buckets.values())
                + sum(len(q) for q in self._cont.values()))

    def push(self, cont) -> None:
        """Re-enqueue a continuing episode (an item with a ``feed``)."""
        self._cont.setdefault(len(cont.feed), deque()).append(cont)

    @staticmethod
    def _select(buckets: Dict[int, deque], passes: Dict[int, int], limit: int) -> int:
        """Fullest bucket, unless one has been passed over ``limit`` times
        (then the oldest-starved, shortest-length one). Losing non-empty
        buckets age by one pass; the winner's counter resets."""
        aged = [b for b in buckets if passes.get(b, 0) >= limit]
        if aged:
            sel = min(aged, key=lambda b: (-passes[b], b))
        else:
            sel = max(buckets, key=lambda b: (len(buckets[b]), -b))
        for b in buckets:
            if b != sel:
                passes[b] = passes.get(b, 0) + 1
        passes.pop(sel, None)
        return sel

    def pop(self, n: int) -> Tuple[int, List[int]]:
        """Pop up to ``n`` fresh-prompt indices from the fullest bucket (ties
        break toward the shorter bucket length), except that a bucket passed
        over ``STARVATION_LIMIT`` times is served first. Returns
        (bucket_len, indices); FIFO within the bucket."""
        lb = self._select(self._buckets, self._passes, self.STARVATION_LIMIT)
        q = self._buckets[lb]
        take = [q.popleft() for _ in range(min(n, len(q)))]
        if not q:
            del self._buckets[lb]
        return lb, take

    def pop_work(self, n: int):
        """Pop up to ``n`` homogeneous work items: ``("cont", feed_len,
        [item, ...])`` or ``("prefill", bucket_len, [row, ...])``.
        Continuations go first until they have monopolized
        ``STARVATION_LIMIT`` consecutive pops with fresh prompts waiting;
        then one fresh bucket is served. With no continuations this is
        exactly :meth:`pop`."""
        serve_cont = self._cont and (
            not self._buckets or self._cont_streak < self.STARVATION_LIMIT)
        if serve_cont:
            self._cont_streak = self._cont_streak + 1 if self._buckets else 0
            K = self._select(self._cont, self._cont_passes, self.STARVATION_LIMIT)
            q = self._cont[K]
            take = [q.popleft() for _ in range(min(n, len(q)))]
            if not q:
                del self._cont[K]
            return "cont", K, take
        self._cont_streak = 0
        lb, idxs = self.pop(n)
        return "prefill", lb, idxs


class _Slots:
    """The slot pool's device state: the cache arena and, per slot, the
    current token, cache length, response length, done flag, budget and the
    response written so far (tokens and logprobs, with one spare column
    that takes the writes of slots with nothing to write)."""

    def __init__(self, model: Model, S: int, smax: int, max_new: int, pad_id: int):
        dev = model.device
        self.caches = model.init_caches(S, smax)
        self.cur_tok = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.cache_len = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.resp_len = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.done = torch.ones((S,), dtype=torch.bool, device=dev)  # every slot starts free
        self.budget = torch.full((S,), max_new, dtype=torch.int32, device=dev)
        self.out_tok = torch.full((S, max_new + 1), pad_id, dtype=torch.int32, device=dev)
        self.out_lp = torch.zeros((S, max_new + 1), dtype=torch.float32, device=dev)
        self.occ = torch.zeros((), dtype=torch.int64, device=dev)  # active lane-steps
        self.steps = 0  # decode steps taken


class ContinuousRolloutEngine:
    """Slot-based continuous-batching generation engine.

    Drop-in for lockstep ``generate`` at the GENERATE stage: callable as
    ``engine(params, prompts, gen) -> RolloutResult`` with the same output
    contract (tokens / response_mask / old_logprob / lengths in dataset
    order). Host code keeps the slot bookkeeping; the refill prefill and the
    early-exiting decode burst run on the model's device."""

    def __init__(
        self,
        model: Model,
        *,
        max_new: int,
        temperature: float = 1.0,
        top_p: float = 1.0,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        num_slots: int = 0,
        prefill_chunk: int = 0,
        prefill_bucket: int = 0,
        refill_threshold: int = 1,
        env=None,
    ):
        if model.is_encdec or model.cfg.num_prefix_embeds:
            raise ValueError(
                "the continuous engine supports text decoder-only archs; "
                "use engine='lockstep' for enc-dec / prefix-modality models")
        if env is not None:
            raise NotImplementedError(
                "multi-turn environments in the continuous engine are not ported yet "
                "(ROADMAP queue 1, item 5: multi-turn environments)")
        if top_p < 1.0:
            raise NotImplementedError(
                "top_p < 1 is not ported yet (ROADMAP queue 1, item 6: other families)")
        self.model = model
        self.max_new = max_new
        self.temperature = temperature
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.num_slots = num_slots
        self.prefill_bucket = prefill_bucket
        # minimum count of newly-freed slots before a burst hands control
        # back for refill (while prompts pend): 1 refills eagerly (maximum
        # occupancy); more trades slot idleness for fewer host round trips
        self.refill_threshold = max(1, refill_threshold)
        # chunked prefill is attention-only (SSM state does not carry between
        # chunks), needs an unwrapped cache (no SWA ring), and excludes int8
        # caches: a chunk would attend the quantized and dequantized K/V of
        # its own prefix, far from whole-prompt prefill
        cfg = model.cfg
        can_chunk = (all(k[0] == "attn" for k in cfg.layer_kinds())
                     and cfg.sliding_window is None and not cfg.kv_quant)
        self.prefill_chunk = prefill_chunk if can_chunk else 0
        self.last_stats: Dict[str, float] = {}

    # ------------------------------------------------------------------ #
    def _refill(self, params, st: _Slots, prompts: torch.Tensor, slots: List[int],
                lane_budget: torch.Tensor, seeds: torch.Tensor, smax: int) -> None:
        """Prefill ``prompts`` (R, Lb), scatter the fresh cache rows over the
        arena at ``slots`` (ids past the pool are padding lanes, dropped),
        sample each lane's first response token and reset the slots' rows."""
        model, R, Lb = self.model, prompts.shape[0], prompts.shape[1]
        chunk = self.prefill_chunk
        if chunk > 0:
            rows = model.init_caches(R, smax)
            for off in range(0, Lb, chunk):
                logits, rows = model.prefill_chunk(params, prompts[:, off:off + chunk], rows,
                                                   offset=off)
        else:
            logits, rows, _ = model.prefill(params, prompts, smax=smax)
        model.scatter_cache_rows(st.caches, rows, slots)

        tok0 = sample_token(logits, seeds, self.temperature)
        lp0 = torch.log_softmax(logits, dim=-1).gather(1, tok0[:, None].long())[:, 0]
        done0 = lane_budget <= 1
        if self.eos_id is not None:
            done0 = done0 | (tok0 == self.eos_id)
        S = st.done.shape[0]
        keep = [j for j, s in enumerate(slots) if s < S]
        lanes = torch.tensor(keep, dtype=torch.long, device=tok0.device)
        ids = torch.tensor([slots[j] for j in keep], dtype=torch.long, device=tok0.device)
        st.cur_tok[ids] = tok0[lanes]
        st.cache_len[ids] = Lb
        st.resp_len[ids] = 1
        st.done[ids] = done0[lanes]
        st.budget[ids] = lane_budget[lanes]
        st.out_tok[ids] = self.pad_id
        st.out_tok[ids, 0] = tok0[lanes]
        st.out_lp[ids] = 0.0
        st.out_lp[ids, 0] = lp0[lanes].float()

    def _burst(self, params, st: _Slots, gen: torch.Generator, has_pending: bool) -> None:
        """Step every slot until every slot is done, or until
        ``refill_threshold`` slots have newly finished while prompts pend
        (the JAX burst's ``cond``, checked before each step as its
        ``while_loop`` does). Reads the done count back before the first
        step and after each step."""
        S, max_new, pad = st.done.shape[0], self.max_new, self.pad_id
        n_entry = n_done = int(st.done.sum())
        while n_done < S and (n_done - n_entry < self.refill_threshold or not has_pending):
            done = st.done
            st.occ += (~done).sum()
            nxt, lp, st.caches, st.cache_len = self.model.decode_step_sample(
                params, st.cur_tok, st.caches, st.cache_len, row_seeds(gen, S),
                self.temperature)
            nxt = torch.where(done, pad, nxt)
            lp = torch.where(done, 0.0, lp)
            wr = (~done) & (st.resp_len < max_new)
            idx = torch.where(wr, st.resp_len, max_new).long()[:, None]  # max_new: spare
            st.out_tok.scatter_(1, idx, nxt[:, None])
            st.out_lp.scatter_(1, idx, lp[:, None].float())
            st.resp_len = st.resp_len + wr.to(torch.int32)
            new_done = done | (st.resp_len >= st.budget)
            if self.eos_id is not None:
                new_done = new_done | (nxt == self.eos_id)
            st.cur_tok, st.done = nxt, new_done
            st.steps += 1
            n_done = int(new_done.sum())

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def __call__(self, params, prompts: torch.Tensor, gen: torch.Generator,
                 budgets=None) -> RolloutResult:
        """``budgets`` (B,) caps each sequence's response length at
        ``min(budgets[b], max_new)``, as lockstep ``generate(budgets=...)``
        does, but a capped sequence frees its slot instead of padding out
        the schedule. ``gen`` draws the sampling seeds and lives on the
        model's device."""
        t_start = time.perf_counter()
        model, max_new, pad = self.model, self.max_new, self.pad_id
        dev = model.device
        prompts_np = np.asarray(prompts.cpu(), np.int32)
        B, Lp = prompts_np.shape
        if budgets is None:
            budgets_np = np.full(B, max_new, np.int32)
        else:
            b = budgets.cpu() if isinstance(budgets, torch.Tensor) else budgets
            budgets_np = np.clip(np.asarray(b, np.int32), 1, max_new)
        S = self.num_slots if self.num_slots > 0 else B
        S = max(1, min(S, B))
        smax = Lp + max_new

        # known budgets and a real queue (S < B): longest-first (LPT) slot
        # packing, so long sequences start first instead of draining alone
        # at the tail. With S == B there is no queue, and dataset order is
        # kept: that is the lockstep-equivalent fixed schedule.
        order = (np.argsort(-budgets_np, kind="stable")
                 if budgets is not None and S < B else None)
        queue = PromptQueue(prompts_np, pad_id=pad, bucket=self.prefill_bucket, order=order)
        prefill_true_tokens = int(queue.true_len.sum())

        st = _Slots(model, S, smax, max_new, pad)
        res_tok = torch.full((B, max_new), pad, dtype=torch.int32, device=dev)
        res_lp = torch.zeros((B, max_new), dtype=torch.float32, device=dev)
        res_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        slot_seq = np.full(S, -1, np.int64)  # dataset row held by each slot
        completed = refills = bursts = prefill_lane_tokens = 0
        tracer = get_tracer()

        while completed < B:
            # one host read a visit: which held slots are done
            done_h = st.done.cpu().numpy()
            fin = [s for s in range(S) if done_h[s] and slot_seq[s] >= 0]
            if fin:
                rows = torch.tensor(slot_seq[fin], dtype=torch.long, device=dev)
                src = torch.tensor(fin, dtype=torch.long, device=dev)
                res_tok[rows] = st.out_tok[src, :max_new]
                res_lp[rows] = st.out_lp[src, :max_new]
                res_len[rows] = st.resp_len[src]
                slot_seq[fin] = -1
                completed += len(fin)
            if completed >= B:
                break
            # refill every free slot, one prefill per homogeneous batch
            free = [s for s in range(S) if slot_seq[s] < 0]
            while free and len(queue):
                _, L, idxs = queue.pop_work(len(free))
                lanes, free = free[:len(idxs)], free[len(idxs):]
                # pad the batch to the next power of two (capped at the pool
                # size): a late single-slot refill runs 1 lane, and a
                # full-pool fill keeps the pool's shape, which is what the
                # lockstep-equivalent schedule runs
                R = 1
                while R < len(idxs):
                    R *= 2
                R = min(R, S)
                batch = np.zeros((R, L), np.int32)
                batch[:len(idxs)] = queue.prompts[idxs][:, :L]
                lane_budget = np.full(R, max_new, np.int32)
                lane_budget[:len(idxs)] = budgets_np[idxs]
                with tracer.span("rollout/prefill", cat="rollout", lanes=R, width=L,
                                 seqs=len(idxs)):
                    self._refill(params, st, torch.from_numpy(batch).to(dev),
                                 lanes + [S] * (R - len(lanes)),
                                 torch.from_numpy(lane_budget).to(dev), row_seeds(gen, R), smax)
                slot_seq[lanes] = idxs
                refills += 1
                # the lanes the prefill ran, padding lanes included
                prefill_lane_tokens += R * L
            if not (slot_seq >= 0).any():
                break  # queue drained and nothing in flight
            # a lane refilled already done (EOS at its first token, or budget
            # 1) is in the burst's entry count, so the burst does not take it
            # for a fresh completion; it flushes on the next visit
            with tracer.span("rollout/decode", cat="rollout", burst=bursts,
                             completed=completed):
                self._burst(params, st, gen, has_pending=len(queue) > 0)
            bursts += 1

        # assemble the RolloutResult in dataset order
        pos = torch.arange(max_new, device=dev)
        resp_mask = pos[None, :] < res_len[:, None]
        prompt_t = torch.from_numpy(prompts_np).to(dev)
        tokens = torch.cat([prompt_t, res_tok], dim=1)
        mask = torch.cat([torch.zeros((B, Lp), dtype=torch.bool, device=dev), resp_mask], dim=1)
        old_lp = torch.cat([torch.zeros((B, Lp), device=dev), res_lp], dim=1)

        steps, occ_steps = st.steps, int(st.occ)
        gen_tokens = int(res_len.sum())
        wall = time.perf_counter() - t_start
        # each sequence's first token comes from its refill's sample, not a
        # decode step
        decode_tokens = gen_tokens - B
        lane_steps = S * steps
        self.last_stats = {
            "tokens": float(gen_tokens),
            "wall_s": wall,
            "tokens_per_s": gen_tokens / wall if wall > 0 else 0.0,
            "decode_steps": float(steps),
            "bursts": float(bursts),
            "refills": float(refills),
            "num_slots": float(S),
            "slot_occupancy": occ_steps / lane_steps if lane_steps else 1.0,
            "padding_waste": 1.0 - decode_tokens / lane_steps if lane_steps else 0.0,
            "prefill_lane_tokens": float(prefill_lane_tokens),
            "prefill_true_tokens": float(prefill_true_tokens),
            "prefill_waste": (1.0 - prefill_true_tokens / prefill_lane_tokens
                              if prefill_lane_tokens else 0.0),
        }
        return RolloutResult(tokens, mask, old_lp, res_len)


def lockstep_waste(lengths, max_new: int) -> float:
    """Padding waste of the lockstep schedule for the same responses: the
    fraction of decode lane-steps (B x (max_new - 1)) that produced no
    counted token."""
    lengths = np.asarray(lengths)
    B = len(lengths)
    lane_steps = B * max(max_new - 1, 1)
    decode_tokens = int(lengths.sum()) - B
    return 1.0 - decode_tokens / lane_steps if lane_steps else 0.0
