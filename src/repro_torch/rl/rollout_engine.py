"""Continuous-batching rollout engine of the PyTorch port (port of
``repro.rl.rollout_engine``): slot-refill generation for the GENERATE stage,
with a multi-turn episode loop for agentic environments.

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
    ``refill_threshold`` slots have newly finished while work pends.

The slot state lives in device tensors. The refill, the continuation and
the burst are methods over them; the burst is a host loop of
``model.decode_step_sample`` that reads the slots' done count back before
its first step and after each step, to take the JAX ``lax.while_loop``'s
exit decision, so the slot schedule is the JAX engine's.

Multi-turn episodes (``env=`` an :class:`repro_torch.rl.envs.EnvRuntime`): a
slot whose sequence finishes a *turn* hands its response to the
environment; if the episode continues, it re-enters the :class:`PromptQueue`
as a :class:`_Continuation` carrying its saved cache rows
(``model.gather_cache_rows``, one gather for every continuing slot of a
visit) and the feed tokens ``[last response token] + observation``. When it
is scheduled, the feed is teacher-forced through ``model.decode_step`` over
the saved rows, each row at its own cache offset, and the rows are
scattered over a free slot's arena rows: the shared prompt/response prefix
is never prefilled again, so ``last_stats["prefill_tokens_turn2plus"]``
counts observation tokens plus one carried token a continuation.
Observation tokens are excluded from ``response_mask`` and tagged 2 in the
emitted ``role_mask``. Attention caches only: an SSM's recurrent state
absorbs the steps a done slot keeps taking, so ``max_turns > 1`` on an SSM
stack raises ``ValueError``, as in JAX.

Seed contract: sampling draws hash seeds from the caller's
``torch.Generator`` (``rollout.row_seeds``), one draw of the lane count for
every refill prefill and every continuation, and one of ``num_slots`` for
every decode step, in schedule order. Under a *fixed slot schedule* (one
length bucket, ``num_slots >= batch``: every prompt prefilled at once, no
refill) that is exactly the stream lockstep ``generate`` consumes (one
``row_seeds(gen, B)`` for the prefill sample, then one per decode step) on
the same shapes, so the engine is token for token equal to lockstep
``generate``, sampled as well as greedy
(``tests/test_torch_rollout_engine.py``). The JAX engine's draws come from
threefry keys, so sampled parity with it holds in distribution only; greedy
streams match it token for token, episodes included.

On a tensor-parallel rank mesh (``model`` > 1) every rank of a data row
runs this engine on the same rows over its slot shard of the arena
(``model.init_caches`` under the ambient mesh): the model's calls are the
ranks' collectives, and every host-side decision (the burst's done count,
the refill schedule, the queue's order, the episodes' env steps, the seed
draws) reads a value that is equal on every rank, since the sampler's
tokens are merged over ``model`` (``ops.fused_sample_shard``) and the
prefill's logits gathered. So the ranks take the same schedule, and each
rank's ``last_stats`` are its data row's counts, once.

Metrics (``engine.last_stats``, surfaced by the GENERATE stage as
``rollout/*``): tokens/s, padding waste, slot occupancy, decode steps,
bursts and refills, the prefill token accounting per turn, and under an env
the mean turns and tool calls; ``engine.last_env`` holds each episode's
reward and turns.
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


class _Continuation:
    """A continuing episode waiting for a slot: the dataset row, the feed
    tokens (last response token + clipped observation), the saved cache rows
    (one row of every leaf) and the cache offset the feed starts at."""

    __slots__ = ("row", "feed", "cache_rows", "cache_len")

    def __init__(self, row: int, feed: np.ndarray, cache_rows, cache_len: int):
        self.row = row
        self.feed = np.asarray(feed, np.int32)
        self.cache_rows = cache_rows
        self.cache_len = int(cache_len)


class PromptQueue:
    """Length-bucketed FIFO over one iteration's pending work.

    Fresh prompts: each prompt's true (non-pad) length is rounded up to a
    multiple of ``bucket`` (0 = a single bucket at the batch's padded
    length, the lockstep-equivalent schedule); refills pop from one bucket
    at a time so every prefill batch shares a padded length. Within a
    bucket, dataset order (or ``order``) is preserved.

    Continuations (:meth:`push`, any item with a ``feed`` of tokens, the
    episode loop's :class:`_Continuation`) re-enter the queue in
    exact-feed-length buckets. ``pop_work`` prefers them, bounding the saved
    cache rows held off the arena, but only for ``STARVATION_LIMIT``
    consecutive pops while fresh prompts wait.

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


class _Episode:
    """Host-side record of one multi-turn episode (dataset row)."""

    __slots__ = ("env", "toks", "roles", "lps", "reward", "turn", "infos")

    def __init__(self, env):
        self.env = env
        self.toks: List[int] = []   # tokens after the prompt region
        self.roles: List[int] = []  # 1 = action, 2 = observation
        self.lps: List[float] = []  # behaviour logprobs (0 on observations)
        self.reward = 0.0
        self.turn = 0
        self.infos: List[dict] = []

    def record_turn(self, resp: np.ndarray, lps: np.ndarray) -> None:
        self.toks.extend(int(t) for t in resp)
        self.roles.extend([1] * len(resp))
        self.lps.extend(float(v) for v in lps)

    def record_obs(self, obs: np.ndarray) -> None:
        self.toks.extend(int(t) for t in obs)
        self.roles.extend([2] * len(obs))
        self.lps.extend([0.0] * len(obs))


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
    order). Host code keeps the slot bookkeeping; the refill prefill, the
    continuation feed and the early-exiting decode burst run on the model's
    device.

    ``env`` (an :class:`repro_torch.rl.envs.EnvRuntime`) switches the slot
    loop to the episode loop: one environment per sequence, up to
    ``max_turns`` turns of at most ``turn_budget`` tokens, observations of
    at most ``obs_budget`` tokens appended through cache-preserving
    continuations. With ``env=None`` (the default) it is the single-turn
    engine."""

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
        max_turns: int = 1,
        turn_budget: int = 0,
        obs_budget: int = 16,
    ):
        if model.is_encdec or model.cfg.num_prefix_embeds:
            raise ValueError(
                "the continuous engine supports text decoder-only archs; "
                "use engine='lockstep' for enc-dec / prefix-modality models")
        self.model = model
        self.max_new = max_new
        self.temperature = temperature
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.num_slots = num_slots
        self.prefill_bucket = prefill_bucket
        # minimum count of newly-freed slots before a burst hands control
        # back for refill (while work pends): 1 refills eagerly (maximum
        # occupancy); more trades slot idleness for fewer host round trips
        self.refill_threshold = max(1, refill_threshold)
        # multi-turn episode loop (None = single-turn slot loop)
        self.env = env
        self.max_turns = max(1, max_turns)
        cfg = model.cfg
        if env is not None and self.max_turns > 1 and any(
                k[0] == "ssm" for k in cfg.layer_kinds()):
            # a done slot keeps taking decode steps (fed PAD) until the burst
            # exits; attention tolerates that (the stray K/V lies past the
            # valid cache_len and is overwritten before it is attended), but
            # SSM recurrent state absorbs every update, so the rows saved at
            # a turn's end would resume the next turn from a wrong state
            raise ValueError(
                "multi-turn environments support attention-only archs; "
                f"{cfg.name!r} has SSM mixer layers whose recurrent "
                "state cannot be preserved across turns (use max_turns=1 "
                "or an attention arch)")
        # per-turn response cap (0 = max_new); observation clip per turn
        self.turn_budget = min(turn_budget, max_new) if turn_budget else max_new
        self.obs_budget = max(1, obs_budget)
        # chunked prefill is attention-only (SSM state does not carry between
        # chunks), needs an unwrapped cache (no SWA ring), and excludes int8
        # caches: a chunk would attend the quantized and dequantized K/V of
        # its own prefix, far from whole-prompt prefill
        can_chunk = (all(k[0] == "attn" for k in cfg.layer_kinds())
                     and cfg.sliding_window is None and not cfg.kv_quant)
        self.prefill_chunk = prefill_chunk if can_chunk else 0
        self.last_stats: Dict[str, float] = {}
        # per-episode env outputs of the last call (None when env is off):
        # {"rewards": (B,), "turns": (B,), "tool_calls": int}
        self.last_env: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------ #
    def _seed(self, st: _Slots, logits: torch.Tensor, seeds: torch.Tensor, slots: List[int],
              lane_budget: torch.Tensor, new_len) -> None:
        """Shared epilogue of the refill and the continuation: sample each
        lane's first response token from ``logits``, reset the slots' output
        rows and write the lanes' state into the slot tensors (ids past the
        pool are padding lanes, dropped). ``new_len`` is the lanes' cache
        length after the fill: the bucket width of a refill, a per-lane
        tensor for a continuation."""
        tok0 = sample_token(logits, seeds, self.temperature, self.top_p)
        lp0 = torch.log_softmax(logits, dim=-1).gather(1, tok0[:, None].long())[:, 0]
        done0 = lane_budget <= 1
        if self.eos_id is not None:
            done0 = done0 | (tok0 == self.eos_id)
        S = st.done.shape[0]
        keep = [j for j, s in enumerate(slots) if s < S]
        lanes = torch.tensor(keep, dtype=torch.long, device=tok0.device)
        ids = torch.tensor([slots[j] for j in keep], dtype=torch.long, device=tok0.device)
        st.cur_tok[ids] = tok0[lanes]
        st.cache_len[ids] = (new_len[lanes].to(torch.int32) if isinstance(new_len, torch.Tensor)
                             else new_len)
        st.resp_len[ids] = 1
        st.done[ids] = done0[lanes]
        st.budget[ids] = lane_budget[lanes]
        st.out_tok[ids] = self.pad_id
        st.out_tok[ids, 0] = tok0[lanes]
        st.out_lp[ids] = 0.0
        st.out_lp[ids, 0] = lp0[lanes].float()

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
        self._seed(st, logits, seeds, slots, lane_budget, Lb)

    def _continue(self, params, st: _Slots, rows, slots: List[int], feed: torch.Tensor,
                  start_len: torch.Tensor, lane_budget: torch.Tensor,
                  seeds: torch.Tensor) -> None:
        """Resume continuing episodes on free slots: teacher-force the ``K``
        feed tokens (R, K) (last response token + observation) through
        ``model.decode_step`` over their saved cache rows, each lane at its
        own offset ``start_len``, scatter the rows over the arena at
        ``slots``, and sample each lane's first next-turn token from the last
        feed position's logits. Only the feed is run: the shared prefix is
        reused from the saved rows."""
        model, clen = self.model, start_len
        for k in range(feed.shape[1]):
            logits, rows, clen = model.decode_step(params, feed[:, k], rows, clen)
        model.scatter_cache_rows(st.caches, rows, slots)
        self._seed(st, logits, seeds, slots, lane_budget, clen)

    def _burst(self, params, st: _Slots, gen: torch.Generator, has_pending: bool) -> None:
        """Step every slot until every slot is done, or until
        ``refill_threshold`` slots have newly finished while work pends
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
                self.temperature, top_p=self.top_p)
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

    @staticmethod
    def _stack_cont_rows(items: List[_Continuation], R: int):
        """Stack the saved cache rows of ``items`` (leaves (1, ...)) into
        caches of ``R`` rows, the unused lanes zero."""
        out = []
        for layer in zip(*[c.cache_rows for c in items]):
            stacked = {}
            for name in layer[0]:
                t = torch.cat([rows[name] for rows in layer], dim=0)
                if R > len(items):
                    t = torch.cat([t, t.new_zeros((R - len(items),) + tuple(t.shape[1:]))])
                stacked[name] = t
            out.append(stacked)
        return out

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def __call__(self, params, prompts: torch.Tensor, gen: torch.Generator,
                 budgets=None) -> RolloutResult:
        """``budgets`` (B,) caps each sequence's response length at
        ``min(budgets[b], max_new)``, as lockstep ``generate(budgets=...)``
        does, but a capped sequence frees its slot instead of padding out
        the schedule; under an env the cap applies per turn (jointly with
        ``turn_budget``). ``gen`` draws the sampling seeds and lives on the
        model's device."""
        t_start = time.perf_counter()
        model, max_new, pad = self.model, self.max_new, self.pad_id
        dev = model.device
        prompts_np = np.asarray(prompts.cpu(), np.int32)
        B, Lp = prompts_np.shape
        env_on = self.env is not None
        max_turns = self.max_turns if env_on else 1
        turn_cap = min(self.turn_budget, max_new) if env_on else max_new
        if budgets is None:
            budgets_np = np.full(B, turn_cap, np.int32)
        else:
            b = budgets.cpu() if isinstance(budgets, torch.Tensor) else budgets
            budgets_np = np.clip(np.asarray(b, np.int32), 1, turn_cap)
        S = self.num_slots if self.num_slots > 0 else B
        S = max(1, min(S, B))
        # the arena holds the longest possible episode: the prompt, every
        # turn's response and every inter-turn feed (observation + 1 carried
        # response token)
        smax = Lp + max_turns * max_new + (max_turns - 1) * (self.obs_budget + 1)

        # episode setup: one env per dataset row; reset() gives the turn-1
        # context (the built-ins return the prompt unchanged, so the
        # single-turn schedule and its tokens are untouched)
        episodes: List[Optional[_Episode]] = [None] * B
        if env_on:
            true0 = _true_lengths(prompts_np, pad)
            queue_rows = np.full((B, Lp), pad, np.int32)
            for b in range(B):
                ep = _Episode(self.env.make_episode())
                obs0 = np.asarray(ep.env.reset(prompts_np[b, :true0[b]]), np.int32).ravel()
                if len(obs0) > Lp:
                    raise ValueError(f"env reset() returned {len(obs0)} tokens > prompt "
                                     f"width {Lp}")
                queue_rows[b, :len(obs0)] = obs0
                episodes[b] = ep
        else:
            queue_rows = prompts_np

        # known budgets and a real queue (S < B): longest-first (LPT) slot
        # packing, so long sequences start first instead of draining alone
        # at the tail. With S == B there is no queue, and dataset order is
        # kept: that is the lockstep-equivalent fixed schedule.
        order = (np.argsort(-budgets_np, kind="stable")
                 if budgets is not None and S < B else None)
        queue = PromptQueue(queue_rows, pad_id=pad, bucket=self.prefill_bucket, order=order)
        prefill_true_tokens = int(queue.true_len.sum())

        st = _Slots(model, S, smax, max_new, pad)
        res_tok = torch.full((B, max_new), pad, dtype=torch.int32, device=dev)
        res_lp = torch.zeros((B, max_new), dtype=torch.float32, device=dev)
        res_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        slot_seq = np.full(S, -1, np.int64)  # dataset row held by each slot
        row_cache_pos = np.zeros(B, np.int64)  # cache offset of each episode
        completed = refills = cont_refills = bursts = prefill_lane_tokens = 0
        cont_feed_tokens = obs_tokens = total_turns = tool_calls = 0
        tracer = get_tracer()

        while completed < B:
            # one host read a visit: which held slots are done
            done_h = st.done.cpu().numpy()
            fin = [s for s in range(S) if done_h[s] and slot_seq[s] >= 0]
            if fin and not env_on:
                rows = torch.tensor(slot_seq[fin], dtype=torch.long, device=dev)
                src = torch.tensor(fin, dtype=torch.long, device=dev)
                res_tok[rows] = st.out_tok[src, :max_new]
                res_lp[rows] = st.out_lp[src, :max_new]
                res_len[rows] = st.resp_len[src]
                slot_seq[fin] = -1
                completed += len(fin)
            elif fin:
                # step each finished slot's episode: finish it, or queue a
                # continuation (the cache rows of every continuing slot are
                # gathered in ONE call below, then sliced per episode)
                src = torch.tensor(fin, dtype=torch.long, device=dev)
                n_h = st.resp_len[src].cpu().numpy()
                tok_h = st.out_tok[src, :max_new].cpu().numpy()
                lp_h = st.out_lp[src, :max_new].cpu().numpy()
                pending_conts = []
                for j, s in enumerate(fin):
                    row = int(slot_seq[s])
                    slot_seq[s] = -1
                    ep = episodes[row]
                    n = int(n_h[j])
                    rtoks = tok_h[j, :n].copy()
                    ep.record_turn(rtoks, lp_h[j, :n])
                    row_cache_pos[row] += n - 1  # decode steps this turn
                    obs, r, ep_done, info = ep.env.step(rtoks)
                    ep.reward += float(r)
                    ep.turn += 1
                    ep.infos.append(info or {})
                    total_turns += 1
                    if info and info.get("tool_call"):
                        tool_calls += 1
                    if ep_done or ep.turn >= max_turns:
                        completed += 1
                        continue
                    obs = np.asarray(obs, np.int32).ravel()[:self.obs_budget]
                    ep.record_obs(obs)
                    # the last response token's K/V was never written (it
                    # was sampled, not fed), so it leads the feed; the saved
                    # rows carry the whole shared prefix
                    feed = np.concatenate([rtoks[-1:], obs])
                    pending_conts.append((s, row, feed))
                    cont_feed_tokens += len(feed)
                    obs_tokens += len(obs)
                if pending_conts:
                    saved = model.gather_cache_rows(st.caches, [s for s, _, _ in pending_conts])
                    for j, (_, row, feed) in enumerate(pending_conts):
                        rows_j = [{name: leaf[j:j + 1] for name, leaf in c.items()}
                                  for c in saved]
                        queue.push(_Continuation(row, feed, rows_j, row_cache_pos[row]))
                        row_cache_pos[row] += len(feed)
            if completed >= B:
                break
            # refill every free slot, one call per homogeneous batch
            # (continuations first, then fresh-prompt length buckets)
            free = [s for s in range(S) if slot_seq[s] < 0]
            while free and len(queue):
                kind, L, items = queue.pop_work(len(free))
                lanes, free = free[:len(items)], free[len(items):]
                # pad the batch to the next power of two (capped at the pool
                # size): a late single-slot refill runs 1 lane, and a
                # full-pool fill keeps the pool's shape, which is what the
                # lockstep-equivalent schedule runs
                R = 1
                while R < len(items):
                    R *= 2
                R = min(R, S)
                slots = lanes + [S] * (R - len(lanes))
                lane_budget = np.full(R, max_new, np.int32)
                if kind == "prefill":
                    batch = np.zeros((R, L), np.int32)
                    batch[:len(items)] = queue.prompts[items][:, :L]
                    lane_budget[:len(items)] = budgets_np[items]
                    with tracer.span("rollout/prefill", cat="rollout", lanes=R, width=L,
                                     seqs=len(items)):
                        self._refill(params, st, torch.from_numpy(batch).to(dev), slots,
                                     torch.from_numpy(lane_budget).to(dev), row_seeds(gen, R),
                                     smax)
                    slot_seq[lanes] = items
                    row_cache_pos[items] = L
                    refills += 1
                    # the lanes the prefill ran, padding lanes included
                    prefill_lane_tokens += R * L
                else:  # continuation: feed tokens only, saved rows reused
                    feed = np.zeros((R, L), np.int32)
                    start_len = np.zeros(R, np.int32)
                    for j, c in enumerate(items):
                        feed[j], start_len[j] = c.feed, c.cache_len
                        lane_budget[j] = budgets_np[c.row]
                    with tracer.span("rollout/refill", cat="rollout", lanes=R, width=L,
                                     conts=len(items)):
                        self._continue(params, st, self._stack_cont_rows(items, R), slots,
                                       torch.from_numpy(feed).to(dev),
                                       torch.from_numpy(start_len).to(dev),
                                       torch.from_numpy(lane_budget).to(dev), row_seeds(gen, R))
                    slot_seq[lanes] = [c.row for c in items]
                    cont_refills += 1
            if not (slot_seq >= 0).any():
                break  # queue drained and nothing in flight
            # a lane refilled already done (EOS at its first token, or budget
            # 1) is in the burst's entry count, so the burst does not take it
            # for a fresh completion; it flushes on the next visit.
            # Work pends while prompts wait or while an in-flight episode may
            # come back as a continuation; without the second, a drained
            # prompt queue would hold every finished slot until the slowest
            # turn ends (lockstep turns). An episode below its turn cap counts
            # even if its env ends it (one extra host visit at most).
            cont_possible = env_on and max_turns > 1 and any(
                slot_seq[s] >= 0 and episodes[slot_seq[s]].turn + 1 < max_turns
                for s in range(S))
            with tracer.span("rollout/decode", cat="rollout", burst=bursts,
                             completed=completed):
                self._burst(params, st, gen, has_pending=len(queue) > 0 or cont_possible)
            bursts += 1

        # assemble the RolloutResult in dataset order
        roles = None
        if not env_on:
            pos = torch.arange(max_new, device=dev)
            resp_mask = pos[None, :] < res_len[:, None]
            prompt_t = torch.from_numpy(prompts_np).to(dev)
            tokens = torch.cat([prompt_t, res_tok], dim=1)
            mask = torch.cat([torch.zeros((B, Lp), dtype=torch.bool, device=dev), resp_mask],
                             dim=1)
            old_lp = torch.cat([torch.zeros((B, Lp), device=dev), res_lp], dim=1)
            total_turns = completed  # one turn a sequence
            self.last_env = None
        else:
            Lmax = Lp + max_turns * max_new + (max_turns - 1) * self.obs_budget
            tok_np = np.full((B, Lmax), pad, np.int32)
            tok_np[:, :Lp] = queue_rows
            role_np = np.zeros((B, Lmax), np.int8)
            lp_np = np.zeros((B, Lmax), np.float32)
            rewards = np.zeros(B, np.float32)
            turns = np.zeros(B, np.int32)
            for b, ep in enumerate(episodes):
                n = len(ep.toks)
                tok_np[b, Lp:Lp + n] = ep.toks
                role_np[b, Lp:Lp + n] = ep.roles
                lp_np[b, Lp:Lp + n] = ep.lps
                rewards[b], turns[b] = ep.reward, ep.turn
            mask_np = role_np == 1
            tokens = torch.from_numpy(tok_np).to(dev)
            mask = torch.from_numpy(mask_np).to(dev)
            old_lp = torch.from_numpy(np.where(mask_np, lp_np, 0.0).astype(np.float32)).to(dev)
            res_len = torch.from_numpy(mask_np.sum(axis=1).astype(np.int32)).to(dev)
            roles = torch.from_numpy(role_np).to(dev)
            self.last_env = {"rewards": rewards, "turns": turns, "tool_calls": tool_calls}

        steps, occ_steps = st.steps, int(st.occ)
        gen_tokens = int(res_len.sum())
        wall = time.perf_counter() - t_start
        # each turn's first token comes from its refill's or continuation's
        # sample, not a decode step
        decode_tokens = gen_tokens - total_turns
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
            # turn 1 prefills the true prompt tokens; every later turn feeds
            # ONLY the observation plus one carried response token through
            # the decode path (the saved rows hold the rest)
            "prefill_tokens": float(prefill_true_tokens + cont_feed_tokens),
            "prefill_tokens_turn1": float(prefill_true_tokens),
            "prefill_tokens_turn2plus": float(cont_feed_tokens),
            "obs_tokens": float(obs_tokens),
            "cont_refills": float(cont_refills),
            "turns": float(total_turns),
        }
        if env_on:
            self.last_stats["turns_mean"] = total_turns / B if B else 0.0
            self.last_stats["tool_calls"] = float(tool_calls)
        return RolloutResult(tokens, mask, old_lp, res_len, roles)


def lockstep_waste(lengths, max_new: int) -> float:
    """Padding waste of the lockstep schedule for the same responses: the
    fraction of decode lane-steps (B x (max_new - 1)) that produced no
    counted token."""
    lengths = np.asarray(lengths)
    B = len(lengths)
    lane_steps = B * max(max_new - 1, 1)
    decode_tokens = int(lengths.sum()) - B
    return 1.0 - decode_tokens / lane_steps if lane_steps else 0.0
