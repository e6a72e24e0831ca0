"""Straggler mitigation (the port's copy of ``repro.ft.straggler``, which
imports no JAX).

The paper (§2.2) identifies rollout long-tails as the dominant utilization
loss, and (§6.2) repacks a variable-length batch so that the contiguous
data-parallel shards of the reordered batch carry near-equal token work.
The worker's ``load_balance`` option calls :func:`balance_by_length` and
reports :func:`bucket_token_ratio` before and after.

The multi-host half comes with the JAX module's semantics: between
iterations, per-host step times are compared; hosts slower than
``threshold`` x median (or dead hosts, detected by missed heartbeats,
:class:`HeartbeatMonitor`) hand their upcoming dataset partitions to the
fastest hosts. :func:`rebalance` is a pure function host_times ->
partition map, so every worker computes the identical new assignment with
no coordinator. :func:`cross_host_rows` counts the rows a hierarchical
repack moves across hosts and :func:`inverse_permutation` undoes a repack.
The port's fleet (ROADMAP queue 1, item 8) is their caller; until then
they are held against the JAX module's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def rebalance(
    host_times: Sequence[float],
    *,
    threshold: float = 1.5,
    dead: Sequence[int] = (),
) -> Dict[int, List[int]]:
    """Deterministic partition map: host -> list of dp-shard ids it loads.

    Healthy hosts keep their own shard; shards of slow/dead hosts are
    re-assigned round-robin to the fastest healthy hosts.
    """
    n = len(host_times)
    times = np.asarray(host_times, dtype=np.float64)
    healthy = [i for i in range(n) if i not in set(dead)]
    if not healthy:
        raise RuntimeError("no healthy hosts")
    med = float(np.median(times[healthy]))
    slow = {i for i in healthy if times[i] > threshold * med}
    donors = sorted(set(dead) | slow)
    receivers = sorted(
        (i for i in healthy if i not in slow), key=lambda i: times[i]
    ) or healthy

    out: Dict[int, List[int]] = {i: [] for i in range(n)}
    for i in healthy:
        if i not in slow:
            out[i].append(i)
    for j, shard in enumerate(donors):
        out[receivers[j % len(receivers)]].append(shard)
    return out


def balance_by_length(
    lengths: Sequence[float],
    num_buckets: int,
    *,
    group_size: int = 1,
    capacities: Optional[Sequence[int]] = None,
    hosts: int = 1,
    inter_host_tolerance: float = 1.25,
) -> np.ndarray:
    """Length-aware load balancing (paper §6.2): permutation repacking a
    variable-length batch into ``num_buckets`` equal-row, near-equal-TOKEN
    buckets, so that contiguous DP shards of the reordered batch carry
    balanced work and one long rollout no longer stalls every peer.

    Greedy longest-processing-time binning at *group* granularity: groups of
    ``group_size`` consecutive rows (GRPO prompt groups; 1 for PPO) are kept
    intact — their member rows move together — sorted by token weight
    descending, each assigned to the non-full bucket with the smallest token
    total. Deterministic (ties break on group index), so every DAG Worker
    derives the identical permutation with no coordinator, exactly like
    :func:`rebalance`.

    ``capacities`` (rows-per-bucket in units of groups) defaults to an even
    split; pass the shard counts from a :func:`rebalance` partition map to
    skew capacity toward fast hosts (the two mitigations compose: rebalance
    decides WHO loads how much, balance_by_length decides WHICH sequences).

    ``hosts > 1`` enables the **hierarchical mode** for multi-host fleet
    meshes (docs/multihost.md): rows start resident on the host that
    generated them (host h owns the contiguous block of ``n/hosts`` rows),
    and moving a token across the inter-pod links is far more expensive
    than moving it between a host's local devices. So groups are first
    binned *within* their resident host's local buckets; only when the
    per-host token totals exceed ``inter_host_tolerance`` x mean are
    equal-row-count group *swaps* made across the pod axis (heaviest host
    with lightest, the swap that best halves their gap), and the swap loop
    stops the moment the totals are back under tolerance — the repack
    permutation never crosses the slow axis unnecessarily. Count the
    crossings with :func:`cross_host_rows`.

    Returns a permutation ``perm`` of ``len(lengths)`` row indices: bucket b
    owns rows ``perm[start_b : start_b + rows_b]``. Invert with
    :func:`inverse_permutation`.
    """
    w = np.asarray(lengths, dtype=np.float64)
    n = len(w)
    if n % group_size:
        raise ValueError(f"batch {n} not divisible by group_size {group_size}")
    n_groups = n // group_size
    gw = w.reshape(n_groups, group_size).sum(axis=1)

    if hosts > 1:
        if capacities is not None:
            raise ValueError("hierarchical mode derives capacities from the "
                             "host layout; pass capacities only with hosts=1")
        if num_buckets % hosts or n_groups % hosts:
            raise ValueError(
                f"hierarchical mode needs buckets ({num_buckets}) and groups "
                f"({n_groups}) divisible by hosts ({hosts})")
        assign = _hierarchical_assign(gw, hosts, inter_host_tolerance)
        local_buckets = num_buckets // hosts
        perm = np.empty(n, dtype=np.int64)
        pos = 0
        for h in range(hosts):
            sub = assign[h]  # group ids resident on host h after swaps
            sub_perm = balance_by_length(
                w.reshape(n_groups, group_size)[sub].reshape(-1),
                local_buckets, group_size=group_size)
            # sub_perm indexes into sub's rows; lift back to global rows
            rows = (np.asarray(sub)[:, None] * group_size
                    + np.arange(group_size)[None, :]).reshape(-1)
            perm[pos : pos + len(rows)] = rows[sub_perm]
            pos += len(rows)
        return perm

    if capacities is None:
        base, extra = divmod(n_groups, num_buckets)
        capacities = [base + (1 if b < extra else 0) for b in range(num_buckets)]
    capacities = list(capacities)
    if sum(capacities) != n_groups:
        raise ValueError(f"capacities {capacities} must sum to {n_groups} groups")

    order = sorted(range(n_groups), key=lambda g: (-gw[g], g))
    totals = np.zeros(num_buckets)
    fill = [0] * num_buckets
    buckets: List[List[int]] = [[] for _ in range(num_buckets)]
    for g in order:
        open_b = [b for b in range(num_buckets) if fill[b] < capacities[b]]
        b = min(open_b, key=lambda b: (totals[b], b))
        buckets[b].append(g)
        totals[b] += gw[g]
        fill[b] += 1

    perm = np.empty(n, dtype=np.int64)
    pos = 0
    for b in range(num_buckets):
        for g in sorted(buckets[b]):  # stable within-bucket order
            rows = np.arange(g * group_size, (g + 1) * group_size)
            perm[pos : pos + group_size] = rows
            pos += group_size
    return perm


def _hierarchical_assign(
    gw: np.ndarray, hosts: int, tolerance: float
) -> List[List[int]]:
    """Group ids per host after cross-host swap migration.

    Host h starts owning the contiguous block of ``n_groups/hosts`` groups
    (residency). While ``max(host_tokens) / mean > tolerance``, swap one
    group between the heaviest and lightest hosts — the pair whose exchange
    best narrows their gap — so row counts per host never change (contiguous
    DP shards need equal rows). Deterministic: ties break on group index,
    and a swap is only taken if it strictly reduces the heavy host's total.
    """
    n_groups = len(gw)
    per = n_groups // hosts
    assign = [list(range(h * per, (h + 1) * per)) for h in range(hosts)]
    totals = np.array([gw[a].sum() for a in assign])
    mean = totals.mean()
    if mean <= 0:
        return assign
    for _ in range(n_groups):  # bounded; each swap strictly reduces max
        if totals.max() / mean <= tolerance:
            break
        hi = int(np.argmax(totals))
        lo = int(np.argmin(totals))
        gap = totals[hi] - totals[lo]
        # best swap: heavy group out, light group in, moving ~gap/2
        best = None
        for i, ga in enumerate(assign[hi]):
            for j, gb in enumerate(assign[lo]):
                delta = gw[ga] - gw[gb]
                if delta <= 0:
                    continue
                # post-swap gap magnitude; strict improvement required
                score = abs(gap - 2 * delta)
                if best is None or score < best[0]:
                    best = (score, i, j, delta)
        if best is None or best[0] >= gap:
            break
        _, i, j, delta = best
        assign[hi][i], assign[lo][j] = assign[lo][j], assign[hi][i]
        assign[hi].sort()
        assign[lo].sort()
        totals[hi] -= delta
        totals[lo] += delta
    return assign


def cross_host_rows(perm: np.ndarray, hosts: int) -> int:
    """Rows whose resident host (contiguous block of the ORIGINAL order)
    differs from the host slot of their position in ``perm`` — the count of
    rows the repack moves across the slow inter-pod axis."""
    n = len(perm)
    per = n // hosts
    dest = np.arange(n) // per  # host slot of each perm position
    src = np.asarray(perm) // per  # resident host of the row placed there
    return int(np.sum(dest != src))


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """inv such that ``x[perm][inv] == x`` (restore original row order)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def bucket_token_ratio(
    lengths: Sequence[float], num_buckets: int, perm: Optional[np.ndarray] = None
) -> float:
    """max-bucket-tokens / mean-bucket-tokens for contiguous even-row buckets
    of (optionally permuted) ``lengths`` — the straggler factor a DP sharding
    of that batch would see (1.0 = perfectly balanced)."""
    w = np.asarray(lengths, dtype=np.float64)
    if perm is not None:
        w = w[perm]
    sums = np.array([c.sum() for c in np.array_split(w, num_buckets)])
    mean = sums.mean()
    return float(sums.max() / mean) if mean > 0 else 1.0


class HeartbeatMonitor:
    """Tracks last-seen iteration per host; hosts silent for ``patience``
    iterations are declared dead (drives ``rebalance(dead=...)``).

    A host that has NEVER beaten is dead at any query — ``last_seen`` starts
    at -inf, not 0, so silence from the start is not mistaken for a beat at
    iteration 0. Beats are monotone (``beat`` keeps the max, so a delayed
    out-of-order heartbeat cannot roll a host backwards), and queries at an
    iteration older than a host's last beat never report it dead. Each beat
    may also carry a wall-clock ``now``; ``dead(..., now=, stale_s=)`` then
    ORs in wall-clock staleness, which is what lets a survivor *blocked* at
    a collective (its own iteration frozen) still detect a killed peer.
    """

    def __init__(self, num_hosts: int, patience: int = 2):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        if patience < 1:
            raise ValueError(
                f"patience must be >= 1, got {patience} (patience=0 would "
                "declare every host dead the instant it beats)")
        self.last_seen = np.full(num_hosts, -np.inf)
        self.last_wall = np.full(num_hosts, -np.inf)
        self.patience = patience

    def beat(self, host: int, iteration: int, *, now: Optional[float] = None) -> None:
        if not 0 <= host < len(self.last_seen):
            raise ValueError(f"host {host} out of range [0, {len(self.last_seen)})")
        self.last_seen[host] = max(self.last_seen[host], iteration)
        if now is not None:
            self.last_wall[host] = max(self.last_wall[host], now)

    def dead(
        self,
        iteration: int,
        *,
        now: Optional[float] = None,
        stale_s: Optional[float] = None,
    ) -> List[int]:
        out = []
        for i, seen in enumerate(self.last_seen):
            lagged = iteration - seen >= self.patience
            stale = (
                now is not None
                and stale_s is not None
                and now - self.last_wall[i] >= stale_s
            )
            if lagged or stale:
                out.append(i)
        return out
