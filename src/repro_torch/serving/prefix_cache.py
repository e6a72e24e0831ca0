"""Shared-prefix radix cache: a token trie over committed KV pages (a copy of
``repro.serving.prefix_cache``; pure Python).

A production serve fleet sees millions of requests that open with the same
system prompt; prefilling that prefix once per *request* is pure waste. This
cache generalizes PR 5's KV-reuse primitive — "resume from your own
episode's saved cache rows" — to "resume from ANY request's matching
prefix": after a request's prompt is prefilled, its full KV pages are
committed into a radix tree keyed by the page's token span; a later request
walks the tree with its own prompt and reuses every matching page instead of
recomputing it.

Structure: one node per committed page. A node's edge label is the exact
``page_size``-token tuple the page covers, so a root-to-node path spells a
page-aligned token prefix and holds the page ids of its KV. Page alignment
is what keeps a hit bitwise-identical to a cold prefill: the serving engine
prefills in ``page_size`` chunks through the same compiled per-chunk
executable whether or not pages were matched, so a hit only ever *skips*
leading chunks whose cached output bytes are scattered in verbatim — the
remaining chunks see bit-identical inputs and produce bit-identical logits.

Lifetime: nodes are refcounted (``acquire`` pins a matched path for the
duration of the slot load; the tree itself holds no refcount) and evicted
LRU from the leaves — an interior node is never evicted before its
descendants, and a pinned node is never evicted at all. ``match`` never
returns the *whole* prompt even on a full match: the last token is always
left to compute so the engine has fresh last-position logits to sample the
first response token from (the same contract as a cold prefill).

The cache owns its pages' ids but not their storage — the
:class:`repro_torch.serving.paged_arena.PagedKVArena` pool holds the bytes, and
eviction hands the freed ids back to the caller to return to the arena's
free list.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("key", "page_id", "parent", "children", "refcount",
                 "last_use")

    def __init__(self, key: Optional[Tuple[int, ...]], page_id: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key  # page_size-token tuple (None at the root)
        self.page_id = page_id  # pool page id (None at the root)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.refcount = 0  # active pins (requests mid-load)
        self.last_use = 0  # LRU clock tick of the last match/insert touch


class RadixPrefixCache:
    """Token-trie over committed KV pages with refcounts + LRU eviction."""

    def __init__(self, *, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.root = _Node(None, None, None)
        self._clock = 0
        self.num_pages = 0  # committed pages currently held
        # counters surfaced in engine stats
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------------ #
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk(self, tokens: Sequence[int], limit_pages: int) -> List[_Node]:
        """Longest stored page-aligned path matching ``tokens`` (<= limit)."""
        ps = self.page_size
        path: List[_Node] = []
        node = self.root
        for p in range(min(len(tokens) // ps, limit_pages)):
            key = tuple(int(t) for t in tokens[p * ps:(p + 1) * ps])
            nxt = node.children.get(key)
            if nxt is None:
                break
            path.append(nxt)
            node = nxt
        return path

    # ------------------------------------------------------------------ #
    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest stored page-aligned strict prefix of ``tokens``.

        Returns ``(matched_tokens, page_ids)``. The match is capped at
        ``(len(tokens) - 1) // page_size`` pages so at least one prompt
        token is always left to prefill (fresh last-position logits).
        Touches the matched path's LRU clocks; does NOT pin.
        """
        limit = max(0, (len(tokens) - 1)) // self.page_size
        path = self._walk(tokens, limit)
        t = self._tick()
        for n in path:
            n.last_use = t
        if path:
            self.hits += 1
            self.hit_tokens += len(path) * self.page_size
        else:
            self.misses += 1
        return len(path) * self.page_size, [n.page_id for n in path]

    def acquire(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """:meth:`match` + pin the matched path (refcount += 1 per node).
        Callers must :meth:`release` with the same tokens/length once the
        pages have been staged into slot rows."""
        m, ids = self.match(tokens)
        for n in self._walk(tokens, m // self.page_size):
            n.refcount += 1
        return m, ids

    def release(self, tokens: Sequence[int], matched_tokens: int) -> None:
        """Unpin a previously acquired path (refcounts stay >= 0)."""
        for n in self._walk(tokens, matched_tokens // self.page_size):
            assert n.refcount > 0, "release without acquire"
            n.refcount -= 1

    # ------------------------------------------------------------------ #
    def insert(self, tokens: Sequence[int], make_page) -> int:
        """Commit every full page of ``tokens`` not already stored.

        ``make_page(page_index)`` is called for each missing page (in
        order) and must return the pool page id now holding that span's KV
        — the engine allocates from the arena and copies from the slot rows
        there. May raise (e.g. pool exhausted); already-attached nodes stay
        valid. Returns the number of newly committed pages.
        """
        ps = self.page_size
        t = self._tick()
        node = self.root
        added = 0
        for p in range(len(tokens) // ps):
            key = tuple(int(x) for x in tokens[p * ps:(p + 1) * ps])
            nxt = node.children.get(key)
            if nxt is None:
                nxt = _Node(key, make_page(p), node)
                node.children[key] = nxt
                self.num_pages += 1
                added += 1
            nxt.last_use = t
            node = nxt
        return added

    # ------------------------------------------------------------------ #
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.children:
                out.append(n)
        return out

    def evict(self, n_pages: int) -> List[int]:
        """Evict up to ``n_pages`` unpinned pages, LRU leaves first, and
        return their page ids for the caller to free. Evicting a leaf may
        expose its parent as the next-oldest leaf — the sweep repeats until
        satisfied or nothing evictable remains."""
        freed: List[int] = []
        while len(freed) < n_pages:
            candidates = [l for l in self._leaves() if l.refcount == 0]
            if not candidates:
                break
            victim = min(candidates, key=lambda l: l.last_use)
            del victim.parent.children[victim.key]
            freed.append(victim.page_id)
            self.num_pages -= 1
        self.evicted_pages += len(freed)
        return freed

    def clear(self) -> List[int]:
        """Drop every unpinned page (weight hot-swap invalidation: cached
        KV is weight-version-scoped — pages prefilled under version v must
        not seed a request decoded under v+1). Returns the freed ids."""
        return self.evict(self.num_pages)

    # introspection (tests / hypothesis properties) --------------------- #
    def _all_nodes(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root:
                out.append(n)
        return out

    def check_invariants(self) -> None:
        nodes = self._all_nodes()
        assert len(nodes) == self.num_pages, "page count drifted"
        ids = [n.page_id for n in nodes]
        assert len(ids) == len(set(ids)), "duplicate page id in trie"
        for n in nodes:
            assert n.refcount >= 0, "negative refcount"
            assert n.key is not None and len(n.key) == self.page_size
