"""Paged KV arena: a block table over fixed-size KV pages (port of
``repro.serving.paged_arena``).

KV storage is a pool of ``num_pages`` fixed-size pages (``page_size`` tokens
each); a logical sequence is a *block table*, an ordered list of page ids,
and pages go back to the free list the moment their owner releases them.
The serving engine keeps everything resident in the pool: the pages of the
requests decoding now (decode reads them through block-table rows), of
parked requests, and of the radix prefix cache's committed prompt pages. The
pool's capacity is independent of the slot count, so resident KV can
outgrow ``num_slots x max_len``.

Device layout: ``model.init_caches(num_pages + 1, page_size)``, a list with
one ``{"k", "v"}`` per layer, each (num_pages + 1, page_size, KVH, hd): each
cache row is one page. Pages ``0 .. num_pages - 1`` are handed out; the last
one, index ``num_pages``, is the **sink**: no block table ever names it, and
the paged decode step sends the K/V writes of retired lanes there
(``lm._decode_paged``). The JAX pool has no sink page and drops those
writes with an out-of-range index instead; compare ``pool[:num_pages]``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.models.api import Model


class ArenaOutOfPages(RuntimeError):
    """Raised when an allocation cannot be satisfied even after eviction."""


class PagedKVArena:
    """Fixed-size page pool + free list + per-owner block tables."""

    def __init__(self, model: Model, *, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"need num_pages >= 1 and page_size >= 1, got "
                f"{num_pages}/{page_size}")
        self.model = model
        self.num_pages = num_pages
        self.page_size = page_size
        self.pool = model.init_caches(num_pages + 1, page_size)  # + the sink page
        self._free: List[int] = list(range(num_pages))
        # owner tag -> block table (ordered page ids); owners are opaque
        # host-side keys (request ids of parked sequences)
        self.tables: Dict[object, List[int]] = {}

    @property
    def sink_page(self) -> int:
        return self.num_pages

    # ------------------------------------------------------------------ #
    # free-list accounting
    # ------------------------------------------------------------------ #
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list (raises ArenaOutOfPages)."""
        if n > len(self._free):
            raise ArenaOutOfPages(
                f"need {n} pages, {len(self._free)} free of {self.num_pages}")
        ids, self._free = self._free[:n], self._free[n:]
        return ids

    def free(self, ids: Sequence[int]) -> None:
        """Return pages to the free list: recycled immediately."""
        for i in ids:
            if not (0 <= i < self.num_pages):
                raise ValueError(f"page id {i} out of range")
        self._free.extend(ids)
        assert len(self._free) <= self.num_pages, "double free"

    # ------------------------------------------------------------------ #
    # block-table ownership (parked sequences)
    # ------------------------------------------------------------------ #
    def park(self, owner, page_ids: List[int]) -> None:
        assert owner not in self.tables, f"{owner!r} already parked"
        self.tables[owner] = list(page_ids)

    def unpark(self, owner) -> List[int]:
        return self.tables.pop(owner)

    # ------------------------------------------------------------------ #
    # device copies: cache rows <-> pool pages
    # ------------------------------------------------------------------ #
    def save_rows(self, caches, slots, page_tables, start_page: int = 0) -> None:
        """Copy pages ``[start_page, start_page + k)`` of the given cache
        rows into the pool pages of ``page_tables``. ``slots`` is one row id
        with a flat page-id list, or a sequence of rows with a (R, k) table:
        all lanes go in one indexed copy per leaf (the copy-on-admit path
        copies a whole admission group this way). ``start_page > 0`` is the
        prefix-commit path: the matched pages are the cache's and shared, so
        only the newly prefilled tail pages are copied out."""
        if np.ndim(slots) == 0:
            slots, page_tables = [slots], [page_tables]
        tables = np.asarray(page_tables, np.int64)
        if tables.size == 0:
            return
        k = tables.shape[1]
        pages = self.model.gather_cache_pages(caches, slots, num_pages=start_page + k,
                                              page_size=self.page_size)
        ids = torch.from_numpy(tables.reshape(-1)).to(self.pool[0]["k"].device)
        for pool, pg in zip(self.pool, pages):
            for name, leaf in pool.items():
                src = pg[name][:, start_page:]
                leaf[ids] = src.reshape((-1,) + tuple(src.shape[2:])).to(leaf.dtype)

    def load_rows(self, caches, slots: Sequence[int], page_tables):
        """Write pooled pages into the cache rows at ``slots``: lane ``j``
        gets ``page_tables[j]`` contiguously from position 0. All lanes
        share a block-table length (the engine groups admissions by matched
        page count). Returns the caches, updated in place."""
        tables = np.asarray(page_tables, np.int64)
        if tables.ndim != 2:
            raise ValueError("page_tables must be (R, k)")
        R, k = tables.shape
        if k == 0:
            return caches
        ids = torch.from_numpy(tables.reshape(-1)).to(self.pool[0]["k"].device)
        pages = [{name: leaf[ids].reshape((R, k) + tuple(leaf.shape[1:]))
                  for name, leaf in pool.items()} for pool in self.pool]
        return self.model.scatter_cache_pages(caches, pages, slots)
