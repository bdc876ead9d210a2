"""Paged KV bookkeeping (the bookkeeping part of
``repro.serving.kv_cache.PagedCache``).

The page payloads live in the model's cache tree (``LM.init_paged_cache``);
this object owns the refcounted free list, the per-sequence page tables,
the device ``(max_seqs, max_pages)`` int32 block table and the device
``seq_lens``, and the hashed-prefix cache.  Physical page 0 is the null
page: never allocated, permanently referenced, the target of block-table
padding and of masked writes.

The prefix keys are the same as ``repro``'s: a chain of Python ``hash``es
of integer tuples (deterministic across processes) seeded with
``prefix_hash_seed``, a sha256 of the same bytes.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

DEFAULT_CACHE_DTYPE = torch.float32
NULL_PAGE = 0
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def prefix_hash_seed(quant_tag: tuple, page_size: int) -> int:
    """Deterministic seed of the hashed-prefix chain (byte-identical to
    ``repro.serving.kv_cache.prefix_hash_seed``)."""
    blob = repr(("kv_prefix_seed_v1", page_size) + tuple(quant_tag))
    digest = hashlib.sha256(blob.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big", signed=True)


class PagedCache:
    """Block-table bookkeeping for a pool of ``num_pages`` allocatable
    pages (+ the null page)."""

    def __init__(self, num_pages: int, page_size: int, *, max_seqs: int = 0,
                 max_pages: int = 0, dtype: torch.dtype = DEFAULT_CACHE_DTYPE,
                 kv_quant=None, device=None):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_seqs = max_seqs or num_pages
        self.max_pages = max_pages or num_pages
        self.device = torch.device("cpu" if device is None else device)
        self.free_list = list(range(num_pages, 0, -1))   # pops 1, 2, 3, ...
        self.tables: dict[int, list[int]] = {}
        self.lengths: dict[int, int] = {}
        self.refcount = np.zeros(num_pages + 1, np.int32)
        self.refcount[NULL_PAGE] = np.iinfo(np.int32).max // 2   # pinned
        self.block_tables = torch.zeros((self.max_seqs, self.max_pages),
                                        dtype=torch.int32, device=self.device)
        self.seq_lens = torch.zeros((self.max_seqs,), dtype=torch.int32,
                                    device=self.device)
        self.rows: dict[int, int] = {}
        self._free_rows = list(range(self.max_seqs))[::-1]
        # the chain is seeded with the KV storage mode, so int8 pages and
        # fp pages of the same tokens never match
        quant_tag = ((kv_quant.dtype, kv_quant.granularity)
                     if kv_quant is not None and kv_quant.quantized
                     else ("fp", _DTYPE_NAMES[dtype]))
        self._hash_seed = prefix_hash_seed(quant_tag, page_size)
        self._prefix_index: dict[int, int] = {}      # hash key -> page id
        self._page_key: dict[int, int] = {}          # page id -> hash key
        self.prefix_hits: dict[int, int] = {}        # seq_id -> pages reused

    # ------------------------------------------------------------ bookkeeping
    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free_list) / self.num_pages

    def row_of(self, seq_id: int) -> int:
        return self.rows[seq_id]

    def _sync_row(self, seq_id: int):
        """Push one sequence's host table into the device block table."""
        arr = np.full((self.max_pages,), NULL_PAGE, np.int32)
        table = self.tables[seq_id]
        arr[:len(table)] = table
        self.block_tables[self.rows[seq_id]] = torch.from_numpy(arr).to(
            self.device)

    def _prefix_keys(self, tokens) -> list[int]:
        """Chain hashes of each full-page-aligned prefix of ``tokens``."""
        keys, key = [], self._hash_seed
        for i in range(len(tokens) // self.page_size):
            page = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            key = hash((key, page))
            keys.append(key)
        return keys

    def alloc_seq(self, seq_id: int, n_tokens: int,
                  share_from: int | None = None, tokens=None,
                  reserve: int = 0) -> bool:
        """Allocate pages and a block-table row for ``n_tokens`` (+
        ``reserve`` tokens of decode capacity).  Full pages are shared from
        ``share_from`` or, given ``tokens``, from the hashed-prefix cache.
        Returns False, with no state change, when pages or rows are short."""
        if seq_id in self.tables:
            raise ValueError(f"seq {seq_id} already allocated")
        pages: list[int] = []
        if share_from is not None and share_from in self.tables:
            src = self.tables[share_from]
            pages = src[:min(len(src), n_tokens // self.page_size)]
        elif tokens is not None:
            keys = self._prefix_keys(tokens)[:self._max_shared_pages(n_tokens)]
            for key in keys:
                page = self._prefix_index.get(key)
                if page is None or self.refcount[page] <= 0:
                    break
                pages.append(page)
        shared = len(pages)
        total = self.pages_needed(n_tokens + reserve)
        need = total - shared
        if (need > len(self.free_list) or not self._free_rows
                or total > self.max_pages):
            return False
        pages = list(pages)               # never alias a donor's table
        for p in pages:
            self.refcount[p] += 1
        for _ in range(need):
            p = self.free_list.pop()
            self.refcount[p] += 1
            pages.append(p)
        self.tables[seq_id] = pages
        self.lengths[seq_id] = n_tokens
        self.rows[seq_id] = self._free_rows.pop()
        if tokens is not None and share_from is None:
            self.prefix_hits[seq_id] = shared
        self._sync_row(seq_id)
        return True

    def _max_shared_pages(self, n_tokens: int) -> int:
        """Prefix hits stop short of full-prompt coverage: at least one
        suffix token remains to produce the first sampled token."""
        return (n_tokens - 1) // self.page_size

    def release_prefix(self, seq_id: int, keep: int) -> int:
        """Swap every still-shared page of ``seq_id`` past its first ``keep``
        for a fresh private page (no payload copy: the caller rewrites the
        span).  Returns the number of pages swapped."""
        table = self.tables[seq_id]
        swapped = 0
        try:
            for li in range(keep, len(table)):
                p = table[li]
                if self.refcount[p] <= 1:
                    continue
                if not self.free_list:
                    raise RuntimeError(
                        f"page pool exhausted while privatizing prefix pages "
                        f"of seq {seq_id} (backoff from page {keep})")
                q = self.free_list.pop()
                self.refcount[p] -= 1
                self.refcount[q] += 1
                table[li] = q
                swapped += 1
        finally:
            if swapped:
                self._sync_row(seq_id)
        return swapped

    def extend_seq(self, seq_id: int, n_new: int = 1) -> bool:
        """Grow a sequence by ``n_new`` tokens, allocating pages as needed.
        Returns False, with no state change, when the pool or the table is
        short.  Growing into a page that another sequence shares needs a
        copy-on-write of its payload, which lives outside this bookkeeping
        object: that raises ``RuntimeError`` before anything changes."""
        old = self.lengths[seq_id]
        length = old + n_new
        table = self.tables[seq_id]
        written = self.pages_needed(length) if n_new > 0 else 0
        for li in range(old // self.page_size, min(len(table), written)):
            if self.refcount[table[li]] > 1:
                raise RuntimeError(
                    f"seq {seq_id} would write into shared page {table[li]}; "
                    f"copy-on-write needs the page payloads, which the "
                    f"engine keeps in the model cache")
        need = self.pages_needed(length) - len(table)
        if need > 0:
            if (len(self.free_list) < need
                    or self.pages_needed(length) > self.max_pages):
                return False
            for _ in range(need):
                p = self.free_list.pop()
                self.refcount[p] += 1
                table.append(p)
            self._sync_row(seq_id)
        self.lengths[seq_id] = length
        return True

    def free_seq(self, seq_id: int):
        for p in self.tables.pop(seq_id, []):
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.free_list.append(p)
                key = self._page_key.pop(p, None)
                if key is not None and self._prefix_index.get(key) == p:
                    del self._prefix_index[key]
        self.lengths.pop(seq_id, None)
        self.prefix_hits.pop(seq_id, None)
        row = self.rows.pop(seq_id, None)
        if row is not None:
            self._free_rows.append(row)
            self.block_tables[row] = 0
            self.seq_lens[row] = 0

    # ------------------------------------------------------------ prefix cache
    def register_prefix(self, seq_id: int, tokens):
        """Publish this sequence's full, written pages to the prefix cache
        (call after the prompt KV has been written)."""
        table = self.tables[seq_id]
        for i, key in enumerate(self._prefix_keys(tokens)):
            page = table[i]
            if key not in self._prefix_index and page not in self._page_key:
                self._prefix_index[key] = page
                self._page_key[page] = key
