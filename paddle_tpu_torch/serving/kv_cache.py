"""Block-paged KV cache with refcounted pages and a radix prefix cache —
the port of ``paddle_tpu/serving/kv_cache.py``.

K/V live in fixed-size pages drawn from one shared pool, a per-sequence
page table maps logical token positions to physical pages, and
sequences of very different lengths share the pool with at most
page_size-1 slots of waste each.  The pool is one stacked tensor
``[L, P + 1, page_size, H, hd]`` per K and V on the engine's device
(bf16 by default); the model step writes it in place.  Page ``P`` is a
scratch page the allocator never hands out: the step writes its padding
tokens there (``gpt_ragged_step``), so the JAX pool's ``[L, P, ...]`` is
``k_pages[:, :P]``.  The two tensors never move: every method that
changes them writes in place, so a CUDA graph that captured their
addresses stays valid.

Allocation is chunk-granular: the chunked-prefill scheduler
``allocate``s a prompt's first chunk at admission and ``extend``s the
table as later chunks and decode tokens land.

Prefix reuse: every page carries a **refcount**, and a **radix tree
keyed on page-aligned token-ID prefixes** (one edge = one FULL page of
prompt tokens) indexes pages whose contents are a pure function of their
token prefix.  ``allocate_prefixed`` walks the tree for the longest
cached prefix of a new prompt, maps those pages in read-only (a
refcount bump instead of prefill FLOPs) and allocates fresh pages only
from the first uncached token.  When the whole prompt is cached the
final page is **copied on write** (an in-place page copy on the device)
so shared pages are never written.  Cached pages nobody references are
*evictable*: they count as free and are LRU-evicted on demand.

The bookkeeping (free list, tables, refcounts, radix tree, LRU heap) is
plain Python carried over unchanged; it is lock-guarded because
telemetry threads read it while the scheduler mutates it.
"""
from __future__ import annotations

import hashlib
import heapq
import math
import threading

import torch

from .._device import resolve_device

__all__ = ["PagedKVCache", "prefix_hashes"]

#: chain hash of the empty prefix (the radix root)
_ROOT_HASH = "radix-root"


def _chunk_hash(parent_hash, key):
    """Chain hash of one page-aligned token chunk appended to a prefix —
    stable across processes (hashlib), the wire identity of a cached
    prefix."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_hash.encode("ascii"))
    h.update(",".join(str(int(t)) for t in key).encode("ascii"))
    return h.hexdigest()


def prefix_hashes(token_ids, page_size, max_pages=64):
    """Chain hashes of the page-aligned prefixes of ``token_ids``:
    ``prefix_hashes(t, ps)[i]`` identifies ``t[:(i+1)*ps]``."""
    out, h = [], _ROOT_HASH
    for i in range(min(len(token_ids) // page_size, max_pages)):
        key = token_ids[i * page_size:(i + 1) * page_size]
        h = _chunk_hash(h, key)
        out.append(h)
    return out


class _PrefixNode:
    """One radix-tree edge: one FULL page of prompt tokens."""

    __slots__ = ("key", "page", "parent", "children", "chain_hash",
                 "last_used")

    def __init__(self, key, page, parent, chain_hash, last_used):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.chain_hash = chain_hash
        self.last_used = last_used


class PagedKVCache:
    """Page pool + per-sequence page tables with alloc/free/defrag,
    per-page refcounts and a radix prefix cache.

    ``k_pages``/``v_pages`` are tensors on ``device`` (default CUDA) of
    ``num_pages + 1`` pages, the last one scratch, that the model step
    updates in place.  Bookkeeping methods touch them only in ``defrag``
    (a page permutation written back in place, one layer at a time), the
    copy-on-write path of ``allocate_prefixed`` (one page copy) and
    ``reset`` (``zero_``); none of them reassigns the tensors."""

    def __init__(self, *, num_layers, num_heads, head_dim, num_pages,
                 page_size, max_seq_len, dtype=torch.bfloat16, device=None):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.device = resolve_device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_seq = math.ceil(max_seq_len / page_size)
        # one page past the pool: the step's scratch page
        shape = (num_layers, num_pages + 1, page_size, num_heads,
                 head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        # LIFO free list: recently-freed (still-warm) pages are reused first
        self._free = list(range(num_pages - 1, -1, -1))
        self._tables = {}          # seq_id -> [physical page ids]
        self._lock = threading.RLock()
        self._ref = {}             # page -> refcount  # guarded-by: self._lock
        self._radix = _PrefixNode((), None, None, _ROOT_HASH, 0)  # guarded-by: self._lock
        self._tree_pages = {}      # page -> its radix node  # guarded-by: self._lock
        # evictable pages (tree-held, refcount 1), counted incrementally
        self._evictable = 0        # guarded-by: self._lock
        # lazy min-heap of (last_used, seq, node) eviction candidates
        self._evict_heap = []      # guarded-by: self._lock
        self._heap_seq = 0         # guarded-by: self._lock
        self._prefix_stats = {"hits": 0, "hit_tokens": 0,
                              "evictions": 0,
                              "inserted_pages": 0}  # guarded-by: self._lock
        self._tick = 0             # logical LRU clock

    # ------------------------------------------------------------ queries
    @property
    def num_free_pages(self):
        """Allocatable pages: the free list PLUS zero-ref cached prefix
        pages (evicted on demand)."""
        with self._lock:
            return len(self._free) + self._evictable

    @property
    def num_used_pages(self):
        return self.num_pages - self.num_free_pages

    def occupancy(self):
        """Fraction of the pool in *hard* use, 0..1."""
        return self.num_used_pages / self.num_pages

    def pages_for(self, num_tokens):
        return math.ceil(num_tokens / self.page_size)

    def seq_ids(self):
        return list(self._tables)

    # ------------------------------------------------------- alloc / free
    def allocate(self, seq_id, num_tokens):
        """Reserve pages for a new sequence of num_tokens; False
        (allocating nothing) when the pool can't cover it."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id!r} already allocated")
        need = self.pages_for(num_tokens)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"seq {seq_id!r}: {num_tokens} tokens need {need} pages > "
                f"max_pages_per_seq {self.max_pages_per_seq}")
        with self._lock:
            pages = self._take_pages_locked(need)
            if pages is None:
                return False
            self._tables[seq_id] = pages
        return True

    def extend(self, seq_id, num_tokens):
        """Grow seq_id's table to cover num_tokens total; False (table
        unchanged) when the pool is exhausted."""
        table = self._tables[seq_id]
        need = self.pages_for(num_tokens) - len(table)
        if need <= 0:
            return True
        if len(table) + need > self.max_pages_per_seq:
            raise ValueError(
                f"seq {seq_id!r}: extend to {num_tokens} tokens exceeds "
                f"max_pages_per_seq {self.max_pages_per_seq}")
        with self._lock:
            pages = self._take_pages_locked(need)
            if pages is None:
                return False
            table.extend(pages)
        return True

    def free(self, seq_id):
        """Drop seq_id's references; a page returns to the pool only at
        refcount zero."""
        with self._lock:
            for p in self._tables.pop(seq_id):
                self._release_page_locked(p)

    def reset(self):
        """Free everything and zero the pool (prefix counters stay
        monotonic)."""
        with self._lock:
            self._tables.clear()
            self._free = list(range(self.num_pages - 1, -1, -1))
            self._ref = {}
            self._radix = _PrefixNode((), None, None, _ROOT_HASH, 0)
            self._tree_pages = {}
            self._evictable = 0
            self._evict_heap = []
            self.k_pages.zero_()
            self.v_pages.zero_()

    # --------------------------------------------------- locked internals
    def _release_page_locked(self, page):
        self._ref[page] -= 1
        count = self._ref[page]
        if count == 0:
            del self._ref[page]
            self._free.append(page)
        elif count == 1:
            node = self._tree_pages.get(page)
            if node is not None:      # tree-only now: became evictable
                self._evictable += 1
                if not node.children:
                    self._note_evictable_locked(node)

    def _bump_ref_locked(self, page):
        count = self._ref.get(page, 0)
        self._ref[page] = count + 1
        if count == 1 and page in self._tree_pages:
            self._evictable -= 1      # referenced again: no longer evictable

    def _note_evictable_locked(self, node):
        """Push ``node`` as an eviction candidate (lazy: stale entries are
        skipped at pop time; compacted when they dominate)."""
        self._heap_seq += 1
        heapq.heappush(self._evict_heap,
                       (node.last_used, self._heap_seq, node))
        if len(self._evict_heap) > 4 * (len(self._tree_pages) + 16):
            live = {}
            for entry in self._evict_heap:
                last_used, _, cand = entry
                if (cand.last_used == last_used and not cand.children
                        and self._tree_pages.get(cand.page) is cand
                        and self._ref.get(cand.page) == 1):
                    live[id(cand)] = entry
            self._evict_heap = sorted(live.values())

    def _take_pages_locked(self, need):
        """Pop ``need`` pages (refcount 1 each), LRU-evicting zero-ref
        cached prefixes as required; None when impossible."""
        while len(self._free) < need:
            if not self._evict_one_locked():
                return None
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def _iter_nodes_locked(self):
        stack = list(self._radix.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def _evict_one_locked(self):
        """Evict the least-recently-used zero-ref LEAF node; True when a
        page was reclaimed."""
        while self._evict_heap:
            last_used, _, victim = heapq.heappop(self._evict_heap)
            if (victim.last_used != last_used or victim.children
                    or self._tree_pages.get(victim.page) is not victim
                    or self._ref.get(victim.page) != 1):
                continue              # stale entry
            parent = victim.parent
            parent.children.pop(victim.key)
            del self._tree_pages[victim.page]
            self._evictable -= 1
            self._release_page_locked(victim.page)
            self._prefix_stats["evictions"] += 1
            if (parent is not self._radix and not parent.children
                    and self._ref.get(parent.page) == 1):
                self._note_evictable_locked(parent)
            return True
        return False

    def _match_locked(self, token_ids):
        """Longest cached page-aligned prefix of token_ids (LRU-touched
        node-chain pages)."""
        self._tick += 1
        node, pages = self._radix, []
        for i in range(len(token_ids) // self.page_size):
            key = tuple(int(t) for t in
                        token_ids[i * self.page_size:
                                  (i + 1) * self.page_size])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick
            if not child.children and self._ref.get(child.page) == 1:
                self._note_evictable_locked(child)
            pages.append(child.page)
            node = child
        return pages

    # ------------------------------------------------------- prefix reuse
    def allocate_prefixed(self, seq_id, token_ids, chunk_tokens):
        """Admission with prefix reuse: map the longest cached prefix in
        read-only and allocate fresh pages for the first ``chunk_tokens``
        uncached tokens.  A fully cached prompt is capped at
        ``len - 1`` matched tokens and its final page copied on write.
        The matched chain is pinned before fresh pages are taken; a match
        that starves its own admission is shrunk a page at a time.

        Returns the number of prompt tokens served from cache, or None
        (nothing allocated, no refcount moved)."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id!r} already allocated")
        n = len(token_ids)
        with self._lock:
            full_match = self._match_locked(token_ids)
            keep = len(full_match)
            while True:
                shared = full_match[:keep]
                cow_src = None
                if shared and len(shared) * self.page_size >= n:
                    cow_src = shared[-1]
                    shared = shared[:-1]
                    matched = n - 1
                else:
                    matched = len(shared) * self.page_size
                cover = min(matched + max(1, int(chunk_tokens)), n)
                need = self.pages_for(cover)
                if need > self.max_pages_per_seq:
                    raise ValueError(
                        f"seq {seq_id!r}: {cover} tokens need {need} "
                        f"pages > max_pages_per_seq "
                        f"{self.max_pages_per_seq}")
                # PIN the matched chain (and the COW source) BEFORE
                # taking fresh pages, so eviction cannot hand a matched
                # page back as "fresh" for this same sequence
                pinned = list(shared)
                if cow_src is not None:
                    pinned.append(cow_src)
                for p in pinned:
                    self._bump_ref_locked(p)
                fresh = self._take_pages_locked(need - len(shared))
                if fresh is not None:
                    break
                for p in pinned:
                    self._release_page_locked(p)
                if keep == 0:
                    return None
                keep -= 1
            if cow_src is not None:
                # one-page copy-on-write into fresh[0], in place on the
                # device
                dst = fresh[0]
                self.k_pages[:, dst].copy_(self.k_pages[:, cow_src])
                self.v_pages[:, dst].copy_(self.v_pages[:, cow_src])
                self._release_page_locked(cow_src)
            self._tables[seq_id] = shared + fresh
            if matched:
                self._prefix_stats["hits"] += 1
                self._prefix_stats["hit_tokens"] += matched
            return matched

    def insert_prefix(self, seq_id, token_ids):
        """Register ``seq_id``'s FULL prompt pages in the radix tree;
        returns the number of pages newly inserted."""
        table = self._tables.get(seq_id)
        if table is None:
            return 0
        added = 0
        with self._lock:
            self._tick += 1
            node = self._radix
            for i in range(len(token_ids) // self.page_size):
                key = tuple(int(t) for t in
                            token_ids[i * self.page_size:
                                      (i + 1) * self.page_size])
                child = node.children.get(key)
                if child is None:
                    page = table[i]
                    child = _PrefixNode(
                        key, page, node,
                        _chunk_hash(node.chain_hash, key), self._tick)
                    node.children[key] = child
                    self._ref[page] = self._ref.get(page, 0) + 1
                    self._tree_pages[page] = child
                    self._prefix_stats["inserted_pages"] += 1
                    added += 1
                else:
                    child.last_used = self._tick
                    if (not child.children
                            and self._ref.get(child.page) == 1):
                        self._note_evictable_locked(child)
                node = child
        return added

    def prefix_stats(self):
        """Monotonic prefix-cache counters plus the cached-page gauge."""
        with self._lock:
            out = dict(self._prefix_stats)
            out["cached_pages"] = len(self._tree_pages)
        return out

    def prefix_summary(self, max_entries=32):
        """Bounded radix summary: ``chain_hash`` → cached-prefix depth in
        tokens for the ``max_entries`` most recently used nodes."""
        with self._lock:
            nodes = []
            stack = [(self._radix, 0)]
            while stack:
                node, depth = stack.pop()
                for child in node.children.values():
                    nodes.append((child, depth + 1))
                    stack.append((child, depth + 1))
            nodes.sort(key=lambda t: t[0].last_used, reverse=True)
            entries = {child.chain_hash: depth * self.page_size
                       for child, depth in nodes[:int(max_entries)]}
            stats = dict(self._prefix_stats)
            stats["cached_pages"] = len(self._tree_pages)
            stats["nodes"] = len(nodes)
        return {"page_size": self.page_size, "entries": entries,
                "stats": stats}

    def check_integrity(self):
        """Debug invariant sweep (tests); raises AssertionError."""
        with self._lock:
            counts = {}
            for table in self._tables.values():
                for p in table:
                    counts[p] = counts.get(p, 0) + 1
            for node in self._iter_nodes_locked():
                counts[node.page] = counts.get(node.page, 0) + 1
            assert counts == self._ref, \
                f"refcount drift: counted {counts} vs {self._ref}"
            assert len(self._free) == len(set(self._free)), \
                "free list holds duplicates (double free)"
            assert not (set(self._free) & set(counts)), \
                "page both free and referenced"
            assert len(self._free) + len(counts) == self.num_pages, \
                "pages leaked: free + referenced != pool"
            for page, node in self._tree_pages.items():
                assert node.page == page, \
                    f"tree-page map drift: {page} -> node.page {node.page}"
            evictable = sum(1 for p in self._tree_pages
                            if self._ref.get(p) == 1)
            assert evictable == self._evictable, \
                (f"evictable counter drift: counted {evictable} vs "
                 f"{self._evictable}")
            for node in self._iter_nodes_locked():
                if node.children or self._ref.get(node.page) != 1:
                    continue
                assert any(nd is node and lu == node.last_used
                           for lu, _, nd in self._evict_heap), \
                    f"evictable leaf (page {node.page}) missing from heap"

    # ---------------------------------------------------------- page table
    def page_table(self, seq_id, width=None):
        """seq_id's table padded with 0 to ``width`` (default
        max_pages_per_seq).  Pad entries are never read."""
        width = width or self.max_pages_per_seq
        table = self._tables[seq_id]
        return table + [0] * (width - len(table))

    # -------------------------------------------------------------- defrag
    def defrag(self):
        """Compact live pages into the low-index prefix of the pool: one
        ``index_select`` a layer of each pool tensor, copied back in place
        (the tensors keep their storage, and the temporary is one layer's
        pages, not the pool's).  Refcount-aware: a shared page relocates
        once and every table and tree node referencing it is remapped.
        Returns pages moved."""
        with self._lock:
            order = []               # new physical slot -> old page id
            remap = {}               # old page id -> new page id
            for seq_id in self._tables:
                for old in self._tables[seq_id]:
                    if old not in remap:
                        remap[old] = len(order)
                        order.append(old)
            for node in self._iter_nodes_locked():
                if node.page not in remap:
                    remap[node.page] = len(order)
                    order.append(node.page)
            n_used = len(order)
            moved = sum(1 for old, new in remap.items() if old != new)
            if moved == 0:
                return 0
            order += [p for p in range(self.num_pages) if p not in remap]
            idx = torch.as_tensor(order, dtype=torch.long,
                                  device=self.device)
            P = self.num_pages
            for pool in (self.k_pages, self.v_pages):
                for layer in pool:
                    layer[:P] = layer[:P].index_select(0, idx)
            self._tables = {sid: [remap[p] for p in t]
                            for sid, t in self._tables.items()}
            for node in self._iter_nodes_locked():
                node.page = remap[node.page]
            self._ref = {remap[p]: c for p, c in self._ref.items()}
            self._tree_pages = {remap[p]: nd
                                for p, nd in self._tree_pages.items()}
            self._free = list(range(self.num_pages - 1, n_used - 1, -1))
            return moved
