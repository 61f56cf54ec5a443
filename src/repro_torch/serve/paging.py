"""Host-side paged-KV bookkeeping: page allocator + radix prefix cache.

The paged serve path replaces per-slot contiguous caches (B, max_len, ...)
with one physical page pool (P, page_size, ...) per cache leaf.  Every
leaf shares a single page-id space: page ``p`` of a request is the same
index into every layer's pool arrays, so ONE host-side allocator and ONE
per-request page table row (logical block -> physical page) cover the
whole model.  Nothing here touches device memory — these classes hand
out integer page ids; the device-side indirection lives in the paged
kernels (``kernels/*/ops.py``), which read each row's page table on the
card and turn a logical position into a physical page row.

A copy of the JAX package's ``serve/paging.py`` (pure Python), kept here
so that the port imports nothing of that package.

``PagePool``    free-list allocator with per-page refcounts.  Page 0 is
                reserved scratch: it is never allocated, every masked /
                padded kernel write is routed there, and no page table
                may map real content to it.
``RadixPrefixCache``
                page-stride radix tree over token ids: each edge spans
                exactly one page (``page_size`` tokens), so a node *is*
                a cached physical page and a tree walk is a longest
                cached-prefix match at page granularity.  Matching maps
                the cached pages copy-free into a new request's page
                table (taking pool refs); inserting at retire adopts the
                request's full pages; eviction releases LRU leaves back
                toward the free list.  A page referenced by both the
                tree and live requests survives eviction until the last
                request retires — the pool refcount is the single
                source of truth for page lifetime.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

SCRATCH_PAGE = 0


class PagePool:
    """Free-list page allocator with refcounts over ``num_pages`` pages.

    Page ``SCRATCH_PAGE`` (0) is reserved and never handed out; usable
    capacity is ``num_pages - 1``.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is scratch)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently-freed pages are re-used first.
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: List[int] = [0] * num_pages
        self._refs[SCRATCH_PAGE] = 1        # pinned forever

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def total_pages(self) -> int:
        """Usable (non-scratch) capacity."""
        return self.num_pages - 1

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages at refcount 1, or None if short (all or
        nothing — a partial grab would deadlock concurrent admissions)."""
        if n < 0:
            raise ValueError("alloc of negative page count")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def ref(self, pages: Sequence[int]) -> None:
        """Add one reference to each page (copy-free sharing)."""
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"ref of free page {p}")
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; pages hitting zero return to the
        free list.  Returns how many pages were actually freed."""
        freed = 0
        for p in pages:
            if p == SCRATCH_PAGE or self._refs[p] <= 0:
                raise ValueError(f"release of page {p} (refs "
                                 f"{self._refs[p]})")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed


class _Node:
    __slots__ = ("children", "parent", "key", "page", "last_used")

    def __init__(self, parent=None, key=None, page=None):
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.key = key
        self.page = page
        self.last_used = 0


class RadixPrefixCache:
    """Page-stride radix tree mapping token prefixes to cached pages.

    Every edge is exactly ``pool.page_size`` token ids; the child node
    owns one pool reference on its physical page.  ``match`` walks the
    tree and refs the matched pages for the caller (the new request);
    ``insert`` adopts a retired request's full pages; ``evict_lru``
    drops leaf nodes in least-recently-used order, releasing the tree's
    reference (the page returns to the free list only once no live
    request still holds it).
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.root = _Node()
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.evictions = 0
        self.node_count = 0
        # Min-heap of (last_used, seq, node) candidate entries, pushed on
        # every touch and validated lazily at pop time (stale timestamps,
        # evicted nodes, and interior nodes are discarded).  Keeps
        # ``evict_lru`` amortised O(log n) instead of a full-tree scan
        # per evicted page — preemption pressure runs eviction in a loop.
        self._heap: List[Tuple[int, int, _Node]] = []
        self._heap_seq = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _touch(self, node: _Node, now: int) -> None:
        node.last_used = now
        self._heap_seq += 1
        heapq.heappush(self._heap, (now, self._heap_seq, node))
        # Lazy invalidation leaves stale entries behind; rebuild once the
        # heap is badly bloated relative to the live tree.
        if len(self._heap) > 64 and len(self._heap) > 8 * self.node_count:
            self._compact_heap()

    def _compact_heap(self) -> None:
        entries: List[Tuple[int, int, _Node]] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            self._heap_seq += 1
            entries.append((n.last_used, self._heap_seq, n))
            stack.extend(n.children.values())
        heapq.heapify(entries)
        self._heap = entries

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix of ``tokens``.

        Returns ``(matched_tokens, pages)``; the caller receives one
        pool reference per matched page and owns releasing them.
        """
        ps = self.pool.page_size
        now = self._tick()
        self.lookups += 1
        node, pages = self.root, []
        for i in range(0, len(tokens) - ps + 1, ps):
            child = node.children.get(tuple(tokens[i:i + ps]))
            if child is None:
                break
            self._touch(child, now)
            pages.append(child.page)
            node = child
        if pages:
            self.hits += 1
            self.pool.ref(pages)
        return len(pages) * ps, pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Adopt the full-page prefix of a retired request.

        ``pages[i]`` backs ``tokens[i*ps:(i+1)*ps]``.  Pages whose
        prefix is already cached are skipped (the existing page wins —
        same token content); new nodes take a pool reference.  Returns
        the number of pages adopted.
        """
        ps = self.pool.page_size
        now = self._tick()
        node, adopted = self.root, 0
        n = min(len(tokens) // ps, len(pages))
        for i in range(n):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(parent=node, key=key, page=pages[i])
                node.children[key] = child
                self.pool.ref([pages[i]])
                self.node_count += 1
                adopted += 1
            self._touch(child, now)
            node = child
        return adopted

    def _leaves(self) -> List[_Node]:
        """Reference full-tree leaf scan (tests gate the heap-ordered
        eviction against ``min(_leaves(), key=last_used)``)."""
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _pop_lru_leaf(self) -> Optional[_Node]:
        """Pop the least-recently-used *current* leaf off the candidate
        heap, discarding stale entries (superseded timestamps, evicted
        nodes, interior nodes).  Interior-node entries are safe to drop:
        children only ever disappear through eviction, which re-pushes
        the parent the moment it becomes a leaf."""
        while self._heap:
            ts, _, node = heapq.heappop(self._heap)
            if (ts == node.last_used and not node.children
                    and node.parent is not None
                    and node.parent.children.get(node.key) is node):
                return node
        return None

    def evict_lru(self, count: int = 1) -> int:
        """Evict up to ``count`` least-recently-used leaf nodes,
        releasing the tree's page references.  Returns nodes evicted."""
        done = 0
        while done < count:
            victim = self._pop_lru_leaf()
            if victim is None:
                break
            parent = victim.parent
            del parent.children[victim.key]
            victim.parent = None
            self.pool.release([victim.page])
            self.node_count -= 1
            self.evictions += 1
            done += 1
            if parent is not self.root and not parent.children:
                # Newly leafed: its live-timestamp entry may already have
                # been popped and discarded as interior — requeue it.
                self._heap_seq += 1
                heapq.heappush(
                    self._heap,
                    (parent.last_used, self._heap_seq, parent))
        return done

    def evict_for(self, pages_needed: int) -> int:
        """Evict LRU leaves until the pool could satisfy an allocation
        of ``pages_needed`` pages (or the tree is empty).  Returns nodes
        evicted.  Evicting a leaf whose page is still shared with a
        live request releases only the tree's ref, so the loop keeps
        going until the free list itself is long enough."""
        done = 0
        while self.pool.free_pages < pages_needed:
            if not self.evict_lru(1):
                break
            done += 1
        return done

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0
