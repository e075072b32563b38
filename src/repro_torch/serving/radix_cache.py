"""Radix-tree prefix cache over the paged KV pool (SGLang-style).

The paper's core complaint is that "redundant data aggravates the system
workload"; in serving, that redundancy is identical prompt prefixes being
prefilled from scratch for every request.  This module shares the KV pages of
common prefixes instead: a token-keyed radix tree whose nodes map prompt
prefix spans to physical pages of the ``PagedKVPool``.

Page-quantized edges
    Sharing granularity is a KV *page*, so every tree node covers exactly one
    full page (``page_size`` tokens) and is keyed by that page's token tuple.
    A prompt's cacheable prefix is its full prompt pages —
    ``len(prompt) // page_size`` of them; the partially-filled last page is
    never shared (decode keeps writing into it).  This quantization removes
    the edge-splitting bookkeeping of a classic radix tree: a "match" is a
    walk of exact page-key lookups, and sub-page divergence simply duplicates
    at most one page of KV per branch.

Matching and copy-on-write
    ``match`` walks full-page hits, then scans the children of the last
    matched node for the longest *partial* page match.  A partial match can
    never be shared — the new request must write its own tokens into the rest
    of that page — so the scheduler forks it: a fresh exclusively-owned page
    is allocated and the matched slots are device-copied into it (COW),
    after which the tail prefill fills the remainder.

Ownership
    The tree holds one pool reference per cached page (taken at ``insert``,
    dropped at eviction/``reset``); every matched request additionally
    ``share``s the pages it reuses, so eviction can never free a page a live
    slot still reads — the pool only frees at refcount zero.  Node ``lock``
    counts pin the matched path while its requests are live, keeping the LRU
    evictor away from pages it would immediately be asked for again.

Eviction
    When the free list runs dry the scheduler calls ``evict(n)``: leaf nodes
    with ``lock == 0`` are detached in least-recently-used order and the
    tree's page references dropped, until ``n`` tree references have been
    released or nothing evictable remains.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .kv_pool import PagedKVPool
from .telemetry import MetricsRegistry


class RadixNode:
    """One full KV page of a cached prompt prefix."""
    __slots__ = ("key", "page", "parent", "children", "lock", "last_access")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["RadixNode"]):
        self.key = key                     # this page's page_size tokens
        self.page = page                   # physical page in the pool
        self.parent = parent
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.lock = 0                      # live requests pinned to this node
        self.last_access = 0


@dataclasses.dataclass
class MatchResult:
    """Outcome of matching a prompt against the tree (no state mutated).

    ``pages`` are the full-page hits, shareable as-is.  ``cow_len > 0`` means
    the first ``cow_len`` token slots of page ``cow_src`` extend the match but
    live in a partially-matched page: fork (copy) before use, never share.
    ``nodes`` is the matched path incl. the COW source — lock it while the
    admitted request is alive.  ``n_matched`` counts reused prompt tokens:
    ``len(pages) * page_size + cow_len``."""
    nodes: List[RadixNode]
    pages: List[int]
    cow_src: Optional[int]
    cow_len: int
    n_matched: int


class RadixCache:
    def __init__(self, pool: PagedKVPool, page_size: int,
                 eviction: str = "lru",
                 metrics: Optional[MetricsRegistry] = None):
        assert eviction in ("lru", "none"), eviction
        self.pool = pool
        self.ps = page_size
        self.eviction = eviction
        self.root = RadixNode((), -1, None)
        self._clock = itertools.count(1)
        self.evictions = 0      # lifetime count, surfaced as cache_evictions
        # telemetry: token-level hit accounting upholds the invariant
        # hit_tokens + miss_tokens == lookup_tokens for every match() call
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_lookups = self.metrics.counter(
            "radix.lookups", "match() calls (one per admission attempt)")
        self._m_lookup_tok = self.metrics.counter(
            "radix.lookup_tokens", "matchable prompt tokens offered")
        self._m_hit_tok = self.metrics.counter(
            "radix.hit_tokens", "prompt tokens served from the tree "
            "(full pages + COW partial)")
        self._m_partial_tok = self.metrics.counter(
            "radix.partial_hit_tokens", "hit tokens needing a COW fork")
        self._m_miss_tok = self.metrics.counter(
            "radix.miss_tokens", "prompt tokens the tree could not serve")
        self._m_inserted = self.metrics.counter(
            "radix.inserted_pages", "pages newly published to the tree")
        self._m_evictions = self.metrics.counter(
            "radix.evictions", "tree references dropped under pressure")
        self._m_nodes = self.metrics.gauge(
            "radix.cached_pages", "pages currently cached (tree nodes)")
        self._m_locked = self.metrics.gauge(
            "radix.locked_nodes", "nodes pinned by live requests")
        self._n_nodes = 0
        self._n_locked = 0

    # -------------------------------------------------------------- querying

    def match(self, tokens: Sequence[int], max_match: int) -> MatchResult:
        """Longest cached prefix of ``tokens``, capped at ``max_match`` tokens
        (callers pass ``len(prompt) - 1`` so at least one tail token is left
        to prefill for first-token logits).  Touches LRU clocks only."""
        ps = self.ps
        tokens = list(tokens)
        node, n, nodes, pages = self.root, 0, [], []
        tick = next(self._clock)
        while n + ps <= max_match:
            child = node.children.get(tuple(tokens[n:n + ps]))
            if child is None:
                break
            child.last_access = tick
            nodes.append(child)
            pages.append(child.page)
            node, n = child, n + ps
        # partial page: best common prefix among this node's children
        cow_src, cow_len = None, 0
        rest = tokens[n:max_match]
        for key, child in node.children.items():
            c = 0
            for a, b in zip(key, rest):
                if a != b:
                    break
                c += 1
            if c > cow_len:
                cow_src, cow_len = child.page, c
                best = child
        if cow_len:
            best.last_access = tick
            nodes.append(best)
        n_matched = n + cow_len
        matchable = min(len(tokens), max_match)
        self._m_lookups.inc()
        self._m_lookup_tok.inc(matchable)
        self._m_hit_tok.inc(n_matched)
        self._m_partial_tok.inc(cow_len)
        self._m_miss_tok.inc(matchable - n_matched)
        return MatchResult(nodes=nodes, pages=pages, cow_src=cow_src,
                           cow_len=cow_len, n_matched=n_matched)

    # -------------------------------------------------------------- mutation

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Publish a prompt's full prompt pages for reuse.

        ``tokens`` must cover ``pages`` exactly (``len == len(pages) * ps``)
        and the pages must stay immutable while cached (full prompt pages
        are: decode writes land strictly past them).  Walks existing nodes
        without touching them — a double insert of an identical prompt adds
        no nodes and takes no extra references; only genuinely new pages are
        attached, with one pool reference each (the tree's).  Returns the
        number of pages newly cached."""
        ps = self.ps
        tokens = list(tokens)
        assert len(tokens) == len(pages) * ps, (len(tokens), len(pages), ps)
        node, new = self.root, 0
        tick = next(self._clock)
        for i, page in enumerate(pages):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, page, node)
                node.children[key] = child
                self.pool.share([page])
                new += 1
            child.last_access = tick
            node = child
        self._m_inserted.inc(new)
        self._n_nodes += new
        self._m_nodes.set(self._n_nodes)
        return new

    def lock(self, nodes: Sequence[RadixNode]) -> None:
        for nd in nodes:
            if nd.lock == 0:
                self._n_locked += 1
            nd.lock += 1
        self._m_locked.set(self._n_locked)

    def unlock(self, nodes: Sequence[RadixNode]) -> None:
        for nd in nodes:
            assert nd.lock > 0, "unlock of an unlocked radix node"
            nd.lock -= 1
            if nd.lock == 0:
                self._n_locked -= 1
        self._m_locked.set(self._n_locked)

    def evict(self, n_pages: int) -> int:
        """Detach up to ``n_pages`` LRU unlocked leaves, dropping the tree's
        page references.  Returns the number of references released (the pool
        frees each page only once every other owner has released it too)."""
        if self.eviction == "none":
            return 0
        freed = 0
        # one tree walk per call; evicting a leaf may expose its parent
        leaves = [nd for nd in self._walk()
                  if not nd.children and nd.lock == 0]
        while freed < n_pages and leaves:
            # prefer leaves whose page the tree solely owns — evicting those
            # actually frees pages; co-owned leaves (a live slot shares the
            # page) are burned only when needed to expose freeable ancestors
            freeing = [nd for nd in leaves if self.pool.ref(nd.page) == 1]
            victim = min(freeing or leaves, key=lambda nd: nd.last_access)
            leaves.remove(victim)
            parent = victim.parent
            del parent.children[victim.key]
            self.pool.release([victim.page])
            self.evictions += 1
            self._m_evictions.inc()
            self._n_nodes -= 1
            self._m_nodes.set(self._n_nodes)
            freed += 1
            if parent is not self.root and not parent.children \
                    and parent.lock == 0:
                leaves.append(parent)
        return freed

    def make_room(self, n_free: int) -> bool:
        """Evict (LRU) until the pool has ``n_free`` free pages, but only if
        that target is actually reachable — a hopeless request (the freeable
        mass is too small because live slots co-own most cached pages) evicts
        nothing, so a failed admission can't wipe the cache for no gain."""
        if self.pool.num_free >= n_free:
            return True
        if self.eviction == "none":
            return False
        if self.pool.num_free + self._freeable() < n_free:
            return False
        while self.pool.num_free < n_free:
            # batch: a single call may release co-owned refs without freeing
            if not self.evict(n_free - self.pool.num_free):
                return False            # unreachable unless _freeable lied
        return True

    def _freeable(self) -> int:
        """Upper bound on pages eviction could return to the free list: nodes
        whose page the tree solely owns, within fully-unlocked subtrees (a
        locked descendant pins every ancestor — leaves evict first)."""
        count = 0

        def visit(nd: RadixNode) -> bool:
            """Returns whether nd's whole subtree is unlocked."""
            nonlocal count
            open_ = all([visit(c) for c in nd.children.values()]) \
                and nd.lock == 0
            if open_ and nd is not self.root and self.pool.ref(nd.page) == 1:
                count += 1
            return open_

        visit(self.root)
        return count

    def reset(self) -> None:
        """Drop every cached page (the tree's references only: pages shared
        with live slots stay allocated until those slots release them)."""
        for nd in list(self._walk()):
            self.pool.release([nd.page])
        self.root.children.clear()
        self._n_nodes = 0
        self._m_nodes.set(0)

    # ------------------------------------------------------------ inspection

    def _walk(self) -> Iterator[RadixNode]:
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            yield nd

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self._walk())

    @property
    def cached_pages(self) -> List[int]:
        return [nd.page for nd in self._walk()]
