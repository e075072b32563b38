"""Paged KV pool: the page allocator behind the engine.

(The port's counterpart of ``repro.serving.kv_pool``: the pool tensors live
on the model's device and are written in place by the model steps.)

``PagedKVPool`` — fixed-size pages, free-list allocation, refcounts.
``StateSlotPool`` — one fixed-size state slot per decode row: the
recurrent state of the state-slot families, with the preemption
checkpoint/restore, or an enc-dec request's pinned cross K/V.

The pool replaces the old ``pad_cache_to`` whole-cache zero-pad copy with
vLLM/MaxText-style paging: the token-addressable cache for *all* live
requests lives in one layer-stacked array set (K/V pages for attention
families, latent pages for MLA), and each request owns an ordered list of
physical pages recorded in an int32 page table.  Allocation and release are
O(1) host-side free-list operations — admitting or retiring a request never
touches the device arrays.

The pool is *family-aware* via the model's ``cache_spec()``:

* plain / MLA paged families: ``pages_for(n)`` is ``ceil(n / page_size)``;
* sliding-window families: the table is a ring of ``horizon_pages`` entries
  and ``pages_for`` caps there — a request holds O(window) pages no matter
  how long it generates (aged-out pages are recycled in place);
* vlm: every request carries ``prefix_tokens`` image positions before its
  text, accounted into ``pages_for``;
* pure state-slot families (SSM / RG-LRU hybrids): ``paged_defs`` is empty,
  ``pages_for`` is 0, and all capacity lives in the ``StateSlotPool``.

Ownership is *refcounted* so pages can be shared across owners: the radix
prefix cache (``radix_cache``) holds one reference per cached page, and every
slot whose prompt prefix matched holds its own reference on the same physical
pages.  ``alloc`` hands out pages at refcount 1, ``share`` adds an owner,
``release`` (aliased as ``free``) drops one — the page only returns to the
free list when its last owner lets go.  A shared page is immutable by
convention: only full prompt pages are ever shared, and writes always land at
positions past every sharer's prompt (see ``radix_cache`` / ``scheduler``).

Physical page 0 is reserved as the *null page*: idle decode slots keep their
table rows zeroed so their (discarded) writes land there, and page-table
entries past a request's allocated region point at it harmlessly (attention
masks positions > pos, so stale bytes are softmax-zero).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..configs.base import ArchConfig, ServeConfig
from ..models.cache_spec import CacheFamilySpec, window_pages
from ..models.params import init_tree, tree_leaves, tree_map
from ..models.registry import build_model
from .telemetry import MetricsRegistry

NULL_PAGE = 0


class PagedKVPool:
    """Device cache pages + host-side page accounting for the serving engine."""

    def __init__(self, cfg: ArchConfig, scfg: ServeConfig,
                 metrics: Optional[MetricsRegistry] = None, *,
                 device="cpu"):
        self.cfg = cfg
        self.scfg = scfg
        self.device = torch.device(device)
        model = build_model(cfg)
        self.spec: CacheFamilySpec = model.cache_spec()
        ps = scfg.page_size
        self.horizon_pages: Optional[int] = (
            window_pages(self.spec.window, ps) if self.spec.window else None)
        if self.horizon_pages is not None and scfg.speculate_tokens:
            # speculative verify writes up to K draft tokens past pos before
            # accept/rollback; one slack page keeps a rejected draft's write
            # from recycling a slot that is still inside the window after
            # rollback (safe because K < page_size, asserted by ServeConfig —
            # the recycled slot's recovered position is already out of window
            # for every post-rollback query)
            self.horizon_pages += 1
        # widest table any request can need: full prompt+generation (plus the
        # vlm image prefix), capped at the ring horizon for windowed families
        raw = -(-(self.spec.prefix_tokens + scfg.max_len) // ps)
        self.table_width: int = (
            0 if not self.spec.paged
            else min(raw, self.horizon_pages) if self.horizon_pages else raw)
        self.total_pages: int = (
            scfg.num_pages or scfg.max_slots * max(self.table_width, 1) + 1)
        defs = model.paged_cache_defs(self.total_pages, ps,
                                      kv_dtype=scfg.kv_dtype)
        # zeros init: pages hold only finite values from day one, so masked
        # (zero-weight) reads of stale pages can never produce NaNs
        self.kv: Dict[str, torch.Tensor] = init_tree(defs, 0, self.device)
        # int8 scale leaves share the payload's page axis (axis 1 after layer
        # stacking): one physical page id addresses payload and scales
        # together, so ``pages_for``/``table_width``, refcounts, radix
        # sharing, COW forks, and ring recycling need no separate scale
        # accounting, and the conservation counters below reconcile
        # unchanged under int8.  The invariant the whole design rests on:
        for _, leaf in tree_leaves(self.kv):
            assert leaf.shape[1] == self.total_pages, (
                "paged-cache leaf does not share the pool page axis: "
                f"{leaf.shape} vs {self.total_pages} pages")
        self._free: List[int] = list(range(self.total_pages - 1, NULL_PAGE, -1))
        self._ref: Dict[int, int] = {}
        # telemetry: conservation counters (allocated == released + live at
        # any instant) plus occupancy gauges the scheduler can't see from
        # num_free alone
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_alloc = self.metrics.counter(
            "pool.pages_allocated", "pages handed out by alloc()")
        self._m_released = self.metrics.counter(
            "pool.pages_released", "pages returned to the free list")
        self._m_shares = self.metrics.counter(
            "pool.refs_shared", "extra owners added via share()")
        self._m_scrubbed = self.metrics.counter(
            "pool.pages_scrubbed", "pages zero-scrubbed during quarantine")
        self._m_live = self.metrics.gauge(
            "pool.pages_live", "pages currently allocated (refcount > 0)")
        self._m_free = self.metrics.gauge(
            "pool.free_pages", "free-list depth")
        self._m_refs = self.metrics.gauge(
            "pool.ref_total", "sum of refcounts over live pages")
        self._m_free.set(len(self._free))

    # ------------------------------------------------------------ accounting

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._ref)

    @property
    def refcounts(self) -> Dict[int, int]:
        """Live page -> owner count (copy; empty when the pool is idle)."""
        return dict(self._ref)

    def ref(self, page: int) -> int:
        return self._ref.get(page, 0)

    def pages_needed(self, n_tokens: int) -> int:
        """Raw page count for ``n_tokens`` contiguous positions."""
        ps = self.scfg.page_size
        return -(-n_tokens // ps)

    def pages_for(self, n_prompt_tokens: int) -> int:
        """Family-aware page budget for admitting a prompt: adds the vlm
        image prefix, caps at the ring horizon for windowed families, and is
        0 when the whole cache lives in state slots."""
        if not self.spec.paged:
            return 0
        n = self.pages_needed(self.spec.prefix_tokens + n_prompt_tokens)
        return min(n, self.horizon_pages) if self.horizon_pages else n

    @property
    def page_nbytes(self) -> int:
        """Device bytes one physical page occupies across all layers and
        leaves — int8 pools count payload *and* scale leaves, since a page id
        owns its slice of both."""
        return sum(leaf.numel() // leaf.shape[1] * leaf.element_size()
                   for _, leaf in tree_leaves(self.kv))

    @property
    def kv_bytes_per_token(self) -> float:
        """Device bytes one token slot costs (``page_nbytes / page_size``) —
        the decode read path moves exactly this much per live token, so it is
        the quantization win the benchmarks gate on."""
        return self.page_nbytes / self.scfg.page_size

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages from the free list; None (no partial grab) if short.

        Each returned page starts at refcount 1 (the caller is the owner)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self._m_alloc.inc(n)
        self._m_refs.inc(n)
        self._sync_gauges()
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one owner to each (already-allocated) page."""
        for p in pages:
            assert p != NULL_PAGE, "tried to share the reserved null page"
            assert p in self._ref, f"share of unallocated page {p}"
            self._ref[p] += 1
        self._m_shares.inc(len(pages))
        self._m_refs.inc(len(pages))

    def release(self, pages: Sequence[int]) -> None:
        """Drop one owner per page; pages at refcount 0 return to the free
        list.  Releasing a page you don't own is a double free."""
        for p in pages:
            assert p != NULL_PAGE, "tried to free the reserved null page"
            assert p in self._ref, f"double free of page {p}"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)
                self._m_released.inc()
        self._m_refs.dec(len(pages))
        self._sync_gauges()

    def _sync_gauges(self) -> None:
        self._m_live.set(len(self._ref))
        self._m_free.set(len(self._free))

    def note_scrubbed(self, n: int) -> None:
        """Record ``n`` pages zero-scrubbed by the engine's quarantine path."""
        self._m_scrubbed.inc(n)

    def conservation_ok(self) -> bool:
        """Counter reconciliation: every page ever allocated is either live
        or has been released, and the free list + live set tile the pool
        (minus the reserved null page)."""
        alloc = self.metrics.value("pool.pages_allocated")
        released = self.metrics.value("pool.pages_released")
        if alloc != released + len(self._ref):
            return False
        return len(self._free) + len(self._ref) == self.total_pages - 1

    # exclusive-ownership spelling used by pre-refcount call sites/tests
    free = release

    # ------------------------------------------------------------ page tables

    def new_table(self) -> np.ndarray:
        """An all-null page table row ([table_width] int32)."""
        return np.full((max(self.table_width, 1),), NULL_PAGE, np.int32)


class StateSlotPool:
    """Per-request fixed-size state slots, one per decode row.

    The device state is one layer-stacked tree on the model's device whose
    slot axis is axis 1 and whose slot index equals the engine's decode
    row, so the decode step reads and writes it in place with no gather.
    ``claim``/``release`` book-keep which rows are live;
    ``checkpoint``/``restore`` are the preemption half of the slot
    lifetime (alloc -> checkpoint-on-preempt -> restore -> free): a
    checkpoint copies the slot's rows to host memory and waits for the
    copy, so the next admission may overwrite the slot on the stream, and
    a restore writes a snapshot back in place, into any claimed slot."""

    def __init__(self, cfg: ArchConfig, scfg: ServeConfig,
                 metrics: Optional[MetricsRegistry] = None, *,
                 device="cpu"):
        self.cfg = cfg
        self.scfg = scfg
        self.device = torch.device(device)
        # enc-dec slots pin ``enc_len`` encoder positions of cross K/V
        defs = build_model(cfg).state_slot_defs(scfg.max_slots, scfg.max_len,
                                                enc_len=scfg.enc_len)
        self.state: Dict[str, Any] = init_tree(defs, 0, self.device)
        self.n_slots = scfg.max_slots
        for _, leaf in tree_leaves(self.state):
            assert leaf.shape[1] == self.n_slots, (
                f"state leaf {tuple(leaf.shape)} has no slot axis 1 of "
                f"{self.n_slots}")
        self._claimed: Set[int] = set()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_resident = self.metrics.gauge(
            "states.slots_claimed", "state slots held by live requests")
        self._m_claims = self.metrics.counter(
            "states.claims", "state-slot claims (admissions)")
        self._m_ckpt = self.metrics.counter(
            "states.checkpoints", "slot snapshots taken on preemption")
        self._m_restore = self.metrics.counter(
            "states.restores", "checkpointed snapshots written back")

    # ------------------------------------------------------------ accounting

    @property
    def num_claimed(self) -> int:
        return len(self._claimed)

    @property
    def claimed(self) -> Set[int]:
        return set(self._claimed)

    @property
    def slot_nbytes(self) -> int:
        """Device bytes one slot occupies across every layer and leaf."""
        return sum(leaf.numel() // self.n_slots * leaf.element_size()
                   for _, leaf in tree_leaves(self.state))

    def claim(self, slot: int) -> None:
        assert 0 <= slot < self.n_slots, slot
        assert slot not in self._claimed, f"double claim of state slot {slot}"
        self._claimed.add(slot)
        self._m_claims.inc()
        self._m_resident.set(len(self._claimed))

    def release(self, slot: int) -> None:
        assert slot in self._claimed, f"release of unclaimed state slot {slot}"
        self._claimed.remove(slot)
        self._m_resident.set(len(self._claimed))

    # ------------------------------------------------- checkpoint / restore

    def checkpoint(self, slot: int) -> Any:
        """Snapshot one slot's state to host memory (preemption); returns
        once the copy is complete."""
        assert slot in self._claimed, f"checkpoint of unclaimed slot {slot}"
        self._m_ckpt.inc()
        return tree_map(lambda a: a[:, slot].to("cpu", copy=True),
                        self.state)

    def restore(self, slot: int, saved: Any) -> None:
        """Write a checkpointed snapshot back, in place, into (a possibly
        different) claimed slot."""
        assert slot in self._claimed, f"restore into unclaimed slot {slot}"
        self._m_restore.inc()
        tree_map(lambda a, s: a[:, slot].copy_(s), self.state, saved)

    # --------------------------------------------------- fault-tolerance hooks

    def _fill_row(self, slot: int, value: float) -> None:
        for _, leaf in tree_leaves(self.state):
            if leaf.is_floating_point():
                leaf[:, slot] = value

    def scrub(self, slot: int) -> None:
        """Zero one slot row (quarantine cleanup).  Rows are overwritten at
        the next claim anyway; scrubbing keeps every idle row finite, so a
        stale NaN can never leak through a masked read."""
        self._fill_row(slot, 0.0)

    def poison(self, slot: int) -> None:
        """Fill one slot row with NaN (fault injection only)."""
        self._fill_row(slot, float("nan"))
