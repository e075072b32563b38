"""Continuous-batching request scheduler.

Policy (SGLang/Orca-style, simplified to a synchronous loop):

* **Admission**: whenever a decode slot is free and the pools can cover the
  prompt, queued requests are admitted via a bucketed tail prefill — and the
  head of the queue is drained *in batch*: every consecutive queued request
  whose tail lands in the same prefill bucket is admitted into the same
  prefill call, up to the free slots (``try_admit_batch``).  Prefill has
  priority over decode — keeping slots full is what buys continuous batching
  its throughput.  With the radix prefix cache enabled, admission first
  matches the prompt against the tree: matched full pages are shared
  (refcount +1), a partially-matched page is forked copy-on-write, and only
  the uncached tail is prefilled.  Admission is **all-or-nothing** per
  request: every accounting step (dequeue, share, alloc, claim, lock, bind)
  happens only after capacity is proven, so a failed attempt mutates nothing.
* **Families**: the page budget is family-aware (``pool.pages_for``): plain
  ceil for token-addressable KV/MLA pages, capped at the ring horizon for
  sliding-window families (pages recycle in place once positions age out of
  the window), zero for pure state-slot families.  State-slot families
  (SSM / RG-LRU hybrids, the enc-dec cross cache) additionally claim one
  ``StateSlotPool`` slot, whose index is the decode row.
* **Chunked prefill** (``ServeConfig.prefill_chunk_tokens > 0``, paged
  text-prompt families): a prompt longer than the budget is prefilled in
  page-aligned *chunks* that interleave Sarathi-style with decode steps —
  after any prefill step, a decode step runs whenever a slot is decode-ready,
  so one long prompt can never head-of-line-block every live request for its
  whole prefill.  A mid-prefill request stays resident in its slot with all
  its pages and an ``n_filled`` cursor; it joins the decode batch only once
  the cursor reaches the prompt end (and earns its first token from that
  final chunk's logits).  Continuation chunks batch like admissions do
  (same-bucket, oldest first, capped at the budget), and completed pages
  publish to the radix cache after every chunk, so a same-prefix request
  queued behind a long prompt starts hitting the cache mid-prefill.
* **Decode**: otherwise every decode-ready slot advances one token in a
  single fixed-shape jitted step; idle slots ride along masked (their
  page-table rows point at the null page).
* **Growth / eviction / preemption**: a slot crossing a page boundary gets a
  fresh page from the free list — unless it has reached the ring horizon, in
  which case the table entry it is about to write already points at the page
  that just aged out (recycling, no host work at all).  If the pool is
  exhausted, unlocked radix nodes are LRU-evicted first, then the youngest
  slot is preempted.  For checkpointable (pure state-slot) families
  preemption snapshots the slot state to host memory and re-admission
  *restores* it, resuming mid-generation; for paged families the request is
  requeued from scratch (greedy decode is deterministic, so the replay
  reproduces its prefix — usually straight from the cache).
* **Retirement**: EOS or max-tokens retires the slot, releases its page
  references, state slot, and radix locks immediately, making room for the
  next admission.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from ..configs.base import ServeConfig
from .kv_pool import PagedKVPool, StateSlotPool
from .radix_cache import RadixCache, RadixNode
from .speculate import speculation_k
from .telemetry import MetricsRegistry, Tracer


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    # --- filled in by the engine ---
    arrival: float = 0.0
    t_first: Optional[float] = None      # first-token (prefill done) time
    t_finish: Optional[float] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    n_preemptions: int = 0
    cached_tokens: int = 0               # prompt tokens served from the cache
    # checkpoint-on-preempt snapshot: (pos, host state pytree), or None
    checkpoint: Optional[Tuple[int, Any]] = None
    error: str = ""                      # nonempty: rejected or cancelled
    # --- fault tolerance / QoS (serving/admission) ---
    deadline: Optional[float] = None         # absolute: finish by this time
    ttft_deadline: Optional[float] = None    # absolute: first token by this
    retry_after_s: float = 0.0               # backoff hint set when shed

    @property
    def finished(self) -> bool:
        return self.t_finish is not None


@dataclasses.dataclass
class Slot:
    """A live request bound to a decode-batch row."""
    req: Request
    pos: int                              # next write position (= tokens cached)
    table: np.ndarray                     # [table_width] int32
    pages: List[int]                      # referenced physical pages, in order
    admit_seq: int                        # admission order (preemption victim key)
    nodes: List[RadixNode] = dataclasses.field(default_factory=list)
    n_shared: int = 0                     # leading pages shared via the cache
    n_filled: int = 0                     # prompt tokens resident (cached +
                                          # prefilled); < len(prompt) means
                                          # the slot is mid-chunked-prefill
                                          # and not yet decode-ready

    @property
    def prefilling(self) -> bool:
        return self.n_filled < len(self.req.prompt)


@dataclasses.dataclass
class Admission:
    """An admission the scheduler has fully accounted; the engine only has to
    run the device work (COW copy + chunk prefill, or a state restore)."""
    slot_idx: int
    req: Request
    n_matched: int                        # cached prompt tokens (incl. COW)
    cow_src: Optional[int]                # page to fork, or None
    cow_dst: Optional[int]                # exclusively-owned fork target
    table: np.ndarray                     # the bound slot's page table
    pages: List[int]                      # shared + exclusive pages, in order
    n_chunk: int = 0                      # first-chunk tokens to prefill (the
                                          # whole tail when chunking is off)
    restore: Optional[Tuple[int, Any]] = None   # checkpointed (pos, state)


class Scheduler:
    def __init__(self, scfg: ServeConfig, pool: PagedKVPool,
                 radix: Optional[RadixCache] = None,
                 states: Optional[StateSlotPool] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.scfg = scfg
        self.pool = pool
        self.radix = radix
        self.states = states
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Slot]] = [None] * scfg.max_slots
        self.finished: List[Request] = []
        self._admit_seq = 0
        # telemetry: queueing + admission-policy visibility (the engine's
        # step counters say what ran; these say what was *decided* and why)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self._m_queue = self.metrics.gauge(
            "sched.queue_depth", "requests waiting for admission")
        self._m_slots = self.metrics.gauge(
            "sched.slots_live", "decode slots bound to live requests")
        self._m_queued = self.metrics.counter(
            "sched.queued", "requests entering the queue (incl. requeues)")
        self._m_admits = self.metrics.counter(
            "sched.admissions", "committed admissions by kind",
            labels=("kind",))               # fresh | cache_hit | restore
        self._m_rejects = self.metrics.counter(
            "sched.rejections", "admission attempts blocked, by reason",
            labels=("reason",))             # no_slot | no_pages
        self._m_preempt = self.metrics.counter(
            "sched.preemptions", "slots evicted under pressure, by kind",
            labels=("kind",))               # checkpoint | replay
        self._m_chunks = self.metrics.counter(
            "sched.chunk_continuations", "continuation chunks scheduled")
        # chunked prefill applies to families whose prompt KV is
        # token-addressable pages at text positions: recurrent state must be
        # carried through a whole prompt in one call, and the vlm image
        # prefix belongs to the first hidden positions of one call
        self.chunk: int = (scfg.chunk_tokens
                           if pool.spec.paged and not pool.spec.prefix_tokens
                           else 0)
        # speculative decoding widens the per-step write horizon: a verify
        # step may write K/V at positions pos .. pos + spec_k, so page
        # growth must cover the whole span (same gate as the engine)
        self.spec_k = speculation_k(pool.cfg, pool.spec, scfg)
        self._last_was_prefill = False

    # ------------------------------------------------------------- inventory

    def add(self, req: Request) -> None:
        if len(req.prompt) >= self.scfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt len {len(req.prompt)} >= "
                f"max_len {self.scfg.max_len}")
        self.queue.append(req)
        self._m_queued.inc()
        self._m_queue.set(len(self.queue))
        self.tracer.on_queued(req.rid, req.arrival or self.tracer.now())

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def decode_ready(self) -> List[int]:
        """Slots whose prompt KV is fully resident — the decode batch.
        Mid-chunked-prefill slots ride along masked (null-page tables would
        be wrong: they own real pages, they just haven't earned a first
        token yet)."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.prefilling]

    def prefilling_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.prefilling]

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _chunk_len(self, n_done: int, n_prompt: int) -> int:
        """Length of the next prefill chunk for a prompt with ``n_done``
        tokens already resident: everything that's left when chunking is
        off, else up to the budget, ending on a page boundary (so completed
        pages can publish to the radix cache) unless the prompt ends first.
        A cache hit can leave ``n_done`` mid-page (COW); alignment recovers
        at the first chunk boundary."""
        if not self.chunk:
            return n_prompt - n_done
        ps = self.scfg.page_size
        end = min(n_prompt, (n_done + self.chunk) // ps * ps)
        if end <= n_done:                  # can't happen with chunk >= ps;
            end = min(n_prompt, n_done + self.chunk)   # guard anyway
        return end - n_done

    def sweep_deadlines(self, now: float) -> Tuple[List[Request], List[int]]:
        """Deadline police: requests whose total deadline passed, or whose
        TTFT deadline passed before any token, are expired.  Queued expirees
        are removed from the queue and returned; live expirees are returned
        as still-bound slot indices — the engine owns the terminal path
        (staged-step teardown, tracer instant, metrics) and retires them."""
        def expired(req: Request) -> bool:
            if req.deadline is not None and now > req.deadline:
                return True
            return (req.ttft_deadline is not None and req.t_first is None
                    and now > req.ttft_deadline)

        expired_q = [r for r in self.queue if expired(r)]
        for r in expired_q:
            self.queue.remove(r)
        if expired_q:
            self._m_queue.set(len(self.queue))
        expired_live = [i for i, s in enumerate(self.slots)
                        if s is not None and expired(s.req)]
        return expired_q, expired_live

    # ------------------------------------------------------------ scheduling

    def next_action(self) -> Optional[Tuple]:
        """('prefill', [Admission, ...]) | ('prefill_chunk', [slot_idx, ...])
        | ('restore', Admission) | ('decode', [slot_idx, ...]) | None.

        Without chunking, prefill has strict priority over decode (keeping
        slots full is what buys continuous batching its throughput).  With a
        chunk budget set, steps interleave Sarathi-style instead: a prefill
        step (admission or continuation chunk) is followed by a decode step
        whenever any slot is decode-ready, so a long prompt advances one
        bounded chunk at a time instead of stalling every live request for
        its whole prefill."""
        order = ("prefill", "decode")
        if self.chunk and self._last_was_prefill and self.decode_ready():
            order = ("decode", "prefill")
        for phase in order:
            act = self._prefill_action() if phase == "prefill" \
                else self._decode_action()
            if act is not None:
                self._last_was_prefill = act[0] != "decode"
                return act
        if self.queue:
            # no slot/page capacity and nothing running to free any.  If the
            # prefix cache is what holds the pool (cache_eviction="none", or
            # only co-owned leaves blocked make_room), serving beats caching:
            # flush the tree's references and retry once before giving up.
            if self.radix is not None and self.radix.num_nodes:
                self.radix.reset()
                act = self._prefill_action()
                if act is not None:
                    self._last_was_prefill = True
                    return act
            raise RuntimeError(
                f"scheduler deadlock: request {self.queue[0].rid} needs "
                f"{self.pool.pages_for(len(self.queue[0].prompt))} pages, "
                f"pool has {self.pool.num_free} free and no live slots")
        return None

    def _prefill_action(self) -> Optional[Tuple]:
        """Admissions first (keeping slots full is what buys continuous
        batching its throughput), then continuation chunks of already-
        admitted prompts."""
        if self.queue:
            adms = self.try_admit_batch()
            if adms:
                if adms[0].restore is not None:
                    return ("restore", adms[0])
                return ("prefill", adms)
        chunks = self._chunk_batch()
        if chunks:
            self._m_chunks.inc(len(chunks))
            return ("prefill_chunk", chunks)
        return None

    def _decode_action(self) -> Optional[Tuple]:
        if not self.decode_ready():
            return None
        self._grow_pages()
        active = self.decode_ready()              # growth may have preempted
        return ("decode", active) if active else None

    def _chunk_batch(self) -> List[int]:
        """Continuation chunks, oldest admissions first: consecutive
        mid-prefill slots whose next chunk lands in the same bucket are
        batched, up to the per-step token budget."""
        jobs: List[int] = []
        bucket: Optional[int] = None
        total = 0
        for i in sorted(self.prefilling_slots(),
                        key=lambda i: self.slots[i].admit_seq):
            slot = self.slots[i]
            c = self._chunk_len(slot.n_filled, len(slot.req.prompt))
            b = self.scfg.bucket_of(c)
            if bucket is not None and b != bucket:
                break
            if jobs and total + c > self.chunk:
                break
            jobs.append(i)
            bucket, total = b, total + c
        return jobs

    def try_admit_batch(self) -> List[Admission]:
        """Drain the queue head into one prefill: consecutive requests whose
        first chunks share a bucket are admitted together (each one
        individually all-or-nothing), capped at the per-step token budget
        when chunking is on.  A checkpointed request is admitted alone — its
        action is a state restore, not a prefill.  With the prefix cache on,
        a request whose prompt pages an *earlier admission in this batch* is
        about to publish waits a step instead, so it re-matches as a cache
        hit rather than prefilling the shared prefix redundantly."""
        adms: List[Admission] = []
        bucket: Optional[int] = None
        ps = self.scfg.page_size
        total = 0
        pending_keys: set = set()
        while self.queue:
            head = self.queue[0]
            if head.checkpoint is not None:
                if not adms:
                    adm = self.try_admit()
                    if adm is not None:
                        adms.append(adm)
                break
            n_matched = 0
            match = None
            keys = set()
            if self.radix is not None:
                # one probe (clock-touches only) finds the chunk bucket and
                # is reused by try_admit below — nothing mutates in between
                match = self.radix.match(head.prompt, len(head.prompt) - 1)
                n_matched = match.n_matched
                # a radix node is its token *prefix*: key the pages this
                # prompt would publish by their cumulative prefixes
                keys = {tuple(head.prompt[:(j + 1) * ps])
                        for j in range(len(head.prompt) // ps)}
                if keys & pending_keys:
                    break
            c = self._chunk_len(n_matched, len(head.prompt))
            b = self.scfg.bucket_of(c)
            if bucket is not None and b != bucket:
                break
            if self.chunk and adms and total + c > self.chunk:
                break
            adm = self.try_admit(match)
            if adm is None:
                break
            adms.append(adm)
            bucket, total = b, total + c
            pending_keys |= keys
        return adms

    def try_admit(self, match=None) -> Optional[Admission]:
        """Admit the oldest queued request if (and only if) every resource it
        needs is available; on failure nothing — queue, pool, tree — changes.
        ``match`` is an optional precomputed ``radix.match`` result for the
        head request (the batch loop's probe), reused to avoid a second
        tree walk."""
        idx = self.free_slot()
        if not self.queue:
            return None
        if idx is None:
            self._m_rejects.labels(reason="no_slot").inc()
            return None
        req = self.queue[0]
        if req.checkpoint is not None:
            # checkpointable families are page-free: a slot is all it needs
            self.queue.popleft()
            self._m_queue.set(len(self.queue))
            self._m_admits.labels(kind="restore").inc()
            pos, _ = req.checkpoint
            slot = self.bind(idx, req, [], pos=pos,
                             n_filled=len(req.prompt))
            adm = Admission(slot_idx=idx, req=req, n_matched=0, cow_src=None,
                            cow_dst=None, table=slot.table, pages=[],
                            restore=req.checkpoint)
            req.checkpoint = None
            return adm
        n = len(req.prompt)
        nodes: List[RadixNode] = []
        shared: List[int] = []
        cow_src, cow_len, n_matched = None, 0, 0
        if self.radix is not None:
            m = match or self.radix.match(req.prompt, n - 1)
            nodes, shared = m.nodes, m.pages
            cow_src, cow_len, n_matched = m.cow_src, m.cow_len, m.n_matched
        # the last prompt token is always computed, so at least one page is
        # never shared: need >= 1 for paged families (0 for state-slot-only)
        need = self.pool.pages_for(n) - len(shared)
        if self.pool.num_free < need:
            if self.radix is not None:
                # pin the matched path so making room can't evict it; a
                # hopeless attempt evicts nothing (all-or-nothing extends to
                # the cache contents)
                self.radix.lock(nodes)
                self.radix.make_room(need)
                self.radix.unlock(nodes)
            if self.pool.num_free < need:
                self._m_rejects.labels(reason="no_pages").inc()
                return None
        # ---- commit point: capacity proven, take everything atomically ----
        self.queue.popleft()
        self._m_queue.set(len(self.queue))
        self._m_admits.labels(
            kind="cache_hit" if n_matched else "fresh").inc()
        self.pool.share(shared)
        fresh = self.pool.alloc(need)
        assert fresh is not None
        if self.radix is not None:
            self.radix.lock(nodes)
        pages = shared + fresh
        slot = self.bind(idx, req, pages,
                         pos=self.pool.spec.prefix_tokens + n, nodes=nodes,
                         n_shared=len(shared), n_filled=n_matched)
        req.cached_tokens = n_matched
        return Admission(slot_idx=idx, req=req, n_matched=n_matched,
                         cow_src=cow_src,
                         cow_dst=fresh[0] if cow_len else None,
                         table=slot.table, pages=pages,
                         n_chunk=self._chunk_len(n_matched, n))

    # ----------------------------------------------------- slot transitions

    def bind(self, slot_idx: int, req: Request, pages: List[int], pos: int,
             nodes: Optional[List[RadixNode]] = None,
             n_shared: int = 0, n_filled: Optional[int] = None) -> Slot:
        table = self.pool.new_table()
        table[:len(pages)] = pages
        slot = Slot(req=req, pos=pos, table=table, pages=pages,
                    admit_seq=self._admit_seq, nodes=list(nodes or []),
                    n_shared=n_shared,
                    n_filled=len(req.prompt) if n_filled is None else n_filled)
        self._admit_seq += 1
        self.slots[slot_idx] = slot
        if self.states is not None:
            self.states.claim(slot_idx)
        self._m_slots.set(sum(s is not None for s in self.slots))
        return slot

    def _unbind(self, slot_idx: int) -> Slot:
        """Release a slot's page references, state slot, and radix locks
        (shared pages are freed only when their last owner — usually the
        tree — lets go)."""
        slot = self.slots[slot_idx]
        assert slot is not None
        self.pool.release(slot.pages)
        if self.states is not None:
            self.states.release(slot_idx)
        if self.radix is not None and slot.nodes:
            self.radix.unlock(slot.nodes)
        self.slots[slot_idx] = None
        self._m_slots.set(sum(s is not None for s in self.slots))
        return slot

    def retire(self, slot_idx: int) -> Request:
        """EOS / max-len eviction: drop every page reference the slot holds."""
        slot = self._unbind(slot_idx)
        self.finished.append(slot.req)
        return slot.req

    def preempt(self, slot_idx: int) -> Request:
        """Evict a live slot and requeue its request.

        Checkpointable (pure state-slot) families snapshot the slot's state
        to host memory first — re-admission restores it and decoding resumes
        mid-generation, tokens intact.  Paged families release their page
        references for a clean replay (only exclusively-owned pages actually
        return to the free list; pages published to the radix cache stay
        resident, so the replay typically re-admits as a cache hit)."""
        checkpointable = (self.states is not None
                          and self.pool.spec.checkpointable)
        if checkpointable:
            slot = self.slots[slot_idx]
            assert slot is not None
            slot.req.checkpoint = (slot.pos,
                                   self.states.checkpoint(slot_idx))
        slot = self._unbind(slot_idx)
        if not checkpointable:
            # replay regenerates the same greedy tokens, but t_first is NOT
            # reset: TTFT measures the first token *ever* produced, so the
            # legacy RequestResult.ttft agrees with tracer ttft_s
            slot.req.generated.clear()
            slot.req.cached_tokens = 0
        slot.req.n_preemptions += 1
        self.queue.appendleft(slot.req)
        self._m_preempt.labels(
            kind="checkpoint" if checkpointable else "replay").inc()
        self._m_queue.set(len(self.queue))
        self.tracer.on_preempted(slot.req.rid, self.tracer.now(),
                                 checkpointable)
        return slot.req

    def _grow_pages(self) -> None:
        """Before a decode step, every live slot must own the page its next
        write lands in — and with speculation on, every page any of the up
        to ``spec_k + 1`` verify-step writes (positions pos .. pos + spec_k)
        lands in, since an accepted draft advances the cursor several
        positions in one step (it may cross a page boundary mid-step).
        Ring-horizon slots recycle in place (their next table entry already
        points at the page that aged out of the window).  When the pool runs
        dry, LRU-evict unlocked cache nodes first, then preempt
        youngest-first."""
        if not self.pool.spec.paged:
            return                         # state-slot families never grow
        ps = self.scfg.page_size
        cap = self.pool.table_width
        for i in sorted(self.active_slots(),
                        key=lambda i: self.slots[i].admit_seq):
            slot = self.slots[i]
            if slot is None:
                continue
            if slot.prefilling:
                continue                   # all prompt pages bound at admission;
                                           # the decode page can wait its turn
            # last page index this step's writes can reach; past the ring
            # horizon the table entries recycle in place instead of growing
            need_to = min((slot.pos + self.spec_k) // ps, cap - 1)
            while len(slot.pages) <= need_to:
                if self.slots[i] is not slot:
                    break                  # preemption below evicted *us*
                pages = self.pool.alloc(1)
                if pages is not None:
                    slot.table[len(slot.pages)] = pages[0]
                    slot.pages.extend(pages)
                    continue
                if self.radix is not None and self.radix.make_room(1):
                    continue                   # eviction freed a page
                victims = [j for j in self.active_slots() if j != i]
                if not victims:
                    # last resort before giving up: the cache may hold pages
                    # this slot doesn't use (cache_eviction="none" keeps
                    # make_room from touching them) — flush and retry
                    if self.radix is not None and self.radix.num_nodes:
                        self.radix.reset()
                        continue
                    raise RuntimeError(
                        "page pool exhausted with a single live slot; "
                        "increase ServeConfig.num_pages")
                victim = max(victims, key=lambda j: self.slots[j].admit_seq)
                self.preempt(victim)
