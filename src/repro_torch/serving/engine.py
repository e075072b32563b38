"""Synchronous continuous-batching inference engine (dense and MoE
families: GQA K/V pages, sliding-window page rings, MLA latent pages; the
state-slot families: SSM and RG-LRU + local-attention state slots).

``Engine`` exposes the classic three-call serving API:

    eng = Engine(cfg, scfg, device="cuda")   # random params from ``seed``
    eng.add_request([1, 2, 3], max_new_tokens=16)
    while eng.step():                        # one prefill OR one decode step
        pass
    results = eng.collect()                  # finished RequestResults

plus ``run_offline(prompts)``, the batch driver used by ``launch/serve.py``.
It is the port of ``repro.serving.engine`` for the families the port
builds (full attention, sliding-window page rings of O(window) pages, which
the radix cache cannot share, and per-request state slots): prefill writes
straight into the paged pool or the state-slot pool (``prefill_paged``)
— the whole prompt, or with the radix prefix cache only its uncached tail —
at a bucketed length, several same-bucket queued requests admitted in one
batched call; with ``ServeConfig.prefill_chunk_tokens > 0`` long prompts
prefill in page-aligned chunks that interleave with decode steps (see
``scheduler``), publishing completed pages to the radix cache after every
chunk.  Decode runs one fixed-shape ``[max_slots]`` step; with
``ServeConfig.speculate_tokens = K`` every decode-ready step runs instead
as a small-q verify step over the last token plus up to K n-gram drafts
(``speculate``), accepting the longest draft prefix the verify argmax
reproduces.  ``ServeConfig.kv_dtype = "int8"`` stores the pool as int8
pages with bf16 scale pages.  The paged attends route through the backend
registry (``ServeConfig.attn_backend``: ``auto|reference|hopper``, see
``models.attn_backend``), and each step gets flat host-built metadata
(``decode_meta`` / ``prefill_meta`` / ``verify_meta``) — page-table rows,
positions, physical write targets — derived once per step.

The pool lives on the engine's device and the model steps write it in
place (the JAX engine donated its buffers to jitted steps instead); the COW
page fork, the quarantine scrub and the fault injector's NaN poison are
in-place writes too.  The engine runs on ``cuda`` unless constructed with
``device="cpu"``.

**Overlapped host/device pipeline.**  Every step is split into a
*dispatch* half (scheduler decision, host-side meta build, the step's
launches — on a CUDA device the kernels are queued on the stream and
control returns while they run) and a *collect* half (the copy of the
step's tokens to the host, which waits for the device, then token
bookkeeping and retirement).  ``step()`` runs them back to back;
``pump()`` additionally *stages* the host plan of step N+1 between the two
halves: while step N's kernels run, the engine builds the next decode
step's page tables, positions and ``decode_meta`` and queues their upload
from page-locked buffers (``meta_to_device(non_blocking=True)``: nothing
in staging waits for the stream).  At the next dispatch the staged plan is
used only if its fingerprint (slot, rid, position, page count) equals a
replan's, so a used plan is bit-identical to a replan and tokens stay
exact.  ``run_offline(..., overlap=True)`` and the streaming front end
(``serving.server``) drive ``pump()``; the ``engine.overlap_*`` counters
count staged, used and dropped plans, and the dispatch / stage / collect
halves appear on the tracer's host-pipeline track.

**Fault tolerance.**  ``faults=FaultPlan`` (``serving.faults``) fires
injected faults at the engine's seams: a NaN poison of the target's newest
exclusively-owned page before a decode launch (its row's finite flag comes
back False and the row is quarantined), a ``RequestFault`` raised before a
launch (only that request is quarantined: the pool was not written yet),
hostage pages (pool pressure), and client disconnects.  A quarantined
request's exclusively-owned pages are zeroed before they return to the
free list.  With ``ServeConfig.admission_control`` a request whose
deadline the calibrated queue model (``admission.AdmissionController``)
cannot meet is shed at the door with a ``retry_after_s`` hint, and
admitted requests past their deadline are evicted by a sweep before every
dispatch; a draining engine sheds every new request.

**State slots.**  For the ssm and hybrid families the whole cache lives
in a ``StateSlotPool`` slot per request (slot index = decode row): the
prefill scatters each row's final state in place, the decode step
advances every slot's state in place, and a preemption checkpoints the
slot to host memory; the scheduler's ``restore`` action writes it back
into a free slot, and decoding resumes where it stopped
(``engine.state_restores``).  The fault injector's NaN poison and the
quarantine scrub fill the slot's state row.

**Frontend inputs.**  An enc-dec arch (seamless-m4t) conditions each
request on ``ServeConfig.enc_len`` frames of encoder input, a vlm (llava)
on ``n_image_tokens`` image embeddings: both are stubs drawn by
``_synthetic_frontend`` from (engine seed, request id), uploaded once a
first-chunk prefill.  The enc-dec prefill encodes them and pins the
request's cross K/V in its ``StateSlotPool`` slot; its continuation chunks
(``prefill_paged_cont``) read the pinned rows and run no encoder.  A vlm's
image prefix takes the first ``n_image_tokens`` positions of its pages.

``generate_static`` is the static-batching baseline kept for verification:
contiguous per-request KV caches, the whole batch padded together and
decoded until its slowest member finishes.

Streaming hook: ``on_token(rid, index, token, t)`` fires as each token is
collected (a preemption replay re-fires earlier indexes; consumers dedup by
index).  ``cancel(rid)`` aborts a queued or live request.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig, ServeConfig
from ..models.attn_backend import (decode_meta, meta_to_device, prefill_meta,
                                   resolve_backend, verify_meta)
from ..models.params import tree_leaves, tree_map
from ..models.registry import build_model, init_cache, init_params
from ..models.steps import make_serve_step
from .admission import AdmissionController, HealthState
from .faults import FaultInjector, FaultPlan, RequestFault
from .kv_pool import NULL_PAGE, PagedKVPool, StateSlotPool
from .radix_cache import RadixCache
from .scheduler import Admission, Request, Scheduler
from .speculate import NgramProposer, accept_length, speculation_k
from .telemetry import MetricsRegistry, Tracer, shared_metrics


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt: List[int]
    tokens: List[int]                 # generated tokens (greedy), incl. EOS
    latency: float                    # arrival -> finish (s)
    ttft: float                       # arrival -> first token *ever* (s)
    n_preemptions: int = 0
    cached_tokens: int = 0            # prompt tokens reused from the cache
    # --- per-request timing from the lifecycle tracer ---
    ttft_s: float = 0.0               # == ttft (tracer-sourced spelling)
    finish_s: float = 0.0             # == latency (tracer-sourced spelling)
    tpot_s: float = 0.0               # time per output token after the first
    n_prefill_chunks: int = 0         # prefill calls run (incl. replays)
    preempted: bool = False
    error: str = ""                   # nonempty: rejected/cancelled/shed/
                                      # quarantined; tokens hold whatever the
                                      # request produced before the terminal
    retry_after_s: float = 0.0        # backoff hint for shed requests

    @property
    def failed(self) -> bool:
        return bool(self.error)


@dataclasses.dataclass
class _Pending:
    """One launched-but-not-collected engine step: on a CUDA device the
    kernels may still be running; ``_finish_step`` blocks on ``out_dev``
    and runs the host-side bookkeeping."""
    kind: str       # prefill | prefill_chunk | restore | decode | verify
    payload: Any                      # scheduler action payload
    rows: Any                         # prefill row tuples / decode active list
    out_dev: Any                      # device logits / next-token tensors
    t0: float                         # dispatch start (step span start)
    t_dispatched: float               # host-side dispatch end
    waiting: bool                     # decode-ready slots parked behind this


@dataclasses.dataclass
class _StagedDecode:
    """A pre-built plan for the *next* decode step, built while the current
    step runs on the device.  ``fp`` is the exact post-step fingerprint
    (slot, rid, pos, owned pages, draft len) the plan assumed; dispatch uses
    the plan only when reality still matches, so a used plan is
    bit-identical to a replan.  Only plain decode steps stage (a verify
    step's draft is unknowable a step ahead), so the staged draft length is
    always 0."""
    active: Tuple[int, ...]
    fp: Tuple[Tuple[int, int, int, int, int], ...]
    meta: Dict[str, torch.Tensor]     # decode_meta, upload already queued


def _copy_page(kv, src: int, dst: int) -> None:
    """Fork physical page ``src`` into ``dst`` across every layer (COW),
    in place."""
    for _, leaf in tree_leaves(kv):
        leaf[:, dst] = leaf[:, src]


def _zero_pages(kv, pages: List[int]) -> None:
    """Zero physical pages ``pages`` across every layer (quarantine scrub),
    in place."""
    for _, leaf in tree_leaves(kv):
        leaf[:, pages] = 0


def _poison_pages(kv, pages: List[int]) -> None:
    """NaN-fill the floating leaves of ``pages`` in place (fault injection
    only).  int8 payload leaves cannot hold NaN and are left alone: their
    bf16 scale leaves carry the poison through the dequant instead."""
    for _, leaf in tree_leaves(kv):
        if leaf.is_floating_point():
            leaf[:, pages] = float("nan")


@functools.lru_cache(maxsize=None)
def _paged_steps(cfg: ArchConfig, attn_backend: str):
    """(prefill_paged, prefill_paged_cont, decode_paged, verify_paged) step
    functions per (config, backend)."""
    return tuple(make_serve_step(cfg, kind, attn_backend) for kind in (
        "prefill_paged", "prefill_paged_cont", "decode_paged",
        "verify_paged"))


def _synthetic_frontend(cfg: ArchConfig, scfg: ServeConfig, seed: int,
                        rid: int) -> Optional[np.ndarray]:
    """Deterministic per-request frontend input (enc-dec frames [enc_len,
    frontend_dim], vlm image embeddings [n_image_tokens, frontend_dim]):
    standard normals from ``np.random.default_rng([seed, rid])`` rounded to
    bf16 (held in fp32), a fixed shape, so every serving path (any batch
    shape, any engine) sees the same values.  None for text-only archs."""
    if cfg.enc_dec:
        n = scfg.enc_len
    elif cfg.n_image_tokens:
        n = cfg.n_image_tokens
    else:
        return None
    x = np.random.default_rng([seed, rid]).standard_normal(
        (n, cfg.frontend_dim), np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _frontend_batch(cfg: ArchConfig, rows: List[np.ndarray], B: int,
                    device) -> Dict[str, torch.Tensor]:
    """The frontend inputs of a batch, rows past ``len(rows)`` zero, as
    bf16 on ``device`` under the model's key ("frames" or
    "image_embeds")."""
    out = torch.zeros((B,) + rows[0].shape, dtype=torch.bfloat16)
    for i, r in enumerate(rows):
        out[i] = torch.from_numpy(r)
    key = "frames" if cfg.enc_dec else "image_embeds"
    return {key: out.to(device)}


def _pow2_pad(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class Engine:
    """Continuous-batching engine over the paged KV and state-slot
    pools."""

    def __init__(self, cfg: ArchConfig, scfg: Optional[ServeConfig] = None,
                 params=None, *, seed: int = 0, device="cuda",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 faults: Optional[FaultPlan] = None):
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.spec = self.model.cache_spec()
        self.seed = seed
        if params is None:
            params = init_params(cfg, seed, self.device)
        else:
            on = {leaf.device for _, leaf in tree_leaves(params)}
            if on != {self.device}:
                raise ValueError(f"params live on {sorted(map(str, on))}, "
                                 f"the engine runs on {str(self.device)!r}")
        self.params = params
        # telemetry: one registry + one lifecycle tracer shared by every
        # layer (pool, radix cache, scheduler, engine) — all host-side
        # appends, so tracing on changes no math and no emitted token
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.pool = PagedKVPool(cfg, self.scfg, metrics=self.metrics,
                                device=self.device)
        self.states = StateSlotPool(cfg, self.scfg, metrics=self.metrics,
                                    device=self.device) \
            if self.spec.state_slots else None
        if self.scfg.prefix_cache and not self.spec.prefix_cacheable:
            print(f"[engine] WARNING: prefix cache disabled for {cfg.name}: "
                  f"cache family {self.spec.describe()} is not "
                  f"token-addressable/immutable; serving uncached")
            self.radix = None
        else:
            self.radix = RadixCache(self.pool, self.scfg.page_size,
                                    self.scfg.cache_eviction,
                                    metrics=self.metrics) \
                if self.scfg.prefix_cache else None
        self.sched = Scheduler(self.scfg, self.pool, self.radix, self.states,
                               metrics=self.metrics, tracer=self.tracer)
        self._next_rid = 0
        self.attn_backend = resolve_backend(self.scfg.attn_backend,
                                            self.device)
        self._prefill, self._prefill_cont, self._decode, self._verify = \
            _paged_steps(cfg, self.attn_backend)
        # speculative decoding: draft length after the family gate and the
        # weight-free prompt-lookup proposer (replaceable, e.g. by tests)
        self.spec_k = speculation_k(cfg, self.spec, self.scfg)
        self.proposer = NgramProposer(self.spec_k) if self.spec_k else None
        # fault tolerance: optional chaos injector, health lifecycle, and
        # deadline-aware admission control (serving/{faults,admission})
        self.injector = FaultInjector(faults, self.metrics) \
            if faults is not None else None
        self.health = HealthState(self.metrics)
        self.admission = AdmissionController(
            self.scfg.max_slots, metrics=self.metrics, seed=seed) \
            if self.scfg.admission_control else None
        self._m_prefill_steps = self.metrics.counter(
            "engine.prefill_steps", "prefill calls (admissions + chunks)")
        self._m_multi_admit = self.metrics.counter(
            "engine.multi_admit_prefills", "prefill calls admitting >1 req")
        self._m_chunk_steps = self.metrics.counter(
            "engine.chunked_prefill_steps", "continuation-chunk calls")
        self._m_cow = self.metrics.counter(
            "engine.cow_forks", "copy-on-write page forks run")
        self._m_restores = self.metrics.counter(
            "engine.state_restores", "checkpoint-restore re-admissions")
        # prefill work accounting: padded counts what the device computed
        # (pow2 rows x bucket), actual counts real prompt tokens — the gap is
        # padding waste, the thing chunking + bucketing are trading against
        self._m_padded = self.metrics.counter(
            "engine.prefill_padded_tokens", "device-computed prefill tokens")
        self._m_actual = self.metrics.counter(
            "engine.prefill_actual_tokens", "real prompt tokens prefilled")
        self._h_decode_step = self.metrics.histogram(
            "engine.decode_step_s", "fixed-shape decode step wall time")
        # speculative-decoding accounting: drafts proposed vs accepted, plus
        # the per-step acceptance-rate distribution (accepted / proposed for
        # each slot-step with a non-empty draft)
        self._m_spec_proposed = self.metrics.counter(
            "engine.spec_proposed", "draft tokens proposed by the n-gram "
            "speculator")
        self._m_spec_accepted = self.metrics.counter(
            "engine.spec_accepted", "draft tokens accepted by the verify "
            "step (emitted without their own decode launch)")
        self._h_accept = self.metrics.histogram(
            "engine.spec_accept_rate", "per slot-step draft acceptance rate "
            "(accepted / proposed, non-empty drafts only)")
        # decode-stall bookkeeping: wall time decode-ready slots spend parked
        # behind non-decode steps (the head-of-line cost chunking bounds)
        self._h_stall = self.metrics.histogram(
            "engine.decode_stall_s", "time decode-ready slots sat parked "
            "behind non-decode steps, per decode step")
        self._stall_accum = 0.0
        # overlapped-pipeline bookkeeping (pump()): staged next-step plans
        self._staged: Optional[_StagedDecode] = None
        self._m_overlap_staged = self.metrics.counter(
            "engine.overlap_staged", "next-step plans staged while the "
            "device ran the current step")
        self._m_overlap_used = self.metrics.counter(
            "engine.overlap_used", "staged plans whose fingerprint still "
            "matched at dispatch (host work hidden behind device time)")
        self._m_overlap_dropped = self.metrics.counter(
            "engine.overlap_dropped", "staged plans invalidated by a "
            "retirement/EOS/admission/preemption before dispatch")
        # request-lifecycle admission guards
        self._inflight: set = set()   # rids queued, live, or awaiting collect
        self._m_reject_budget = self.metrics.counter(
            "sched.rejections", "admission attempts blocked, by reason",
            labels=("reason",)).labels(reason="no_budget")
        # fault-tolerance accounting: quarantines (NaN logits / step errors),
        # client cancels, deadline evictions, and admission sheds
        self._m_quarantined = self.metrics.counter(
            "engine.quarantined", "requests terminal-failed mid-flight by "
            "the per-step fault guard (nan_logits | step_error)")
        self._m_cancelled = self.metrics.counter(
            "engine.cancelled", "requests cancelled by the client "
            "(disconnects), queued or live")
        self._m_deadline_evict = self.metrics.counter(
            "engine.deadline_evictions", "requests expired by the deadline "
            "sweep (queued or mid-flight)")
        self._m_shed = self.metrics.counter(
            "admission.shed", "Requests shed at admission, by reason.",
            labels=("reason",))
        self.on_token: Optional[Callable[[int, int, int, float], None]] = None

    @property
    def _restores(self) -> int:
        return self._m_restores.value

    def _state(self):
        """The state-slot pool's device tree ({} for the paged families)."""
        return self.states.state if self.states is not None else {}

    # ----------------------------------------------------------- public API

    def add_request(self, prompt: Sequence[int], max_new_tokens: int = 16,
                    rid: Optional[int] = None, *,
                    deadline_s: Optional[float] = None,
                    ttft_deadline_s: Optional[float] = None) -> int:
        """Queue a prompt; returns the request id.

        A request with no token budget under ``max_len`` is rejected
        gracefully: counted under ``sched.rejections{reason=no_budget}`` and
        surfaced from ``collect()`` as a failed ``RequestResult``.  The only
        submission-time exception is a ``rid`` collision with an in-flight
        request.

        ``deadline_s`` / ``ttft_deadline_s`` are relative QoS budgets
        (seconds from now; ``ServeConfig.default_*`` fill absent ones).
        With ``ServeConfig.admission_control`` on, a request whose deadline
        the calibrated queue model cannot meet is shed at the door (failed
        result, ``error="shed: overloaded"``, a jittered ``retry_after_s``),
        and admitted requests that blow their deadline are evicted by the
        sweep before each dispatch.  A draining engine sheds every new
        request with reason ``draining``."""
        if rid is None:
            rid = self._next_rid
        elif rid in self._inflight:
            raise ValueError(f"request id {rid} collides with an in-flight "
                             f"request (queued, live, or awaiting collect)")
        self._next_rid = max(self._next_rid, rid) + 1
        self._inflight.add(rid)
        prompt = [int(t) for t in prompt]
        now = time.perf_counter()
        max_new = min(int(max_new_tokens), self.scfg.max_len - len(prompt))
        if max_new < 1:
            self._m_reject_budget.inc()
            req = Request(rid=rid, prompt=prompt, max_new=0, arrival=now,
                          error=f"no_budget: prompt len {len(prompt)} leaves "
                                f"no token budget under max_len="
                                f"{self.scfg.max_len}")
            req.t_finish = now
            self.sched.finished.append(req)
            self.tracer.on_rejected(rid, now, "no_budget")
            return rid
        if deadline_s is None and self.scfg.default_deadline_s > 0:
            deadline_s = self.scfg.default_deadline_s
        if ttft_deadline_s is None and self.scfg.default_ttft_deadline_s > 0:
            ttft_deadline_s = self.scfg.default_ttft_deadline_s
        if self.health.draining:
            return self._shed(rid, prompt, now, "draining")
        if self.admission is not None:
            reason = self.admission.check(len(self.sched.queue),
                                          deadline_s, ttft_deadline_s)
            if reason is not None:
                return self._shed(rid, prompt, now, reason)
        self.sched.add(Request(
            rid=rid, prompt=prompt, max_new=max_new, arrival=now,
            deadline=now + deadline_s if deadline_s else None,
            ttft_deadline=now + ttft_deadline_s if ttft_deadline_s else None))
        return rid

    def _shed(self, rid: int, prompt: List[int], now: float,
              reason: str) -> int:
        """Refuse a request at the door: failed result, backoff hint, and a
        ``rejected`` tracer terminal — the engine never does work for it."""
        retry = (self.admission.retry_after_s(len(self.sched.queue))
                 if self.admission is not None else 1.0)
        self._m_shed.labels(reason=reason).inc()
        req = Request(rid=rid, prompt=prompt, max_new=0, arrival=now,
                      error=f"shed: {reason}", retry_after_s=retry)
        req.t_finish = now
        self.sched.finished.append(req)
        self.tracer.on_rejected(rid, now, reason)
        return rid

    def cancel(self, rid: int) -> bool:
        """Abort a queued or live request: its slot/pages are released
        immediately and it surfaces from ``collect()`` as a failed result
        carrying whatever tokens it had produced.  Returns False if ``rid``
        is not queued or live."""
        now = time.perf_counter()
        for req in list(self.sched.queue):
            if req.rid == rid:
                self.sched.queue.remove(req)
                self.sched._m_queue.set(len(self.sched.queue))
                req.error = "cancelled"
                req.t_finish = now
                self.sched.finished.append(req)
                self._m_cancelled.inc()
                self.tracer.on_rejected(rid, now, "cancelled")
                return True
        for i, slot in enumerate(self.sched.slots):
            if slot is not None and slot.req.rid == rid:
                self._drop_staged()           # slot set is about to change
                slot.req.error = "cancelled"
                slot.req.t_finish = now
                self.sched.retire(i)
                self._m_cancelled.inc()
                self.tracer.on_finished(rid, now, len(slot.req.generated),
                                        error="cancelled")
                return True
        return False

    def step(self) -> bool:
        """Run one scheduler action (a prefill, a continuation chunk, or a
        decode) synchronously.  False when idle.

        A :class:`RequestFault` raised at the pre-launch seam (an injected
        step error) quarantines only the offending request: the pool was
        not written yet, so the surviving slots simply run on the next
        step, token streams intact."""
        try:
            pending = self._dispatch_next()
        except RequestFault as e:
            self._quarantine_rid(e.rid, e.kind)
            return True
        if pending is None:
            return False
        self._finish_step(pending)
        return True

    def pump(self) -> bool:
        """One *overlapped* step: dispatch the next action, stage the host
        plan of the step after it while the device computes, then collect.
        Token for token identical to ``step()`` (a staged plan is used only
        when it fingerprints equal to a replan); the gain is host time
        hidden behind device time.  False when idle."""
        try:
            pending = self._dispatch_next()
        except RequestFault as e:
            self._quarantine_rid(e.rid, e.kind)
            return True
        if pending is None:
            return False
        self.tracer.host_span("dispatch", pending.t0, pending.t_dispatched,
                              kind=pending.kind)
        t_s0 = time.perf_counter()
        if self._stage_next(pending):
            self.tracer.host_span("stage", t_s0, time.perf_counter())
        self._finish_step(pending, overlap=True)
        return True

    def collect(self) -> List[RequestResult]:
        """Pop every finished request as a RequestResult."""
        out = []
        for req in self.sched.finished:
            rec = self.tracer.requests.get(req.rid)
            latency = (req.t_finish - req.arrival
                       if req.t_finish is not None else 0.0)
            res = RequestResult(
                rid=req.rid, prompt=req.prompt, tokens=list(req.generated),
                latency=latency,
                ttft=(req.t_first - req.arrival
                      if req.t_first is not None else 0.0),
                n_preemptions=req.n_preemptions,
                cached_tokens=req.cached_tokens, error=req.error,
                retry_after_s=req.retry_after_s)
            if rec is not None and rec.t_finish is not None:
                t_first = rec.t_first if rec.t_first is not None \
                    else rec.t_finish
                res.ttft_s = t_first - rec.arrival
                res.finish_s = rec.t_finish - rec.arrival
                res.tpot_s = (rec.t_finish - t_first) \
                    / max(len(req.generated) - 1, 1)
                res.n_prefill_chunks = rec.n_chunks
                res.preempted = rec.n_preemptions > 0
            if self.admission is not None and not res.failed:
                # calibrate the queue model on what actually served
                self.admission.observe_result(res.ttft, res.latency)
            self._inflight.discard(req.rid)
            out.append(res)
        self.sched.finished.clear()
        return out

    def run_offline(self, prompts: Sequence[Sequence[int]],
                    max_new_tokens=16, *,
                    overlap: bool = False) -> Tuple[List[RequestResult], Dict]:
        """Admit every prompt, drive the loop dry, return (results, metrics).

        ``max_new_tokens`` is an int or a per-prompt sequence.  With
        ``overlap=True`` the loop runs the pipelined ``pump()`` instead of
        the synchronous ``step()`` (same tokens, host work hidden behind
        device time)."""
        budgets = ([max_new_tokens] * len(prompts)
                   if isinstance(max_new_tokens, int) else list(max_new_tokens))
        # a reused engine must not leak the previous run's trailing stall
        # time (or a stale staged plan) into this run's accounting
        self._stall_accum = 0.0
        self._staged = None
        self.health.mark_healthy()
        t0 = time.perf_counter()
        for p, m in zip(prompts, budgets):
            self.add_request(p, m)
        drive = self.pump if overlap else self.step
        while drive():
            pass
        wall = time.perf_counter() - t0
        results = sorted(self.collect(), key=lambda r: r.rid)
        ok = [r for r in results if not r.failed]
        metrics = shared_metrics(
            len(results), sum(len(r.tokens) for r in results),
            [r.latency for r in ok], wall,
            ttfts=[r.ttft for r in ok],
            prompt_tokens=sum(len(r.prompt) for r in results),
            cached_tokens=sum(r.cached_tokens for r in results),
            prefill_steps=self._m_prefill_steps.value,
            prefill_padded_tokens=self._m_padded.value,
            prefill_actual_tokens=self._m_actual.value,
            decode_step_s=self._h_decode_step.values,
            decode_stall_s=self._h_stall.values)
        metrics["rejected_requests"] = len(results) - len(ok)
        metrics["multi_admit_prefills"] = self._m_multi_admit.value
        metrics["chunked_prefill_steps"] = self._m_chunk_steps.value
        metrics["state_restores"] = self._m_restores.value
        metrics["attn_backend"] = self.attn_backend
        if self.spec_k:
            metrics["spec_tokens"] = self.spec_k
            metrics["spec_proposed"] = self._m_spec_proposed.value
            metrics["spec_accepted"] = self._m_spec_accepted.value
            metrics["spec_accept_rate"] = (
                self._m_spec_accepted.value
                / max(self._m_spec_proposed.value, 1))
        metrics["device"] = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else "cpu")
        if self.radix is not None:
            metrics["cache_pages"] = len(self.radix.cached_pages)
            metrics["cache_evictions"] = self.radix.evictions
        return results, metrics

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Full registry snapshot (counters/gauges/histograms of every
        serving layer) — the ``--metrics-json`` payload."""
        return self.metrics.snapshot()

    # --------------------------------------------------- dispatch / collect

    def _drop_staged(self) -> None:
        if self._staged is not None:
            self._m_overlap_dropped.inc()
            self._staged = None

    def _dispatch_next(self) -> Optional[_Pending]:
        """Scheduler decision + host-side meta build + step launch.  On a
        CUDA device the launch returns before the kernels finish.  ``None``
        on drain (trailing stall time is flushed there)."""
        if self.injector is not None:
            self.injector.on_tick(self)
        if self.admission is not None:
            self._evict_deadlines()
        try:
            action = self.sched.next_action()
        except RuntimeError:
            # injected pool pressure can manufacture a scheduler deadlock the
            # real pool would never see; give the hostage pages back and
            # retry once before treating it as genuine exhaustion
            if self.injector is None \
                    or not self.injector.release_pressure(self):
                raise
            action = self.sched.next_action()
        if action is None:
            self._drop_staged()
            if self.injector is not None:
                self.injector.on_drain(self)
            if self._stall_accum:
                self._h_stall.observe(self._stall_accum)
                self._stall_accum = 0.0
            return None
        waiting = bool(self.sched.decode_ready())
        kind, payload = action
        if kind != "decode":
            self._drop_staged()
        t0 = time.perf_counter()
        if kind == "prefill":
            rows, out = self._launch_prefill(payload, t0)
        elif kind == "prefill_chunk":
            rows, out = self._launch_chunks(payload)
        elif kind == "restore":
            self._run_restore(payload, t0)
            rows, out = None, None
        elif kind == "decode" and self.spec_k:
            # speculation on: every decode-ready step runs as a small-q
            # verify step (with an empty draft it degenerates to decode)
            kind = "verify"
            if self.injector is not None:
                self.injector.before_launch(self, "verify", payload)
            rows, out = payload, self._launch_verify(payload)
        else:
            if self.injector is not None:
                self.injector.before_launch(self, "decode", payload)
            rows, out = payload, self._launch_decode(payload)
        return _Pending(kind=kind, payload=payload, rows=rows, out_dev=out,
                        t0=t0, t_dispatched=time.perf_counter(),
                        waiting=waiting)

    def _finish_step(self, pending: _Pending, overlap: bool = False) -> None:
        """Block on the pending step's device output and run the host-side
        bookkeeping: token appends, retirement, step span, stall account."""
        t_c0 = time.perf_counter()
        if pending.kind == "decode":
            self._collect_decode(pending)
        elif pending.kind == "verify":
            self._collect_verify(pending)
        elif pending.kind in ("prefill", "prefill_chunk"):
            self._collect_prefill(pending)
        t1 = time.perf_counter()
        n_rows = 1 if pending.kind == "restore" else len(pending.payload)
        self.tracer.step_span(pending.kind, pending.t0, t1, rows=n_rows,
                              decode_waiting=pending.waiting)
        if overlap:
            self.tracer.host_span("collect", t_c0, t1, kind=pending.kind)
        if pending.kind in ("decode", "verify"):
            # verify steps *serve* decode-ready slots: both flush the stall
            self._h_stall.observe(self._stall_accum)
            self._stall_accum = 0.0
        elif pending.waiting:
            # decode-ready slots sat out this step: head-of-line stall
            self._stall_accum += t1 - pending.t0

    # ---------------------------------------------- quarantine / deadlines

    def poison_slot(self, slot_idx: int) -> None:
        """Fault injection: NaN-fill the floating leaves of the slot's most
        recent exclusively-owned page (or its state-slot row), in place.
        At the decode seam the newest page always holds positions past
        every sharer's prompt, and a state row belongs to its decode row
        alone, so only the target row ever reads it — the poison is
        strictly per-request, which is what makes the exact-survivor
        contract testable."""
        slot = self.sched.slots[slot_idx]
        assert slot is not None
        if self.pool.spec.paged and slot.pages:
            page = next((p for p in reversed(slot.pages)
                         if self.pool.ref(p) == 1), None)
            assert page is not None, \
                f"slot {slot_idx} owns no exclusive page to poison"
            _poison_pages(self.pool.kv, [page])
        elif self.states is not None:
            self.states.poison(slot_idx)

    def _scrub_slot(self, slot_idx: int) -> None:
        """Zero a quarantined slot's exclusively-owned pages (and state row)
        before they return to the free list: masked attention is a
        zero-*weight* multiply, so a NaN in a recycled page would poison
        every later request whose table points at it.  Shared (radix)
        pages are co-owned and left alone."""
        slot = self.sched.slots[slot_idx]
        excl = [p for p in slot.pages if self.pool.ref(p) == 1]
        if excl:
            _zero_pages(self.pool.kv, excl)
            self.pool.note_scrubbed(len(excl))
        if self.states is not None:
            self.states.scrub(slot_idx)

    def _quarantine_slot(self, slot_idx: int, reason: str,
                         now: float) -> None:
        """Terminal-fail one live request without touching its batchmates:
        scrub the pages it exclusively owns, release everything through the
        normal retire path, and emit the failure terminal."""
        req = self.sched.slots[slot_idx].req
        self._drop_staged()
        self._scrub_slot(slot_idx)
        req.error = reason
        req.t_finish = now
        self.sched.retire(slot_idx)
        self._m_quarantined.inc()
        self.tracer.on_finished(req.rid, now, len(req.generated),
                                error=reason)

    def _quarantine_rid(self, rid: int, reason: str) -> None:
        """Quarantine by request id (the step-error path: the fault names a
        rid, not a slot).  No-op if the rid is no longer live."""
        now = time.perf_counter()
        for i, slot in enumerate(self.sched.slots):
            if slot is not None and slot.req.rid == rid:
                self._quarantine_slot(i, reason, now)
                return

    def _evict_deadlines(self) -> None:
        """Expire queued and mid-flight requests whose deadline passed.
        Mid-flight eviction frees the slot immediately — finishing a request
        its client already gave up on is negative goodput."""
        now = time.perf_counter()
        expired_q, expired_live = self.sched.sweep_deadlines(now)
        for req in expired_q:
            req.error = "deadline_exceeded"
            req.t_finish = now
            self.sched.finished.append(req)
            self._m_deadline_evict.inc()
            self.tracer.on_rejected(req.rid, now, "deadline_exceeded")
        for i in expired_live:
            self._drop_staged()
            req = self.sched.slots[i].req
            req.error = "deadline_exceeded"
            req.t_finish = now
            self.sched.retire(i)
            self._m_deadline_evict.inc()
            self.tracer.on_finished(req.rid, now, len(req.generated),
                                    error="deadline_exceeded")

    def _stage_next(self, pending: _Pending) -> bool:
        """While the dispatched step runs on the device, build the plan of
        the *next* decode step and queue its upload.  Staged only when the
        next action is deterministically the same decode batch one position
        further: the pending step is a decode, nothing is queued, no slot is
        mid-prefill, no slot retires on budget at this step's collect (an
        EOS retirement is caught by the dispatch fingerprint instead), and
        no slot crosses a page boundary at its next position.  Nothing here
        waits for the stream.  True when a plan was staged."""
        if pending.kind != "decode" or self.sched.queue \
                or self.sched.prefilling_slots():
            return False
        active = list(pending.rows)
        ps = self.scfg.page_size
        cap = self.pool.table_width
        for i in active:
            slot = self.sched.slots[i]
            if len(slot.req.generated) + 1 >= slot.req.max_new:
                return False          # retires when this step collects
            p1 = slot.pos + 1
            if self.pool.spec.paged and len(slot.pages) < cap \
                    and p1 % ps == 0 and p1 // ps >= len(slot.pages):
                return False          # next decode needs page growth
        self._staged = _StagedDecode(
            active=tuple(active),
            fp=tuple((i, self.sched.slots[i].req.rid,
                      self.sched.slots[i].pos + 1,
                      len(self.sched.slots[i].pages), 0) for i in active),
            meta=self._decode_plan(active, pos_offset=1, non_blocking=True))
        self._m_overlap_staged.inc()
        return True

    # -------------------------------------------------------------- prefill

    def _extras(self, rids: List[int], B: int) -> Dict[str, torch.Tensor]:
        """Frontend inputs of a padded prefill batch on the engine's device
        ({} for text-only archs)."""
        if not (self.cfg.enc_dec or self.cfg.n_image_tokens):
            return {}
        return _frontend_batch(
            self.cfg, [_synthetic_frontend(self.cfg, self.scfg, self.seed, r)
                       for r in rids], B, self.device)

    def _prefill_launch(self, rows: List[Tuple[int, Any, int, int]],
                        continuation: bool = False):
        """Launch one batched chunk-prefill call.  ``rows`` holds
        (slot_idx, req, n_done, n_chunk): each row prefills prompt tokens
        [n_done, n_done + n_chunk) into its bound pages.  The batch is padded
        to a pow2 row count and the tokens to a bucket, so the set of step
        shapes stays bounded.  ``continuation`` marks a batch of chunks
        after the first: no frontend inputs (a vlm never chunks; enc-dec
        reads its pinned cross K/V instead of encoding again).  Returns the
        per-row last-real-token logits, still on the device."""
        bucket = self.scfg.bucket_of(max(c for _, _, _, c in rows))
        B = _pow2_pad(len(rows), self.scfg.max_slots)
        toks = np.zeros((B, bucket), np.int32)
        start = np.zeros((B,), np.int32)
        n_tail = np.zeros((B,), np.int32)
        tables = np.full((B, max(self.pool.table_width, 1)), NULL_PAGE,
                         np.int32)
        slots = np.full((B,), self.scfg.max_slots, np.int32)  # pad rows
        for i, (slot_idx, req, n_done, n_chunk) in enumerate(rows):
            toks[i, :n_chunk] = req.prompt[n_done:n_done + n_chunk]
            start[i] = n_done
            n_tail[i] = n_chunk
            tables[i] = self.sched.slots[slot_idx].table
            slots[i] = slot_idx
        # token-addressable families attend only the pages the batch
        # actually reaches: truncate the table view to a pow2 page count
        # (bounded shape set) instead of always paying a max_len-wide
        # gather.  A ring keeps its full width: the ring modulus is the
        # table width (attn_backend.decode_meta)
        ps = self.scfg.page_size
        width = tables.shape[1]
        if not self.cfg.sliding_window:
            need = -(-(int((start + n_tail).max())
                       + self.pool.spec.prefix_tokens) // ps)
            W = 1
            while W < need:
                W *= 2
            width = max(min(W, tables.shape[1]), 1)
        meta = meta_to_device(prefill_meta(
            self.cfg, ps, tables[:, :width], slots, start, n_tail, bucket),
            self.device)
        tokens = torch.as_tensor(toks, device=self.device)
        extras = {} if continuation \
            else self._extras([req.rid for _, req, _, _ in rows], B)
        step = self._prefill_cont if continuation and self.cfg.enc_dec \
            else self._prefill
        with self.tracer.annotate("prefill_step"):
            logits, self.pool.kv, _ = step(
                self.params, self.pool.kv, self._state(), meta, tokens,
                extras)
        self._m_padded.inc(B * bucket)
        self._m_actual.inc(sum(c for _, _, _, c in rows))
        return logits

    def _after_chunk(self, slot_idx: int, req, n_done: int, n_chunk: int,
                     logits_row: np.ndarray, now: float,
                     pages: List[int]) -> None:
        """Advance a slot's prefill cursor past one chunk: publish the newly
        completed full prompt pages, and on the final chunk take the first
        token from this call's logits."""
        slot = self.sched.slots[slot_idx]
        slot.n_filled = n_done + n_chunk
        if self.radix is not None:
            ps = self.scfg.page_size
            full = min(slot.n_filled, len(req.prompt)) // ps
            if full:
                self.radix.insert(req.prompt[:full * ps], pages[:full])
        if slot.n_filled >= len(req.prompt):
            if req.t_first is None:       # replay keeps the original TTFT
                req.t_first = now
            self.tracer.on_first_token(req.rid, now)
            tok = int(logits_row.argmax())
            req.generated.append(tok)
            self._emit_token(req.rid, len(req.generated) - 1, tok, now)
            self._maybe_retire(slot_idx, now)

    def _launch_prefill(self, adms: List[Admission], t0: float):
        """Launch a batch of already-accounted admissions: fork COW pages if
        a cache match ended mid-page, then prefill each request's first
        chunk in one call."""
        for adm in adms:
            self.tracer.on_admitted(adm.req.rid, t0,
                                    cached_tokens=adm.n_matched)
            if adm.cow_dst is not None:
                _copy_page(self.pool.kv, adm.cow_src, adm.cow_dst)
                self._m_cow.inc()
        rows = [(adm.slot_idx, adm.req, adm.n_matched, adm.n_chunk)
                for adm in adms]
        out = self._prefill_launch(rows)
        self._m_prefill_steps.inc()
        if len(adms) > 1:
            self._m_multi_admit.inc()
        return rows, out

    def _launch_chunks(self, slot_idxs: List[int]):
        """Launch a batch of continuation chunks for mid-prefill slots."""
        rows = []
        for i in slot_idxs:
            slot = self.sched.slots[i]
            n_done = slot.n_filled
            n_chunk = self.sched._chunk_len(n_done, len(slot.req.prompt))
            rows.append((i, slot.req, n_done, n_chunk))
        out = self._prefill_launch(rows, continuation=True)
        self._m_prefill_steps.inc()
        self._m_chunk_steps.inc()
        return rows, out

    def _collect_prefill(self, pending: _Pending) -> None:
        """Collect half of a prefill/chunk step: copy the logits to the host
        (waits for the device), then advance every row's cursor."""
        logits = pending.out_dev.float().cpu().numpy()
        now = time.perf_counter()
        for r, (slot_idx, req, n_done, n_chunk) in enumerate(pending.rows):
            slot = self.sched.slots[slot_idx]
            if slot is None or slot.req is not req:
                continue              # cancelled under our feet
            self.tracer.on_chunk(req.rid, pending.t0, now,
                                 n_done=n_done, n_chunk=n_chunk)
            if not np.isfinite(logits[r]).all():
                # checked before _after_chunk so a poisoned prompt never
                # publishes its pages to the radix cache
                self._quarantine_slot(slot_idx, "nan_logits", now)
                continue
            pages = (pending.payload[r].pages if pending.kind == "prefill"
                     else slot.pages)
            self._after_chunk(slot_idx, req, n_done, n_chunk, logits[r],
                              now, pages)

    def _run_restore(self, adm: Admission, t0: float) -> None:
        """Re-admit a checkpointed (preempted) request: write its state
        snapshot back, in place, into the claimed slot and resume decoding
        where it left off — no prompt replay (the scheduler already bound
        the slot at the checkpointed position)."""
        self.tracer.on_admitted(adm.req.rid, t0, kind="restore")
        _, saved = adm.restore
        self.states.restore(adm.slot_idx, saved)
        self._m_restores.inc()
        self.tracer.on_restored(adm.req.rid, time.perf_counter())

    # --------------------------------------------------------------- decode

    def _decode_plan(self, active: List[int], pos_offset: int = 0,
                     non_blocking: bool = False) -> Dict[str, torch.Tensor]:
        """Flat per-step decode metadata, derived once on the host.
        ``pos_offset=1`` builds the *next* step's plan while this step's
        collect has not advanced the cursors yet (staging), and
        ``non_blocking`` queues its upload without waiting for the
        stream."""
        B = self.scfg.max_slots
        pos = np.zeros((B,), np.int32)
        tables = np.full((B, max(self.pool.table_width, 1)), NULL_PAGE,
                         np.int32)
        for i in active:
            slot = self.sched.slots[i]
            pos[i] = slot.pos + pos_offset
            tables[i] = slot.table
        return meta_to_device(
            decode_meta(self.cfg, self.scfg.page_size, tables, pos),
            self.device, non_blocking=non_blocking)

    def _launch_decode(self, active: List[int]):
        """Launch one fixed-shape decode step, reusing a staged plan when
        its fingerprint still matches reality (a used plan is bit-identical
        to a replan — same positions, tables, pages — so tokens are exact).
        Returns (device next-token tensor, device finite flags, launch time)
        without waiting."""
        tokens = np.zeros((self.scfg.max_slots,), np.int32)
        for i in active:
            tokens[i] = self.sched.slots[i].req.generated[-1]
        meta = None
        if self._staged is not None:
            st, self._staged = self._staged, None
            fp = tuple(
                (i, self.sched.slots[i].req.rid, self.sched.slots[i].pos,
                 len(self.sched.slots[i].pages), 0) for i in active)
            if tuple(active) == st.active and fp == st.fp:
                meta = st.meta
                self._m_overlap_used.inc()
            else:
                self._m_overlap_dropped.inc()
        if meta is None:
            meta = self._decode_plan(active)
        t_launch = time.perf_counter()
        with self.tracer.annotate("decode_step"):
            nxt, ok, self.pool.kv, _ = self._decode(
                self.params, self.pool.kv, self._state(), meta,
                torch.as_tensor(tokens, device=self.device))
        return nxt, ok, t_launch

    def _collect_decode(self, pending: _Pending) -> None:
        """Collect half of a decode step: copy the tokens to the host (waits
        for the device), then advance cursors, fire streaming hooks and
        retire finished slots.  A row whose finite flag came back False is
        quarantined instead of emitting its garbage argmax."""
        nxt_dev, ok_dev, t_launch = pending.out_dev
        nxt = nxt_dev.cpu().numpy()
        ok = ok_dev.cpu().numpy()
        now = time.perf_counter()
        self._h_decode_step.observe(now - t_launch)
        if self.admission is not None:
            self.admission.observe_step(now - t_launch)
        for i in pending.rows:
            slot = self.sched.slots[i]
            if slot is None:
                continue              # quarantined earlier in this collect
            if not ok[i]:
                self._quarantine_slot(i, "nan_logits", now)
                continue
            slot.pos += 1
            tok = int(nxt[i])
            slot.req.generated.append(tok)
            self._emit_token(slot.req.rid, len(slot.req.generated) - 1,
                             tok, now)
            self._maybe_retire(i, now)

    # ------------------------------------------------------------- speculate

    def _verify_plan(self, active: List[int],
                     drafts: Dict[int, List[int]]) -> Dict[str, torch.Tensor]:
        """Fixed-shape verify-step metadata: like ``_decode_plan`` but with
        per-row live query counts (1 + draft length) and per-query write
        targets for all Q = spec_k + 1 positions.  Idle rows keep pos=0,
        n_q=1 and a NULL_PAGE table, so their single query writes to the
        reserved sink page exactly as an idle decode row does."""
        B = self.scfg.max_slots
        pos = np.zeros((B,), np.int32)
        n_q = np.ones((B,), np.int32)
        tables = np.full((B, max(self.pool.table_width, 1)), NULL_PAGE,
                         np.int32)
        for i in active:
            slot = self.sched.slots[i]
            pos[i] = slot.pos
            n_q[i] = 1 + len(drafts[i])
            tables[i] = slot.table
        return meta_to_device(
            verify_meta(self.cfg, self.scfg.page_size, tables, pos, n_q,
                        self.spec_k + 1), self.device)

    def _launch_verify(self, active: List[int]):
        """Launch one fixed-shape speculative verify step: draft up to
        ``spec_k`` tokens per row from the request's own history (prompt +
        generation), then run draft + carried token through the small-q
        verify step in one device call.  Rows whose proposer finds nothing
        run with an empty draft — the step degenerates to a decode step for
        them.  Drafts are clamped so the furthest K/V write (pos + draft
        len) stays inside both the token budget and the page horizon.
        Returns (device [B, Q] next tokens, device finite flags, launch
        time, drafts) without waiting."""
        tokens = np.zeros((self.scfg.max_slots, self.spec_k + 1), np.int32)
        drafts: Dict[int, List[int]] = {}
        prefix = self.pool.spec.prefix_tokens
        for i in active:
            req = self.sched.slots[i].req
            # a draft token beyond the remaining budget could never be
            # emitted (the bonus token fills the last budget slot), and its
            # K/V write must stay under the max_len page horizon
            kmax = min(self.spec_k,
                       req.max_new - len(req.generated) - 1,
                       prefix + self.scfg.max_len - 1
                       - self.sched.slots[i].pos)
            draft = self.proposer.propose(
                req.prompt + req.generated)[:max(kmax, 0)]
            drafts[i] = draft
            tokens[i, 0] = req.generated[-1]
            tokens[i, 1:1 + len(draft)] = draft
            if draft:
                self._m_spec_proposed.inc(len(draft))
        meta = self._verify_plan(active, drafts)
        t_launch = time.perf_counter()
        with self.tracer.annotate("verify_step"):
            nxt, ok, self.pool.kv, _ = self._verify(
                self.params, self.pool.kv, self._state(), meta,
                torch.as_tensor(tokens, device=self.device))
        return nxt, ok, t_launch, drafts

    def _collect_verify(self, pending: _Pending) -> None:
        """Collect half of a verify step: copy the [B, Q] greedy tokens to
        the host (waits for the device), accept each row's longest draft
        prefix the argmax reproduced, and emit accepted + bonus tokens — the
        stream a sequence of one-token decode steps would have produced.
        EOS or budget reached mid-emit stops the emission there.  A rejected
        draft's K/V stays in its page past the new position, masked from
        every later query until the next step's write overwrites it."""
        nxt_dev, ok_dev, t_launch, drafts = pending.out_dev
        nxt = nxt_dev.cpu().numpy()
        ok = ok_dev.cpu().numpy()
        now = time.perf_counter()
        self._h_decode_step.observe(now - t_launch)
        if self.admission is not None:
            self.admission.observe_step(now - t_launch)
        for i in pending.rows:
            slot = self.sched.slots[i]
            if slot is None:
                continue              # quarantined earlier in this collect
            if not ok[i]:
                self._quarantine_slot(i, "nan_logits", now)
                continue
            req = slot.req
            draft = drafts[i]
            a = accept_length(draft, nxt[i, :len(draft)]) if draft else 0
            if draft:
                self._m_spec_accepted.inc(a)
                self._h_accept.observe(a / len(draft))
            for j in range(a + 1):
                tok = int(nxt[i, j])
                slot.pos += 1
                req.generated.append(tok)
                self._emit_token(req.rid, len(req.generated) - 1, tok, now)
                self._maybe_retire(i, now)
                if self.sched.slots[i] is not slot:
                    break             # EOS or budget: the rest is dropped

    def _emit_token(self, rid: int, index: int, tok: int, now: float) -> None:
        """Fire the streaming hook and the injector's token seam (the
        client-disconnect fault watches the stream, not the scheduler)."""
        if self.on_token is not None:
            self.on_token(rid, index, tok, now)
        if self.injector is not None:
            self.injector.on_token(rid, index)

    def _maybe_retire(self, slot_idx: int, now: float) -> None:
        req = self.sched.slots[slot_idx].req
        done = len(req.generated) >= req.max_new
        if self.scfg.eos_id >= 0 and req.generated[-1] == self.scfg.eos_id:
            done = True
        if done:
            req.t_finish = now
            self.sched.retire(slot_idx)
            self.tracer.on_finished(req.rid, now, len(req.generated))


# ---------------------------------------------------------- static baseline

@functools.lru_cache(maxsize=None)
def _static_steps(cfg: ArchConfig):
    """(prefill_at, decode) step functions per config."""
    return (make_serve_step(cfg, "prefill_at"),
            make_serve_step(cfg, "decode"))


def generate_static(cfg: ArchConfig, params, prompts: Sequence[Sequence[int]],
                    max_new_tokens=16, scfg: Optional[ServeConfig] = None,
                    *, batch_size: int = 1, eos_id: Optional[int] = None,
                    seed: int = 0) -> Tuple[List[List[int]], Dict]:
    """Static-batching reference on the device the params live on:
    contiguous KV caches (a ring of ``min(window, max_len)`` entries for
    sliding-window families; conv taps and recurrent state, and the
    hybrid's local-attention ring, for the state-slot families),
    arrival-order batches padded to a shared bucket (windowed and
    state-slot families: to the batch max), each batch decoded until its
    slowest request is done.  ``batch_size=1`` is the exact single-request
    greedy baseline the engine's output is verified against.  ``eos_id``
    defaults to ``scfg.eos_id``.  Enc-dec and vlm archs get the frontend
    inputs ``_synthetic_frontend`` draws from (``seed``, request index):
    those an engine of that seed draws for the same request ids."""
    scfg = scfg or ServeConfig()
    eos = scfg.eos_id if eos_id is None else eos_id
    budgets = ([max_new_tokens] * len(prompts)
               if isinstance(max_new_tokens, int) else list(max_new_tokens))
    prefill, decode = _static_steps(cfg)
    device = params["embed"]["tok"].device
    n_img = cfg.n_image_tokens

    all_tokens: List[Optional[List[int]]] = [None] * len(prompts)
    latencies: List[float] = [0.0] * len(prompts)
    ttfts: List[float] = [0.0] * len(prompts)
    decode_step_s: List[float] = []
    prefill_padded = prefill_actual = 0
    t0 = time.perf_counter()
    for lo in range(0, len(prompts), batch_size):
        idxs = list(range(lo, min(lo + batch_size, len(prompts))))
        B = len(idxs)
        lens = [len(prompts[i]) for i in idxs]
        budget = [min(budgets[i], scfg.max_len - len(prompts[i])) for i in idxs]
        # recurrent state absorbs pad tokens and the sliding-window ring is
        # filled from the final prompt positions: both need the prompt end
        # to be the sequence end, so those families pad to the batch max
        # instead of a bucket (exact at batch_size=1 or equal lengths)
        bucket = (max(lens)
                  if cfg.family in ("ssm", "hybrid") or cfg.sliding_window
                  else scfg.bucket_of(max(lens)))
        toks = np.zeros((B, bucket), np.int32)
        for r, i in enumerate(idxs):
            toks[r, :lens[r]] = prompts[i]
        batch = {"tokens": torch.as_tensor(toks, device=device)}
        if cfg.enc_dec or n_img:
            batch.update(_frontend_batch(
                cfg, [_synthetic_frontend(cfg, scfg, seed, i) for i in idxs],
                B, device))
        # a vlm's hidden sequence is its image prefix, then the text
        last_idx = torch.as_tensor([n_img + n - 1 for n in lens],
                                   device=device)
        logits, cache = prefill(params, batch, last_idx)
        # grow the contiguous cache to max_len (only a sequence or ring
        # axis is shorter than the fresh cache's)
        cache.pop("pos")
        fresh = init_cache(cfg, B, n_img + scfg.max_len, device,
                           **({"enc_len": scfg.enc_len} if cfg.enc_dec
                              else {}))
        tree_map(lambda f, c: f[tuple(slice(0, n) for n in c.shape)]
                 .copy_(c), fresh, cache)
        cache = {**fresh, "pos": torch.as_tensor(
            [n_img + n for n in lens], dtype=torch.int32, device=device)}
        cur = logits.argmax(-1).to(torch.int32)
        gen = [cur.cpu().numpy()]
        t_first = time.perf_counter() - t0       # batch's first tokens exist
        prefill_padded += B * bucket
        prefill_actual += sum(lens)
        # the whole batch decodes until its slowest member is done
        for _ in range(max(budget) - 1):
            t_step = time.perf_counter()
            cur, cache = decode(params, cache, cur)
            gen.append(cur.cpu().numpy())        # waits for the step
            decode_step_s.append(time.perf_counter() - t_step)
        t_batch = time.perf_counter() - t0
        stacked = np.stack(gen, axis=1)               # [B, max(budget)]
        for r, i in enumerate(idxs):
            row = stacked[r, :budget[r]].tolist()
            if eos >= 0 and eos in row:
                row = row[:row.index(eos) + 1]
            all_tokens[i] = row
            latencies[i] = t_batch
            ttfts[i] = t_first
    wall = time.perf_counter() - t0
    return all_tokens, shared_metrics(
        len(prompts), sum(len(t) for t in all_tokens), latencies, wall,
        ttfts=ttfts, prompt_tokens=sum(len(p) for p in prompts),
        prefill_steps=-(-len(prompts) // batch_size),
        prefill_padded_tokens=prefill_padded,
        prefill_actual_tokens=prefill_actual,
        decode_step_s=decode_step_s)
