"""Synchronous continuous-batching inference engine (dense families).

``Engine`` exposes the classic three-call serving API:

    eng = Engine(cfg, scfg, device="cuda")   # random params from ``seed``
    eng.add_request([1, 2, 3], max_new_tokens=16)
    while eng.step():                        # one prefill OR one decode step
        pass
    results = eng.collect()                  # finished RequestResults

plus ``run_offline(prompts)``, the batch driver used by ``launch/serve.py``.
It is the port of ``repro.serving.engine`` for the paged-KV families the
port builds: prefill writes straight into the paged pool (``prefill_paged``)
— the whole prompt, or with the radix prefix cache only its uncached tail —
at a bucketed length, several same-bucket queued requests admitted in one
batched call; with ``ServeConfig.prefill_chunk_tokens > 0`` long prompts
prefill in page-aligned chunks that interleave with decode steps (see
``scheduler``), publishing completed pages to the radix cache after every
chunk.  Decode runs one fixed-shape ``[max_slots]`` step.  The paged attends
route through the backend registry (``ServeConfig.attn_backend``:
``auto|reference|hopper``, see ``models.attn_backend``), and each step gets
flat host-built metadata (``decode_meta`` / ``prefill_meta``) — page-table
rows, positions, physical write targets — derived once per step.

The pool lives on the engine's device and the model steps write it in
place (the JAX engine donated its buffers to jitted steps instead); the COW
page fork and the quarantine scrub are in-place copies too.  The engine
runs on ``cuda`` unless constructed with ``device="cpu"``.

Not in this slice, each raising ``NotImplementedError`` naming its ROADMAP
queue 1 item: the overlapped ``pump()`` pipeline, fault injection and
deadline-aware admission control (item 9), speculative decoding (item 7)
and int8 pages (item 8).

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
                                   resolve_backend)
from ..models.params import tree_leaves
from ..models.registry import build_model, init_cache, init_params
from ..models.steps import make_serve_step
from .admission import HealthState
from .kv_pool import NULL_PAGE, PagedKVPool
from .radix_cache import RadixCache
from .scheduler import Admission, Request, Scheduler
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
    error: str = ""                   # nonempty: rejected/cancelled/
                                      # quarantined; tokens hold whatever the
                                      # request produced before the terminal

    @property
    def failed(self) -> bool:
        return bool(self.error)


@dataclasses.dataclass
class _Pending:
    """One launched-but-not-collected engine step: on a CUDA device the
    kernels may still be running; ``_finish_step`` blocks on ``out_dev``
    and runs the host-side bookkeeping."""
    kind: str       # prefill | prefill_chunk | decode
    payload: Any                      # scheduler action payload
    rows: Any                         # prefill row tuples / decode active list
    out_dev: Any                      # device logits / next-token tensors
    t0: float                         # dispatch start (step span start)
    waiting: bool                     # decode-ready slots parked behind this


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


@functools.lru_cache(maxsize=None)
def _paged_steps(cfg: ArchConfig, attn_backend: str):
    """(prefill_paged, decode_paged) step functions per (config, backend)."""
    return (make_serve_step(cfg, "prefill_paged", attn_backend),
            make_serve_step(cfg, "decode_paged", attn_backend))


def _pow2_pad(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue 1 item {item}")


class Engine:
    """Continuous-batching engine over the paged KV pool."""

    def __init__(self, cfg: ArchConfig, scfg: Optional[ServeConfig] = None,
                 params=None, *, seed: int = 0, device="cuda",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 faults=None):
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        if faults is not None:
            raise _not_in_slice("fault injection (--inject)", "9")
        if self.scfg.admission_control or self.scfg.default_deadline_s \
                or self.scfg.default_ttft_deadline_s:
            raise _not_in_slice("deadline-aware admission control", "9")
        if self.scfg.speculate_tokens:
            raise _not_in_slice("speculative decoding", "7")
        if self.scfg.kv_dtype != "bf16":
            raise _not_in_slice(f"kv_dtype={self.scfg.kv_dtype!r}", "8")
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
        self.radix = RadixCache(self.pool, self.scfg.page_size,
                                self.scfg.cache_eviction,
                                metrics=self.metrics) \
            if self.scfg.prefix_cache else None
        self.sched = Scheduler(self.scfg, self.pool, self.radix, None,
                               metrics=self.metrics, tracer=self.tracer)
        self._next_rid = 0
        self.attn_backend = resolve_backend(self.scfg.attn_backend,
                                            self.device)
        self._prefill, self._decode = _paged_steps(cfg, self.attn_backend)
        self.health = HealthState(self.metrics)
        self._m_prefill_steps = self.metrics.counter(
            "engine.prefill_steps", "prefill calls (admissions + chunks)")
        self._m_multi_admit = self.metrics.counter(
            "engine.multi_admit_prefills", "prefill calls admitting >1 req")
        self._m_chunk_steps = self.metrics.counter(
            "engine.chunked_prefill_steps", "continuation-chunk calls")
        self._m_cow = self.metrics.counter(
            "engine.cow_forks", "copy-on-write page forks run")
        # prefill work accounting: padded counts what the device computed
        # (pow2 rows x bucket), actual counts real prompt tokens — the gap is
        # padding waste, the thing chunking + bucketing are trading against
        self._m_padded = self.metrics.counter(
            "engine.prefill_padded_tokens", "device-computed prefill tokens")
        self._m_actual = self.metrics.counter(
            "engine.prefill_actual_tokens", "real prompt tokens prefilled")
        self._h_decode_step = self.metrics.histogram(
            "engine.decode_step_s", "fixed-shape decode step wall time")
        # decode-stall bookkeeping: wall time decode-ready slots spend parked
        # behind non-decode steps (the head-of-line cost chunking bounds)
        self._h_stall = self.metrics.histogram(
            "engine.decode_stall_s", "time decode-ready slots sat parked "
            "behind non-decode steps, per decode step")
        self._stall_accum = 0.0
        # request-lifecycle admission guards
        self._inflight: set = set()   # rids queued, live, or awaiting collect
        self._m_reject_budget = self.metrics.counter(
            "sched.rejections", "admission attempts blocked, by reason",
            labels=("reason",)).labels(reason="no_budget")
        self._m_quarantined = self.metrics.counter(
            "engine.quarantined", "requests terminal-failed mid-flight by "
            "the per-step finite-logits guard")
        self._m_cancelled = self.metrics.counter(
            "engine.cancelled", "requests cancelled by the client "
            "(disconnects), queued or live")
        self.on_token: Optional[Callable[[int, int, int, float], None]] = None

    # ----------------------------------------------------------- public API

    def add_request(self, prompt: Sequence[int], max_new_tokens: int = 16,
                    rid: Optional[int] = None) -> int:
        """Queue a prompt; returns the request id.

        A request with no token budget under ``max_len`` is rejected
        gracefully: counted under ``sched.rejections{reason=no_budget}`` and
        surfaced from ``collect()`` as a failed ``RequestResult``.  The only
        submission-time exception is a ``rid`` collision with an in-flight
        request."""
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
        self.sched.add(Request(rid=rid, prompt=prompt, max_new=max_new,
                               arrival=now))
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
        decode) synchronously.  False when idle."""
        pending = self._dispatch_next()
        if pending is None:
            return False
        self._finish_step(pending)
        return True

    def pump(self) -> bool:
        raise _not_in_slice("the overlapped pump() pipeline", "9")

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
                cached_tokens=req.cached_tokens, error=req.error)
            if rec is not None and rec.t_finish is not None:
                t_first = rec.t_first if rec.t_first is not None \
                    else rec.t_finish
                res.ttft_s = t_first - rec.arrival
                res.finish_s = rec.t_finish - rec.arrival
                res.tpot_s = (rec.t_finish - t_first) \
                    / max(len(req.generated) - 1, 1)
                res.n_prefill_chunks = rec.n_chunks
                res.preempted = rec.n_preemptions > 0
            self._inflight.discard(req.rid)
            out.append(res)
        self.sched.finished.clear()
        return out

    def run_offline(self, prompts: Sequence[Sequence[int]],
                    max_new_tokens=16, *,
                    overlap: bool = False) -> Tuple[List[RequestResult], Dict]:
        """Admit every prompt, drive the loop dry, return (results, metrics).
        ``max_new_tokens`` is an int or a per-prompt sequence."""
        if overlap:
            raise _not_in_slice("run_offline(overlap=True)", "9")
        budgets = ([max_new_tokens] * len(prompts)
                   if isinstance(max_new_tokens, int) else list(max_new_tokens))
        self._stall_accum = 0.0
        self.health.mark_healthy()
        t0 = time.perf_counter()
        for p, m in zip(prompts, budgets):
            self.add_request(p, m)
        while self.step():
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
        metrics["attn_backend"] = self.attn_backend
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

    def _dispatch_next(self) -> Optional[_Pending]:
        """Scheduler decision + host-side meta build + step launch.  On a
        CUDA device the launch returns before the kernels finish.  ``None``
        on drain (trailing stall time is flushed there)."""
        action = self.sched.next_action()
        if action is None:
            if self._stall_accum:
                self._h_stall.observe(self._stall_accum)
                self._stall_accum = 0.0
            return None
        waiting = bool(self.sched.decode_ready())
        kind, payload = action
        t0 = time.perf_counter()
        if kind == "prefill":
            rows, out = self._launch_prefill(payload, t0)
        elif kind == "prefill_chunk":
            rows, out = self._launch_chunks(payload)
        elif kind == "decode":
            rows, out = payload, self._launch_decode(payload)
        else:
            raise _not_in_slice(f"scheduler action {kind!r}", "13")
        return _Pending(kind=kind, payload=payload, rows=rows, out_dev=out,
                        t0=t0, waiting=waiting)

    def _finish_step(self, pending: _Pending) -> None:
        """Block on the pending step's device output and run the host-side
        bookkeeping: token appends, retirement, step span, stall account."""
        if pending.kind == "decode":
            self._collect_decode(pending)
        else:
            self._collect_prefill(pending)
        t1 = time.perf_counter()
        self.tracer.step_span(pending.kind, pending.t0, t1,
                              rows=len(pending.payload),
                              decode_waiting=pending.waiting)
        if pending.kind == "decode":
            self._h_stall.observe(self._stall_accum)
            self._stall_accum = 0.0
        elif pending.waiting:
            # decode-ready slots sat out this step: head-of-line stall
            self._stall_accum += t1 - pending.t0

    # ---------------------------------------------------------- quarantine

    def _scrub_slot(self, slot_idx: int) -> None:
        """Zero a quarantined slot's exclusively-owned pages before they
        return to the free list: masked attention is a zero-*weight*
        multiply, so a NaN in a recycled page would poison every later
        request whose table points at it.  Shared (radix) pages are
        co-owned and left alone."""
        slot = self.sched.slots[slot_idx]
        excl = [p for p in slot.pages if self.pool.ref(p) == 1]
        if excl:
            _zero_pages(self.pool.kv, excl)
            self.pool.note_scrubbed(len(excl))

    def _quarantine_slot(self, slot_idx: int, reason: str,
                         now: float) -> None:
        """Terminal-fail one live request without touching its batchmates:
        scrub the pages it exclusively owns, release everything through the
        normal retire path, and emit the failure terminal."""
        req = self.sched.slots[slot_idx].req
        self._scrub_slot(slot_idx)
        req.error = reason
        req.t_finish = now
        self.sched.retire(slot_idx)
        self._m_quarantined.inc()
        self.tracer.on_finished(req.rid, now, len(req.generated),
                                error=reason)

    # -------------------------------------------------------------- prefill

    def _prefill_launch(self, rows: List[Tuple[int, Any, int, int]]):
        """Launch one batched chunk-prefill call.  ``rows`` holds
        (slot_idx, req, n_done, n_chunk): each row prefills prompt tokens
        [n_done, n_done + n_chunk) into its bound pages.  The batch is padded
        to a pow2 row count and the tokens to a bucket, so the set of step
        shapes stays bounded.  Returns the per-row last-real-token logits,
        still on the device."""
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
        # attend only the pages the batch actually reaches: truncate the
        # table view to a pow2 page count (bounded shape set) instead of
        # always paying a max_len-wide gather
        ps = self.scfg.page_size
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
        with self.tracer.annotate("prefill_step"):
            logits, self.pool.kv, _ = self._prefill(
                self.params, self.pool.kv, {}, meta, tokens, {})
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
        out = self._prefill_launch(rows)
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

    # --------------------------------------------------------------- decode

    def _decode_plan(self, active: List[int]) -> Dict[str, torch.Tensor]:
        """Flat per-step decode metadata, derived once on the host."""
        B = self.scfg.max_slots
        pos = np.zeros((B,), np.int32)
        tables = np.full((B, max(self.pool.table_width, 1)), NULL_PAGE,
                         np.int32)
        for i in active:
            slot = self.sched.slots[i]
            pos[i] = slot.pos
            tables[i] = slot.table
        return meta_to_device(
            decode_meta(self.cfg, self.scfg.page_size, tables, pos),
            self.device)

    def _launch_decode(self, active: List[int]):
        """Launch one fixed-shape decode step; returns (device next-token
        tensor, device finite flags, launch time) without waiting."""
        tokens = np.zeros((self.scfg.max_slots,), np.int32)
        for i in active:
            tokens[i] = self.sched.slots[i].req.generated[-1]
        meta = self._decode_plan(active)
        t_launch = time.perf_counter()
        with self.tracer.annotate("decode_step"):
            nxt, ok, self.pool.kv, _ = self._decode(
                self.params, self.pool.kv, {}, meta,
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

    def _emit_token(self, rid: int, index: int, tok: int, now: float) -> None:
        if self.on_token is not None:
            self.on_token(rid, index, tok, now)

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
                    *, batch_size: int = 1,
                    eos_id: Optional[int] = None) -> Tuple[List[List[int]],
                                                           Dict]:
    """Static-batching reference on the device the params live on:
    contiguous KV caches, arrival-order batches padded to a shared bucket,
    each batch decoded until its slowest request is done.  ``batch_size=1``
    is the exact single-request greedy baseline the engine's output is
    verified against.  ``eos_id`` defaults to ``scfg.eos_id``."""
    scfg = scfg or ServeConfig()
    eos = scfg.eos_id if eos_id is None else eos_id
    budgets = ([max_new_tokens] * len(prompts)
               if isinstance(max_new_tokens, int) else list(max_new_tokens))
    prefill, decode = _static_steps(cfg)
    device = params["embed"]["tok"].device

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
        bucket = scfg.bucket_of(max(lens))
        toks = np.zeros((B, bucket), np.int32)
        for r, i in enumerate(idxs):
            toks[r, :lens[r]] = prompts[i]
        batch = {"tokens": torch.as_tensor(toks, device=device)}
        last_idx = torch.as_tensor([n - 1 for n in lens], device=device)
        logits, cache = prefill(params, batch, last_idx)
        # grow the contiguous cache to max_len
        fresh = init_cache(cfg, B, scfg.max_len, device)
        for name, leaf in cache["blocks"].items():
            fresh["blocks"][name][:, :, :leaf.shape[2]] = leaf
        cache = {"blocks": fresh["blocks"],
                 "pos": torch.as_tensor(lens, dtype=torch.int32,
                                        device=device)}
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
