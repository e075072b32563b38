"""Serving telemetry: metrics registry + request-lifecycle tracer.

The paper's central claim is an *efficiency* claim — parallelization
"accelerates computation" — and the serving stack can only defend (or
optimize) that claim if a step's time is attributable.  This module is the
measurement layer every serving component reports into:

``MetricsRegistry``
    Typed counters / gauges / histograms with optional labels, registered by
    dotted name (``pool.pages_allocated``, ``sched.admissions{kind=...}``).
    Registration is idempotent — ``registry.counter("x")`` returns the
    existing metric on a second call — so each component declares what it
    emits without coordination.  ``snapshot()`` renders everything to plain
    JSON (histograms as count/sum/percentiles), the shape ``--metrics-json``
    dumps and the benchmark embeds.  All operations are O(1) host-side dict
    and list work: the decode hot loop can afford them (<2% of a step).

``Tracer``
    Request-lifecycle + engine-phase tracing in Chrome trace-event JSON
    (the ``{"traceEvents": [...]}`` format Perfetto / ``chrome://tracing``
    load directly).  Two tracks:

    * **engine** (pid 1) — one complete ("X") event per ``Engine.step``:
      ``prefill`` / ``prefill_chunk`` / ``restore`` / ``decode``, with args
      recording the rows served and whether decode-ready slots sat parked
      behind the step (``decode_waiting`` — stall attribution).
    * **requests** (pid 2, tid = rid) — per-request spans
      ``queued → prefill_chunk[i]... → decode`` plus ``preempted`` /
      ``restored`` instants and a terminal ``finished`` instant whose args
      carry the request's summary (ttft, tpot, chunk count, preemptions).

    The tracer also keeps a per-rid lifecycle record (arrival, admission,
    first token, finish, chunk count, preemptions) that the engine reads
    back into each ``RequestResult`` — per-request timing comes from one
    place.  ``annotate(name)`` optionally wraps the model steps in
    ``torch.profiler.record_function`` so these host spans line up with
    device timelines when a torch profiler trace is being captured.

``shared_metrics``
    The one end-of-run metrics schema both engines emit
    (``generate_static`` and ``Engine.run_offline``), so BENCH_serve.json
    rows are comparable column-for-column; ``percentile`` is the shared
    percentile helper.

``validate_trace``
    Well-formedness checker for an emitted trace: monotonic non-negative
    timestamps, properly nested spans per track, and every admitted rid
    reaching a terminal ``finished`` event.  Used by tests and
    ``launch/trace_report.py --validate`` (and CI).

The hard contract, inherited from ``--verify``: telemetry records time, it
never participates in scheduling or math — turning it on must not change a
single emitted token.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- helpers


def percentile(xs: Sequence[float], q: float) -> float:
    """Shared percentile helper (0.0 on empty input)."""
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs), q))


# ---------------------------------------------------------------- metrics


class Counter:
    """Monotonically increasing count (events, tokens, pages)."""
    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0

    def inc(self, n: int = 1) -> None:
        assert n >= 0, f"counter {self.name} decremented"
        self.value += n


class Gauge:
    """Point-in-time level (queue depth, live pages, claimed slots)."""
    kind = "gauge"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n


class Histogram:
    """Distribution of observed values (step times, stall times)."""
    kind = "histogram"
    __slots__ = ("name", "help", "values")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> float:
        return float(sum(self.values))

    def percentile(self, q: float) -> float:
        return percentile(self.values, q)

    @property
    def max(self) -> float:
        return max(self.values) if self.values else 0.0


class LabeledFamily:
    """A metric family fanned out over label values.

    ``family.labels(reason="no_pages")`` returns (creating on first use) the
    child metric for that label combination; children appear in snapshots as
    ``name{reason=no_pages}``."""

    def __init__(self, ctor, name: str, help: str, label_names: Tuple[str, ...]):
        self._ctor = ctor
        self.name, self.help = name, help
        self.label_names = tuple(label_names)
        self.kind = ctor.kind
        self.children: Dict[Tuple[str, ...], Any] = {}

    def labels(self, **kv) -> Any:
        assert set(kv) == set(self.label_names), \
            f"{self.name}: labels {sorted(kv)} != {sorted(self.label_names)}"
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self.children.get(key)
        if child is None:
            suffix = ",".join(f"{k}={v}"
                              for k, v in zip(self.label_names, key))
            child = self._ctor(f"{self.name}{{{suffix}}}", self.help)
            self.children[key] = child
        return child

    def items(self) -> Iterator[Tuple[Tuple[str, ...], Any]]:
        return iter(sorted(self.children.items()))


class MetricsRegistry:
    """Named typed metrics; each serving component registers what it emits.

    Registration is idempotent by name (the metric type must match), so the
    pool, cache, scheduler, and engine can all hold references into one
    registry without ordering constraints."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _register(self, ctor, name: str, help: str,
                  labels: Tuple[str, ...]) -> Any:
        m = self._metrics.get(name)
        if m is not None:
            assert m.kind == ctor.kind, \
                f"metric {name} re-registered as {ctor.kind}, was {m.kind}"
            return m
        m = LabeledFamily(ctor, name, help, labels) if labels \
            else ctor(name, help)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: Tuple[str, ...] = ()) -> Any:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Tuple[str, ...] = ()) -> Any:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Tuple[str, ...] = ()) -> Any:
        return self._register(Histogram, name, help, labels)

    def get(self, name: str) -> Any:
        return self._metrics.get(name)

    def value(self, name: str, default=0):
        """Scalar value of a plain counter/gauge (default if unregistered)."""
        m = self._metrics.get(name)
        return default if m is None else m.value

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Plain-JSON view: {counters: {...}, gauges: {...}, histograms:
        {name: {count, sum, p50, p95, max}}}, labeled children flattened to
        ``name{k=v}`` keys."""
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}}

        def emit(m):
            if m.kind == "histogram":
                out["histograms"][m.name] = {
                    "count": m.count, "sum": m.total,
                    "p50": m.percentile(50), "p95": m.percentile(95),
                    "max": m.max}
            else:
                out[m.kind + "s"][m.name] = m.value

        for m in self._metrics.values():
            if isinstance(m, LabeledFamily):
                for _, child in m.items():
                    emit(child)
            else:
                emit(m)
        return out


# ----------------------------------------------------------------- tracer

# Chrome trace-event track layout (pid/tid are just track ids to Perfetto)
ENGINE_PID = 1
REQUEST_PID = 2
HOST_TID = 1       # engine-process track for the overlapped host pipeline:
                   # dispatch / stage / collect spans emitted by Engine.pump()
                   # sit beside the step track (tid 0) so the overlap is
                   # visible in Perfetto


@dataclasses.dataclass
class RequestRecord:
    """Per-rid lifecycle bookkeeping the engine reads back into results."""
    arrival: float = 0.0
    t_queued: float = 0.0               # last (re-)queue time (preemptions)
    t_admitted: Optional[float] = None
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    n_chunks: int = 0                   # prefill calls incl. replays
    n_preemptions: int = 0
    n_restores: int = 0
    terminal: bool = False


class Tracer:
    """Request-lifecycle + engine-phase tracer (Chrome trace-event JSON).

    All methods are host-side list/dict appends on a perf_counter clock;
    ``enabled=False`` turns every hook into a cheap early return (used by
    standalone Scheduler construction in tests).
    ``profiler_annotations=True`` makes ``annotate(name)`` wrap model step
    launches in ``torch.profiler.record_function`` so a concurrently
    captured device profile carries the same phase names."""

    def __init__(self, enabled: bool = True,
                 profiler_annotations: bool = False):
        self.enabled = enabled
        self.profiler_annotations = profiler_annotations
        self.t0 = time.perf_counter()       # trace epoch (ts are relative)
        self.events: List[Dict[str, Any]] = []
        self.requests: Dict[int, RequestRecord] = {}
        self._steps = 0

    # ------------------------------------------------------------- plumbing

    def now(self) -> float:
        return time.perf_counter()

    def _ts(self, t: float) -> float:
        return (t - self.t0) * 1e6          # seconds -> trace microseconds

    def span(self, pid: int, tid: int, name: str, t_start: float,
             t_end: float, **args) -> None:
        """One complete ("X") event covering [t_start, t_end] (abs seconds)."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "ph": "X", "pid": pid, "tid": tid,
            "cat": "engine" if pid == ENGINE_PID else "request",
            "ts": self._ts(t_start),
            "dur": max(self._ts(t_end) - self._ts(t_start), 0.0),
            "args": args})

    def instant(self, pid: int, tid: int, name: str, t: float,
                **args) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name, "ph": "i", "s": "t", "pid": pid, "tid": tid,
            "cat": "engine" if pid == ENGINE_PID else "request",
            "ts": self._ts(t), "args": args})

    def annotate(self, name: str):
        """Context manager for one model step launch: a
        ``torch.profiler.record_function`` range when enabled, else a
        no-op."""
        if self.enabled and self.profiler_annotations:
            import torch
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    # -------------------------------------------------------- engine phases

    def step_span(self, name: str, t_start: float, t_end: float,
                  **args) -> None:
        """One engine step (prefill / prefill_chunk / restore / decode)."""
        if not self.enabled:
            return
        args.setdefault("step", self._steps)
        self._steps += 1
        self.span(ENGINE_PID, 0, name, t_start, t_end, **args)

    def host_span(self, name: str, t_start: float, t_end: float,
                  **args) -> None:
        """One host-pipeline phase (dispatch / stage / collect) of an
        overlapped ``Engine.pump()`` step, on its own engine-process track."""
        self.span(ENGINE_PID, HOST_TID, name, t_start, t_end, **args)

    # ---------------------------------------------------- request lifecycle

    def _rec(self, rid: int) -> RequestRecord:
        rec = self.requests.get(rid)
        if rec is None:
            rec = self.requests[rid] = RequestRecord()
        return rec

    def on_queued(self, rid: int, t: float) -> None:
        if not self.enabled:
            return
        rec = self._rec(rid)
        rec.arrival = rec.arrival or t
        rec.t_queued = t

    def on_admitted(self, rid: int, t: float, cached_tokens: int = 0,
                    kind: str = "prefill") -> None:
        """Queued -> admitted transition (also re-admissions after
        preemption); closes the rid's ``queued`` span."""
        if not self.enabled:
            return
        rec = self._rec(rid)
        rec.t_admitted = t
        self.span(REQUEST_PID, rid, "queued", rec.t_queued, t,
                  cached_tokens=cached_tokens, kind=kind)

    def on_chunk(self, rid: int, t_start: float, t_end: float,
                 n_done: int, n_chunk: int) -> None:
        """One prefill chunk of this rid's prompt ran in [t_start, t_end]."""
        if not self.enabled:
            return
        rec = self._rec(rid)
        self.span(REQUEST_PID, rid, "prefill_chunk", t_start, t_end,
                  index=rec.n_chunks, n_done=n_done, n_chunk=n_chunk)
        rec.n_chunks += 1

    def on_first_token(self, rid: int, t: float) -> None:
        """Idempotent: TTFT is the first token *ever* produced, so a
        preemption replay re-earning token 0 does not move it."""
        if self.enabled:
            rec = self._rec(rid)
            if rec.t_first is None:
                rec.t_first = t

    def on_preempted(self, rid: int, t: float, checkpointed: bool) -> None:
        # note rec.t_first survives a replay: ttft_s measures the first
        # token ever produced, matching the legacy RequestResult.ttft
        if not self.enabled:
            return
        rec = self._rec(rid)
        rec.n_preemptions += 1
        rec.t_queued = t
        self.instant(REQUEST_PID, rid, "preempted", t,
                     checkpointed=checkpointed)

    def on_rejected(self, rid: int, t: float, reason: str) -> None:
        """Terminal transition for a request that never ran: a graceful
        admission rejection (no token budget) or a cancellation while still
        queued.  Emits a ``rejected`` instant, which the validator accepts
        as this rid's terminal event."""
        if not self.enabled:
            return
        rec = self._rec(rid)
        rec.arrival = rec.arrival or t
        rec.t_finish = t
        rec.terminal = True
        self.instant(REQUEST_PID, rid, "rejected", t, reason=reason)

    def on_restored(self, rid: int, t: float) -> None:
        if not self.enabled:
            return
        self._rec(rid).n_restores += 1
        self.instant(REQUEST_PID, rid, "restored", t)

    def on_finished(self, rid: int, t: float, n_tokens: int,
                    error: str = "") -> None:
        """Terminal transition: closes the rid's ``decode`` span and emits
        the ``finished`` instant with the request's summary args.  A
        nonempty ``error`` marks a mid-flight failure terminal (quarantine,
        cancel, deadline eviction) — same instant, extra ``error`` arg, so
        trace consumers see exactly one terminal per rid either way."""
        if not self.enabled:
            return
        rec = self._rec(rid)
        rec.t_finish = t
        rec.terminal = True
        t_first = rec.t_first if rec.t_first is not None else t
        self.span(REQUEST_PID, rid, "decode", t_first, t, n_tokens=n_tokens)
        extra = {"error": error} if error else {}
        self.instant(
            REQUEST_PID, rid, "finished", t,
            ttft_s=t_first - rec.arrival, finish_s=t - rec.arrival,
            tpot_s=(t - t_first) / max(n_tokens - 1, 1),
            n_tokens=n_tokens, n_prefill_chunks=rec.n_chunks,
            n_preemptions=rec.n_preemptions, **extra)

    # ------------------------------------------------------------ emission

    def to_dict(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing)."""
        meta = [
            {"ph": "M", "pid": ENGINE_PID, "tid": 0, "name": "process_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": ENGINE_PID, "tid": 0, "name": "thread_name",
             "args": {"name": "steps"}},
            {"ph": "M", "pid": REQUEST_PID, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        if any(e.get("pid") == ENGINE_PID and e.get("tid") == HOST_TID
               for e in self.events):
            meta.append(
                {"ph": "M", "pid": ENGINE_PID, "tid": HOST_TID,
                 "name": "thread_name", "args": {"name": "host pipeline"}})
        meta += [{"ph": "M", "pid": REQUEST_PID, "tid": rid,
                  "name": "thread_name", "args": {"name": f"request {rid}"}}
                 for rid in sorted(self.requests)]
        return {"traceEvents": meta + self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


# ------------------------------------------------------- trace validation


def validate_trace(trace: Dict[str, Any]) -> List[str]:
    """Well-formedness problems of a Chrome trace dict ([] when clean).

    Checks: timestamps finite, non-negative, with non-negative durations;
    spans on each (pid, tid) track properly nested (disjoint or contained —
    no partial overlap); per-request lifecycle ordering (queued ends before
    decode starts); and every rid that was admitted (has any span) reaches a
    terminal ``finished`` instant."""
    problems: List[str] = []
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") != "M"]
    tracks: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
    for e in events:
        ts = e.get("ts")
        if ts is None or not np.isfinite(ts) or ts < 0:
            problems.append(f"bad ts {ts!r} on event {e.get('name')!r}")
            continue
        if e.get("ph") == "X":
            dur = e.get("dur", 0.0)
            if not np.isfinite(dur) or dur < 0:
                problems.append(
                    f"bad dur {dur!r} on span {e.get('name')!r}")
                continue
        tracks.setdefault((e.get("pid"), e.get("tid")), []).append(e)

    eps = 1.0                               # float slack, microseconds
    for (pid, tid), evs in sorted(tracks.items()):
        spans = sorted((e for e in evs if e["ph"] == "X"),
                       key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[Tuple[float, str]] = []  # (end ts, name)
        for e in spans:
            start, end = e["ts"], e["ts"] + e.get("dur", 0.0)
            while stack and stack[-1][0] <= start + eps:
                stack.pop()
            if stack and end > stack[-1][0] + eps:
                problems.append(
                    f"track ({pid},{tid}): span {e['name']!r} "
                    f"[{start:.0f},{end:.0f}] partially overlaps "
                    f"{stack[-1][1]!r} (ends {stack[-1][0]:.0f})")
            stack.append((end, e["name"]))

        if pid == REQUEST_PID:
            names = {e["name"] for e in evs}
            if not any(e["ph"] == "i" and e["name"] in ("finished", "rejected")
                       for e in evs):
                problems.append(
                    f"request {tid}: admitted (spans {sorted(names)}) but "
                    f"never reached a terminal 'finished'/'rejected' event")
            queued_ends = [e["ts"] + e.get("dur", 0.0) for e in evs
                          if e["ph"] == "X" and e["name"] == "queued"]
            decodes = [e["ts"] for e in evs
                       if e["ph"] == "X" and e["name"] == "decode"]
            if queued_ends and decodes \
                    and min(decodes) + eps < min(queued_ends):
                problems.append(
                    f"request {tid}: decode span starts before first "
                    f"admission")
    return problems


# ------------------------------------------------- shared metrics schema

#: Every key both serving paths emit, column-for-column.  The engine path
#: layers its extras (cache hit rate is only meaningful with a radix cache,
#: stall only with interleaved scheduling) but the *keys* are always present
#: in both, with honest zero defaults where a path cannot measure the value.
SHARED_METRIC_KEYS = (
    "n_requests", "new_tokens", "wall_s", "tokens_per_s", "requests_per_s",
    "latency_p50_s", "latency_p95_s", "ttft_p50_s", "ttft_p95_s",
    "prompt_tokens", "cached_tokens", "prefill_tokens", "cache_hit_rate",
    "prefill_steps", "prefill_padded_tokens", "prefill_actual_tokens",
    "prefill_padding_waste", "decode_steps", "decode_step_ms_p50",
    "decode_step_ms_p95", "decode_stall_ms_p50", "decode_stall_ms_p95",
    "decode_stall_ms_max",
)


def shared_metrics(n_requests: int, n_tokens: int,
                   latencies: Sequence[float], wall: float, *,
                   ttfts: Sequence[float] = (),
                   prompt_tokens: int = 0, cached_tokens: int = 0,
                   prefill_steps: int = 0,
                   prefill_padded_tokens: int = 0,
                   prefill_actual_tokens: int = 0,
                   decode_step_s: Sequence[float] = (),
                   decode_stall_s: Sequence[float] = ()) -> Dict[str, Any]:
    """The one end-of-run metrics schema both engines report."""
    stalls = list(decode_stall_s) or [0.0]
    m = {
        "n_requests": n_requests,
        "new_tokens": n_tokens,
        "wall_s": wall,
        "tokens_per_s": n_tokens / max(wall, 1e-9),
        "requests_per_s": n_requests / max(wall, 1e-9),
        "latency_p50_s": percentile(latencies, 50),
        "latency_p95_s": percentile(latencies, 95),
        "ttft_p50_s": percentile(ttfts, 50),
        "ttft_p95_s": percentile(ttfts, 95),
        "prompt_tokens": prompt_tokens,
        "cached_tokens": cached_tokens,
        "prefill_tokens": prompt_tokens - cached_tokens,
        "cache_hit_rate": cached_tokens / max(prompt_tokens, 1),
        "prefill_steps": prefill_steps,
        "prefill_padded_tokens": prefill_padded_tokens,
        "prefill_actual_tokens": prefill_actual_tokens,
        "prefill_padding_waste": 1.0 - (prefill_actual_tokens
                                        / max(prefill_padded_tokens, 1)),
        "decode_steps": len(decode_step_s),
        "decode_step_ms_p50": percentile(decode_step_s, 50) * 1e3,
        "decode_step_ms_p95": percentile(decode_step_s, 95) * 1e3,
        "decode_stall_ms_p50": percentile(stalls, 50) * 1e3,
        "decode_stall_ms_p95": percentile(stalls, 95) * 1e3,
        "decode_stall_ms_max": max(stalls) * 1e3,
    }
    assert set(m) == set(SHARED_METRIC_KEYS)
    return m
