"""Async streaming front-end over the continuous-batching ``Engine`` (a
copy of ``repro.serving.server``; one definition differs on purpose,
``ServingLoop._engine_main``: PyTorch keeps the current CUDA device and the
grad mode per thread, so the engine thread sets its own — the engine's
indexed device and ``torch.no_grad()`` — before its first step).

The paper's end goal is an online recognition *service* — traffic arrives
open-loop, responses stream back as they decode.  This module is the bridge
between that world (an asyncio event loop speaking HTTP/SSE, see
``launch.serve_http``) and the engine's single-threaded hot loop:

``ServingLoop``
    Owns the engine on a dedicated **engine thread** driving
    ``Engine.pump()`` (the overlapped host/device pipeline; ``overlap=False``
    falls back to the synchronous ``step()``).  The event loop talks to it
    through two queues:

    * a **submit queue** of control messages (``submit`` / ``cancel``)
      drained at the top of every iteration, so admission happens between —
      never inside — engine steps;
    * a bounded **collect queue** carrying per-token events from the
      engine's ``on_token`` hook to the **detokenize worker thread**.  The
      bound is the backpressure contract: when the detokenizer falls behind,
      the engine thread blocks on ``put`` and stops decoding — the device
      never races ahead of what the host can deliver.  Per-stream asyncio
      queues downstream of the worker are unbounded; a single slow *client*
      buffers there without stalling the engine for everyone else.

    The detokenize worker turns token ids into text fragments off the hot
    loop and hands finished events into each request's ``asyncio.Queue`` via
    ``loop.call_soon_threadsafe`` — the only thread-crossing primitive used.

    Preemption replays re-fire early token indexes (greedy decode
    regenerates the identical prefix); ``ServingLoop`` dedups by index so a
    stream sees every token exactly once, in order — streamed output is
    token-exact against ``generate_static`` by construction.

``detokenize``
    Stand-in tokenizer: the repo serves synthetic token-id traffic, so a
    token renders as ``<id>``.  The seam is where a real tokenizer's
    incremental decode would plug in.

Events delivered into a stream's queue are plain dicts (JSON-ready):

    {"type": "token", "index": i, "token": t, "text": "<t>"}
    {"type": "done", "tokens": [...], "ttft_s": ..., "tpot_s": ...,
     "finish_s": ..., "n_preemptions": ...}
    {"type": "error", "error": "..."}     # rejected / cancelled / shed / fatal

``done``/``error`` are terminal: the loop forgets the stream afterwards.

**Fault tolerance.**  The loop owns three server-side recovery pieces (the
engine owns quarantine and deadlines, see ``serving/{faults,admission}``):

* the engine's :class:`~repro_torch.serving.admission.HealthState` is advanced
  here — ``healthy`` once the engine thread is driving, ``degraded`` on a
  fatal engine error or watchdog trip, ``draining``/``drained`` around
  :meth:`drain` (new submissions shed with reason ``draining``; ``drained``
  once the engine has no work left);
* an optional **watchdog** (``watchdog_s > 0``): a monitor thread that trips
  when the engine thread makes no progress for ``watchdog_s`` seconds while
  streams are pending, fails every pending stream with a clean terminal
  error (delivered directly, bypassing the possibly-wedged event queue),
  and marks the server degraded — clients never hang on a dead engine;
* :meth:`admission_check`, the advisory front-door used by the HTTP layer
  to turn a predicted deadline miss into an immediate 503 + Retry-After
  *before* the SSE stream opens.
"""
from __future__ import annotations

import asyncio
import functools
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .engine import Engine, RequestResult


def detokenize(token: int) -> str:
    """Token id -> text fragment (stand-in for an incremental tokenizer)."""
    return f"<{token}>"


class ServingLoop:
    """Drives an ``Engine`` from its own thread and streams tokens into
    per-request ``asyncio.Queue``s on the event loop that called
    ``start()``."""

    def __init__(self, engine: Engine, *, overlap: bool = True,
                 collect_queue_size: int = 256, poll_s: float = 0.001,
                 watchdog_s: float = 0.0):
        self.engine = engine
        self.overlap = overlap
        self._poll_s = poll_s
        self._watchdog_s = watchdog_s
        self._submit: "queue.Queue[Tuple]" = queue.Queue()
        # bounded: the engine thread blocks here when the detokenizer falls
        # behind — backpressure instead of unbounded buffering
        self._events: "queue.Queue[Optional[Tuple]]" = queue.Queue(
            maxsize=collect_queue_size)
        self._streams: Dict[int, asyncio.Queue] = {}
        self._streamed: Dict[int, int] = {}    # rid -> tokens already emitted
        self._results: Dict[int, RequestResult] = {}
        self._next_rid = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop = threading.Event()
        self._fatal: Optional[str] = None
        self._t_progress = time.monotonic()    # engine-thread liveness stamp
        self._engine_thread = threading.Thread(
            target=self._engine_main, name="engine", daemon=True)
        self._detok_thread = threading.Thread(
            target=self._detok_main, name="detokenize", daemon=True)
        self._watchdog_thread = threading.Thread(
            target=self._watchdog_main, name="watchdog", daemon=True) \
            if watchdog_s > 0 else None
        self._m_watchdog = engine.metrics.counter(
            "server.watchdog_trips", "hung-engine detections: no engine "
            "progress for watchdog_s with streams pending")
        engine.on_token = self._on_token

    # ----------------------------------------------------- event-loop side

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._engine_thread.start()
        self._detok_thread.start()
        if self._watchdog_thread is not None:
            self._watchdog_thread.start()

    async def stop(self) -> None:
        self._stop.set()
        loop = asyncio.get_running_loop()
        # a healthy engine thread exits promptly on the stop flag; a hung
        # one (the watchdog case) is a daemon we abandon after a bounded
        # join — but its detok worker must still be unstuck
        join_s = 10.0 if self._fatal is not None else None
        await loop.run_in_executor(
            None, functools.partial(self._engine_thread.join, join_s))
        if self._engine_thread.is_alive():
            try:
                self._events.put_nowait(None)   # detok shutdown sentinel
            except queue.Full:
                pass
        await loop.run_in_executor(
            None, functools.partial(self._detok_thread.join, join_s))

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None
               ) -> Tuple[int, asyncio.Queue]:
        """Queue a request; returns (rid, stream queue).  Call from the
        event loop thread only.  The queue yields token events followed by
        one terminal ``done``/``error`` event.  Deadlines are relative
        seconds passed through to ``Engine.add_request`` (inert unless
        admission control is on)."""
        if self._fatal is not None:
            raise RuntimeError(f"serving loop dead: {self._fatal}")
        rid = self._next_rid
        self._next_rid += 1
        q: asyncio.Queue = asyncio.Queue()
        self._streams[rid] = q
        self._submit.put(("submit", rid, [int(t) for t in prompt],
                          int(max_new_tokens), deadline_s, ttft_deadline_s))
        return rid, q

    def drain(self) -> None:
        """Begin a graceful drain: new submissions are shed with reason
        ``draining``; in-flight requests run to completion.  The health
        state reaches ``drained`` once the engine has no work left."""
        self.engine.health.begin_drain()

    def admission_check(self, deadline_s: Optional[float] = None,
                        ttft_deadline_s: Optional[float] = None
                        ) -> Optional[Tuple[str, float]]:
        """Advisory front-door check (event-loop thread): returns
        ``(reason, retry_after_s)`` if the request should be refused before
        its stream opens, else None.  Advisory only — the engine-side check
        in ``add_request`` is authoritative; this one exists so the HTTP
        layer can answer 503 instead of opening an SSE stream that
        immediately errors."""
        adm = self.engine.admission
        # queued work the engine knows about, plus submissions still in
        # flight to it (open streams beyond slot capacity) — the gauge alone
        # lags a burst, which would wave the whole burst through
        depth = max(int(self.engine.metrics.value("sched.queue_depth")),
                    len(self._streams) - self.engine.scfg.max_slots)
        if self.engine.health.draining:
            retry = adm.retry_after_s(depth) if adm is not None else 1.0
            self.engine._m_shed.labels(reason="draining").inc()
            return ("draining", retry)
        if adm is None:
            return None
        reason = adm.check(depth, deadline_s, ttft_deadline_s)
        if reason is None:
            return None
        self.engine._m_shed.labels(reason=reason).inc()
        return (reason, adm.retry_after_s(depth))

    def cancel(self, rid: int) -> None:
        """Abort a request (client disconnect).  The engine releases its
        slot/pages at the next loop iteration."""
        self._submit.put(("cancel", rid))

    def forget(self, rid: int) -> None:
        """Drop a stream's delivery queue (after its terminal event)."""
        self._streams.pop(rid, None)

    # -------------------------------------------------- engine-thread side

    def _on_token(self, rid: int, index: int, token: int, t: float) -> None:
        self._t_progress = time.monotonic()
        n = self._streamed.get(rid, 0)
        if index < n:
            return          # preemption replay: identical prefix, already out
        self._streamed[rid] = index + 1
        self._events.put(("token", rid, index, token, t))   # blocks when full

    def _engine_main(self) -> None:
        drive = self.engine.pump if self.overlap else self.engine.step
        health = self.engine.health
        # the current device and the grad mode are per thread in PyTorch:
        # this thread launches on the engine's own (indexed) device and
        # records no autograd graph, whatever the thread that built it set
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        health.mark_healthy()
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    self._t_progress = time.monotonic()
                    busy = False
                    while True:
                        try:
                            msg = self._submit.get_nowait()
                        except queue.Empty:
                            break
                        busy = True
                        if msg[0] == "submit":
                            _, rid, prompt, max_new, dl, ttft_dl = msg
                            try:
                                self.engine.add_request(
                                    prompt, max_new, rid=rid, deadline_s=dl,
                                    ttft_deadline_s=ttft_dl)
                            except ValueError as e:   # rid collision (bug)
                                self._events.put(("error", rid, str(e)))
                        else:
                            self.engine.cancel(msg[1])
                    if drive():
                        busy = True
                    for res in self.engine.collect():
                        busy = True
                        self._events.put(("done", res.rid, res))
                    if not busy:
                        if (health.draining
                                and not self.engine.sched.has_work()
                                and self._submit.empty()):
                            health.mark_drained()
                        self._stop.wait(self._poll_s)
        except Exception as e:              # scheduler deadlock, OOM, ...
            self._fatal = f"{type(e).__name__}: {e}"
            health.mark_degraded(self._fatal)
            for rid in list(self._streams):
                self._events.put(("error", rid, self._fatal))
        finally:
            self._events.put(None)          # detok worker shutdown sentinel

    # ----------------------------------------------------- watchdog thread

    def _watchdog_main(self) -> None:
        """Trip when the engine thread stalls: no progress stamp for
        ``watchdog_s`` while streams are pending.  Fails every pending
        stream directly (``_deliver`` bypasses the possibly-wedged event
        queue) so clients see a terminal error instead of hanging."""
        period = max(self._watchdog_s / 4, 0.01)
        while not self._stop.wait(period):
            if not self._streams and self._submit.empty():
                self._t_progress = time.monotonic()   # idle: nothing to watch
                continue
            stale = time.monotonic() - self._t_progress
            if stale < self._watchdog_s:
                continue
            self._fatal = (f"watchdog: engine made no progress for "
                           f"{stale:.1f}s with requests pending")
            self._m_watchdog.inc()
            self.engine.health.mark_degraded("watchdog_timeout")
            for rid in list(self._streams):
                self._deliver(rid, {"type": "error", "error": self._fatal})
            return

    # --------------------------------------------------- detok-worker side

    def _detok_main(self) -> None:
        injector = getattr(self.engine, "injector", None)
        while True:
            ev = self._events.get()
            if ev is None:
                return
            if ev[0] == "token":
                if injector is not None:
                    injector.on_detok(time.sleep)   # detok_stall fault seam
                _, rid, index, token, t = ev
                self._deliver(rid, {"type": "token", "index": index,
                                    "token": token,
                                    "text": detokenize(token)})
            elif ev[0] == "done":
                _, rid, res = ev
                self._streamed.pop(rid, None)
                self._results[rid] = res
                if res.failed:
                    self._deliver(rid, {"type": "error", "error": res.error,
                                        "tokens": res.tokens,
                                        "retry_after_s": res.retry_after_s})
                else:
                    self._deliver(rid, {
                        "type": "done", "tokens": res.tokens,
                        "text": "".join(detokenize(t) for t in res.tokens),
                        "ttft_s": res.ttft_s, "tpot_s": res.tpot_s,
                        "finish_s": res.finish_s,
                        "n_preemptions": res.n_preemptions,
                        "cached_tokens": res.cached_tokens})
            else:                           # ("error", rid, msg)
                _, rid, msg = ev
                self._streamed.pop(rid, None)
                self._deliver(rid, {"type": "error", "error": msg})

    def _deliver(self, rid: int, payload: Dict[str, Any]) -> None:
        q = self._streams.get(rid)
        loop = self._loop
        if q is None or loop is None or loop.is_closed():
            return
        try:
            loop.call_soon_threadsafe(q.put_nowait, payload)
        except RuntimeError:
            pass                            # loop shut down mid-delivery


async def stream_request(serving: ServingLoop, prompt: Sequence[int],
                         max_new_tokens: int = 16,
                         timeout_s: float = 120.0) -> List[Dict[str, Any]]:
    """Submit one request and await its full event stream (tokens + the
    terminal event) — the in-process client used by tests and the Poisson
    benchmark."""
    rid, q = serving.submit(prompt, max_new_tokens)
    events: List[Dict[str, Any]] = []
    deadline = time.monotonic() + timeout_s
    while True:
        ev = await asyncio.wait_for(q.get(),
                                    timeout=max(deadline - time.monotonic(),
                                                0.001))
        events.append(ev)
        if ev["type"] in ("done", "error"):
            serving.forget(rid)
            return events
