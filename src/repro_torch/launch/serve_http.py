"""HTTP/SSE streaming server over the port's continuous-batching engine
(the port of ``repro.launch.serve_http``).

  # serve an arch on :8080 on the card (SSE streaming, overlapped pipeline,
  # the Hopper kernels)
  PYTHONPATH=src python -m repro_torch.launch.serve_http --arch qwen2-0.5b \
      --port 8080

  # self-contained smoke run: start the server on an ephemeral port, stream
  # N requests through real HTTP, check the streams, write the trace
  PYTHONPATH=src python -m repro_torch.launch.serve_http --device cpu \
      --reduced --smoke 4 --trace trace.json

``--device`` is ``cuda`` by default (without a card the run exits with an
error instead of moving to the CPU); ``--attn-backend`` takes
``auto|reference|hopper`` (``auto``: ``hopper`` on ``cuda``).  The smoke
checks that every stream delivers each token index exactly once, in order,
with the tokens of its ``done`` frame; then it holds the streamed tokens to
the static single-request baseline exactly on the ``reference`` backend,
and on ``hopper`` (whose sums round in another order) to the reference
replay by the dual gate of ``serving.parity``, printing how many tokens
are exact.  It also reads ``GET /metrics``.

API (deliberately tiny, stdlib-only on both ends):

* ``POST /generate`` — body ``{"prompt": [ids...], "max_new_tokens": n}``;
  responds ``text/event-stream``, one ``data: {json}`` frame per token as
  it decodes plus a terminal ``done`` (tokens, ttft_s, tpot_s) or ``error``
  frame.  A client disconnect mid-stream cancels the request — its slot and
  pages free at the next engine iteration.
* ``GET /metrics`` — full metrics-registry snapshot as JSON (every serving
  layer: pool, radix cache, scheduler, engine, overlap counters).
* ``GET /health`` — the real health state machine (``starting → healthy →
  degraded/draining → drained`` with transition history) plus live-slot and
  queue-depth gauges.  Load balancers key off ``state``.
* ``POST /drain`` — begin a graceful drain: new work is shed with a 503,
  in-flight requests run to completion, ``/health`` reports ``drained``
  once the engine is idle.

Overload behaviour (``--admission-control``): requests may carry
``deadline_s`` / ``ttft_deadline_s``; when the predicted queue wait blows
the deadline (or the server is draining) the request is refused **before**
its SSE stream opens — 503 with a JSON body ``{"error": "overloaded",
"reason": ..., "retry_after_s": ...}`` and a ``Retry-After`` header whose
value is a jittered backoff hint (so a retrying fleet decorrelates).

The HTTP layer is hand-rolled over ``asyncio.start_server`` (request line +
headers + Content-Length body; no chunked uploads, no keep-alive) so the
serving stack stays dependency-free — the point is the engine behind it,
not the framework in front.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs import ServeConfig, get_arch, reduced as make_reduced
from ..serving import (Engine, ServingLoop, Tracer, dual_gate,
                       generate_static, logit_tol, replay_logits)

MAX_BODY = 1 << 20      # 1 MiB request-body cap


def _json_response(payload: Any, status: str = "200 OK",
                   headers: Optional[Dict[str, str]] = None) -> bytes:
    body = json.dumps(payload).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    return (f"HTTP/1.1 {status}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n{extra}Connection: close\r\n\r\n"
            ).encode() + body


SSE_HEADER = (b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
              b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[Tuple[str, str, bytes]]:
    """Parse one HTTP/1.1 request: (method, path, body) or None on EOF."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin1").split()
    if len(parts) < 2:
        return None
    method, path = parts[0], parts[1]
    n_body = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin1").partition(":")
        if k.strip().lower() == "content-length":
            n_body = min(int(v.strip()), MAX_BODY)
    body = await reader.readexactly(n_body) if n_body else b""
    return method, path, body


class HttpFrontend:
    """Routes HTTP requests into a ``ServingLoop``."""

    def __init__(self, serving: ServingLoop, default_max_new: int = 16):
        self.serving = serving
        self.default_max_new = default_max_new
        self.n_streams = 0
        self.report: Dict[str, Any] = {}      # the smoke's numbers

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            req = await _read_request(reader)
            if req is None:
                return
            method, path, body = req
            if method == "POST" and path == "/generate":
                await self._generate(writer, body)
            elif method == "GET" and path == "/metrics":
                writer.write(_json_response(
                    self.serving.engine.metrics_snapshot()))
            elif method == "GET" and path == "/health":
                m = self.serving.engine.metrics
                payload = self.serving.engine.health.to_dict()
                payload.update(
                    slots_live=m.value("sched.slots_live"),
                    queue_depth=m.value("sched.queue_depth"))
                writer.write(_json_response(payload))
            elif method == "POST" and path == "/drain":
                self.serving.drain()
                writer.write(_json_response(
                    self.serving.engine.health.to_dict()))
            else:
                writer.write(_json_response({"error": "not found"},
                                            "404 Not Found"))
            await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError,
                BrokenPipeError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _generate(self, writer: asyncio.StreamWriter,
                        body: bytes) -> None:
        try:
            payload = json.loads(body or b"{}")
            prompt = [int(t) for t in payload["prompt"]]
            max_new = int(payload.get("max_new_tokens", self.default_max_new))
            deadline_s = payload.get("deadline_s")
            ttft_deadline_s = payload.get("ttft_deadline_s")
            deadline_s = float(deadline_s) if deadline_s is not None else None
            ttft_deadline_s = (float(ttft_deadline_s)
                               if ttft_deadline_s is not None else None)
        except (KeyError, TypeError, ValueError) as e:
            writer.write(_json_response({"error": f"bad request: {e}"},
                                        "400 Bad Request"))
            return
        shed = self.serving.admission_check(deadline_s, ttft_deadline_s)
        if shed is not None:
            reason, retry_after = shed
            writer.write(_json_response(
                {"error": "overloaded", "reason": reason,
                 "retry_after_s": retry_after},
                "503 Service Unavailable",
                headers={"Retry-After": f"{retry_after:.3f}"}))
            return
        rid, q = self.serving.submit(prompt, max_new,
                                     deadline_s=deadline_s,
                                     ttft_deadline_s=ttft_deadline_s)
        self.n_streams += 1
        writer.write(SSE_HEADER)
        try:
            while True:
                ev = await q.get()
                writer.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
                await writer.drain()     # disconnect surfaces here
                if ev["type"] in ("done", "error"):
                    return
        except (ConnectionResetError, BrokenPipeError):
            self.serving.cancel(rid)     # client went away: free the slot
        finally:
            self.serving.forget(rid)


# --------------------------------------------------------------- smoke mode


async def _sse_client(host: str, port: int, prompt, max_new: int,
                      deadline_s: Optional[float] = None,
                      ttft_deadline_s: Optional[float] = None,
                      disconnect_after: int = 0) -> Dict[str, Any]:
    """Minimal stdlib SSE client: POST /generate, collect every event.

    Understands the 503 shed path (returns ``status``, ``retry_after`` and
    the JSON body instead of a stream) and can abandon the connection after
    ``disconnect_after`` tokens to exercise mid-stream client disconnects.
    """
    reader, writer = await asyncio.open_connection(host, port)
    req: Dict[str, Any] = {"prompt": prompt, "max_new_tokens": max_new}
    if deadline_s is not None:
        req["deadline_s"] = deadline_s
    if ttft_deadline_s is not None:
        req["ttft_deadline_s"] = ttft_deadline_s
    body = json.dumps(req).encode()
    writer.write((f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    t_submit = time.perf_counter()

    status_line = await reader.readline()
    status = int(status_line.split()[1]) if status_line else 0
    retry_after = None
    n_header_body = 0
    while True:                          # response headers
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin1").partition(":")
        k = k.strip().lower()
        if k == "retry-after":
            retry_after = float(v.strip())
        elif k == "content-length":
            n_header_body = int(v.strip())
    if status != 200:                    # shed / error: JSON body, no stream
        raw = await reader.readexactly(n_header_body) if n_header_body else b""
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass
        return {"status": status, "retry_after": retry_after,
                "body": json.loads(raw or b"{}"), "events": [],
                "streamed": [], "final": {"type": "shed"},
                "client_ttft_s": time.perf_counter() - t_submit}

    events = []
    t_first = None
    while True:
        line = await reader.readline()
        if not line:
            raise RuntimeError("server closed the stream mid-request")
        if not line.startswith(b"data: "):
            continue                     # keep-alive blank lines
        ev = json.loads(line[6:])
        if ev["type"] == "token" and t_first is None:
            t_first = time.perf_counter()
        events.append(ev)
        if ev["type"] in ("done", "error"):
            break
        if disconnect_after and len(events) >= disconnect_after:
            break                        # abandon mid-stream (hard close)
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionResetError, BrokenPipeError):
        pass
    streamed = [e["token"] for e in events if e["type"] == "token"]
    final = events[-1]
    return {"status": status, "retry_after": retry_after, "events": events,
            "streamed": streamed, "final": final,
            "client_ttft_s": (t_first or time.perf_counter()) - t_submit}


async def _http_json(host: str, port: int, method: str, path: str
                     ) -> Tuple[int, Dict[str, Any]]:
    """One non-streaming request (GET /health, POST /drain, ...)."""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Length: 0\r\n\r\n").encode())
    await writer.drain()
    status_line = await reader.readline()
    status = int(status_line.split()[1]) if status_line else 0
    n_body = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin1").partition(":")
        if k.strip().lower() == "content-length":
            n_body = int(v.strip())
    raw = await reader.readexactly(n_body) if n_body else b""
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionResetError, BrokenPipeError):
        pass
    return status, json.loads(raw or b"{}")


async def _overload_smoke(host: str, port: int, args, cfg,
                          service_hint_s: float,
                          report: Dict[str, Any]) -> int:
    """Burst 3N deadline-carrying clients (≈2× what the calibrated slots
    can absorb) and assert the overload contract: nobody hangs, every
    client reaches a terminal state, and at least one shed carries a 503
    with a positive Retry-After backoff hint."""
    rng = np.random.RandomState(args.seed + 1)
    n = 3 * args.smoke
    deadline_s = max(1.2 * service_hint_s, 0.05)
    prompts = [rng.randint(1, cfg.vocab,
                           size=int(rng.randint(4, args.prompt_len + 1))
                           ).tolist() for _ in range(n)]
    outs = await asyncio.wait_for(
        asyncio.gather(*[_sse_client(host, port, p, args.gen,
                                     deadline_s=deadline_s)
                         for p in prompts]),
        timeout=args.timeout_s)      # the no-hang assertion
    done = [o for o in outs if o["final"]["type"] == "done"]
    shed_503 = [o for o in outs if o["status"] == 503]
    # engine-side sheds / deadline evictions surface as stream errors
    errs = [o for o in outs if o["final"]["type"] == "error"]
    bad = []
    for o in shed_503:
        if o["retry_after"] is None or o["retry_after"] <= 0:
            bad.append(f"503 without positive Retry-After: {o['body']}")
        elif o["body"].get("reason") not in ("overloaded", "draining"):
            bad.append(f"503 with unexpected reason: {o['body']}")
    if not shed_503:
        bad.append(f"2x-overload burst of {n} produced no front-door 503 "
                   f"(deadline {deadline_s:.3f}s)")
    if len(done) + len(shed_503) + len(errs) != n:
        bad.append("some client reached no terminal state")
    report.update(overload_clients=n, overload_served=len(done),
                  overload_shed_503=len(shed_503),
                  overload_failed=len(errs))
    print(f"[serve_http] overload: {n} burst clients, deadline "
          f"{deadline_s * 1e3:.0f} ms -> {len(done)} served, "
          f"{len(shed_503)} shed at front door (503), {len(errs)} failed "
          f"in-engine")
    for why in bad:
        print(f"[serve_http] OVERLOAD SMOKE FAILED: {why}", file=sys.stderr)
    return 1 if bad else 0


async def _drain_smoke(host: str, port: int, report: Dict[str, Any]) -> int:
    """Drive the health machine through a graceful drain over HTTP and
    assert healthy → draining → drained plus 503s for late arrivals."""
    bad = []
    _, health = await _http_json(host, port, "GET", "/health")
    if health.get("state") != "healthy":
        bad.append(f"pre-drain state {health.get('state')!r} != 'healthy'")
    _, health = await _http_json(host, port, "POST", "/drain")
    if health.get("state") not in ("draining", "drained"):
        bad.append(f"post-drain state {health.get('state')!r}")
    late = await _sse_client(host, port, [1, 2, 3], 4)
    if late["status"] != 503 or late["body"].get("reason") != "draining":
        bad.append(f"late submit not shed with 503/draining: "
                   f"status={late['status']} body={late.get('body')}")
    deadline = time.perf_counter() + 10.0
    while time.perf_counter() < deadline:
        _, health = await _http_json(host, port, "GET", "/health")
        if health.get("state") == "drained":
            break
        await asyncio.sleep(0.05)
    if health.get("state") != "drained":
        bad.append(f"never reached 'drained' (stuck at {health.get('state')!r})")
    hist = health.get("history", [])
    for a, b in (("healthy", "draining"), ("draining", "drained")):
        if a in hist and b in hist and hist.index(a) < hist.index(b):
            continue
        bad.append(f"history missing transition {a} -> {b}: {hist}")
    print(f"[serve_http] drain: health history {' -> '.join(hist)}")
    report["health_history"] = hist
    for why in bad:
        print(f"[serve_http] DRAIN SMOKE FAILED: {why}", file=sys.stderr)
    return 1 if bad else 0


async def _smoke(frontend: HttpFrontend, host: str, port: int, args,
                 cfg, scfg) -> int:
    """Stream ``--smoke N`` requests through real HTTP and verify the
    streamed tokens byte-for-byte against the static baseline.  With
    ``--overload`` a 2x burst phase follows; a graceful-drain phase always
    runs last (it leaves the server refusing work)."""
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(1, cfg.vocab,
                           size=int(rng.randint(4, args.prompt_len + 1))
                           ).tolist()
               for _ in range(args.smoke)]
    t0 = time.perf_counter()
    outs = await asyncio.wait_for(asyncio.gather(*[
        _sse_client(host, port, p, args.gen) for p in prompts]),
        timeout=args.timeout_s)
    elapsed_s = time.perf_counter() - t0
    eng = frontend.serving.engine
    report = frontend.report
    bad = []
    for i, out in enumerate(outs):
        idx = [e["index"] for e in out["events"] if e["type"] == "token"]
        if out["final"]["type"] != "done":
            bad.append((i, f"terminal {out['final']}"))
        elif idx != list(range(len(idx))):
            bad.append((i, f"token indexes {idx} not 0..n-1 in order"))
        elif out["streamed"] != out["final"]["tokens"]:
            bad.append((i, "done-frame tokens differ from the stream"))
    streamed = [o["streamed"] for o in outs]
    n_tok = sum(map(len, streamed))
    with torch.no_grad():
        if eng.attn_backend == "reference":
            ref, _ = generate_static(cfg, eng.params, prompts, args.gen,
                                     scfg, batch_size=1)
            bad += [(i, f"streamed {got} != {want}")
                    for i, (got, want) in enumerate(zip(streamed, ref))
                    if not bad and got != want]
            exact = sum(a == b for t, u in zip(streamed, ref)
                        for a, b in zip(t, u))
            how = "exact vs the single-request static baseline"
        else:
            gate = dual_gate(
                [replay_logits(cfg, scfg, eng.params, p, t)
                 for p, t in zip(prompts, streamed)],
                [replay_logits(cfg, scfg, eng.params, p, t,
                               attn_backend=eng.attn_backend)
                 for p, t in zip(prompts, streamed)],
                streamed, tol=logit_tol(cfg))
            if not gate["ok"]:
                bad.append((-1, f"dual gate against the reference replay: "
                                f"max |dlogit| {gate['max_logit_err']:.4f} "
                                f"(tol {gate['tol']}), "
                                f"{gate['high_margin_mismatches']} "
                                f"high-margin mismatches"))
            exact = gate["greedy_equal_tokens"]
            report.update(max_logit_err=gate["max_logit_err"],
                          high_margin_tokens=gate["high_margin_tokens"],
                          high_margin_mismatches=gate[
                              "high_margin_mismatches"])
            how = ("held to the reference replay by the dual gate (max "
                   f"|dlogit| {gate['max_logit_err']:.4f}); tokens equal to "
                   "the replay's greedy token")
    status, snap = await _http_json(host, port, "GET", "/metrics")
    if status != 200 or "counters" not in snap:
        bad.append((-1, f"GET /metrics gave {status} without counters"))
    report.update(streams=len(outs), tokens=n_tok, exact_tokens=exact,
                  elapsed_s=elapsed_s, tokens_per_s=n_tok / elapsed_s,
                  client_ttft_p50_s=float(np.median(
                      [o["client_ttft_s"] for o in outs])),
                  overlap_staged=eng._m_overlap_staged.value,
                  overlap_used=eng._m_overlap_used.value,
                  overlap_dropped=eng._m_overlap_dropped.value)
    print(f"[serve_http] smoke: {len(outs)} requests streamed over HTTP, "
          f"{n_tok} tokens in {elapsed_s:.3f} s; client ttft p50 "
          f"{report['client_ttft_p50_s']*1e3:.1f} ms; "
          f"overlap staged/used/dropped "
          f"{eng._m_overlap_staged.value}/{eng._m_overlap_used.value}/"
          f"{eng._m_overlap_dropped.value}; /metrics {status}")
    if bad:
        for i, why in bad:
            print(f"[serve_http] SMOKE FAILED request {i}: {why}",
                  file=sys.stderr)
        return 1
    print(f"[serve_http] smoke verify OK: {len(outs)} streams complete, in "
          f"order, deduplicated; {exact}/{n_tok} tokens {how}")
    rc = 0
    if args.overload:
        # phase-1 wall time for N concurrent clients ≈ one admission wave's
        # service time — the deadline calibration for the burst
        rc |= await _overload_smoke(host, port, args, cfg, elapsed_s,
                                    report)
    rc |= await _drain_smoke(host, port, report)
    return rc


# --------------------------------------------------------------------- main


def build_engine(args, params=None) -> Tuple[Engine, Any, ServeConfig]:
    """The engine ``args`` describe, on ``args.device`` (random weights from
    ``args.seed`` unless ``params`` are given)."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    cfg = dataclasses.replace(cfg, remat="none")
    ps = args.page_size
    max_len = args.max_len or ((args.prompt_len + args.gen + ps - 1)
                               // ps) * ps
    scfg = ServeConfig(page_size=ps, max_slots=args.slots, max_len=max_len,
                       prefix_cache=args.prefix_cache,
                       attn_backend=args.attn_backend,
                       prefill_chunk_tokens=args.prefill_chunk_tokens,
                       admission_control=(args.admission_control
                                          or args.overload))
    tracer = Tracer()
    eng = Engine(cfg, scfg, params, seed=args.seed, tracer=tracer,
                 device=device)
    return eng, cfg, scfg


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs; cuda without a card exits "
                         "with an error")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="TCP port (0 = ephemeral; --smoke defaults to 0)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-request length cap (0 -> fitted to workload)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="workload sizing hint (max_len fit + smoke prompts)")
    ap.add_argument("--gen", type=int, default=16,
                    help="default max_new_tokens per request")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--attn-backend", choices=("auto", "reference", "hopper"),
                    default="auto")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0)
    ap.add_argument("--no-overlap", action="store_true",
                    help="drive the synchronous step() instead of the "
                         "overlapped pump()")
    ap.add_argument("--queue-size", type=int, default=256,
                    help="bounded collect-queue size (the backpressure knob)")
    ap.add_argument("--smoke", type=int, default=0, metavar="N",
                    help="self-test: stream N requests through HTTP, check "
                         "the streams, then drive a graceful drain; exit")
    ap.add_argument("--timeout-s", type=float, default=120.0,
                    help="with --smoke: the most a phase's streams may take "
                         "(a hang fails the smoke instead of blocking)")
    ap.add_argument("--admission-control", action="store_true",
                    help="enable deadline-aware admission shedding "
                         "(503 + Retry-After)")
    ap.add_argument("--overload", action="store_true",
                    help="with --smoke: add a 2x burst phase asserting the "
                         "shed contract (implies --admission-control)")
    ap.add_argument("--watchdog-s", type=float, default=0.0,
                    help="fail pending streams if the engine makes no "
                         "progress for this long (0 = off)")
    ap.add_argument("--trace", metavar="PATH", default="",
                    help="write the lifecycle trace (incl. host-pipeline "
                         "dispatch/stage/collect spans) on exit")
    ap.add_argument("--metrics-json", metavar="PATH", default="",
                    help="write the metrics-registry snapshot on exit")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def serve(eng: Engine, cfg, scfg, args) -> Tuple[int, Dict[str, Any]]:
    """Run the HTTP server over ``eng`` (the smoke with ``args.smoke``, else
    until interrupted); returns (exit code, the smoke's numbers)."""
    serving = ServingLoop(eng, overlap=not args.no_overlap,
                          collect_queue_size=args.queue_size,
                          watchdog_s=args.watchdog_s)
    frontend = HttpFrontend(serving, default_max_new=args.gen)
    port = args.port if not args.smoke else (args.port if args.port != 8080
                                             else 0)

    async def run() -> int:
        await serving.start()
        server = await asyncio.start_server(frontend.handle, args.host, port)
        bound = server.sockets[0].getsockname()[1]
        print(f"[serve_http] {cfg.name} on http://{args.host}:{bound} "
              f"(device {eng.device}, backend {eng.attn_backend}, "
              f"slots={scfg.max_slots}, max_len={scfg.max_len}, "
              f"overlap={'off' if args.no_overlap else 'on'}) — "
              f"POST /generate, GET /metrics, GET /health, POST /drain")
        rc = 0
        try:
            if args.smoke:
                rc = await _smoke(frontend, args.host, bound, args, cfg, scfg)
            else:
                async with server:
                    await server.serve_forever()
        finally:
            server.close()
            await server.wait_closed()
            await serving.stop()
        return rc

    try:
        rc = asyncio.run(run())
    except KeyboardInterrupt:
        rc = 0
    return rc, frontend.report


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        eng, cfg, scfg = build_engine(args)
    except RuntimeError as e:
        raise SystemExit(f"[serve_http] {e}")
    rc, _ = serve(eng, cfg, scfg, args)
    if args.trace:
        eng.tracer.save(args.trace)
        print(f"[serve_http] trace: {len(eng.tracer.events)} events -> "
              f"{args.trace}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(eng.metrics_snapshot(), f, indent=2, sort_keys=True)
        print(f"[serve_http] metrics -> {args.metrics_json}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
