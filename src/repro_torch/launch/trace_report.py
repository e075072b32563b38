"""Offline analyzer for serving traces written by ``serve --trace``.

  PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json
  PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json \\
      --validate

(A verbatim copy of ``repro.launch.trace_report`` over the port's copy of
``serving.telemetry``.)

Reads the Chrome-trace-event JSON emitted by ``serving.telemetry.Tracer``
and prints:

* a time-in-phase breakdown over the engine step track — prefill /
  chunked-prefill / restore / decode device time, the host-scheduling gap
  (wall clock not covered by any step span), and the decode-stall share
  (non-decode steps that ran while decode-ready slots were parked behind
  them, i.e. step spans carrying ``decode_waiting=True``);
* a per-request table (TTFT, total latency, TPOT, tokens, prefill chunks,
  preemptions) read from each request's terminal ``finished`` instant;
* a failure summary — terminal errors (quarantine, cancel, deadline) and
  rejections (admission sheds, no_budget) counted by cause — when any
  request did not finish cleanly.

``--validate`` additionally runs the well-formedness checker
(``telemetry.validate_trace``: monotonic finite timestamps, proper span
nesting per track, every admitted request reaching a terminal event) and
exits nonzero if anything is off — CI runs it on every trace artifact.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from ..serving.telemetry import ENGINE_PID, HOST_TID, REQUEST_PID, \
    percentile, validate_trace

# engine phases in display order; anything else lands in "other".
# "verify" is the speculative small-q decode step (draft + bonus token in
# one launch) — it *serves* decode-ready slots, so the stall computation
# below exempts it exactly like plain decode
PHASES = ("prefill", "prefill_chunk", "restore", "decode", "verify")
# overlapped host-pipeline phases (ENGINE_PID, tid=HOST_TID), Engine.pump()
HOST_PHASES = ("dispatch", "stage", "collect")


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def phase_breakdown(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Time-in-phase sums (seconds) over the engine step track.

    ``wall_s`` spans first event start to last event end; ``host_s`` is the
    wall time no step span covers (scheduler decisions, admission matching,
    host-side bookkeeping); ``stall_s`` is the part of non-decode phases
    that ran with decode-ready slots waiting."""
    spans = [e for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("pid") == ENGINE_PID
             and e.get("tid", 0) == 0]    # step track only: the overlapped
                                          # host pipeline reports separately
    per = {p: 0.0 for p in PHASES}
    counts = {p: 0 for p in PHASES}
    stall = other = 0.0
    lo, hi = float("inf"), 0.0
    for e in spans:
        dur = e.get("dur", 0.0) / 1e6
        name = e.get("name")
        lo = min(lo, e["ts"] / 1e6)
        hi = max(hi, (e["ts"] + e.get("dur", 0.0)) / 1e6)
        if name in per:
            per[name] += dur
            counts[name] += 1
        else:
            other += dur
        if name not in ("decode", "verify") \
                and e.get("args", {}).get("decode_waiting"):
            stall += dur
    wall = (hi - lo) if spans else 0.0
    stepped = sum(per.values()) + other
    return {"wall_s": wall, "per_phase_s": per, "counts": counts,
            "other_s": other, "host_s": max(wall - stepped, 0.0),
            "stall_s": stall, "n_steps": len(spans)}


def host_pipeline(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Overlapped host-pipeline sums (``Engine.pump()``): time in the
    dispatch / stage / collect halves on the (ENGINE_PID, HOST_TID) track.
    Empty dict when the run was synchronous (no host track emitted)."""
    per = {p: 0.0 for p in HOST_PHASES}
    counts = {p: 0 for p in HOST_PHASES}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("pid") == ENGINE_PID \
                and e.get("tid") == HOST_TID and e.get("name") in per:
            per[e["name"]] += e.get("dur", 0.0) / 1e6
            counts[e["name"]] += 1
    if not any(counts.values()):
        return {}
    return {"per_phase_s": per, "counts": counts}


def request_rows(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    rows = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "i" and e.get("name") == "finished" \
                and e.get("pid") == REQUEST_PID:
            rows.append({"rid": e.get("tid"), **e.get("args", {})})
    rows.sort(key=lambda r: r["rid"])
    return rows


def failure_summary(trace: Dict[str, Any]) -> Dict[str, int]:
    """Terminal failures by cause: ``finished`` instants carrying an
    ``error`` arg (quarantine/cancel/deadline) and ``rejected`` instants by
    reason (admission sheds, no_budget, deadline_exceeded in queue)."""
    counts: Dict[str, int] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "i" or e.get("pid") != REQUEST_PID:
            continue
        args = e.get("args", {})
        if e.get("name") == "finished" and args.get("error"):
            key = f"failed:{args['error']}"
        elif e.get("name") == "rejected":
            key = f"rejected:{args.get('reason', 'unknown')}"
        else:
            continue
        counts[key] = counts.get(key, 0) + 1
    return counts


def report(trace: Dict[str, Any]) -> str:
    out = []
    bd = phase_breakdown(trace)
    wall = bd["wall_s"] or 1e-12
    out.append(f"engine steps: {bd['n_steps']}   "
               f"wall {bd['wall_s']*1e3:.1f} ms")
    out.append("time in phase:")
    for p in PHASES:
        s = bd["per_phase_s"][p]
        out.append(f"  {p:<14} {s*1e3:9.1f} ms  {s/wall*100:5.1f}%  "
                   f"({bd['counts'][p]} steps)")
    if bd["other_s"]:
        out.append(f"  {'other':<14} {bd['other_s']*1e3:9.1f} ms  "
                   f"{bd['other_s']/wall*100:5.1f}%")
    out.append(f"  {'host-sched':<14} {bd['host_s']*1e3:9.1f} ms  "
               f"{bd['host_s']/wall*100:5.1f}%  (wall not in any step)")
    out.append(f"  {'decode-stall':<14} {bd['stall_s']*1e3:9.1f} ms  "
               f"{bd['stall_s']/wall*100:5.1f}%  "
               f"(non-decode steps with decode ready)")

    hp = host_pipeline(trace)
    if hp:
        out.append("host pipeline (overlapped dispatch/stage/collect):")
        for p in HOST_PHASES:
            s = hp["per_phase_s"][p]
            out.append(f"  {p:<14} {s*1e3:9.1f} ms  {s/wall*100:5.1f}%  "
                       f"({hp['counts'][p]} spans)")

    rows = request_rows(trace)
    if rows:
        ttfts = [r.get("ttft_s", 0.0) for r in rows]
        tpots = [r.get("tpot_s", 0.0) for r in rows]
        out.append("")
        out.append(f"requests: {len(rows)}   "
                   f"ttft p50 {percentile(ttfts, 50)*1e3:.1f} / "
                   f"p95 {percentile(ttfts, 95)*1e3:.1f} ms   "
                   f"tpot p50 {percentile(tpots, 50)*1e3:.2f} ms")
        out.append(f"  {'rid':>4} {'ttft_ms':>9} {'finish_ms':>10} "
                   f"{'tpot_ms':>8} {'toks':>5} {'chunks':>6} {'preempt':>7}")
        for r in rows:
            out.append(
                f"  {r['rid']:>4} {r.get('ttft_s', 0.0)*1e3:>9.1f} "
                f"{r.get('finish_s', 0.0)*1e3:>10.1f} "
                f"{r.get('tpot_s', 0.0)*1e3:>8.2f} "
                f"{r.get('n_tokens', 0):>5} "
                f"{r.get('n_prefill_chunks', 0):>6} "
                f"{r.get('n_preemptions', 0):>7}")

    failures = failure_summary(trace)
    if failures:
        total = sum(failures.values())
        detail = ", ".join(f"{k}={v}" for k, v in sorted(failures.items()))
        out.append("")
        out.append(f"failures: {total} requests did not finish cleanly "
                   f"({detail})")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="Chrome-trace JSON from serve --trace")
    ap.add_argument("--validate", action="store_true",
                    help="run the well-formedness checker; exit nonzero on "
                         "any problem")
    args = ap.parse_args(argv)

    trace = load(args.trace)
    print(report(trace))
    if args.validate:
        problems = validate_trace(trace)
        if problems:
            print(f"\n[trace_report] INVALID trace "
                  f"({len(problems)} problems):", file=sys.stderr)
            for p in problems:
                print(f"  - {p}", file=sys.stderr)
            return 1
        print(f"\n[trace_report] trace valid "
              f"({len(trace.get('traceEvents', []))} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
