"""Deadline-aware admission control and the serving health state machine
(a verbatim copy of ``repro.serving.admission``, which is framework-free).

Admission control answers one question at the front door: *given what the
engine has recently measured about itself, can this request plausibly meet
its deadline?*  If not, shedding it immediately (HTTP 503 + Retry-After)
is strictly better than letting it queue, time out mid-flight, and waste
the prefill work — the goodput-under-overload benchmark of the JAX package
(``benchmarks/serve_throughput.py``) quantifies exactly that trade.

The estimate is deliberately simple and self-calibrating: EWMAs of observed
per-step latency, TTFT, and total service time, combined as

    est_wait  = ceil(queue_depth / max_slots) * service_ewma
    est_ttft  = est_wait + ttft_ewma
    est_total = est_wait + service_ewma

A request is shed with reason ``"overloaded"`` when either estimate exceeds
the corresponding deadline.  Requests without deadlines are never shed by
the estimator (only by ``draining``).

:class:`HealthState` is the engine-owned lifecycle machine reported by
``GET /health``::

    starting ── healthy ── draining ── drained
        └──────┬───┘
            degraded ─────┘

Transitions outside the arrows are ignored (returns False), which makes the
mark_* helpers idempotent and safe to call from both the engine thread and
the event loop.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple


class HealthState:
    """Serving lifecycle: starting → healthy → degraded → draining → drained."""

    STATES = ("starting", "healthy", "degraded", "draining", "drained")
    _ALLOWED = {
        "starting": {"healthy", "degraded", "draining"},
        "healthy": {"degraded", "draining"},
        "degraded": {"draining"},
        "draining": {"drained"},
        "drained": set(),
    }

    def __init__(self, metrics=None):
        self.state = "starting"
        self.reason = ""
        self.history: List[str] = ["starting"]
        self._gauge = None
        if metrics is not None:
            self._gauge = metrics.gauge(
                "server.health_state",
                "Health state index (0=starting 1=healthy 2=degraded 3=draining 4=drained).",
            )
            self._gauge.set(0)

    def _to(self, new: str, reason: str = "") -> bool:
        if new == self.state:
            return False
        if new not in self._ALLOWED[self.state]:
            return False
        self.state = new
        self.reason = reason
        self.history.append(new)
        if self._gauge is not None:
            self._gauge.set(self.STATES.index(new))
        return True

    def mark_healthy(self) -> bool:
        return self._to("healthy")

    def mark_degraded(self, reason: str) -> bool:
        return self._to("degraded", reason)

    def begin_drain(self) -> bool:
        return self._to("draining", "drain requested")

    def mark_drained(self) -> bool:
        return self._to("drained")

    @property
    def draining(self) -> bool:
        return self.state in ("draining", "drained")

    @property
    def accepting(self) -> bool:
        return self.state in ("starting", "healthy", "degraded")

    def to_dict(self) -> Dict[str, object]:
        return {
            "state": self.state,
            "ok": self.state in ("starting", "healthy"),
            "reason": self.reason,
            "history": list(self.history),
        }


class AdmissionController:
    """Sheds requests whose deadlines the calibrated queue model can't meet."""

    def __init__(
        self,
        max_slots: int,
        metrics=None,
        seed: int = 0,
        step_s_prior: float = 0.05,
        ewma: float = 0.3,
    ):
        assert max_slots >= 1
        self.max_slots = max_slots
        self._ewma = ewma
        self._step_s = step_s_prior   # per-engine-step latency (always available)
        self._ttft_s: Optional[float] = None     # observed once results flow
        self._service_s: Optional[float] = None  # arrival → finish per request
        self._rng = random.Random(seed)
        self._m_shed = None
        if metrics is not None:
            self._m_shed = metrics.counter(
                "admission.shed",
                "Requests shed at admission, by reason.",
                labels=("reason",),
            )

    def _blend(self, old: Optional[float], new: float) -> float:
        return new if old is None else (1 - self._ewma) * old + self._ewma * new

    def observe_step(self, dt_s: float) -> None:
        self._step_s = self._blend(self._step_s, dt_s)

    def observe_result(self, ttft_s: Optional[float], service_s: Optional[float]) -> None:
        if ttft_s is not None and ttft_s > 0:
            self._ttft_s = self._blend(self._ttft_s, ttft_s)
        if service_s is not None and service_s > 0:
            self._service_s = self._blend(self._service_s, service_s)

    def estimate_queue_wait(self, queue_depth: int) -> float:
        """queue depth × calibrated service time, in admission waves."""
        if queue_depth <= 0:
            return 0.0
        if self._service_s is not None:
            waves = math.ceil(queue_depth / self.max_slots)
            return waves * self._service_s
        return queue_depth * self._step_s

    def check(
        self,
        queue_depth: int,
        deadline_s: Optional[float] = None,
        ttft_deadline_s: Optional[float] = None,
    ) -> Optional[str]:
        """Return a shed reason, or None to admit."""
        if deadline_s is None and ttft_deadline_s is None:
            return None
        wait = self.estimate_queue_wait(queue_depth)
        if ttft_deadline_s is not None:
            est_ttft = wait + (self._ttft_s if self._ttft_s is not None else self._step_s)
            if est_ttft > ttft_deadline_s:
                return "overloaded"
        if deadline_s is not None:
            est_total = wait + (self._service_s if self._service_s is not None else self._step_s)
            if est_total > deadline_s:
                return "overloaded"
        return None

    def note_shed(self, reason: str) -> None:
        if self._m_shed is not None:
            self._m_shed.labels(reason=reason).inc()

    def retry_after_s(self, queue_depth: int) -> float:
        """Backoff hint: estimated drain time with deterministic seeded jitter."""
        base = min(max(self.estimate_queue_wait(max(queue_depth, 1)), 0.05), 30.0)
        return base * (0.5 + self._rng.random())
