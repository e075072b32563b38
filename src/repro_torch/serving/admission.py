"""The serving health state machine (the part of ``repro.serving.admission``
the engine needs; deadline-aware admission control arrives with the
overload-control slice, ROADMAP queue 1 item 9).

:class:`HealthState` is the engine-owned lifecycle machine::

    starting ── healthy ── draining ── drained
        └──────┬───┘
            degraded ─────┘

Transitions outside the arrows are ignored (returns False), which makes the
mark_* helpers idempotent.
"""

from __future__ import annotations

from typing import Dict, List


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
