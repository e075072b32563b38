"""Deterministic fault injection for the serving engine (a verbatim copy
of ``repro.serving.faults``, which is framework-free).

The serving stack's recovery paths (request quarantine, pool-pressure
survival, watchdog drain, disconnect cleanup) are only trustworthy if they
are exercised on every CI run, not just when hardware misbehaves.  This
module provides a seeded, declarative ``FaultPlan`` that the engine consults
at its seams, so a chaos run is exactly reproducible:

    plan = FaultPlan.parse("nan_logits:rid=1,at=2;step_error:rid=2,at=1")
    eng = Engine(cfg, scfg, params, faults=plan)

Fault taxonomy (``Fault.kind``):

``nan_logits``
    Poison the target request's exclusively-owned KV page (or state-slot
    row) with NaN right before the decode/verify launch at which it has
    produced exactly ``at`` tokens.  Masked attention is a zero-*weight*
    multiply, so the NaN propagates into that row's logits; the decode
    step reports a per-row finite flag and the engine quarantines the row.
``step_error``
    Raise :class:`RequestFault` at the host seam immediately *before* the
    decode/verify launch once the target has ``>= at`` tokens.  Raising
    before launch matters: the steps write the KV pool in place (the JAX
    engine donates it), so a post-launch exception would leave the pool
    half-written for everyone.  An exception raised *inside* a step remains
    fatal by design.
``pool_pressure``
    At engine tick ``at``, grab ``min(pages, free)`` pages from the pool and
    hold them for ``steps`` ticks, forcing eviction/preemption churn.  If
    the scheduler deadlocks (no progress possible), the engine asks the
    injector to release the hostage pages and retries once.
``client_disconnect``
    After the target rid has streamed ``at`` tokens, cancel it as if the
    client vanished.  The cancel is deferred to the top of the next
    dispatch — mutating slots mid-collect is unsafe.
``detok_stall``
    Sleep ``stall_s`` seconds inside the detokenizer worker at its ``at``-th
    token event, exercising backpressure and (with a watchdog armed) the
    hung-pipeline recovery path.

All faults are one-shot; :meth:`FaultPlan.unfired` lets ``--verify`` assert
the plan actually executed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

FAULT_KINDS = (
    "nan_logits",
    "step_error",
    "pool_pressure",
    "client_disconnect",
    "detok_stall",
)


class RequestFault(RuntimeError):
    """A fault attributable to a single request (raised pre-launch)."""

    def __init__(self, rid: int, kind: str):
        super().__init__(f"injected {kind} for rid={rid}")
        self.rid = rid
        self.kind = kind


@dataclasses.dataclass
class Fault:
    """One injected fault.  Field meaning depends on ``kind`` (see module doc)."""

    kind: str
    rid: int = -1       # target request id (nan_logits/step_error/client_disconnect)
    at: int = 1         # token count / engine tick / detok event index trigger
    pages: int = 0      # pool_pressure: pages to hold
    steps: int = 1      # pool_pressure: ticks to hold them
    stall_s: float = 0.0  # detok_stall: sleep duration
    fired: bool = dataclasses.field(default=False, compare=False)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.kind == "nan_logits" and self.at < 1:
            # Token 0 comes from prefill (checked host-side); the poison seam
            # only exists once the request is decoding.
            raise ValueError("nan_logits requires at >= 1")
        if self.kind == "pool_pressure" and self.pages < 1:
            raise ValueError("pool_pressure requires pages >= 1")
        if self.kind == "detok_stall" and self.stall_s <= 0:
            raise ValueError("detok_stall requires stall_s > 0")

    def describe(self) -> str:
        parts = [f"rid={self.rid}", f"at={self.at}"]
        if self.kind == "pool_pressure":
            parts = [f"at={self.at}", f"pages={self.pages}", f"steps={self.steps}"]
        if self.kind == "detok_stall":
            parts = [f"at={self.at}", f"stall_s={self.stall_s}"]
        return f"{self.kind}:{','.join(parts)}"


@dataclasses.dataclass
class FaultPlan:
    """A deterministic, ordered set of faults for one serve run."""

    faults: List[Fault] = dataclasses.field(default_factory=list)
    seed: int = 0

    @staticmethod
    def parse(spec: str, seed: int = 0) -> "FaultPlan":
        """Parse ``"kind:k=v,k=v;kind2:k=v"`` into a plan.

        Keys: ``rid``, ``at``, ``pages``, ``steps`` (ints) and ``stall_s``
        (float).  Example: ``"nan_logits:rid=1,at=2;pool_pressure:at=2,pages=4"``.
        """
        faults: List[Fault] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            kind, _, rest = part.partition(":")
            kwargs = {}
            for kv in filter(None, (s.strip() for s in rest.split(","))):
                key, _, val = kv.partition("=")
                if key == "stall_s":
                    kwargs[key] = float(val)
                elif key in ("rid", "at", "pages", "steps"):
                    kwargs[key] = int(val)
                else:
                    raise ValueError(f"unknown fault field {key!r} in {part!r}")
            faults.append(Fault(kind=kind.strip(), **kwargs))
        if not faults:
            raise ValueError(f"empty fault plan spec: {spec!r}")
        return FaultPlan(faults=faults, seed=seed)

    def unfired(self) -> List[str]:
        return [f.describe() for f in self.faults if not f.fired]


class FaultInjector:
    """Engine-side executor for a :class:`FaultPlan`.

    The engine calls the seam hooks below; each fault fires at most once.
    All counters land in ``engine.faults_injected{kind=...}``.
    """

    def __init__(self, plan: FaultPlan, metrics):
        self.plan = plan
        self._tick = 0
        self._held: List[int] = []       # pool_pressure hostage pages
        self._release_at = -1
        self._pending_cancels: List[int] = []
        self._detok_events = 0
        self._m_injected = metrics.counter(
            "engine.faults_injected",
            "Faults fired by the injection harness, by kind.",
            labels=("kind",),
        )

    def _fire(self, fault: Fault) -> None:
        fault.fired = True
        self._m_injected.labels(kind=fault.kind).inc()

    def unfired(self) -> List[str]:
        return self.plan.unfired()

    # ---- engine seams ----------------------------------------------------

    def on_tick(self, engine) -> None:
        """Top of ``_dispatch_next``: tick clock, pressure, deferred cancels."""
        self._tick += 1
        for rid in self._pending_cancels:
            engine.cancel(rid)
        self._pending_cancels.clear()
        pool = engine.pool
        if self._held and self._tick >= self._release_at:
            self.release_pressure(engine)
        for f in self.plan.faults:
            if f.fired or f.kind != "pool_pressure" or self._tick < f.at:
                continue
            if not pool.spec.paged:
                self._fire(f)  # state-slot pools have no page pool to squeeze
                continue
            grab = min(f.pages, pool.num_free)
            if grab > 0:
                held = pool.alloc(grab)
                assert held is not None
                self._held.extend(held)
            self._release_at = self._tick + max(f.steps, 1)
            self._fire(f)

    def release_pressure(self, engine) -> bool:
        """Release hostage pages (deadlock recovery / drain).  True if any."""
        if not self._held:
            return False
        engine.pool.release(self._held)
        self._held = []
        return True

    def before_launch(self, engine, kind: str, rows: List[int]) -> None:
        """Immediately before a decode/verify launch over slot indices ``rows``.

        May raise :class:`RequestFault` (step_error) or poison a row's KV
        (nan_logits).  Only the decode/verify seam is used: the donated
        buffers are still intact here, and prefill batches commit multiple
        admissions at once, which a single-request fault must not strand.
        """
        if kind not in ("decode", "verify"):
            return
        for f in self.plan.faults:
            if f.fired or f.kind not in ("step_error", "nan_logits"):
                continue
            for i in rows:
                slot = engine.sched.slots[i]
                if slot is None or slot.req.rid != f.rid:
                    continue
                n = len(slot.req.generated)
                if f.kind == "step_error" and n >= f.at:
                    self._fire(f)
                    raise RequestFault(f.rid, "step_error")
                if f.kind == "nan_logits" and n == f.at:
                    engine.poison_slot(i)
                    self._fire(f)

    def on_token(self, rid: int, index: int) -> None:
        """After a token is emitted for ``rid`` (its ``index``-th token)."""
        for f in self.plan.faults:
            if f.fired or f.kind != "client_disconnect" or f.rid != rid:
                continue
            if index + 1 >= f.at:
                self._pending_cancels.append(rid)
                self._fire(f)

    def on_detok(self, sleep_fn) -> None:
        """Inside the detokenizer worker, once per token event."""
        self._detok_events += 1
        for f in self.plan.faults:
            if f.fired or f.kind != "detok_stall":
                continue
            if self._detok_events >= f.at:
                self._fire(f)
                sleep_fn(f.stall_s)

    def on_drain(self, engine) -> None:
        self.release_pressure(engine)
