"""repro_torch.serving — the continuous-batching engine of the port.

``kv_pool`` (paged KV pool and state-slot pool on the device, host-side
accounting), ``radix_cache`` (page-quantized prefix cache), ``scheduler``
(admission, chunked prefill, growth, preemption), ``speculate`` and
``telemetry`` are the host-side layers of ``repro.serving`` (the last four
verbatim copies);
``engine`` drives the model steps on the device (synchronously with
``step()``, or overlapped with ``pump()``: step N+1's plan staged while
step N runs), and ``parity`` holds the teacher-forced replay and dual gate
that compare two backends, two frameworks, or an int8 pool with a bf16 one.
``server`` (``ServingLoop``: the engine on its own thread, tokens streamed
into asyncio queues, a watchdog, a graceful drain), ``faults`` (the
seeded fault-injection plan) and ``admission`` (deadline-aware admission
control and the health state machine) are copies of their ``repro``
counterparts, the first with its engine thread adapted to PyTorch.
"""
from __future__ import annotations

from .admission import AdmissionController, HealthState  # noqa: F401
from .engine import Engine, RequestResult, generate_static  # noqa: F401
from .faults import (  # noqa: F401
    FAULT_KINDS, Fault, FaultInjector, FaultPlan, RequestFault)
from .kv_pool import NULL_PAGE, PagedKVPool, StateSlotPool  # noqa: F401
from .parity import (dual_gate, dual_gate_verify,  # noqa: F401
                     format_report, logit_tol, replay_logits)
from .radix_cache import MatchResult, RadixCache  # noqa: F401
from .scheduler import Admission, Request, Scheduler  # noqa: F401
from .server import ServingLoop, detokenize, stream_request  # noqa: F401
from .speculate import (NgramProposer, accept_length,  # noqa: F401
                        speculation_k)
from .telemetry import (  # noqa: F401
    MetricsRegistry, Tracer, percentile, shared_metrics, validate_trace)
