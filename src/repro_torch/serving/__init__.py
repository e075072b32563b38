"""repro_torch.serving — the continuous-batching engine of the port.

``kv_pool`` (paged KV pool on the device, host-side page accounting),
``radix_cache`` (page-quantized prefix cache), ``scheduler`` (admission,
chunked prefill, growth, preemption), ``speculate`` and ``telemetry`` are
the host-side layers of ``repro.serving`` (the last four verbatim copies);
``engine`` drives the model steps on the device, and ``parity`` holds the
teacher-forced replay and dual gate that compare two backends or two
frameworks.
"""
from __future__ import annotations

from .admission import HealthState  # noqa: F401
from .engine import Engine, RequestResult, generate_static  # noqa: F401
from .kv_pool import NULL_PAGE, PagedKVPool  # noqa: F401
from .parity import dual_gate, replay_logits  # noqa: F401
from .radix_cache import MatchResult, RadixCache  # noqa: F401
from .scheduler import Admission, Request, Scheduler  # noqa: F401
from .telemetry import (  # noqa: F401
    MetricsRegistry, Tracer, shared_metrics, validate_trace)
