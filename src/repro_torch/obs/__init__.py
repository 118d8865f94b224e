"""Observability (DESIGN.md §12), as the JAX package's ``repro.obs``:
structured tracing of the event runtime's round lifecycle and the metric
registry behind ``runtime.stats``.  Both are strictly read-only with
respect to simulation state — ``tracer=None`` runs are bit-identical and
pay nothing.  The exporters (``obs/export``) and the dispatch profiler
(``obs/profile``) come with ROADMAP queue A item 11."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricRegistry, StatsView)
from repro_torch.obs.trace import (NULL_TRACER, Instant, NullTracer, Span,
                                   Tracer)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "Instant",
    "Counter", "Gauge", "Histogram", "MetricRegistry", "StatsView",
]
