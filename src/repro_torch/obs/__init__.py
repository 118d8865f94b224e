"""Observability (DESIGN.md §12), as the JAX package's ``repro.obs``:
structured tracing of the event runtime's round lifecycle, the metric
registry behind ``runtime.stats``, Perfetto/JSONL export and fused-
dispatch profiling.  Everything here is strictly read-only with respect
to simulation state — ``tracer=None`` / ``profiler=None`` runs are
bit-identical and pay nothing."""
from repro_torch.obs.export import (add_runtime_tracks, export_chrome,
                                    export_jsonl, validate_chrome_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricRegistry, StatsView)
from repro_torch.obs.profile import DispatchProfiler
from repro_torch.obs.trace import (NULL_TRACER, Instant, NullTracer, Span,
                                   Tracer)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "Instant",
    "Counter", "Gauge", "Histogram", "MetricRegistry", "StatsView",
    "DispatchProfiler",
    "export_chrome", "export_jsonl", "validate_chrome_trace",
    "add_runtime_tracks",
]
