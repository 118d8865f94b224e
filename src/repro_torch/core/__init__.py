"""Orbital geometry, timing, the model bank, aggregation, grouping and the
fused epoch loop (the ported part of ``repro.core``)."""
