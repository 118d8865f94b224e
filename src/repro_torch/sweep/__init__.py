"""Batched scenario engine (DESIGN.md §13), as the JAX package's
``repro.sweep``: Monte-Carlo sweeps over seeds / geometry / link rates /
trigger policies / staleness functions run as a handful of shared
physical epoch steps instead of sequential runs, with percentile-band
reduction — and a differential parity contract pinning batched ==
sequential bit-identically."""
from repro_torch.sweep.batch import BatchedProgram, DispatchBatcher
from repro_torch.sweep.driver import ScenarioResult, run_scenarios
from repro_torch.sweep.scenario import ScenarioSpec, draw, draw_spec, grid
from repro_torch.sweep.stats import percentile_bands, reduce_results
from repro_torch.sweep.testbed import (ConvergingTrainer,
                                       MeanDistanceEvaluator, make_model)

__all__ = [
    "BatchedProgram", "DispatchBatcher", "ScenarioResult", "ScenarioSpec",
    "ConvergingTrainer", "MeanDistanceEvaluator", "make_model",
    "draw", "draw_spec", "grid", "percentile_bands", "reduce_results",
    "run_scenarios",
]
