"""Percentile reduction over per-scenario sweep results.

Monte-Carlo claims report bands, not point estimates: each swept cell
reduces its scenarios' metrics to p10/p50/p90 (numpy ``percentile`` with
linear interpolation — deterministic for a deterministic batch).  A
scenario that never reaches the target has ``convergence_delay_s=None``;
those are excluded from the band and counted in ``n_failed`` so a cell
that "converges fast, 40% of the time" cannot masquerade as fast.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

BAND_PS = (10, 50, 90)


def percentile_bands(values: Iterable[Optional[float]],
                     ps: Sequence[int] = BAND_PS) -> Dict:
    """{"p10": ..., "p50": ..., "p90": ..., "n": ..., "n_failed": ...}
    over ``values``; Nones are failures, excluded from the percentiles.
    An all-None (or empty) input yields None bands."""
    vals = [v for v in values if v is not None]
    n_failed = sum(1 for v in values if v is None)
    out: Dict = {"n": len(vals) + n_failed, "n_failed": n_failed}
    if not vals:
        out.update({f"p{p}": None for p in ps})
        return out
    arr = np.asarray(vals, np.float64)
    for p in ps:
        out[f"p{p}"] = float(np.percentile(arr, p))
    return out


def reduce_results(results: Sequence) -> Dict:
    """Band summary over a list of ``driver.ScenarioResult``:
    convergence delay, epochs-to-target, final accuracy, aggregations."""
    return {
        "convergence_delay_s": percentile_bands(
            [r.convergence_delay_s for r in results]),
        "epochs_to_target": percentile_bands(
            [None if r.convergence_delay_s is None else float(r.epochs)
             for r in results]),
        "final_accuracy": percentile_bands(
            [r.final_accuracy for r in results]),
        "aggregations": percentile_bands(
            [float(r.epochs) for r in results]),
    }
