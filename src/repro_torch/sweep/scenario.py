"""Scenario specifications and the grid/draw compiler (DESIGN.md §13).

A *scenario* is one full federated-learning simulation: a seed, a
constellation geometry, a link rate, a trigger policy (via the strategy
table) and a staleness function, plus the simulation horizon knobs.  The
sweep engine (`sweep/driver.py`) runs *batches* of scenarios with their
fused epoch dispatches multiplexed into shared device programs
(`sweep/batch.py`), so a Monte-Carlo sweep of hundreds of configs costs a
handful of batched dispatches instead of hundreds of sequential runs.

Two compilers produce scenario batches:

* ``grid(**axes)`` — the cartesian product of explicit axis values
  (deterministic order: axes sorted by name, rightmost axis fastest);
* ``draw(n, axes, seed)`` — ``n`` independent draws, one value per axis
  per scenario, from a seeded ``numpy`` Generator (reproducible; the
  draw spec is what benchmark rows record).

Every axis must name a ``ScenarioSpec`` field; unknown axes raise at
compile time, not at run time inside a worker thread.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One simulation configuration, batchable alongside others.

    Geometry fields default to ``None`` = the paper constellation
    (``core.constellation.paper_constellation``); setting ``num_orbits``
    and ``sats_per_orbit`` builds an explicit WalkerDelta shell instead.
    ``strategy`` picks the trigger policy / aggregation rule from the
    ``fl.strategies`` table; ``staleness_fn`` / ``ps_channels`` /
    ``max_in_flight`` override that spec's fields when not None.
    """
    seed: int = 0
    strategy: str = "asyncfleo-gs"
    # geometry (None, None -> paper constellation)
    num_orbits: Optional[int] = None
    sats_per_orbit: Optional[int] = None
    altitude_m: float = 2000e3
    inclination_deg: float = 80.0
    # link + policy knobs
    rate_bps: float = 16e6
    staleness_fn: Optional[str] = None
    ps_channels: Optional[int] = None
    max_in_flight: Optional[int] = None
    # horizon
    duration_s: float = 86400.0
    dt_s: float = 60.0
    train_time_s: float = 300.0
    agg_timeout_s: float = 1500.0

    def geometry_key(self) -> tuple:
        """Hashable geometry identity (constellation cache key)."""
        return (self.num_orbits, self.sats_per_orbit, self.altitude_m,
                self.inclination_deg, self.duration_s, self.dt_s)


_FIELDS = {f.name for f in dataclasses.fields(ScenarioSpec)}


def _check_axes(axes: Dict[str, Sequence]) -> None:
    unknown = sorted(set(axes) - _FIELDS)
    if unknown:
        raise ValueError(f"unknown scenario axes {unknown}; "
                         f"valid fields: {sorted(_FIELDS)}")
    for name, vals in axes.items():
        if not len(list(vals)):
            raise ValueError(f"scenario axis {name!r} has no values")


def grid(base: Optional[ScenarioSpec] = None, **axes) -> List[ScenarioSpec]:
    """Cartesian product of axis values over ``base`` (axes sorted by
    name; the last-sorted axis varies fastest — deterministic order)."""
    _check_axes(axes)
    base = base or ScenarioSpec()
    names = sorted(axes)
    out = []
    for combo in itertools.product(*(list(axes[n]) for n in names)):
        out.append(dataclasses.replace(base, **dict(zip(names, combo))))
    return out


def draw(n: int, axes: Dict[str, Sequence], seed: int = 0,
         base: Optional[ScenarioSpec] = None) -> List[ScenarioSpec]:
    """``n`` scenarios with each axis drawn independently and uniformly
    from its value list by a seeded generator — the Monte-Carlo
    counterpart of :func:`grid`.  Same (axes, seed, n) -> same batch."""
    _check_axes(axes)
    if n <= 0:
        raise ValueError("draw needs n >= 1")
    base = base or ScenarioSpec()
    rng = np.random.default_rng(seed)
    names = sorted(axes)
    out = []
    for _ in range(n):
        picks = {name: list(axes[name])[int(rng.integers(len(list(axes[name]))))]
                 for name in names}
        out.append(dataclasses.replace(base, **picks))
    return out


def draw_spec(axes: Dict[str, Sequence], seed: int, n: int) -> Dict:
    """JSON-serializable record of a draw (what bench rows store)."""
    return {"kind": "draw", "n": int(n), "seed": int(seed),
            "axes": {k: list(v) for k, v in sorted(axes.items())}}
