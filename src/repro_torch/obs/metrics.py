"""Metric registry: counters, gauges, bounded histograms (DESIGN.md §12),
as the JAX package's ``repro.obs.metrics``.

The registry is the single backing store for what used to be ad-hoc
telemetry dicts: `EventDrivenRuntime.stats` becomes a
:class:`StatsView` over a :class:`MetricRegistry` (the old dict keys
keep working, read and write), and `ChannelPool` queue-wait telemetry
feeds a histogram so `contention` bench blocks report percentiles, not
just totals.

Histograms are **bounded and deterministic**: the sample buffer keeps
every ``stride``-th observation and, on reaching ``max_samples``,
decimates itself (drop every other retained sample, double the stride)
— no RNG, so two identical runs summarize identically, and memory is
O(max_samples) no matter how many observations arrive.  ``count`` /
``sum`` / ``min`` / ``max`` stay exact; p50/p95/p99 are computed over
the retained samples.
"""
from __future__ import annotations

import dataclasses
from collections.abc import MutableMapping
from typing import Dict, Iterator, List, Optional, Sequence


@dataclasses.dataclass
class Counter:
    """Monotonic count (resettable only via the registry)."""
    name: str
    value: float = 0

    def inc(self, amount: float = 1) -> None:
        self.value += amount


@dataclasses.dataclass
class Gauge:
    """Last-written value (e.g. peak in-flight depth via ``set_max``)."""
    name: str
    value: float = 0

    def set(self, value: float) -> None:
        self.value = value

    def set_max(self, value: float) -> None:
        if value > self.value:
            self.value = value


class Histogram:
    """Bounded deterministic histogram with exact count/sum/min/max.

    Keeps at most ``max_samples`` observations for percentile
    estimation by stride-decimation: observation ``i`` is retained iff
    ``i % stride == 0``, and when the buffer fills the stride doubles
    and every other retained sample is dropped.  Early observations are
    never privileged over late ones beyond the uniform stride, and no
    randomness is involved.
    """

    def __init__(self, name: str, max_samples: int = 1024):
        if max_samples < 2:
            raise ValueError("max_samples must be >= 2")
        self.name = name
        self.max_samples = int(max_samples)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []
        self._stride = 1

    def observe(self, value: float) -> None:
        v = float(value)
        if self.count == 0 or v < self.min:
            self.min = v
        if self.count == 0 or v > self.max:
            self.max = v
        if self.count % self._stride == 0:
            if len(self._samples) >= self.max_samples:
                self._samples = self._samples[::2]
                self._stride *= 2
            if self.count % self._stride == 0:
                self._samples.append(v)
        self.count += 1
        self.sum += v

    def percentile(self, q: float) -> Optional[float]:
        """Linear-interpolated percentile over the retained samples
        (None when empty).  ``q`` in [0, 100]."""
        if not self._samples:
            return None
        xs = sorted(self._samples)
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> Dict:
        """JSON-serializable summary (min/max/percentiles None when
        empty) — the compat-view representation of histogram stats."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    @property
    def samples(self) -> Sequence[float]:
        return tuple(self._samples)


class MetricRegistry:
    """Flat namespace of counters, gauges, and histograms.

    ``counter``/``gauge``/``histogram`` are get-or-create; ``inc`` /
    ``set_gauge`` / ``observe`` are the write shorthands call sites
    use.  ``snapshot`` renders everything to plain JSON-serializable
    values (histograms as their summary dict)."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    # ---- get-or-create -----------------------------------------------------

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, max_samples: int = 1024) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, max_samples)
        return h

    # ---- write shorthands --------------------------------------------------

    def inc(self, name: str, amount: float = 1) -> None:
        self.counter(name).inc(amount)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    # ---- read --------------------------------------------------------------

    def get(self, name: str):
        """The rendered value of a metric by name (counters/gauges →
        number, histograms → summary dict); KeyError when absent."""
        if name in self.counters:
            return self.counters[name].value
        if name in self.gauges:
            return self.gauges[name].value
        if name in self.histograms:
            return self.histograms[name].summary()
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return (name in self.counters or name in self.gauges
                or name in self.histograms)

    def names(self) -> List[str]:
        return (list(self.counters) + list(self.gauges)
                + list(self.histograms))

    def snapshot(self) -> Dict:
        return {n: self.get(n) for n in self.names()}


class StatsView(MutableMapping):
    """The legacy ``runtime.stats`` dict as a live view over a registry.

    Existing call sites keep working unchanged — ``stats[k] += 1``,
    ``stats.get(k, 0)``, ``dict(stats)``, ``json.dump`` — but every
    read reflects the registry, so the dict and the registry can never
    drift.  Keys listed in ``histogram_keys`` render as histogram
    summary dicts (bounded; the fix for the unbounded
    ``backoff_delays_s`` list) and reject writes; integer-like counter
    values render as ``int`` so JSON artifacts keep their old shape.
    Unknown-key writes create counters, so policy hooks that invent
    keys (e.g. ``shrunk_windows``) still work.
    """

    def __init__(self, registry: MetricRegistry,
                 counter_keys: Sequence[str] = (),
                 histogram_keys: Sequence[str] = ()):
        self._registry = registry
        self._histogram_keys = tuple(histogram_keys)
        for k in counter_keys:
            registry.counter(k)
        for k in histogram_keys:
            registry.histogram(k)

    @property
    def registry(self) -> MetricRegistry:
        return self._registry

    def _render(self, key: str):
        v = self._registry.get(key)
        if isinstance(v, float) and v.is_integer() \
                and key not in self._registry.gauges:
            return int(v)
        return v

    def __getitem__(self, key: str):
        if key not in self._registry:
            raise KeyError(key)
        return self._render(key)

    def __setitem__(self, key: str, value) -> None:
        if key in self._histogram_keys:
            raise TypeError(
                f"{key!r} is histogram-backed; use "
                f"registry.observe({key!r}, v) instead of assignment")
        if key in self._registry.gauges:
            self._registry.gauges[key].set(value)
        else:
            self._registry.counter(key).value = value

    def __delitem__(self, key: str) -> None:
        raise TypeError("StatsView keys cannot be deleted")

    def __iter__(self) -> Iterator[str]:
        return iter(self._registry.names())

    def __len__(self) -> int:
        return len(self._registry.names())

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"
