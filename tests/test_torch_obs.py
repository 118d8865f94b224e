"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``): the same call sequences give the same
registry snapshots, histogram summaries (exact and decimated), StatsView
renderings and tracer buffers.  All of it is pure Python, so equality is
exact."""
import dataclasses
import random

import pytest

from repro.obs import metrics as jm
from repro.obs import trace as jt
from repro_torch.obs import metrics as tm
from repro_torch.obs import trace as tt


def _values(seed, n):
    rng = random.Random(seed)
    return [rng.choice([rng.uniform(-5.0, 5.0), float(rng.randint(0, 9)),
                        0.0, 1e-9]) for _ in range(n)]


@pytest.mark.parametrize("n,max_samples", [(0, 1024), (1, 1024), (7, 4),
                                           (1000, 64), (5000, 1024),
                                           (4097, 2)])
def test_histogram_summary_and_samples_equal(n, max_samples):
    """Below and past ``max_samples``: the stride decimation keeps the
    same samples, so every percentile agrees, and the aggregates are
    exact on both sides."""
    a, b = tm.Histogram("w", max_samples), jm.Histogram("w", max_samples)
    for v in _values(n, n):
        a.observe(v)
        b.observe(v)
    assert a.summary() == b.summary()
    assert a.samples == b.samples
    assert len(a.samples) <= max_samples
    for q in (0.0, 12.5, 50.0, 99.9, 100.0):
        assert a.percentile(q) == b.percentile(q)


def test_histogram_validation_matches():
    for mod in (tm, jm):
        with pytest.raises(ValueError):
            mod.Histogram("w", max_samples=1)


def _drive_registry(mod, seed):
    """One random sequence of registry and StatsView writes."""
    rng = random.Random(seed)
    reg = mod.MetricRegistry()
    st = mod.StatsView(reg, counter_keys=("a", "b", "peak"),
                       histogram_keys=("h",))
    reg.gauge("g")
    for _ in range(300):
        op = rng.randrange(7)
        key = rng.choice("abcxyz")
        if op == 0:
            reg.inc(key, rng.choice([1, 2, 0.5]))
        elif op == 1:
            st[key] = st.get(key, 0) + 1
        elif op == 2:
            reg.observe(rng.choice(["h", "q"]), rng.uniform(0, 3))
        elif op == 3:
            reg.gauge("g").set_max(rng.uniform(0, 10))
        elif op == 4:
            st["g"] = rng.randint(0, 4)
        elif op == 5:
            st["peak"] = max(st["peak"], rng.randint(0, 5))
        else:
            reg.set_gauge("lvl", rng.uniform(-1, 1))
    return reg, st


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_stats_view_equal(seed):
    treg, tst = _drive_registry(tm, seed)
    jreg, jst = _drive_registry(jm, seed)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.names() == jreg.names()
    assert dict(tst) == dict(jst)
    assert repr(tst) == repr(jst)
    assert [type(v) for v in dict(tst).values()] == \
        [type(v) for v in dict(jst).values()]
    assert len(tst) == len(jst) and list(tst) == list(jst)


def test_stats_view_refusals_match():
    for mod in (tm, jm):
        st = mod.StatsView(mod.MetricRegistry(), counter_keys=("a",),
                           histogram_keys=("h",))
        with pytest.raises(TypeError):
            st["h"] = 1
        with pytest.raises(TypeError):
            del st["a"]
        with pytest.raises(KeyError):
            st["missing"]


def _drive_tracer(mod):
    t = mod.Tracer()
    h0 = t.begin(mod.SPAN_ROUND, 10.0, track="round 0", source=1)
    t.instant(mod.EV_ARRIVAL, 12.0, track="round 0", sat=3)
    h1 = t.begin(mod.SPAN_ROUND, 11.0, track="round 1", sink=2)
    t.span(mod.SPAN_RECRUIT, 10.0, 11.5, track="round 0", participants=4)
    t.span(mod.SPAN_TRIGGER, 30.0, 20.0, track="round 1")   # clamped end
    t.end(h0, 20.0, committed=True)
    t.end(h0, 25.0)                                  # already closed
    t.end(999, 5.0)                                  # unknown handle
    h2 = t.begin("x", 50.0, track="round 2")
    t.instant(mod.EV_COMMIT, 40.0, track="round 1", epoch=0)
    tracks_open = t.tracks()
    t.close_open_spans(45.0)                         # h2 clamps to 50
    return t, (h0, h1, h2), tracks_open


def _rows(tracer):
    return ([dataclasses.astuple(s) for s in tracer.spans],
            [dataclasses.astuple(i) for i in tracer.instants])


def test_tracer_buffers_equal():
    tt_, th, ttracks = _drive_tracer(tt)
    jt_, jh, jtracks = _drive_tracer(jt)
    assert th == jh and ttracks == jtracks
    assert _rows(tt_) == _rows(jt_)
    assert [s.duration for s in tt_.spans] == [s.duration for s in jt_.spans]
    assert tt_.tracks() == jt_.tracks()
    tt_.clear()
    assert not tt_.spans and not tt_.instants and not tt_.tracks()


def test_names_equal():
    names = [n for n in dir(jt) if n.startswith(("SPAN_", "EV_"))]
    assert len(names) == 19
    assert {n: getattr(tt, n) for n in names} == \
        {n: getattr(jt, n) for n in names}


def test_null_tracer_is_inert():
    nt = tt.NULL_TRACER
    assert isinstance(nt, tt.NullTracer) and nt.enabled is False
    assert nt.begin("round", 0.0, track="round 0", junk=1) == -1
    nt.end(-1, 1.0)
    nt.instant("x", 2.0)
    nt.span("y", 0.0, 1.0)
    nt.close_open_spans(3.0)
    nt.clear()
    assert nt.tracks() == []
    assert not hasattr(nt, "spans") and not hasattr(nt, "__dict__")
