"""The port's trace exporters (``repro_torch.obs.export``) against the JAX
package's (``repro.obs.export``).

One traced event-driven run on each side, at the TINY width of
``tests/test_torch_sched.py``: asyncfleo-twohap with two rounds in flight,
one channel a PS (channel-occupancy spans), 30 % transfer loss (retries)
and dark PS windows (outage spans).  The two runs are the same run
(``assert_same_run``); after ``add_runtime_tracks`` on each:

* ``export_chrome``'s object equals the reference's after a JSON round
  trip, and ``export_jsonl``'s file equals the reference's line for line;
* ``validate_chrome_trace`` accepts the port's object and gives the
  reference's error list for malformed ones;
* both files load back through ``benchmarks/trace_report.py`` into the
  waterfall, utilization and retry views, as ``tests/test_obs.py`` holds
  the reference's.
"""
import dataclasses
import json

import pytest

from benchmarks.trace_report import (load_trace, ps_utilization,
                                     retry_report, round_waterfall)
from repro.obs import export as jexport
from repro_torch.obs import (add_runtime_tracks, export_chrome, export_jsonl,
                             validate_chrome_trace)
from repro_torch.obs.trace import (EV_TRANSFER_RETRY, NULL_TRACER,
                                   SPAN_CHANNEL, SPAN_OUTAGE, SPAN_ROUND,
                                   Tracer)
from test_torch_faults import _faults
from test_torch_sched import (assert_same_run, one_torch_thread,  # noqa: F401
                              run_pair, setup)

SPEC = dict(max_in_flight=2, handoff_policy="next_contact", ps_channels=1)
FAULT = dict(loss_prob=0.3, max_retries=2, retry_backoff_s=60.0,
             ps_outage_fraction=0.1)


@pytest.fixture(scope="module")
def traced(setup):
    """(JAX runtime, port runtime) of one traced run, their per-PS tracks
    added."""
    jrun, trun = run_pair(setup, "asyncfleo-twohap", 5, spec_kw=SPEC,
                          traced=True, **_faults(**FAULT))
    assert_same_run(jrun, trun)
    jrt, trt = jrun[0], trun[0]
    jexport.add_runtime_tracks(jrt.tracer, jrt)
    add_runtime_tracks(trt.tracer, trt)
    return jrt, trt


def test_runtime_tracks_equal_reference(traced):
    jrt, trt = traced
    tr = trt.tracer
    assert any(s.name == SPAN_CHANNEL for s in tr.spans)
    assert any(s.name == SPAN_OUTAGE for s in tr.spans)
    assert any(i.name == EV_TRANSFER_RETRY for i in tr.instants)
    assert [dataclasses.astuple(s) for s in tr.spans] == \
        [dataclasses.astuple(s) for s in jrt.tracer.spans]
    assert tr.tracks() == jrt.tracer.tracks()


def test_export_chrome_equals_reference(traced, tmp_path):
    jrt, trt = traced
    path = tmp_path / "port.json"
    obj = export_chrome(trt.tracer, str(path))
    want = json.loads(json.dumps(jexport.export_chrome(jrt.tracer)))
    assert json.loads(json.dumps(obj)) == want
    assert json.loads(path.read_text()) == want
    assert validate_chrome_trace(obj) == []
    assert validate_chrome_trace(json.loads(path.read_text())) == []
    # ps tracks come first in the tid layout, then rounds in order
    names = [e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M"]
    ps = [n for n in names if n.startswith("ps ")]
    assert ps and names[:len(ps)] == sorted(ps)


def test_export_jsonl_equals_reference(traced, tmp_path):
    jrt, trt = traced
    got, want = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    n = export_jsonl(trt.tracer, str(got))
    assert n == jexport.export_jsonl(jrt.tracer, str(want))
    assert n == len(trt.tracer.spans) + len(trt.tracer.instants)
    assert got.read_text().splitlines() == want.read_text().splitlines()


MALFORMED = [
    [], "trace", {"traceEvents": {}}, {"events": []},
    {"traceEvents": ["x", 3]},
    {"traceEvents": [{"ph": "Z", "name": "x", "pid": 0, "tid": 0,
                      "ts": 0.0}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 0, "tid": 0,
                      "ts": 0.0, "dur": -1.0}]},
    {"traceEvents": [{"ph": "X", "name": 3, "tid": 0, "ts": "0"}]},
    {"traceEvents": [{"ph": "i", "name": "x", "pid": 0}]},
    {"traceEvents": [{"ph": "M", "name": "thread_name"},
                     {"ph": "X", "name": "x", "pid": 0, "ts": 1}]},
]


@pytest.mark.parametrize("obj", MALFORMED)
def test_validate_chrome_trace_errors_equal_reference(obj):
    errors = validate_chrome_trace(obj)
    assert errors and errors == jexport.validate_chrome_trace(obj)


def test_exports_round_trip_through_trace_report(traced, tmp_path):
    _, trt = traced
    tr = trt.tracer
    jpath, cpath = tmp_path / "t.jsonl", tmp_path / "t.json"
    export_jsonl(tr, str(jpath))
    export_chrome(tr, str(cpath))
    a, b = load_trace(str(cpath)), load_trace(str(jpath))
    for t in (a, b):
        assert len(t.spans) == len(tr.spans)
        assert len(t.instants) == len(tr.instants)
        assert sorted(t.tracks()) == sorted(tr.tracks())
    wf = round_waterfall(a)
    assert len(wf) - 2 == sum(s.name == SPAN_ROUND for s in a.spans)
    assert round_waterfall(b) == wf
    util = "\n".join(ps_utilization(a))
    assert "busy" in util and "outage" in util
    assert "retries" in retry_report(a)[0]


def test_runtime_tracks_only_for_what_the_run_configured(setup, traced):
    """No channels and no outages: no per-PS span.  The null tracer
    records nothing, whatever the run configured."""
    _, trun = run_pair(setup, "asyncfleo-hap", 2)
    tr = Tracer()
    add_runtime_tracks(tr, trun[0])
    assert tr.spans == [] and tr.tracks() == []
    add_runtime_tracks(NULL_TRACER, traced[1])
    assert NULL_TRACER.tracks() == []
