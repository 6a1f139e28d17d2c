"""The program's spans on the device trace's timeline (``spans.py``) and
the span metrics' readers, on a synthetic window (``data/spans_small.json``):
three lane threads whose spans, counters and runtime calls are given in
the trace's microseconds, turned into a recording on the perf counter
with a known offset from the realtime clock."""
import json
from pathlib import Path

import pytest

import devtrace
import run
import spans
from repro_torch.core import trace

DATA = json.loads((Path(__file__).resolve().parent / "data"
                   / "spans_small.json").read_text())
NAMES = ("ingest_host_ms", "escalation_host_ms", "device_wait_ms",
         "decode_starved_share", "host_offcpu_share")


def recording(anchors=None):
    """The data's recording on the perf counter: trace us t is perf ns
    (t - 100) * 1000 + 5,000,000."""
    rec = DATA["recording"]
    anchors = anchors or rec["anchors"]

    def ns(t):
        return (t - 100) * 1000 + 5_000_000

    out = [trace.Span(n, seq, tid, parent, ns(a), ns(b),
                      None if cpu is None else cpu * 1000, wait)
           for n, seq, tid, parent, a, b, cpu, wait in rec["spans"]]
    return trace.Recording(out, dict(rec["counters"]),
                           tuple(tuple(a) for a in anchors),
                           {int(k): tuple(v)
                            for k, v in rec["threads"].items()})


@pytest.fixture
def traced(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(DATA["trace"]))
    return devtrace.load(path), spans.trace_file(path)


def ctx_of(tf, rec=None):
    return spans.context(rec or recording(), tf)


def test_spans_map_back_exactly(traced):
    _, tf = traced
    ctx = ctx_of(tf)
    want = DATA["recording"]["spans"]
    assert [(s.ts, s.end) for s in ctx["spans"]] == [(w[4], w[5])
                                                     for w in want]
    assert ctx["span_window"] == (100.0, 1100.0)
    assert ctx["clock_drift_us"] == 0.0
    assert ctx["spans"][1].self_us == 300 - 100 - 50 - 40
    assert ctx["spans"][8].cpu is None
    # 100 ns of drift over the window: the anchors still map exactly
    (r0, p0), (r1, p1) = DATA["recording"]["anchors"]
    drifted = ctx_of(tf, recording([(r0, p0), (r1 + 100, p1)]))
    assert drifted["clock_drift_us"] == pytest.approx(0.1)
    assert drifted["span_window"][1] == pytest.approx(1100.1, abs=1e-9)
    assert drifted["spans"][8].end == pytest.approx(1100.1, abs=1e-9)
    assert drifted["spans"][0].ts == 100.0


def test_readers_read_the_hand_computed_values(traced):
    _, tf = traced
    ctx = ctx_of(tf)
    got = {n: run.load_reader(n)(ctx) for n in NAMES}
    # per batch of 2: ingest 300 us less its 40 us sync, escalate 300
    # less 80, the syncs 40 + 80 + 20; the decode lane waited 400 + 550
    # of 1000 us; work 260 + 50 + 340 us wall against 195 + 40 + 185 CPU
    assert got == pytest.approx({
        "ingest_host_ms": 0.13, "escalation_host_ms": 0.11,
        "device_wait_ms": 0.07, "decode_starved_share": 95.0,
        "host_offcpu_share": 100 * (650 - 420) / 650})


def test_readers_read_none_without_spans(traced):
    _, tf = traced
    bare = {"trace": traced[0], "tiles_used": None}
    for n in NAMES:
        assert run.load_reader(n)(bare) is None
        assert run.load_reader(n)(dict(bare, spans=[])) is None
    no_batches = dict(ctx_of(tf), counters={})
    assert all(run.load_reader(n)(no_batches) is None for n in NAMES)
    assert spans.context(None, tf) == {}
    assert spans.context(recording(), {"runtime": []}) == {}
    assert spans.idle_spans(traced[0], {}) is None
    assert spans.mapping_check({}) is None
    assert spans.recorder() is trace      # None in a program without one


def test_idle_time_goes_to_the_work_span_that_covered_it(traced):
    tr, tf = traced
    ctx = ctx_of(tf)
    # idle 100-200, 400-700 and 800-1100 us inside the recording
    got = dict(spans.idle_spans(tr, ctx))
    assert got == pytest.approx({
        "escalate": 100e-6, "escalate.round": 100e-6, "stage.rs": 70e-6,
        "stage.ingest": 60e-6, "stage.decode": 50e-6, "finish": 50e-6,
        "upload.pin": 40e-6})
    # no thread in a work span: 50 + 60 + 120 of the 700 idle us
    assert spans.idle_without_work(tr, ctx) == pytest.approx(
        100 * 230 / 700)


def test_mapping_check_counts_lane_calls_inside_stage_spans(traced):
    tr, tf = traced
    ctx = ctx_of(tf)
    # lane calls after each loop's first span and before the stop: five
    # inside a stage span, one (thread 11 at 120 us) in its input wait
    assert spans.mapping_check(ctx) == pytest.approx(
        {"share": 500 / 6, "calls": 6, "matched_by": "native"})
    # the ids an H100 host's trace gave: pthread ids cut to a signed
    # 32-bit int, printed as its absolute value
    threads = {11: ("ingest.0", 0x7FCE_2460_16C0),
               12: ("decode.0", 0x7FCE_DF1F_E6C0),
               13: ("rs.0", 0x7FCE_0000_1013)}
    pthread = {11: 0x2460_16C0, 12: 0x20E0_1940, 13: 0x1013}
    by_pthread = [(n, pthread.get(t, t), a, b)
                  for n, t, a, b in tf["runtime"]]
    assert spans.mapping_check(dict(ctx, runtime=by_pthread,
                                    span_threads=threads)) == \
        pytest.approx({"share": 500 / 6, "calls": 6,
                       "matched_by": "pthread"})
    line = spans.summary(tr, ctx)
    assert "83.33 % of 6 launch and copy calls" in line
    assert "32.86 %" in line
