"""PyTorch port: the span and counter recorder (``core/trace.py``) and
its sites on the stream path, on the CPU at a tiny size (tile 16, img 32
cropped from raw 40, extractor channels 8, depth 2, batches of 8,
escalation to 3 tiles).

* off, a stream with escalation reads no clock: ``time.perf_counter_ns``
  and ``time.thread_time_ns`` raise, and it still completes;
* spans nest on their thread (parent indices, inherited ``seq``, self
  times, thread CPU time only where asked for), two threads' buffers
  merge and counters add up;
* on, the results are bit-identical to off, and every batch has exactly
  one span of each stage;
* the ``batches`` counter agrees with the results;
* on the stream, thread CPU time is read on the stage spans and their
  waits for the card, and on no other span.
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import extractor as ex
from repro_torch.core import trace
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.rs import codec

TILE, IMG, RAW, B, K, N_BATCHES = 16, 32, 40, 8, 3, 3
FIELDS = ("message_bits", "ok", "n_corrected", "logits", "tiles_used")


@pytest.fixture(autouse=True)
def _off_after():
    yield
    with contextlib.suppress(RuntimeError):   # a test left it on
        trace.stop()


def _params():
    p = ex.init_extractor_numpy(3, n_bits=60, channels=8, depth=2,
                                tile=TILE)
    p["head"]["w"] = p["head"]["w"] * 0.0        # the correlation path only
    return p


def _batches(p):
    """Batches of which half the rows carry an RS codeword in every tile
    cell (they verify on one tile) and half are unmarked (they escalate,
    most to the third tile)."""
    rng = np.random.default_rng(3)
    cw = codec.rs_encode(codec.DEFAULT_CODE, rng.integers(0, 2, 48))
    wm = np.tensordot((2.0 * cw - 1.0).astype(np.float32), p["corr"],
                      axes=1)
    wm *= 30.0 / np.sqrt(np.mean(wm * wm))
    out = []
    for _ in range(N_BATCHES):
        raw = rng.uniform(0, 255, (B, RAW, RAW, 3)).astype(np.float32)
        o = (RAW - IMG) // 2
        for y in range(o, o + IMG, TILE):
            for x in range(o, o + IMG, TILE):
                raw[: B // 2, y:y + TILE, x:x + TILE] += wm
        out.append(np.clip(np.rint(raw), 0, 255).astype(np.uint8))
    return out


def _stream(p, batches):
    cfg = DetectionConfig(tile=TILE, img_size=IMG, resize_src=RAW,
                          escalate_tiles=K)
    pipe = DetectionPipeline(cfg, p, device="cpu")
    try:
        return pipe.run_stream(iter(batches))
    finally:
        pipe.close()


@pytest.fixture(scope="module")
def streams():
    """The same stream with the recorder off and on, and the
    recording."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p = _params()
        batches = _batches(p)
        off = _stream(p, batches)
        trace.start()
        try:
            on = _stream(p, batches)
        finally:
            rec = trace.stop()
    finally:
        torch.set_num_threads(n)
    return off, on, rec


def test_off_reads_no_clock_and_allocates_no_span(monkeypatch):
    def refuse():
        raise AssertionError("a span site read a clock while off")

    p = _params()
    batches = _batches(p)[:2]
    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(time, "thread_time_ns", refuse)
    out = _stream(p, batches)
    assert len(out["results"]) == 2
    assert out["results"][1]["tiles_used"].max() == K
    assert trace.span("a") is trace.span("b", 3, wait=True)
    assert trace.count("batches") is None


def test_spans_nest_per_thread_and_buffers_merge(monkeypatch):
    ticks = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    cpu_ticks = iter(range(0, 10 ** 6, 3))
    monkeypatch.setattr(time, "thread_time_ns", lambda: next(cpu_ticks))
    trace.start()
    with pytest.raises(RuntimeError, match="already"):
        trace.start()
    with trace.span("outer", seq=7, cpu=True):   # ticks 10 .. 80, cpu 0 .. 9
        with trace.span("inner"):                # 20 .. 50
            with trace.span("sync", wait=True, cpu=True):  # 30 .. 40, 3 .. 6
                trace.count("rows", 8)
        with trace.span("last"):                 # 60 .. 70
            pass

    def other():
        with trace.span("stage.rs", seq=9, cpu=True):   # cpu 12 .. 15
            trace.count("rows", 2)
            trace.count("batches")

    t = threading.Thread(target=other, name="lane")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    rec = trace.stop()
    with pytest.raises(RuntimeError, match="not recording"):
        trace.stop()

    names = [s.name for s in rec.spans]
    assert names == ["outer", "inner", "sync", "last", "stage.rs"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 0, -1]
    assert [s.seq for s in rec.spans] == [7, 7, 7, 7, 9]
    assert [s.wait for s in rec.spans] == [False, False, True, False, False]
    assert [s.end_ns - s.start_ns for s in rec.spans[:4]] == [70, 30, 10,
                                                             10]
    assert rec.self_ns()[:4] == [30, 20, 10, 10]
    assert [s.cpu_ns for s in rec.spans] == [9, None, 3, None, 3]
    main, lane = threading.get_native_id(), rec.spans[-1].tid
    assert {s.tid for s in rec.spans[:4]} == {main} and lane != main
    assert rec.threads[lane][0] == "lane"
    assert rec.counters == {"rows": 10, "batches": 1}
    (t0, p0), (t1, p1) = rec.anchors
    assert p1 > p0 and t1 >= t0


def test_open_span_ends_at_stop():
    trace.start()
    with trace.span("open", cpu=True):
        rec = trace.stop()
    (s,) = rec.spans
    assert s.end_ns == rec.anchors[1][1] and s.cpu_ns is None


def test_recording_leaves_results_bit_identical(streams):
    off, on, rec = streams
    assert len(off["results"]) == len(on["results"]) == N_BATCHES
    for a, b in zip(off["results"], on["results"]):
        assert a.keys() == b.keys()
        for f in FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for stage in ("ingest", "decode", "rs"):
        seqs = sorted(s.seq for s in rec.spans
                      if s.name == f"stage.{stage}")
        assert seqs == list(range(N_BATCHES)), stage
    feed = [s for s in rec.spans if s.name == "feed.keys"]
    assert sorted(s.seq for s in feed) == list(range(N_BATCHES))
    # escalation's spans sit inside the rs stage and share its seq
    for s in rec.spans:
        if s.name == "escalate":
            parent = rec.spans[s.parent]
            assert parent.name == "stage.rs" and parent.seq == s.seq


def test_counters_match_the_results(streams):
    _, on, rec = streams
    assert len(on["results"]) == N_BATCHES
    assert on["images"] == N_BATCHES * B
    assert rec.counters == {"batches": N_BATCHES}


def test_cpu_time_read_on_stages_and_their_waits_only(streams):
    _, on, rec = streams
    used = np.concatenate([r["tiles_used"] for r in on["results"]])
    assert (used == 3).any()            # escalation's rounds ran
    names = {s.name for s in rec.spans}
    assert {"escalate.round", "sync", "lane.wait_in"} <= names
    for s in rec.spans:
        read = s.name.startswith("stage.") or s.name == "sync"
        assert (s.cpu_ns is not None) == read, s
        assert s.cpu_ns is None or s.cpu_ns >= 0
