"""The per-layer metrics' readers on a small trace: two decode streams
that overlap, a pinned upload, two idle stretches, a CUDA runtime call
in the longest."""
from pathlib import Path

import numpy as np
import pytest

import devtrace
import flops
import run
from conftest import load

TRACE = Path(__file__).resolve().parent / "data" / "trace_small.json"
NAMES = ("device_idle_share", "decode_roofline", "mfu",
         "decode_stream_overlap", "h2d_ms_per_batch", "tiles_per_image")
PEAKS = flops.PEAKS["NVIDIA H100 80GB HBM3"]


def ctx(trace, **kw):
    return dict({"trace": trace, "cfg": load("configs", "qrmark-fp32"),
                 "peaks": PEAKS, "images_per_s": 1000.0,
                 "tiles_used": np.array([1, 1, 3, 2]),
                 "batches_traced": 2}, **kw)


def read(name, c):
    return run.load_reader(name)(c)


def test_union_idle_and_overlap():
    tr = devtrace.load(TRACE)
    assert (tr.start, tr.end) == (0.0, 1000.0)
    # device busy: [10, 65], [100, 310], [400, 500]
    assert devtrace.busy_us(tr.device) == 365.0
    assert read("device_idle_share", ctx(tr)) == pytest.approx(63.5)
    # decode kernels 375 us in all, 220 of it beside the other stream
    assert read("decode_stream_overlap", ctx(tr)) == pytest.approx(
        100 * 220 / 375)


def test_roofline_counts_whole_calls_only():
    tr = devtrace.load(TRACE)
    # each stream's first call may have begun before the trace: only the
    # second call of stream 7 counts, 2 tiles in 160 us
    least = flops.least_seconds(2, 64, load("configs", "qrmark-fp32")
                                ["extractor"], "fp32", PEAKS)
    assert read("decode_roofline", ctx(tr)) == pytest.approx(
        100 * least / 160e-6)


def test_upload_mfu_and_tiles():
    tr = devtrace.load(TRACE)
    assert read("h2d_ms_per_batch", ctx(tr)) == pytest.approx(0.05)
    per_image = flops.extractor_flops(1, 64, channels=64, depth=7, n_bits=60)
    assert read("mfu", ctx(tr)) == pytest.approx(
        100 * per_image * 1000.0 / 67e12)
    assert read("tiles_per_image", ctx(tr)) == pytest.approx(1.75)


def test_missing_sources_read_none():
    tr = devtrace.load(TRACE)
    bare = devtrace.Trace([e for e in tr.device if "HtoD" in e.name],
                          tr.host, tr.start, tr.end)
    assert read("decode_roofline", ctx(bare)) is None
    assert read("decode_stream_overlap", ctx(bare)) is None
    empty = devtrace.Trace([], tr.host, tr.start, tr.end)
    for name in NAMES[:5]:
        assert read(name, ctx(empty, peaks=None, images_per_s=None)) is None
        assert read(name, ctx(None, peaks=None, images_per_s=None)) is None
    assert read("tiles_per_image", ctx(None, tiles_used=None)) is None


def test_breakdown_lists_ops_and_gaps():
    tr = devtrace.load(TRACE)
    ops = devtrace.device_ops(tr)
    assert ops[0][0].startswith("void qr::conv_regtile_kernel<qr::RF32, 64,")
    gaps = devtrace.idle_gaps(tr)
    assert [g[1] for g in gaps] == pytest.approx([500e-6, 90e-6, 35e-6,
                                                  10e-6])
    assert gaps[0][0].startswith("cudaStreamSynchronize 0.300 ms")
    assert gaps[-1][0].startswith("cudaLaunchKernel 0.005 ms")
