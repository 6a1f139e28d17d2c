"""PyTorch port: the lane executor on the card — lanes as CUDA streams.
Every test here needs a CUDA device (``gpu`` marker) and is skipped
without one; the file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lanes_cuda.py

At full width (C 64, D 7, 60 bits, tile 64, img 256, raw 288, batch 32)
``run_stream`` at every lane map equals serial ``detect_batch`` over the
same batches with the same keys, bit for bit, at fp32 and int8; the
decode kernels of a ``run_stream`` with 4 decode lanes run on more than
one CUDA stream (read from a ``torch.profiler`` trace); and a cold
pipeline's first ``run_stream`` at 4 lanes, with every cached device
constant dropped first, equals serial execution; an escalating
``run_stream`` draws one plan on the card a batch that escalated.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.extractor import init_extractor_numpy
from repro_torch.data.pipeline import synth_image
from repro_torch.kernels import fused_extractor as fx
from repro_torch.kernels import fused_preprocess as fp
from repro_torch.kernels import fused_tile_preprocess as ftp

pytestmark = pytest.mark.gpu

FULL = dict(tile=64, img_size=256, resize_src=288)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: lanes are CUDA streams there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stream():
    return [np.stack([synth_image(32 * k + i, 288) for i in range(32)])
            for k in range(6)]


def _pipe(dev, **kw):
    p = init_extractor_numpy(0, n_bits=60, channels=64, depth=7, tile=64,
                             bias_scale=0.1)
    return DetectionPipeline(DetectionConfig(**FULL, **kw), p, device=dev)


def _serial(pipe, stream):
    return [pipe.detect_batch(raw, key=pipe.stages.batch_key(i))
            for i, raw in enumerate(stream)]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("lanes", [1, 3, None,
                                   {"ingest": 2, "decode": 4, "rs": 2}])
def test_lane_maps_equal_serial(dev, stream, dtype, lanes):
    pipe = _pipe(dev, decode_dtype=dtype)
    want = _serial(pipe, stream)
    pipe._seq = 0
    _equal(pipe.run_stream(stream, lanes=lanes)["results"], want)


def test_decode_kernels_run_on_several_streams(dev, stream, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    pipe = _pipe(dev)
    pipe.run_stream(stream[:2], lanes=4)       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        pipe.run_stream(stream, lanes=4)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    streams = {e["args"]["stream"]
               for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel" and fx.is_decode_kernel(e["name"])}
    assert len(streams) > 1, streams


def test_cold_pipeline_at_four_lanes_equals_serial(dev, stream):
    """Drop every cached device constant (ingest tables, int8 fragments),
    then a fresh pipeline's first act is run_stream at 4 lanes."""
    for fn in (fp.device_tables, fp.ingest_tables, ftp.ingest_geometry):
        fn.cache_clear()
    fx._FRAGMENTS.clear()
    cold = _pipe(dev, decode_dtype="int8")
    got = cold.run_stream(stream, lanes=4)["results"]
    _equal(got, _serial(_pipe(dev, decode_dtype="int8"), stream))


def test_escalated_stream_draws_one_plan_a_batch(dev, stream):
    """An escalating ``run_stream`` (k = 3; the random detector fails RS
    on most rows) launches the plan kernel once for each batch that
    escalated, and equals serial ``detect_batch``."""
    from repro_torch.kernels import ops
    pipe = _pipe(dev, escalate_tiles=3)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = pipe.run_stream(stream)["results"]
    torch.cuda.synchronize()
    plans = ops.launch_counts()["escalation_plan"]
    escalated = sum(int(r["tiles_used"].max() > 1) for r in got)
    assert escalated > 0 and plans == escalated
    _equal(got, _serial(_pipe(dev, escalate_tiles=3), stream))
