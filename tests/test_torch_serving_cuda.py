"""PyTorch port: the online server on the card.  Every test here needs a
CUDA device (``gpu`` marker) and is skipped without one; the file imports
nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serving_cuda.py

At full width (C 64, D 7, 60 bits, tile 64, img 256, raw 288) a
``DetectionServer`` on the card serves a stream of requests of 1 to 8
images, coalesced into micro-batches of up to 32, each equal to
``detect_batch`` of its images under its key bit for bit, at fp32 and
int8, launching each main-path kernel once a micro-batch; exact-tier
hits and coalesced followers equal the cold path; the decode's
``with_embed`` logits equal the embed-free ones bit for bit on the flat
and a blocked schedule at every rung; and the server refuses to start
without a card unless the CPU is asked for.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.extractor import (init_extractor_numpy, pack_params,
                                        params_from_numpy)
from repro_torch.data.pipeline import synth_image
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import fused_extractor as fx
from repro_torch.serving import BatcherConfig, DetectionServer

pytestmark = pytest.mark.gpu

FULL = dict(tile=64, img_size=256, resize_src=288)
FIELDS = ("message_bits", "ok", "n_corrected", "logits")
MAIN = ("fused_tile_preprocess", "fused_extractor", "rs_decode")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the server runs its kernels there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params():
    return init_extractor_numpy(0, n_bits=60, channels=64, depth=7, tile=64,
                                bias_scale=0.1)


@pytest.fixture(scope="module")
def requests():
    pool = np.stack([synth_image(i, 288) for i in range(24)])
    rng = np.random.default_rng(0)
    return [pool[np.sort(rng.choice(24, int(rng.integers(1, 9)),
                                    replace=False))] for _ in range(24)]


def _equal(got, want):
    assert set(got) == set(want)
    for f in got:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _server(cfg, params, dev):
    srv = DetectionServer(cfg, params, batcher=BatcherConfig(
        max_batch=32, max_wait_ms=2.0), device=dev)
    srv.warmup(synth_image(0, 288))
    return srv.start()


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_server_equals_detect_batch_and_launches(dev, params, requests,
                                                 dtype):
    srv = _server(DetectionConfig(**FULL, decode_dtype=dtype), params, dev)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rid0 = srv._req_seq
        results = [h.result(120) for h in [srv.submit(r)
                                           for r in requests]]
        assert srv.drain(60)
        counts = ops.launch_counts()
        st = srv.stats()
    finally:
        srv.close()
    n_mb = st["batch_images"]["n"]
    assert n_mb < len(requests)          # requests were coalesced
    # one launch of each kernel a run of a micro-batch (a speculative
    # retry of a straggler is a second run)
    runs = n_mb + st["straggler_retries"]
    assert all(counts[k] == runs for k in MAIN)
    assert sum(counts.values()) == runs * len(MAIN)
    for i, (r, res) in enumerate(zip(requests, results)):
        _equal(res, srv.pipe.detect_batch(
            r, key=srv.registry.batch_key(rid0 + i)))


def test_exact_hits_equal_cold_path(dev, params, requests):
    srv = _server(DetectionConfig(**FULL, cache_exact=True), params, dev)
    try:
        sent = [requests[i % 4] for i in range(12)]
        results = [h.result(120) for h in [srv.submit(r) for r in sent]]
        st = srv.stats()
        assert srv._dedup.depth() == 0
    finally:
        srv.close()
    assert st["cache_miss"] >= 4
    assert st["cache_hit_exact"] + st["dedup_coalesced"] + \
        st["cache_miss"] == 12
    for i, res in enumerate(results):
        want = srv.pipe.detect_batch(sent[i], key=srv.content_key(sent[i]))
        _equal(res, want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("schedule", [None, "bb4-ct32-db"])
def test_with_embed_is_logit_inert(dev, params, dtype, schedule):
    packed = pack_params(params_from_numpy(params, dev), dtype)
    sched = None if schedule is None else autotune.Schedule.from_string(
        schedule)
    tiles = torch.as_tensor(np.random.default_rng(1).normal(
        size=(7, 64, 64, 3)).astype(np.float32)).to(dev)
    logits, g = ops.fused_extractor(tiles, packed, schedule=sched,
                                    with_embed=True)
    assert torch.equal(logits, ops.fused_extractor(tiles, packed,
                                                   schedule=sched))
    _, want = fx.fused_extractor_plain(tiles, packed, with_embed=True)
    tol = (1e-4 * (1.0 + float(want.abs().max())) if dtype == "fp32"
           else 0.02)
    assert float((g - want).abs().max()) <= tol


def test_server_needs_a_card_unless_cpu_is_asked_for(monkeypatch, dev,
                                                     params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionServer(DetectionConfig(**FULL), params)


def test_keys_stay_on_the_host(dev, params):
    srv = DetectionServer(DetectionConfig(**FULL), params, device=dev)
    try:
        assert srv.pipe.device.type == "cuda"
        keys = srv.registry.image_keys(prng.key(3), 4)
        assert keys.device.type == "cpu"
        pipe = DetectionPipeline(DetectionConfig(**FULL), params,
                                 device="cpu")
        assert torch.equal(keys, pipe.stages.image_keys(prng.key(3), 4))
    finally:
        srv.close()
