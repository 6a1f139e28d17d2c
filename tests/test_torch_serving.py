"""PyTorch port: the online serving runtime (``repro_torch.serving``) on the
CPU at the reference tests' small size (tile 16, img 32, resize_src 40,
raw 64; extractor channels 8, depth 2).

Against the JAX package:

* ``MetricsRegistry`` snapshots and ``percentile`` equal the reference's
  on the same observations;
* the ``MicroBatcher`` on one scripted submission sequence (sizes,
  classes, buckets; closed before popping, so no deadline decides)
  gives the reference's slots, ``true_b``, ``padded_b``, rows and key
  rows;
* ``StageRegistry.decode_keyed_embed`` gives the reference's logits and
  GAP embedding within 1e-4 * (1 + max|x|) on the fused, staged and
  unfused decode;
* the server's results for keyless requests equal the reference's
  ``detect_batch(images, key=fold_in(key(seed), rid))``: tile offsets,
  ``ok`` and ``n_corrected`` exact, messages where ``ok``, logits within
  tolerance; and with ``escalate_tiles=3`` on a watermarked, damaged
  workload (the reference pads each escalation group to a power of two,
  the port decodes its true rows) ``tiles_used`` too.

The reference's pipelines use ``jax_rs`` as their device RS engine
(patched in for this module, as in ``test_torch_escalation.py``); no
JAX ``DetectionServer`` is started.  In the port alone: the server
equals the port's ``detect_batch`` bit for bit under random arrival
interleavings, buckets and lane maps, under speculative retries and
across a live reallocation; embedding emission is logit-inert on every
engine and the embedding tier short-circuits escalation; ``close``
leaves no handle unresolved and an empty request is rejected; and the
batcher's deadlines, coalescing, atomic groups, class promotion and
backpressure behave as the reference's tests describe.  Threaded tests
carry the deadlock canary.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canary import deadline
from repro.core import stages as jstages
from repro.core import tiling as jtiling
from repro.core.detect import DetectionConfig as JConfig
from repro.core.detect import DetectionPipeline as JPipeline
from repro.core.rs import jax_rs
from repro.serving import batcher as jbatcher
from repro.serving import metrics as jmetrics
from repro_torch.core import extractor as ex
from repro_torch.core import prng, tiling
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.rs import codec
from repro_torch.core.scheduler import StragglerPolicy
from repro_torch.serving import (AdmissionError, BatcherConfig,
                                 DetectionServer, MetricsRegistry,
                                 MicroBatcher)
from repro_torch.serving.batcher import pad_to_bucket
from repro_torch.serving.metrics import aggregate_counters, percentile
from repro_torch.data.pipeline import synth_image

torch.set_num_threads(1)

SMALL = dict(tile=16, img_size=32, resize_src=40)
FIELDS = ("message_bits", "ok", "n_corrected", "logits")


@pytest.fixture(scope="module", autouse=True)
def _jax_rs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstages, "make_device_rs", jax_rs.make_batch_decoder)
        yield


def _params():
    return ex.init_extractor_numpy(0, n_bits=60, channels=8, depth=2,
                                   tile=16)


@pytest.fixture(scope="module")
def params():
    return _params()


def _raw(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


def _tol(x):
    return 1e-4 * (1.0 + float(np.abs(x).max()))


def _equal(got, want, what=""):
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, (what, f)
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")


# -- metrics ------------------------------------------------------------------
def test_percentiles_and_snapshot_equal_reference():
    vals = np.random.default_rng(0).exponential(0.01, 257)
    mine, ref = MetricsRegistry(), jmetrics.MetricsRegistry()
    for m in (mine, ref):
        for v in vals:
            m.observe("lat", float(v))
        m.count("requests_completed", 100)
        m.count("images_completed", 250)
        m.count("cache_hit_exact", 3)
        m.count("cache_miss", 9)
        m.count("requests_rejected", 2)
        m.count("requests_admitted", 12)
        m.gauge("queue_depth", 7)
    a, b = mine.snapshot(), ref.snapshot()
    for k in ("lat", "counters", "gauges", "rejection_rate",
              "cache_hit_rate"):
        assert a[k] == b[k], k
    s = sorted(vals)
    for q in (0, 50, 95, 99, 100):
        assert percentile(s, q) == jmetrics.percentile(s, q)
    assert percentile([], 50) != percentile([], 50)
    assert aggregate_counters([a, a]) == jmetrics.aggregate_counters([b, b])
    mine.reset()
    snap = mine.snapshot()
    assert "lat" not in snap and not snap["counters"]


# -- the micro-batcher against the reference ----------------------------------
def _imgs(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 8, 8, 3),
                                                dtype=np.uint8)


def _keys(n, seed=0):
    return prng.fold_in(prng.key(seed)[None].expand(n, 2), torch.arange(n))


def _jkeys(n, seed=0):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed),
                                                 i))(jnp.arange(n))


SCRIPT = [(3, "bulk"), (1, "interactive"), (2, "interactive"), (4, "bulk"),
          (1, "bulk"), (2, "interactive"), (3, "interactive"), (1, "bulk")]


@pytest.mark.parametrize("bucket", [0, 3])
@pytest.mark.parametrize("classes", [None, {"interactive": 9e4,
                                            "bulk": 9e4}])
def test_batcher_script_equals_reference(bucket, classes):
    """One scripted submission sequence through both batchers, popped
    after close (no deadline is waited for): the same micro-batches."""
    cfg = dict(max_batch=5, max_wait_ms=9e4, bucket=bucket,
               classes=classes)
    mine = MicroBatcher(BatcherConfig(**cfg))
    ref = jbatcher.MicroBatcher(jbatcher.BatcherConfig(**cfg))
    for i, (n, cls) in enumerate(SCRIPT):
        pri = cls if classes else None
        mine.submit(_imgs(n, i), _keys(n, i), slot=i, priority=pri)
        ref.submit(_imgs(n, i), _jkeys(n, i), slot=i, priority=pri)
    assert mine.class_depths() == ref.class_depths()
    assert mine.depth() == ref.depth() == 17
    mine.close()
    ref.close()
    n_batches = 0
    while True:
        a, b = mine.next_batch(timeout=1.0), ref.next_batch(timeout=1.0)
        if a is None or b is None:
            assert a is None and b is None
            break
        n_batches += 1
        assert a.slots == b.slots
        assert (a.true_b, a.padded_b) == (b.true_b, b.padded_b)
        assert a.occupancy == b.occupancy
        np.testing.assert_array_equal(a.raw, b.raw)
        assert a.keys.dtype == torch.int64 and a.keys.shape == (a.padded_b, 2)
        np.testing.assert_array_equal(
            a.keys.numpy(), np.asarray(jax.random.key_data(b.keys)))
    assert n_batches >= 4


# -- the micro-batcher's behaviour (the reference's tests, on the port) --------
def test_pad_to_bucket_and_admission_rejects():
    with pytest.raises(AdmissionError, match="empty"):
        pad_to_bucket(np.zeros((0, 8, 8, 3), np.uint8))
    padded, b = pad_to_bucket(_imgs(3))
    assert padded.shape[0] == 4 and b == 3
    mb = MicroBatcher(BatcherConfig(max_batch=4))
    with pytest.raises(AdmissionError, match="empty"):
        mb.submit(_imgs(0), None, slot=None)
    with pytest.raises(AdmissionError, match="max_batch"):
        mb.submit(_imgs(5), _keys(5), slot=None)
    for bad in (dict(max_batch=0), dict(classes={}),
                dict(bulk_admit_frac=0.0), dict(classes={"a": 0.0})):
        with pytest.raises(ValueError):
            MicroBatcher(BatcherConfig(**bad))


@deadline(30)
def test_batcher_deadline_triggers_partial_batch():
    mb = MicroBatcher(BatcherConfig(max_batch=16, max_wait_ms=40.0))
    mb.submit(_imgs(3), _keys(3), slot="r0")
    t0 = time.perf_counter()
    out = mb.next_batch(timeout=5.0)
    assert time.perf_counter() - t0 >= 0.02
    assert out.true_b == 3 and out.padded_b == 4
    assert out.slots == [("r0", 0, 3)]
    assert torch.equal(out.keys[3], out.keys[2])   # pad row repeats


@deadline(30)
def test_batcher_coalesces_up_to_max_batch():
    mb = MicroBatcher(BatcherConfig(max_batch=4, max_wait_ms=500.0))
    for i in range(6):
        mb.submit(_imgs(1, seed=i), _keys(1, i), slot=i)
    t0 = time.perf_counter()
    out = mb.next_batch(timeout=5.0)
    assert time.perf_counter() - t0 < 0.4
    assert out.true_b == 4 and [s[0] for s in out.slots] == [0, 1, 2, 3]
    out2 = mb.next_batch(timeout=5.0)
    assert out2.true_b == 2 and [s[0] for s in out2.slots] == [4, 5]


@deadline(30)
def test_batcher_request_groups_stay_atomic():
    mb = MicroBatcher(BatcherConfig(max_batch=4, max_wait_ms=1.0))
    mb.submit(_imgs(3), _keys(3), slot="a")
    mb.submit(_imgs(2), _keys(2), slot="b")
    assert [s[0] for s in mb.next_batch(timeout=5.0).slots] == ["a"]
    assert [s[0] for s in mb.next_batch(timeout=5.0).slots] == ["b"]


@deadline(30)
def test_batcher_expired_deadline_promotes_starved_class():
    mb = MicroBatcher(BatcherConfig(
        max_batch=2, max_wait_ms=5.0,
        classes={"interactive": 10_000.0, "bulk": 10.0}))
    mb.submit(_imgs(1, seed=9), _keys(1), slot="bulk0", priority="bulk")
    time.sleep(0.03)
    for i in range(4):
        mb.submit(_imgs(1, seed=i), _keys(1), slot=f"i{i}",
                  priority="interactive")
    assert [s[0] for s in mb.next_batch(timeout=5.0).slots] == \
        ["bulk0", "i0"]
    assert [s[0] for s in mb.next_batch(timeout=5.0).slots] == ["i1", "i2"]


@deadline(30)
def test_batcher_admission_backpressure_under_slow_consumer():
    mb = MicroBatcher(BatcherConfig(max_batch=4, max_queue=4,
                                    max_wait_ms=1.0,
                                    classes={"hi": 1.0, "lo": 1.0},
                                    bulk_admit_frac=0.5))
    assert mb.headroom() == 4 and mb.headroom("lo") == 2
    for i in range(4):
        mb.submit(_imgs(1, seed=i), _keys(1), slot=i)
    with pytest.raises(AdmissionError, match="queue full"):
        mb.submit(_imgs(1), _keys(1), slot=99)
    assert mb.depth() == 4 and mb.headroom() == 0
    done = []

    def blocked_submit():
        mb.submit(_imgs(1), _keys(1), slot="late", block=True, timeout=10.0)
        done.append(True)

    t = threading.Thread(target=blocked_submit, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not done
    assert mb.next_batch(timeout=5.0) is not None
    t.join(10.0)
    assert done and mb.depth() == 1
    assert [e.slot for e in mb.flush()] == ["late"] and mb.depth() == 0


def test_batcher_slicing_covers_every_request():
    rng = np.random.default_rng(11)
    for _ in range(10):
        sizes = [int(n) for n in rng.integers(1, 5,
                                              size=int(rng.integers(1, 7)))]
        mb = MicroBatcher(BatcherConfig(max_batch=16, max_wait_ms=0.5,
                                        bucket=int(rng.choice([0, 2, 3]))))
        for i, n in enumerate(sizes):
            mb.submit(_imgs(n, seed=i), _keys(n, i), slot=i)
        seen = 0
        while seen < len(sizes):
            out = mb.next_batch(timeout=2.0)
            off = 0
            for slot, o, n in out.slots:
                assert o == off and n == sizes[slot]
                np.testing.assert_array_equal(out.keys[o:o + n].numpy(),
                                              _keys(n, slot).numpy())
                off += n
            assert off == out.true_b <= out.padded_b == out.raw.shape[0]
            seen += len(out.slots)


# -- the embedding decode -------------------------------------------------------
EMBED_CONFIGS = {"fused": dict(), "staged": dict(tile_first=False),
                 "unfused": dict(fused_decode=False)}


@pytest.mark.parametrize("name", list(EMBED_CONFIGS))
def test_decode_keyed_embed_equals_reference(params, name):
    """Logits and embedding within 1e-4 * (1 + max|x|) of the
    reference's; the port's logits bitwise its embed-free decode's."""
    knob = EMBED_CONFIGS[name]
    jp = JPipeline(JConfig(**SMALL, **knob), jax.tree.map(jnp.asarray,
                                                          params))
    tp = DetectionPipeline(DetectionConfig(**SMALL, **knob), params,
                           device="cpu")
    raw = _raw(4, 3)
    jreg, treg = jp.stages, tp.stages
    jkeys = jreg.image_keys(jax.random.key(9), 3)
    tkeys = treg.image_keys(prng.key(9), 3)
    jl, je = jreg.decode_keyed_embed(jreg.ingest_keyed(jnp.asarray(raw),
                                                       jkeys), jkeys)
    x = treg.ingest_keyed(torch.as_tensor(raw), tkeys)
    tl, te = treg.decode_keyed_embed(x, tkeys)
    assert torch.equal(tl, treg.decode_keyed(x, tkeys))
    assert te.shape == (3, 60) and tl.shape == (3, 60)
    for got, want in ((tl, jl), (te, je)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=_tol(want))


@pytest.mark.parametrize("knob", [dict(decode_schedule="bb2-ct4"),
                                  dict(decode_dtype="int8"),
                                  dict(decode_dtype="bf16",
                                       decode_schedule="bb3-ct8-db"),
                                  dict(mode="sequential"),
                                  dict(mode="tiled")])
def test_embed_emission_is_logit_inert(params, knob):
    reg = DetectionPipeline(DetectionConfig(**SMALL, **knob), params,
                            device="cpu").stages
    raw = torch.as_tensor(_raw(5, 5))
    keys = reg.image_keys(prng.key(2), 5)
    x = reg.ingest_keyed(raw, keys)
    logits, g = reg.decode_keyed_embed(x, keys)
    assert torch.equal(logits, reg.decode_keyed(x, keys))
    assert g.shape == (5, 60) and torch.isfinite(g).all()


# -- the server against the reference ------------------------------------------
@pytest.fixture(scope="module")
def default_srv(params):
    srv = DetectionServer(DetectionConfig(**SMALL), params,
                          batcher=BatcherConfig(max_batch=8,
                                                max_wait_ms=2.0),
                          device="cpu")
    assert srv.warmup(_raw(0, 1)[0]) == [1, 2, 4, 8]
    srv.start()
    yield srv
    srv.close()


@deadline(240)
def test_server_equals_reference_detect_batch(default_srv, params):
    """Keyless requests take fold_in(key(seed), rid), as the reference's
    server does; each result equals the reference's detect_batch of the
    request under that key."""
    rid0 = default_srv._req_seq
    reqs = [_raw(20 + i, 2) for i in range(3)]
    results = [h.result(120) for h in [default_srv.submit(r)
                                       for r in reqs]]
    jp = JPipeline(JConfig(**SMALL), jax.tree.map(jnp.asarray, params))
    for i, (raw, got) in enumerate(zip(reqs, results)):
        jkey = jax.random.fold_in(jax.random.key(0), rid0 + i)
        want = jp.detect_batch(jnp.asarray(raw), key=jkey)
        tkeys = default_srv.registry.image_keys(
            default_srv.registry.batch_key(rid0 + i), 2)
        offs = tiling.tile_first_offsets("random_grid", tkeys,
                                         img_size=32, tile=16)
        np.testing.assert_array_equal(
            offs.numpy(), np.asarray(jtiling.tile_first_offsets(
                "random_grid", jp.stages.image_keys(jkey, 2),
                img_size=32, tile=16)))
        for f in ("ok", "n_corrected"):
            np.testing.assert_array_equal(got[f], np.asarray(want[f]), f)
        ok = got["ok"]
        np.testing.assert_array_equal(got["message_bits"][ok],
                                      np.asarray(want["message_bits"])[ok])
        np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]),
                                   rtol=0, atol=_tol(want["logits"]))


def _esc_workload():
    """test_torch_escalation's workload (raw 40 at an identity resize):
    the bank's patterns signed by an RS codeword in every cell of the
    crop, a corr-only detector, noise (sigma 90) on the tiles round 1
    picks under key 5 in five of eight rows."""
    p = ex.init_extractor_numpy(3, n_bits=60, channels=8, depth=2, tile=16)
    p["head"]["w"] = p["head"]["w"] * 0.0
    msg = np.random.default_rng(0).integers(0, 2, 48)
    cw = codec.rs_encode(codec.DEFAULT_CODE, msg)
    wm = np.tensordot((2.0 * cw - 1.0).astype(np.float32), p["corr"],
                      axes=1)
    wm *= 30.0 / np.sqrt(np.mean(wm * wm))
    raw = np.stack([synth_image(i, 40) for i in range(8)]).astype(
        np.float32)
    for y in range(4, 36, 16):
        for x in range(4, 36, 16):
            raw[:, y:y + 16, x:x + 16] += wm
    keys = prng.fold_in(prng.key(5)[None].expand(8, 2), torch.arange(8))
    offs = tiling.tile_first_offsets("random_grid", keys, img_size=32,
                                     tile=16).numpy() + 4
    rng = np.random.default_rng(1)
    for i in (0, 2, 3, 5, 6):
        y, x = offs[i]
        raw[i, y:y + 16, x:x + 16] += rng.normal(0, 90.0, (16, 16, 3))
    return p, msg, np.clip(np.rint(raw), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def esc():
    return _esc_workload()


@deadline(300)
def test_server_escalation_equals_reference(esc):
    """escalate_tiles=3 through the server (round r re-submitted as a
    payload of the group's true rows) equals the reference's
    detect_batch with escalation, whose groups are padded to powers of
    two: tiles_used, ok, n_corrected exact, messages where ok."""
    p, msg, raw = esc
    cfg = dict(SMALL)
    srv = DetectionServer(DetectionConfig(**cfg, escalate_tiles=3), p,
                          batcher=BatcherConfig(max_batch=8,
                                                max_wait_ms=2.0),
                          device="cpu")
    srv.warmup(raw[0])
    srv.start()
    try:
        got = srv.submit(raw, key=prng.key(5)).result(120)
        halves = [srv.submit(raw[i:i + 4], key=prng.key(5 + i)).result(120)
                  for i in (0, 4)]
        st = srv.stats()
    finally:
        srv.close()
    assert (got["tiles_used"][[0, 2, 3, 5, 6]] > 1).all()
    assert (got["tiles_used"][[1, 4, 7]] == 1).all()
    assert st["escalation_batches"] >= 2 and st["escalation_rate"] > 0
    jp = JPipeline(JConfig(**cfg, escalate_tiles=3),
                   jax.tree.map(jnp.asarray, p))
    want = jp.detect_batch(jnp.asarray(raw), key=jax.random.key(5))
    for f in ("tiles_used", "ok", "n_corrected"):
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), f)
    ok = got["ok"]
    assert ok.mean() >= 0.8 and (got["message_bits"][ok] == msg).all()
    np.testing.assert_array_equal(got["message_bits"][ok],
                                  np.asarray(want["message_bits"])[ok])
    np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]),
                               rtol=0, atol=3 * _tol(want["logits"]))
    pipe = DetectionPipeline(DetectionConfig(**cfg, escalate_tiles=3), p,
                             device="cpu")
    _equal(got, pipe.detect_batch(raw, key=prng.key(5)), "k3")
    for i, h in zip((0, 4), halves):
        _equal(h, pipe.detect_batch(raw[i:i + 4], key=prng.key(5 + i)),
               f"k3 rows {i}")


# -- the server alone ------------------------------------------------------------
def _online_trial(params, *, seed, max_batch, bucket, lanes, max_wait_ms,
                  n_requests=10):
    rng = np.random.default_rng(seed)
    reqs = [_raw(seed * 100 + i, int(rng.integers(1, 5)))
            for i in range(n_requests)]
    keys = [prng.key(int(rng.integers(0, 2 ** 31)))
            for _ in range(n_requests)]
    srv = DetectionServer(
        DetectionConfig(**SMALL), params,
        batcher=BatcherConfig(max_batch=max_batch, max_wait_ms=max_wait_ms,
                              bucket=bucket), lanes=lanes,
        device="cpu").start()
    try:
        handles = []
        for r, k in zip(reqs, keys):
            handles.append(srv.submit(r, key=k))
            if rng.random() < 0.5:
                time.sleep(float(rng.uniform(0, 0.01)))
        results = [h.result(120) for h in handles]
        occupancy = srv.stats()["batch_occupancy"]
    finally:
        srv.close()
    pipe = DetectionPipeline(DetectionConfig(**SMALL), params, device="cpu")
    for i, (r, k, res) in enumerate(zip(reqs, keys, results)):
        _equal(res, pipe.detect_batch(r, key=k), f"seed {seed} request {i}")
    return occupancy


@deadline(300)
@pytest.mark.parametrize("trial", [
    dict(seed=1, max_batch=8, bucket=0, max_wait_ms=3.0,
         lanes={"ingest": 1, "decode": 3, "rs": 2}),
    dict(seed=2, max_batch=5, bucket=3, max_wait_ms=1.0,
         lanes={"ingest": 1, "decode": 1, "rs": 1})])
def test_online_bit_identity_random_interleavings(params, trial):
    occ = _online_trial(params, **trial)
    assert 0.0 < occ["mean"] <= 1.0 and occ["n"] >= 1


@deadline(300)
def test_online_straggler_retry_keeps_results_exact(params):
    srv = DetectionServer(
        DetectionConfig(**SMALL), params,
        batcher=BatcherConfig(max_batch=4, max_wait_ms=1.0),
        straggler_policy=StragglerPolicy(timeout_factor=0.0,
                                         min_timeout_s=0.001,
                                         max_retries=2),
        watchdog_interval_s=0.005, device="cpu").start()
    reqs = [_raw(300 + i, 2) for i in range(6)]
    try:
        results = [h.result(120) for h in
                   [srv.submit(r, key=prng.key(50 + i))
                    for i, r in enumerate(reqs)]]
        retries = srv.mon.retry_count
        st = srv.stats()
    finally:
        srv.close()
    assert retries > 0 and st["straggler_retries"] == retries
    pipe = DetectionPipeline(DetectionConfig(**SMALL), params, device="cpu")
    for i, (r, res) in enumerate(zip(reqs, results)):
        _equal(res, pipe.detect_batch(r, key=prng.key(50 + i)))


@deadline(300)
def test_online_live_reallocation_mid_traffic(default_srv, params):
    srv = default_srv
    reqs = [_raw(400 + i, 2) for i in range(8)]
    first = [srv.submit(r, key=prng.key(80 + i))
             for i, r in enumerate(reqs[:4])]
    [h.result(120) for h in first]
    assert srv.drain(60)
    profiles = srv.stage_profiles()
    assert [p.name for p in profiles] == ["ingest", "decode", "rs"]
    applied = srv.reallocate(lane_budget=6)
    assert applied is not None and sum(applied.values()) <= 6
    assert srv.lane_counts() == applied
    assert srv.reconfigure({"ingest": 1, "decode": 2, "rs": 2}) == \
        {"ingest": 1, "decode": 2, "rs": 2}
    second = [srv.submit(r, key=prng.key(84 + i))
              for i, r in enumerate(reqs[4:])]
    results = [h.result(120) for h in second]
    pipe = DetectionPipeline(DetectionConfig(**SMALL), params, device="cpu")
    for i, (r, res) in enumerate(zip(reqs[4:], results)):
        _equal(res, pipe.detect_batch(r, key=prng.key(84 + i)))
    st = srv.stats()
    assert st["counters"]["reallocations"] == 1
    assert st["counters"]["reconfigures"] == 1
    assert st["request_latency_s"]["p50"] > 0
    assert set(st["lanes"]) == {"ingest", "decode", "rs"}


@deadline(120)
def test_server_rejects_empty_request(default_srv):
    r0 = default_srv.metrics.counter("requests_rejected")
    with pytest.raises(AdmissionError):
        default_srv.submit(np.zeros((0, 64, 64, 3), np.uint8))
    assert default_srv.metrics.counter("requests_rejected") == r0 + 1
    assert default_srv.load()["inflight_requests"] >= 0


@deadline(300)
def test_server_close_never_leaves_unresolved_futures(params):
    srv = DetectionServer(DetectionConfig(**SMALL), params,
                          batcher=BatcherConfig(max_batch=4,
                                                max_wait_ms=200.0),
                          device="cpu").start()
    handles = [srv.submit(_raw(500 + i, 1), key=prng.key(i))
               for i in range(5)]
    srv.close()
    for h in handles:
        assert h.done() or h._ready.wait(5)
        try:
            assert h.result(0)["message_bits"].shape[0] == 1
        except RuntimeError:
            pass
    assert srv._finished == srv._admitted
    with pytest.raises(AdmissionError, match="closed"):
        srv.submit(_raw(1, 1))


@deadline(300)
def test_server_embed_tier_short_circuits_escalation(esc):
    """A thin-margin request escalates and settles; the same pixels under
    the same key (exact tier off) hit the embedding tier at round 0 and
    adopt the settled verdicts without new escalation rounds."""
    p, _, raw = esc
    srv = DetectionServer(
        DetectionConfig(**SMALL, escalate_tiles=2, escalate_margin=50.0,
                        cache_embedding_threshold=0.995), p,
        batcher=BatcherConfig(max_batch=4, max_wait_ms=5.0),
        watchdog_interval_s=10.0, device="cpu")
    srv.warmup(raw[0])
    srv.start()
    try:
        rows = raw[[1, 4]]
        r1 = srv.submit(rows, key=prng.key(5)).result(120)
        assert (r1["tiles_used"] > 1).all() and r1["ok"].all()
        e0 = srv.metrics.counter("escalation_batches")
        r2 = srv.submit(np.array(rows, copy=True),
                        key=prng.key(5)).result(120)
        assert srv.metrics.counter("cache_hit_embed") == 2
        assert srv.metrics.counter("escalation_batches") == e0
        assert (r2["tiles_used"] == 1).all()
        _equal(r2, r1, "embed hit")
    finally:
        srv.close()
