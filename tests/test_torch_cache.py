"""PyTorch port: the serving cache (``repro_torch.serving.cache``) and the
server's exact tier, on the CPU at the reference tests' small size
(tile 16, img 32, resize_src 40, raw 48; extractor channels 8, depth 2).

Against the JAX package: the perceptual hashes, the sha256 digests, the
CRC fingerprint, ``result_key`` of the port's (2,) int64 key against the
reference's on ``jax.random.key`` of the same seed, and
``StageRegistry.content_key`` — all equal exactly.  In the port alone:
the LRU, embedding and in-flight tables as the reference's tests
describe them, and a module-scoped ``DetectionServer`` with the exact
tier on: a hit equals the cold path, ``detect_batch`` and ``run_batch``
at the content key bit for bit, explicit keys cache, dedup resolves
every follower once, classes and rejections are counted, and ``close``
rejects a queued leader with its followers.  Threaded tests carry the
deadlock canary.
"""
import jax
import numpy as np
import pytest
import torch

from canary import deadline
from repro.core import stages as jstages
from repro.core.detect import DetectionConfig as JConfig
from repro.serving import cache as jcache
from repro_torch.core import extractor as ex
from repro_torch.core import prng
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.serving import (AdmissionError, BatcherConfig,
                                 DetectionServer, EmbeddingCache,
                                 InFlightTable, ResultCache)
from repro_torch.serving import cache as cache_lib

torch.set_num_threads(1)

SMALL = dict(tile=16, img_size=32, resize_src=40)
FIELDS = ("message_bits", "ok", "n_corrected", "logits")


def _img(seed, h=48, w=48):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                np.uint8)


def _params():
    return ex.init_extractor_numpy(0, n_bits=60, channels=8, depth=2,
                                   tile=16)


# -- against the JAX package --------------------------------------------------
@pytest.mark.parametrize("hw", [(48, 48), (8, 80), (4, 3), (33, 17)])
def test_hashes_and_digests_equal_reference(hw):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    imgs = rng.integers(0, 256, (3, *hw, 3), np.uint8)
    for img in (imgs[0], imgs[1].astype(np.float32), imgs[2]):
        assert cache_lib.dhash(img) == jcache.dhash(img)
        assert cache_lib.ahash(img) == jcache.ahash(img)
        assert cache_lib.image_digest(img) == jcache.image_digest(img)
    d = cache_lib.request_digest(imgs)
    assert d == jcache.request_digest(imgs)
    assert cache_lib.fingerprint32(d) == jcache.fingerprint32(d)
    np.testing.assert_array_equal(cache_lib._resize_mean(imgs[0, ..., 0], 5, 7),
                                  jcache._resize_mean(imgs[0, ..., 0], 5, 7))


@pytest.mark.parametrize("seed", [0, 1, 77, 2 ** 31 - 1, -5])
def test_result_key_equals_reference(seed):
    d = cache_lib.image_digest(_img(3))
    mine = cache_lib.result_key(prng.key(seed), d)
    assert mine == jcache.result_key(jax.random.key(seed), d)
    # a folded key (words above 2^31) and a numpy key hash the same
    jk = jax.random.fold_in(jax.random.key(seed), 12345)
    tk = prng.fold_in(prng.key(seed), 12345)
    assert cache_lib.result_key(tk, d) == jcache.result_key(jk, d)
    assert cache_lib.result_key(tk.numpy(), d) == \
        cache_lib.result_key(tk, d)


@pytest.mark.parametrize("seed", [0, 3])
def test_content_key_equals_reference(seed):
    """``StageRegistry.content_key`` equals the reference registry's, and
    the server's ``content_key(images)`` is it on the request digest."""
    p = _params()
    jreg = jstages.StageRegistry(JConfig(**SMALL, seed=seed),
                                 jax.tree.map(np.asarray, p))
    pipe = DetectionPipeline(DetectionConfig(**SMALL, seed=seed), p,
                             device="cpu")
    imgs = np.stack([_img(seed + 10), _img(seed + 11)])
    fps = [0, 1, 2 ** 31, 2 ** 32 - 1,
           cache_lib.fingerprint32(cache_lib.request_digest(imgs))]
    for fp in fps:
        np.testing.assert_array_equal(
            pipe.stages.content_key(fp).numpy(),
            np.asarray(jax.random.key_data(jreg.content_key(fp))))
    srv = DetectionServer(DetectionConfig(**SMALL, seed=seed), p,
                          device="cpu")
    assert torch.equal(srv.content_key(imgs),
                       pipe.stages.content_key(fps[-1]))
    assert torch.equal(srv.content_key(imgs[0]),
                       pipe.stages.content_key(cache_lib.fingerprint32(
                           cache_lib.request_digest(imgs[:1]))))
    srv.close()


# -- the cache primitives (the reference's tests, on the port) -----------------
def test_resize_mean_exact_block_means():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (32, 48))
    np.testing.assert_allclose(cache_lib._resize_mean(x, 8, 8),
                               x.reshape(8, 4, 8, 6).mean(axis=(1, 3)),
                               rtol=1e-12)
    assert cache_lib._resize_mean(x, 5, 7).shape == (5, 7)
    with np.errstate(divide="raise", invalid="raise"):
        tiny = np.arange(12, dtype=np.float64).reshape(4, 3)
        np.testing.assert_allclose(cache_lib._resize_mean(tiny, 8, 9), tiny)
        assert cache_lib.dhash(np.zeros((4, 3, 3), np.uint8)) == 0


def test_image_digest_separates_flat_images_and_invariants():
    flats = [np.full((32, 32, 3), v, np.uint8) for v in (0, 128, 255)]
    assert len({cache_lib.image_digest(x) for x in flats}) == 3
    tweaked = flats[0].copy()
    tweaked[7, 9, 1] = 1
    assert cache_lib.image_digest(tweaked) != \
        cache_lib.image_digest(flats[0])
    for seed in range(5):
        img = _img(seed, 8 + 9 * seed, 70 - 9 * seed)
        d = cache_lib.image_digest(img)
        assert cache_lib.image_digest(img.astype(np.float64)) == d
        assert cache_lib.image_digest(
            img.astype(np.float32).astype(np.uint8)) == d
    a, b = _img(1), _img(2)
    assert cache_lib.request_digest(np.stack([a, b])) != \
        cache_lib.request_digest(np.stack([b, a]))


def test_result_cache_lru_and_buffer_isolation():
    c = ResultCache(capacity=2)
    r = {"ok": np.array([True]), "logits": np.zeros((1, 4))}
    c.put(b"a", r)
    r["logits"][:] = 9.0
    hit = c.get(b"a")
    assert hit["logits"].sum() == 0.0
    hit["logits"][:] = 5.0
    assert c.get(b"a")["logits"].sum() == 0.0
    c.put(b"b", r)
    assert c.get(b"a") is not None
    c.put(b"c", r)
    assert c.get(b"b") is None and len(c) == 2
    with pytest.raises(ValueError):
        ResultCache(capacity=0)


def test_embedding_cache_threshold_and_degenerates():
    c = EmbeddingCache(capacity=2, threshold=0.9)
    rows = {"ok": np.array(True)}
    c.put(np.array([2.0, 0.0]), rows)
    assert c.get(np.array([7.0, 0.0])) is not None
    assert c.get(np.array([1.0, 1.0])) is None
    assert c.get(np.array([0.9, 0.1])) is not None
    assert c.get(np.zeros(2)) is None
    c.put(np.zeros(2), rows)
    assert len(c) == 1
    c.put(np.array([0.0, 1.0]), rows)
    c.put(np.array([1.0, 1.0]), rows)
    assert len(c) == 2 and c.get(np.array([5.0, 0.0])) is None
    with pytest.raises(ValueError):
        EmbeddingCache(threshold=0.0)


def test_inflight_attach_pop_exactly_once():
    t = InFlightTable()
    assert t.attach(b"k", "L") is False
    assert t.attach(b"k", "f1") is True and t.attach(b"k", "f2") is True
    assert t.depth() == 2
    assert t.pop(b"k") == ["f1", "f2"] and t.pop(b"k") == []
    assert t.pop(None) == []
    assert t.attach(b"k", "L2") is False


# -- the server's exact tier ----------------------------------------------------
def _cfg(**kw):
    return DetectionConfig(**SMALL, **kw)


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def exact_srv(params):
    srv = DetectionServer(
        _cfg(cache_exact=True, cache_capacity=32), params,
        batcher=BatcherConfig(max_batch=4, max_wait_ms=40.0,
                              classes={"interactive": 40.0,
                                       "bulk": 400.0}), device="cpu")
    srv.warmup(_img(0))
    srv.start()
    yield srv
    srv.close()


@deadline(120)
def test_exact_hit_equals_cold_path_and_offline_engines(exact_srv, params):
    imgs = np.stack([_img(10), _img(11)])
    m0 = exact_srv.metrics.counter("cache_miss")
    h0 = exact_srv.metrics.counter("cache_hit_exact")
    cold = exact_srv.submit(imgs).result(60)
    hit = exact_srv.submit(np.array(imgs, copy=True)).result(60)
    assert exact_srv.metrics.counter("cache_miss") == m0 + 1
    assert exact_srv.metrics.counter("cache_hit_exact") == h0 + 1
    ckey = exact_srv.content_key(imgs)
    pipe = DetectionPipeline(_cfg(), params, device="cpu")
    offline = pipe.detect_batch(imgs, key=ckey)
    sharded = pipe.run_batch(imgs, key=ckey, mesh=["cpu", "cpu"])
    for f in FIELDS:
        for other in (hit, offline, sharded):
            assert cold[f].dtype == other[f].dtype, f
            np.testing.assert_array_equal(cold[f], other[f], err_msg=f)


@deadline(120)
def test_explicit_key_traffic_caches_too(exact_srv):
    imgs = _img(20)[None]
    h0 = exact_srv.metrics.counter("cache_hit_exact")
    r1 = exact_srv.submit(imgs, key=prng.key(77)).result(60)
    r2 = exact_srv.submit(imgs, key=prng.key(77)).result(60)
    assert exact_srv.metrics.counter("cache_hit_exact") == h0 + 1
    for f in FIELDS:
        np.testing.assert_array_equal(r1[f], r2[f], err_msg=f)
    h1 = exact_srv.metrics.counter("cache_hit_exact")
    exact_srv.submit(imgs, key=prng.key(78)).result(60)
    assert exact_srv.metrics.counter("cache_hit_exact") == h1


@deadline(120)
def test_dedup_in_flight_resolves_every_follower_once(exact_srv):
    imgs = _img(30)[None]
    d0 = exact_srv.metrics.counter("dedup_coalesced")
    c0 = exact_srv.metrics.counter("requests_completed")
    handles = [exact_srv.submit(np.array(imgs, copy=True))
               for _ in range(3)]
    results = [h.result(60) for h in handles]
    assert exact_srv.metrics.counter("dedup_coalesced") == d0 + 2
    assert exact_srv.metrics.counter("requests_completed") == c0 + 3
    for f in FIELDS:
        for r in results[1:]:
            np.testing.assert_array_equal(results[0][f], r[f], err_msg=f)
            assert r[f] is not results[0][f]
    assert exact_srv._dedup.depth() == 0


@deadline(120)
def test_priority_classes_and_rejected_accounting(exact_srv):
    with pytest.raises(AdmissionError, match="unknown priority"):
        exact_srv.submit(_img(40)[None], priority="nope")
    r0 = exact_srv.metrics.counter("requests_rejected")
    f0 = exact_srv.metrics.counter("requests_failed")
    exact_srv.submit(_img(41)[None], priority="bulk").result(60)
    with pytest.raises(AdmissionError):
        exact_srv.submit(_img(42)[None], priority="also-nope")
    st = exact_srv.stats()
    assert st["counters"]["requests_rejected"] >= r0 + 1
    assert st["counters"].get("requests_failed", 0.0) == f0
    assert "request_latency_bulk_s" in st
    assert "request_latency_interactive_s" in st
    assert 0.0 < st["rejection_rate"] < 1.0
    c = st["counters"]
    hits = c.get("cache_hit_exact", 0) + c.get("dedup_coalesced", 0)
    assert st["cache_hit_rate"] == pytest.approx(
        hits / (hits + c.get("cache_miss", 0)))
    assert st["class_depths"] == {"interactive": 0, "bulk": 0}


@deadline(60)
def test_close_rejects_coalesced_followers(params):
    srv = DetectionServer(_cfg(cache_exact=True), params,
                          batcher=BatcherConfig(max_batch=4,
                                                max_wait_ms=5000.0),
                          device="cpu")
    imgs = _img(50)[None]
    leader = srv.submit(imgs)
    follower = srv.submit(np.array(imgs, copy=True))
    assert srv.metrics.counter("dedup_coalesced") == 1
    srv.close()
    for h in (leader, follower):
        with pytest.raises(RuntimeError, match="closed"):
            h.result(1)
    assert srv.metrics.counter("requests_failed") == 2
    assert srv._finished == srv._admitted
