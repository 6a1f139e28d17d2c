"""PyTorch port: the fleet (``serving.replica``, ``serving.router``) on
the CPU, at one small geometry (tile 16, image 32 from raw 64 at resize
40, extractor channels 8, depth 2), with one set of numpy weights shared
by every server.

* ``rendezvous_order`` equals the reference's on seeded digests (the
  blake2b scores are the reference's), and keeps the rendezvous
  properties (deterministic; removing or adding a replica remaps only
  what it owned or takes);
* a fleet of 1, 2 or 3 port replicas returns, request for request, the
  results of one port ``DetectionServer`` bit for bit, on explicit-key
  and content-key (``cache_exact``) traffic with a repeat;
* a replica crashed after admission (``FaultPlan.crash_after_admit``)
  hands its requests back, and a sibling re-executes them, equal to
  ``detect_batch`` under the same keys; an induced ``AdmissionError``
  spills over to a sibling, and when every replica refuses the router
  raises instead of looping;
* a rolling reconfigure under traffic drops nothing; a crash during
  its drain does not wedge it; a non-graceful close settles every
  pending handle exactly once; the ``FaultPlan`` seams hold.

No JAX server is started: the reference enters only through its pure
routing function.  Every threaded test carries the deadlock canary.
"""
import threading
import time

import numpy as np
import pytest
import torch

from canary import deadline
from repro.serving.router import rendezvous_order as jrendezvous_order
from repro_torch.core import extractor as ex
from repro_torch.core import prng
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.scheduler import StragglerPolicy
from repro_torch.serving import (AdmissionError, BatcherConfig,
                                 DetectionServer, FaultPlan, FleetRouter,
                                 Replica, ReplicaCrashed)
from repro_torch.serving.router import rendezvous, rendezvous_order

torch.set_num_threads(1)

FIELDS = ("message_bits", "ok", "n_corrected", "logits")
# no speculative re-execution: on two shared CPU cores a micro-batch can
# outlast the card-sized default timeout, and retry storms only cost time
# here (they change no result; tests/test_torch_serving.py covers them)
CALM = StragglerPolicy(min_timeout_s=60.0)


@pytest.fixture(scope="module")
def params():
    return ex.init_extractor_numpy(0, n_bits=60, channels=8, depth=2,
                                   tile=16)


def _cfg(**kw):
    return DetectionConfig(tile=16, img_size=32, resize_src=40, **kw)


def _replica(name, params, *, cfg=None, plan=None, max_wait_ms=2.0,
             max_batch=4):
    return Replica(name, cfg or _cfg(), params,
                   batcher=BatcherConfig(max_batch=max_batch,
                                         max_wait_ms=max_wait_ms),
                   fault_plan=plan, device="cpu", straggler_policy=CALM)


def _reqs(n, seed, max_group=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(rng.integers(1, max_group + 1)),
                                  64, 64, 3), dtype=np.uint8)
            for _ in range(n)]


def _equal(got, want, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{what} {f}")


def _match_detect_batch(params, reqs, keys, results):
    pipe = DetectionPipeline(_cfg(), params, device="cpu")
    try:
        for i, (r, k, res) in enumerate(zip(reqs, keys, results)):
            _equal(res, pipe.detect_batch(r, key=k), f"request {i}")
    finally:
        pipe.close()


# -- rendezvous ------------------------------------------------------------------
def test_rendezvous_order_equals_reference_and_is_stable():
    rng = np.random.default_rng(0)
    for n in range(1, 9):
        names = [f"r{i}" for i in range(n)]
        digests = [rng.bytes(32) for _ in range(24)]
        for d in digests:
            assert rendezvous_order(d, names) == jrendezvous_order(d, names)
            assert rendezvous(d, names[::-1]) == rendezvous(d, names)
        if n < 2:
            continue
        base = {d: rendezvous(d, names) for d in digests}
        for d in digests:       # removal remaps only the removed's digests
            if base[d] != names[0]:
                assert rendezvous(d, names[1:]) == base[d]
            assert rendezvous(d, names + ["new"]) in (base[d], "new")
    with pytest.raises(ValueError):
        rendezvous(b"d", [])


# -- fleet == one server ---------------------------------------------------------
@pytest.fixture(scope="module")
def single_server_results(params):
    """One port DetectionServer's results on the request set (explicit
    and content keys, an exact repeat)."""
    reqs = _reqs(6, seed=7)
    reqs.append(reqs[0].copy())
    keys = [prng.key(100 + i) if i % 2 else None for i in range(len(reqs))]
    srv = DetectionServer(_cfg(cache_exact=True), params,
                          batcher=BatcherConfig(max_batch=4,
                                                max_wait_ms=2.0),
                          straggler_policy=CALM, device="cpu").start()
    try:
        hs = [srv.submit(r, key=k) for r, k in zip(reqs, keys)]
        return reqs, keys, [h.result(120) for h in hs]
    finally:
        srv.close()


@pytest.mark.parametrize("n", [1, 2, 3])
@deadline(300)
def test_fleet_equals_single_server_bit_for_bit(params,
                                                single_server_results, n):
    reqs, keys, want = single_server_results
    cfg = _cfg(cache_exact=True)
    router = FleetRouter([_replica(f"r{i}", params, cfg=cfg)
                          for i in range(n)]).start()
    try:
        hs = [router.submit(r, key=k) for r, k in zip(reqs, keys)]
        got = [h.result(120) for h in hs]
        stats = router.stats()
    finally:
        router.close()
    for i, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"{n} replicas, request {i}")
    assert stats["counters"]["requests_completed"] == len(reqs)
    # identical pixels route to one replica, whose exact tier serves the
    # repeat (or coalesces it onto the first while in flight)
    fc = stats["fleet_counters"]
    assert fc.get("cache_hit_exact", 0) + fc.get("dedup_coalesced", 0) >= 1


# -- faults ----------------------------------------------------------------------
@deadline(300)
def test_crash_after_admit_reexecutes_on_sibling(params):
    reps = [_replica("doomed", params, plan=FaultPlan(crash_after_admit=0),
                     max_wait_ms=100.0),
            _replica("healthy", params)]
    router = FleetRouter(reps).start()
    reqs = _reqs(6, seed=11)
    keys = [prng.key(i) for i in range(len(reqs))]
    try:
        hs = [router.submit(r, key=k) for r, k in zip(reqs, keys)]
        results = [h.result(120) for h in hs]
        stats = router.stats()
    finally:
        router.close()
    assert stats["reroutes"] >= 1 and stats["unhealthy"] == 1
    assert stats["counters"].get("requests_failed", 0) == 0
    rerouted = [h for h in hs if h.reroutes]
    assert rerouted and all(h.replica == "healthy" for h in rerouted)
    _match_detect_batch(params, reqs, keys, results)


@deadline(300)
def test_spillover_on_induced_admission_error(params):
    reps = [_replica("full", params, plan=FaultPlan(reject_submits=1000)),
            _replica("sib-a", params), _replica("sib-b", params)]
    router = FleetRouter(reps).start()
    reqs = _reqs(6, seed=13)
    keys = [prng.key(40 + i) for i in range(len(reqs))]
    try:
        hs = [router.submit(r, key=k) for r, k in zip(reqs, keys)]
        results = [h.result(120) for h in hs]
        stats = router.stats()
    finally:
        router.close()
    assert stats["spillovers"] >= 1
    assert stats["counters"].get("requests_failed", 0) == 0
    spilled = [h for h in hs if h.spilled]
    assert spilled and all(h.replica != "full" for h in spilled)
    assert stats["fleet_counters"]["faults_injected"] == len(spilled)
    _match_detect_batch(params, reqs, keys, results)


@deadline(120)
def test_spillover_terminates_when_every_replica_refuses(params):
    router = FleetRouter([_replica(f"r{i}", params,
                                   plan=FaultPlan(reject_submits=1000))
                          for i in range(2)]).start()
    try:
        with pytest.raises(AdmissionError, match="no healthy replica"):
            router.submit(np.zeros((1, 64, 64, 3), np.uint8),
                          key=prng.key(0))
        assert router.stats()["counters"].get("requests_rejected") == 1
        assert router.drain(5)
    finally:
        router.close()


@deadline(300)
def test_rolling_reconfigure_under_traffic_drops_nothing(params):
    router = FleetRouter([_replica(f"r{i}", params) for i in range(2)])
    rng = np.random.default_rng(17)
    router.warmup(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    router.start()
    handles, refused = [], []
    stop = threading.Event()

    def pump():
        k = 0
        while not stop.is_set():
            img = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
            try:
                handles.append(router.submit(img, key=prng.key(k)))
            except AdmissionError as e:
                refused.append(e)
            k += 1
            time.sleep(0.02)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        time.sleep(0.1)
        applied = router.rolling_reconfigure(
            {"ingest": 1, "decode": 2, "rs": 1}, drain_timeout=60.0)
        time.sleep(0.1)
    finally:
        stop.set()
        t.join(10.0)
    try:
        assert applied == {f"r{i}": {"ingest": 1, "decode": 2, "rs": 1}
                           for i in range(2)}
        assert not refused
        assert all(h.result(120) is not None for h in handles)
        stats = router.stats()
        assert stats["counters"].get("requests_failed", 0) == 0
        assert stats["unhealthy"] == 0
        assert stats["counters"]["reconfigures"] == 2
    finally:
        router.close()


@deadline(300)
def test_crash_during_drain_does_not_wedge_the_roll(params):
    reps = [_replica("fragile", params, plan=FaultPlan(crash_on_drain=True),
                     max_wait_ms=100.0),
            _replica("steady", params)]
    router = FleetRouter(reps).start()
    reqs = _reqs(4, seed=31, max_group=2)
    keys = [prng.key(60 + i) for i in range(len(reqs))]
    try:
        hs = [router.submit(r, key=k) for r, k in zip(reqs, keys)]
        applied = router.rolling_reconfigure(drain_timeout=60.0)
        assert list(applied) == ["steady"]
        assert router.stats()["unhealthy"] == 1
        results = [h.result(120) for h in hs]
        post = router.submit(reqs[0], key=keys[0])
        assert post.result(120) is not None and post.replica == "steady"
    finally:
        router.close()
    _match_detect_batch(params, reqs, keys, results)


@deadline(300)
def test_close_rejects_pending_exactly_once(params):
    router = FleetRouter([_replica(f"r{i}", params, max_wait_ms=60_000.0,
                                   max_batch=32)
                          for i in range(2)]).start()
    reqs = _reqs(5, seed=23, max_group=2)
    hs = [router.submit(r, key=prng.key(i)) for i, r in enumerate(reqs)]
    fired = {h.rid: 0 for h in hs}
    for h in hs:
        h.add_done_callback(lambda hh: fired.__setitem__(
            hh.rid, fired[hh.rid] + 1))
    router.close(graceful=False)
    for h in hs:
        assert h.done()
        with pytest.raises(RuntimeError):
            h.result(0)
    assert all(v == 1 for v in fired.values()), fired
    with pytest.raises(AdmissionError, match="closed"):
        router.submit(reqs[0])
    router.close()


@deadline(120)
def test_replica_fault_plan_seams(params):
    rep = _replica("r0", params, plan=FaultPlan(reject_submits=2)).start()
    img = np.zeros((1, 64, 64, 3), np.uint8)
    try:
        for _ in range(2):
            with pytest.raises(AdmissionError, match="induced"):
                rep.submit(img, key=prng.key(0))
        assert rep.plan.reject_submits == 0
        assert rep.submit(img, key=prng.key(0)).result(60) is not None
        assert rep.healthy
        rep.crash("test")
        rep.crash("a second crash is a no-op")
        assert not rep.healthy
        with pytest.raises(ReplicaCrashed):
            rep.submit(img, key=prng.key(0))
        load = rep.load()
        assert load["headroom"] == 0 and load["queue_depth"] >= 1 << 30
        assert rep.drain(0.1) is False
        with pytest.raises(ReplicaCrashed):
            rep.reconfigure({"ingest": 1, "decode": 1, "rs": 1})
        assert rep.stats()["counters"]["faults_injected"] == 2
    finally:
        rep.close()
