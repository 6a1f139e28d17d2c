"""PyTorch port: the lane executor, Algorithms 1 and 2, the stage graph,
``run_stream``, the offline ``DetectionService`` and the data-parallel
``run_batch`` on the CPU, at the small size the reference's own lane
tests use (tile 16, img 32, resize_src 40, raw 64; extractor channels 8,
depth 2, with the bank; b <= 4 where JAX runs).

* The executor (plain threading, the reference's) in both modes.
* The allocator and the LPT scheduler are pure Python copied from the
  reference: exactly equal to it on seeded profiles and task pools.
* ``run_stream`` at lanes 1, 3, the default map and a dict equals the
  port's serial ``detect_batch`` over the same batches with the same
  keys, bit for bit, in every mode, RS engine and rung, with escalation
  and padded items, and so does the executor's service mode.
* One whole-slice check against JAX: the reference's
  ``DetectionService(lanes=2).serve`` against the port's on the same
  batches (RS outputs exact — both run the scalar codec on the bits —
  and logits within 1e-4 * (1 + max|logit|)), with ``warmup_stats``
  fixed on both sides, so the LPT split depends on no timing.
* ``run_batch`` over 4 CPU "devices" and over one equals
  ``detect_batch`` on every real row of a ragged batch.
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocator as jalloc
from repro.core import scheduler as jsched
from repro.core.detect import DetectionConfig as JConfig
from repro.launch.serve import DetectionService as JService
from repro_torch.core import allocator, scheduler
from repro_torch.core import extractor as ex
from repro_torch.core import interleave, prng
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.lanes import (LaneExecutor, LaneStreams, Stage,
                                    hand_over, lanes_from_allocation,
                                    receive)
from repro_torch.kernels import _build, ops
from repro_torch.launch.serve import DetectionService
from repro_torch.serving.batcher import AdmissionError, pad_to_bucket

torch.set_num_threads(1)

SMALL = dict(tile=16, img_size=32, resize_src=40)


# ---------------------------------------------------------------------------
# the executor (mirrors tests/test_lanes.py's executor tests)
# ---------------------------------------------------------------------------


def test_executor_preserves_order_with_many_lanes():
    def jitter(x):
        time.sleep(0.001 * (x % 5))  # out-of-order completion
        return x * 2

    ex_ = LaneExecutor([Stage("a", jitter, lanes=4, depth=3),
                        Stage("b", lambda x: x + 1, lanes=3, depth=3)])
    assert ex_.map(range(40)) == [i * 2 + 1 for i in range(40)]


def test_executor_propagates_stage_error_in_order():
    seen = []

    def boom(x):
        if x == 5:
            raise ValueError("boom")
        return x

    ex_ = LaneExecutor([Stage("s", boom, lanes=2, depth=2)])
    with pytest.raises(ValueError, match="boom"):
        for x in ex_.run(range(10)):
            seen.append(x)
    assert seen == [0, 1, 2, 3, 4]


def test_executor_propagates_source_error_after_fed_items():
    def src():
        yield from range(3)
        raise RuntimeError("source died")

    ex_ = LaneExecutor([Stage("s", lambda x: x, lanes=2)])
    seen = []
    with pytest.raises(RuntimeError, match="source died"):
        for x in ex_.run(src()):
            seen.append(x)
    assert seen == [0, 1, 2]


def test_executor_stage_concurrency_actually_overlaps():
    peak, live = [0], [0]
    lock = threading.Lock()

    def fn(x):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.02)
        with lock:
            live[0] -= 1
        return x

    LaneExecutor([Stage("s", fn, lanes=4, depth=4)]).map(range(12))
    assert peak[0] >= 2, f"no overlap observed (peak in-flight {peak[0]})"


def test_executor_is_single_use():
    ex_ = LaneExecutor([Stage("s", lambda x: x)])
    assert ex_.map(range(3)) == [0, 1, 2]
    with pytest.raises(RuntimeError, match="single-use"):
        ex_.map(range(3))


def test_executor_bounds_in_flight_work():
    prepared = []
    ex_ = LaneExecutor([Stage("s", lambda x: (prepared.append(x), x)[1],
                              depth=2)])
    gen = ex_.run(range(100))
    next(gen)
    time.sleep(0.2)
    in_flight = len(prepared)
    ex_.close()
    assert in_flight < 20, \
        f"stage ran {in_flight} items ahead of a stalled consumer"


def test_lanes_from_allocation_and_stage_checks():
    assert lanes_from_allocation(("ingest", "decode", "rs"), [1, 4, 0]) == \
        {"ingest": 1, "decode": 4, "rs": 1}
    with pytest.raises(ValueError, match="lanes"):
        Stage("s", lambda x: x, lanes=0)
    with pytest.raises(ValueError, match="depth"):
        Stage("s", lambda x: x, depth=0)


# -- service mode ------------------------------------------------------------


def test_service_completes_out_of_order_and_drains():
    release = threading.Event()

    def fn(x):
        if x == 0:
            release.wait(5)       # the first payload finishes last
        return x * 10

    ex_ = LaneExecutor([Stage("s", fn, lanes=3, depth=4)]).start()
    order = []
    try:
        tickets = [ex_.submit(i, callback=lambda t: order.append(t.seq))
                   for i in range(4)]
        assert tickets[3].result(5) == 30 and not tickets[0].done()
        assert ex_.pending() == 1
        release.set()
        assert ex_.drain(5) and ex_.pending() == 0
        assert [t.result(1) for t in tickets] == [0, 10, 20, 30]
        assert order[-1] == 0 and sorted(order) == [0, 1, 2, 3]
    finally:
        ex_.close()


def test_service_stage_error_rejects_only_its_ticket():
    def fn(x):
        if x == 1:
            raise KeyError("bad payload")
        return x

    ex_ = LaneExecutor([Stage("s", fn, lanes=2)]).start()
    try:
        t = [ex_.submit(i) for i in range(3)]
        assert ex_.drain(5)
        assert isinstance(t[1].exception(1), KeyError)
        assert t[0].result(1) == 0 and t[2].result(1) == 2
    finally:
        ex_.close()


def test_service_close_rejects_pending_tickets_and_fires_callbacks():
    gate = threading.Event()
    ex_ = LaneExecutor([Stage("s", lambda x: (gate.wait(5), x)[1],
                              lanes=1, depth=4)]).start()
    fired = []
    tickets = [ex_.submit(i, callback=lambda t: fired.append(t.seq))
               for i in range(3)]
    threading.Timer(0.1, gate.set).start()   # the busy lane then exits
    ex_.close()
    for t in tickets:
        assert t.done()
        with pytest.raises(RuntimeError, match="closed"):
            t.result(1)
    assert sorted(fired) == [0, 1, 2]
    with pytest.raises(RuntimeError, match="closed"):
        ex_.submit(9)
    assert not any(th.is_alive() for th in ex_._service_threads)


def test_service_reconfigure_up_and_down_loses_no_payload():
    ex_ = LaneExecutor([Stage("a", lambda x: x + 1, lanes=1, depth=2),
                        Stage("b", lambda x: (time.sleep(0.002), x * 2)[1],
                              lanes=1, depth=2)]).start()
    try:
        tickets = [ex_.submit(i) for i in range(10)]
        assert ex_.reconfigure({"b": 4}) == {"a": 1, "b": 4}
        tickets += [ex_.submit(i) for i in range(10, 20)]
        assert ex_.reconfigure({"a": 2, "b": 1}) == {"a": 2, "b": 1}
        tickets += [ex_.submit(i) for i in range(20, 30)]
        assert ex_.drain(10)
        assert [t.result(1) for t in tickets] == \
            [(i + 1) * 2 for i in range(30)]
        assert ex_.lane_counts() == {"a": 2, "b": 1}
        with pytest.raises(RuntimeError, match="service"):
            LaneExecutor([Stage("s", lambda x: x)]).reconfigure({"s": 2})
    finally:
        ex_.close()


def test_lane_streams_are_host_threads_on_the_cpu():
    fn = lambda p: p  # noqa: E731
    assert LaneStreams("cpu").wrap(fn) is fn
    p = {"x": torch.zeros(2)}
    hand_over(p, None)            # no CUDA tensor: no event
    receive(p, None)
    assert list(p) == ["x"]


def test_prefetch_iterator_places_on_the_device():
    data = [(np.full((2, 3), i, np.uint8), i) for i in range(5)]
    it = interleave.PrefetchIterator(iter(data), device="cpu")
    got = list(it)
    assert [tb for _, tb in got] == list(range(5))
    assert all(isinstance(x, torch.Tensor) and int(x[0, 0]) == i
               for i, (x, _) in enumerate(got))
    assert list(interleave.interleaved(range(3), prepare=lambda x: x + 1,
                                       enabled=False)) == [1, 2, 3]


# ---------------------------------------------------------------------------
# Algorithms 1 and 2: exactly the reference's
# ---------------------------------------------------------------------------


def _profiles(rng, mods):
    out = []
    for name in ("ingest", "decode", "rs"):
        t, u, o = rng.uniform(1e-6, 3e-4), rng.uniform(1e3, 5e6), \
            rng.uniform(0, 2e-4)
        out.append((mods.StageProfile(name, t, u, o)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_allocation_equals_reference(seed):
    rng_a, rng_b = (np.random.default_rng(seed) for _ in range(2))
    pa, pb = _profiles(rng_a, allocator), _profiles(rng_b, jalloc)
    for B, budget, cap in ((16, 8, 16e9), (32, 8, 2e9), (256, 32, 16e9),
                           (64, 5, 1e8)):
        a = allocator.adaptive_allocation(pa, global_batch=B,
                                          stream_budget=budget, mem_cap=cap)
        b = jalloc.adaptive_allocation(pb, global_batch=B,
                                       stream_budget=budget, mem_cap=cap)
        assert (a.streams, a.minibatch, a.bottleneck_s, a.history) == \
            (b.streams, b.minibatch, b.bottleneck_s, b.history)
        assert allocator.assign(pa, global_batch=B, lane_budget=budget,
                                mem_cap=cap) == \
            jalloc.assign(pb, global_batch=B, lane_budget=budget,
                          mem_cap=cap)
        for p, q in zip(pa, pb):
            assert allocator.stage_time(p, 3, 8, B) == \
                jalloc.stage_time(q, 3, 8, B)


def _fields(task):
    return (task.task_id, task.n_samples, task.tile, task.lat, task.mem,
            task.minibatch)


@pytest.mark.parametrize("seed", range(6))
def test_lpt_schedule_and_tasks_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 40))
    stats = {16: (float(rng.uniform(1e-5, 1e-3)), 1e4),
             32: (float(rng.uniform(1e-5, 1e-3)), 4e4)}
    metas = [{"i": i, "tile": int(rng.choice([16, 32, 48]))}
             for i in range(n)]
    group = int(rng.integers(1, 5))
    ta = scheduler.build_tasks(metas, stats, b0=n, group=group,
                               select_tile=lambda m: m["tile"])
    tb = jsched.build_tasks(metas, stats, b0=n, group=group,
                            select_tile=lambda m: m["tile"])
    assert [_fields(t) for t in ta] == [_fields(t) for t in tb]
    for lanes, slack, cap, b_min in ((3, 0.25, 1e9, 1), (5, 0.0, 2e5, 2),
                                     (8, 0.5, 1e9, 1)):
        sa = scheduler.lpt_schedule(ta, n_lanes=lanes, balance_slack=slack,
                                    mem_cap=cap, b_min=b_min, global_batch=n)
        sb = jsched.lpt_schedule(tb, n_lanes=lanes, balance_slack=slack,
                                 mem_cap=cap, b_min=b_min, global_batch=n)
        assert (sa.m_unit, sa.loads, sa.imbalance) == \
            (sb.m_unit, sb.loads, sb.imbalance)
        assert [[_fields(t) for t in ln] for ln in sa.lanes] == \
            [[_fields(t) for t in ln] for ln in sb.lanes]


def test_straggler_monitor_equals_reference(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    ma, mb = scheduler.StragglerMonitor(), jsched.StragglerMonitor()
    trace = []
    for m in (ma, mb):
        clock[0] = 0.0
        out = []
        for tid in range(6):
            m.start(tid)
        for tid, dt in ((0, 0.01), (1, 0.02), (2, 0.03)):
            clock[0] += dt
            out.append(m.complete(tid))
        out.append(m.complete(1))          # duplicate
        clock[0] += 1.0
        out += [m.timeout_s(), m.stragglers()]
        m.mark_retried(4)
        m.mark_retried(4)
        clock[0] += 1.0
        out += [m.stragglers(), m.retry_count]
        trace.append(out)
    assert trace[0] == trace[1]


def test_profile_stage_walks_tensors_arrays_and_trees():
    calls = []

    def fn(batch):
        calls.append(batch[0].shape[0])
        return {"y": torch.as_tensor(batch[0]) * 2, "n": np.ones(3)}

    sample = (np.zeros((8, 4), np.float32), torch.zeros(8, 2,
                                                         dtype=torch.int64))
    p = allocator.profile_stage(fn, sample, iters=2, name="s")
    assert p.name == "s" and p.t_per_sample > 0 and p.launch_overhead >= 0
    assert p.u_per_sample == (4 * 4 + 2 * 8)
    assert calls == [8, 8, 8, 1, 1, 1]


# ---------------------------------------------------------------------------
# run_stream == serial detect_batch, bit for bit
# ---------------------------------------------------------------------------


def _params():
    return ex.init_extractor_numpy(0, n_bits=60, channels=8, depth=2,
                                   tile=16, bias_scale=0.1)


def _batches(n=4, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
            for _ in range(n)]


def _pipe(**kw):
    return DetectionPipeline(DetectionConfig(**SMALL, rs_threads=2, **kw),
                             ex.params_from_numpy(_params()), device="cpu")


def _serial(pipe, items):
    out = []
    for i, item in enumerate(items):
        raw, tb = item if isinstance(item, tuple) else (item, None)
        out.append(pipe.detect_batch(raw, key=pipe.stages.batch_key(i),
                                     true_b=tb))
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


LANE_MAPS = [1, 3, None, {"ingest": 2, "decode": 3, "rs": 2}]


@pytest.mark.parametrize("cfg", [
    dict(mode="qrmark", rs_mode="device"),
    dict(mode="qrmark", rs_mode="device", decode_dtype="int8"),
    dict(mode="qrmark", rs_mode="cpu_sync", tile_first=False),
    dict(mode="qrmark", rs_mode="cpu_pool", decode_dtype="int8",
         decode_schedule="bb2-ct4"),
    dict(mode="tiled", rs_mode="cpu_pool"),
    dict(mode="sequential", rs_mode="cpu_sync")],
    ids=["qrmark-device", "qrmark-device-int8", "staged-cpu_sync",
         "qrmark-cpu_pool-int8-blocked", "tiled-cpu_pool",
         "sequential-cpu_sync"])
def test_run_stream_equals_serial_at_every_lane_map(cfg):
    pipe = _pipe(**cfg)
    try:
        data = _batches(n=2)
        want = _serial(pipe, data)
        for lanes in LANE_MAPS:
            pipe._seq = 0
            out = pipe.run_stream(data, lanes=lanes)
            _equal(out["results"], want)
            assert out["images"] == 8 and pipe._seq == 2
            if lanes is None:
                assert out["lanes"] == pipe.default_lanes()
            elif isinstance(lanes, int):
                assert out["lanes"] == {"ingest": 1, "decode": lanes,
                                        "rs": lanes}
            else:
                assert out["lanes"] == lanes
    finally:
        pipe.close()


def test_run_stream_escalates_padded_items_like_serial():
    """escalate_tiles=3 through the rs lane, with a (raw, true_b) item
    padded by pad_to_bucket: pad rows never escalate."""
    pipe = _pipe(mode="tiled", escalate_tiles=3)
    try:
        data = _batches(n=2)
        items = [pad_to_bucket(data[0][:3]), data[1]]
        assert items[0][0].shape[0] == 4 and items[0][1] == 3
        want = _serial(pipe, items)
        assert (want[0]["tiles_used"][3] == 1 and
                (want[0]["tiles_used"][:3] > 1).any())
        for lanes in (1, None, {"ingest": 2, "decode": 2, "rs": 3}):
            pipe._seq = 0
            _equal(pipe.run_stream(items, lanes=lanes)["results"], want)
    finally:
        pipe.close()


def test_escalation_round_payloads_equal_escalate_round_summed():
    """A round r > 0 payload through build_stages(escalate_inline=False)
    ingests plan column r, decodes it and adds acc_logits; RS runs on
    the sum."""
    pipe = _pipe(escalate_tiles=3)
    st = pipe.stages
    raw = torch.as_tensor(_batches(n=1)[0])
    keys = st.image_keys(st.batch_key(7), 4)
    acc = st.escalate_round(raw, keys, 0)
    stages = st.build_stages({"decode": 2, "rs": 2}, escalate_inline=False)
    ex_ = LaneExecutor(stages)
    outs = ex_.map([{"raw": raw.numpy(), "keys": keys, "round": r,
                     "acc_logits": acc.numpy(), "slot": r}
                    for r in (1, 2)])
    for r, p in zip((1, 2), outs):
        want = acc + st.escalate_round(raw, keys, r)
        assert torch.equal(p["logits"], want) and p["slot"] == r
        msg, ok, ncorr = st.rs_correct(st.bits(want))
        assert torch.equal(p["msg"], msg) and torch.equal(p["ok"], ok)
        assert "tiles_used" not in p
    # emit_embed: round 0 also carries the GAP embedding, its logits
    # bitwise the embed-free graph's; round r > 0 payloads carry none
    emb = LaneExecutor(st.build_stages({"decode": 2}, escalate_inline=False,
                                       emit_embed=True)).map(
        [{"raw": raw.numpy(), "keys": keys},
         {"raw": raw.numpy(), "keys": keys, "round": 1,
          "acc_logits": acc.numpy()}])
    x = st.ingest_keyed(raw, keys)
    want, g = st.decode_keyed_embed(x, keys)
    assert torch.equal(emb[0]["logits"], st.decode_keyed(x, keys))
    assert torch.equal(emb[0]["logits"], want)
    assert torch.equal(emb[0]["embed"], g) and g.shape == (4, 60)
    assert "embed" not in emb[1]
    assert torch.equal(emb[1]["logits"], outs[0]["logits"])


def test_service_mode_stage_graph_equals_serial():
    """The executor's service mode over the pipeline's stage graph: the
    same results as serial detect_batch, in completion order."""
    pipe = _pipe(rs_mode="cpu_sync")
    data = _batches(n=5)
    want = _serial(pipe, data)
    ex_ = LaneExecutor(pipe.build_stages({"decode": 3, "rs": 2})).start()
    done = []
    try:
        tickets = [ex_.submit(
            {"raw": raw, "keys": pipe.stages.image_keys(
                pipe.stages.batch_key(i), raw.shape[0])},
            callback=lambda t: done.append(t.seq))
            for i, raw in enumerate(data)]
        assert ex_.drain(60)
        _equal([t.result(1) for t in tickets], want)
        assert sorted(done) == list(range(5))
    finally:
        ex_.close()


def test_run_stream_prepares_before_the_first_payload(monkeypatch):
    pipe = _pipe()
    events = []
    prepare = pipe.stages.prepare
    monkeypatch.setattr(pipe.stages, "prepare",
                        lambda shape: (events.append(("prepare", shape)),
                                       prepare(shape)))
    ingest = pipe.stages.ingest_keyed
    monkeypatch.setattr(pipe.stages, "ingest_keyed",
                        lambda raw, keys: (events.append("ingest"),
                                           ingest(raw, keys))[1])
    pipe.run_stream(_batches(n=3), lanes=3)
    assert events[0] == ("prepare", (4, 64, 64, 3))
    assert events[1:] == ["ingest"] * 3


def test_a_stage_error_fails_run_stream_in_order(monkeypatch):
    pipe = _pipe()
    decode = pipe.stages.decode_keyed
    calls = [0]

    def flaky(x, keys):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("decode failed")
        return decode(x, keys)

    monkeypatch.setattr(pipe.stages, "decode_keyed", flaky)
    seen = []
    with pytest.raises(RuntimeError, match="decode failed"):
        pipe.run_stream(_batches(n=4), lanes=1,
                        on_result=lambda i, r: seen.append(i))
    assert seen == [0]


# ---------------------------------------------------------------------------
# the offline service against the reference's
# ---------------------------------------------------------------------------


def test_service_equals_reference_service():
    p = _params()
    data = _batches(n=3, b=4, seed=3) + [_batches(n=1, b=3, seed=4)[0]]
    stats = {16: (1e-3, 1e3)}
    jsvc = JService(JConfig(**SMALL, rs_mode="cpu_sync"),
                    jax.tree.map(jnp.asarray, p), lanes=2)
    tsvc = DetectionService(DetectionConfig(**SMALL, rs_mode="cpu_sync"),
                            ex.params_from_numpy(p), lanes=2, device="cpu")
    jsvc.warmup_stats = dict(stats)
    tsvc.warmup_stats = dict(stats)
    jres = []
    run = jsvc.pipe.run_stream
    jsvc.pipe.run_stream = lambda *a, **k: (lambda o: (jres.extend(
        o["results"]), o)[1])(run(*a, **k))
    jrep = jsvc.serve(data)
    trep = tsvc.serve(data)
    tsvc.close()
    fields = ("images", "lanes", "lane_loads", "allocation",
              "straggler_retries")
    assert [getattr(trep, f) for f in fields] == \
        [getattr(jrep, f) for f in fields]
    assert trep.images == 15 and trep.allocation is None
    assert trep.lanes == {"ingest": 1, "decode": 2, "rs": 2}
    assert len(tsvc.results) == len(jres) == 15
    for t, j in zip(tsvc.results, jres):
        for k in ("message_bits", "ok", "n_corrected"):
            np.testing.assert_array_equal(t[k], np.asarray(j[k]), err_msg=k)
        jl = np.asarray(j["logits"])
        np.testing.assert_allclose(t["logits"], jl, rtol=0,
                                   atol=1e-4 * (1 + np.abs(jl).max()))


def test_service_results_equal_serial_over_its_work_items():
    svc = DetectionService(DetectionConfig(**SMALL),
                           ex.params_from_numpy(_params()), device="cpu")
    alloc = svc.warmup(_batches(n=1)[0])
    assert len(svc.profiles) == 3 and len(alloc.streams) == 3
    assert set(svc.lanes) == {"ingest", "decode", "rs"}
    data = [_batches(n=1, b=4)[0], _batches(n=1, b=3, seed=1)[0]]
    work, loads = svc.plan(data)
    assert sum(tb for _, tb in work) == 7 and len(loads) == \
        sum(svc.lanes.values())
    rep = svc.serve(data)
    ref = DetectionPipeline(svc.det_cfg, ex.params_from_numpy(_params()),
                            device="cpu")
    want = [{k: v[:tb] for k, v in r.items()}
            for r, (_, tb) in zip(_serial(ref, work), work)]
    _equal(svc.results, want)
    assert rep.images == 7 and rep.lane_loads == [round(x, 6) for x in loads]
    svc.close()


def test_pad_to_bucket():
    raw = np.arange(5)[:, None].repeat(2, 1)
    padded, tb = pad_to_bucket(raw)
    assert tb == 5 and padded.shape[0] == 8 and (padded[5:] == 4).all()
    assert pad_to_bucket(raw, 3)[0].shape[0] == 6
    assert pad_to_bucket(raw[:4])[0].shape[0] == 4
    with pytest.raises(AdmissionError):
        pad_to_bucket(raw[:0])


# ---------------------------------------------------------------------------
# data-parallel run_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,n_dev", [
    (dict(rs_mode="device"), 1), (dict(rs_mode="device"), 4),
    (dict(rs_mode="cpu_sync", decode_dtype="int8"), 4),
    (dict(rs_mode="device", escalate_tiles=3), 4)])
def test_run_batch_equals_detect_batch_on_real_rows(cfg, n_dev):
    pipe = _pipe(**cfg)
    raw7 = _batches(n=1, b=7, seed=5)[0]
    key = prng.key(9)
    want = pipe.detect_batch(raw7, key=key)
    got = pipe.run_batch(raw7, mesh=["cpu"] * n_dev, key=key)
    _equal([got], [want])
    pipe.close()


def test_run_batch_uses_the_offline_key_sequence():
    pipe = _pipe()
    raw = _batches(n=1, b=4)[0]
    got = [pipe.run_batch(raw, mesh=["cpu"] * 2) for _ in range(2)]
    _equal(got, _serial(pipe, [raw, raw]))


# ---------------------------------------------------------------------------
# thread safety of the launch counters
# ---------------------------------------------------------------------------


def test_launch_counters_are_exact_under_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launch_counts()
        n = 2000

        def work():
            for _ in range(n):
                _build.count("rs_decode")
                _build.count_kernel("k")

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ops.launch_counts()["rs_decode"] == 8 * n
        assert ops.kernel_launch_counts() == {"k": 8 * n}
    finally:
        sys.setswitchinterval(old)
        ops.reset_launch_counts()
