"""Online request-level detection server (counterpart of
``repro.serving.server``).

``DetectionServer`` is the deployment regime the paper's system layer
targets (provenance checks under heavy user traffic): requests arrive
over time, are coalesced by the dynamic micro-batcher, flow through a
**persistent service-mode lane executor** running the same stage
registry as every offline engine, and scatter back to per-request
futures the moment their micro-batch completes.

Request lifecycle::

    submit(images, key) ──► content cache (tier-1 exact sha256 hit →
        resolve immediately; identical request in flight → coalesce
        onto it) ──► admission (per-class depth bound; empty/oversized
        rejected) ──► MicroBatcher class queues (priority pop, tiered
        deadlines) ──► deadline/size-triggered micro-batch ──►
        service-mode LaneExecutor (ingest ► decode ► rs, N lanes
        each) ──► tier-2 embedding cache (escalation short-circuit)
        ──► result scatter (cache fill + dedup fan-out) ──►
        RequestHandle.result()

Content-addressed caching (``DetectionConfig.cache_exact`` /
``cache_embedding_threshold``, machinery in ``serving.cache``): tier 1
keys on a cryptographic content digest (sha256 over shape + canonical
pixel bytes, host-side, pre-admission — collision-free, so a hit can
only ever serve the same image's result) joined with the request
fold_in key; hits bypass admission and are **bitwise identical** to
the cold path because content-derived default keys make identical
pixels take identical RNG paths.  Concurrent identical requests
coalesce onto one execution (dedup-in-flight) — straggler/retry
accounting stays per-underlying-execution.  Tier 2 is approximate by
construction (near-duplicate GAP embeddings, cosine-thresholded) and
only fires for images *headed into escalation*: a hit substitutes the
near-duplicate's FULL cached payload (message_bits, ok, n_corrected,
logits — the image's own round-0 decode is discarded) in place of
running the escalation rounds.  The round-0 decode itself always
executes (it produces the probe embedding), and images that settle at
round 0 are never touched by this tier.

Correctness anchor: results are **bit-identical** to
``DetectionPipeline.detect_batch`` of the same images with the same
keys, for any arrival order, coalescing, bucket size, or lane config —
each request carries its own fold_in key, per-image keys are derived
per *request* (not per coalesced batch) by the shared
``StageRegistry.image_keys``, and padding rows are sliced off before
the scatter.

Beyond the paper: straggler speculative re-execution (the watchdog
re-submits micro-batches that exceed the ``StragglerMonitor`` timeout;
first completion wins) and live lane reallocation (Algorithm 1 re-run
on *measured* stage latencies, applied with ``LaneExecutor.reconfigure``
without dropping queued work).

Adaptive escalation online (``DetectionConfig.escalate_tiles > 1``):
when a micro-batch completes its single-tile round, only the FAILED
(or thin-margin) images across its requests are regrouped into an
**escalation micro-batch** — a round-r payload the same stage graph
ingests as tile r of each image's plan, adding the new soft bits onto
the carried accumulator — and re-submitted to the executor, round by
round, until every image settles or the tile budget is spent.
Escalation batches get the full straggler treatment (monitored,
speculatively re-executed, first completion wins); requests resolve
when their last escalating image settles, bit-identical to
``detect_batch`` of the same images/keys at the same config.
Escalation rate, per-image tiles, and batch counts are exported
through the metrics registry (``stats()``).

On the card: the server runs on ``device`` (``None`` = the first CUDA
device, raising if there is none; ``"cpu"`` runs the kernels' plain
versions, as the tests do), and every stage call, key derivation aside,
runs under ``torch.cuda.device`` of it.  Each lane of the executor is a
CUDA stream of its own (``lanes.LaneStreams``); the rs lane's sink turns
a micro-batch's device tensors into numpy on its own stream, so every
consumer outside the executor (the scatter, the escalation gather, the
embedding tier) reads host arrays only.  Per-request keys are derived on
the host and cross to the card with their micro-batch.  PyTorch runs
eagerly and every kernel is batch-stable, so an escalation group
decodes its true rows: the reference pads each group to a power of two
for its jit shapes, which changes no row's result.  Stage times for the
online Algorithm 1 profiles are host wall times of the stage calls, as
in the reference, where jitted dispatch is asynchronous too: on the
card they time the launches and the host work of a stage, and the
device work only where a stage waits for it (the rs lane's copy to the
host).
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import allocator, lanes as lanes_lib
from repro_torch.core import scheduler as sched_lib
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.stages import host_numpy
from repro_torch.serving import cache as cache_lib
from repro_torch.serving.batcher import (AdmissionError, BatcherConfig,
                                         MicroBatcher, pad_to_bucket)
from repro_torch.serving.metrics import MetricsRegistry

_RESULT_FIELDS = ("message_bits", "ok", "n_corrected", "logits")


class RequestHandle:
    """Future for one submitted request (n images).

    ``priority`` is the admission class the batcher resolved for this
    request (per-class latency metrics key off it).  ``_ckey`` is the
    content-cache key when the exact tier is on — the resolver uses it
    to populate the cache and fan results out to coalesced in-flight
    followers."""

    def __init__(self, rid: int, n: int, priority: str = "default"):
        self.rid = rid
        self.n = n
        self.priority = priority
        self._ckey: Optional[bytes] = None
        self.t_submit = time.perf_counter()
        self._ready = threading.Event()
        self._result: Optional[Dict[str, np.ndarray]] = None
        self._error: Optional[BaseException] = None
        self.t_done: Optional[float] = None
        self._cb_lock = threading.Lock()
        self._callbacks: List = []

    def done(self) -> bool:
        return self._ready.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> Dict[str, np.ndarray]:
        if not self._ready.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done after "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def add_done_callback(self, fn):
        """Register ``fn(handle)`` to run when the handle settles
        (resolve or reject) — immediately if it already has.  Each
        callback fires exactly once; exceptions it raises propagate to
        the settling thread (callbacks are the fleet router's re-route
        hook, so failures there must be loud, not swallowed)."""
        with self._cb_lock:
            if not self._ready.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _fire_callbacks(self):
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            fn(self)

    def _resolve(self, result: Dict[str, np.ndarray]):
        self.t_done = time.perf_counter()
        self._result = result
        self._ready.set()
        self._fire_callbacks()

    def _reject(self, err: BaseException):
        self.t_done = time.perf_counter()
        self._error = err
        self._ready.set()
        self._fire_callbacks()

    @property
    def latency_s(self) -> Optional[float]:
        return (self.t_done - self.t_submit
                if self.t_done is not None else None)


class _SlotState:
    """Partial results for a request whose images are still escalating:
    round-1 rows are held here, escalated rows overwrite them as their
    rounds settle, and the request's handle resolves when the last
    pending image settles."""

    def __init__(self, slot, rows: Dict[str, np.ndarray], pending: int,
                 embeds: Optional[np.ndarray] = None):
        self.slot = slot
        self.rows = {f: np.asarray(v).copy() for f, v in rows.items()}
        self.tiles_used = np.ones(rows["ok"].shape[0], np.int32)
        self.pending = pending
        # round-0 GAP embeddings of this request's images — escalated
        # verdicts are inserted into the tier-2 cache under them
        self.embeds = embeds


@dataclasses.dataclass
class _EscGroup:
    """One escalation micro-batch: the still-failing images gathered
    across a completed batch's requests, entering plan-tile ``round``
    with their accumulated soft bits."""
    raw: np.ndarray                           # (n, H, W, 3) true rows
    keys: Any                                 # (n, 2) int64 key tensor
    acc: np.ndarray                           # (n, n_bits) accumulated
    targets: List[Tuple[_SlotState, int]]     # (state, row) per image
    round: int                                # plan column this round


@dataclasses.dataclass
class _InFlight:
    mb: Any                     # MicroBatch (round 0) or None
    tid: int
    esc: Optional[_EscGroup] = None   # escalation round payload
    done: bool = False          # first completion wins (speculative)


class DetectionServer:
    """Request-level serving runtime over the shared stage registry."""

    def __init__(self, cfg: DetectionConfig, extractor_params, *,
                 batcher: Optional[BatcherConfig] = None,
                 lanes: Optional[Dict[str, int]] = None,
                 straggler_policy: Optional[
                     sched_lib.StragglerPolicy] = None,
                 watchdog_interval_s: float = 0.05,
                 realloc_every: int = 0,
                 device=None,
                 name: str = "detect-server"):
        # the device pin: every stage call and the warmup run under
        # torch.cuda.device of the pipeline's card (None = the first
        # card, raising if there is none; "cpu" only when asked for)
        self.pipe = DetectionPipeline(cfg, extractor_params, device=device)
        self._device = self.pipe.device
        self.registry = self.pipe.stages
        self.cfg = cfg
        self.name = name
        self.metrics = MetricsRegistry()
        self.batcher = MicroBatcher(batcher or BatcherConfig())
        # content-addressed result cache (serving.cache).  Tier 1
        # (exact sha256) + dedup-in-flight switch on together: both key
        # off the same content digest and share the exactness contract.
        # Tier 2 (near-duplicate GAP embedding) is independent and
        # approximate — it only short-circuits escalation rounds.
        if getattr(cfg, "cache_exact", False):
            self._exact: Optional[cache_lib.ResultCache] = \
                cache_lib.ResultCache(getattr(cfg, "cache_capacity", 256))
            self._dedup = cache_lib.InFlightTable()
        else:
            self._exact = None
            self._dedup = cache_lib.InFlightTable()  # pop(None) no-ops
        self._embed_thr = getattr(cfg, "cache_embedding_threshold", 0.0)
        self._embed: Optional[cache_lib.EmbeddingCache] = (
            cache_lib.EmbeddingCache(
                getattr(cfg, "cache_embedding_capacity", 512),
                self._embed_thr)
            if self._embed_thr > 0 else None)
        self.mon = sched_lib.StragglerMonitor(
            straggler_policy or sched_lib.StragglerPolicy())
        self._lanes = dict(lanes or self.pipe.default_lanes())
        self._watchdog_interval = watchdog_interval_s
        self._realloc_every = realloc_every
        self._ex: Optional[lanes_lib.LaneExecutor] = None
        self._stop = threading.Event()
        self._threads: list = []
        self._lock = threading.Lock()
        self._mon_lock = threading.Lock()   # StragglerMonitor is not
        self._esc_lock = threading.Lock()   # escalation slot states
        # escalation groups cross threads through a queue: _on_done runs
        # on the executor's dispatcher thread, whose blocking submit on
        # a full first-stage queue would deadlock the whole server (the
        # dispatcher is what drains those queues) — a dedicated pump
        # thread does the blocking submit instead
        self._esc_q: "queue.Queue[_EscGroup]" = queue.Queue()
        self._inflight: Dict[int, _InFlight] = {}   # thread-safe itself
        self._req_seq = 0
        self._tid_seq = 0
        self._batches_done = 0
        self._last_realloc = 0
        # admitted vs finished request counts close the drain() race: a
        # micro-batch in the pump's hands (popped from the batcher, not
        # yet in _inflight) is invisible to both queues, but its
        # requests are admitted-and-unfinished
        self._admitted = 0
        self._finished = 0
        # EWMA of measured per-stage seconds/batch for live reallocation
        self._stage_s: Dict[str, float] = {}
        self._stage_b: float = 0.0

    def _dev_ctx(self):
        """Context manager making this server's card the current CUDA
        device (a no-op on the CPU)."""
        return (torch.cuda.device(self._device)
                if self._device.type == "cuda" else contextlib.nullcontext())

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "DetectionServer":
        # escalate_inline=False: the server escalates by re-submitting
        # round-r micro-batches through this same executor (straggler
        # coverage + lane concurrency) instead of looping on an rs lane
        stages = self.registry.build_stages(
            self._lanes, finish=self._finish_payload,
            depth=2 if self.cfg.interleave else 1, escalate_inline=False,
            emit_embed=self._embed is not None)
        for st in stages:
            st.fn = self._timed(st.name, st.fn)
        self._ex = lanes_lib.LaneExecutor(stages, name=self.name).start()
        pump = threading.Thread(target=self._pump_loop, daemon=True,
                                name=f"{self.name}/pump")
        dog = threading.Thread(target=self._watchdog_loop, daemon=True,
                               name=f"{self.name}/watchdog")
        esc = threading.Thread(target=self._esc_loop, daemon=True,
                               name=f"{self.name}/escalation")
        pump.start()
        dog.start()
        esc.start()
        self._threads += [pump, dog, esc]
        return self

    def warmup(self, sample_image: np.ndarray):
        """Build what a first request would otherwise pay for inside its
        latency (and trip the straggler watchdog with): the kernel
        library and the device constants of the geometry
        (``StageRegistry.prepare``), then one run of the stage functions
        at every pad-bucket size the batcher can emit (up to
        ``max_batch``), at the rung and schedule that serve, with the
        embedding decode when the near-duplicate tier is on.  With
        escalation one escalation round runs too: the port decodes an
        escalation group's true rows and no kernel depends on the batch
        size, so there is no power-of-two shape to warm.  Runs the
        registry functions directly, off the metrics path, and waits for
        the device; returns the bucket sizes."""
        cfg = self.batcher.cfg
        reg = self.registry
        with self._dev_ctx():
            return self._warmup_body(cfg, reg, sample_image)

    def _warmup_body(self, cfg, reg, sample_image: np.ndarray):
        sizes = []
        if cfg.bucket > 0:
            b = cfg.bucket
            while b < cfg.max_batch:
                sizes.append(b)
                b += cfg.bucket
        else:
            b = 1
            while b < cfg.max_batch:
                sizes.append(b)
                b *= 2
        sizes.append(pad_to_bucket(
            np.repeat(sample_image[None], cfg.max_batch, 0),
            cfg.bucket)[0].shape[0])
        reg.prepare((max(sizes), *np.shape(sample_image)))
        for b in sorted(set(sizes)):
            raw = reg.to_device(np.repeat(sample_image[None], b, axis=0))
            keys = reg.image_keys(reg.base_key, b)
            x = reg.ingest_keyed(raw, keys)
            if self._embed is not None:
                # the served round-0 decode is the embed-emitting one
                logits, _ = reg.decode_keyed_embed(x, keys)
            else:
                logits = reg.decode_keyed(x, keys)
            host_numpy(reg.rs_correct(reg.bits(logits))[0])
        if reg.policy.enabled:
            raw = reg.to_device(sample_image[None])
            keys = reg.image_keys(reg.base_key, 1)
            logits = reg.decode_tiles(reg.escalation_tiles(raw, keys, 1))
            host_numpy(reg.rs_correct(reg.bits(logits))[0])
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return sorted(set(sizes))

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every admitted request has been resolved (covers
        the batcher queue, batches in the pump's hands, and the
        executor — nothing can be admitted-and-unfinished in between)."""
        t_end = (time.perf_counter() + timeout
                 if timeout is not None else None)
        while True:
            with self._lock:
                idle = self._finished >= self._admitted
            if idle:
                return True
            if t_end is not None and time.perf_counter() > t_end:
                return False
            time.sleep(0.002)

    def close(self):
        """Graceful shutdown: stop admission, drain in-flight work,
        stop the loops, close the executor and the pipeline.  Requests
        that survive the drain timeout are rejected, never left with an
        unresolved future."""
        self.batcher.close()
        # an un-started server has no pump to finish admitted work —
        # draining would just burn the timeout before the flush below
        # rejects everything queued
        self.drain(timeout=30.0 if self._threads else 0.0)
        self._stop.set()
        if self._ex is not None:
            self._ex.drain(timeout=10.0)
            self._ex.close()   # rejects leftover tickets THROUGH their
            #                    callbacks -> _on_done rejects the slots
        for e in self.batcher.flush():   # never popped by the pump
            self._finish_requests([e.slot], error=RuntimeError(
                f"{self.name}: server closed before dispatch"))
        while True:      # escalation groups never picked up by the pump
            try:
                g = self._esc_q.get_nowait()
            except queue.Empty:
                break
            self._fail_states(g.targets, RuntimeError(
                f"{self.name}: server closed before escalation dispatch"))
        self.pipe.close()
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=2.0)

    def kill(self, error: Optional[BaseException] = None):
        """Abrupt shutdown — the crash-simulation path the fleet tier's
        fault injection drives.  Unlike :meth:`close` nothing is
        drained: admission stops, the executor is closed out from under
        its in-flight tickets (each rejects THROUGH its callback, so
        every admitted request's handle settles), and queued-but-never-
        dispatched requests are rejected.  No handle is ever left
        unresolved — the router's re-execution discipline depends on
        rejection, not on timeouts."""
        err = error if error is not None else RuntimeError(
            f"{self.name}: killed")
        self.batcher.close()
        self._stop.set()
        if self._ex is not None:
            self._ex.close()   # in-flight tickets reject via _on_done
        for e in self.batcher.flush():
            self._finish_requests([e.slot], error=err)
        while True:
            try:
                g = self._esc_q.get_nowait()
            except queue.Empty:
                break
            self._fail_states(g.targets, err)
        self.pipe.close()
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=2.0)

    def reconfigure(self, lanes: Dict[str, int]) -> Dict[str, int]:
        """Apply an explicit lane map to the running executor (the
        rolling-reconfigure path: the router drains this replica, calls
        this, and returns it to rotation).  ``reallocate()`` is the
        measured/Algorithm-1 variant; this one takes the map as given."""
        if self._ex is None:
            self._lanes = dict(lanes)
            return dict(lanes)
        applied = self._ex.reconfigure(dict(lanes))
        self._lanes = dict(applied)
        self.metrics.count("reconfigures")
        return applied

    def load(self) -> Dict[str, int]:
        """Backpressure surface for the fleet router's least-loaded
        spill-over and health polling: queued images, admitted-but-
        unfinished requests, and the batcher's current admission
        headroom (images the highest class could still admit)."""
        with self._lock:
            inflight = self._admitted - self._finished
        return {"queue_depth": self.batcher.depth(),
                "inflight_requests": int(inflight),
                "headroom": self.batcher.headroom()}

    def _finish_requests(self, slots, *, error: BaseException):
        n = 0
        for slot in slots:
            slot._reject(error)
            n += 1
            # dedup followers coalesced onto this execution must be
            # rejected too — exactly-once settlement, even on the
            # close()/executor-failure paths
            for f in self._dedup.pop(getattr(slot, "_ckey", None)):
                f._reject(error)
                n += 1
        self.metrics.count("requests_failed", n)
        with self._lock:
            self._finished += n

    # -- request path ---------------------------------------------------------
    def content_key(self, images: np.ndarray):
        """The content-derived request fold_in key ``submit`` uses when
        ``cache_exact`` is on and no explicit key is given — exposed so
        offline baselines (``detect_batch`` / ``run_batch``) can
        reproduce a served (or cached) result bit-for-bit."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        return self.registry.content_key(
            cache_lib.fingerprint32(cache_lib.request_digest(images)))

    def submit(self, images: np.ndarray, *, key=None,
               block: bool = False,
               priority: Optional[str] = None) -> RequestHandle:
        """Admit one request (n images, one fold_in key).

        ``key`` defaults to the offline discipline —
        ``fold_in(key(cfg.seed), request_seq)`` — so a stream of online
        requests reproduces ``detect_batch`` called once per request on
        a fresh pipeline.  With ``cache_exact`` on the default flips to
        the *content-derived* key (``content_key``): identical pixels
        get identical keys, which is what makes an exact cache hit
        bitwise equal to the cold path (per-request sequence keys would
        make every resubmission a distinct computation by design).
        ``priority`` selects the batcher admission class (None = the
        highest configured class).  Raises :class:`AdmissionError` on
        backpressure (``block=True`` waits instead)."""
        images = np.asarray(images)
        if images.ndim == 3:           # single image -> group of one
            images = images[None]
        try:
            cls = self.batcher.resolve_class(priority)
        except AdmissionError:
            self.metrics.count("requests_rejected")
            raise
        with self._lock:
            rid = self._req_seq
            self._req_seq += 1
        n = images.shape[0]
        handle = RequestHandle(rid, n, priority=cls)
        if self._exact is not None and n:
            digest = cache_lib.request_digest(images)
            if key is None:
                key = self.registry.content_key(
                    cache_lib.fingerprint32(digest))
            ckey = cache_lib.result_key(key, digest)
            hit = self._exact.get(ckey)
            if hit is not None:
                # cache hits bypass admission entirely — no queue
                # round-trip, no depth-bound backpressure
                self.metrics.count("cache_hit_exact")
                self.metrics.count("requests_admitted")
                with self._lock:
                    self._admitted += 1
                self._settle(handle, hit, count_tiles=False)
                return handle
            if self._dedup.attach(ckey, handle):
                # follower: an identical request is already executing —
                # coalesce onto it, the resolver fans the result out
                self.metrics.count("dedup_coalesced")
                self.metrics.count("requests_admitted")
                with self._lock:
                    self._admitted += 1
                return handle
            self.metrics.count("cache_miss")
            handle._ckey = ckey
        if key is None:
            key = self.registry.batch_key(rid)
        # per-REQUEST image keys: coalescing can't change them, which is
        # what makes online results bit-identical to offline (integer
        # hashing on the host; they reach the card with the micro-batch)
        keys = self.registry.image_keys(key, n) if n else None
        try:
            self.batcher.submit(images, keys, handle,
                                priority=cls, block=block)
        except AdmissionError:
            self.metrics.count("requests_rejected")
            # a leader that never dispatched must release its in-flight
            # claim and reject any followers that raced in behind it
            nf = 0
            for f in self._dedup.pop(handle._ckey):
                f._reject(AdmissionError(
                    "coalesced leader rejected at admission"))
                nf += 1
            if nf:
                self.metrics.count("requests_failed", nf)
                with self._lock:
                    self._finished += nf
            raise
        with self._lock:
            self._admitted += 1
        self.metrics.count("requests_admitted")
        self.metrics.gauge("queue_depth", self.batcher.depth())
        return handle

    # -- internal: micro-batch dispatch ---------------------------------------
    def _payload(self, inf: _InFlight) -> dict:
        # a FRESH dict per dispatch: stage fns annotate the payload in
        # place (ingest replaces "raw" by its device copy), so a
        # speculative retry must not share the original
        if inf.esc is not None:
            g = inf.esc
            # the group's true rows, unpadded: every kernel is
            # batch-stable, so no row depends on the group's size
            return {"raw": g.raw, "keys": g.keys, "round": g.round,
                    "acc_logits": g.acc}
        return {"raw": inf.mb.raw, "keys": inf.mb.keys}

    def _dispatch(self, inf: _InFlight, *, retry: bool = False):
        if retry:
            self.metrics.count("straggler_retries")
        else:
            with self._mon_lock:
                self.mon.start(inf.tid)
        self._ex.submit(self._payload(inf),
                        callback=lambda t, inf=inf: self._on_done(inf, t))

    def _pump_loop(self):
        while not self._stop.is_set():
            mb = self.batcher.next_batch(timeout=0.05)
            if mb is None:
                if self.batcher.closed:
                    # closed and empty: next_batch returns at once, and a
                    # spinning pump would hold the GIL against the lanes'
                    # small host ops (a close() would then drain slowly)
                    self._stop.wait(0.05)
                continue
            with self._lock:
                tid = self._tid_seq
                self._tid_seq += 1
                inf = _InFlight(mb=mb, tid=tid)
                self._inflight[tid] = inf
            self.metrics.observe("batch_occupancy", mb.occupancy)
            self.metrics.observe("batch_images", mb.true_b)
            self.metrics.gauge("queue_depth", self.batcher.depth())
            try:
                self._dispatch(inf)
            except RuntimeError as e:   # executor closed under us: the
                # batch must still resolve (reject), and the pump must
                # keep looping to fail any remaining queued batches
                with self._lock:
                    inf.done = True
                    self._inflight.pop(inf.tid, None)
                self._finish_requests([s for s, _, _ in mb.slots],
                                      error=e)

    def _finish_payload(self, p: dict) -> dict:
        """Stage-graph sink: device -> numpy on the rs lane (on its own
        stream, after the payload's event), so nothing downstream of the
        executor reads a device tensor."""
        out = {"message_bits": host_numpy(p["msg"]),
               "ok": host_numpy(p["ok"]),
               "n_corrected": host_numpy(p["ncorr"]),
               "logits": host_numpy(p["logits"])}
        if "embed" in p:         # round-0 GAP embeddings (tier-2 cache)
            out["embed"] = host_numpy(p["embed"])
        return out

    def _on_done(self, inf: _InFlight, ticket):
        """Executor callback (completion order): scatter to requests,
        or advance the escalation state machine for round-r batches."""
        with self._lock:
            if inf.done:          # a speculative duplicate lost the race
                return
            inf.done = True
            self._inflight.pop(inf.tid, None)
            self._batches_done += 1
        with self._mon_lock:
            self.mon.complete(inf.tid)
        err = ticket.exception(0)
        if err is not None:
            if inf.esc is not None:
                self._fail_states(inf.esc.targets, err)
            else:
                self._finish_requests([s for s, _, _ in inf.mb.slots],
                                      error=err)
            return
        res = ticket.result(0)
        if inf.esc is not None:
            with self._esc_lock:
                self._scatter_escalation(inf.esc, res)
            return
        with self._esc_lock:
            self._scatter_round0(inf.mb, res)
        self.metrics.observe("batch_latency_s",
                             time.perf_counter() - inf.mb.t_formed)

    def _settle(self, slot, result: Dict[str, np.ndarray], *,
                count_tiles: bool = True):
        """Resolve one handle and account for it (per-class latency,
        completion counters).  ``count_tiles=False`` for cache hits and
        dedup followers — they adopted a result, no tiles ran for
        them, so they must not skew the escalation telemetry."""
        slot._resolve(result)
        n = result["message_bits"].shape[0]
        self.metrics.count("requests_completed")
        self.metrics.count("images_completed", n)
        self.metrics.observe("request_latency_s", slot.latency_s)
        self.metrics.observe(f"request_latency_{slot.priority}_s",
                             slot.latency_s)
        tiles = result.get("tiles_used")
        if count_tiles and tiles is not None:
            # counted at resolution (not when escalation starts), so
            # escalation_rate = images_escalated / images_completed is
            # a true fraction of COMPLETED images even while rounds are
            # in flight or after escalation failures
            self.metrics.count("images_escalated",
                               int((tiles > 1).sum()))
            for t in tiles:
                self.metrics.observe("tiles_per_image", float(t))
        with self._lock:
            self._finished += 1

    def _resolve_request(self, slot, result: Dict[str, np.ndarray]):
        """Settle an *executed* request: populate the exact cache
        BEFORE releasing its in-flight claim (no window where a new
        identical request sees neither), then fan the result out to
        every coalesced follower."""
        ckey = getattr(slot, "_ckey", None)
        if ckey is not None:
            if self._exact is not None:
                self._exact.put(ckey, result)
            followers = self._dedup.pop(ckey)
        else:
            followers = ()
        self._settle(slot, result)
        for f in followers:
            self._settle(f, cache_lib.copy_result(result),
                         count_tiles=False)

    def _embed_tier(self, rows, need: np.ndarray, embeds: np.ndarray,
                    off: int):
        """Tier-2 near-duplicate cache over round-0 GAP embeddings.
        Images about to escalate adopt a cached settled verdict when
        their embedding clears the cosine threshold — the approximate
        tier only short-circuits escalation rounds, never the exact
        path.  Adoption is WHOLESALE: every result field
        (message_bits, ok, n_corrected, logits) is replaced by the
        cached near-duplicate's payload and the image's own round-0
        decode is discarded — the deliberate semantics of an
        approximate tier (mixing the probe's failed bits with a
        borrowed ok verdict would produce incoherent rows).
        Settled-ok images insert their verdicts for future near-dupes.
        Mutates ``need`` in place; returns rows (copied to writable
        arrays if any verdict was adopted)."""
        want = np.nonzero(need)[0]
        adopted = np.zeros(need.shape, bool)
        if want.size:
            rows = {f: np.array(rows[f]) for f in _RESULT_FIELDS}
        for i in want:
            hit = self._embed.get(embeds[off + int(i)])
            if hit is None:
                continue
            for f in _RESULT_FIELDS:
                rows[f][i] = hit[f]
            need[i] = False
            adopted[i] = True
            self.metrics.count("cache_hit_embed")
        ok = np.asarray(rows["ok"], bool)
        for i in np.nonzero(~need & ~adopted & ok)[0]:
            emb = embeds[off + int(i)]
            if self._embed.get(emb) is None:   # keep entries distinct
                self._embed.put(
                    emb, {f: np.asarray(rows[f][int(i)]).copy()
                          for f in _RESULT_FIELDS})
        return rows

    def _scatter_round0(self, mb, res: Dict[str, np.ndarray]):
        """Completed single-tile round: resolve settled requests, hold
        the rest in slot states and regroup their failed images into
        one escalation micro-batch."""
        policy = self.registry.policy
        embeds = res.get("embed")
        esc: List[Tuple[_SlotState, int, int]] = []   # (state, row, gidx)
        for slot, off, n in mb.slots:
            rows = {f: res[f][off: off + n] for f in _RESULT_FIELDS}
            if not policy.enabled:
                self._resolve_request(slot, rows)
                continue
            need = np.array(policy.wants_escalation(rows["ok"],
                                                    rows["logits"]))
            if self._embed is not None and embeds is not None:
                rows = self._embed_tier(rows, need, embeds, off)
            if not need.any():
                self._resolve_request(
                    slot, {**rows, "tiles_used": np.ones(n, np.int32)})
                continue
            state = _SlotState(slot, rows, pending=int(need.sum()),
                               embeds=(embeds[off: off + n].copy()
                                       if embeds is not None else None))
            esc.extend((state, int(i), off + int(i))
                       for i in np.nonzero(need)[0])
        if esc:
            gidx = np.asarray([g for _, _, g in esc])
            self._dispatch_escalation(_EscGroup(
                raw=np.asarray(mb.raw)[gidx],
                keys=mb.keys[torch.as_tensor(gidx)],
                acc=np.asarray(res["logits"], np.float32)[gidx],
                targets=[(s, r) for s, r, _ in esc],
                round=1))

    def _scatter_escalation(self, g: _EscGroup, res: Dict[str, np.ndarray]):
        """Completed escalation round: settle images whose RS now
        succeeds (or whose budget is spent), re-group the rest for the
        next round with their accumulated soft bits."""
        policy = self.registry.policy
        n = len(g.targets)
        rows = {f: np.asarray(res[f])[:n] for f in _RESULT_FIELDS}
        need = policy.wants_escalation(rows["ok"], rows["logits"])
        nxt: List[int] = []
        for i, (state, row) in enumerate(g.targets):
            for f in _RESULT_FIELDS:
                state.rows[f][row] = rows[f][i]
            state.tiles_used[row] = g.round + 1
            if need[i] and g.round + 1 < policy.max_tiles:
                nxt.append(i)
                continue
            state.pending -= 1
            if (self._embed is not None and state.embeds is not None
                    and bool(rows["ok"][i])):
                # an escalation-settled verdict is exactly what the
                # tier-2 cache is for: the expensive multi-round answer,
                # keyed by the image's round-0 embedding so a near-dupe
                # can skip the rounds entirely
                emb = state.embeds[row]
                if self._embed.get(emb) is None:
                    self._embed.put(
                        emb, {f: np.asarray(rows[f][i]).copy()
                              for f in _RESULT_FIELDS})
            if state.pending == 0:
                self._resolve_request(
                    state.slot,
                    {**state.rows, "tiles_used": state.tiles_used})
        if nxt:
            sel = np.asarray(nxt)
            self._dispatch_escalation(_EscGroup(
                raw=g.raw[sel], keys=g.keys[torch.as_tensor(sel)],
                acc=rows["logits"][sel],
                targets=[g.targets[i] for i in nxt],
                round=g.round + 1))

    def _dispatch_escalation(self, group: _EscGroup):
        """Hand the group to the escalation pump (never submit from
        here: callers run on the executor's dispatcher thread, and a
        blocking submit there wedges the server — the dispatcher is
        the only consumer of the completion queue)."""
        self.metrics.count("escalation_batches")
        self.metrics.observe("escalation_batch_images",
                             len(group.targets))
        self._esc_q.put(group)

    def _esc_loop(self):
        """Escalation pump: pops groups and does the (possibly
        blocking) executor submit off the dispatcher thread."""
        while not self._stop.is_set():
            try:
                group = self._esc_q.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._lock:
                tid = self._tid_seq
                self._tid_seq += 1
                inf = _InFlight(mb=None, tid=tid, esc=group)
                self._inflight[tid] = inf
            try:
                self._dispatch(inf)
            except RuntimeError as e:   # executor closed under us
                with self._lock:
                    inf.done = True
                    self._inflight.pop(tid, None)
                self._fail_states(group.targets, e)

    def _fail_states(self, targets, err: BaseException):
        """Reject every request behind an escalation group that can no
        longer complete (a request's escalating rows always travel in
        one group, so each state appears in exactly one group)."""
        seen: Dict[int, _SlotState] = {}
        for state, _ in targets:
            seen.setdefault(id(state), state)
        n = 0
        for state in seen.values():
            state.slot._reject(err)
            n += 1
            for f in self._dedup.pop(getattr(state.slot, "_ckey", None)):
                f._reject(err)
                n += 1
        self.metrics.count("requests_failed", n)
        with self._lock:
            self._finished += n

    # -- straggler mitigation ----------------------------------------
    def _watchdog_loop(self):
        """Speculative re-execution: re-submit micro-batches the monitor
        flags as stragglers (stage fns are pure, first completion wins —
        ``_on_done`` drops the loser by the ``done`` flag).  Periodic
        live reallocation also runs here: reconfigure() can block on the
        bounded stage queues, which must never happen on the executor's
        dispatcher thread (it is what drains them)."""
        while not self._stop.is_set():
            time.sleep(self._watchdog_interval)
            with self._mon_lock:
                stragglers = self.mon.stragglers()
            for tid in stragglers:
                with self._lock:
                    inf = self._inflight.get(tid)
                if inf is None or inf.done:
                    continue
                with self._mon_lock:
                    self.mon.mark_retried(tid)
                try:
                    self._dispatch(inf, retry=True)
                except RuntimeError:
                    return        # executor closed under us
            if self._realloc_every:
                with self._lock:
                    due = (self._batches_done - self._last_realloc
                           >= self._realloc_every)
                    if due:
                        self._last_realloc = self._batches_done
                if due:
                    try:
                        self.reallocate()
                    except Exception:
                        pass      # reallocation must never kill serving

    # -- live reallocation -------------------------------------------
    def _timed(self, name: str, fn):
        def timed_fn(p):
            t0 = time.perf_counter()
            with self._dev_ctx():
                out = fn(p)
            dt = time.perf_counter() - t0
            if p.get("round", 0) > 0:
                # escalation rounds are small sub-batches: feeding
                # them into the EWMA would skew the Algorithm-1 profiles
                # (and _stage_b) toward a workload the allocator should
                # not tune for — tracked separately instead
                self.metrics.observe(f"stage_{name}_esc_s", dt)
                return out
            with self._lock:
                prev = self._stage_s.get(name)
                self._stage_s[name] = (dt if prev is None
                                       else 0.8 * prev + 0.2 * dt)
                if name == "ingest":
                    b = p["raw"].shape[0]
                    self._stage_b = (b if not self._stage_b
                                     else 0.8 * self._stage_b + 0.2 * b)
            self.metrics.observe(f"stage_{name}_s", dt)
            return out
        return timed_fn

    def stage_profiles(self):
        """Algorithm 1 profiles from the *measured* (EWMA) stage wall
        times — the online replacement for warmup profiling.  Kernels
        launch asynchronously on the lanes' streams, so these are
        launch + host times (the rs stage also waits for its copy to the
        host); they still rank the stages, which is what the allocator
        consumes.  Returns None until every stage has been observed."""
        with self._lock:
            if any(n not in self._stage_s for n in ("ingest", "decode",
                                                    "rs")):
                return None
            b = max(self._stage_b, 1.0)
            # u is not measurable from wall times; 1 byte/sample keeps
            # the allocation latency-driven (the warmup path measures
            # real bytes when a memory cap matters)
            return [allocator.StageProfile(
                        name=n, t_per_sample=self._stage_s[n] / b,
                        u_per_sample=1.0, launch_overhead=0.0)
                    for n in ("ingest", "decode", "rs")]

    def reallocate(self, lane_budget: Optional[int] = None
                   ) -> Optional[Dict[str, int]]:
        """Re-run Algorithm 1 on measured stage latencies and apply the
        allocation to the RUNNING executor (live reconfiguration); the
        paper's warmup allocation assumed latencies that drift under
        real traffic.  No-op until all stages have been measured."""
        profiles = self.stage_profiles()
        if profiles is None or self._ex is None:
            return None
        budget = lane_budget or self.cfg.lane_budget
        new = allocator.assign(
            profiles, global_batch=max(int(self._stage_b), 1),
            lane_budget=budget)
        self._lanes = new
        applied = self._ex.reconfigure(new)
        self.metrics.count("reallocations")
        return applied

    # -- reporting ------------------------------------------------------------
    def lane_counts(self) -> Dict[str, int]:
        return (self._ex.lane_counts() if self._ex is not None
                else dict(self._lanes))

    def stats(self) -> dict:
        out = self.metrics.snapshot()
        out["lanes"] = self.lane_counts()
        # the resettable metrics counter, NOT mon.retry_count: one
        # server is reused across fig11 sweep points with a metrics
        # reset between them, and the monitor's cumulative total would
        # misattribute earlier points' retries to later rows
        out["straggler_retries"] = int(
            self.metrics.counter("straggler_retries"))
        out["queue_depth"] = self.batcher.depth()
        # escalation rate: fraction of completed images that needed
        # more than their single-tile round (0.0 when escalation off)
        done = self.metrics.counter("images_completed")
        out["escalation_rate"] = (
            self.metrics.counter("images_escalated") / done
            if done else 0.0)
        out["escalation_batches"] = int(
            self.metrics.counter("escalation_batches"))
        # cache / dedup funnel (rates are derived in snapshot())
        for c in ("cache_hit_exact", "cache_hit_embed", "cache_miss",
                  "dedup_coalesced"):
            out[c] = int(self.metrics.counter(c))
        out["class_depths"] = self.batcher.class_depths()
        return out
