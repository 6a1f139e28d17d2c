"""Multi-replica fleet router (counterpart of ``repro.serving.router``):
Algorithm 1's resource-aware policy, generalized from lanes-within-a-
process to replicas-across-a-fleet.

:class:`FleetRouter` fronts N :class:`~repro_torch.serving.replica
.Replica` instances (each a full :class:`DetectionServer` runtime,
thread-per-replica in-process, each pinned to a card — several replicas
share one card, each with its own lane streams — or to the CPU) behind
the same ``submit() -> handle`` surface a single server exposes, so the
Poisson load generator drives a fleet exactly like one server.

Routing disciplines, in the order a request meets them::

    submit(images) ──► content digest (sha256, the cache key material)
        ──► rendezvous hash over healthy in-rotation replicas
            (identical pixels -> identical replica, so ``cache_exact``
            traffic always lands on the replica that holds its entry;
            add/remove one replica remaps ~1/N of the keyspace)
        ──► AdmissionError? spill over to the least-loaded healthy
            sibling (queue depth + in-flight via the batcher's
            backpressure surface; counted as ``spillovers``)
        ──► replica crash mid-flight? the dead replica rejects the
            request THROUGH its handle callback; the router re-executes
            it on a healthy sibling (counted as ``reroutes``) —
            stage fns are pure and keys derive from content/request,
            never placement, so re-execution is exact and
            first-completion-wins is safe (the straggler-monitor
            discipline, one level up)
        ──► FleetHandle.result()

**Bit-identity contract**: routing must never change results.  Request
keys derive from explicit caller keys or from content
(``cache_exact``), so the same request set through 1, 2, or N replicas
— under any spill-over or re-execution history — is bitwise identical
to one ``DetectionServer`` (asserted by ``tests/test_torch_fleet.py``).

**Rolling reconfigure** (:meth:`rolling_reconfigure`): one replica at
a time is taken out of rotation (new traffic routes to siblings),
drained, ``reconfigure()``-d live, and returned — zero dropped
requests.  A replica that crashes while draining is marked unhealthy
and skipped, never wedging the roll.

**Health**: a poller thread watches replica health and per-replica
queue depth; a crashed replica leaves rotation exactly once (counted
as ``unhealthy``) and its in-flight work re-executes as above.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.serving import cache as cache_lib
from repro_torch.serving.batcher import AdmissionError
from repro_torch.serving.metrics import MetricsRegistry, aggregate_counters
from repro_torch.serving.replica import Replica, ReplicaCrashed
from repro_torch.serving.server import RequestHandle


def rendezvous_order(digest: bytes, names: Sequence[str]) -> List[str]:
    """Highest-random-weight (rendezvous) preference order of
    ``names`` for a request digest: every (digest, name) pair gets an
    independent hash score (blake2b of name + digest, 8 bytes, the
    reference's) and names sort by it.  Properties the fleet
    leans on — deterministic (identical digests always order
    identically), and minimal-disruption (removing a name only remaps
    digests that ranked it first, ~1/N of the keyspace; adding one
    steals ~1/(N+1) and moves nothing else)."""
    return sorted(
        names,
        key=lambda n: hashlib.blake2b(
            n.encode() + digest, digest_size=8).digest(),
        reverse=True)


def rendezvous(digest: bytes, names: Sequence[str]) -> str:
    """The owning replica for a digest (first of the preference
    order).  Raises on an empty name set."""
    if not names:
        raise ValueError("rendezvous over an empty replica set")
    return rendezvous_order(digest, names)[0]


class FleetHandle(RequestHandle):
    """Future for one fleet request.  Extends the server handle with
    the routing history the tests and the chip smoke run read:
    ``replica`` (where it last executed), ``spilled`` (admission
    spill-over happened) and ``reroutes`` (crash re-executions)."""

    def __init__(self, rid: int, n: int, priority: str = "default"):
        super().__init__(rid, n, priority=priority)
        self.replica: Optional[str] = None
        self.spilled = False
        self.reroutes = 0


class _FleetReq:
    """Router-side state for one in-flight fleet request."""

    def __init__(self, fh: FleetHandle, images: np.ndarray, key,
                 priority: Optional[str], digest: bytes):
        self.fh = fh
        self.images = images
        self.key = key
        self.priority = priority
        self.digest = digest
        self.tried: Set[str] = set()   # admitted-then-crashed replicas
        self.settled = False


class FleetRouter:
    """Front-end over N detection replicas (rendezvous routing,
    spill-over, crash re-execution, rolling reconfigure)."""

    def __init__(self, replicas: Sequence[Replica], *,
                 poll_interval_s: float = 0.02):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self._replicas: Dict[str, Replica] = {r.name: r for r in replicas}
        self.metrics = MetricsRegistry()
        self._lock = threading.Lock()
        self._rotation: Dict[str, bool] = {n: True for n in names}
        self._known_dead: Set[str] = set()
        self._pending: Dict[int, _FleetReq] = {}
        self._req_seq = 0
        self._closed = False
        self._stop = threading.Event()
        self._poll_interval = poll_interval_s
        self._threads: List[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "FleetRouter":
        for r in self._replicas.values():
            r.start()
        poller = threading.Thread(target=self._poll_loop, daemon=True,
                                  name="fleet-router/health")
        poller.start()
        self._threads.append(poller)
        return self

    def warmup(self, sample_image: np.ndarray):
        """Warm every replica (each builds its own pipeline, constants
        and buckets on its own device; the kernel library is built once
        a process)."""
        out = {}
        for name, r in self._replicas.items():
            out[name] = r.warmup(sample_image)
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every fleet handle has settled — this covers
        spill-over and re-execution windows where a request belongs to
        no replica queue (it is between replicas, in the router's
        hands)."""
        t_end = (time.perf_counter() + timeout
                 if timeout is not None else None)
        while True:
            with self._lock:
                idle = not self._pending
            if idle:
                return True
            if t_end is not None and time.perf_counter() > t_end:
                return False
            time.sleep(0.002)

    def close(self, *, graceful: bool = True,
              drain_timeout: float = 30.0):
        """Shut the fleet down.  ``graceful`` drains in-flight work
        first (every handle resolves with its result); ``graceful=
        False`` kills the replicas and rejects every pending handle —
        in both modes each handle settles **exactly once** (the
        ``_FleetReq.settled`` flag is the single settlement gate, and
        the closed flag set first means no rejection can trigger a
        re-route)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if graceful:
            self.drain(drain_timeout)
        err = RuntimeError("fleet router closed")
        for r in self._replicas.values():
            if graceful:
                r.close()
            else:
                r.kill(err)
        # anything still unsettled (e.g. a request that was between
        # replicas when a non-graceful close landed) rejects here —
        # the settled flag makes a racing late callback a no-op
        with self._lock:
            leftovers = list(self._pending.values())
        for req in leftovers:
            self._settle(req, error=err)
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=2.0)

    # -- health -------------------------------------------------------
    def _mark_unhealthy(self, name: str):
        with self._lock:
            if name in self._known_dead:
                return
            self._known_dead.add(name)
            self._rotation[name] = False
        self.metrics.count("unhealthy")

    def _poll_loop(self):
        while not self._stop.is_set():
            for name, r in self._replicas.items():
                if not r.healthy:
                    self._mark_unhealthy(name)
                    continue
                load = r.load()
                self.metrics.gauge(f"replica_{name}_depth",
                                   load["queue_depth"])
                self.metrics.gauge(f"replica_{name}_inflight",
                                   load["inflight_requests"])
            self.metrics.gauge("healthy_replicas", sum(
                r.healthy for r in self._replicas.values()))
            self._stop.wait(self._poll_interval)

    def healthy_replicas(self) -> List[str]:
        return [n for n, r in self._replicas.items() if r.healthy]

    # -- routing ------------------------------------------------------
    def _candidates(self, digest: bytes, tried: Set[str]) -> List[str]:
        """Attempt order for one dispatch pass: the rendezvous owner
        among healthy in-rotation replicas first, then the remaining
        in-rotation siblings least-loaded first (the spill-over
        order), then out-of-rotation-but-healthy replicas as a last
        resort (a mid-roll fleet must still take every request —
        rolling reconfigure drops nothing)."""
        with self._lock:
            rot = [n for n, r in self._replicas.items()
                   if r.healthy and self._rotation[n] and n not in tried]
            out = [n for n, r in self._replicas.items()
                   if r.healthy and not self._rotation[n]
                   and n not in tried]
        if not rot and not out:
            return []
        order: List[str] = []
        if rot:
            ranked = rendezvous_order(digest, rot)
            order.append(ranked[0])
            rest = ranked[1:]
            # spill-over order: least queued work first; digest rank
            # breaks ties deterministically
            rank = {n: i for i, n in enumerate(ranked)}
            rest.sort(key=lambda n: (self._load_score(n), rank[n]))
            order.extend(rest)
        if out:
            rank_out = {n: i for i, n in
                        enumerate(rendezvous_order(digest, out))}
            out.sort(key=lambda n: (self._load_score(n), rank_out[n]))
            order.extend(out)
        return order

    def _load_score(self, name: str) -> int:
        load = self._replicas[name].load()
        return load["queue_depth"] + load["inflight_requests"]

    def submit(self, images: np.ndarray, *, key=None,
               priority: Optional[str] = None,
               block: bool = False) -> FleetHandle:
        """Admit one request to the fleet.  Raises
        :class:`AdmissionError` when no healthy replica will take it
        (whole-fleet backpressure) — mirroring a single server's
        surface so load generators need not know they talk to N."""
        with self._lock:
            if self._closed:
                raise AdmissionError("fleet router closed")
            rid = self._req_seq
            self._req_seq += 1
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        if images.shape[0] == 0:
            self.metrics.count("requests_rejected")
            raise AdmissionError("empty request (0 images)")
        digest = cache_lib.request_digest(images)
        fh = FleetHandle(rid, images.shape[0],
                         priority=priority or "default")
        req = _FleetReq(fh, images, key, priority, digest)
        with self._lock:
            self._pending[rid] = req
        try:
            self._dispatch(req, block=block)
        except AdmissionError:
            with self._lock:
                self._pending.pop(rid, None)
                req.settled = True
            self.metrics.count("requests_rejected")
            raise
        self.metrics.count("requests_admitted")
        return fh

    def _dispatch(self, req: _FleetReq, *, block: bool = False):
        """One placement pass: try candidates in routing order until a
        replica admits the request; hook the underlying handle so
        completion (or a crash rejection) flows back through
        :meth:`_on_underlying`.  Raises :class:`AdmissionError` when
        every candidate refused."""
        last_err: Optional[BaseException] = None
        spilled = False
        for name in self._candidates(req.digest, req.tried):
            r = self._replicas[name]
            try:
                uh = r.submit(req.images, key=req.key,
                              priority=req.priority, block=block)
            except AdmissionError as e:
                last_err = e
                spilled = True
                continue
            except ReplicaCrashed as e:
                last_err = e
                self._mark_unhealthy(name)
                continue
            req.fh.replica = name
            if spilled:
                req.fh.spilled = True
                self.metrics.count("spillovers")
            uh.add_done_callback(
                lambda h, req=req, rep=r: self._on_underlying(req, rep,
                                                              h))
            return
        raise AdmissionError(
            "no healthy replica admitted the request "
            f"(fleet backpressure; last: {last_err})")

    def _on_underlying(self, req: _FleetReq, replica: Replica, uh):
        """Settlement hook, called exactly once per underlying handle.
        Success settles the fleet handle (first completion wins).  A
        rejection from a replica that died re-executes on a sibling —
        the crash analogue of straggler speculation; any other error
        (or an exhausted fleet) propagates to the caller's handle."""
        try:
            result = uh.result(0)
            err = None
        except BaseException as e:   # includes ReplicaCrashed
            result, err = None, e
        if err is None:
            self._settle(req, result=result)
            return
        crashed = isinstance(err, ReplicaCrashed) or not replica.healthy
        with self._lock:
            closed = self._closed
        if crashed and not closed:
            self._mark_unhealthy(replica.name)
            req.tried.add(replica.name)
            req.fh.reroutes += 1
            self.metrics.count("reroutes")
            try:
                self._dispatch(req)
                return
            except AdmissionError as e:
                err = e
        self._settle(req, error=err)

    def _settle(self, req: _FleetReq, *, result=None, error=None):
        with self._lock:
            if req.settled:
                return
            req.settled = True
            self._pending.pop(req.fh.rid, None)
        if error is None:
            req.fh._resolve(result)
            self.metrics.count("requests_completed")
            self.metrics.count("images_completed",
                               result["message_bits"].shape[0])
            self.metrics.observe("request_latency_s", req.fh.latency_s)
        else:
            req.fh._reject(error)
            self.metrics.count("requests_failed")

    # -- rolling reconfigure ------------------------------------------
    def _set_rotation(self, name: str, in_rotation: bool):
        with self._lock:
            if name not in self._known_dead:
                self._rotation[name] = in_rotation

    def rolling_reconfigure(self, lanes: Optional[Dict[str, int]] = None,
                            *, drain_timeout: float = 30.0
                            ) -> Dict[str, Dict[str, int]]:
        """Reconfigure the fleet one replica at a time with zero
        dropped requests: take a replica out of rotation (new traffic
        rendezvous-routes to its siblings; an out-of-rotation replica
        only takes traffic when it is the last healthy one), drain it,
        apply the lane map (``None`` re-applies its current lanes),
        and return it.  A replica that crashes while draining is
        marked unhealthy and skipped — its in-flight work re-executes
        on siblings through the normal crash path."""
        applied: Dict[str, Dict[str, int]] = {}
        for name in list(self._replicas):
            r = self._replicas[name]
            if not r.healthy:
                continue
            self._set_rotation(name, False)
            try:
                r.drain(drain_timeout)
                if not r.healthy:        # crash-during-drain
                    self._mark_unhealthy(name)
                    continue
                target = dict(lanes) if lanes else r.srv.lane_counts()
                applied[name] = r.reconfigure(target)
                self.metrics.count("reconfigures")
            except ReplicaCrashed:
                self._mark_unhealthy(name)
                continue
            finally:
                if r.healthy:
                    self._set_rotation(name, True)
        return applied

    # -- reporting ----------------------------------------------------
    def stats(self) -> dict:
        """Fleet-level report: the router's own funnel (admissions,
        spill-overs, re-routes, fleet-wide latency percentiles) plus
        the exact sum of every replica's counters and a per-replica
        health/load table."""
        out = self.metrics.snapshot()
        rep_stats = {n: r.stats() for n, r in self._replicas.items()}
        out["fleet_counters"] = aggregate_counters(rep_stats.values())
        out["straggler_retries"] = int(sum(
            s.get("straggler_retries", 0) for s in rep_stats.values()))
        out["replicas"] = {
            n: {"healthy": r.healthy,
                "in_rotation": self._rotation[n],
                **(r.load() if r.healthy else {})}
            for n, r in self._replicas.items()}
        for c in ("spillovers", "reroutes", "unhealthy"):
            out[c] = int(self.metrics.counter(c))
        with self._lock:
            out["pending"] = len(self._pending)
        return out
