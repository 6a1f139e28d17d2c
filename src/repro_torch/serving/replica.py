"""Fleet replica (counterpart of ``repro.serving.replica``): one
:class:`~repro_torch.serving.server.DetectionServer` wrapped for fleet
membership and fault injection.

A :class:`Replica` is the unit the :class:`~repro_torch.serving.router
.FleetRouter` fronts — it owns a full single-process serving runtime
(micro-batcher, service-mode lane executor with a CUDA stream a lane,
straggler watchdog, caches) plus the three things a fleet needs on top:

* **identity + placement** — a stable ``name`` (the rendezvous-hash
  token) and a ``device`` pin, the server's ``device``: replica i of N
  on ``cuda:(i % device_count)``, so on one card every replica shares
  it, each with its own streams; ``"cpu"`` runs the kernels' plain
  versions, as the tests do;
* **health** — ``healthy`` flips to False exactly once, on
  :meth:`crash`; a crashed replica rejects every in-flight and queued
  request with :class:`ReplicaCrashed` (via ``DetectionServer.kill``),
  which is the signal the router's re-execution path keys on;
* **fault injection** — an injectable :class:`FaultPlan` consulted at
  the replica's public seams (submit admission, post-admission,
  drain).  Tests and the chip smoke run express failure scenarios as
  data instead of monkeypatching server internals, and the injection
  points are part of the wrapper's contract, not its implementation.

The wrapper deliberately adds **no routing logic**: which replica gets
a request, spill-over, and re-execution live in the router; the
replica only answers "can you take this" (admission), "how loaded are
you" (:meth:`load`), and "are you alive" (:attr:`healthy`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np

from repro_torch.serving.batcher import AdmissionError, BatcherConfig
from repro_torch.serving.server import DetectionServer, RequestHandle


class ReplicaCrashed(RuntimeError):
    """A replica died with this request in its hands (or was asked to
    take it after dying).  The router treats this as re-executable:
    the request never produced a result, so re-running it on a healthy
    sibling is exact, not at-most-once-violating."""


@dataclasses.dataclass
class FaultPlan:
    """Injectable failure schedule, consulted at the replica's seams.

    All fields count *this replica's* submit attempts (0-based order of
    arrival at :meth:`Replica.submit`), so tests can pin a fault to an
    exact request without reaching into server internals:

    * ``reject_submits`` — the next N submits raise
      :class:`AdmissionError` (induced backpressure; the router must
      spill over, counted as ``spillovers``);
    * ``crash_at_submit`` — crash *instead of admitting* submit #k:
      the request never enters this replica, the router re-routes it;
    * ``crash_after_admit`` — admit submit #k normally, then crash
      while it is in flight (mid-batch): its handle — and every other
      in-flight request here — rejects with :class:`ReplicaCrashed`
      and must resolve via sibling re-execution;
    * ``crash_on_drain`` — crash the next time the router drains this
      replica (the crash-during-drain / rolling-reconfigure scenario).
    """
    reject_submits: int = 0
    crash_at_submit: Optional[int] = None
    crash_after_admit: Optional[int] = None
    crash_on_drain: bool = False


class Replica:
    """One fleet member: a named, device-pinned :class:`DetectionServer`
    (``device`` None: the first card, raising if there is none) with
    health state and fault injection."""

    def __init__(self, name: str, cfg, params, *,
                 batcher: Optional[BatcherConfig] = None,
                 lanes: Optional[Dict[str, int]] = None,
                 device=None,
                 fault_plan: Optional[FaultPlan] = None,
                 **server_kw):
        self.name = name
        self.plan = fault_plan or FaultPlan()
        self.srv = DetectionServer(cfg, params, batcher=batcher,
                                   lanes=lanes, device=device,
                                   name=f"replica/{name}", **server_kw)
        self._lock = threading.Lock()
        self._dead = False
        self._closed = False
        self._submit_seq = 0   # arrival order, the FaultPlan's clock

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "Replica":
        self.srv.start()
        return self

    def warmup(self, sample_image: np.ndarray):
        return self.srv.warmup(sample_image)

    def close(self):
        """Graceful shutdown (drains).  Crashed replicas are already
        torn down — close() on one is a no-op, not a second teardown."""
        with self._lock:
            if self._dead or self._closed:
                return
            self._closed = True
        self.srv.close()

    def kill(self, error: Optional[BaseException] = None):
        """Abrupt shutdown with a caller-supplied rejection error (the
        router's non-graceful close path).  Unlike :meth:`crash` the
        replica counts as *closed*, not crashed — pending requests
        reject with ``error``, and the router's closed flag (set
        before killing) keeps those rejections from triggering
        re-routes."""
        with self._lock:
            if self._dead or self._closed:
                return
            self._closed = True
        self.srv.kill(error)

    def crash(self, reason: str = "fault injection"):
        """Simulated process death: flips ``healthy`` exactly once and
        abruptly kills the server — every in-flight and queued request
        here rejects with :class:`ReplicaCrashed` through its handle
        callbacks, which is what drives the router's re-execution."""
        with self._lock:
            if self._dead or self._closed:
                return
            self._dead = True
        self.srv.kill(ReplicaCrashed(
            f"replica {self.name} crashed ({reason})"))

    @property
    def healthy(self) -> bool:
        with self._lock:
            return not self._dead and not self._closed

    # -- fault-plan seams --------------------------------------------
    def _tick_submit(self) -> int:
        with self._lock:
            seq = self._submit_seq
            self._submit_seq += 1
        return seq

    # -- serving surface ---------------------------------------------
    def submit(self, images: np.ndarray, *, key=None,
               priority: Optional[str] = None,
               block: bool = False) -> RequestHandle:
        """Admit one request on this replica.  Consults the fault plan
        first: induced rejections and crashes happen at this seam, in
        arrival order, exactly as a real replica would fail — before
        or after admission, never half-way through the server's own
        bookkeeping."""
        seq = self._tick_submit()
        plan = self.plan
        if plan.crash_at_submit is not None and \
                seq >= plan.crash_at_submit:
            self.crash(f"crash_at_submit={plan.crash_at_submit}")
        if not self.healthy:
            raise ReplicaCrashed(f"replica {self.name} is down")
        if plan.reject_submits > 0:
            with self._lock:
                induced = plan.reject_submits > 0
                if induced:
                    plan.reject_submits -= 1
            if induced:
                self.srv.metrics.count("faults_injected")
                raise AdmissionError(
                    f"replica {self.name}: induced backpressure "
                    f"(fault plan)")
        handle = self.srv.submit(images, key=key, priority=priority,
                                 block=block)
        if plan.crash_after_admit is not None and \
                seq >= plan.crash_after_admit:
            self.crash(f"crash_after_admit={plan.crash_after_admit}")
        return handle

    def drain(self, timeout: Optional[float] = None) -> bool:
        if self.plan.crash_on_drain:
            self.plan.crash_on_drain = False
            self.crash("crash_on_drain")
            return False
        if not self.healthy:
            return False
        return self.srv.drain(timeout)

    def reconfigure(self, lanes: Dict[str, int]) -> Dict[str, int]:
        if not self.healthy:
            raise ReplicaCrashed(f"replica {self.name} is down")
        return self.srv.reconfigure(lanes)

    def load(self) -> Dict[str, int]:
        """Queue depth / in-flight / admission headroom (the router's
        least-loaded spill-over metric).  A dead replica reports zero
        headroom and infinite-equivalent depth so it always sorts
        last even if a stale poll races the crash."""
        if not self.healthy:
            return {"queue_depth": 1 << 30, "inflight_requests": 1 << 30,
                    "headroom": 0}
        return self.srv.load()

    def stats(self) -> dict:
        return self.srv.stats()

    def __repr__(self):
        state = "up" if self.healthy else "down"
        return f"Replica({self.name!r}, {state})"
