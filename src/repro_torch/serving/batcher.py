"""Dynamic micro-batching for the online detection server (counterpart
of ``repro.serving.batcher``).

Requests (single images or small groups, each with pre-derived
per-image fold_in keys) arrive over time; the batcher coalesces queued
requests into ``pad_to_bucket``-shaped micro-batches under a
``max_wait_ms`` deadline:

* a micro-batch ships as soon as ``max_batch`` images are queued, or
  when the *oldest* queued request has waited ``max_wait_ms`` —
  deadline-triggered partial batches keep tail latency bounded at low
  offered load, batch shaping keeps throughput at high load;
* request groups are atomic (one request's images never split across
  micro-batches), so each request's result rows are one contiguous
  slice;
* admission control is depth-bounded: when ``max_queue`` images are
  already waiting, ``submit`` raises :class:`AdmissionError`
  (backpressure to the client, not host OOM) unless ``block=True``.

SLO-tiered admission (``BatcherConfig.classes``): requests may carry a
priority class, each class with its own deadline generalizing
``max_wait_ms``.  Dict order is priority order — when a micro-batch
forms, higher classes are popped first and lower classes only backfill
the remaining capacity (interactive preempts bulk), while the shipping
deadline is the earliest across class heads so no class's SLO is
hostage to another's.  Aging closes the starvation hole priority
popping would otherwise open: an entry whose deadline has already
expired is promoted to the head of the pop order (earliest expired
deadline first, ahead of fresh higher-class traffic), so even when
interactive load alone fills ``max_batch`` every cycle, a bulk entry
waits at most ~its deadline before it is *included* in a batch — the
deadline bounds inclusion, not just ship timing.  Backpressure is
tiered too: classes after the
first admit only up to ``bulk_admit_frac * max_queue`` queued images,
so bulk traffic absorbs ``AdmissionError`` first and the interactive
class keeps headroom.  With ``classes=None`` (default) everything runs
as one class with ``max_wait_ms`` — bit-for-bit the legacy behavior.

Bit-identity: the batcher only moves arrays around — keys travel with
their images, padding rows repeat the last image/key and are sliced
off after RS — so any coalescing of any arrival order produces results
bitwise equal to ``detect_batch`` of each request alone with its key.
Priority classes reorder *which* requests coalesce together, which the
per-request key discipline makes result-inert.

Keys are the port's (n, 2) int64 key tensors (``repro_torch.core.prng``,
on the host as ``StageRegistry.image_keys`` derives them); a micro-batch
joins and pads them with ``torch.cat`` on their own device, so they
cross to the card with the batch, in the ingest stage.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


class AdmissionError(RuntimeError):
    """Request rejected at admission (invalid, or queue depth bound)."""


def pad_to_bucket(raw: np.ndarray, bucket: int = 0) -> Tuple[np.ndarray, int]:
    """Pad a ragged batch up to a shape bucket: the next power of two
    when ``bucket`` is 0, else the next multiple of ``bucket``.  Returns
    (padded batch, true size).  Empty batches are rejected — there is no
    row to repeat and no work to do."""
    b = raw.shape[0]
    if b == 0:
        raise AdmissionError(
            "pad_to_bucket: empty batch (b == 0) — reject empty "
            "requests at admission instead of padding nothing")
    if bucket > 0:
        target = -(-b // bucket) * bucket
    else:
        target = 1
        while target < b:
            target *= 2
    if target == b:
        return raw, b
    return np.concatenate(
        [raw, np.repeat(raw[-1:], target - b, axis=0)]), b


@dataclasses.dataclass
class BatcherConfig:
    max_batch: int = 32       # images per coalesced micro-batch
    max_wait_ms: float = 5.0  # oldest-request deadline for partial ships
    max_queue: int = 256      # queued-image admission bound
    bucket: int = 0           # pad_to_bucket granularity (0 = pow2)
    # SLO classes: {name: max_wait_ms}, dict order = priority order
    # (first = highest).  None = single legacy class ("default",
    # max_wait_ms).  Non-first classes admit only up to
    # bulk_admit_frac * max_queue queued images.
    classes: Optional[Mapping[str, float]] = None
    bulk_admit_frac: float = 0.5


@dataclasses.dataclass
class _Entry:
    images: np.ndarray        # (n, H, W, 3) uint8
    keys: Any                 # (n, 2) int64 key tensor
    slot: Any                 # opaque per-request handle for the scatter
    t_enq: float


@dataclasses.dataclass
class MicroBatch:
    """One coalesced, padded unit of work for the stage graph."""
    raw: np.ndarray           # (padded_b, H, W, 3)
    keys: Any                 # (padded_b, 2) int64 key tensor
    slots: List[Tuple[Any, int, int]]   # (slot, offset, n) per request
    true_b: int
    padded_b: int
    t_formed: float

    @property
    def occupancy(self) -> float:
        return self.true_b / self.padded_b if self.padded_b else 0.0


class MicroBatcher:
    """Thread-safe request queue + deadline-driven coalescer."""

    def __init__(self, cfg: BatcherConfig = BatcherConfig()):
        if cfg.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if cfg.classes is not None and not cfg.classes:
            raise ValueError("classes must be a non-empty mapping "
                             "(or None for the single legacy class)")
        if not 0.0 < cfg.bulk_admit_frac <= 1.0:
            raise ValueError("bulk_admit_frac must be in (0, 1]")
        self.cfg = cfg
        # priority order = dict order; single legacy class otherwise
        if cfg.classes:
            self.classes = list(cfg.classes)
            self._wait_ms = {c: float(cfg.classes[c])
                             for c in self.classes}
        else:
            self.classes = ["default"]
            self._wait_ms = {"default": cfg.max_wait_ms}
        for c, w in self._wait_ms.items():
            if w <= 0:
                raise ValueError(f"class {c!r} deadline must be > 0 ms")
        self._cv = threading.Condition()
        self._q: Dict[str, List[_Entry]] = {c: [] for c in self.classes}
        self._depth = 0           # queued images, all classes
        self._closed = False

    # -- admission --------------------------------------------------------
    def resolve_class(self, priority: Optional[str] = None) -> str:
        """Map a request's priority to a configured class (None -> the
        highest class).  Unknown names are an admission error — a
        client bug, surfaced where every other invalid request is."""
        if priority is None:
            return self.classes[0]
        if priority not in self._wait_ms:
            raise AdmissionError(
                f"unknown priority class {priority!r} "
                f"(configured: {self.classes})")
        return priority

    def _admit_bound(self, cls: str) -> int:
        """Per-class queued-image bound: the highest class gets the
        full ``max_queue``; every lower class only
        ``bulk_admit_frac * max_queue`` — bulk traffic hits
        backpressure first and interactive keeps headroom."""
        if cls == self.classes[0]:
            return self.cfg.max_queue
        return max(1, int(self.cfg.max_queue * self.cfg.bulk_admit_frac))

    def submit(self, images: np.ndarray, keys, slot,
               *, priority: Optional[str] = None,
               block: bool = False, timeout: Optional[float] = None):
        """Admit one request.  Raises :class:`AdmissionError` on an
        empty/oversized request or (``block=False``) a full queue."""
        n = int(images.shape[0])
        if n == 0:
            raise AdmissionError("empty request (0 images)")
        if n > self.cfg.max_batch:
            raise AdmissionError(
                f"request of {n} images exceeds max_batch="
                f"{self.cfg.max_batch}; split it client-side")
        cls = self.resolve_class(priority)
        bound = self._admit_bound(cls)
        with self._cv:
            if self._closed:
                raise AdmissionError("batcher closed")
            if self._depth + n > bound:
                if not block:
                    raise AdmissionError(
                        f"queue full ({self._depth}/{bound} images "
                        f"queued for class {cls!r}) — backpressure, "
                        f"retry later")
                ok = self._cv.wait_for(
                    lambda: self._closed
                    or self._depth + n <= bound, timeout)
                if not ok or self._closed:
                    raise AdmissionError("queue full (timed out blocking)"
                                         if not self._closed else
                                         "batcher closed")
            self._q[cls].append(
                _Entry(images, keys, slot, time.perf_counter()))
            self._depth += n
            self._cv.notify_all()

    def depth(self) -> int:
        """Queued images (admission-control view of the backlog)."""
        with self._cv:
            return self._depth

    def headroom(self, priority: Optional[str] = None) -> int:
        """Images a non-blocking :meth:`submit` for this class could
        admit right now (0 when closed or at the class's depth bound) —
        the backpressure surface the fleet router's least-loaded
        spill-over reads instead of probing with doomed submits."""
        cls = self.resolve_class(priority)
        with self._cv:
            if self._closed:
                return 0
            return max(0, self._admit_bound(cls) - self._depth)

    def class_depths(self) -> Dict[str, int]:
        """Queued images per priority class (metrics view)."""
        with self._cv:
            return {c: sum(e.images.shape[0] for e in q)
                    for c, q in self._q.items()}

    @property
    def closed(self) -> bool:
        """Whether :meth:`close` was called (admission stopped)."""
        with self._cv:
            return self._closed

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def flush(self) -> List[_Entry]:
        """Drain and return whatever is still queued — the shutdown
        path, so a forced close can reject the orphaned requests
        instead of leaving their futures unresolved."""
        with self._cv:
            take: List[_Entry] = []
            for c in self.classes:
                take.extend(self._q[c])
                self._q[c] = []
            self._depth = 0
            self._cv.notify_all()
            return take

    # -- coalescing ---------------------------------------------------------
    def _earliest_deadline(self) -> float:
        """Min over class heads of (enqueue time + class deadline) —
        the partial-batch ship time.  Caller holds the lock and
        guarantees at least one queue is non-empty."""
        return min(q[0].t_enq + self._wait_ms[c] / 1e3
                   for c, q in self._q.items() if q)

    def next_batch(self, timeout: Optional[float] = None
                   ) -> Optional[MicroBatch]:
        """Block until a micro-batch is ready (or ``timeout``); returns
        None on timeout or when closed and empty.

        Ships when ``max_batch`` images are queued or the earliest
        per-class head deadline expires — whichever first.  Popping is
        in priority order — the highest class fills first, lower
        classes backfill remaining capacity — EXCEPT that entries whose
        deadline has already expired are promoted ahead of everything
        (earliest expired deadline first), so sustained high-class
        traffic can delay a lower class only up to its deadline, never
        starve it out of batches entirely."""
        cfg = self.cfg
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._depth or self._closed, timeout):
                return None
            if not self._depth:
                return None          # closed and empty
            while (not self._closed and self._depth < cfg.max_batch):
                # recomputed every wake: a late higher-priority arrival
                # with a shorter deadline must be able to pull the ship
                # time earlier
                rem = self._earliest_deadline() - time.perf_counter()
                if rem <= 0:
                    break
                self._cv.wait(rem)
                if not self._depth:  # drained by close() race
                    return None
            # pop whole requests up to max_batch (groups stay atomic):
            # heads whose deadline already expired go first (earliest
            # expired deadline wins, regardless of class — the aging
            # rule that keeps bulk from starving under an interactive
            # flood), then priority order, lower classes backfilling
            take: List[_Entry] = []
            total = 0
            now = time.perf_counter()
            while True:
                best = None       # (sort key, class)
                for i, c in enumerate(self.classes):
                    q = self._q[c]
                    if not q or total + q[0].images.shape[0] \
                            > cfg.max_batch:
                        continue
                    dl = q[0].t_enq + self._wait_ms[c] / 1e3
                    # expired heads (0, deadline, ...) sort before all
                    # fresh heads (1, priority, ...)
                    k = (0, dl, i) if dl <= now else (1, i, 0.0)
                    if best is None or k < best[0]:
                        best = (k, c)
                if best is None:
                    break
                e = self._q[best[1]].pop(0)
                take.append(e)
                total += e.images.shape[0]
            self._depth -= total
            self._cv.notify_all()    # wake blocked submitters
        assert take, "next_batch woke with an un-poppable queue head"
        raw = (take[0].images if len(take) == 1
               else np.concatenate([e.images for e in take]))
        keys = (take[0].keys if len(take) == 1
                else torch.cat([e.keys for e in take]))
        raw, true_b = pad_to_bucket(raw, cfg.bucket)
        pad = raw.shape[0] - true_b
        if pad:
            # pad keys like the images: repeated rows are inert (results
            # sliced off before the scatter), any key value works
            keys = torch.cat([keys, keys[-1:].repeat(pad, 1)])
        slots, off = [], 0
        for e in take:
            n = e.images.shape[0]
            slots.append((e.slot, off, n))
            off += n
        return MicroBatch(raw=raw, keys=keys, slots=slots, true_b=true_b,
                          padded_b=raw.shape[0],
                          t_formed=time.perf_counter())
