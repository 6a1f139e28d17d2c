"""Multi-lane horizontal-fusion executor (counterpart of
``repro.core.lanes``; QRMark §6.2, system layer).

Each detection stage (ingest, tiled decode, RS correction) is a
:class:`Stage`, and :class:`LaneExecutor` runs the allocator's lane
assignment as real concurrency: ``lanes[k]`` worker threads per stage k,
connected by bounded queues, with several mini-batches in flight per
stage.  Results come out in input order whatever the lane count, errors
are raised in sequence order, and stage functions are pure in their
payload (every RNG key is derived from the item's sequence number
before it enters), so any lane configuration equals serial execution of
the same stage functions bit for bit.

Two execution modes share the worker machinery: :meth:`LaneExecutor.run`
(single use, in input order) and the service mode
(:meth:`LaneExecutor.start`: :meth:`~LaneExecutor.submit` returns a
:class:`Ticket`, completions arrive in completion order,
:meth:`~LaneExecutor.drain`, :meth:`~LaneExecutor.close` and a live
:meth:`~LaneExecutor.reconfigure`).  This is the reference's plain
threading, unchanged.

Lanes as CUDA streams (:class:`LaneStreams`): on a card each worker
thread of a stage runs its stage function on a non-default stream of its
own, made at its first payload, so the kernel wrappers (which launch on
the current stream) of different lanes overlap on the device.  A payload
dict hands its device tensors to the next stage through an event
(:func:`hand_over` records it after the stage function, :func:`receive`
makes the next lane's stream wait on it before its first op and marks
every CUDA tensor of the payload with ``record_stream``, so the caching
allocator never gives a tensor's memory to its producer's next batch
while a later lane still reads it).  On the CPU lanes are host threads
and nothing else.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence

import torch


@dataclasses.dataclass
class Stage:
    """One node of the detection stage graph.

    ``fn`` maps payload -> payload.  ``lanes`` is the number of worker
    threads (concurrent mini-batches in flight for this stage); ``depth``
    bounds the stage's input queue.  ``gpu_intensive`` records the
    resource profile the allocator uses to decide who gets extra lanes
    (Algorithm 1 gives device-bound stages more streams, host-bound
    stages fewer)."""
    name: str
    fn: Callable[[Any], Any]
    lanes: int = 1
    depth: int = 2
    gpu_intensive: bool = False
    profile: Optional[object] = None   # allocator.StageProfile when known

    def __post_init__(self):
        if self.lanes < 1:
            raise ValueError(f"stage {self.name!r}: lanes must be >= 1")
        if self.depth < 1:
            raise ValueError(f"stage {self.name!r}: depth must be >= 1")


class _Failure:
    """Error marker that flows through the graph in place of a payload so
    ordering never stalls; re-raised at the consumer in sequence order."""

    def __init__(self, err: BaseException):
        self.err = err


_DONE = object()


class _Retire:
    """Poison token for live lane removal: the service worker that pops
    it exits instead of processing — queued payloads behind it keep
    flowing through the stage's remaining lanes."""


class Ticket:
    """Future for one payload submitted to a service-mode executor.

    Resolved (out of input order — completion order) by the dispatcher
    thread; ``result()`` re-raises the stage error if the payload
    failed."""

    def __init__(self, seq: int):
        self.seq = seq
        self._ready = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._ready.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ready.wait(timeout):
            raise TimeoutError(f"ticket {self.seq} not done after "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._ready.wait(timeout):
            raise TimeoutError(f"ticket {self.seq} not done after "
                               f"{timeout}s")
        return self._error

    def _resolve(self, value):
        self._value = value
        self._ready.set()

    def _reject(self, err: BaseException):
        self._error = err
        self._ready.set()


class LaneExecutor:
    """Runs a linear stage graph over a stream of items.

    * one input queue per stage, ``maxsize = stage.depth`` — bounded
      buffering is what overlaps the stages without unbounded memory;
    * ``stage.lanes`` daemon worker threads per stage — horizontal
      fusion: several mini-batches of the *same* stage in flight;
    * a reorder buffer at the sink restores input order, so lane count
      never changes observable results.
    """

    def __init__(self, stages: Sequence[Stage], name: str = "pipeline"):
        if not stages:
            raise ValueError("LaneExecutor needs at least one stage")
        self.stages = list(stages)
        self.name = name
        self._cancel = threading.Event()
        self._used = False
        # service-mode state (populated by start())
        self._service = False
        self._closed = False
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._tickets: Dict[int, tuple] = {}   # seq -> (Ticket, callback)
        self._submit_seq = 0
        self._service_threads: List[threading.Thread] = []
        self._lane_counts: Dict[str, int] = {}

    # -- cooperative queue ops so close() can unstick blocked workers ----
    def _put(self, q: "queue.Queue", item) -> bool:
        while not self._cancel.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: "queue.Queue"):
        while not self._cancel.is_set():
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                continue
        return _DONE

    def close(self):
        """Cancel in-flight work (workers drain and exit).  In service
        mode also rejects every unresolved ticket so no caller blocks on
        a result that will never arrive; call :meth:`drain` first for a
        graceful shutdown."""
        with self._lock:
            self._closed = True
            pending = list(self._tickets.values())
            self._tickets.clear()
            self._idle.notify_all()
        self._cancel.set()
        for ticket, callback in pending:
            self._deliver_rejection(ticket, callback)
        # join service threads: cancelled workers exit within one poll
        # interval, and leaving them alive into interpreter shutdown
        # aborts the process when the runtime's C++ state is torn down
        # under a thread mid-teardown
        me = threading.current_thread()
        for t in self._service_threads:
            if t is not me:
                t.join(timeout=2.0)

    # ------------------------------------------------------------------
    # service mode: long-lived submit/complete executor
    # ------------------------------------------------------------------
    def start(self) -> "LaneExecutor":
        """Switch to long-lived service mode.

        Spawns the stage workers and a dispatcher thread; payloads enter
        via :meth:`submit` and leave through their :class:`Ticket` (and
        optional callback) in *completion* order — the reorder buffer of
        :meth:`run` is the caller's concern here (an online server wants
        each result the moment it exists, not after its predecessors)."""
        if self._used:
            raise RuntimeError(
                f"{self.name}: executor already used (run() and start() "
                "are mutually exclusive, one lifecycle per executor)")
        self._used = True
        self._service = True
        self._qs = [queue.Queue(maxsize=s.depth) for s in self.stages]
        self._out_q: "queue.Queue" = queue.Queue(
            maxsize=self.stages[-1].depth)
        for i, st in enumerate(self.stages):
            self._lane_counts[st.name] = st.lanes
            for lane in range(st.lanes):
                self._spawn_service_worker(i, lane)
        disp = threading.Thread(target=self._dispatch_loop, daemon=True,
                                name=f"{self.name}/dispatch")
        disp.start()
        self._service_threads.append(disp)
        return self

    def _spawn_service_worker(self, idx: int, lane: int):
        t = threading.Thread(
            target=self._service_worker, args=(idx,), daemon=True,
            name=f"{self.name}/{self.stages[idx].name}.{lane}")
        t.start()
        self._service_threads.append(t)

    def _service_worker(self, idx: int):
        stage = self.stages[idx]
        in_q = self._qs[idx]
        nxt = self._qs[idx + 1] if idx + 1 < len(self._qs) else self._out_q
        while True:
            got = self._get(in_q)
            if got is _DONE:          # cancelled
                return
            if isinstance(got, _Retire):   # live lane removal
                return
            seq, payload = got
            if not isinstance(payload, _Failure):
                try:
                    payload = stage.fn(payload)
                except BaseException as e:
                    payload = _Failure(e)
            self._put(nxt, (seq, payload))

    def _deliver_rejection(self, ticket: Ticket, callback):
        """Reject a ticket AND fire its callback: completion callbacks
        are the only notification some callers have (the server's
        result scatter), so a close()-time rejection that skipped them
        would leave those callers blocked forever."""
        ticket._reject(RuntimeError(f"{self.name}: executor closed"))
        if callback is not None:
            try:
                callback(ticket)
            except BaseException:
                pass

    def _dispatch_loop(self):
        """Sink for service mode: resolve tickets in completion order."""
        while True:
            got = self._get(self._out_q)
            if got is _DONE:          # cancelled
                return
            seq, payload = got
            with self._lock:
                entry = self._tickets.pop(seq, None)
                if not self._tickets:
                    self._idle.notify_all()
            if entry is None:         # closed under us; ticket rejected
                continue
            ticket, callback = entry
            if isinstance(payload, _Failure):
                ticket._reject(payload.err)
            else:
                ticket._resolve(payload)
            if callback is not None:
                try:
                    callback(ticket)
                except BaseException:
                    pass              # callbacks must not kill the sink

    def submit(self, payload, *,
               callback: Optional[Callable[[Ticket], None]] = None
               ) -> Ticket:
        """Enqueue one payload; returns its :class:`Ticket`.

        Blocks while the first stage queue is full — the executor's
        bounded queues are the backpressure surface (admission control
        with a hard depth bound lives in the caller, e.g. the
        micro-batcher).  ``callback(ticket)`` fires on the dispatcher
        thread the moment the payload completes (out of order)."""
        if not self._service:
            raise RuntimeError(f"{self.name}: submit() requires service "
                               "mode — call start() first")
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self.name}: executor closed")
            seq = self._submit_seq
            self._submit_seq += 1
            ticket = Ticket(seq)
            self._tickets[seq] = (ticket, callback)
        if not self._put(self._qs[0], (seq, payload)):
            with self._lock:
                entry = self._tickets.pop(seq, None)
                if not self._tickets:
                    self._idle.notify_all()
            if entry is not None:    # close() didn't already reject it
                self._deliver_rejection(ticket, callback)
            return ticket
        return ticket

    def pending(self) -> int:
        """Number of submitted-but-unresolved payloads."""
        with self._lock:
            return len(self._tickets)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted payload has been delivered (or
        ``timeout`` elapses).  Returns True when idle."""
        with self._idle:
            return self._idle.wait_for(
                lambda: not self._tickets or self._closed, timeout)

    def reconfigure(self, lanes: Dict[str, int]) -> Dict[str, int]:
        """Re-apply a lane allocation to a *running* service executor.

        Growing a stage spawns workers immediately; shrinking enqueues
        retire tokens that the next free worker of that stage consumes —
        queued payloads are never dropped, and results stay bit-identical
        because stage fns are pure.  Returns the new lane map."""
        if not self._service:
            raise RuntimeError(f"{self.name}: reconfigure() requires "
                               "service mode")
        retire: List[int] = []     # stage indices, one entry per token
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self.name}: executor closed")
            for i, st in enumerate(self.stages):
                target = lanes.get(st.name)
                if target is None:
                    continue
                target = max(1, int(target))
                cur = self._lane_counts[st.name]
                if target > cur:
                    for lane in range(cur, target):
                        self._spawn_service_worker(i, lane)
                elif target < cur:
                    retire.extend([i] * (cur - target))
                self._lane_counts[st.name] = target
                st.lanes = target
            out = dict(self._lane_counts)
        # retire tokens ride the bounded stage queues; putting them
        # outside the lock keeps the dispatcher free to drain results
        # (the queues only empty while the sink keeps consuming)
        for i in retire:
            self._put(self._qs[i], _Retire())
        return out

    def lane_counts(self) -> Dict[str, int]:
        """Current {stage: lanes} (live, reflects reconfigure())."""
        if self._service:
            with self._lock:
                return dict(self._lane_counts)
        return {s.name: s.lanes for s in self.stages}

    # ------------------------------------------------------------------
    def run(self, items: Iterable) -> Iterator:
        """Pump ``items`` through the graph; yields results in order.

        Single-use: the sink cancels all workers when the stream ends,
        so a second ``run()`` needs a fresh executor."""
        if self._used:
            raise RuntimeError(
                f"{self.name}: LaneExecutor.run() is single-use — "
                "construct a new executor for another stream")
        self._used = True
        qs = [queue.Queue(maxsize=s.depth) for s in self.stages]
        # the sink queue is bounded too: a slow consumer must exert
        # backpressure on the whole graph, not buffer the entire stream
        out_q: "queue.Queue" = queue.Queue(maxsize=self.stages[-1].depth)

        def feeder():
            seq = 0
            try:
                for item in items:
                    if not self._put(qs[0], (seq, item)):
                        return
                    seq += 1
            except BaseException as e:  # source iterator failed: the
                # error takes the next sequence slot so every item fed
                # before it still comes out first
                self._put(qs[0], (seq, _Failure(e)))
            finally:
                self._put(qs[0], _DONE)

        def worker(idx: int, stage: Stage, done_box: dict):
            in_q = qs[idx]
            nxt = qs[idx + 1] if idx + 1 < len(qs) else out_q
            while True:
                got = self._get(in_q)
                if got is _DONE:
                    with done_box["lock"]:
                        done_box["n"] += 1
                        last = done_box["n"] >= stage.lanes
                    # siblings each need to see the sentinel once; the
                    # last lane forwards it downstream instead
                    self._put(nxt if last else in_q, _DONE)
                    return
                seq, payload = got
                if isinstance(payload, _Failure):
                    self._put(nxt, (seq, payload))
                    continue
                try:
                    payload = stage.fn(payload)
                except BaseException as e:
                    payload = _Failure(e)
                self._put(nxt, (seq, payload))

        threads = [threading.Thread(target=feeder, daemon=True,
                                    name=f"{self.name}/feed")]
        for i, st in enumerate(self.stages):
            box = {"lock": threading.Lock(), "n": 0}
            for lane in range(st.lanes):
                threads.append(threading.Thread(
                    target=worker, args=(i, st, box), daemon=True,
                    name=f"{self.name}/{st.name}.{lane}"))
        for t in threads:
            t.start()

        # sink: reorder buffer keyed by sequence number.  The sentinel
        # protocol guarantees _DONE reaches out_q only after every
        # result (each lane finishes + forwards its in-flight item
        # before consuming the sentinel), so draining until _DONE then
        # flushing the buffer sees every sequence number exactly once.
        buf: Dict[int, Any] = {}
        next_seq = 0
        done = False
        try:
            while not done or buf:
                if not done:
                    got = self._get(out_q)
                    if got is _DONE:
                        done = True
                        continue
                    seq, payload = got
                    buf[seq] = payload
                while next_seq in buf:
                    payload = buf.pop(next_seq)
                    next_seq += 1
                    if isinstance(payload, _Failure):
                        raise payload.err
                    yield payload
                if done and buf and next_seq not in buf:
                    raise RuntimeError(
                        f"{self.name}: lost sequence {next_seq} "
                        f"(have {sorted(buf)})")
        finally:
            self.close()

    def map(self, items: Iterable) -> List:
        """Eager form of :meth:`run`."""
        return list(self.run(items))


def lanes_from_allocation(stage_names: Sequence[str],
                          streams: Sequence[int]) -> Dict[str, int]:
    """{stage: lanes} from an ``allocator.Allocation.streams`` vector."""
    return {n: max(1, int(s)) for n, s in zip(stage_names, streams)}


# ---------------------------------------------------------------------------
# lanes as CUDA streams
# ---------------------------------------------------------------------------

READY = "ready_event"   # payload field: the event its device tensors wait on


def _cuda_tensors(tree):
    """The CUDA tensors of a tree of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            yield tree
    elif isinstance(tree, (dict, tuple, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _cuda_tensors(v)


def hand_over(p, stream: "torch.cuda.Stream"):
    """After a stage function on ``stream``: when the payload dict holds
    CUDA tensors, record an event on the stream into it (field
    :data:`READY`) for the next lane to wait on."""
    if isinstance(p, dict) and any(True for _ in _cuda_tensors(p)):
        ev = torch.cuda.Event()
        ev.record(stream)
        p[READY] = ev


def receive(p, stream: "torch.cuda.Stream"):
    """Before a stage function on ``stream``: wait on the payload's event
    (if it carries one) and mark its CUDA tensors as used on ``stream``."""
    ev = p.pop(READY, None) if isinstance(p, dict) else None
    if ev is not None:
        stream.wait_event(ev)
        for t in _cuda_tensors(p):
            t.record_stream(stream)


def upload(a, device: torch.device) -> torch.Tensor:
    """An array or tensor on ``device``, contiguous.  From host memory to
    a card it is two steps: a copy into pinned host memory, then a
    non-blocking copy on the current stream (the pinned block is not
    reused before that copy has run)."""
    t = torch.as_tensor(a)
    if device.type != "cuda" or t.is_cuda:
        return t.to(device).contiguous()
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True)


class LaneStreams:
    """Lanes as CUDA streams on one device.

    :meth:`wrap` turns a payload stage function into one that runs, on
    each worker thread that calls it, on that thread's own non-default
    stream of ``device`` (made at its first call and kept for the
    thread's life), between :func:`receive` and :func:`hand_over`.  On a
    CPU device :meth:`wrap` returns the function itself."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._local = threading.local()

    def stream(self) -> "torch.cuda.Stream":
        """This thread's lane stream."""
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = torch.cuda.Stream(self.device)
        return s

    def wrap(self, fn: Callable[[Any], Any]) -> Callable[[Any], Any]:
        if self.device.type != "cuda":
            return fn

        def on_lane_stream(p):
            s = self.stream()
            with torch.cuda.stream(s):
                receive(p, s)
                out = fn(p)
                hand_over(out, s)
            return out

        return on_lane_stream
