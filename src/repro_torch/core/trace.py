"""In-memory spans and counters of the port's detection path.

Port only: the JAX package has no counterpart.  The stream path records
a span at each layer boundary (the feeder's keys, each lane's queue
waits and stage function, the upload, the offsets, escalation's plan,
rounds and gathers, every wait for the card, the sink's finish) and
counts the ``batches`` it finishes; see the sites in ``core/lanes.py``,
``core/stages.py`` and ``core/detect.py``.

Recording is off by default.  While it is off, :func:`span` returns one
shared no-op context manager and :func:`count` returns at once: neither
reads a clock nor allocates, so a span site costs one global read and
one call.  :func:`start` turns recording on for the whole process and
:func:`stop` turns it off and returns the window's :class:`Recording`::

    from repro_torch.core import trace
    trace.start()
    ...                      # run_stream, the server, anything
    rec = trace.stop()
    rec.spans, rec.counters, rec.anchors, rec.threads

While it is on, each thread appends to a buffer of its own (thread
local, registered once under a lock), so a span takes no lock.  A span
records its name, the batch's sequence number ``seq`` (given, or else
its parent's, so every span of one batch on a lane shares it), the
thread's native id, its parent (the index of the innermost span open on
the thread when it began; -1 for none), its start and end on
``time.perf_counter_ns``, ``wait``: the thread only waits in it (for a
queue, or for the card), and, for a span opened with ``cpu=True``, the
thread CPU time it used (``time.thread_time_ns``: on some hosts a
system call that costs more than the rest of the span, so only the
stage functions and the waits for the card read it).  A span that began before
:func:`start` is not recorded, so its children in the window have no
parent; one still open at :func:`stop` ends there, with ``cpu_ns``
None.

:func:`start` and :func:`stop` each read the realtime clock and the
perf counter back to back (:attr:`Recording.anchors`): spans map onto
the realtime clock that other traces (``torch.profiler``'s) stamp, and
the two clocks' drift over the window is bounded by the anchors.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    """One recorded span; times in ns on ``time.perf_counter_ns``."""
    name: str
    seq: Optional[int]
    tid: int                 # threading.get_native_id() of its thread
    parent: int              # index in Recording.spans, -1 for none
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]    # thread CPU time used; None: not read
    #                          (cpu=False) or open at stop
    wait: bool


@dataclasses.dataclass(frozen=True)
class Recording:
    """What :func:`stop` returns: the window's spans (each thread's in
    the order they began, threads one after another), its counters (the
    counts made in it), the clock anchors ``((time_ns, perf_counter_ns) at start, the same at stop)``
    and ``threads``: each recording thread's native id -> (name,
    ``threading.get_ident()``)."""
    spans: List[Span]
    counters: Dict[str, int]
    anchors: Tuple[Tuple[int, int], Tuple[int, int]]
    threads: Dict[int, Tuple[str, int]]

    def self_ns(self) -> List[int]:
        """Each span's self time: its duration less its children's."""
        out = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.end_ns - s.start_ns
        return out


class _NoSpan:
    """The span of a process that is not recording."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Buffer:
    """One thread's spans, open-span stack and counts in a session."""
    __slots__ = ("tid", "spans", "open", "counts")

    def __init__(self):
        self.tid = threading.get_native_id()
        # (name, seq, parent, start_ns, end_ns or None, cpu: None where
        # not read, else the thread time at start while open and the
        # time used once closed, wait); an entry is replaced whole when
        # its span closes
        self.spans: list = []
        self.open: List[int] = []
        self.counts: Dict[str, int] = {}


class _Session:
    def __init__(self):
        self.local = threading.local()
        self.lock = threading.Lock()
        self.buffers: List[_Buffer] = []
        self.threads: Dict[int, Tuple[str, int]] = {}
        self.anchor = _anchor()

    def buffer(self) -> _Buffer:
        buf = getattr(self.local, "buf", None)
        if buf is None:
            buf = self.local.buf = _Buffer()
            me = threading.current_thread()
            with self.lock:
                self.buffers.append(buf)
                self.threads[buf.tid] = (me.name, me.ident)
        return buf


class _Span:
    __slots__ = ("_buf", "_head", "_i")

    def __init__(self, buf: _Buffer, name: str, seq: Optional[int],
                 wait: bool, cpu: bool):
        self._buf = buf
        self._head = (name, seq, wait, cpu)

    def __enter__(self):
        buf = self._buf
        name, seq, wait, cpu = self._head
        parent = buf.open[-1] if buf.open else -1
        if seq is None and parent >= 0:
            seq = buf.spans[parent][1]
        self._i = len(buf.spans)
        buf.open.append(self._i)
        buf.spans.append((name, seq, parent, time.perf_counter_ns(), None,
                          time.thread_time_ns() if cpu else None, wait))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        buf = self._buf
        name, seq, parent, start, _, cpu0, wait = buf.spans[self._i]
        if cpu0 is not None:
            cpu0 = time.thread_time_ns() - cpu0
        buf.spans[self._i] = (name, seq, parent, start, end, cpu0, wait)
        buf.open.pop()
        return False


_session: Optional[_Session] = None
_control = threading.Lock()


def _anchor() -> Tuple[int, int]:
    return time.time_ns(), time.perf_counter_ns()


def span(name: str, seq: Optional[int] = None, wait: bool = False,
         cpu: bool = False):
    """A context manager that records a span named ``name`` on this
    thread while recording is on (see the module's docstring)."""
    s = _session
    if s is None:
        return _NO_SPAN
    return _Span(s.buffer(), name, seq, wait, cpu)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while recording is on."""
    s = _session
    if s is None:
        return
    counts = s.buffer().counts
    counts[name] = counts.get(name, 0) + int(n)


def start():
    """Turn recording on for the process."""
    global _session
    with _control:
        if _session is not None:
            raise RuntimeError("trace: already recording")
        _session = _Session()


def stop() -> Recording:
    """Turn recording off and return the window's :class:`Recording`."""
    global _session
    with _control:
        s, _session = _session, None
        if s is None:
            raise RuntimeError("trace: not recording")
    end = _anchor()
    with s.lock:
        buffers = list(s.buffers)
        threads = dict(s.threads)
    spans: List[Span] = []
    counters: Dict[str, int] = {}
    for buf in buffers:
        base = len(spans)
        for name, seq, parent, t0, t1, cpu, wait in list(buf.spans):
            spans.append(Span(name, seq, buf.tid,
                              parent + base if parent >= 0 else -1, t0,
                              end[1] if t1 is None else t1,
                              None if t1 is None else cpu, wait))
        for k, v in dict(buf.counts).items():
            counters[k] = counters.get(k, 0) + v
    return Recording(spans, counters, (s.anchor, end), threads)
