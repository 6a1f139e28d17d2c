"""The program's spans on the device trace's timeline, and what the
span metrics and the breakdown read of them.

The port's recorder (``repro_torch.core.trace``; a program without one
gives nothing here, and every function below then returns None) stamps
its spans on ``time.perf_counter_ns``, with a pair of (realtime,
perf-counter) readings at its start and at its stop.  ``torch.profiler``'s
chrome trace stamps ``ts`` in microseconds counted from its top-level
``baseTimeNanoseconds`` on the realtime clock.  A span maps onto the
trace's microseconds linearly between the two anchors, so the clocks'
drift over the window is spread over it.

A traced run starts the recorder right after the profiler and stops it
right before the profiler, on the thread that starts and stops the
profiler, and reads the trace file before it is deleted:

    rec = spans.recorder()              # after the profiler starts
    rec.start()
    ...
    recording = rec.stop()              # before the profiler stops
    ctx.update(spans.context(recording, spans.trace_file(path)))

The check of the mapping: the CUDA runtime calls that launch a kernel
or copy (``cudaLaunchKernel*``, ``cudaMemcpyAsync``) of a lane thread
(one that ran a ``stage.*`` span) are all made inside its stage
function, so after mapping they fall inside a ``stage.*`` span of their
own thread.  Counted are the calls the trace gives to a lane thread
after the start of the first span that thread's loop recorded
(``lane.wait_in``, ``stage.*`` or ``lane.wait_out`` without a parent:
the one before it may have begun before the recorder) and before the
recorder stopped.
"""
from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, NamedTuple, Optional, Tuple

import devtrace

RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync")
LANE_LOOP = ("lane.wait_in", "lane.wait_out")


class Span(NamedTuple):
    """A span in the trace's microseconds."""
    name: str
    seq: Optional[int]
    tid: int
    parent: int
    ts: float
    end: float
    cpu: Optional[float]     # thread CPU time used, us; None: not read
    #                          or open at stop
    wait: bool
    self_us: float           # duration less its children's

    @property
    def dur(self) -> float:
        return self.end - self.ts


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace


def trace_file(path) -> dict:
    """What the spans need of the chrome trace at ``path``: its
    ``baseTimeNanoseconds`` and the kernel-launch and copy runtime calls
    as (name, tid, ts, end)."""
    with open(path) as f:
        raw = json.load(f)
    calls = [(e["name"], e.get("tid"), float(e["ts"]),
              float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in raw.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
             and e.get("name", "").startswith(RUNTIME_CALLS)]
    return {"base_ns": raw.get("baseTimeNanoseconds"), "runtime": calls}


def context(recording, tf: dict) -> dict:
    """The ctx keys of a recording mapped onto the trace of ``tf``
    (:func:`trace_file`): ``spans`` (a list of :class:`Span`),
    ``counters``, ``span_window`` (the recording's start and stop, us),
    ``span_threads`` (native id -> (name, ident)), ``runtime`` and
    ``clock_drift_us`` (realtime less perf-counter time over the
    window).  Empty without a recording or a base time."""
    base = tf.get("base_ns")
    if recording is None or base is None:
        return {}
    (r0, p0), (r1, p1) = recording.anchors
    scale = (r1 - r0) / (p1 - p0) if p1 > p0 else 1.0

    def us(p):
        return ((r0 - base) + (p - p0) * scale) / 1e3

    self_ns = recording.self_ns()
    out = [Span(s.name, s.seq, s.tid, s.parent, us(s.start_ns),
                us(s.end_ns), None if s.cpu_ns is None else s.cpu_ns / 1e3,
                s.wait, self_ns[i] * scale / 1e3)
           for i, s in enumerate(recording.spans)]
    return {"spans": out, "counters": dict(recording.counters),
            "span_window": (us(p0), us(p1)),
            "span_threads": dict(recording.threads),
            "runtime": tf.get("runtime", []),
            "clock_drift_us": ((r1 - r0) - (p1 - p0)) / 1e3}


def _batches(ctx) -> Optional[int]:
    if not ctx.get("spans"):
        return None
    return ctx.get("counters", {}).get("batches") or None


def _children(spans: List[Span]) -> Dict[int, List[int]]:
    kids: Dict[int, List[int]] = collections.defaultdict(list)
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids[s.parent].append(i)
    return kids


def _waited(spans, kids, i) -> Tuple[float, Optional[float]]:
    """(wall, CPU) us of span i's outermost wait descendants; CPU None
    where one of them was open at stop."""
    wall, cpu, todo = 0.0, 0.0, list(kids.get(i, ()))
    while todo:
        j = todo.pop()
        s = spans[j]
        if s.wait:
            wall += s.dur
            cpu = None if cpu is None or s.cpu is None else cpu + s.cpu
        else:
            todo.extend(kids.get(j, ()))
    return wall, cpu


def host_ms_per_batch(ctx, name: str) -> Optional[float]:
    """Wall time in spans named ``name`` less their wait descendants
    (the host waiting for the card), ms per batch finished in the
    recording."""
    n = _batches(ctx)
    if n is None:
        return None
    spans = ctx["spans"]
    kids = _children(spans)
    return sum(s.dur - _waited(spans, kids, i)[0]
               for i, s in enumerate(spans) if s.name == name) / 1e3 / n


def wait_ms_per_batch(ctx, name: str) -> Optional[float]:
    """Wall time in spans named ``name`` on every thread, ms per batch
    finished in the recording."""
    n = _batches(ctx)
    if n is None:
        return None
    return sum(s.dur for s in ctx["spans"] if s.name == name) / 1e3 / n


def starved_share(ctx, stage: str) -> Optional[float]:
    """The share (%) of the time of the lanes of ``stage`` (threads that
    ran a ``stage.<stage>`` span) over the recording that they spent
    waiting for input (``lane.wait_in``)."""
    if _batches(ctx) is None:
        return None
    spans, (a, b) = ctx["spans"], ctx["span_window"]
    lanes = {s.tid for s in spans if s.name == f"stage.{stage}"}
    if not lanes or b <= a:
        return None
    waited = sum(max(0.0, min(b, s.end) - max(a, s.ts)) for s in spans
                 if s.name == "lane.wait_in" and s.tid in lanes)
    return 100.0 * waited / (len(lanes) * (b - a))


def offcpu_share(ctx) -> Optional[float]:
    """Over the lanes' work time (``stage.*`` spans less their wait
    descendants), the share (%) the threads spent off the CPU: wall
    time less thread CPU time.  Spans open at stop, or with a wait
    descendant whose CPU time was not read, are left out."""
    if _batches(ctx) is None:
        return None
    spans = ctx["spans"]
    kids = _children(spans)
    wall = cpu = 0.0
    for i, s in enumerate(spans):
        if not s.name.startswith("stage.") or s.cpu is None:
            continue
        w_wall, w_cpu = _waited(spans, kids, i)
        if w_cpu is None:
            continue
        wall += s.dur - w_wall
        cpu += s.cpu - w_cpu
    if wall <= 0:
        return None
    return 100.0 * (wall - cpu) / wall


def _minus(a: float, b: float, holes) -> List[Tuple[float, float]]:
    """[a, b] less the sorted, disjoint ``holes``."""
    out, cur = [], a
    for x, y in holes:
        if x > cur:
            out.append((cur, min(x, b)))
        cur = max(cur, y)
        if cur >= b:
            break
    if cur < b:
        out.append((cur, b))
    return [(x, y) for x, y in out if y > x]


def work_intervals(spans: List[Span]) -> List[Tuple[float, float, str]]:
    """(start, end, name) where a thread's innermost open span is a
    work span (not a wait), on every thread."""
    kids = _children(spans)
    out = []
    for i, s in enumerate(spans):
        if s.wait:
            continue
        holes = sorted((spans[j].ts, spans[j].end) for j in kids.get(i, ()))
        out += [(x, y, s.name) for x, y in _minus(s.ts, s.end, holes)]
    return out


def _idle(trace: devtrace.Trace, window) -> List[Tuple[float, float]]:
    """The device's idle stretches inside the trace and ``window``."""
    a = max(trace.start, window[0])
    b = min(trace.end, window[1])
    if b <= a:
        return []
    return _minus(a, b, devtrace.union((e.ts, e.end) for e in trace.device))


def _overlap(intervals, with_sorted) -> float:
    """Total overlap of ``intervals`` with the sorted, disjoint
    ``with_sorted``."""
    starts = [x for x, _ in with_sorted]
    total = 0.0
    for a, b in intervals:
        k = max(0, bisect.bisect_right(starts, a) - 1)
        while k < len(with_sorted) and with_sorted[k][0] < b:
            x, y = with_sorted[k]
            total += max(0.0, min(b, y) - max(a, x))
            k += 1
    return total


def idle_spans(trace: devtrace.Trace, ctx, top: int = 10
               ) -> Optional[List[list]]:
    """[name, seconds] of the span names whose work (a thread's innermost
    span, not a wait) overlapped the device's idle time most, summed
    over threads."""
    if not ctx.get("spans") or trace is None:
        return None
    idle = _idle(trace, ctx["span_window"])
    by_name: Dict[str, list] = collections.defaultdict(list)
    for a, b, name in work_intervals(ctx["spans"]):
        by_name[name].append((a, b))
    over = {n: _overlap(iv, idle) for n, iv in by_name.items()}
    return [[n, s / 1e6] for n, s in
            sorted(over.items(), key=lambda kv: -kv[1])[:top] if s > 0]


def idle_without_work(trace: devtrace.Trace, ctx) -> Optional[float]:
    """The share (%) of the device's idle time in the recording during
    which no program thread was inside a work span."""
    if not ctx.get("spans") or trace is None:
        return None
    idle = _idle(trace, ctx["span_window"])
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    busy = devtrace.union((a, b) for a, b, _ in
                          work_intervals(ctx["spans"]))
    return 100.0 * (total - _overlap(busy, idle)) / total


def mapping_check(ctx) -> Optional[dict]:
    """The share (%) of the lane threads' kernel-launch and copy runtime
    calls (see the module's docstring) inside a ``stage.*`` span of
    their thread, the calls counted, and how trace thread ids were
    matched to the spans' (``native``: the same native id; ``pthread``:
    the absolute value of the thread's ``threading.get_ident`` cut to a
    signed 32-bit int)."""
    if not ctx.get("spans"):
        return None
    spans, (_, stop) = ctx["spans"], ctx["span_window"]
    first: Dict[int, float] = {}
    stages: Dict[int, list] = collections.defaultdict(list)
    for s in spans:
        if s.name.startswith("stage."):
            stages[s.tid].append((s.ts, s.end))
        if s.parent < 0 and (s.name in LANE_LOOP
                             or s.name.startswith("stage.")):
            first[s.tid] = min(first.get(s.tid, s.ts), s.ts)
    calls = ctx.get("runtime", [])
    alias = {t: t for t in stages}
    matched = "native"
    if calls and not any(tid in alias for _, tid, _, _ in calls):
        # the trace may give a call the thread's pthread id cut to a
        # signed 32-bit int, and print its absolute value
        matched = "pthread"
        alias = {}
        for native, (_, ident) in ctx.get("span_threads", {}).items():
            if native in stages:
                low = ident & 0xFFFFFFFF
                alias[low if low < 1 << 31 else (1 << 32) - low] = native
    n = inside = 0
    for _, tid, a, b in calls:
        native = alias.get(tid)
        if native is None or native not in first or a < first[native] \
                or b > stop:
            continue
        n += 1
        inside += any(x <= a and b <= y for x, y in stages[native])
    if not n:
        return {"share": None, "calls": 0, "matched_by": matched}
    return {"share": 100.0 * inside / n, "calls": n, "matched_by": matched}


def summary(trace: devtrace.Trace, ctx) -> Optional[str]:
    """One line of the run's log: the recording, the mapping check,
    idle time with no program work, and the host ms per batch by span
    name (self time), most first."""
    n = _batches(ctx)
    if n is None:
        return None
    spans = ctx["spans"]
    check = mapping_check(ctx)
    share = check["share"]
    self_ms: Dict[str, float] = collections.defaultdict(float)
    for s in spans:
        if not s.wait:
            self_ms[s.name] += s.self_us / 1e3 / n
    top = sorted(self_ms.items(), key=lambda kv: -kv[1])[:12]
    idle = idle_without_work(trace, ctx)
    a, b = ctx["span_window"]
    return (f"spans: {len(spans)} on {len({s.tid for s in spans})} threads "
            f"over {(b - a) / 1e6:.3f} s, {n} batches, clocks drift "
            f"{ctx['clock_drift_us']:.1f} us; mapping check: "
            f"{'none' if share is None else f'{share:.2f} %'} of "
            f"{check['calls']} launch and copy calls of lane threads inside "
            f"a stage span of their thread (thread ids matched by the "
            f"{check['matched_by']} id); device idle with no program "
            f"thread in a work span: "
            f"{'none' if idle is None else f'{idle:.2f} %'}; host ms a "
            f"batch by span (self): "
            + ", ".join(f"{k} {v:.3f}" for k, v in top))
