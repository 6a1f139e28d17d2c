"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read.

Times are microseconds as the trace gives them.  Device events are the
kernels, copies and sets the profiler took from CUPTI (``cat`` kernel,
gpu_memcpy, gpu_memset), each with its CUDA stream; host events are the
CPU operators and CUDA runtime calls the profiler recorded.  The traced
window is the profiler's own span (its ``Trace`` event), widened to
every event.
"""
from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Event(NamedTuple):
    name: str
    ts: float
    dur: float
    stream: Optional[int]
    grid: Optional[Tuple[int, ...]]

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Trace(NamedTuple):
    device: List[Event]
    host: List[Event]
    start: float
    end: float

    @property
    def window_us(self) -> float:
        return self.end - self.start


def from_events(raw: List[dict]) -> Trace:
    """A Trace from the chrome trace's ``traceEvents``."""
    dev, host, span = [], [], []
    for e in raw:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        if e.get("cat") == "Trace":     # the profiler's own active span
            span.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            continue
        args = e.get("args", {})
        grid = args.get("grid")
        ev = Event(e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                   args.get("stream"), tuple(grid) if grid else None)
        if e.get("cat") in DEVICE_CATS:
            dev.append(ev)
        elif e.get("cat") in HOST_CATS:
            host.append(ev)
    span += [(e.ts, e.end) for e in dev + host]
    if not span:
        return Trace([], [], 0.0, 0.0)
    return Trace(sorted(dev, key=lambda e: e.ts), host,
                 min(a for a, _ in span), max(b for _, b in span))


def load(path) -> Trace:
    with open(path) as f:
        return from_events(json.load(f)["traceEvents"])


def union(spans) -> List[Tuple[float, float]]:
    """Merged (start, end) intervals of the spans, in order."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(events) -> float:
    """Time in which at least one of the events ran."""
    return sum(b - a for a, b in union((e.ts, e.end) for e in events))


def overlap_share(events) -> Optional[float]:
    """The share of the events' time during which an event on another
    stream also ran (None without events)."""
    total = sum(e.dur for e in events)
    if total <= 0:
        return None
    by_stream: Dict[object, list] = collections.defaultdict(list)
    for e in events:
        by_stream[e.stream].append(e)
    shared = 0.0
    for s, evs in by_stream.items():
        others = union((e.ts, e.end) for t, o in by_stream.items() if t != s
                       for e in o)
        starts = [a for a, _ in others]
        for e in evs:
            i = max(0, bisect.bisect_right(starts, e.ts) - 1)
            while i < len(others) and others[i][0] < e.end:
                a, b = others[i]
                shared += max(0.0, min(b, e.end) - max(a, e.ts))
                i += 1
    return shared / total


def device_ops(trace: Trace, top: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took most time."""
    acc: Dict[str, float] = collections.defaultdict(float)
    for e in trace.device:
        acc[e.name] += e.dur
    return [[n, us / 1e6] for n, us in
            sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """[label, seconds] of the longest stretches of the traced window in
    which the device ran nothing, each labelled by the host activity that
    filled most of it (the host event names that overlap it most, with
    their overlap in ms)."""
    busy = union((e.ts, e.end) for e in trace.device)
    gaps, cur = [], trace.start
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if trace.end > cur:
        gaps.append((cur, trace.end))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for a, b in gaps:
        over: Dict[str, float] = collections.defaultdict(float)
        for e in trace.host:
            o = min(b, e.end) - max(a, e.ts)
            if o > 0:
                over[e.name] += o
        names = sorted(over.items(), key=lambda kv: -kv[1])[:3]
        label = ("; ".join(f"{n} {o / 1e3:.3f} ms" for n, o in names)
                 if names else "no host event")
        out.append([f"{label} (at +{(a - trace.start) / 1e3:.1f} ms)",
                    (b - a) / 1e6])
    return out
