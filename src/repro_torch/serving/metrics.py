"""Serving metrics registry (counterpart of ``repro.serving.metrics``):
counters, gauges, and windowed latency percentiles.

Deliberately dependency-free (no prometheus client in the container):
a :class:`MetricsRegistry` is a thread-safe dict of counters/gauges
plus bounded reservoirs for distributions.  ``snapshot()`` renders the
report the server and the fig11/fig12 benchmarks consume — queue
depth, batch occupancy, p50/p95/p99 request latency, throughput, and
the escalation telemetry (``images_escalated`` / ``escalation_batches``
counters, the ``tiles_per_image`` distribution; the server derives
``escalation_rate`` from them in ``stats()``).

Cache / admission telemetry: the server counts cache hits by tier
(``cache_hit_exact`` / ``cache_hit_embed`` / ``cache_miss`` plus
``dedup_coalesced`` for in-flight coalescing) and observes request
latency both overall (``request_latency_s``) and per priority class
(``request_latency_<class>_s`` — p50/p95 per class come out of the
same snapshot machinery).  ``snapshot()`` derives ``rejection_rate``
(rejected / offered) and the request-level ``cache_hit_rate`` from the
counters so every consumer reads one definition.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict

# distributions keep the most recent N observations — enough for stable
# tail percentiles at benchmark scale without unbounded growth
_RESERVOIR = 8192


def aggregate_counters(snapshots) -> Dict[str, float]:
    """Sum the ``counters`` dicts of several :meth:`MetricsRegistry
    .snapshot` outputs — the fleet-level rollup (per-replica counters
    are exact and additive; latency distributions are NOT additive and
    stay per-replica, the router observes its own fleet-wide ones)."""
    out: Dict[str, float] = {}
    for snap in snapshots:
        for k, v in snap.get("counters", {}).items():
            out[k] = out.get(k, 0.0) + v
    return out


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (q in [0,100])."""
    if not sorted_vals:
        return float("nan")
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


class MetricsRegistry:
    """Thread-safe counters / gauges / distributions for the server."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._dists: Dict[str, Deque[float]] = {}
        self._t0 = time.perf_counter()

    # -- primitives -----------------------------------------------------
    def count(self, name: str, delta: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float):
        with self._lock:
            d = self._dists.get(name)
            if d is None:
                d = self._dists[name] = deque(maxlen=_RESERVOIR)
            d.append(float(value))

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    # -- the serving report ----------------------------------------------
    def snapshot(self) -> dict:
        """One dict with everything: counters, gauges, and per
        distribution n/mean/p50/p95/p99 (latencies in the unit they
        were observed in — the server observes seconds)."""
        with self._lock:
            wall = time.perf_counter() - self._t0
            out = {"wall_s": wall,
                   "counters": dict(self._counters),
                   "gauges": dict(self._gauges)}
            dists = {k: sorted(v) for k, v in self._dists.items()}
        for name, vals in dists.items():
            out[name] = {
                "n": len(vals),
                "mean": (sum(vals) / len(vals)) if vals else float("nan"),
                "p50": percentile(vals, 50),
                "p95": percentile(vals, 95),
                "p99": percentile(vals, 99),
            }
        done = out["counters"].get("requests_completed", 0.0)
        imgs = out["counters"].get("images_completed", 0.0)
        out["throughput_rps"] = done / wall if wall > 0 else 0.0
        out["throughput_ips"] = imgs / wall if wall > 0 else 0.0
        c = out["counters"]
        # admission funnel: rejected vs everything the server accepted
        # (admitted covers cache hits and dedup followers too — they
        # were accepted work, just not executed)
        rej = c.get("requests_rejected", 0.0)
        adm = c.get("requests_admitted", 0.0)
        out["rejection_rate"] = rej / (rej + adm) if rej + adm else 0.0
        # cache funnel (request level): exact hits + coalesced
        # followers avoided an execution; misses ran the pipeline.
        # Tier-2 embedding hits are per-IMAGE escalation short-circuits
        # and are reported as their own counter, not folded in here.
        hits = c.get("cache_hit_exact", 0.0) + c.get("dedup_coalesced",
                                                     0.0)
        lookups = hits + c.get("cache_miss", 0.0)
        out["cache_hit_rate"] = hits / lookups if lookups else 0.0
        return out

    def reset_clock(self):
        """Restart the throughput window (after warmup, before load)."""
        with self._lock:
            self._t0 = time.perf_counter()

    def reset(self):
        """Drop everything (counters, gauges, distributions) and restart
        the clock — between sweep points that reuse one server so each
        offered-load measurement stands alone."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._dists.clear()
            self._t0 = time.perf_counter()
