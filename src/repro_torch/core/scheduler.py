"""Algorithm 2 — Resource-aware mini-batch scheduling (counterpart of
``repro.core.scheduler``; QRMark §6.2) with LPT placement, balance
slack, shard-to-b_min fallback, and (beyond the paper) straggler
mitigation.

Tasks are tile-decoding work items; lanes are the executors produced by
the adaptive allocator.  The scheduler is execution-agnostic: it emits a
``Schedule`` that the pipeline runner maps onto lanes (worker threads,
each with a CUDA stream of its own on the card).  Pure Python, the
reference's code unchanged.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Task:
    task_id: int
    n_samples: int
    tile: int
    lat: float              # predicted latency (warm-up model)
    mem: float              # predicted bytes
    minibatch: int = 0      # assigned by Step 4


@dataclasses.dataclass
class Schedule:
    lanes: List[List[Task]]
    m_unit: int
    loads: List[float]

    @property
    def imbalance(self) -> float:
        mx, mn = max(self.loads), min(self.loads)
        return mx / mn if mn > 0 else float("inf")


def predict_from_warmup(tile: int, stats: Dict[int, Tuple[float, float]],
                        n_samples: int, b0: int) -> Tuple[float, float]:
    """(latency, memory) for a task, interpolating warm-up stats.

    stats: {tile_size: (t_per_sample, bytes_per_sample)} measured at b0.
    Unknown tile sizes interpolate quadratically in tile area (decode cost
    scales with pixels)."""
    if tile in stats:
        t, u = stats[tile]
    else:
        base_tile, (bt, bu) = sorted(stats.items())[0]
        scale = (tile / base_tile) ** 2
        t, u = bt * scale, bu * scale
    return t * n_samples, u * n_samples


def lpt_schedule(tasks: Sequence[Task], *, n_lanes: int, balance_slack: float,
                 mem_cap: float, b_min: int, global_batch: int) -> Schedule:
    """Algorithm 2, faithful: LPT + balance check + shard fallback."""
    pool = sorted(tasks, key=lambda t: -t.lat)
    lanes: List[List[Task]] = [[] for _ in range(n_lanes)]
    loads = [0.0] * n_lanes
    mem_used = 0.0

    # max-latency-first pop; min-load lane; balance + memory constraints
    heap = [(-t.lat, i, t) for i, t in enumerate(pool)]
    heapq.heapify(heap)
    next_id = len(pool)
    while heap:
        _, _, kappa = heapq.heappop(heap)
        p_star = min(range(n_lanes), key=lambda p: loads[p])
        min_load = min(loads)
        bal_ok = loads[p_star] + kappa.lat <= (1 + balance_slack) * \
            max(min_load, kappa.lat)
        fit_ok = mem_used + kappa.mem <= mem_cap
        if (bal_ok and fit_ok) or kappa.n_samples <= b_min:
            lanes[p_star].append(kappa)
            loads[p_star] += kappa.lat
            mem_used += kappa.mem
        else:
            # shard kappa at granularity b_min
            n1 = max(b_min, kappa.n_samples // 2)
            n2 = kappa.n_samples - n1
            frac = n1 / kappa.n_samples
            k1 = dataclasses.replace(kappa, n_samples=n1,
                                     lat=kappa.lat * frac,
                                     mem=kappa.mem * frac)
            lanes[p_star].append(k1)
            loads[p_star] += k1.lat
            mem_used += k1.mem
            if n2 > 0:
                k2 = dataclasses.replace(
                    kappa, task_id=next_id, n_samples=n2,
                    lat=kappa.lat * (1 - frac), mem=kappa.mem * (1 - frac))
                next_id += 1
                heapq.heappush(heap, (-k2.lat, next_id, k2))

    # Step 4: uniform mini-batch size
    u = sum(len(l) for l in lanes)
    m_unit = max(b_min, global_batch // max(u, 1))
    for lane in lanes:
        for t in lane:
            t.minibatch = m_unit
    return Schedule(lanes, m_unit, loads)


def build_tasks(images_meta: Sequence[dict],
                warmup_stats: Dict[int, Tuple[float, float]], *,
                b0: int, select_tile: Callable[[dict], int],
                group: int = 1) -> List[Task]:
    """Step 1 of Algorithm 2: candidate task pool from an image set."""
    tasks = []
    for i in range(0, len(images_meta), group):
        metas = images_meta[i: i + group]
        tile = select_tile(metas[0])
        lat, mem = predict_from_warmup(tile, warmup_stats, len(metas), b0)
        tasks.append(Task(task_id=len(tasks), n_samples=len(metas),
                          tile=tile, lat=lat, mem=mem))
    return tasks


# ---------------------------------------------------------------------------
# straggler mitigation (beyond paper — required at 1000-node scale)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerPolicy:
    timeout_factor: float = 3.0   # x median task latency
    min_timeout_s: float = 0.05
    max_retries: int = 2


class StragglerMonitor:
    """Tracks per-task start times; re-issues work that exceeds the
    timeout to the least-loaded healthy lane (speculative re-execution —
    first completion wins, duplicates are dropped by task_id)."""

    def __init__(self, policy: StragglerPolicy = StragglerPolicy()):
        self.policy = policy
        self._started: Dict[int, float] = {}
        self._done: set = set()
        self._retries: Dict[int, int] = {}
        self._latencies: List[float] = []

    def start(self, task_id: int):
        self._started[task_id] = time.perf_counter()

    def complete(self, task_id: int) -> bool:
        """Returns False if this was a duplicate completion."""
        if task_id in self._done:
            return False
        self._done.add(task_id)
        t0 = self._started.pop(task_id, None)
        if t0 is not None:
            self._latencies.append(time.perf_counter() - t0)
        return True

    def timeout_s(self) -> float:
        if not self._latencies:
            return self.policy.min_timeout_s
        med = sorted(self._latencies)[len(self._latencies) // 2]
        return max(self.policy.min_timeout_s,
                   self.policy.timeout_factor * med)

    def stragglers(self) -> List[int]:
        now = time.perf_counter()
        lim = self.timeout_s()
        out = []
        for tid, t0 in self._started.items():
            if now - t0 > lim and \
                    self._retries.get(tid, 0) < self.policy.max_retries:
                out.append(tid)
        return out

    def mark_retried(self, task_id: int):
        self._retries[task_id] = self._retries.get(task_id, 0) + 1
        self._started[task_id] = time.perf_counter()

    @property
    def retry_count(self) -> int:
        """Total speculative re-executions recorded via
        :meth:`mark_retried` — the number a service report should
        surface as ``straggler_retries``."""
        return sum(self._retries.values())
