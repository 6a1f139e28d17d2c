"""Algorithm 1 — Adaptive Streams Allocation (counterpart of
``repro.core.allocator``; QRMark §5.2).

The paper assigns CUDA streams to pipeline stages, and so does the
port: a *lane* of the executor (``core/lanes.py``) is a worker thread
with a CUDA stream of its own on the card.  The algorithm is the
reference's, unchanged:

  1. warm-up profiling of per-stage time t[k] and per-sample memory u[k];
  2. greedy hill-climb: add one lane to the stage that most reduces the
     bottleneck latency J* = max_k TIME(k, s[k], m[k]), subject to the
     memory cap and the global lane budget; stall-counter termination;
  3. mini-batch leveling for stages far faster than the bottleneck.

TIME(k, s, m) models a stage whose step time scales with its share of the
batch and inversely with lanes, plus a per-launch overhead — the same
first-order model the paper's profile-driven search uses (and the reason
a (1,1,16) allocation helps at B=256 but hurts at B=16).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class StageProfile:
    name: str
    t_per_sample: float       # seconds per sample at batch b0 (warm-up)
    u_per_sample: float       # bytes per in-flight sample
    launch_overhead: float    # per-minibatch dispatch cost (seconds)


@dataclasses.dataclass
class Allocation:
    streams: List[int]          # s[1..K] lanes per stage
    minibatch: List[int]        # m[1..K] minibatch size per stage
    bottleneck_s: float         # J*
    history: List[Tuple[List[int], float]]  # search trace


def stage_time(p: StageProfile, s: int, m: int, B: int) -> float:
    """Predicted per-global-batch time for stage p with s lanes of
    minibatch m.

    Each *wave* dispatches one minibatch to each of the s lanes: the host
    serialises the s dispatches (s * launch_overhead) while the lanes
    compute in parallel (m * t).  waves = ceil(B / (s*m)).  This is the
    first-order model behind the paper's observations: at B=256 extra
    streams shrink the wave count (1.43x), at B=16 they only add launch
    overhead (0.86x)."""
    waves = -(-B // max(s * m, 1))
    return waves * (m * p.t_per_sample + s * p.launch_overhead)


def mem_ok(profiles: Sequence[StageProfile], s: List[int], m: List[int],
           cap: float) -> bool:
    return sum(si * mi * p.u_per_sample
               for p, si, mi in zip(profiles, s, m)) <= cap


def adaptive_allocation(profiles: Sequence[StageProfile], *, global_batch: int,
                        stream_budget: int = 32, mem_cap: float = 16e9,
                        eps: float = 1e-4, stall_cap: int = 3,
                        max_iters: int = 64) -> Allocation:
    """Algorithm 1, faithful to the paper's pseudocode."""
    K = len(profiles)
    # Step 1: init one lane per stage; largest uniform minibatch in budget
    s = [1] * K
    m_uni = global_batch
    while m_uni > 1 and not mem_ok(profiles, s, [m_uni] * K, mem_cap):
        m_uni //= 2
    m = [max(m_uni, 1)] * K

    def J(s_, m_):
        return max(stage_time(p, si, mi, global_batch)
                   for p, si, mi in zip(profiles, s_, m_))

    j_star = J(s, m)
    stall = 0
    history = [(list(s), j_star)]

    def fit_m(s_):
        mu = global_batch
        while mu > 1 and not mem_ok(profiles, s_, [mu] * K, mem_cap):
            mu //= 2
        return [max(mu, 1)] * K

    # Step 2: adaptive search.  (Each candidate re-fits the largest
    # feasible uniform minibatch — the paper fits m once at init; the
    # refit keeps the memory constraint coherent as streams grow.)
    iters = 0
    while stall < stall_cap and iters < max_iters:
        iters += 1
        gain, best = 0.0, (s, m)
        for k in range(K):
            if sum(s) + 1 > stream_budget:
                continue
            s2 = list(s)
            s2[k] += 1
            m2 = fit_m(s2)
            if not mem_ok(profiles, s2, m2, mem_cap):
                continue
            j2 = J(s2, m2)
            delta = j_star - j2
            if delta > gain:
                gain, best = delta, (s2, m2)
        if gain > eps:
            s, m = best
            j_star = J(s, m)
            stall = 0
            history.append((list(s), j_star))
        else:
            stall += 1

    # Step 3: mini-batch leveling
    u_s = sum(s)
    m_unit = max(1, global_batch // max(u_s, 1))
    for k in range(K):
        tk = stage_time(profiles[k], s[k], m[k], global_batch)
        if tk < 0.5 * j_star:
            m2 = list(m)
            m2[k] = min(m_unit, 2 * m[k])
            if mem_ok(profiles, s, m2, mem_cap):
                m = m2
    return Allocation(s, m, J(s, m), history)


def assign(profiles: Sequence[StageProfile], *, global_batch: int,
           lane_budget: int = 8, mem_cap: float = 16e9
           ) -> Dict[str, int]:
    """{stage name: lane count} for the lane executor — Algorithm 1's
    stream vector keyed by stage so :class:`repro.core.lanes.Stage`
    assignments can be looked up by name."""
    alloc = adaptive_allocation(profiles, global_batch=global_batch,
                                stream_budget=lane_budget, mem_cap=mem_cap)
    return {p.name: max(1, int(s))
            for p, s in zip(profiles, alloc.streams)}


# ---------------------------------------------------------------------------
# warm-up profiling (Step 1 of the paper's algorithm)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    """Tensors and arrays of a tree of dicts, tuples and lists, in order."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def _map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return tree


def _wait(out):
    """Wait for the devices of every CUDA tensor in ``out``."""
    for dev in {t.device for t in _leaves(out)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return a.nbytes


def profile_stage(fn: Callable, sample_batch, *, iters: int = 3,
                  bytes_per_sample: Optional[float] = None,
                  name: str = "stage") -> StageProfile:
    """Measure t[k]/u[k] by running ``fn`` on a warm-up batch (a tensor,
    an array, or a tree of them in dicts, tuples and lists; the first
    leaf's first axis is the batch): the time of ``iters`` calls ended by
    a wait for every device that holds a CUDA tensor of the output."""
    leaves = _leaves(sample_batch)
    b = leaves[0].shape[0]
    fn(sample_batch)  # build/warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(sample_batch)
    _wait(out)
    dt = (time.perf_counter() - t0) / iters
    if bytes_per_sample is None:
        bytes_per_sample = sum(_nbytes(leaf) for leaf in leaves) / b
    # crude launch overhead estimate: run at batch 1
    one = _map(lambda x: x[:1], sample_batch)
    fn(one)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(one)
    _wait(out)
    dt1 = (time.perf_counter() - t0) / iters
    per_sample = max((dt - dt1) / max(b - 1, 1), 1e-9)
    overhead = max(dt1 - per_sample, 0.0)
    return StageProfile(name, per_sample, float(bytes_per_sample), overhead)
