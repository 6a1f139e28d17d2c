"""Serving launcher (counterpart of ``repro.launch.serve``), in two
regimes: the offline batch stream (:class:`DetectionService`) and, with
``--online``, the request-level server
(``repro_torch.serving.DetectionServer``) under open-loop Poisson load
(:func:`run_online`).

:class:`DetectionService` is the reference's offline service: its
``warmup`` profiles the pipeline's three stage functions on its device
through the engine that will really run (Algorithm 1:
``allocator.adaptive_allocation`` and ``assign``), and ``serve`` splits
every batch into LPT-placed tasks (Algorithm 2,
``scheduler.lpt_schedule``, ``group = b // 4``), pads each task to a
shape bucket (``serving.batcher.pad_to_bucket``) and streams the tasks
through ``DetectionPipeline.run_stream`` — the three-stage lane
executor, each lane a CUDA stream of its own on the card — with a
``StragglerMonitor``; ``serve_sharded`` splits each batch over the
visible devices instead (``DetectionPipeline.run_batch``).

The geometry follows the reference launcher: tile ``--tile``, image
``--img``, ``resize_src = img + img // 8``, raw images of ``img + 32``
square.  The extractor is the launcher's full width (channels 64, depth
7, 60 bits) with the tile's correlation bank, randomly initialised from
a fixed ``torch.Generator`` seed.

The flags carry the reference's meanings: ``--lanes`` (0: the lanes
Algorithm 1 assigns after the warm-up; n: n decode and n RS lanes),
``--ragged`` (odd-size batches, padded by ``pad_to_bucket``),
``--sharded`` (``serve_sharded``), ``--mode`` (``sequential`` |
``tiled`` | ``qrmark``), ``--rs-mode`` (``device`` | ``cpu_pool`` |
``cpu_sync``), ``--staged-ingest`` (full-image ingest, then tile
selection), ``--unfused-decode`` (the plain extractor graph),
``--decode-dtype`` (``fp32`` | ``bf16`` | ``int8``: the fused decode's
rung), ``--schedule`` (``flat`` | ``auto`` | ``bb<N>-ct<N>[-db]``),
``--autotune`` (sweep the blocked schedules at that dtype into the cache
at ``--autotune-cache`` before building the pipeline, then serve with
``auto``, which reads that dtype's entry), ``--escalate-tiles`` (the
tile budget of an image: k > 1 decodes images whose RS failed again on
up to k - 1 more tiles, summing their soft bits) and
``--escalate-margin`` (also escalate images whose mean |logit| is below
it).

``--online`` serves per-request submissions arriving through
:func:`open_loop_load` (``--qps`` for ``--duration`` seconds, ``--group``
images a request) through the micro-batcher (``--max-batch``,
``--max-wait-ms``, ``--max-queue``; SLO classes ``--classes
name:deadline_ms,...`` with ``--bulk-frac`` of the requests in the
lowest), with live lane reallocation every ``--realloc-every``
micro-batches, the exact result cache and dedup-in-flight
(``--cache-exact``), the near-duplicate embedding tier
(``--cache-embed-threshold``) and a repeat-heavy workload drawn from
``--pool`` images (Zipf-skewed by ``--zipf``), and prints its report
JSON: throughput, latency percentiles, batch occupancy, rejections,
straggler retries, cache and escalation counters.

``--fleet`` fronts ``--replicas`` ``DetectionServer`` replicas with the
``FleetRouter`` (rendezvous content routing, spill-over, crash
re-execution) and drives the same Poisson load through the router
(:func:`run_fleet`); replica i runs on ``cuda:(i % device_count)``, so
on one card every replica shares it, each with its own lane streams.

``--compilation-cache DIR`` is the counterpart of the reference's
persistent jit cache: the port's only compiled artifact is the CUDA
kernel library, so the flag builds it into (and reuses it from) DIR
instead of ``build/repro_torch_kernels/`` (``_build.use_build_dir``),
and puts the autotune cache at ``DIR/decode_schedules.json`` unless
``--autotune-cache`` names another, as the reference does.  A restart
with the same DIR and sources loads the library without running
``nvcc``.

Runs on the card by default; ``--device cpu`` runs the plain versions.
Offline, prints the ``allocation:`` line of Algorithm 1, then the
``ServiceReport`` JSON (with the device it ran on).

    python -m repro_torch.launch.serve --batches 3 --batch 32 \
        --img 256 --tile 64 [--lanes N] [--ragged] [--sharded] [--mode M] \
        [--rs-mode R] [--staged-ingest] [--unfused-decode] \
        [--decode-dtype fp32|bf16|int8] [--schedule S] [--autotune] \
        [--autotune-cache PATH] [--escalate-tiles K] [--escalate-margin X] \
        [--device cuda|cpu]
    python -m repro_torch.launch.serve --online --qps 50 --duration 5 \
        [--group N] [--max-batch N] [--max-wait-ms X] [--max-queue N] \
        [--realloc-every N] [--cache-exact] [--cache-embed-threshold X] \
        [--classes interactive:5,bulk:50 --bulk-frac 0.3] \
        [--pool N [--zipf X]] [offline flags...]
    python -m repro_torch.launch.serve --fleet --replicas 2 --qps 50 \
        [--compilation-cache DIR] [online and offline flags...]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import allocator, prng, scheduler as sched_lib
from repro_torch.core.detect import (DetectionConfig, DetectionPipeline,
                                     resolve_device)
from repro_torch.core.extractor import (init_extractor, pack_params,
                                        params_from_numpy)
from repro_torch.core.rs.codec import DEFAULT_CODE
from repro_torch.core.stages import host_numpy
from repro_torch.data.pipeline import synth_image
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as autotune_lib
from repro_torch.launch.mesh import make_detection_mesh
from repro_torch.serving.batcher import AdmissionError, pad_to_bucket

DEFAULT_AUTOTUNE_CACHE = "experiments/autotune/decode_schedules.json"


@dataclasses.dataclass
class ServiceReport:
    images: int
    wall_s: float
    throughput_ips: float
    allocation: Optional[List[int]]
    lanes: Optional[Dict[str, int]]
    lane_loads: Optional[List[float]]
    straggler_retries: int = 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Batch detection service (offline), request-level "
                    "detection server (--online) and a fleet of servers "
                    "behind the router (--fleet) on the PyTorch port",
        allow_abbrev=False)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--mode", default="qrmark",
                    choices=("sequential", "tiled", "qrmark"))
    ap.add_argument("--rs-mode", default="device",
                    choices=("device", "cpu_pool", "cpu_sync"))
    ap.add_argument("--lanes", type=int, default=0,
                    help="0 = adaptive (Algorithm 1); n = fixed n "
                         "decode/RS lanes")
    ap.add_argument("--ragged", action="store_true",
                    help="send odd-size batches to exercise padding")
    ap.add_argument("--sharded", action="store_true",
                    help="data-parallel run_batch over all local devices")
    ap.add_argument("--staged-ingest", action="store_true",
                    help="disable tile-first ingest (full-image "
                         "preprocess + tile select in decode)")
    ap.add_argument("--unfused-decode", action="store_true",
                    help="disable the fused extractor kernel (decode "
                         "runs the plain extractor graph)")
    ap.add_argument("--decode-dtype", default="fp32",
                    choices=("fp32", "bf16", "int8"),
                    help="fused-decode precision: fp32; bf16 (bf16 "
                         "operands, fp32 sums); int8 (per-channel weight "
                         "scales, per-pixel activation quantization, exact "
                         "integer tap dots; RS absorbs the extra bit noise)")
    ap.add_argument("--schedule", default="flat",
                    help="decode kernel schedule: 'flat', 'auto' (winner "
                         "from the autotune cache), or an explicit "
                         "'bb<N>-ct<N>[-db]' point")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep blocked decode schedules for this config "
                         "before building the pipeline, persist the "
                         "winner in the autotune cache, and serve with it "
                         "(implies --schedule auto)")
    ap.add_argument("--autotune-cache", default=None,
                    help="schedule-cache JSON path (default: "
                         "DIR/decode_schedules.json with "
                         "--compilation-cache DIR, else "
                         f"{DEFAULT_AUTOTUNE_CACHE})")
    ap.add_argument("--compilation-cache", default="",
                    help="directory the CUDA kernel library is built "
                         "into and reused from across restarts (the "
                         "port's compile cache), and the default home "
                         "of the autotune cache")
    ap.add_argument("--escalate-tiles", type=int, default=1,
                    help="adaptive escalation tile budget per image "
                         "(1 = single-tile fast path only; k > 1 "
                         "re-decodes RS failures on up to k-1 extra "
                         "tiles, accumulating soft bits)")
    ap.add_argument("--escalate-margin", type=float, default=0.0,
                    help="also escalate images whose mean |logit| is "
                         "below this margin even when RS succeeded "
                         "(0 = RS-failure trigger only; requires "
                         "--escalate-tiles > 1)")
    ap.add_argument("--fleet", action="store_true",
                    help="front --replicas DetectionServer replicas "
                         "with the FleetRouter (rendezvous content "
                         "routing, spill-over, crash re-execution) and "
                         "drive Poisson load through the router")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet size for --fleet (replica i runs on "
                         "cuda:(i %% device_count); with --device cpu "
                         "every replica on the CPU)")
    ap.add_argument("--online", action="store_true",
                    help="request-level serving: DetectionServer + "
                         "open-loop Poisson load instead of the "
                         "offline batch-stream service")
    ap.add_argument("--qps", type=float, default=8.0,
                    help="offered load for --online (requests/s)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="load-generation window for --online (s)")
    ap.add_argument("--group", type=int, default=1,
                    help="images per request for --online")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="micro-batcher coalescing cap (--online)")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="micro-batcher deadline for partial batches")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission-control depth bound (images)")
    ap.add_argument("--realloc-every", type=int, default=0,
                    help="re-run Algorithm 1 on measured stage "
                         "latencies every N micro-batches (0 = off)")
    ap.add_argument("--cache-exact", action="store_true",
                    help="tier-1 content-addressed result cache + "
                         "dedup-in-flight (--online); keyless requests "
                         "switch to content-derived fold_in keys so "
                         "hits are bitwise the cold-path result")
    ap.add_argument("--cache-embed-threshold", type=float, default=0.0,
                    help="tier-2 near-duplicate cache cosine threshold "
                         "over the extractor GAP embedding (0 = off; "
                         "approximate — only short-circuits "
                         "escalation rounds)")
    ap.add_argument("--classes", default="",
                    help="SLO admission classes for --online as "
                         "'name:deadline_ms,...', first = highest "
                         "priority (e.g. 'interactive:5,bulk:50'); "
                         "empty = single class at --max-wait-ms")
    ap.add_argument("--bulk-frac", type=float, default=0.0,
                    help="fraction of --online requests submitted as "
                         "the lowest class (requires --classes)")
    ap.add_argument("--zipf", type=float, default=0.0,
                    help="Zipf exponent (> 1) skewing --pool draws — "
                         "the repeat-heavy workload the content cache "
                         "targets (0 = uniform)")
    ap.add_argument("--pool", type=int, default=0,
                    help="draw --online request images from a fixed "
                         "pool of this many distinct synthetic images "
                         "(0 = every request distinct)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    if args.autotune_cache is None:
        args.autotune_cache = (
            str(Path(args.compilation_cache) / "decode_schedules.json")
            if args.compilation_cache else DEFAULT_AUTOTUNE_CACHE)
    return args


def parse_classes(spec: str) -> Optional[Dict[str, float]]:
    """``--classes`` ('name:deadline_ms,...') -> {name: deadline_ms} in
    priority order, or None when empty."""
    if not spec:
        return None
    classes: Dict[str, float] = {}
    for part in spec.split(","):
        name, _, ms = part.partition(":")
        classes[name.strip()] = float(ms)
    return classes


def make_batches(args) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The reference launcher's warm-up sample and batch stream."""
    raw = args.img + 32
    sample = np.stack([synth_image(i, raw) for i in range(args.batch)])
    rng = np.random.default_rng(0)
    sizes = [args.batch if not args.ragged else
             int(rng.integers(1, args.batch + 1))
             for _ in range(args.batches)]
    batches = [np.stack([synth_image(1000 + k * args.batch + i, raw)
                         for i in range(n)])
               for k, n in enumerate(sizes)]
    return sample, batches


def build_config(args) -> Tuple[DetectionConfig, dict]:
    """The launcher's full-width extractor (random weights from a fixed
    seed) and the configuration the flags name; ``--autotune`` first
    sweeps the schedules into the cache on the pipeline's device."""
    params = init_extractor(torch.Generator().manual_seed(0),
                            n_bits=DEFAULT_CODE.codeword_bits,
                            tile=args.tile)
    schedule = args.schedule
    if args.autotune:
        packed = pack_params(params_from_numpy(
            params, resolve_device(args.device)), args.decode_dtype)
        autotune_lib.autotune(packed, tile=args.tile, batch=args.batch,
                              dtype=args.decode_dtype,
                              cache_path=args.autotune_cache)
        schedule = "auto"
    cfg = DetectionConfig(tile=args.tile, img_size=args.img,
                          resize_src=args.img + args.img // 8,
                          mode=args.mode, rs_mode=args.rs_mode,
                          tile_first=not args.staged_ingest,
                          fused_decode=not args.unfused_decode,
                          decode_dtype=args.decode_dtype,
                          decode_schedule=schedule,
                          autotune_cache=args.autotune_cache,
                          escalate_tiles=args.escalate_tiles,
                          escalate_margin=args.escalate_margin,
                          cache_exact=args.cache_exact,
                          cache_embedding_threshold=(
                              args.cache_embed_threshold))
    return cfg, params


def build_pipeline(args) -> DetectionPipeline:
    """The pipeline of :func:`build_config`'s configuration."""
    cfg, params = build_config(args)
    return DetectionPipeline(cfg, params, device=args.device)


def warm_up(pipe: DetectionPipeline, sample: np.ndarray):
    """One detection on ``sample`` with an explicit key (the batch
    counter does not move), so the kernels are built and loaded before
    the stream is timed."""
    pipe.detect_batch(sample, key=prng.key(0))


def serve(pipe: DetectionPipeline, batches: List[np.ndarray]
          ) -> Tuple[ServiceReport, List[Dict[str, np.ndarray]]]:
    """Detect every batch in order; returns the report and results."""
    t0 = time.perf_counter()
    results = [pipe.detect_batch(raw) for raw in batches]
    wall = time.perf_counter() - t0  # detect_batch ends in host numpy
    n_img = sum(r["logits"].shape[0] for r in results)
    rep = ServiceReport(images=n_img, wall_s=wall,
                        throughput_ips=n_img / wall if wall else 0.0,
                        allocation=None, lanes=None, lane_loads=None)
    return rep, results


class DetectionService:
    """Adaptive, scheduled batch-stream detection service (the offline
    regime): Algorithm 1 after a warm-up, Algorithm 2 and the lane
    executor while serving.  After :meth:`warmup`, ``profiles`` holds the
    three stage profiles; after a serve, ``results`` the results of its
    work items in order, sliced to their true rows."""

    def __init__(self, det_cfg: DetectionConfig, extractor_params, *,
                 lane_budget: int = 8, mem_cap: float = 2e9,
                 lanes: int = 0, pad_bucket: int = 0, device=None):
        self.pipe = DetectionPipeline(det_cfg, extractor_params,
                                      device=device)
        self.det_cfg = det_cfg
        self.lane_budget = lane_budget
        self.mem_cap = mem_cap
        self.pad_bucket = pad_bucket
        self.allocation: Optional[allocator.Allocation] = None
        # lanes knob: 0 = adaptive (allocator.assign after warmup),
        # n >= 1 = fixed n decode/RS lanes, bypassing the allocator
        self.lanes: Optional[Dict[str, int]] = (
            None if lanes == 0 else
            {"ingest": 1, "decode": max(1, lanes), "rs": max(1, lanes)})
        self._fixed_lanes = lanes != 0
        self.warmup_stats: Dict[int, tuple] = {}
        self.profiles: List[allocator.StageProfile] = []
        self.results: List[Dict[str, np.ndarray]] = []

    # -- Algorithm 1: warm-up profiling + adaptive allocation -------------
    def warmup(self, sample_raw) -> allocator.Allocation:
        """Profile the pipeline's own stage functions on its device, each
        through the engine that will really run (ingest with the upload
        of the raw batch; decode at the configured rung and schedule; RS
        through ``_rs_correct``: the device kernel, or the host engine on
        host bits), then run Algorithm 1."""
        cfg = self.det_cfg
        pipe = self.pipe
        key = prng.key(0)
        pre = allocator.profile_stage(
            lambda b: pipe._ingest(b, key), sample_raw, name="ingest")
        x, keys = pipe._ingest(sample_raw, key)
        dec = allocator.profile_stage(
            lambda b: pipe._decode_x(b, keys[: b.shape[0]]), x,
            name="decode")
        bits = pipe._bits(pipe._decode_x(x, keys))
        rs_sample = bits if cfg.rs_mode == "device" else host_numpy(bits)
        rs_prof = allocator.profile_stage(pipe._rs_correct, rs_sample,
                                          name="rs")
        profiles = [pre, dec, rs_prof]
        self.profiles = profiles
        self.allocation = allocator.adaptive_allocation(
            profiles, global_batch=sample_raw.shape[0],
            stream_budget=self.lane_budget, mem_cap=self.mem_cap)
        if not self._fixed_lanes:
            self.lanes = allocator.assign(
                profiles, global_batch=sample_raw.shape[0],
                lane_budget=self.lane_budget, mem_cap=self.mem_cap)
        self.warmup_stats[cfg.tile] = (dec.t_per_sample, dec.u_per_sample)
        return self.allocation

    # -- Algorithm 2 + lane-executor streaming -----------------------------
    def plan(self, batches: Iterable, *, use_scheduler: bool = True
             ) -> Tuple[List[Tuple[np.ndarray, int]], Optional[List[float]]]:
        """The work stream :meth:`serve` runs: (padded slice, true size)
        items in order — each batch's LPT-placed tasks, lane by lane,
        with the scheduler on and warm-up stats known, else the batch
        whole — and the LPT lanes' predicted loads summed over the
        batches (None without the scheduler)."""
        lane_loads: Optional[List[float]] = None
        work: List[Tuple[np.ndarray, int]] = []
        for raw in batches:
            raw = np.asarray(raw)
            b = raw.shape[0]
            if use_scheduler and self.warmup_stats:
                tasks = sched_lib.build_tasks(
                    [{"i": i} for i in range(b)], self.warmup_stats,
                    b0=b, select_tile=lambda m: self.det_cfg.tile,
                    group=max(1, b // 4))
                n_lanes = (sum(self.lanes.values()) if self.lanes else 4)
                sched = sched_lib.lpt_schedule(
                    tasks, n_lanes=max(n_lanes, 1), balance_slack=0.25,
                    mem_cap=self.mem_cap, b_min=1, global_batch=b)
                if lane_loads is None:
                    lane_loads = [0.0] * len(sched.loads)
                lane_loads = [a + l for a, l in zip(lane_loads,
                                                    sched.loads)]
                off = 0
                for lane in sched.lanes:
                    for task in lane:
                        sl = raw[off: off + task.n_samples]
                        off += task.n_samples
                        if sl.shape[0]:
                            work.append(pad_to_bucket(sl, self.pad_bucket))
            else:
                work.append(pad_to_bucket(raw, self.pad_bucket))
        return work, lane_loads

    def serve(self, batches: Iterable, *,
              use_scheduler: bool = True) -> ServiceReport:
        """Run a stream of (possibly ragged) batches through the lane
        executor.  With the scheduler on, each batch is split into
        LPT-placed mini-batch tasks first (Algorithm 2, :meth:`plan`);
        the task slices then flow through the executor as the work
        stream, each under the next key of the pipeline's batch counter,
        and each result is sliced to its true rows."""
        mon = sched_lib.StragglerMonitor()
        work, lane_loads = self.plan(batches, use_scheduler=use_scheduler)

        def feed():
            for tid, (sl, tb) in enumerate(work):
                mon.start(tid)
                yield (sl, tb)

        n_img_box = [0]

        def consume(tid: int, res: dict):
            # completion is recorded as each result leaves the executor
            true_b = work[tid][1]
            for k, v in res.items():
                if getattr(v, "ndim", 0) >= 1:
                    res[k] = v[:true_b]   # slice pad rows off
            n_img_box[0] += true_b
            mon.complete(tid)

        t0 = time.perf_counter()
        out = self.pipe.run_stream(feed(), lanes=self.lanes,
                                   on_result=consume)
        wall = time.perf_counter() - t0
        self.results = out["results"]
        n_img = n_img_box[0]
        return ServiceReport(
            images=n_img, wall_s=wall,
            throughput_ips=n_img / wall if wall else 0.0,
            allocation=(self.allocation.streams if self.allocation
                        else None),
            lanes=out.get("lanes"),
            lane_loads=([round(l, 6) for l in lane_loads]
                        if lane_loads else None),
            straggler_retries=mon.retry_count)

    # -- data-parallel sharded path ----------------------------------------
    def serve_sharded(self, batches: Iterable) -> ServiceReport:
        """Split each batch over every visible device (the pipeline's
        own where it runs on the CPU) instead of pipelining."""
        dev = self.pipe.device
        mesh = make_detection_mesh(None if dev.type == "cuda" else [dev])
        n_img = 0
        t0 = time.perf_counter()
        results = []
        for raw in batches:
            out = self.pipe.run_batch(np.asarray(raw), mesh=mesh)
            results.append(out)
            n_img += out["ok"].shape[0]
        wall = time.perf_counter() - t0
        self.results = results
        return ServiceReport(
            images=n_img, wall_s=wall,
            throughput_ips=n_img / wall if wall else 0.0,
            allocation=None, lanes=None, lane_loads=None)

    def close(self):
        self.pipe.close()


def open_loop_load(server, *, qps: float, duration_s: float,
                   make_images: Callable[[int], np.ndarray],
                   seed: int = 0,
                   priority: Optional[Callable[[int],
                                               Optional[str]]] = None
                   ) -> dict:
    """Open-loop Poisson load generator (the online serving regime).

    Request k arrives at exponential inter-arrival gaps of mean
    ``1/qps`` **regardless of completions** — unlike closed-loop
    drivers, queueing delay is exposed instead of self-throttled, so
    latency percentiles vs offered load mean something.  Rejected
    submissions (admission backpressure) are counted, not retried —
    and counted *separately* from execution failures, which surface
    later through the handles.  ``priority`` maps request index ->
    admission class (None = the server's highest class).

    Returns {handles, offered, rejected, wall_s}; call
    ``server.stats()`` after draining for the latency/throughput view.
    """
    rng = np.random.default_rng(seed)
    handles = []
    rejected = 0
    t0 = time.perf_counter()
    t_next = t0
    k = 0
    while t_next - t0 < duration_s:
        now = time.perf_counter()
        if now < t_next:
            time.sleep(t_next - now)
        try:
            handles.append(server.submit(
                make_images(k),
                priority=priority(k) if priority else None))
        except AdmissionError:
            rejected += 1
        k += 1
        t_next += rng.exponential(1.0 / qps)
    return {"handles": handles, "offered": k, "rejected": rejected,
            "wall_s": time.perf_counter() - t0}


def _lat_ms(dist: dict) -> dict:
    return {k: round(dist.get(k, float("nan")) * 1e3, 2)
            for k in ("p50", "p95", "p99", "mean")}


def run_online(cfg: DetectionConfig, params, *, qps: float,
               duration_s: float, raw_size: int, group: int = 1,
               max_batch: int = 16, max_wait_ms: float = 10.0,
               max_queue: int = 256, lanes: int = 0,
               realloc_every: int = 0, seed: int = 0,
               classes: Optional[Dict[str, float]] = None,
               bulk_frac: float = 0.0, zipf: float = 0.0,
               pool: int = 0, quiet: bool = False, device=None) -> dict:
    """Build a :class:`~repro_torch.serving.DetectionServer` on
    ``device``, warm it up, drive it with Poisson arrivals, drain, and
    report.

    ``classes`` enables SLO-tiered admission ({name: deadline_ms},
    first = highest priority); ``bulk_frac`` of requests are then sent
    as the *lowest* class.  ``pool`` > 0 draws each request's images
    from a fixed pool of ``pool`` synthetic images — uniformly, or
    Zipf-skewed with exponent ``zipf`` > 1 — the repeat-heavy
    workload the content cache is for."""
    from repro_torch.serving import BatcherConfig, DetectionServer
    lane_map = (None if lanes == 0 else
                {"ingest": 1, "decode": max(1, lanes),
                 "rs": max(1, lanes)})
    srv = DetectionServer(
        cfg, params,
        batcher=BatcherConfig(max_batch=max_batch,
                              max_wait_ms=max_wait_ms,
                              max_queue=max_queue, classes=classes),
        lanes=lane_map, realloc_every=realloc_every, device=device)
    try:
        buckets = srv.warmup(synth_image(0, raw_size))
        if not quiet:
            print(f"online: warmed buckets {buckets}, lanes "
                  f"{srv.lane_counts()}", flush=True)
        srv.start()
        srv.metrics.reset()

        wl_rng = np.random.default_rng(seed + 1)  # workload draws, not
        #                                           arrival gaps

        def pool_index(k: int) -> int:
            if pool <= 0:
                return k
            if zipf > 1.0:
                return int((wl_rng.zipf(zipf) - 1) % pool)
            return int(wl_rng.integers(pool))

        def make_images(k: int) -> np.ndarray:
            base = pool_index(k)
            return np.stack([synth_image(1000 + base * group + i, raw_size)
                             for i in range(group)])

        priority = None
        if classes and bulk_frac > 0.0:
            names = list(classes)

            def priority(k: int) -> str:
                return (names[-1] if wl_rng.random() < bulk_frac
                        else names[0])

        load = open_loop_load(srv, qps=qps, duration_s=duration_s,
                              make_images=make_images, seed=seed,
                              priority=priority)
        srv.drain(timeout=120.0)
        stats = srv.stats()
    finally:
        srv.close()
    failed = int(stats["counters"].get("requests_failed", 0))
    report = {
        "qps_offered": qps, "duration_s": duration_s, "group": group,
        "offered": load["offered"],
        # rejected (admission backpressure) and failed (execution
        # errors) are different outcomes — never folded together
        "rejected": load["rejected"],
        "rejection_rate": round(stats["rejection_rate"], 4),
        "failed": failed,
        "completed": int(stats["counters"].get("requests_completed", 0)),
        "unresolved": sum(not h.done() for h in load["handles"]),
        "throughput_rps": round(stats["throughput_rps"], 2),
        "throughput_ips": round(stats["throughput_ips"], 2),
        "latency_ms": _lat_ms(stats.get("request_latency_s", {})),
        "batch_occupancy": round(
            stats.get("batch_occupancy", {}).get("mean", float("nan")),
            3),
        "queue_depth_last": stats["gauges"].get("queue_depth", 0),
        "lanes": stats["lanes"],
        "straggler_retries": stats["straggler_retries"],
        "device": str(srv.pipe.device),
    }
    if classes:
        report["latency_ms_by_class"] = {
            c: _lat_ms(stats.get(f"request_latency_{c}_s", {}))
            for c in classes}
    if cfg.cache_exact or cfg.cache_embedding_threshold > 0:
        report["cache"] = {
            "hit_exact": stats["cache_hit_exact"],
            "hit_embed": stats["cache_hit_embed"],
            "miss": stats["cache_miss"],
            "dedup_coalesced": stats["dedup_coalesced"],
            "hit_rate": round(stats["cache_hit_rate"], 4),
        }
    if srv.registry.policy.enabled:
        report["escalation_rate"] = round(stats["escalation_rate"], 4)
        report["escalation_batches"] = stats["escalation_batches"]
        report["mean_tiles_per_image"] = round(
            stats.get("tiles_per_image", {}).get("mean", 1.0), 3)
    return report


def fleet_devices(replicas: int, device=None) -> List[torch.device]:
    """Replica i's device: ``cuda:(i % device_count)`` (``device`` None
    or a CUDA device; raising without a card), else ``device`` for every
    replica (the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * replicas
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(replicas)]


def run_fleet(cfg: DetectionConfig, params, *, replicas: int,
              qps: float, duration_s: float, raw_size: int,
              group: int = 1, max_batch: int = 16,
              max_wait_ms: float = 10.0, max_queue: int = 256,
              lanes: int = 0, seed: int = 0,
              fault_plans: Optional[dict] = None,
              quiet: bool = False, device=None) -> dict:
    """Build a :class:`~repro_torch.serving.FleetRouter` over ``replicas``
    :class:`~repro_torch.serving.Replica` instances (replica i on
    :func:`fleet_devices`' device i), warm them, drive the fleet with
    Poisson arrivals THROUGH the router, drain, and report.  Requests
    route by content digest, so results are bit-identical to a single
    server at any fleet size.  ``fault_plans`` maps a replica name
    (``r0``..) to a :class:`~repro_torch.serving.FaultPlan`."""
    from repro_torch.serving import BatcherConfig, FleetRouter, Replica
    devices = fleet_devices(replicas, device)
    lane_map = (None if lanes == 0 else
                {"ingest": 1, "decode": max(1, lanes),
                 "rs": max(1, lanes)})
    reps = [Replica(
        f"r{i}", cfg, params,
        batcher=BatcherConfig(max_batch=max_batch,
                              max_wait_ms=max_wait_ms,
                              max_queue=max_queue),
        lanes=lane_map,
        fault_plan=(fault_plans or {}).get(f"r{i}"),
        device=devices[i])
        for i in range(replicas)]
    router = FleetRouter(reps)
    try:
        router.warmup(synth_image(0, raw_size))
        router.start()
        if not quiet:
            print(f"fleet: {replicas} replicas over "
                  f"{len(set(map(str, devices)))} device(s), warmed",
                  flush=True)
        router.metrics.reset()

        def make_images(k: int) -> np.ndarray:
            return np.stack([synth_image(1000 + k * group + i, raw_size)
                             for i in range(group)])

        load = open_loop_load(router, qps=qps, duration_s=duration_s,
                              make_images=make_images, seed=seed)
        drained = router.drain(timeout=120.0)
        stats = router.stats()
        unresolved = sum(not h.done() for h in load["handles"])
    finally:
        router.close()
    return {
        "replicas": replicas, "qps_offered": qps,
        "duration_s": duration_s, "group": group,
        "offered": load["offered"], "rejected": load["rejected"],
        "completed": int(stats["counters"].get("requests_completed", 0)),
        "failed": int(stats["counters"].get("requests_failed", 0)),
        "unresolved": int(unresolved), "drained": bool(drained),
        "throughput_rps": round(stats["throughput_rps"], 2),
        "latency_ms": _lat_ms(stats.get("request_latency_s", {})),
        "spillovers": stats["spillovers"],
        "reroutes": stats["reroutes"],
        "unhealthy": stats["unhealthy"],
        "straggler_retries": stats["straggler_retries"],
        "faults_injected": int(
            stats["fleet_counters"].get("faults_injected", 0)),
        "replica_table": stats["replicas"],
        "devices": [str(d) for d in devices],
    }


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    if args.compilation_cache:
        print(f"compilation cache: kernels in "
              f"{_build.use_build_dir(args.compilation_cache)}, autotune "
              f"cache {args.autotune_cache}", flush=True)
    cfg, params = build_config(args)
    if args.fleet:
        if args.replicas < 1:
            raise SystemExit("--replicas must be >= 1")
        rep = run_fleet(cfg, params, replicas=args.replicas, qps=args.qps,
                        duration_s=args.duration, raw_size=args.img + 32,
                        group=args.group, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        max_queue=args.max_queue, lanes=args.lanes,
                        device=args.device)
        print(json.dumps(rep, indent=1, default=str))
        return
    if args.online:
        rep = run_online(cfg, params, qps=args.qps,
                         duration_s=args.duration,
                         raw_size=args.img + 32, group=args.group,
                         max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         max_queue=args.max_queue, lanes=args.lanes,
                         realloc_every=args.realloc_every,
                         classes=parse_classes(args.classes),
                         bulk_frac=args.bulk_frac, zipf=args.zipf,
                         pool=args.pool, device=args.device)
        print(json.dumps(rep, indent=1))
        return
    svc = DetectionService(cfg, params, lanes=args.lanes,
                           device=args.device)
    try:
        sample, batches = make_batches(args)
        alloc = svc.warmup(sample)
        print(f"allocation: streams={alloc.streams} "
              f"J*={alloc.bottleneck_s:.4f} lanes={svc.lanes}")
        rep = (svc.serve_sharded(batches) if args.sharded
               else svc.serve(batches))
    finally:
        svc.close()
    print(json.dumps({**dataclasses.asdict(rep),
                      "device": str(svc.pipe.device)}, indent=1))


if __name__ == "__main__":
    main()
