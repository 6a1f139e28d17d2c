"""Serving launcher, offline batch regime (counterpart of the offline
``DetectionService`` regime of ``repro.launch.serve``).

A stream of synthetic raw batches goes through
``DetectionPipeline.detect_batch`` one batch at a time, with the keys
the reference's ``run_stream`` gives batch k: ``fold_in(key(seed), k)``.
The geometry follows the reference launcher: tile ``--tile``, image
``--img``, ``resize_src = img + img // 8``, raw images of
``img + 32`` square.  The extractor is the launcher's full width
(channels 64, depth 7, 60 bits) with the tile's correlation bank,
randomly initialised from a fixed ``torch.Generator`` seed.

The configuration flags carry the reference's meanings: ``--mode``
(``sequential`` | ``tiled`` | ``qrmark``), ``--rs-mode`` (``device`` |
``cpu_pool`` | ``cpu_sync``), ``--staged-ingest`` (full-image ingest,
then tile selection), ``--unfused-decode`` (the plain extractor graph),
``--decode-dtype`` (``fp32`` | ``bf16`` | ``int8``: the fused decode's
rung), ``--schedule`` (``flat`` | ``auto`` | ``bb<N>-ct<N>[-db]``), and
``--autotune`` (sweep the blocked schedules at that dtype into the cache
at ``--autotune-cache`` before building the pipeline, then serve with
``auto``, which reads that dtype's entry), ``--escalate-tiles`` (the
tile budget of an image: k > 1 decodes images whose RS failed again on
up to k - 1 more tiles, summing their soft bits) and
``--escalate-margin`` (also escalate images whose mean |logit| is below
it).

Runs on the card by default; ``--device cpu`` runs the plain versions.
Flags of the reference launcher that need the lane executor,
allocator, scheduler, online server, fleet, sharding or the serving
cache are rejected by argparse as unrecognized, never ignored.  Prints
a ``ServiceReport``-shaped JSON object (``allocation`` and ``lanes``
null: no lane allocation runs here).

    python -m repro_torch.launch.serve --batches 3 --batch 32 \
        --img 256 --tile 64 [--mode M] [--rs-mode R] [--staged-ingest] \
        [--unfused-decode] [--decode-dtype fp32|bf16|int8] [--schedule S] \
        [--autotune] [--autotune-cache PATH] [--escalate-tiles K] \
        [--escalate-margin X] [--ragged] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.detect import (DetectionConfig, DetectionPipeline,
                                     resolve_device)
from repro_torch.core.extractor import (init_extractor, pack_params,
                                        params_from_numpy)
from repro_torch.core.rs.codec import DEFAULT_CODE
from repro_torch.data.pipeline import synth_image
from repro_torch.kernels import autotune as autotune_lib

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
        description="Offline batch detection service on the PyTorch port",
        epilog="Flags of the reference launcher that need the lane "
               "executor, allocator, scheduler, online server, fleet, "
               "sharding or the serving cache are not ported yet "
               "(ROADMAP.md queue 1 items 11-13) and are rejected as "
               "unrecognized.",
        allow_abbrev=False)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--mode", default="qrmark",
                    choices=("sequential", "tiled", "qrmark"))
    ap.add_argument("--rs-mode", default="device",
                    choices=("device", "cpu_pool", "cpu_sync"))
    ap.add_argument("--ragged", action="store_true",
                    help="send odd-size batches")
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
    ap.add_argument("--autotune-cache", default=DEFAULT_AUTOTUNE_CACHE,
                    help="schedule-cache JSON path")
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    return ap.parse_args(argv)


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


def build_pipeline(args) -> DetectionPipeline:
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
                          escalate_margin=args.escalate_margin)
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


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    pipe = build_pipeline(args)
    sample, batches = make_batches(args)
    warm_up(pipe, sample)
    rep, _ = serve(pipe, batches)
    pipe.close()
    print(json.dumps({**dataclasses.asdict(rep),
                      "device": str(pipe.device)}, indent=1))


if __name__ == "__main__":
    main()
