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

Runs on the card by default; ``--device cpu`` runs the plain versions.
Flags of the reference launcher that need the lane executor,
allocator, scheduler, online server, fleet, sharding or another
configuration are rejected by argparse as unrecognized, never ignored.
Prints a
``ServiceReport``-shaped JSON object (``allocation`` and ``lanes``
null: no lane allocation runs here).

    python -m repro_torch.launch.serve --batches 3 --batch 32 \
        --img 256 --tile 64 [--ragged] [--device cuda|cpu]
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
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.extractor import init_extractor
from repro_torch.core.rs.codec import DEFAULT_CODE
from repro_torch.data.pipeline import synth_image

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
               "sharding or another configuration are not ported yet "
               "(ROADMAP.md queue 1 items 8-13) and are rejected as "
               "unrecognized.",
        allow_abbrev=False)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--ragged", action="store_true",
                    help="send odd-size batches")
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
    cfg = DetectionConfig(tile=args.tile, img_size=args.img,
                          resize_src=args.img + args.img // 8)
    params = init_extractor(torch.Generator().manual_seed(0),
                            n_bits=DEFAULT_CODE.codeword_bits,
                            tile=args.tile)
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
    print(json.dumps({**dataclasses.asdict(rep),
                      "device": str(pipe.device)}, indent=1))


if __name__ == "__main__":
    main()
