"""Example (PyTorch port): batched watermark-detection serving with
QRMark's adaptive lane allocation (Algorithm 1), LPT mini-batch
scheduling (Algorithm 2), inter-batch interleaving and the fused
ingest and decode kernels, compared against the sequential baseline.

  PYTHONPATH=src python examples/torch_serve_detection.py [--batches 6] \
      [--device cpu]

Needs a trained pair: examples/torch_train_extractor.py first.
"""
import argparse
import pickle
from pathlib import Path

import numpy as np

from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.data.pipeline import synth_image
from repro_torch.launch.serve import DetectionService

EXTRACTOR_CANDIDATES = [Path("experiments/extractor_torch/tile32_params.pkl"),
                        Path("experiments/extractor_torch/tile16_params.pkl")]


def load_pair():
    for p in EXTRACTOR_CANDIDATES:
        if p.exists():
            with open(p, "rb") as f:
                d = pickle.load(f)
            return d["params"], d["cfg"]
    raise SystemExit("train an extractor first: "
                     "PYTHONPATH=src python examples/torch_train_extractor.py")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()

    params, tcfg = load_pair()
    raw_size = 160
    batches = [np.stack([synth_image(k * args.batch + i, raw_size)
                         for i in range(args.batch)])
               for k in range(args.batches)]

    # --- sequential baseline --------------------------------------------
    base = DetectionPipeline(DetectionConfig(
        tile=tcfg.tile, img_size=128, resize_src=144, mode="sequential",
        rs_mode="cpu_sync", fused_preprocess=False, interleave=False,
        code=tcfg.code), params["dec"], device=args.device)
    try:
        r0 = base.run_stream(batches)
    finally:
        base.close()
    print(f"sequential baseline : {r0['throughput_ips']:8.1f} img/s")

    # --- QRMark service with adaptive allocation -------------------------
    svc = DetectionService(DetectionConfig(
        tile=tcfg.tile, img_size=128, resize_src=144, mode="qrmark",
        rs_mode="device", code=tcfg.code), params["dec"], lane_budget=8,
        device=args.device)
    try:
        alloc = svc.warmup(batches[0])
        print(f"adaptive allocation : streams={alloc.streams} "
              f"(pre/decode/RS), predicted J*="
              f"{alloc.bottleneck_s * 1e3:.2f}ms")
        rep = svc.serve(batches)
    finally:
        svc.close()
    print(f"qrmark service      : {rep.throughput_ips:8.1f} img/s "
          f"({rep.throughput_ips / max(r0['throughput_ips'], 1e-9):.2f}x)")
    print(f"straggler re-issues : {rep.straggler_retries}")


if __name__ == "__main__":
    main()
