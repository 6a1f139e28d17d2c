#!/usr/bin/env python3
"""Images/s of the port's default serve path, this checkout against
another one (for example the parent commit), in turns on one CUDA card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_serve_turns.py --parent DIR [--rounds 1]

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  Each round
runs parent, change, change, parent, each turn in a fresh process that
imports only that checkout's ``repro_torch`` (its kernels built from its
own sources into its own ``build/``).  A turn builds the serve
launcher's default pipeline at full width (C 64, D 7, 60 bits, tile 64,
img 256, raw 288, batch 32, seeded weights), warms it up, then sends
three windows of 102 batches of 32 (the 3 batches of ``chip_smoke.py``'s
end-to-end phase, 34 times each) and reads images/s per window; then one
profiled pass over the 3 batches gives the device busy time per batch,
the idle share (an upper bound: the profiler slows the host) and the
device time of the RS kernel per batch.

Prints one JSON line per turn and a last line with every turn, and
writes ``build/serve_turns/turns.json``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "serve_turns"
WINDOWS, REPS = 3, 34


def turn(tree: Path) -> dict:
    """One turn, in this process, on ``tree``'s package."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as serve_lib
    args = serve_lib.parse_args(["--batches", "3", "--batch", "32",
                                 "--img", "256", "--tile", "64",
                                 "--device", "cuda"])
    pipe = serve_lib.build_pipeline(args)
    sample, batches = serve_lib.make_batches(args)
    serve_lib.warm_up(pipe, sample)
    torch.cuda.synchronize()
    ips = [serve_lib.serve(pipe, batches * REPS)[0].throughput_ips
           for _ in range(WINDOWS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for raw in batches:
            pipe.detect_batch(raw)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    rs_ms = sum(e.self_device_time_total for e in rows
                if "rs_" in e.key and "decode" in e.key) / 1e3
    pipe.close()
    n = len(batches)
    return {"tree": str(tree), "images_per_s": ips,
            "median_images_per_s": statistics.median(ips),
            "device_busy_ms_per_batch": busy_ms / n if busy_ms else None,
            "idle_share_upper_bound": (1 - busy_ms / wall_ms
                                       if busy_ms else None),
            "rs_device_ms_per_batch": rs_ms / n if busy_ms else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve())))
        return 0
    if args.parent is None:
        ap.error("--parent DIR is required")
    parent = args.parent.resolve()
    if not (parent / "src" / "repro_torch").is_dir():
        ap.error(f"{parent} holds no src/repro_torch")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    order = [("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)] * args.rounds
    turns = []
    for side, tree in order:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--turn",
             str(tree)], check=True, capture_output=True, text=True,
            timeout=900, cwd=tree).stdout.strip().splitlines()[-1]
        res = {"side": side, **json.loads(out)}
        turns.append(res)
        print(json.dumps(res))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "turns.json").write_text(json.dumps(
        {"card": card, "turns": turns}, indent=1))
    print(json.dumps({"card": card, "median_images_per_s": {
        side: [t["median_images_per_s"] for t in turns if t["side"] == side]
        for side in ("parent", "change")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
