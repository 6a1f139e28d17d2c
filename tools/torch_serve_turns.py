#!/usr/bin/env python3
"""Images/s of the port's serve path, this checkout against another one
(for example the parent commit), in turns on one CUDA card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_serve_turns.py --parent DIR [--rounds 1]
        [--decode-dtype fp32|bf16|int8] [--schedules S[,S...]]

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
device time per batch of the RS kernel, of the ingest kernel and of the
decode's kernels.  Then, alone at b = 32 on the same pipeline's inputs,
the median call ms (20 calls between CUDA events) of the tile-first
ingest op and of the flat decode op at ``--decode-dtype`` (default
fp32, the default path's), of the blocked decode op at each of
``--schedules`` (``bb<N>-ct<N>[-db]`` strings; none by default), and of
the head kernel alone on the flat decode's partials (over 10
back-to-back launches), the head's device ms a launch in the profiled
pass, the ingest op's host microseconds a call over 200
back-to-back calls, and the staged (full-image) ingest op's call ms and
device ms a launch (10 calls under the profiler) on the same raw batch.  Each turn also hashes the served results
(logits, messages, ok, n_corrected of every batch); the run fails unless
every turn's hash is the same, so the two checkouts serve the same bits.

Prints one JSON line per turn and a last line with every turn, and
writes ``build/serve_turns/turns.json``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "serve_turns"
WINDOWS, REPS = 3, 34


def host_us(fn, calls: int) -> float:
    """Host microseconds a call over ``calls`` back-to-back calls, the
    card synchronised only after them: the wrapper's own cost while the
    card keeps up with it."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def call_ms(fn, iters: int = 20, reps: int = 1) -> float:
    """Median ms of one call between CUDA events, after warm-up; with
    ``reps`` > 1 each sample times that many back-to-back calls."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def turn(tree: Path, dtype: str, schedules=()) -> dict:
    """One turn, in this process, on ``tree``'s package."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fused_extractor as fx
    from repro_torch.launch import serve as serve_lib
    args = serve_lib.parse_args(["--batches", "3", "--batch", "32",
                                 "--img", "256", "--tile", "64",
                                 "--device", "cuda", "--decode-dtype",
                                 dtype])
    pipe = serve_lib.build_pipeline(args)
    sample, batches = serve_lib.make_batches(args)
    serve_lib.warm_up(pipe, sample)
    torch.cuda.synchronize()
    _, results = serve_lib.serve(pipe, batches)
    digest = hashlib.sha256()
    for r in results:
        for k in ("logits", "message_bits", "ok", "n_corrected"):
            digest.update(np.ascontiguousarray(r[k]).tobytes())
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
    n = len(batches)

    def per_batch(match):
        ms = sum(e.self_device_time_total for e in rows if match(e.key))
        return ms / 1e3 / n if busy_ms else None

    # the ingest and decode ops alone, at b = 32 on the pipeline's inputs
    cfg, st = pipe.cfg, pipe.stages
    raw = st.to_device(batches[0])
    offs = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.img_size // cfg.tile, (32, 2)).astype(np.int32) * cfg.tile
    ).to(raw.device)
    kw = dict(resize=cfg.resize_src, crop=cfg.img_size, tile=cfg.tile)
    tiles = ops.fused_tile_preprocess(raw, offs, **kw)
    ingest_ms = call_ms(lambda: ops.fused_tile_preprocess(raw, offs, **kw))
    ingest_us = host_us(lambda: ops.fused_tile_preprocess(raw, offs, **kw),
                        200)
    pk = st.packed_params
    decode_ms = call_ms(lambda: ops.fused_extractor(tiles, pk))
    blocked_ms = {sc: call_ms(lambda: ops.fused_extractor(
        tiles, pk, schedule=at.Schedule.from_string(sc)))
        for sc in schedules}
    # the head alone on the flat decode's partials
    lib, rung = _build.library(), fx.RUNGS[dtype]
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    x = tiles
    for blk in pk["blocks"]:
        x = fx.conv_block(lib, x, blk, rung, stream)
    parts = fx.to_bits_partials(lib, tiles, x, pk, rung, stream)
    head_ms = call_ms(lambda: fx.head_logits(lib, *parts, pk, rung, cfg.tile,
                                             False, stream), reps=10)
    # the staged ingest op alone: call ms, and device ms a launch
    skw = dict(resize=cfg.resize_src, crop=cfg.img_size)
    staged_ms = call_ms(lambda: ops.fused_preprocess(raw, **skw))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as sprof:
        for _ in range(8):  # a later session can miss its first events
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(10):
            ops.fused_preprocess(raw, **skw)
        torch.cuda.synchronize()
    srows = [e for e in sprof.key_averages()
             if e.device_type == DeviceType.CUDA and
             "preprocess_kernel" in e.key]
    staged_dev = (sum(e.self_device_time_total for e in srows) / 1e3 /
                  sum(e.count for e in srows)) if srows else None
    pipe.close()
    return {"tree": str(tree), "decode_dtype": dtype,
            "results_sha256": digest.hexdigest(), "images_per_s": ips,
            "median_images_per_s": statistics.median(ips),
            "device_busy_ms_per_batch": busy_ms / n if busy_ms else None,
            "idle_share_upper_bound": (1 - busy_ms / wall_ms
                                       if busy_ms else None),
            "rs_device_ms_per_batch": per_batch(
                lambda k: "rs_" in k and "decode" in k),
            "ingest_device_ms_per_batch": per_batch(
                lambda k: "tile_preprocess" in k),
            # summed over the decode's kernels by the parent process
            "device_ms_per_batch_by_kernel": {
                k: per_batch(lambda key, k=k: key == k)
                for k in {e.key for e in rows}} if busy_ms else None,
            "head_device_ms_per_batch": per_batch(
                lambda k: "head_kernel" in k),
            "ingest_call_ms": ingest_ms, "ingest_host_us": ingest_us,
            "decode_call_ms": decode_ms, "blocked_call_ms": blocked_ms,
            "head_call_ms": head_ms, "staged_ingest_call_ms": staged_ms,
            "staged_ingest_device_ms": staged_dev}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--decode-dtype", default="fp32",
                    choices=("fp32", "bf16", "int8"))
    ap.add_argument("--schedules", default="",
                    help="blocked schedules to time, comma-separated")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    schedules = [s for s in args.schedules.split(",") if s]
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.decode_dtype,
                              schedules)))
        return 0
    if args.parent is None:
        ap.error("--parent DIR is required")
    # this checkout's definition of the decode's kernels, for both sides
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fused_extractor import is_decode_kernel
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
             str(tree), "--decode-dtype", args.decode_dtype,
             "--schedules", args.schedules], check=True,
            capture_output=True, text=True, timeout=900,
            cwd=tree).stdout.strip().splitlines()[-1]
        res = {"side": side, **json.loads(out)}
        by_kernel = res.pop("device_ms_per_batch_by_kernel")
        res["decode_device_ms_per_batch"] = None if by_kernel is None else \
            sum(ms for k, ms in by_kernel.items() if is_decode_kernel(k))
        turns.append(res)
        print(json.dumps(res))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"turns_{args.decode_dtype}.json").write_text(json.dumps(
        {"card": card, "turns": turns}, indent=1))
    hashes = {t["results_sha256"] for t in turns}
    if len(hashes) != 1:
        print(f"the turns served different results: {hashes}",
              file=sys.stderr)
        return 1
    print(json.dumps({"card": card, "decode_dtype": args.decode_dtype,
                      "same_results": True, **{
        key: {side: [t[key] for t in turns if t["side"] == side]
              for side in ("parent", "change")}
        for key in ("median_images_per_s", "decode_call_ms",
                    "blocked_call_ms", "head_call_ms",
                    "head_device_ms_per_batch", "ingest_call_ms",
                    "ingest_host_us", "decode_device_ms_per_batch",
                    "ingest_device_ms_per_batch", "staged_ingest_call_ms",
                    "staged_ingest_device_ms")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
