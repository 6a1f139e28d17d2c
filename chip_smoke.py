#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

In order, it

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes (batch 32, full width) and at batch 1 and a
   ragged 5 — integers exactly equal, floats within the stated
   tolerance — and times both with CUDA events (median call time); the
   full-image ingest kernel also at two scaling geometries and against
   the tile-first kernel (staged tiles equal tile-first tiles exactly),
   the blocked decode kernel on every candidate schedule and three
   explicit points against its plain version and, bitwise, against the
   flat kernel, each blocked conv instantiation alone on the 64 -> 64
   layer (ms per launch at bb 1, 2, 4 and 8, each launch's blocks as the
   profiler traced them against SMs, at least 256 at ct = C, ``ptxas
   -v`` registers, spills and stack: none, at every rung),
   then an autotune sweep into
   ``build/chip_smoke/decode_schedules.json``; then the bf16 and int8
   rungs of both decode kernels at full width (flat at b=32, 1 and a
   ragged 5, blocked on every candidate and the explicit points at
   b=32, 5 and 1) against their plain versions and, bitwise, blocked
   against flat; call ms of each and the
   ``ptxas -v`` registers and spills, and the blocked instantiations
   alone as at fp32; and a bf16 and an int8 sweep into the same
   cache, each under its own key; then the flat fp32 decode's kernels one by
   one at b=32 (layer 0, a 64 -> 64 block, to_bits + GAP + corr, the
   head: ms per launch, bound, registers, spills (none)) beside cuDNN's fp32
   conv2d on the same layer as a yardstick the port never calls, and
   the flat int8 decode's tensor-core kernels the same way (bounds at the
   int8 peak, with int8 activations) beside ``torch._int_mm`` on the
   layer's im2col, their IMMA instructions counted in the SASS
   (``cuobjdump -sass``); the RS syndrome kernel against the
   Berlekamp-Welch plain version on every single-symbol pattern of 16
   codewords (and of 256 at B = 65536), on 2-4 symbol errors and uniform
   words, and on words with entries outside {0, 1} (alone, among {0, 1}
   words, as int64 and as bool bits), its one kernel per call traced by
   the profiler, its call ms and ``ptxas -v`` registers, stack frame and
   spills (none); the escalation plan kernel (added by the port) against
   ``tiling.escalation_offsets`` bit for bit on every strategy and k up
   to the cap, timed at the mixed cells' batch of 256 rows beside the
   host ops a call of each;
4. drives the serve launcher's code path (``repro_torch.launch.serve``)
   at full width for 3 batches of 32 synthetic images, checks that every
   kernel of the path was launched, replays one batch through the plain
   versions, and prints images/s; then times three longer windows of
   the same stream (images/s), and profiles one more pass (device busy
   time by kernel, idle share);
5. drives the serve path, 3 batches of 32 each, in every other
   configuration — qrmark with ``--staged-ingest``, ``--schedule auto``
   (from the sweep's cache), ``--schedule bb4-ct32-db`` and
   ``--rs-mode cpu_pool``, ``--mode tiled``, ``--mode sequential
   --rs-mode cpu_sync`` (the paper's baseline), ``--mode sequential``,
   ``--decode-dtype bf16`` (flat, and blocked at ``bb4-ct32-db``, which
   must serve the flat bf16 bits), ``--decode-dtype int8`` and
   ``--decode-dtype int8 --schedule auto`` (from the int8 sweep) and
   ``--decode-dtype int8 --schedule bb4-ct32-db`` (which must serve the
   flat int8 bits), the decode's device ms a batch of each profiled one
   — checking each one's launch counts and its results against the
   default path's (the rungs' bits wherever the fp32 logit clears the
   rungs' margin), and prints images/s for each and the ratio of the
   default path's median window to each sequential run; the
   ``--decode-dtype int8`` run's launches per decode kernel, matched to
   its profiled pass, and the blocked int8 run's 9 kernels a batch; no
   profiled pass may trace a quantize pass; the ingest's, the head's and
   the RS kernel's device ms a launch and the decode's a batch in the
   default path's profiled pass, the staged ingest's device ms a launch
   in its own (with its registers and, as a yardstick the port never
   calls, ``F.interpolate`` bilinear plus the affine on the same
   images);
6. drives adaptive escalation at full width: a corr-only detector (head
   weights zeroed) on 32 images watermarked with the bank's patterns in
   every tile cell, Gaussian noise on the tile round 1 picks in 11 of
   them — k = 1 fails exactly there, k = 3 recovers them on 1 + rounds
   launches of each kernel and leaves the other rows bit for bit; a
   flat-filled round-1 tile escalates under ``escalate_margin``;
   ``decode_all_keyed`` equals the rounds bit for bit; the escalated
   results equal a replay through the plain versions — then images/s at
   k = 1 and 3 on the clean and the damaged batch, the synchronizing
   calls a batch, a profiled escalated pass, ``serve --escalate-tiles 3``
   at fp32 and int8 on the launcher's stream (counted, replayed),
   ``torch_rs`` on the card against the CPU at (4, 15, 11) and
   (8, 32, 24) and against the RS kernel at (4, 15, 12), with call ms at
   B = 32 and 65,536, and each ``ATTACKS`` entry on the card against the
   CPU;
7. drives the lane executor at full width (``phase_lanes``): on a
   12-batch stream, serial ``detect_batch`` against ``run_stream`` at
   one lane a stage, the default lanes and Algorithm 1's, and against
   the executor's service mode, by result hash, at fp32 and int8, with
   escalation (k = 3 on the escalation workload) and with ``cpu_pool``;
   launches equal to serial's; a profiled pass of the serial loop, the
   lanes and the scheduled service (device busy as the union of the
   trace's device intervals, idle share, H2D, the CUDA streams the
   decode kernels ran on — more than one with 4 decode lanes — and
   whether two overlapped); Algorithm 1's profiles and allocation;
   images/s in alternating windows; the raw batch's pageable and pinned
   upload; host µs a batch by part; keys and offsets with 1, 2 and 4
   threads at once; ``run_batch`` == ``detect_batch``; the launcher's
   ``main`` adaptive, ``--lanes 4`` and ``--sharded``;
8. drives the online server at full width (``phase_online``): a seeded
   stream of 200 requests of 1 to 8 images through ``DetectionServer``
   (micro-batches of up to 32, a 2 ms deadline), at fp32 and int8, each
   request equal to ``detect_batch`` under its key bit for bit, one
   launch of each main-path kernel a micro-batch, matched against a
   profiled pass's trace, with throughput, latency percentiles, batch
   occupancy and the host µs of ``submit``; the exact tier on a repeated
   pool (hits and coalesced followers equal the cold path and
   ``detect_batch`` at the content key); the decode's ``with_embed``
   logits equal the embed-free ones bit for bit at every rung, flat and
   blocked, its embedding the plain version's; ``escalate_tiles=3``
   through the server on the escalation workload equal to
   ``detect_batch``; and ``python -m repro_torch.launch.serve --online``
   at its defaults, at full width under open-loop load, and with the
   caches and escalation on a Zipf pool;
9. drives the fleet at full width (``phase_fleet``): a seeded stream of
   100 requests through two replicas sharing the card behind the
   ``FleetRouter``, each equal to one ``DetectionServer``'s result bit
   for bit, the main-path kernels' launches counted over the run, with
   requests/s, images/s and latency percentiles; a rolling reconfigure
   under traffic with no drop; the stream again with one replica crashed
   after admission, resolved through its sibling; and ``python -m
   repro_torch.launch.serve --fleet --replicas 2`` at its defaults;
10. drives the training stage at ``ExtractorTrainConfig()``'s widths
   (``phase_train``): one step's loss and gradients on the card against
   the CPU (a TF32 matmul would miss the tolerance), 20 steps with ms a
   step, ``evaluate`` on the card through the decode and RS kernels
   (launches counted), the decode kernels at hidden widths 8, 24 and 64
   at every rung against their plain versions with blocked equal to flat
   on every schedule, and a few LDM pretrain and fine-tune steps;
11. drives the LM seed code (``phase_lm``; none of the hand kernels):
   each of the ten archs at ``reduced`` — one float32 train step's loss
   and gradients on the card against the CPU from the same weights (TF32
   off), the MoE layers' routing on the same inputs, the bf16 loss —;
   smollm-360m at full width and depth through ``python -m
   repro_torch.launch.train`` (batch 8, sequence 512, bf16, 6 steps, a
   checkpoint every 2): killed before step 5 (exit 42), resumed from
   the step it committed, the resumed losses held to an uninterrupted
   run's, with ms a step, tokens/s and peak memory; a 512-token prefill
   at batch 4 and 16 greedy decode steps, each step's logits held to a
   prefill of the extended prompt; and granite-moe-3b-a800m (2 layers),
   mamba2-2.7b (2 layers) and h2o-danube-3-4b (1 layer, a 4608-token
   prompt, so the 4096-window ring cache engages) at their published
   widths: a train step and decode against prefill;
12. runs the LM's dry-run (``phase_dryrun``; none of the hand kernels):
   ``python -m repro_torch.launch.dryrun`` with probes, one process a
   row, in parallel on the host — smollm-360m at all four shapes on both
   production meshes (long_500k skipped with the reference's reason),
   granite-moe-3b-a800m train_4k and mamba2-2.7b long_500k on the
   single-pod mesh, every enabled cell ``ok`` with its derived roofline —
   and meanwhile on the card smollm-360m at a 1 x 1 plan at the LM
   phase's shapes (train b 8 x 512, prefill 4 x 512, one decode step):
   the FLOPs counted on meta equal ``FlopCounterMode``'s count of the
   same step on the card and the argument bytes from the specs equal the
   parameters, AdamW moments and inputs made on the card, exactly; the
   temp estimate beside the step's peak memory and its ms beside the
   roofline bound are printed, not gated;
13. checks the default and the staged path, and the bf16 and int8 rungs,
   against the JAX package's golden outputs
   (``tests/data/torch_port_golden.npz``);
14. prints the whole script's time, one ``{"kernels": [...]}`` line and,
   last, the status line.

Every failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available or when
the repository's sources are not beside it.  Imports nothing of JAX and
nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"   # ptxas log, trace, results JSON
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory, fp32 outside
# the tensor cores, int32 ALU (64 lanes/SM x 132 SMs x 1.98 GHz), dense
# bf16 and int8 tensor cores (the least time of the rungs' work)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_INT32_S = 16.7e12
RUNG_PEAK_S = {"fp32": PEAK_FP32_S, "bf16": 989e12, "int8": 1979e12}

INGEST_ATOL = 1e-5        # ingest vs plain: a few float32 ulps
LOGIT_RTOL = 1e-4         # logits vs plain/golden: 1e-4 * (1 + max|ref|)
RUNGS = ("bf16", "int8")
# bf16 / int8 logits and embedding vs plain / golden, absolute: where two
# fp32 sums of an activation differ by an ulp, its bf16 rounding or int8
# quantization can land one step apart (up to ~1e-3 in a logit)
RUNG_ATOL = 0.02
# a rung's bits vs the fp32 path's wherever |fp32 logit| exceeds this
# (int8 moved the serve path's logits by up to 0.094 from fp32 on an
# NVIDIA H100 80GB HBM3 at 700.00 W, bf16 by up to 0.025)
RUNG_MARGIN = 0.2
FULL = dict(tile=64, img_size=256, resize_src=288)  # DetectionConfig()
RAW = 288                 # serve launcher: img + 32
WIDTH = dict(n_bits=60, channels=64, depth=7)       # serve launcher


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def golden_params(seed: int, margin: float) -> dict:
    """The golden run's extractor weights, drawn by numpy from ``seed``:
    full width with the 64x64 correlation bank, nonzero biases, and a
    head bias of ``margin`` * (+-1) along an RS codeword with one symbol
    error, so some images decode (ok, one correction) and others fail."""
    from repro_torch.core.extractor import init_extractor_numpy
    from repro_torch.core.rs.codec import DEFAULT_CODE, rs_encode
    p = init_extractor_numpy(seed, tile=FULL["tile"], bias_scale=0.1,
                             **WIDTH)
    rng = np.random.default_rng(seed + 1)
    cw = rs_encode(DEFAULT_CODE, rng.integers(0, 2, 48)).copy()
    cw[5] ^= 1
    p["head"]["b"] = (p["head"]["b"] + margin * (2 * cw - 1)).astype(
        np.float32)
    return p


def logit_tol(ref: np.ndarray) -> float:
    return LOGIT_RTOL * (1.0 + float(np.abs(ref).max()))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 20, reps: int = 1) -> float:
    """Median per-call time as an eager caller sees it: CUDA events
    around each call after warm-up, host work in the wrapper included
    whenever the card waits for it.  With ``reps`` > 1 each of the
    ``iters`` samples times that many back-to-back calls and counts the
    time per call, so the host's launch cost hides behind the queue
    unless it exceeds the kernel's.  Device time alone by kernel comes
    from the profiled pass of the serve path."""
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


def traced_grids(launch, name: str) -> list:
    """Run ``launch`` once under ``torch.profiler`` and export the trace
    to build/chip_smoke/<name>_trace.json; return (kernel name with its
    spaces removed, blocks in its grid) of each device kernel it ran, in
    launch order, read from the trace's kernel events (empty where the
    profiler saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    # the warm-up step of profile_path: ``launch`` once, traced and
    # discarded, then the step the trace keeps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        launch()
        torch.cuda.synchronize()
        prof.step()
        launch()
        torch.cuda.synchronize()
    path = OUT / f"{name}_trace.json"
    prof.export_chrome_trace(str(path))
    events = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("cat") == "kernel" and "grid" in e.get(
                         "args", {}) and "spin_kernel" not in e["name"]),
                    key=lambda e: e["ts"])
    return [(e["name"].replace(" ", ""),
             int(np.prod(e["args"]["grid"]))) for e in events]


def timings(kernel_fn, plain_fn, plain_iters: int = 20) -> dict:
    return dict(ms=call_ms(kernel_fn),
                plain_ms=call_ms(plain_fn, plain_iters))


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 3a: tile-first ingest ------------------------------------------
def phase_ingest(dev, rng):
    import torch
    from repro_torch.kernels import fused_preprocess as fp
    from repro_torch.kernels import fused_tile_preprocess as ftp
    l, crop = FULL["tile"], FULL["img_size"]
    grid = crop // l
    cases = [(32, None, RAW, FULL["resize_src"]), (1, None, RAW, 288),
             (5, None, RAW, 288), (5, 3, RAW, 288), (5, 2, 400, 288)]
    err, main = 0.0, None
    for b, k, raw_hw, resize in cases:
        raw = torch.as_tensor(rng.integers(0, 256, (b, raw_hw, raw_hw, 3),
                                           dtype=np.uint8)).to(dev)
        shape = (b, 2) if k is None else (b, k, 2)
        offs = rng.integers(0, grid, shape) * l
        flat = offs.reshape(-1, 2)
        flat[0], flat[-1] = (0, 0), (crop - l, crop - l)  # grid borders
        offs = torch.as_tensor(offs.astype(np.int32)).to(dev)
        kw = dict(resize=resize, crop=crop, tile=l)
        got = ftp.fused_tile_preprocess_cuda(raw, offs, **kw)
        want = ftp.fused_tile_preprocess_plain(raw, offs, **kw)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        check(got.shape == want.shape and e <= INGEST_ATOL,
              f"ingest b={b} k={k} raw={raw_hw}: max |err| {e} > "
              f"{INGEST_ATOL}")
        err = max(err, e)
        if main is None:
            main = (raw, offs, kw)
    raw, offs, kw = main
    times = timings(
        lambda: ftp.fused_tile_preprocess_cuda(raw, offs, **kw),
        lambda: ftp.fused_tile_preprocess_plain(raw, offs, **kw))
    # bytes: the raw pixels under each tile's taps, the offsets, the output
    ry_idx, _, rx_idx, _ = (t.cpu().numpy() for t in fp.device_tables(
        RAW, RAW, kw["resize"], crop, None, None, str(dev))[:4])
    n_bytes = 0
    for oy, ox in offs.cpu().numpy():
        n_bytes += 3 * np.unique(ry_idx[oy: oy + l]).size * \
            np.unique(rx_idx[ox: ox + l]).size + 8
    n_out = offs.shape[0] * l * l * 3
    n_bytes += 4 * n_out
    bound_ms, by = bound(n_bytes, 12 * n_out, PEAK_FP32_S)
    return dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by,
                library_ms=None, **times)


# -- phase 3b: extractor decode --------------------------------------------
def extractor_flops(packed, b: int, l: int) -> float:
    ops, cin = 0.0, 3
    for blk in packed["blocks"]:
        cout = blk["w"].shape[-1]
        ops += b * l * l * (2 * 9 * cin * cout + 8 * cout)
        cin = cout
    n = packed["to_bits"]["w"].shape[-1]
    ops += b * l * l * (2 * 9 * cin * n + 2 * n)        # to_bits + GAP
    ops += b * 2 * n * n                                # head
    if "corr" in packed:
        ops += b * l * l * 3 * (11 + 2 * n)             # highpass + corr
    return ops


def phase_extractor(dev, rng):
    import torch
    from repro_torch.core.extractor import (init_extractor_numpy,
                                            pack_params, params_from_numpy)
    from repro_torch.kernels import fused_extractor as fx
    l = FULL["tile"]
    pk = pack_params(params_from_numpy(init_extractor_numpy(
        1, tile=l, bias_scale=0.1, **WIDTH), dev))
    no_corr = {k: v for k, v in pk.items() if k not in ("corr",
                                                        "corr_scale")}
    cases = [(32, pk, False), (32, pk, True), (1, pk, True), (5, pk, False),
             (5, no_corr, True)]
    err, main = 0.0, None
    for b, packed, embed in cases:
        tiles = torch.as_tensor(rng.uniform(-2.0, 2.5, (b, l, l, 3)).astype(
            np.float32)).to(dev)
        got = fx.fused_extractor_cuda(tiles, packed, with_embed=True)
        want = fx.fused_extractor_plain(tiles, packed, with_embed=True)
        if not embed:
            got = (fx.fused_extractor_cuda(tiles, packed),)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            w = w.cpu().numpy()
            e = float(np.abs(g.cpu().numpy() - w).max())
            check(g.shape == w.shape and np.isfinite(e) and
                  e <= logit_tol(w),
                  f"extractor b={b} corr={'corr' in packed} embed={embed}: "
                  f"max |err| {e} > {logit_tol(w)}")
            err = max(err, e)
        if main is None:
            main = tiles
    tiles = main
    times = timings(lambda: fx.fused_extractor_cuda(tiles, pk),
                    lambda: fx.fused_extractor_plain(tiles, pk))
    n_bytes = 4 * (tiles.numel() + sum(
        t.numel() for t in _leaves(pk)) + tiles.shape[0] * 60)
    bound_ms, by = bound(n_bytes, extractor_flops(pk, tiles.shape[0], l),
                         PEAK_FP32_S)
    return dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by,
                library_ms=None, **times)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# -- phase 3d: full-image (staged) ingest ----------------------------------
INGEST_KERNEL = "tile_preprocess_kernel"  # both ingest paths' kernel


def interpolate_yardstick_ms(raw, resize: int, crop: int):
    """ms a call of ``F.interpolate`` (bilinear, align_corners=False, no
    antialias) of the raw batch as float to (resize, resize), its center
    crop and the normalising affine: a yardstick the port never calls,
    not the same function (it takes float images, NCHW, and interpolates
    the whole image before the crop), so no kernel's library_ms."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_preprocess as fp
    scale, bias = (torch.as_tensor(a, device=raw.device).view(1, 3, 1, 1)
                   for a in fp.affine(None, None))
    x = raw.permute(0, 3, 1, 2).float()
    off = (resize - crop) // 2

    def call():
        y = F.interpolate(x, size=(resize, resize), mode="bilinear",
                          align_corners=False)
        return y[:, :, off:off + crop, off:off + crop] * scale + bias
    return call_ms(call)


def phase_preprocess(dev, rng, regs: dict):
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import fused_preprocess as fp
    from repro_torch.kernels import fused_tile_preprocess as ftp
    crop, l = FULL["img_size"], FULL["tile"]
    # (b, raw, resize, crop, tile): the main path's shape first, then
    # b=1, a ragged 5 and the two scaling geometries (at the default
    # one the resize is the identity, every weight 0 or 1)
    cases = [(32, RAW, FULL["resize_src"], crop, l), (1, RAW, 288, 256, 64),
             (5, RAW, 288, 256, 64), (5, 400, 288, 256, 64),
             (5, 64, 40, 32, 16)]
    err, main = 0.0, None
    for b, raw_hw, resize, cr, tl in cases:
        raw = torch.as_tensor(rng.integers(0, 256, (b, raw_hw, raw_hw, 3),
                                           dtype=np.uint8)).to(dev)
        kw = dict(resize=resize, crop=cr)
        got = fp.fused_preprocess_cuda(raw, **kw)
        want = fp.fused_preprocess_plain(raw, **kw)
        offs = rng.integers(0, cr // tl, (b, 2)) * tl
        offs[0], offs[-1] = (0, 0), (cr - tl, cr - tl)
        offs = torch.as_tensor(offs.astype(np.int32)).to(dev)
        staged = tiling.extract_tiles(got, offs, tl)
        first = ftp.fused_tile_preprocess_cuda(raw, offs, tile=tl, **kw)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        check(got.shape == want.shape and e <= INGEST_ATOL,
              f"preprocess b={b} raw={raw_hw} resize={resize}: max |err| "
              f"{e} > {INGEST_ATOL}")
        check(torch.equal(staged, first),
              f"staged tiles differ from tile-first tiles (b={b} "
              f"raw={raw_hw} resize={resize})")
        err = max(err, e)
        if main is None:
            main = (raw, kw)
    raw, kw = main
    times = timings(lambda: fp.fused_preprocess_cuda(raw, **kw),
                    lambda: fp.fused_preprocess_plain(raw, **kw))
    # bytes: the raw pixels under the taps (each read once), the output
    ry_idx, _, rx_idx, _ = (t.cpu().numpy() for t in fp.device_tables(
        RAW, RAW, kw["resize"], crop, None, None, str(dev))[:4])
    b = raw.shape[0]
    n_out = b * crop * crop * 3
    n_bytes = 3 * b * np.unique(ry_idx).size * np.unique(rx_idx).size + \
        4 * n_out
    bound_ms, by = bound(n_bytes, 12 * n_out, PEAK_FP32_S)
    from repro_torch.kernels import _build
    r = _build.registers_of(regs, INGEST_KERNEL)
    check(r is not None, f"{INGEST_KERNEL}: no ptxas -v line")
    yard_ms = interpolate_yardstick_ms(raw, kw["resize"], crop)
    print(f"preprocess: staged tiles equal tile-first tiles exactly at "
          f"every geometry; {INGEST_KERNEL} registers {r[0]}, spill bytes "
          f"{r[1] + r[2]}; yardstick, never called by the port: "
          f"F.interpolate bilinear + affine {yard_ms:.4f} ms at b={b}")
    return dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by,
                library_ms=None, kernel=INGEST_KERNEL, registers=r[0],
                spill_bytes=r[1] + r[2], interpolate_yardstick_ms=yard_ms,
                **times)



# -- phase 3e: blocked decode schedules + autotune --------------------------
SERVE_SCHEDULE = "bb4-ct32-db"   # the explicit blocked point the serve
                                 # phase runs and the kernels line times
# explicit points outside the sweep: narrower channel tiles and a batch
# block that leaves ragged blocks at b=32
EXTRA_SCHEDULES = ("bb2-ct16", "bb3-ct8-db", "bb1-ct4")
BLOCKED_BBS = (1, 2, 4, 8)  # batch blocks of the per-instantiation table
MIN_BLOCKS = 256  # the traced grid at ct = C, b = 32, every batch block


def blocked_kernels(dev, rng, card: str, regs: dict, dtype: str) -> dict:
    """Each ``conv_blocked_kernel`` instantiation at full width and the
    rung ``dtype``, on the decode's 64 -> 64 layer at b=32 (its input the
    blocked layer 0's output): ms per launch (``call_ms`` over 10
    back-to-back launches) at bb 1, 2, 4 and 8 with db on, the blocks
    of each launch's grid as the profiler traced it, against the card's
    SMs, and the ``ptxas -v`` registers, spill bytes and stack bytes;
    layer 0 (cin 3) at bb 4, ct 0.  Fails on any spill or stack in any
    instantiation of the rung's blocked conv (every width, channel tile
    and input width), on a traced grid of fewer blocks than SMs, and at
    ct = C on one of fewer than ``MIN_BLOCKS``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_extractor as fx
    l, b, C = FULL["tile"], 32, WIDTH["channels"]
    rung = fx.RUNGS[dtype]
    pk = rung_pack(dev, dtype)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = torch.as_tensor(rng.uniform(-2.0, 2.5, (b, l, l, 3)).astype(
        np.float32)).to(dev)
    blk0, blk1 = pk["blocks"][0], pk["blocks"][1]
    x1 = fx.conv_block(lib, tiles, blk0, rung, stream, blocked=(4, C, True))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cts = sorted(fx.blocked_channel_tiles(C), reverse=True)

    def launch(bb, ct):
        return fx.conv_block(lib, x1, blk1, rung, stream,
                             blocked=(bb, ct, True))

    traced = traced_grids(lambda: [launch(bb, ct) for ct in cts
                                   for bb in BLOCKED_BBS],
                          f"{dtype}_blocked_grids")
    family = fx.conv_kernel_name(rung, C, C, C).split("<")[0] + "<"
    if rung != fx.INT8:
        family += fx.conv_kernel_name(rung, C, C, C).split("<")[1].split(
            ",")[0] + ","
    every = {k: v for k, v in regs.items() if family in k.replace(" ", "")}
    # one instantiation per (cout, ct, cin 3 or cout) the sources build
    n_inst = sum(2 * len(fx.blocked_channel_tiles(c))
                 for c in fx.HIDDEN_CHANNELS)
    check(len(every) == n_inst and all(v[1:] == (0, 0, 0, 0)
                                   for v in every.values()),
          f"{dtype} blocked conv: {len(every)} instantiations, spills or "
          f"stack in {[k for k, v in every.items() if any(v[1:])]}")
    rows = []
    for ct in cts:
        kernel = fx.conv_kernel_name(rung, C, C, ct)
        r = _build.registers_of(regs, kernel)
        check(r is not None, f"{kernel}: no ptxas -v line")
        check(r[1] == r[2] == r[3] == r[4] == 0,
              f"{kernel}: ptxas -v shows spills or stack: {r}")
        grids = [g for k, g in traced if kernel in k]
        blocks = dict(zip(BLOCKED_BBS, grids)) \
            if len(grids) == len(BLOCKED_BBS) else None
        least = MIN_BLOCKS if ct == C else sms
        check(blocks is None or min(blocks.values()) >= least,
              f"{kernel}: a traced grid below {least} blocks: {blocks}")
        rows.append(dict(
            kernel=kernel, ct=ct, registers=r[0], spill_bytes=r[1] + r[2],
            stack_bytes=r[3] + r[4],
            ms_by_bb={bb: call_ms(lambda: launch(bb, ct), reps=10)
                      for bb in BLOCKED_BBS},
            blocks_by_bb=blocks))
    layer0_ms = call_ms(lambda: fx.conv_block(
        lib, tiles, blk0, rung, stream, blocked=(4, C, True)), reps=10)
    print(f"  {dtype} conv_blocked_kernel instantiations, {C} -> {C} at "
          f"b=32 (ms per launch at bb {'/'.join(map(str, BLOCKED_BBS))}, "
          f"db; traced blocks at those bb on {sms} SMs; registers / spill "
          f"bytes / stack bytes), on {card}:")
    for r in rows:
        blocks = "not measured" if r["blocks_by_bb"] is None else \
            " / ".join(str(r["blocks_by_bb"][bb]) for bb in BLOCKED_BBS)
        print(f"    {r['kernel']}: "
              + " / ".join(f"{r['ms_by_bb'][bb]:.4f}" for bb in BLOCKED_BBS)
              + f" ms; blocks {blocks}; {r['registers']} / "
                f"{r['spill_bytes']} / {r['stack_bytes']}")
    print(f"    layer 0 (3 -> {C}) at bb4-ct0: {layer0_ms:.4f} ms; all "
          f"{len(every)} instantiations (cout 16/32/64, every ct, cin 3 or "
          f"cout) 0 spill and 0 stack, at most "
          f"{max(v[0] for v in every.values())} registers")
    return dict(sms=sms, kernels=rows, layer0_bb4_ct0_ms=layer0_ms,
                instantiations_checked=len(every),
                max_registers=max(v[0] for v in every.values()))


def phase_blocked(dev, rng, card: str, regs: dict):
    """Every candidate schedule (and the extra points) at b=32 and a
    ragged b=5: the blocked kernel against its plain version on the same
    tiles (logits and embedding within the logit tolerance) and bitwise
    against the flat kernel; call ms of each at b=32; each blocked
    conv instantiation alone (:func:`blocked_kernels`)."""
    import torch
    from repro_torch.core.extractor import (init_extractor_numpy,
                                            pack_params, params_from_numpy)
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fused_extractor as fx
    l = FULL["tile"]
    pk = pack_params(params_from_numpy(init_extractor_numpy(
        1, tile=l, bias_scale=0.1, **WIDTH), dev))
    cands = at.candidate_schedules(32, WIDTH["channels"], "cuda")
    scheds = cands + [at.Schedule.from_string(s) for s in EXTRA_SCHEDULES]
    sched_ms, err = {}, 0.0
    for b in (32, 5):
        tiles = torch.as_tensor(rng.uniform(-2.0, 2.5, (b, l, l, 3)).astype(
            np.float32)).to(dev)
        flat = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
        for sc in scheds:
            kw = dict(batch_block=sc.batch_block,
                      channel_tile=sc.channel_tile,
                      double_buffer=sc.double_buffer)
            got = fx.fused_extractor_blocked_cuda(tiles, pk, with_embed=True,
                                                  **kw)
            want = fx.fused_extractor_blocked_plain(tiles, pk,
                                                    with_embed=True, **kw)
            torch.cuda.synchronize()
            for what, g, w in zip(("logits", "embed"), got, want):
                w = w.cpu().numpy()
                e = float(np.abs(g.cpu().numpy() - w).max())
                check(g.shape == w.shape and np.isfinite(e) and
                      e <= logit_tol(w),
                      f"blocked {sc.to_string()} b={b} {what}: max |err| "
                      f"{e} vs plain > {logit_tol(w)}")
                err = max(err, e)
            check(torch.equal(got[0], flat[0]) and
                  torch.equal(got[1], flat[1]),
                  f"blocked {sc.to_string()} b={b} differs from flat")
            if b == 32:
                sched_ms[sc.to_string()] = call_ms(
                    lambda: fx.fused_extractor_blocked_cuda(tiles, pk,
                                                            **kw))
        if b == 32:
            main = tiles
            sched_ms["flat"] = call_ms(
                lambda: fx.fused_extractor_cuda(tiles, pk))
    print(f"blocked: every candidate ({len(cands)}) and "
          f"{', '.join(EXTRA_SCHEDULES)} within {err:.3g} of the plain "
          f"version and bitwise equal to flat at b=32 and b=5; call ms at "
          f"b=32 on {card}:")
    for name, ms in sorted(sched_ms.items(), key=lambda kv: kv[1]):
        print(f"  {name:<14} {ms:.4f} ms")
    instantiations = blocked_kernels(dev, rng, card, regs, "fp32")
    sc = at.Schedule.from_string(SERVE_SCHEDULE)
    kw = dict(batch_block=sc.batch_block, channel_tile=sc.channel_tile,
              double_buffer=sc.double_buffer)
    tiles = main
    times = dict(ms=sched_ms[SERVE_SCHEDULE], plain_ms=call_ms(
        lambda: fx.fused_extractor_blocked_plain(tiles, pk, **kw), 5))
    n_bytes = 4 * (tiles.numel() + sum(
        t.numel() for t in _leaves(pk)) + tiles.shape[0] * 60)
    bound_ms, by = bound(n_bytes, extractor_flops(pk, tiles.shape[0], l),
                         PEAK_FP32_S)
    # autotune: a fresh sweep into the smoke's cache, then "auto" must
    # resolve from it without the flat-fallback hint
    cache = OUT / "decode_schedules.json"
    cache.unlink(missing_ok=True)
    winner = at.autotune(pk, tile=l, batch=32, dtype="fp32",
                         cache_path=cache, iters=5, warmup=2)
    name = "flat" if winner is None else winner.to_string()
    hint = io.StringIO()
    with contextlib.redirect_stderr(hint):
        got = at.resolve_schedule("auto", dtype="fp32", tile=l,
                                  channels=WIDTH["channels"],
                                  depth=WIDTH["depth"],
                                  n_bits=WIDTH["n_bits"], cache_path=cache,
                                  device=dev)
    check(hint.getvalue() == "" and got == winner,
          f"auto did not resolve from the cache: {got} / {hint.getvalue()}")
    print(f"autotune: winner {name} (cache {cache.relative_to(ROOT)}); "
          f"auto resolves to it from the cache")
    return dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by,
                library_ms=None, schedules_ms=sched_ms, winner=name,
                instantiations=instantiations, **times), cache, winner


# -- phase 3f: the bf16 and int8 rungs of both decode kernels --------------
def rung_pack(dev, dtype: str):
    from repro_torch.core.extractor import (init_extractor_numpy,
                                            pack_params, params_from_numpy)
    return pack_params(params_from_numpy(init_extractor_numpy(
        1, tile=FULL["tile"], bias_scale=0.1, **WIDTH), dev), dtype)


def decode_bound(packed, tiles, dtype: str):
    """Each input byte read once (tiles, the pack at its dtype), each
    output written once, and the decode's operations at the rung's peak."""
    b, l = tiles.shape[0], tiles.shape[1]
    n_bytes = 4 * tiles.numel() + sum(
        t.numel() * t.element_size() for t in _leaves(packed)) + 4 * b * 60
    return bound(n_bytes, extractor_flops(packed, b, l), RUNG_PEAK_S[dtype])


def _hold_rung(got, want, what: str) -> float:
    err = 0.0
    for g, w in zip(got, want):
        w = w.cpu().numpy()
        e = float(np.abs(g.cpu().numpy() - w).max())
        check(g.shape == w.shape and np.isfinite(e) and e <= RUNG_ATOL,
              f"{what}: max |err| {e} vs plain > {RUNG_ATOL}")
        err = max(err, e)
    return err


def phase_rungs(dev, rng, card: str, cache, regs: dict):
    """Both decode kernels at bf16 and int8, full width: flat against its
    plain version at b=32, 1 and 5; blocked against its plain version
    and bitwise against flat on every candidate and the explicit points
    at b=32, 5 and 1; call ms (median of 20)
    of every schedule at b=32, the plain versions' ms, the bounds at the
    rung's peak.  Then a bf16 and an int8 autotune sweep into the same
    cache, each under its own key, and "auto" at each resolving from
    it."""
    import torch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fused_extractor as fx
    l = FULL["tile"]
    serve_sc = at.Schedule.from_string(SERVE_SCHEDULE)
    scheds = at.candidate_schedules(32, WIDTH["channels"], "cuda") + [
        at.Schedule.from_string(s) for s in EXTRA_SCHEDULES]
    scheds += [serve_sc] if serve_sc not in scheds else []
    out = {}
    for dtype in RUNGS:
        pk = rung_pack(dev, dtype)
        err = {"flat": 0.0, "blocked": 0.0}
        sched_ms, main = {}, None
        for b in (32, 1, 5):
            tiles = torch.as_tensor(rng.uniform(-2.0, 2.5, (b, l, l, 3)).astype(
                np.float32)).to(dev)
            flat = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
            alone = fx.fused_extractor_cuda(tiles, pk)
            want = fx.fused_extractor_plain(tiles, pk, with_embed=True)
            torch.cuda.synchronize()
            check(torch.equal(alone, flat[0]),
                  f"{dtype} flat b={b}: the embedding output moved logits")
            err["flat"] = max(err["flat"], _hold_rung(
                flat, want, f"{dtype} flat b={b}"))
            for sc in scheds:
                kw = dict(batch_block=sc.batch_block,
                          channel_tile=sc.channel_tile,
                          double_buffer=sc.double_buffer)
                got = fx.fused_extractor_blocked_cuda(tiles, pk,
                                                      with_embed=True, **kw)
                want = fx.fused_extractor_blocked_plain(tiles, pk,
                                                        with_embed=True, **kw)
                torch.cuda.synchronize()
                err["blocked"] = max(err["blocked"], _hold_rung(
                    got, want, f"{dtype} blocked {sc.to_string()} b={b}"))
                check(torch.equal(got[0], flat[0]) and
                      torch.equal(got[1], flat[1]),
                      f"{dtype} blocked {sc.to_string()} b={b} differs "
                      f"from flat")
                if b == 32:
                    sched_ms[sc.to_string()] = call_ms(
                        lambda: fx.fused_extractor_blocked_cuda(tiles, pk,
                                                                **kw))
            if b == 32:
                main = tiles
                sched_ms["flat"] = call_ms(
                    lambda: fx.fused_extractor_cuda(tiles, pk))
        tiles = main
        kw = dict(batch_block=serve_sc.batch_block,
                  channel_tile=serve_sc.channel_tile,
                  double_buffer=serve_sc.double_buffer)
        bound_ms, by = decode_bound(pk, tiles, dtype)
        out[dtype] = {
            "fused_extractor": dict(
                ms=sched_ms["flat"], max_abs_err=err["flat"],
                plain_ms=call_ms(lambda: fx.fused_extractor_plain(tiles, pk)),
                bound_ms=bound_ms, bound_by=by, library_ms=None),
            "fused_extractor_blocked": dict(
                ms=sched_ms[SERVE_SCHEDULE], max_abs_err=err["blocked"],
                plain_ms=call_ms(lambda: fx.fused_extractor_blocked_plain(
                    tiles, pk, **kw), 5),
                bound_ms=bound_ms, bound_by=by, library_ms=None),
            "schedules_ms": sched_ms}
        r = out[dtype]
        print(f"{dtype}: flat within {err['flat']:.3g} and blocked within "
              f"{err['blocked']:.3g} of their plain versions (tol "
              f"{RUNG_ATOL}) at b=32, 1 and 5; blocked bitwise equal to "
              f"flat on {len(scheds)} schedules (every candidate, "
              f"{', '.join(EXTRA_SCHEDULES)}) at each b; on {card}:")
        for k in ("fused_extractor", "fused_extractor_blocked"):
            print(f"  {k}: {r[k]['ms']:.4f} ms, plain {r[k]['plain_ms']:.4f}"
                  f" ms, bound {r[k]['bound_ms']:.3g} ms ({by}), batch 32")
        print("  call ms at b=32: " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in sorted(sched_ms.items(),
                                               key=lambda kv: kv[1])))
        tags = {"bf16": ("RBF16", "__nv_bfloat16"),
                "int8": ("imma_kernel",)}[dtype]
        mine = {k: v for k, v in regs.items() if any(t in k for t in tags)}
        print("  registers / spill stores / spill loads: " + "; ".join(
            f"{k.replace('qr::', '').replace('void ', '')} {v[0]}/{v[1]}/"
            f"{v[2]}" for k, v in sorted(mine.items())))
        r["registers"] = mine
        r["fused_extractor_blocked"]["instantiations"] = blocked_kernels(
            dev, rng, card, regs, dtype)
    winners = {dtype: at.autotune(rung_pack(dev, dtype), tile=l, batch=32,
                                  dtype=dtype, cache_path=cache, iters=5,
                                  warmup=2) for dtype in RUNGS}
    entries = at.load_cache(cache)["entries"]
    check(sorted(k.split("|")[1] for k in entries) == ["bf16", "fp32",
                                                       "int8"],
          f"the cache should hold an entry a rung: {list(entries)}")
    for dtype, winner in winners.items():
        hint = io.StringIO()
        with contextlib.redirect_stderr(hint):
            got = at.resolve_schedule("auto", dtype=dtype, tile=l,
                                      channels=WIDTH["channels"],
                                      depth=WIDTH["depth"],
                                      n_bits=WIDTH["n_bits"],
                                      cache_path=cache, device=dev)
        check(hint.getvalue() == "" and got == winner,
              f"{dtype} auto did not resolve from the cache: {got} / "
              f"{hint.getvalue()}")
        name = "flat" if winner is None else winner.to_string()
        print(f"autotune {dtype}: winner {name}, its own entry beside "
              f"fp32's in {cache.relative_to(ROOT)}; auto at {dtype} "
              f"resolves to it")
        out[dtype]["winner"] = name
    return out, winners["int8"]


# -- phase 3g: the flat decode's kernels one by one, fp32 and int8 --------
def phase_decode_parts(dev, rng, card: str, regs: dict, dtype: str = "fp32"):
    """The flat decode's CUDA kernels alone at b=32, full width, each on
    the inputs the decode gives it: layer 0 (cin 3 -> 64), a 64 -> 64
    hidden block, to_bits + GAP + corr, the head.  Per kernel: ms per
    launch (``call_ms`` over 10 back-to-back launches), its bound (fp32:
    FFMA peak, fp32 activations; int8: the int8 tensor cores' peak, int8
    words and a scale a pixel in and out), the ``ptxas -v`` registers and
    spill bytes (the phase fails on any spill); its launches come from
    the path's run (:func:`check_part_launches`).  Beside them, as a
    yardstick the port never calls, the same 64 -> 64 layer's product in
    one library call:
    fp32, cuDNN's conv2d (TF32 off, channels_last), the conv alone,
    without bias, norm or ReLU; int8, ``torch._int_mm`` on its im2col
    (the exact int32 dot of one tap-stacked matrix, without the per-tap
    dequantize, the norm or the quantize), so neither is the kernel's
    library_ms.  Returns (parts, yardstick ms)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_extractor as fx
    l, b, C, nb = FULL["tile"], 32, WIDTH["channels"], WIDTH["n_bits"]
    r8 = dtype == "int8"
    rung = fx.RUNGS[dtype]
    pk = rung_pack(dev, dtype)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = torch.as_tensor(rng.uniform(-2.0, 2.5, (b, l, l, 3)).astype(
        np.float32)).to(dev)
    blk0, blk1 = pk["blocks"][0], pk["blocks"][1]
    x1 = fx.conv_block(lib, tiles, blk0, rung, stream)
    x2 = fx.conv_block(lib, x1, blk1, rung, stream)
    parts = fx.to_bits_partials(lib, tiles, x2, pk, rung, stream)
    npix, n_parts = b * l * l, parts[0].shape[0]
    # bytes of an activation of c channels a pixel, and of a pack leaf
    act = (lambda c: c + 4) if r8 else (lambda c: 4 * c)
    nbytes = (lambda t: t.numel() * t.element_size())

    def conv_work(cin, blk):
        cout = blk["w"].shape[-1]
        n_in = npix * (4 * cin if cin == 3 else act(cin))
        return (n_in + nbytes(blk["w"]) + 4 * cout * (1 + r8) +
                npix * act(cout),
                npix * (2 * 9 * cin * cout + 8 * cout))

    tb = pk["to_bits"]
    peak = RUNG_PEAK_S[dtype]
    rows = [
        ("conv layer 0 (3 -> 64)", fx.conv_kernel_name(rung, 3, C),
         lambda: fx.conv_block(lib, tiles, blk0, rung, stream),
         *conv_work(3, blk0)),
        (f"conv hidden ({C} -> {C})", fx.conv_kernel_name(rung, C, C),
         lambda: fx.conv_block(lib, x1, blk1, rung, stream),
         *conv_work(C, blk1)),
        ("to_bits + GAP + corr", fx.to_bits_kernel_name(rung, C, nb),
         lambda: fx.to_bits_partials(lib, tiles, x2, pk, rung, stream),
         npix * act(C) + 4 * tiles.numel() + nbytes(tb["w"]) +
         4 * nb * (1 + r8) +
         nbytes(pk["corr"]) + 4 * 2 * n_parts * nb,
         npix * (2 * 9 * C * nb + 2 * nb) + npix * 3 * (11 + 2 * nb)),
        ("head", fx.head_kernel_name(rung, nb),
         lambda: fx.head_logits(lib, *parts, pk, rung, l, False, stream),
         4 * (2 * n_parts * nb + pk["head"]["w"].numel() + 2 * nb + b * nb),
         b * (2 * nb * nb + 2 * (n_parts // b) * nb + 3 * nb)),
    ]
    out = []
    for name, kernel, fn, n_bytes, n_ops in rows:
        # the head's products and sums are fp32 at every rung
        bound_ms, by = bound(n_bytes, n_ops,
                             PEAK_FP32_S if name == "head" else peak)
        r = _build.registers_of(regs, kernel)
        check(r is not None and r[1] == r[2] == 0,
              f"{kernel}: ptxas -v shows spills, or no line for it: {r}")
        out.append(dict(name=name, kernel=kernel, ms=call_ms(fn, reps=10),
                        bound_ms=bound_ms, bound_by=by, registers=r[0],
                        spill_bytes=r[1] + r[2]))
    if r8:
        yard_name = "torch._int_mm, int8 x int8 -> int32, on the im2col"
        # the layer's input as int8 (b*l*l, 576) taps x channels, zero-padded
        q = x1.q.view(torch.int8).view(b, l, l, C)
        qp = F.pad(q.view(torch.uint8), (0, 0, 1, 1, 1, 1)).view(torch.int8)
        cols = torch.cat([qp[:, dy:dy + l, dx:dx + l]
                          for dy in range(3) for dx in range(3)],
                         dim=-1).reshape(npix, 9 * C).contiguous()
        wq = blk1["w"].contiguous()
        try:
            yard_ms = call_ms(lambda: torch._int_mm(cols, wq), reps=10)
            yard_note = "the exact int32 dot alone"
        except RuntimeError as e:  # an optional yardstick, never the port
            yard_ms, yard_note = None, f"not measured: {e}"
    else:
        yard_name = "cuDNN conv2d fp32 (TF32 off, channels_last)"
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            xin = x1.permute(0, 3, 1, 2)  # NCHW view of NHWC = channels_last
            wt = blk1["w"].view(3, 3, C, C).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            y = F.conv2d(xin, wt, padding=1).permute(0, 2, 3, 1)
            mu = (y + blk1["b"]).mean(-1, keepdim=True)
            ref = torch.relu((y + blk1["b"] - mu) * torch.rsqrt(
                ((y + blk1["b"] - mu) ** 2).mean(-1, keepdim=True) + 1e-5))
            dev_err = float((ref - x2).abs().max())
            check(dev_err <= 1e-3, f"cuDNN yardstick: its conv + norm "
                  f"differs from the kernel's block by {dev_err}")
            yard_ms = call_ms(lambda: F.conv2d(xin, wt, padding=1), reps=10)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        yard_note = (f"the conv alone; + bias/norm/ReLU in torch within "
                     f"{dev_err:.3g} of the kernel")
    print(f"flat {dtype} decode kernels alone, b=32, full width, on {card} "
          f"(ms per launch, median of 20 samples of 10 launches):")
    for r in out:
        print(f"  {r['kernel']} ({r['name']}): {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4g} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.1%} of it; registers "
              f"{r['registers']}, spill bytes {r['spill_bytes']}")
    print(f"  yardstick, never called by the port: {yard_name} {C} -> {C}: "
          f"{yard_ms} ms ({yard_note})")
    return out, yard_ms


def imma_sass(card: str) -> dict:
    """The int8 flat kernels' tensor-core instructions in the built
    library's SASS (``cuobjdump -sass``): {kernel: IMMA count}; fails
    unless each ``conv_imma_kernel`` and ``gap_corr_imma_kernel`` issues
    IMMA."""
    import re
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", _build.build_info["path"]],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "imma_kernel" in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.search(r"\bIMMA\.", line):
            counts[name] += 1
    check(len(counts) >= 2 and all(counts.values()),
          f"the int8 flat kernels issue no IMMA in their SASS: {counts}")
    out = dict(zip(_build.demangle(list(counts)), counts.values()))
    print(f"int8 flat kernels' SASS ({tool.name} -sass): IMMA instructions "
          + ", ".join(f"{k} {v}" for k, v in sorted(out.items())))
    return out


def check_part_launches(parts, kernel_counts, traced, n_batches: int,
                        path: str = "default path"):
    """Set each flat-decode kernel's ``launches`` to its count in the
    path's run (``ops.kernel_launch_counts``, zeroed just before it), and
    fail unless each ran: layer 0, to_bits and the head once a batch,
    the hidden conv depth - 1 times, and no other decode kernel (at int8:
    no quantize pass).  Where the profiled pass over the same batches
    saw device time, its trace must show each kernel launched as often
    and no ``quantize_rows_kernel`` (``traced``: the profiler's kernel
    names, spaces removed, and their counts)."""
    want = {parts[0]["kernel"]: n_batches,
            parts[1]["kernel"]: (WIDTH["depth"] - 1) * n_batches,
            parts[2]["kernel"]: n_batches, parts[3]["kernel"]: n_batches}
    check(kernel_counts == want,
          f"the {path}'s decode kernels launched {kernel_counts}, "
          f"expected {want}")
    if traced:
        quant = sum(n for k, (n, _) in traced.items() if "quantize_rows" in k)
        check(quant == 0, f"the {path}'s trace shows {quant} quantize "
              f"passes")
    for p in parts:
        p["launches"] = kernel_counts[p["kernel"]]
        if traced:
            seen = sum(n for k, (n, _) in traced.items()
                       if f"::{p['kernel']}(" in k)
            check(seen == p["launches"],
                  f"{p['kernel']}: the profiled pass traced {seen} "
                  f"launches, the counter {p['launches']}")
    print(f"{path}, {n_batches} batches: decode kernel launches "
          f"{json.dumps({p['kernel']: p['launches'] for p in parts})}"
          + ("; the profiled pass traced the same" if traced else
             "; trace counts not measured"))


# -- phase 3c: RS decode ---------------------------------------------------
RS_KERNEL = "rs_syndrome_decode_kernel"


def flip_symbol(word: np.ndarray, pos: int, value: int) -> np.ndarray:
    out = word.copy()
    out[4 * pos:4 * pos + 4] ^= (value >> np.arange(3, -1, -1)) & 1
    return out


def rs_words(rng, n_codewords: int, n_each: int) -> np.ndarray:
    """Every single-symbol pattern (15 positions x 16 values, 0 included)
    on ``n_codewords`` random codewords, ``n_each`` codewords with 2, 3
    and 4 symbol errors each, and ``n_each`` uniform words, shuffled.
    Codewords are XORs of the unit messages' (the code is linear over
    GF(2) bit by bit)."""
    from repro_torch.core.rs.codec import DEFAULT_CODE, rs_encode
    gen = np.stack([rs_encode(DEFAULT_CODE, e) for e in np.eye(48, dtype=int)])
    rows = [flip_symbol(cw, p, v)
            for cw in rng.integers(0, 2, (n_codewords, 48)) @ gen % 2
            for p in range(15) for v in range(16)]
    for n_err in (2, 3, 4):
        for w in rng.integers(0, 2, (n_each, 48)) @ gen % 2:
            for p in rng.choice(15, n_err, replace=False):
                w = flip_symbol(w, int(p), int(rng.integers(1, 16)))
            rows.append(w)
    rows += list(rng.integers(0, 2, (n_each, 60)))
    words = np.stack(rows).astype(np.int32)
    return words[rng.permutation(len(words))]


def rs_out_of_domain_words(rng) -> np.ndarray:
    """(128, 60) int32 words with entries outside {0, 1}: codewords and
    single-error words with one to four entries of 2, -1, 3, -2 or 5
    (every fourth left in {0, 1}), words over [-2, 3], and words with
    entries at the int32 limits (-2^31 times a symbol weight wraps to 0
    in the reference's int32 arithmetic), shuffled."""
    from repro_torch.core.rs.codec import DEFAULT_CODE, rs_encode
    gen = np.stack([rs_encode(DEFAULT_CODE, e) for e in np.eye(48, dtype=int)])
    rows = []
    for i, cw in enumerate(rng.integers(0, 2, (64, 48)) @ gen % 2):
        w = cw.astype(np.int64)
        if i % 2:
            w = flip_symbol(w, int(rng.integers(15)), int(rng.integers(16)))
        if i % 4 != 3:
            for j in rng.choice(60, int(rng.integers(1, 5)), replace=False):
                w[j] = rng.choice([2, -1, 3, -2, 5])
        rows.append(w)
    rows += list(rng.integers(-2, 4, (32, 60)))
    big = [2 ** 30, 2 ** 29, -2 ** 31, 2 ** 31 - 1, -2 ** 30 - 7]
    for i in range(32):
        w = rng.integers(0, 2, 60) if i % 2 else np.zeros(60, np.int64)
        w[(7 * i) % 60] = -2 ** 31
        w[(11 * i + 3) % 60] = big[i % 5]
        rows.append(w)
    words = np.stack(rows).astype(np.int32)
    return words[rng.permutation(len(words))]


def rs_int_ops(n_words: int) -> float:
    """int32 ops of the least work a t=1 decode of one word needs, times
    the words: unpack 60 bits (2 ops each), two syndromes over 15
    symbols (a table multiply and an xor each), locate and size the one
    error through the log/exp tables (~10), and pack the 108 output bits
    (2 ops each)."""
    return float(n_words * (2 * 60 + 2 * 15 * 2 + 10 + 2 * 108))


def rs_bound(n_words: int):
    """(bound ms, what bounds it) of decoding ``n_words`` words: each
    reads 60 int32 bits and writes 48 + 60 int32 bits, an int32
    n_corrected and a one-byte ok."""
    return bound(n_words * (4 * (60 + 48 + 60 + 1) + 1),
                 rs_int_ops(n_words), PEAK_INT32_S)


def phase_rs(dev, rng, card: str, regs: dict):
    """The syndrome kernel against the Berlekamp-Welch plain version on
    every single-symbol pattern of 16 codewords, 2-4 symbol errors and
    uniform words, at B = 1, 5, 32, the whole set (5888) and 65536 (256
    codewords' patterns; 16384 blocks): all four outputs exact, dtypes
    included.  One call counts one launch.  Call ms at B = 32 beside the
    bound and the kernel's ``ptxas -v`` registers, stack frame and
    spills (none allowed); ms per launch at B = 65536 (10 back to back)
    beside its bound."""
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import rs_decode as rs
    full = rs_words(rng, 16, 512)
    cases = [full[:32], full[32:33], full[33:38], full,
             rs_words(rng, 256, 1024)]
    for words in cases:
        bits = torch.as_tensor(words).to(dev)
        got = rs.rs_decode_cuda(bits)
        want = rs.rs_decode_plain(bits)
        torch.cuda.synchronize()
        for k in want:
            check(got[k].dtype == want[k].dtype and
                  torch.equal(got[k], want[k]),
                  f"rs B={len(words)}: {k} differs from the plain version")
    check(got["ok"].dtype == torch.bool, "rs: ok is not torch.bool")
    outcomes = torch.unique(want["n_corrected"]).tolist()
    check(outcomes == [-1, 0, 1], f"rs: outcomes {outcomes}")
    # entries outside {0, 1} (the reference's algorithm in the kernel),
    # alone and among {0, 1} words, and int64 / bool bits (cast to int32
    # as the reference casts them)
    odd = rs_out_of_domain_words(rng)
    mixed = np.concatenate([odd, full])
    mixed = mixed[rng.permutation(len(mixed))]
    w64 = odd.astype(np.int64)
    odd_cases = {"int32": odd, "mixed": mixed,
                 "int64": w64 + (1 << 32) * np.sign(w64), "bool": odd != 0}
    for what, words in odd_cases.items():
        bits = torch.as_tensor(words).to(dev)
        got = rs.rs_decode_cuda(bits)
        want = rs.rs_decode_plain(bits)
        torch.cuda.synchronize()
        for k in want:
            check(got[k].dtype == want[k].dtype and
                  torch.equal(got[k], want[k]),
                  f"rs {what} words outside {{0, 1}} (B={len(words)}): {k} "
                  f"differs from the plain version")
    big_ms = call_ms(lambda: rs.rs_decode_cuda(bits), reps=10)
    big_bound, _ = rs_bound(len(bits))
    bits = torch.as_tensor(cases[0]).to(dev)
    ops.reset_launch_counts()
    ops.rs_decode(bits)
    n = ops.launch_counts()["rs_decode"]
    check(n == 1, f"rs: one call counted {n} launches")
    times = timings(lambda: rs.rs_decode_cuda(bits),
                    lambda: rs.rs_decode_plain(bits), plain_iters=5)
    bound_ms, by = rs_bound(len(bits))
    r = _build.registers_of(regs, RS_KERNEL)
    check(r is not None and r[1] == r[2] == r[3] == 0,
          f"rs: ptxas -v shows a stack frame or spills: {r}")
    print(f"rs_decode ({RS_KERNEL}) on {card}: equal to the plain version "
          f"on {', '.join(str(len(c)) for c in cases)} words and on "
          f"{len(odd)} words with entries outside {{0, 1}} (int32, int64, "
          f"bool bits; and {len(mixed)} mixed with {{0, 1}} words); B=32: "
          f"{times['ms']:.4f} ms a call, bound {bound_ms:.3g} ms ({by}), plain "
          f"{times['plain_ms']:.4f} ms; registers {r[0]}, stack {r[3]} B "
          f"(cumulative, with the out-of-{{0, 1}} path: {r[4]} B), spill "
          f"stores {r[1]} B, spill loads {r[2]} B; B={len(cases[-1])}: "
          f"{big_ms:.4f} ms a launch, bound {big_bound:.3g} ms")
    return dict(max_abs_err=0.0, bound_ms=bound_ms, bound_by=by,
                library_ms=None, kernel=RS_KERNEL, registers=r[0],
                stack_bytes=r[3], cumulative_stack_bytes=r[4],
                spill_bytes=r[1] + r[2],
                large_b=dict(b=len(cases[-1]), ms=big_ms,
                             bound_ms=big_bound), **times)


def rs_device_ms(dev, rng, card: str, calls: int = 20):
    """``calls`` calls of the RS wrapper at B = 32 under the profiler:
    every device kernel they launch must be the RS kernel (no cast kernel
    after it); returns its device ms per launch, or None where the
    profiler saw no device time.  Run after the main path's profiled
    pass, whose launch counts are checked: a later profiler session in
    the process can miss its first few device events (a primer of torch's
    spin kernel comes first, left out), so the launches are read and
    reported here, not required to equal ``calls``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import rs_decode as rs
    bits = torch.as_tensor(rs_words(rng, 1, 8)[:32]).to(dev)
    rs.rs_decode_cuda(bits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(calls):
            rs.rs_decode_cuda(bits)
        torch.cuda.synchronize()
    traced = {e.key: (e.count, e.self_device_time_total / 1e3 / e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count and
              "spin_kernel" not in e.key}
    if not sum(ms for _, ms in traced.values()):
        print("rs_decode: the profiler saw no device time (not measured)")
        return None
    check(len(traced) == 1 and RS_KERNEL in next(iter(traced)) and
          0 < next(iter(traced.values()))[0] <= calls,
          f"rs: {calls} calls launched {traced}, expected {RS_KERNEL} "
          f"and nothing else")
    n, ms = next(iter(traced.values()))
    print(f"rs_decode: {calls} calls at B=32 traced {n} device kernel "
          f"launches, all {RS_KERNEL}, {ms:.4f} ms each on {card}")
    return ms


# -- phase 3f: the escalation plan kernel ---------------------------------
PLAN_KERNEL = "escalation_plan_kernel"
# integer ops of one Threefry-2x32 block: 20 rounds of an add, a rotate
# and a xor, five key injections of three adds, the start's two adds and
# the key parity's two xors
THREEFRY_OPS = 20 * 3 + 5 * 3 + 4
# the mixed cells' plan: a batch of 256 images (of which ~192 escalate),
# random_grid, tile 64 (16 cells), k = 3
PLAN_SHAPE = dict(n=256, strategy="random_grid", hw=(256, 256), tile=64,
                  k=3)


def plan_bound(n: int, cells: int, k: int):
    """The least time of a ``random_grid`` plan of ``n`` rows, k > 1: a
    row needs randint's four Threefry blocks, fold_in's one, and each
    sort round's split (two) and ``cells`` bit draws, and a sort of
    ``cells`` words (cells * log2(cells) compares, three ops each), at
    the int32 ALU peak; its bytes are the keys read and the plan
    written."""
    import math
    from repro_torch.core import prng
    rounds = prng.permutation_rounds(cells)
    ops = n * ((5 + rounds * (2 + cells)) * THREEFRY_OPS
               + rounds * 3 * cells * math.ceil(math.log2(cells)))
    return bound(n * 16 + n * k * 8, ops, PEAK_INT32_S)


def aten_calls(fn) -> int:
    """The ``aten::`` operators (nested ones included) one call of
    ``fn`` runs on the host, read from ``torch.profiler``'s CPU
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name.startswith("aten::"))


def phase_tile_plan(dev, card: str, regs: dict) -> dict:
    """The escalation plan kernel against its plain version,
    ``tiling.escalation_offsets`` on the same keys on the CPU, bit for
    bit: every strategy, ``random_grid`` at tile 32, 64 and 128 on 256
    images at every k up to the cap, two sort rounds in shared memory
    (4,096 cells) and in the scratch buffer (65,536 cells), 1, 192 and
    1,000 rows, keys with the words 0 and 0xFFFFFFFF; an int32
    contiguous plan on the keys' device and one launch counted a call.
    At the mixed cells' shape (``PLAN_SHAPE``): call ms (the keys'
    pageable copy and the launch, as the registry calls it; CUDA
    events), host us a call, device ms a launch (profiled), the plain
    version's ms on the host (the path the kernel replaced), the bound,
    the ``aten::`` operators a call of each, registers and spills (none
    allowed)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tiling
    from repro_torch.kernels import _build, ops
    rng = np.random.default_rng(28)

    def keys_of(n: int):
        w = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64)
        m = min(n, 3)
        w[:m] = np.array([(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                          (0, 0xFFFFFFFF)], np.uint64)[:m]
        return torch.as_tensor(w.astype(np.int64))

    full = (256, 256)
    cases = [("random_grid", full, 32, range(1, 65), (1, 192)),
             ("random_grid", full, 64, range(1, 17), (1, 192, 1000)),
             ("random_grid", full, 128, range(1, 5), (1, 192, 1000)),
             ("random", full, 64, (1, 2, 3, 8), (1, 192, 1000)),
             ("fixed", full, 64, range(1, 17), (1, 192)),
             ("random_grid", (128, 128), 2, (2, 5), (3,)),
             ("random_grid", (512, 512), 2, (2,), (3,))]
    checked = 0
    for strategy, hw, tile, ks, ns in cases:
        for n in ns:
            keys = keys_of(n)
            kd = keys.to(dev)
            for k in ks:
                ops.reset_launch_counts()
                got = ops.escalation_plan(strategy, kd, hw, tile, k)
                torch.cuda.synchronize()
                want = tiling.escalation_offsets(strategy, keys, hw, tile, k)
                check(got.dtype == torch.int32 and got.is_contiguous() and
                      got.device == kd.device and
                      torch.equal(got.cpu(), want),
                      f"escalation plan {strategy} {hw}/{tile} n={n} k={k}: "
                      f"differs from the plain version")
                check(ops.launch_counts()["escalation_plan"] == 1,
                      f"escalation plan: one call counted "
                      f"{ops.launch_counts()['escalation_plan']} launches")
                checked += 1
    sh = PLAN_SHAPE
    geo = (sh["hw"], sh["tile"], sh["k"])
    keys = keys_of(sh["n"])

    def call():
        return ops.escalation_plan(sh["strategy"],
                                   keys.to(dev, non_blocking=True), *geo)

    ms = call_ms(call)
    host = []
    for _ in range(200):
        t0 = time.perf_counter()
        call()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    plain = []
    for _ in range(20):
        t0 = time.perf_counter()
        tiling.escalation_offsets(sh["strategy"], keys, *geo)
        plain.append(time.perf_counter() - t0)
    kd = keys.to(dev)
    ops.escalation_plan(sh["strategy"], kd, *geo)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(20):
            ops.escalation_plan(sh["strategy"], kd, *geo)
        torch.cuda.synchronize()
    traced = [(e.count, e.self_device_time_total / 1e3 / e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count and
              PLAN_KERNEL in e.key]
    device_ms = traced[0][1] if traced else None
    cells = (sh["hw"][0] // sh["tile"]) * (sh["hw"][1] // sh["tile"])
    bound_ms, by = plan_bound(sh["n"], cells, sh["k"])
    calls = {"kernel": aten_calls(call), "plain": aten_calls(
        lambda: tiling.escalation_offsets(sh["strategy"], keys, *geo))}
    r = _build.registers_of(regs, PLAN_KERNEL)
    check(r is not None and r[1] == r[2] == 0,
          f"escalation plan: ptxas -v shows spills: {r}")
    out = dict(max_abs_err=0.0, ms=ms, plain_ms=statistics.median(plain) *
               1e3, host_us=statistics.median(host) * 1e6,
               device_ms=device_ms, bound_ms=bound_ms, bound_by=by,
               library_ms=None, kernel=PLAN_KERNEL, registers=r[0],
               stack_bytes=r[3], spill_bytes=r[1] + r[2],
               aten_calls=calls, plans_checked=checked, shape=sh)
    print(f"escalation_plan ({PLAN_KERNEL}) on {card}: equal to the plain "
          f"version on {checked} plans; at {sh['n']} rows, {sh['strategy']} "
          f"{cells} cells, k={sh['k']}: {ms:.4f} ms a call, host "
          f"{out['host_us']:.1f} us a call, device {device_ms} ms a launch, "
          f"bound {bound_ms:.3g} ms ({by}), plain on the host "
          f"{out['plain_ms']:.3f} ms; aten ops a call {calls['kernel']} "
          f"(plain {calls['plain']}); registers {r[0]}, stack {r[3]} B, "
          f"spills {r[1] + r[2]} B")
    return out


# -- phase 4: the main path through the serve launcher ---------------------
def phase_end_to_end(card: str):
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import fused_extractor as fx
    from repro_torch.kernels import fused_tile_preprocess as ftp
    from repro_torch.kernels import ops, rs_decode as rs
    from repro_torch.launch import serve as serve_lib
    args = serve_lib.parse_args(["--batches", "3", "--batch", "32",
                                 "--img", "256", "--tile", "64",
                                 "--device", "cuda"])
    pipe = serve_lib.build_pipeline(args)
    sample, batches = serve_lib.make_batches(args)
    serve_lib.warm_up(pipe, sample)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep, results = serve_lib.serve(pipe, batches)
    counts = ops.launch_counts()
    kernel_counts = ops.kernel_launch_counts()
    print(f"end-to-end: launches {json.dumps(counts)}")
    main_path = ("fused_tile_preprocess", "fused_extractor", "rs_decode")
    check(all(counts[k] == len(batches) for k in main_path) and
          sum(counts.values()) == len(batches) * len(main_path),
          f"the default path did not launch its three kernels once per "
          f"batch: {counts}")
    check(rep.images == 96, f"served {rep.images} images, expected 96")
    for r in results:
        check(r["logits"].shape == (32, 60) and
              np.isfinite(r["logits"]).all(), "bad logits")
        check(r["message_bits"].shape == (32, 48) and
              set(np.unique(r["message_bits"])) <= {0, 1}, "bad bits")
    # replay batch 0 through the plain versions on the card
    st, cfg = pipe.stages, pipe.cfg
    keys = st.image_keys(st.batch_key(0), 32)
    offs = tiling.tile_first_offsets(cfg.strategy, keys,
                                     img_size=cfg.img_size, tile=cfg.tile)
    raw = st.to_device(batches[0])
    tiles = ftp.fused_tile_preprocess_plain(
        raw, offs.to(raw.device), resize=cfg.resize_src, crop=cfg.img_size,
        tile=cfg.tile)
    logits = fx.fused_extractor_plain(tiles, st.packed_params)
    want = rs.rs_decode_plain((logits > 0).to(torch.int32))
    got = results[0]
    ref = logits.cpu().numpy()
    check(np.abs(got["logits"] - ref).max() <= logit_tol(ref),
          "end-to-end logits differ from the plain replay")
    margined = np.abs(ref).min(axis=1) > 10 * logit_tol(ref)
    for k in ("message_bits", "ok", "n_corrected"):
        check((got[k][margined] == want[k].cpu().numpy()[margined]).all(),
              f"end-to-end {k} differs from the plain replay")
    print(f"end-to-end: {rep.images} images in {rep.wall_s:.4f} s = "
          f"{rep.throughput_ips:.1f} images/s on {card} (3 batches of 32, "
          f"tile 64, img 256, raw 288, C=64 D=7; "
          f"{int(margined.sum())}/32 margined rows exact vs plain replay)")
    return counts, kernel_counts, pipe, batches, results


def phase_throughput(pipe, batches, card: str, windows: int = 3,
                     reps: int = 34) -> list:
    """Images/s of the serve loop over longer windows: each window sends
    the 3 batches of the end-to-end phase ``reps`` times (102 batches of
    32, seconds long), each batch under its own stream key."""
    from repro_torch.launch import serve as serve_lib
    ips = []
    for w in range(windows):
        rep, _ = serve_lib.serve(pipe, batches * reps)
        ips.append(rep.throughput_ips)
        print(f"throughput window {w}: {rep.images} images in "
              f"{rep.wall_s:.4f} s = {rep.throughput_ips:.1f} images/s on "
              f"{card}")
    return ips


PROFILED: dict = {}   # profile name -> wall and device busy ms of its pass


def profile_path(pipe, batches, card: str, name: str = "serve", key=None):
    """One more pass over the batches under ``torch.profiler``: device
    busy time by kernel against the wall time (the profiler's own host
    cost inflates the wall, so the idle share is an upper bound).  The
    trace goes to build/chip_smoke/<name>_trace.json.  ``key``, where
    given, is every batch's key (else the stream's keys).  Returns (launches,
    device ms in all) per device kernel name (spaces removed), or None
    where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.core import prng
    torch.cuda.synchronize()
    # a later session in the process can miss its first few device events:
    # a warm-up step (traced, then discarded) runs the path once on the
    # first batch under a fixed key (the batch counter does not move), and
    # only the step after it makes the rows below
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        pipe.detect_batch(batches[0], key=prng.key(0) if key is None
                          else key)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for raw in batches:
            pipe.detect_batch(raw, key=key)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
    quant = [e.key for e in rows if "quantize" in e.key]
    check(not quant, f"profile {name}: a quantize pass ran: {quant}")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    PROFILED[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                          batches=len(batches))
    prof.export_chrome_trace(str(OUT / f"{name}_trace.json"))
    if busy_ms == 0:
        print(f"profile {name}: the profiler saw no device time "
              f"(not measured)")
        return None
    print(f"profile {name}: {len(batches)} batches, wall {wall_ms:.3f} ms, "
          f"device "
          f"busy {busy_ms:.3f} ms, idle share <= "
          f"{1 - busy_ms / wall_ms:.3f} on {card}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    return {e.key.replace(" ", ""): (e.count, e.self_device_time_total / 1e3)
            for e in rows}


def decode_device_ms(traced, n_batches: int):
    """Device ms a batch of the decode's CUDA kernels (convs, to_bits,
    head) in a profiled pass, or None where none was traced (the plain
    decode launches none of them)."""
    from repro_torch.kernels.fused_extractor import is_decode_kernel
    hits = [ms for k, (_, ms) in (traced or {}).items()
            if is_decode_kernel(k)]
    return sum(hits) / n_batches if hits else None


# -- phase 5: the other configurations through the serve launcher ---------
def serve_config(flags, batches, card: str, profile: str = ""):
    """Build the launcher's pipeline for ``flags`` at full width, warm it
    up, zero the counters, serve ``batches``; return (report, results,
    launch counts, launches per decode kernel, the profiled pass's
    launches per device kernel or None).  With ``profile``, one more pass
    runs under the profiler (device time by kernel) after the counted
    one."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    args = serve_lib.parse_args(["--batch", "32", "--img", "256",
                                 "--tile", "64", "--device", "cuda",
                                 *flags])
    pipe = serve_lib.build_pipeline(args)
    try:
        sample, _ = serve_lib.make_batches(args)
        serve_lib.warm_up(pipe, sample)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rep, results = serve_lib.serve(pipe, batches)
        counts = ops.launch_counts()
        kernel_counts = ops.kernel_launch_counts()
        traced = profile_path(pipe, batches, card, profile) if profile \
            else None
    finally:
        pipe.close()
    print(f"serve {' '.join(flags)}: {rep.images} images in "
          f"{rep.wall_s:.4f} s = {rep.throughput_ips:.1f} images/s on "
          f"{card}; launches {json.dumps(counts)}")
    return rep, results, counts, kernel_counts, traced


def check_blocked_int8_launches(kernel_counts, traced, n_batches: int):
    """The ``--decode-dtype int8 --schedule SERVE_SCHEDULE`` run's decode
    kernels (``ops.kernel_launch_counts``): 9 a batch, the blocked layer 0
    once, the blocked 64 -> 64 conv depth - 1 times, the flat to_bits and
    the head once, no quantize pass; where its profiled pass saw device
    time, its trace shows each as often."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fused_extractor as fx
    C, r = WIDTH["channels"], fx.INT8
    ct = at.Schedule.from_string(SERVE_SCHEDULE).channel_tile or C
    want = {fx.conv_kernel_name(r, 3, C, ct): n_batches,
            fx.conv_kernel_name(r, C, C, ct): (WIDTH["depth"] - 1) * n_batches,
            fx.to_bits_kernel_name(r, C, WIDTH["n_bits"]): n_batches,
            fx.head_kernel_name(r, WIDTH["n_bits"]): n_batches}
    check(kernel_counts == want and
          sum(want.values()) == (WIDTH["depth"] + 2) * n_batches,
          f"int8 at {SERVE_SCHEDULE}: decode kernels launched "
          f"{kernel_counts}, expected {want}")
    for kernel, count in want.items():
        seen = sum(c for k, (c, _) in (traced or {}).items()
                   if f"::{kernel}(" in k)
        check(not traced or seen == count,
              f"{kernel}: the int8 {SERVE_SCHEDULE} pass traced {seen} "
              f"launches, the counter {count}")
    print(f"int8 at {SERVE_SCHEDULE}, {n_batches} batches: "
          f"{WIDTH['depth'] + 2} decode kernels a batch, no quantize pass "
          f"{json.dumps(want)}"
          + ("; the profiled pass traced the same" if traced else ""))


def phase_configs(batches, default_results, default_ips, cache, winner,
                  winner8, card: str, parts8):
    """Each configuration of the second slice on the default path's 3
    batches of 32: launch counts per batch, and its results against the
    default path's (the same keys: batch k of each stream).
    ``default_ips`` is the default path's median window (images/s), the
    qrmark side of the ratios to the sequential baseline.  The int8
    configuration's run sets ``parts8``' launches
    (:func:`check_part_launches`: its decode kernels, matched to its
    profiled pass, and no quantize pass), the blocked int8 run's are
    checked by :func:`check_blocked_int8_launches`."""
    n = len(batches)
    zero = dict(fused_tile_preprocess=0, fused_preprocess=0,
                fused_extractor=0, fused_extractor_blocked=0, rs_decode=0,
                escalation_plan=0)
    auto_kernel = ("fused_extractor" if winner is None
                   else "fused_extractor_blocked")
    auto8_kernel = ("fused_extractor" if winner8 is None
                    else "fused_extractor_blocked")
    configs = [
        ("staged", ["--staged-ingest"],
         dict(fused_preprocess=n, fused_extractor=n, rs_decode=n), "exact"),
        ("auto", ["--schedule", "auto", "--autotune-cache", str(cache)],
         {"fused_tile_preprocess": n, auto_kernel: n, "rs_decode": n},
         "exact"),
        ("blocked", ["--schedule", SERVE_SCHEDULE],
         dict(fused_tile_preprocess=n, fused_extractor_blocked=n,
              rs_decode=n), "exact"),
        ("cpu_pool", ["--rs-mode", "cpu_pool"],
         dict(fused_tile_preprocess=n, fused_extractor=n), "host-rs"),
        ("tiled", ["--mode", "tiled"], dict(rs_decode=n), None),
        ("sequential", ["--mode", "sequential", "--rs-mode", "cpu_sync"],
         {}, None),
        # the paper's baseline decode with the device RS, to split the
        # baseline's time between its decode and its host RS
        ("sequential-device", ["--mode", "sequential"], dict(rs_decode=n),
         None),
        # the lower rungs on the default path, and int8 on the schedule
        # its own sweep picked
        ("bf16", ["--decode-dtype", "bf16"],
         dict(fused_tile_preprocess=n, fused_extractor=n, rs_decode=n),
         "rung"),
        ("bf16-blocked", ["--decode-dtype", "bf16", "--schedule",
                          SERVE_SCHEDULE],
         dict(fused_tile_preprocess=n, fused_extractor_blocked=n,
              rs_decode=n), "rung"),
        ("int8", ["--decode-dtype", "int8"],
         dict(fused_tile_preprocess=n, fused_extractor=n, rs_decode=n),
         "rung"),
        ("int8-auto", ["--decode-dtype", "int8", "--schedule", "auto",
                       "--autotune-cache", str(cache)],
         {"fused_tile_preprocess": n, auto8_kernel: n, "rs_decode": n},
         "rung"),
        ("int8-blocked", ["--decode-dtype", "int8", "--schedule",
                          SERVE_SCHEDULE],
         dict(fused_tile_preprocess=n, fused_extractor_blocked=n,
              rs_decode=n), "rung"),
    ]
    out = {}
    for name, flags, want, relation in configs:
        rep, results, counts, kernel_counts, traced = serve_config(
            flags, batches, card,
            profile=name if name in ("staged", "blocked",
                                     "sequential-device", "bf16",
                                     "bf16-blocked", "int8", "int8-auto",
                                     "int8-blocked") else "")
        if name == "int8":
            check_part_launches(parts8, kernel_counts, traced, n,
                                path="--decode-dtype int8 path")
        if name == "int8-blocked":
            check_blocked_int8_launches(kernel_counts, traced, n)
        check(counts == {**zero, **want},
              f"{name}: launches {counts}, expected {({**zero, **want})}")
        check(rep.images == 32 * n, f"{name}: served {rep.images} images")
        for r, d in zip(results, default_results):
            check(r["logits"].shape == (32, 60) and
                  np.isfinite(r["logits"]).all(), f"{name}: bad logits")
            if relation == "exact":
                for k in ("logits", "message_bits", "ok", "n_corrected"):
                    check(np.array_equal(r[k], d[k]),
                          f"{name}: {k} differs from the tile-first path")
            elif relation == "host-rs":
                check(np.array_equal(r["logits"], d["logits"]) and
                      np.array_equal(r["ok"], d["ok"]) and
                      not r["n_corrected"].any(),
                      f"{name}: differs from the device-RS path")
                ok = d["ok"]
                check(np.array_equal(r["message_bits"][ok],
                                     d["message_bits"][ok]),
                      f"{name}: messages differ where ok")
            elif relation == "rung":
                sure = np.abs(d["logits"]) > RUNG_MARGIN
                check(np.array_equal((r["logits"] > 0)[sure],
                                     (d["logits"] > 0)[sure]),
                      f"{name}: a bit differs from the fp32 path where "
                      f"|logit| > {RUNG_MARGIN}")
                rows = sure.all(axis=1)
                for k in ("message_bits", "ok", "n_corrected"):
                    check(np.array_equal(r[k][rows], d[k][rows]),
                          f"{name}: {k} differs from the fp32 path on a "
                          f"margined row")
        # a blocked schedule serves its rung's flat bits
        flat_of = {"int8-auto": "int8", "int8-blocked": "int8",
                   "bf16-blocked": "bf16"}.get(name)
        if flat_of:
            for r, f in zip(results, out[flat_of]["results"]):
                for k in ("logits", "message_bits", "ok", "n_corrected"):
                    check(np.array_equal(r[k], f[k]),
                          f"{name}: {k} differs from {flat_of} on the flat "
                          f"schedule")
        out[name] = dict(images_per_s=rep.throughput_ips, launches=counts,
                         flags=flags,
                         decode_device_ms=decode_device_ms(traced, n))
        if name == "staged":  # the staged ingest's device ms a launch
            hits = [v for k, v in (traced or {}).items()
                    if f"::{INGEST_KERNEL}(" in k]
            out[name]["ingest_device_ms"] = (hits[0][1] / hits[0][0]
                                             if hits else None)
        if out[name]["decode_device_ms"] is not None:
            print(f"  {name}: the decode's kernels take "
                  f"{out[name]['decode_device_ms']:.4f} ms of device time "
                  f"a batch in the profiled pass, on {card}")
        if relation == "rung":
            dev_ = max(float(np.abs(r["logits"] - d["logits"]).max())
                       for r, d in zip(results, default_results))
            sure = np.concatenate([np.abs(d["logits"]) > RUNG_MARGIN
                                   for d in default_results])
            out[name].update(results=results, max_dev_vs_fp32=dev_)
            print(f"  {name}: max |logit - fp32 logit| {dev_:.4g}; bits "
                  f"equal to fp32's on the {int(sure.sum())} of "
                  f"{sure.size} with |fp32 logit| > {RUNG_MARGIN}; "
                  f"{int(sure.all(axis=1).sum())} rows margined whole")
    for name in ("bf16", "bf16-blocked", "int8", "int8-auto", "int8-blocked"):
        del out[name]["results"]
    for name in ("sequential", "sequential-device"):
        ips = out[name]["images_per_s"]
        print(f"qrmark {default_ips:.1f} images/s (median of the 102-batch "
              f"windows) vs {name} {ips:.1f} images/s (3 batches) = "
              f"{default_ips / ips:.2f}x, batches of 32 at full width, on "
              f"{card}")
    return out


# -- phase 5: golden JAX outputs ------------------------------------------
def phase_golden():
    from repro_torch.core import tiling
    from repro_torch.core.detect import DetectionConfig, DetectionPipeline
    from repro_torch.data.pipeline import synth_image
    g = np.load(GOLDEN)
    params = golden_params(int(g["seed"]), float(g["margin"]))
    raw = np.stack([synth_image(int(i), RAW) for i in g["image_ids"]])
    outs = {}
    for prefix in ("", "staged_"):
        pipe = DetectionPipeline(DetectionConfig(**FULL,
                                                 tile_first=not prefix),
                                 params, device="cuda")
        out = pipe.detect_batch(raw)            # key fold_in(key(0), 0)
        keys = pipe.stages.image_keys(pipe.stages.batch_key(0),
                                      raw.shape[0])
        offs = tiling.tile_first_offsets("random_grid", keys, img_size=256,
                                         tile=64).numpy()
        check((offs == g["offsets"]).all(), "golden offsets differ")
        ref = g[prefix + "logits"]
        e = float(np.abs(out["logits"] - ref).max())
        check(e <= logit_tol(ref), f"golden {prefix}logits: max |err| {e}")
        margined = np.abs(ref).min(axis=1) > 10 * logit_tol(ref)
        check(margined.any(), "no margined golden row")
        for k in ("message_bits", "ok", "n_corrected"):
            check((out[k][margined] == g[prefix + k][margined]).all(),
                  f"golden {prefix}{k} differs on a margined row")
        print(f"golden {prefix or 'tile-first '}path: "
              f"{int(margined.sum())}/{len(ref)} margined rows exact, "
              f"logits max |err| {e:.3g} (tol {logit_tol(ref):.3g}), ok "
              f"{out['ok'].astype(int).tolist()}, n_corrected "
              f"{out['n_corrected'].tolist()}")
        outs[prefix] = out
    check(np.array_equal(outs[""]["logits"], outs["staged_"]["logits"]),
          "golden: staged logits differ from tile-first logits on the card")
    for dtype in RUNGS:
        prefix = dtype + "_"
        pipe = DetectionPipeline(DetectionConfig(**FULL, decode_dtype=dtype),
                                 params, device="cuda")
        out = pipe.detect_batch(raw)
        ref = g[prefix + "logits"]
        e = float(np.abs(out["logits"] - ref).max())
        check(e <= RUNG_ATOL, f"golden {dtype} logits: max |err| {e}")
        margined = np.abs(ref).min(axis=1) > RUNG_ATOL
        check(margined.any(), f"no margined golden {dtype} row")
        # and the fp32 path's decisions where the fp32 logits clear the
        # rungs' margin
        sure = np.abs(g["logits"]).min(axis=1) > RUNG_MARGIN
        check(sure.any(), f"no golden row clears {RUNG_MARGIN}")
        for k in ("message_bits", "ok", "n_corrected"):
            check((out[k][margined] == g[prefix + k][margined]).all(),
                  f"golden {dtype} {k} differs on a margined row")
            check((out[k][sure] == g[k][sure]).all(),
                  f"golden {dtype} {k} differs from the fp32 decision")
        print(f"golden {dtype}: {int(margined.sum())}/{len(ref)} margined "
              f"rows exact, {int(sure.sum())} rows equal to the fp32 path's "
              f"RS outputs, logits max |err| {e:.3g} (tol {RUNG_ATOL})")


# -- phase 6: adaptive escalation ------------------------------------------
ESC_K = 3               # an image's tile budget
ESC_RMS = 6.0           # the watermark's RMS, raw 0..255 units
ESC_SIGMA = 90.0        # noise on the tile round 1 picks
# mean |logit| floor of the margin check: a numpy model of the
# correlation path at full width puts flat-filled tiles below 0.015 and
# clean ones above 1.28
ESC_MARGIN = 0.5
ESC_DAMAGED = tuple(range(0, 22, 2))   # 11 of 32 rows: ragged rounds
ESC_KEY = 5
ESC_FIELDS = ("message_bits", "ok", "n_corrected", "logits")
RS_CODES = ((4, 15, 11), (8, 32, 24))  # torch_rs on the card


def esc_workload(geo: dict, width: dict, raw_hw: int, b: int,
                 rms: float = ESC_RMS):
    """A corr-only detector (full width, head weights zeroed: every conv
    still runs, the logits come from the correlation bank), a random
    48-bit message, and ``b`` synthetic raw float images with the bank's
    patterns, signed by the message's RS codeword and scaled to RMS
    ``rms``, added to every tile cell of the centre crop."""
    from repro_torch.core.extractor import init_extractor_numpy
    from repro_torch.core.rs.codec import DEFAULT_CODE, rs_encode
    from repro_torch.data.pipeline import synth_image
    p = init_extractor_numpy(0, tile=geo["tile"], **width)
    p["head"]["w"] = p["head"]["w"] * 0.0
    msg = np.random.default_rng(0).integers(0, 2, DEFAULT_CODE.message_bits)
    cw = rs_encode(DEFAULT_CODE, msg)
    wm = np.tensordot((2.0 * cw - 1.0).astype(np.float32), p["corr"], axes=1)
    wm *= rms / np.sqrt(np.mean(wm * wm))
    t, img = geo["tile"], geo["img_size"]
    o = (raw_hw - img) // 2
    raw = np.stack([synth_image(i, raw_hw) for i in range(b)]).astype(
        np.float32)
    for y in range(o, o + img, t):
        for x in range(o, o + img, t):
            raw[:, y:y + t, x:x + t] += wm
    return p, msg, raw


def esc_damage(raw, offs, rows, tile: int, sigma=None, fill=None):
    """uint8 images with Gaussian noise (``sigma``) or a flat ``fill`` on
    the tile at raw offsets ``offs[i]`` of each row in ``rows``."""
    rng = np.random.default_rng(1)
    out = raw.copy()
    for i in rows:
        y, x = offs[i]
        if fill is not None:
            out[i, y:y + tile, x:x + tile] = fill
        else:
            out[i, y:y + tile, x:x + tile] += rng.normal(0.0, sigma,
                                                         (tile, tile, 3))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def plain_escalation(st, raw, keys) -> dict:
    """Escalation replayed through the plain versions on ``raw``'s
    device: every plan column's tiles and logits for every row, then the
    rounds (RS failure, or mean |sum| below the margin, on the host), the
    sums in round order.  ``thin`` marks rows where some sum a decision
    read had an |entry| within 10x the comparison's tolerance."""
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import fused_extractor as fx
    from repro_torch.kernels import fused_tile_preprocess as ftp
    from repro_torch.kernels import rs_decode as rs
    cfg, k, margin = st.cfg, st.policy.max_tiles, st.policy.margin
    b = raw.shape[0]
    plan = tiling.escalation_offsets(cfg.strategy, keys, (cfg.img_size,) * 2,
                                     cfg.tile, k).to(raw.device)
    rounds = [fx.fused_extractor_plain(ftp.fused_tile_preprocess_plain(
        raw, plan[:, r].contiguous(), resize=cfg.resize_src,
        crop=cfg.img_size, tile=cfg.tile), st.packed_params)
        for r in range(k)]
    acc = rounds[0].clone()
    out = {n: v.clone() for n, v in rs.rs_decode_plain(
        (acc > 0).to(torch.int32)).items()}
    used = np.ones(b, np.int32)
    smallest = acc.abs().min(dim=1).values.cpu().numpy()

    def wants(ok, sums):
        need = ~ok.cpu().numpy()
        if margin > 0.0:
            need |= np.abs(sums.cpu().numpy()).mean(axis=-1) < margin
        return need

    need = wants(out["ok"], acc)
    for r in range(1, k):
        idx = np.nonzero(need)[0]
        if not idx.size:
            break
        i = torch.as_tensor(idx, device=raw.device)
        acc[i] = acc[i] + rounds[r][i]
        o = rs.rs_decode_plain((acc[i] > 0).to(torch.int32))
        for n in out:
            out[n][i] = o[n]
        used[idx] = r + 1
        smallest[idx] = np.minimum(smallest[idx], acc[i].abs().min(
            dim=1).values.cpu().numpy())
        need = np.zeros(b, bool)
        need[idx] = wants(o["ok"], acc[i])
    res = {n: out[n].cpu().numpy() for n in ("message_bits", "ok",
                                             "n_corrected")}
    return dict(res, logits=acc.cpu().numpy(), tiles_used=used,
                smallest=smallest)


def hold_to_plain(got: dict, ref: dict, tol: float, k: int,
                  what: str) -> int:
    """Logits within ``tol``; integers and tiles_used exact on every row
    whose decisions read sums clear of 10x the larger of the observed
    deviation and k x the fp32 tolerance (at fp32: 10x ``tol``).
    Returns that row count."""
    e = float(np.abs(got["logits"] - ref["logits"]).max())
    check(e <= tol, f"{what}: logits differ from the plain replay by {e} "
          f"> {tol}")
    sure = ref["smallest"] > 10 * max(e, k * logit_tol(ref["logits"]))
    for n in ("message_bits", "ok", "n_corrected", "tiles_used"):
        check(np.array_equal(got[n][sure], ref[n][sure]),
              f"{what}: {n} differs from the plain replay on a margined row")
    return int(sure.sum())


def esc_tol(st, logits) -> float:
    """k x the rung's logit tolerance (1e-4 (1 + max|logit|) at fp32)."""
    k = st.policy.max_tiles
    if st.cfg.decode_dtype == "fp32":
        return k * logit_tol(logits)
    return k * RUNG_ATOL


def count_syncs(fn) -> dict:
    """Synchronizing CUDA calls ``fn`` makes, as torch's sync debug mode
    reports them (a D2H copy, a blocking H2D copy, a wait on the
    stream): {"n": count, "at": {"file:line": count}} by the Python line
    that made each."""
    import collections
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    at = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                             for w in seen if "synchroniz" in str(w.message))
    return {"n": sum(at.values()), "at": dict(at)}


def esc_ips(pipe, raw, key, n: int = 20) -> float:
    """Images/s of ``n`` detect_batch calls on one host batch under one
    key (its damaged tiles are where that key's round 1 looks)."""
    import torch
    pipe.detect_batch(raw, key=key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        pipe.detect_batch(raw, key=key)
    return n * raw.shape[0] / (time.perf_counter() - t0)


def esc_checks(dev, geo=FULL, width=WIDTH, raw_hw=RAW, b=32,
               damaged=ESC_DAMAGED, rms=ESC_RMS) -> dict:
    """Checks 1-6 of the escalation phase on ``dev`` (the CPU runs them
    at a small size, without the launch counts): the workload, k = 1,
    k = 3 with its launches, the margin trigger, ``decode_all_keyed``
    against the rounds, and the plain replay."""
    import torch
    from repro_torch.core import prng, tiling
    from repro_torch.core.detect import DetectionConfig, DetectionPipeline
    from repro_torch.core.transforms import IMAGENET_MEAN, IMAGENET_STD
    from repro_torch.kernels import ops
    on_card = torch.device(dev).type == "cuda"
    p, msg, clean_f = esc_workload(geo, width, raw_hw, b, rms)
    t, img = geo["tile"], geo["img_size"]
    o = (raw_hw - img) // 2
    key = prng.key(ESC_KEY)

    def pipe(k=1, margin=0.0):
        return DetectionPipeline(DetectionConfig(
            **geo, escalate_tiles=k, escalate_margin=margin), p,
            ground_truth_bits=msg, device=dev)

    p1, p3, pm = pipe(), pipe(ESC_K), pipe(ESC_K, ESC_MARGIN)
    st = p3.stages
    keys = st.image_keys(key, b)
    offs = tiling.tile_first_offsets(geo.get("strategy", "random_grid"),
                                     keys, img_size=img, tile=t).numpy()
    rest = [i for i in range(b) if i not in damaged]
    clean = esc_damage(clean_f, offs + o, (), t)
    noised = esc_damage(clean_f, offs + o, damaged, t, sigma=ESC_SIGMA)
    flat = esc_damage(clean_f, offs + o, damaged, t, fill=128.0)

    # the 288 -> 288 resize is the identity: the ingested tile is the
    # watermarked raw pixels under the affine, so the watermark survives
    tiles = st.ingest_keyed(st.to_device(clean), keys).cpu().numpy()
    want = np.stack([clean[i, o + y:o + y + t, o + x:o + x + t]
                     for i, (y, x) in enumerate(offs)]).astype(np.float32)
    want = (want / np.float32(255.0) - IMAGENET_MEAN) / IMAGENET_STD
    e = float(np.abs(tiles - want).max())
    check(e <= INGEST_ATOL, f"escalation: the ingest is not the identity "
          f"resize on the watermark ({e})")

    # 1. one tile: the damaged rows fail, the clean rows match
    o1 = p1.detect_batch(noised, key=key)
    check("tiles_used" not in o1, "k = 1 reports tiles_used")
    check(o1["match"][list(damaged)].mean() <= 0.2 and
          o1["match"][rest].all(),
          f"k = 1: damaged rows match {o1['match'][list(damaged)].mean()}, "
          f"clean rows {o1['match'][rest].mean()}")

    # 2. three tiles, counted (6.)
    if on_card:
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    o3 = p3.detect_batch(noised, key=key)
    counts = ops.launch_counts()
    used = o3["tiles_used"]
    n_rounds = int(used.max()) - 1
    sub_batches = [int((used > r).sum()) for r in range(1, ESC_K)]
    check(o3["match"][list(damaged)].mean() >= 0.8,
          f"k = 3: damaged rows match {o3['match'][list(damaged)].mean()}")
    check(np.array_equal(used > 1, ~o1["ok"]),
          f"k = 3: tiles_used {used.tolist()} against round-1 ok "
          f"{o1['ok'].astype(int).tolist()}")
    stay = used == 1
    for n in ESC_FIELDS:
        check(np.array_equal(o3[n][stay], o1[n][stay]),
              f"k = 3: {n} of a row that did not escalate differs from k = 1")
    # one plan a batch that escalated, drawn by the plan kernel
    want_counts = dict(fused_tile_preprocess=1 + n_rounds,
                       fused_extractor=1 + n_rounds, rs_decode=1 + n_rounds,
                       escalation_plan=int(n_rounds > 0))
    want_counts = {n: c for n, c in want_counts.items() if c}
    if on_card:
        check({n: c for n, c in counts.items() if c} == want_counts,
              f"k = 3: launches {counts}, expected {want_counts}")

    # 3. the margin trigger on flat-filled round-1 tiles
    of1 = p1.detect_batch(flat, key=key)
    om = pm.detect_batch(flat, key=key)
    flat_mean = float(np.abs(of1["logits"][list(damaged)]).mean(axis=1).max())
    check((om["tiles_used"][list(damaged)] >= 2).all() and
          (om["tiles_used"][rest] == 1).all() and om["match"].all(),
          f"margin {ESC_MARGIN}: tiles_used {om['tiles_used'].tolist()}, "
          f"match {om['match'].astype(int).tolist()}")

    # 4. all k tiles at once == the rounds, bit for bit, counted
    raw_d = st.to_device(noised)
    if on_card:
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    all_k = st.decode_all_keyed(raw_d, keys)
    all_counts = ops.launch_counts()
    if on_card:
        check(all_counts["fused_tile_preprocess"] == 1 and
              all_counts["fused_extractor"] == 1,
              f"decode_all_keyed launches {all_counts}")
    check(torch.equal(all_k[:, 0], st.decode_keyed(
        st.ingest_keyed(raw_d, keys), keys)), "decode_all_keyed column 0 "
        "differs from round 1")
    for r in range(1, ESC_K):
        check(torch.equal(all_k[:, r], st.escalate_round(raw_d, keys, r)),
              f"decode_all_keyed column {r} differs from escalate_round")

    # 5. the plain replay
    ref = plain_escalation(st, raw_d, keys)
    tol = esc_tol(st, ref["logits"])
    n_sure = hold_to_plain(o3, ref, tol, ESC_K, "k = 3")
    return dict(p=p, msg=msg, key=key, pipes=(p1, p3), clean=clean,
                noised=noised, counts=counts, decode_all_counts=all_counts,
                sub_batches=sub_batches, rounds=n_rounds,
                tiles_used=used.tolist(), replay_rows_exact=n_sure,
                match_k1=float(o1["match"][list(damaged)].mean()),
                match_k3=float(o3["match"][list(damaged)].mean()),
                flat_round1_mean_abs_logit=flat_mean,
                margin_tiles_used=om["tiles_used"].tolist())


def esc_serve(flags, batches, card: str) -> dict:
    """The launcher's escalation on the end-to-end phase's stream:
    launches counted (1 + the batch's rounds per kernel a batch), batch 0
    held to the plain replay."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    args = serve_lib.parse_args(["--batch", "32", "--img", "256", "--tile",
                                 "64", "--device", "cuda", *flags])
    pipe = serve_lib.build_pipeline(args)
    sample, _ = serve_lib.make_batches(args)
    serve_lib.warm_up(pipe, sample)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep, results = serve_lib.serve(pipe, batches)
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    per = sum(1 + int(r["tiles_used"].max()) - 1 for r in results)
    plans = sum(int(r["tiles_used"].max() > 1) for r in results)
    want = dict(fused_tile_preprocess=per, fused_extractor=per,
                rs_decode=per, **({"escalation_plan": plans} if plans
                                  else {}))
    check(counts == want, f"serve {' '.join(flags)}: launches {counts}, "
          f"expected {want}")
    st = pipe.stages
    keys = st.image_keys(st.batch_key(0), 32)
    ref = plain_escalation(st, st.to_device(batches[0]), keys)
    n_sure = hold_to_plain(results[0], ref, esc_tol(st, ref["logits"]),
                           ESC_K, f"serve {' '.join(flags)}")
    used = np.concatenate([r["tiles_used"] for r in results])
    print(f"serve {' '.join(flags)}: {rep.images} images in "
          f"{rep.wall_s:.4f} s = {rep.throughput_ips:.1f} images/s on "
          f"{card}; launches {json.dumps(counts)}; tiles a batch "
          f"{[int(r['tiles_used'].sum()) for r in results]}; batch 0 "
          f"equals the plain replay ({n_sure}/32 rows exact)")
    return dict(images_per_s=rep.throughput_ips, launches=counts,
                tiles_used_mean=float(used.mean()),
                ok_share=float(np.mean([r["ok"].mean() for r in results])),
                replay_rows_exact=n_sure)


def rs_code_words(code, rng, n: int) -> np.ndarray:
    """``n`` words of ``code``: codewords with 0..t+2 symbol errors and
    uniform words, in turn."""
    import torch
    from repro_torch.core.rs import torch_rs
    m, nn, k = code.m, code.n, code.k
    cw = torch_rs.make_encoder(code)(torch.as_tensor(
        rng.integers(0, 2, (n, k * m)))).numpy()
    for i, row in enumerate(cw):
        n_err = i % (code.t + 4)
        if n_err == code.t + 3:
            row[:] = rng.integers(0, 2, nn * m)
            continue
        for pos in rng.choice(nn, n_err, replace=False):
            flip = int(rng.integers(1, 1 << m))
            row[pos * m:(pos + 1) * m] ^= (flip >> np.arange(m - 1, -1, -1)
                                           ) & 1
    return cw.astype(np.int32)


def esc_rs_and_attacks(dev, rng, card: str) -> dict:
    """Checks 8 and 9: ``torch_rs`` on the card equals its CPU run at the
    other codes (and the RS kernel equals it at the default code on every
    {0, 1} word of ``rs_words``), with call ms at B = 32 and 65,536; each
    ``ATTACKS`` entry on the card equals its CPU run within 1e-5, the
    jpeg elements beyond it only where a coefficient sits within 1e-4
    of a half-step."""
    import torch
    from repro_torch.core import transforms
    from repro_torch.core.rs import torch_rs
    from repro_torch.core.rs.codec import DEFAULT_CODE, RSCode
    from repro_torch.kernels import rs_decode as rs
    fields = ("message_bits", "codeword_bits", "n_corrected", "ok")
    out = {"rs_ms": {}}
    words = rs_words(rng, 16, 64)
    got = torch_rs.make_batch_decoder(DEFAULT_CODE)(
        torch.as_tensor(words).to(dev))
    want = rs.rs_decode_cuda(torch.as_tensor(words).to(dev))
    for n in fields:
        check(torch.equal(got[n], want[n]),
              f"torch_rs (4, 15, 12) {n} differs from the RS kernel")
    for mnk in ((4, 15, 12), *RS_CODES):
        code = RSCode(*mnk)
        dec = torch_rs.make_batch_decoder(code)
        w = rs_code_words(code, rng, 4096)
        cpu = dec(torch.as_tensor(w))
        card_ = dec(torch.as_tensor(w).to(dev))
        for n in fields:
            check(np.array_equal(card_[n].cpu().numpy(), cpu[n].numpy()),
                  f"torch_rs {mnk} {n}: the card differs from the CPU")
        check(set(np.unique(cpu["n_corrected"].numpy())) >=
              {-1, 0, code.t}, f"torch_rs {mnk}: outcomes not mixed")
        ms = {}
        for B in (32, 65536):
            wb = torch.as_tensor(w[np.arange(B) % len(w)]).to(dev)
            ms[f"torch_rs_{B}"] = call_ms(lambda: dec(wb), iters=10)
            if mnk == (4, 15, 12):
                ms[f"kernel_{B}"] = call_ms(lambda: rs.rs_decode_cuda(wb))
        out["rs_ms"]["-".join(map(str, mnk))] = ms
        print(f"torch_rs {mnk}: card == CPU on 4096 words; call ms "
              f"{json.dumps({k: round(v, 4) for k, v in ms.items()})} on "
              f"{card}")
    x = rng.normal(0.0, 1.0, (8, 256, 256, 3)).astype(np.float32)
    xc, xd = torch.as_tensor(x), torch.as_tensor(x).to(dev)
    errs = {}
    for name, fn in transforms.ATTACKS.items():
        a, c = fn(xc).numpy(), fn(xd).cpu().numpy()
        e = np.abs(a - c)
        errs[name] = float(e.max())
        if name != "jpeg_50":
            check(errs[name] <= INGEST_ATOL, f"attack {name}: card vs CPU "
                  f"{errs[name]}")
            continue
        sc = transforms.jpeg_coefficients(xc, 50)[0].numpy()
        near = np.abs(sc - np.floor(sc) - 0.5) < 1e-4
        block = np.repeat(np.repeat(near.any(axis=(2, 4)), 8, axis=1), 8,
                          axis=2)
        off = e > INGEST_ATOL
        check(not (off & ~block).any(), "attack jpeg_50: the card differs "
              "from the CPU away from a half-step")
        out["jpeg_half_steps"] = int(near.sum())
        out["jpeg_elements_off"] = int(off.sum())
    out["attack_max_abs_err"] = errs
    print(f"attacks on (8, 256, 256, 3): card vs CPU max |err| "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}; "
          f"jpeg_50: {out['jpeg_half_steps']} coefficients within 1e-4 of a "
          f"half-step, {out['jpeg_elements_off']} elements beyond "
          f"{INGEST_ATOL}")
    return out


def phase_escalation(dev, rng, card: str, batches) -> dict:
    """The escalation path at full width on the card: checks 1-9, images
    per second at k = 1 and 3 on the clean and the damaged batch, a
    profiled escalated pass, host syncs a batch, sub-batch sizes."""
    out = esc_checks(dev)
    p1, p3 = out.pop("pipes")
    key, clean, noised = out.pop("key"), out.pop("clean"), out.pop("noised")
    out.pop("p"), out.pop("msg")
    all_k = {n: c for n, c in out["decode_all_counts"].items() if c}
    print(f"escalation: k = 1 damaged rows match {out['match_k1']:.3f}, "
          f"k = {ESC_K} {out['match_k3']:.3f}; tiles_used {out['tiles_used']}"
          f"; sub-batches a round {out['sub_batches']}; launches "
          f"{json.dumps(out['counts'])}, decode_all_keyed "
          f"{json.dumps(all_k)}"
          f"; the plain replay equal ({out['replay_rows_exact']}/32 rows "
          f"exact); the margin {ESC_MARGIN} escalated the flat rows "
          f"(round-1 mean |logit| <= {out['flat_round1_mean_abs_logit']:.4f})")
    ips = {}
    for name, pipe, raw in (("k1_clean", p1, clean), ("k3_clean", p3, clean),
                            ("k1_damaged", p1, noised),
                            ("k3_damaged", p3, noised)):
        ips[name] = esc_ips(pipe, raw, key)
    out["images_per_s"] = ips
    print(f"escalation images/s on {card}: "
          f"{json.dumps({k: round(v, 1) for k, v in ips.items()})}")
    out["syncs"] = {n: count_syncs(lambda: pp.detect_batch(raw, key=key))
                    for n, pp, raw in (("k1_clean", p1, clean),
                                       ("k3_clean", p3, clean),
                                       ("k3_damaged", p3, noised))}
    print(f"escalation: synchronizing CUDA calls a batch "
          f"{json.dumps({n: v['n'] for n, v in out['syncs'].items()})} "
          f"({out['rounds']} rounds); by line "
          f"{json.dumps({n: v['at'] for n, v in out['syncs'].items()})}")
    traced = profile_path(p3, [noised] * 3, card, "escalation", key=key)
    prof = PROFILED.get("escalation")
    if traced and prof:
        out["device_busy_ms_a_batch"] = prof["busy_ms"] / 3
        out["idle_share"] = 1 - prof["busy_ms"] / prof["wall_ms"]
        hits = [v for k, v in traced.items() if f"::{INGEST_KERNEL}(" in k]
        out["ingest_launches_traced"] = hits[0][0] if hits else None
        check(not hits or hits[0][0] == 3 * (1 + out["rounds"]),
              f"escalation: the trace shows {hits} tile kernel launches")
    out["serve"] = {"fp32": esc_serve(["--escalate-tiles", str(ESC_K)],
                                      batches, card),
                    "int8": esc_serve(["--decode-dtype", "int8",
                                       "--escalate-tiles", str(ESC_K)],
                                      batches, card)}
    out.update(esc_rs_and_attacks(dev, rng, card))
    return out


# -- phase 7: the lane executor (lanes as CUDA streams) --------------------
LANE_ARGS = ["--batch", "32", "--img", "256", "--tile", "64"]
LANE_BATCHES = 12        # the stream each lane map runs


def result_hash(results) -> str:
    """sha256 of a list of result dicts (every field's dtype, shape and
    bytes, fields in name order): equal hashes are equal results."""
    import hashlib
    h = hashlib.sha256()
    for r in results:
        for k in sorted(r):
            a = np.ascontiguousarray(r[k])
            h.update(f"{k}|{a.dtype}|{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()[:16]


def lane_service(flags, dev: str = "cuda"):
    """The launcher's full-width DetectionService for ``flags`` (lanes
    adaptive: Algorithm 1 assigns them at the warm-up)."""
    from repro_torch.launch import serve as serve_lib
    args = serve_lib.parse_args([*LANE_ARGS, "--device", dev, *flags])
    cfg, params = serve_lib.build_config(args)
    return serve_lib.DetectionService(cfg, params, device=dev)


def serial_results(pipe, stream) -> list:
    """``detect_batch`` over the stream, item i under batch key i."""
    return [pipe.detect_batch(raw, key=pipe.stages.batch_key(i))
            for i, raw in enumerate(stream)]


def hold_lanes(svc, stream, label: str) -> dict:
    """Serial ``detect_batch`` against ``run_stream`` at every lane map
    and the executor's service mode over the same stream (item i under
    batch key i): every result hash equal to serial's."""
    from repro_torch.core.lanes import LaneExecutor
    pipe = svc.pipe
    want = result_hash(serial_results(pipe, stream))
    out = {"serial": want, "lanes": {}}
    maps = {"1": 1, "default": None, "assign": dict(svc.lanes)}
    for name, lanes in maps.items():
        pipe._seq = 0
        got = pipe.run_stream(stream, lanes=lanes)
        h = result_hash(got["results"])
        check(h == want, f"lanes {label}: run_stream at {name} "
              f"{got['lanes']} hashes {h}, serial {want}")
        out["lanes"][name] = got["lanes"]
    # the service mode: tickets resolve in completion order
    st = pipe.stages
    st.prepare(stream[0].shape)
    ex = LaneExecutor(pipe.build_stages(), name="service").start()
    order = []
    try:
        tickets = [ex.submit({"raw": raw, "keys": st.image_keys(
            st.batch_key(i), raw.shape[0])},
            callback=lambda t: order.append(t.seq))
            for i, raw in enumerate(stream)]
        check(ex.drain(300), f"lanes {label}: the service did not drain")
        h = result_hash([t.result(0) for t in tickets])
    finally:
        ex.close()
    check(h == want, f"lanes {label}: the service mode hashes {h}, "
          f"serial {want}")
    out["service_completion_order"] = order
    print(f"lanes {label}: {len(stream)} batches, serial == run_stream at "
          f"{json.dumps(out['lanes'])} == the service mode (completion "
          f"order {order}), hash {want}")
    return out


def lane_stream_trace(fn, name: str):
    """Run ``fn`` once under ``torch.profiler``; return (the trace's
    device events — kernels, copies, sets — as (name, ts, dur, stream)
    in µs, the wall ms, the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):  # the primer of profile_path
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = OUT / f"{name}_trace.json"
    prof.export_chrome_trace(str(path))
    events = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
               e.get("args", {}).get("stream"))
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "spin_kernel" not in e["name"]]
    return events, wall_ms


def busy_union_ms(events) -> float:
    """Device busy time: the union of the events' intervals (streams
    that overlap count once), ms."""
    spans = sorted((ts, ts + dur) for _, ts, dur, _ in events)
    total, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def lane_profile(fn, name: str, n_batches: int, card: str) -> dict:
    """A profiled pass of ``fn``: wall, device busy (union) and the sum
    of device time, idle share, H2D time, the CUDA streams that ran
    decode kernels and whether two decode kernels overlapped."""
    from repro_torch.kernels.fused_extractor import is_decode_kernel
    events, wall_ms = lane_stream_trace(fn, name)
    if not events:
        print(f"lanes profile {name}: the profiler saw no device time "
              f"(not measured)")
        return {"measured": False}
    dec = sorted((e for e in events if is_decode_kernel(e[0])),
                 key=lambda e: e[1])
    streams = sorted({e[3] for e in dec})
    overlap = any(a[3] != b[3] and b[1] < a[1] + a[2]
                  for i, a in enumerate(dec) for b in dec[i + 1:])
    busy = busy_union_ms(events)
    h2d = sum(d for n, _, d, _ in events if "HtoD" in n) / 1e3
    out = dict(measured=True, wall_ms=wall_ms, busy_ms=busy,
               device_ms=sum(d for _, _, d, _ in events) / 1e3,
               idle_share=1 - busy / wall_ms, h2d_ms=h2d,
               busy_ms_a_batch=busy / n_batches,
               decode_streams=len(streams), decode_overlap=overlap,
               decode_launches=len(dec))
    print(f"lanes profile {name}: {n_batches} batches, wall {wall_ms:.3f} "
          f"ms, device busy {busy:.3f} ms ({busy / n_batches:.3f} a batch; "
          f"device time summed {out['device_ms']:.3f}), idle share "
          f"<= {out['idle_share']:.3f}, H2D {h2d:.3f} ms, decode kernels "
          f"on {len(streams)} stream(s), overlapping: {overlap}, on {card}")
    return out


def lane_windows(svc, stream, card: str, rounds: int = 2) -> dict:
    """Images/s of the serial loop, run_stream at one lane a stage and at
    the default lanes on whole batches, and the service's scheduled
    stream (LPT tasks of b // 4, padded), in one process, windows
    alternating serial, lanes1, lanes, service, service, lanes, lanes1,
    serial."""
    pipe = svc.pipe
    n_img = sum(r.shape[0] for r in stream)

    def serial():
        for raw in stream:
            pipe.detect_batch(raw)

    def lanes1():
        pipe.run_stream(stream, lanes=1)

    def lanes():
        pipe.run_stream(stream)

    def service():
        svc.serve(stream)

    runs = {"serial": serial, "lanes1": lanes1, "lanes": lanes,
            "service": service}
    ips = {k: [] for k in runs}
    for _ in range(rounds):
        for name in ("serial", "lanes1", "lanes", "service", "service",
                     "lanes", "lanes1", "serial"):
            t0 = time.perf_counter()
            runs[name]()
            ips[name].append(n_img / (time.perf_counter() - t0))
    shown = {k: [round(v, 1) for v in vs] for k, vs in ips.items()}
    print(f"lanes images/s ({len(stream)} batches of 32 a window): "
          f"{json.dumps(shown)} on {card}")
    return ips


def upload_ms(raw, card: str, dev: str = "cuda", iters: int = 20) -> dict:
    """Host ms to put the 8 MB raw batch on the card and wait for it:
    pageable (``torch.as_tensor(raw).to``) against pinned staging and a
    non-blocking copy (``lanes.upload``), alternating, medians."""
    import torch
    from repro_torch.core.lanes import upload
    dev = torch.device(dev)
    times = {"pageable": [], "pinned": []}
    fns = {"pageable": lambda: torch.as_tensor(raw).to(dev),
           "pinned": lambda: upload(raw, dev)}
    for _ in range(3):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    for _ in range(iters):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    out = {k: statistics.median(v) for k, v in times.items()}
    print(f"upload of the {raw.nbytes / 2**20:.1f} MiB raw batch: pageable "
          f"{out['pageable']:.4f} ms, pinned {out['pinned']:.4f} ms "
          f"(host clock to the wait, median of {iters}) on {card}")
    return out


def host_contention(card: str, n: int = 24) -> dict:
    """Host ms a batch of the keys and tile offsets of a batch of 32 (a
    few hundred small torch ops, each releasing and retaking the GIL),
    computed by 1, 2 and 4 threads at once: total wall over total
    batches, so 1.0x the one-thread time means the threads cost nothing
    extra."""
    import threading
    import torch
    from repro_torch.core import prng, tiling
    base = prng.key(0)

    def work():
        for i in range(n):
            keys = prng.fold_in(prng.fold_in(base, i)[None].expand(32, 2),
                                torch.arange(32))
            tiling.tile_first_offsets("random_grid", keys, img_size=256,
                                      tile=64)

    work()
    out = {}
    for nt in (1, 2, 4, 1):
        threads = [threading.Thread(target=work) for _ in range(nt)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out.setdefault(str(nt), []).append(
            (time.perf_counter() - t0) * 1e3 / (n * nt))
    shown = {k: [round(x, 4) for x in v] for k, v in out.items()}
    print(f"host ms a batch of keys + offsets with 1, 2, 4 threads at once "
          f"(wall / batches): {json.dumps(shown)} on the host of {card}")
    return out


def host_parts(pipe, stream, card: str) -> dict:
    """Host µs a batch of the serial default path by part (median over
    the stream): keys, offsets, the raw batch's pageable upload, the
    offsets' upload, the ingest, decode and bits + RS wrapper calls, the
    wait for the device, and the D2H of ``_finish`` after it; held to
    ``detect_batch`` (same hash)."""
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import ops as kops
    st, cfg = pipe.stages, pipe.cfg
    parts = ("keys", "offsets", "upload", "offsets_h2d", "ingest_call",
             "decode_call", "rs_call", "device_wait", "finish_d2h")
    times = {k: [] for k in parts}
    results = []
    torch.cuda.synchronize()
    for i, batch in enumerate(stream):
        t = [time.perf_counter()]
        keys = st.image_keys(st.batch_key(i), batch.shape[0])
        t.append(time.perf_counter())
        offs = tiling.tile_first_offsets(cfg.strategy, keys,
                                         img_size=cfg.img_size,
                                         tile=cfg.tile)
        t.append(time.perf_counter())
        raw = st.to_device(batch)
        t.append(time.perf_counter())
        offs_d = offs.to(raw.device).contiguous()
        t.append(time.perf_counter())
        x = kops.fused_tile_preprocess(raw, offs_d, resize=cfg.resize_src,
                                       crop=cfg.img_size, tile=cfg.tile)
        t.append(time.perf_counter())
        logits = st.extract(x)
        t.append(time.perf_counter())
        rs = st._device_rs(st.bits(logits))
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        results.append(pipe._finish(rs["message_bits"], rs["ok"],
                                    rs["n_corrected"], logits))
        t.append(time.perf_counter())
        for k, a, b in zip(parts, t, t[1:]):
            times[k].append((b - a) * 1e6)
    want = result_hash(serial_results(pipe, stream))
    check(result_hash(results) == want,
          "host parts: the timed replica differs from detect_batch")
    out = {k: statistics.median(v) for k, v in times.items()}
    out["total"] = sum(out.values())
    shown = {k: round(v, 1) for k, v in out.items()}
    print(f"host µs a batch by part (serial default path, median of "
          f"{len(stream)}): {json.dumps(shown)} on {card}")
    return out


def lane_launcher(card: str, dev: str = "cuda") -> dict:
    """``python -m repro_torch.launch.serve`` at full width, adaptive,
    ``--lanes 4`` and ``--sharded``, through its ``main`` in this
    process: each prints the allocation line and a report with
    ``allocation``, ``lanes`` and ``lane_loads``."""
    from repro_torch.launch import serve as serve_lib
    out = {}
    for name, flags in (("adaptive", []), ("lanes4", ["--lanes", "4"]),
                        ("sharded", ["--sharded"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_lib.main([*LANE_ARGS, "--batches", "4", "--device", dev,
                            *flags])
        text = buf.getvalue()
        line, _, rest = text.partition("\n")
        check(line.startswith("allocation: streams="),
              f"serve {name}: no allocation line: {text[:200]}")
        rep = json.loads(rest)
        check({"allocation", "lanes", "lane_loads"} <= set(rep) and
              rep["images"] == 4 * int(LANE_ARGS[1]),
              f"serve {name}: report {rep}")
        if name == "lanes4":
            check(rep["lanes"] == {"ingest": 1, "decode": 4, "rs": 4},
                  f"serve --lanes 4: lanes {rep['lanes']}")
        out[name] = dict(line=line, **rep)
        print(f"serve {' '.join(flags) or '(adaptive)'}: {line}; "
              f"{rep['images']} images, {rep['throughput_ips']:.1f} "
              f"images/s, lanes {rep['lanes']}, lane_loads "
              f"{rep['lane_loads']} on {card}")
    return out


def lane_escalation(card: str, dev: str = "cuda", geo=FULL, width=WIDTH,
                    raw_hw: int = RAW, b: int = 32) -> dict:
    """escalate_tiles=3 on the escalation phase's workload through the
    lanes: each stream item's round-1 tiles (under batch key i) noised
    in the phase's 11 rows, so the rs lanes escalate them."""
    from repro_torch.core import tiling
    from repro_torch.core.detect import DetectionConfig, DetectionPipeline
    p, msg, clean_f = esc_workload(geo, width, raw_hw, b)
    pipe = DetectionPipeline(DetectionConfig(**geo, escalate_tiles=ESC_K),
                             p, ground_truth_bits=msg, device=dev)
    st, o = pipe.stages, (raw_hw - geo["img_size"]) // 2
    damaged = [i for i in ESC_DAMAGED if i < b]
    stream = []
    for i in range(4):
        offs = tiling.tile_first_offsets(
            "random_grid", st.image_keys(st.batch_key(i), b),
            img_size=geo["img_size"], tile=geo["tile"]).numpy()
        stream.append(esc_damage(clean_f, offs + o, damaged, geo["tile"],
                                 sigma=ESC_SIGMA))
    want_res = serial_results(pipe, stream)
    want = result_hash(want_res)
    used = np.stack([r["tiles_used"] for r in want_res])
    check((used[:, damaged] > 1).mean() >= 0.8 and
          np.stack([r["match"] for r in want_res]).mean() >= 0.8,
          f"lanes escalation: the damaged rows did not escalate and "
          f"recover: tiles_used {used.tolist()}")
    maps = {"1": 1, "default": None, "dict": {"ingest": 2, "decode": 3,
                                              "rs": 3}}
    for name, lanes in maps.items():
        pipe._seq = 0
        h = result_hash(pipe.run_stream(stream, lanes=lanes)["results"])
        check(h == want, f"lanes escalation: run_stream at {name} hashes "
              f"{h}, serial {want}")
    print(f"lanes escalation (k = {ESC_K}, 4 damaged batches): serial == "
          f"run_stream at {list(maps)}, hash {want}, tiles_used a batch "
          f"{used.sum(axis=1).tolist()} on {card}")
    return dict(hash=want, tiles_used=used.sum(axis=1).tolist())


def lane_run_batch(svc, raw, card: str) -> dict:
    """``run_batch`` over the visible cards on a ragged batch (29 rows)
    equal to ``detect_batch`` with the same key."""
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_detection_mesh
    mesh = make_detection_mesh()
    key = prng.key(11)
    got = svc.pipe.run_batch(raw[:29], mesh=mesh, key=key)
    want = svc.pipe.detect_batch(raw[:29], key=key)
    check(result_hash([got]) == result_hash([want]),
          "run_batch differs from detect_batch")
    print(f"run_batch over {[str(d) for d in mesh]} == detect_batch on a "
          f"ragged batch of 29, on {card}")
    return dict(devices=[str(d) for d in mesh], equal=True)


def phase_lanes(batches, card: str, dev: str = "cuda") -> dict:
    """The lane executor at full width on the card (C 64, D 7, 60 bits,
    tile 64, img 256, raw 288, batch 32): results equal to serial at
    every lane map, rung, with escalation and cpu_pool; decode kernels
    on more than one stream; launches equal to serial's; Algorithm 1's
    profiles and allocation; images/s, device busy and idle share of the
    serial loop, the lanes and the scheduled service; upload and host
    time by part; the launcher adaptive, --lanes 4 and --sharded;
    run_batch == detect_batch."""
    import torch
    from repro_torch.kernels import ops
    stream = (list(batches) * LANE_BATCHES)[:LANE_BATCHES]
    out = {"rungs": {}}
    svcs = {}
    for dtype in ("fp32", "int8"):
        svc = lane_service(["--decode-dtype", dtype], dev)
        alloc = svc.warmup(stream[0])
        prof = [dict(name=p.name, t_per_sample=p.t_per_sample,
                     u_per_sample=p.u_per_sample,
                     launch_overhead=p.launch_overhead)
                for p in svc.profiles]
        print(f"lanes Algorithm 1 ({dtype}): profiles {json.dumps(prof)}; "
              f"streams {alloc.streams} J* {alloc.bottleneck_s:.6f} s; "
              f"minibatch {alloc.minibatch}; assign {svc.lanes} on {card}")
        out["rungs"][dtype] = dict(
            profiles=prof, streams=alloc.streams, minibatch=alloc.minibatch,
            j_star=alloc.bottleneck_s, assign=dict(svc.lanes),
            **hold_lanes(svc, stream, dtype))
        svcs[dtype] = svc
    svc = svcs["fp32"]
    pipe = svc.pipe

    # launches: run_stream's equal serial's, per wrapper and per kernel
    counts = {}
    for name, fn in (("serial", lambda: serial_results(pipe, stream)),
                     ("lanes", lambda: pipe.run_stream(stream))):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        pipe._seq = 0
        fn()
        torch.cuda.synchronize()
        counts[name] = (ops.launch_counts(), ops.kernel_launch_counts())
    check(counts["serial"] == counts["lanes"],
          f"lanes: launches {counts['lanes']} differ from serial's "
          f"{counts['serial']}")
    out["launches"] = counts["lanes"][0]
    print(f"lanes launches (== serial's, {LANE_BATCHES} batches): "
          f"{json.dumps(counts['lanes'][0])}")

    # streams are real, and each path's device busy / idle / H2D
    n = LANE_BATCHES
    out["profiles"] = {
        "serial": lane_profile(lambda: serial_results(pipe, stream),
                               "lanes_serial", n, card),
        "lanes": lane_profile(lambda: pipe.run_stream(stream),
                              "lanes_default", n, card),
        "service": lane_profile(lambda: svc.serve(stream),
                                "lanes_service", n, card)}
    lp = out["profiles"]["lanes"]
    check(lp["measured"] and lp["decode_streams"] > 1,
          f"lanes: the decode kernels ran on {lp.get('decode_streams')} "
          f"stream(s) with {pipe.default_lanes()['decode']} decode lanes")

    out["images_per_s"] = lane_windows(svc, stream * 3, card)
    out["upload_ms"] = upload_ms(stream[0], card, dev)
    out["host_us"] = host_parts(pipe, stream, card)
    out["host_contention_ms"] = host_contention(card)
    out["escalation"] = lane_escalation(card, dev)
    pool = lane_service(["--rs-mode", "cpu_pool"], dev)
    pool.warmup(stream[0])
    out["cpu_pool"] = hold_lanes(pool, stream[:4], "cpu_pool")
    pool.close()
    out["run_batch"] = lane_run_batch(svc, stream[0], card)
    for s in svcs.values():
        s.close()
    out["launcher"] = lane_launcher(card, dev)
    return out


# -- phase 8: the online server (repro_torch.serving) ----------------------
ONLINE_REQUESTS = 200    # the seeded request stream a rung serves
ONLINE_MAX_IMAGES = 8    # images a request: 1 to this
ONLINE_MAX_BATCH = 32    # the micro-batcher's cap (the offline batch)
ONLINE_WAIT_MS = 2.0     # its deadline for partial micro-batches
ONLINE_KERNELS = ("fused_tile_preprocess", "fused_extractor", "rs_decode")
# open-loop load at full width through the launcher: requests/s offered,
# images a request (the generator makes each request's 288^2 images with
# synth_image on the host, ~70 images/s on the card's host: a higher
# rate would measure the generator, not the server)
ONLINE_QPS, ONLINE_GROUP = 12.0, 4


def online_server(cfg, params, dev: str = "cuda", **kw):
    """A DetectionServer on ``dev`` with the phase's batcher (``kw`` to
    the server), not yet warmed up or started."""
    from repro_torch.serving import BatcherConfig, DetectionServer
    return DetectionServer(cfg, params, batcher=BatcherConfig(
        max_batch=ONLINE_MAX_BATCH, max_wait_ms=ONLINE_WAIT_MS),
        device=dev, **kw)


def online_stream(pool, n: int, seed: int = 0):
    """``n`` requests of 1 to ONLINE_MAX_IMAGES distinct rows of ``pool``
    each, and the gap after each: none for half of them (so requests
    coalesce), up to 2 ms for the rest (so micro-batches also ship
    part-full at their deadline)."""
    rng = np.random.default_rng(seed)
    reqs = [pool[np.sort(rng.choice(len(pool), int(rng.integers(
        1, ONLINE_MAX_IMAGES + 1)), replace=False))] for _ in range(n)]
    gaps = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0.0, 2e-3, n))
    return reqs, gaps


def online_submit(srv, reqs, gaps, keys=None):
    """Submit a stream (request i under ``keys[i]``, or keyless) at its
    gaps; wait for every handle.  Returns (results, host µs of each
    ``submit``, wall s, the first request id)."""
    rid0 = srv._req_seq
    handles, sub_us = [], []
    t0 = time.perf_counter()
    for i, (r, g) in enumerate(zip(reqs, gaps)):
        t = time.perf_counter()
        handles.append(srv.submit(r, key=None if keys is None else keys[i]))
        sub_us.append((time.perf_counter() - t) * 1e6)
        if g:
            time.sleep(g)
    results = [h.result(300) for h in handles]
    wall = time.perf_counter() - t0
    check(all(h.done() for h in handles) and srv.drain(60),
          "online: a request was left unresolved")
    executor_idle(srv)
    return results, sub_us, wall, rid0


def executor_idle(srv, timeout: float = 60.0):
    """Wait until the server's executor has delivered every payload,
    speculative retries that lost their race included: a straggler retry
    is counted when it is dispatched and launches its kernels when it
    runs, which can be after its request was resolved by the original."""
    check(srv._ex.drain(timeout),
          f"{srv.name}: the executor still held payloads after {timeout} s")


def online_hold(srv, reqs, results, keys, label: str):
    """Each served request equals ``detect_batch`` of its images under its
    key on the server's own pipeline, by result hash."""
    pipe = srv.pipe
    for i, (r, res) in enumerate(zip(reqs, results)):
        want = pipe.detect_batch(r, key=keys[i])
        check(result_hash([res]) == result_hash([want]),
              f"online {label}: request {i} ({r.shape[0]} images) differs "
              f"from detect_batch under its key")


def online_rung(cfg, params, reqs, gaps, card: str, label: str,
                dev: str = "cuda", trace: bool = True) -> dict:
    """The seeded stream through a warmed server (keyless: request id i
    under fold_in(key(seed), i)), every request held to ``detect_batch``
    bit for bit; throughput, latency percentiles, occupancy and the
    submit's host time; on the card the launches of each kernel per
    micro-batch, matched against a profiled second pass's trace."""
    from repro_torch.kernels import ops
    srv = online_server(cfg, params, dev)
    try:
        t0 = time.perf_counter()
        buckets = srv.warmup(reqs[0][0])
        warm_s = time.perf_counter() - t0
        srv.start()
        srv.metrics.reset()
        on_card = dev != "cpu"
        if on_card:
            import torch
            torch.cuda.synchronize()
            ops.reset_launch_counts()
        results, sub_us, wall, rid0 = online_submit(srv, reqs, gaps)
        st = srv.stats()
        counts = ops.launch_counts() if on_card else {}
        kcounts = ops.kernel_launch_counts() if on_card else {}
        n_mb = st["batch_images"]["n"]
        out = dict(
            buckets=buckets, warmup_s=warm_s, requests=len(reqs),
            images=int(sum(r.shape[0] for r in reqs)), wall_s=wall,
            requests_per_s=len(reqs) / wall,
            images_per_s=sum(r.shape[0] for r in reqs) / wall,
            latency_ms={q: st["request_latency_s"][q] * 1e3
                        for q in ("p50", "p95", "p99", "mean")},
            micro_batches=n_mb,
            occupancy=st["batch_occupancy"]["mean"],
            images_a_micro_batch=st["batch_images"]["mean"],
            straggler_retries=st["straggler_retries"],
            submit_us={"mean": statistics.mean(sub_us),
                       "p50": statistics.median(sub_us),
                       "p99": sorted(sub_us)[int(0.99 * (len(sub_us) - 1))]},
            lanes=st["lanes"])
        if on_card:
            # a speculative retry of a straggling micro-batch runs it again
            runs = n_mb + st["straggler_retries"]
            check(all(counts[k] == runs for k in ONLINE_KERNELS) and
                  sum(counts.values()) == runs * len(ONLINE_KERNELS),
                  f"online {label}: launches {counts} in {n_mb} "
                  f"micro-batches and {st['straggler_retries']} retries, "
                  f"not one of each kernel a run")
            out["launches"] = counts
            out["launches_a_micro_batch"] = {k: counts[k] / runs
                                             for k in ONLINE_KERNELS}
            out["decode_kernels_a_micro_batch"] = {
                k: v / runs for k, v in kcounts.items()}
        keys = [srv.registry.batch_key(rid0 + i) for i in range(len(reqs))]
        if on_card and trace:
            out["trace"] = online_trace(srv, reqs[:40], gaps[:40], card,
                                        label)
    finally:
        srv.close()
    online_hold(srv, reqs, results, keys, label)
    print(f"online {label}: {len(reqs)} requests ({out['images']} images) "
          f"in {n_mb} micro-batches (occupancy {out['occupancy']:.3f}, "
          f"{out['images_a_micro_batch']:.2f} images each), "
          f"{out['requests_per_s']:.1f} requests/s = "
          f"{out['images_per_s']:.1f} images/s, latency ms p50/p95/p99 "
          f"{out['latency_ms']['p50']:.3f}/{out['latency_ms']['p95']:.3f}/"
          f"{out['latency_ms']['p99']:.3f}, submit µs mean "
          f"{out['submit_us']['mean']:.1f} p99 {out['submit_us']['p99']:.1f}"
          f", retries {out['straggler_retries']}, launches a micro-batch "
          f"{json.dumps(out.get('launches_a_micro_batch'))}; every request "
          f"== detect_batch bit for bit, on {card}")
    return out


def online_trace(srv, reqs, gaps, card: str, label: str) -> dict:
    """A profiled pass of part of the stream through the running server:
    the launches of each kernel counted from the trace (the ingest
    kernel, the decode's kernels, the RS kernel) against the wrappers'
    counts of the same pass; device busy and idle share.  A session can
    miss its first device events, so a primer of 8 requests runs first
    in it, and only device events after the counted pass's annotation
    are read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_extractor import is_decode_kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        online_submit(srv, reqs[:8], gaps[:8])
        torch.cuda.synchronize()
        srv.metrics.reset()
        ops.reset_launch_counts()
        with record_function("online_counted_pass"):
            t0 = time.perf_counter()
            online_submit(srv, reqs, gaps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    counts, kcounts = ops.launch_counts(), ops.kernel_launch_counts()
    st = srv.stats()
    n_mb = st["batch_images"]["n"]
    path = OUT / f"online_{label}_trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    marks = [float(e["ts"]) for e in trace
             if e.get("name") == "online_counted_pass"]
    events = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
              for e in trace
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and marks and float(e["ts"]) >= marks[0]]
    if not events:
        print(f"online {label} profile: the profiler saw no device time "
              f"(not measured)")
        return {"measured": False}
    traced = {"fused_tile_preprocess": sum(
                  INGEST_KERNEL in e[0] for e in events),
              "fused_extractor": sum(is_decode_kernel(e[0]) for e in events),
              "rs_decode": sum(RS_KERNEL in e[0] for e in events)}
    want = {"fused_tile_preprocess": counts["fused_tile_preprocess"],
            "fused_extractor": sum(kcounts.values()),
            "rs_decode": counts["rs_decode"]}
    check(traced == want, f"online {label}: traced kernels {traced}, "
          f"counted {want} ({n_mb} micro-batches)")
    busy = busy_union_ms([(n, ts, d, None) for n, ts, d in events])
    out = dict(measured=True, micro_batches=n_mb,
               straggler_retries=st["straggler_retries"], traced=traced,
               wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
               busy_ms_a_micro_batch=busy / n_mb)
    print(f"online {label} profile: {len(reqs)} requests in {n_mb} "
          f"micro-batches, traced launches {traced} == counted, wall "
          f"{wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({out['busy_ms_a_micro_batch']:.3f} a micro-batch), idle "
          f"share <= {out['idle_share']:.3f}, on {card}")
    return out


def online_cache(cfg, params, reqs, card: str, dev: str = "cuda") -> dict:
    """The exact tier on a repeated pool of 8 requests: each submitted
    three times back to back (followers coalesce onto the leader in
    flight), then five more rounds (hits); every result equals the cold
    path and ``detect_batch`` at the content key bit for bit, every
    handle resolves once, no follower is left behind."""
    import dataclasses
    pool = reqs[:8]
    srv = online_server(dataclasses.replace(cfg, cache_exact=True), params,
                        dev)
    try:
        srv.warmup(pool[0][0])
        srv.start()
        srv.metrics.reset()
        order = [i for i in range(8) for _ in range(3)] + list(range(8)) * 5
        sent = [pool[i] for i in order]
        results, _, wall, _ = online_submit(srv, sent, [0.0] * len(sent))
        st = srv.stats()
        check(srv._dedup.depth() == 0, "online cache: followers left")
    finally:
        srv.close()
    n = len(sent)
    hit, dd, miss = (st[k] for k in ("cache_hit_exact", "dedup_coalesced",
                                     "cache_miss"))
    check(hit + dd + miss == n and miss >= 8 and
          st["counters"]["requests_completed"] == n,
          f"online cache: hits {hit} + coalesced {dd} + misses {miss} "
          f"over {n} requests, completed "
          f"{st['counters'].get('requests_completed')}")
    cold = {}
    for i, res in zip(order, results):
        h = result_hash([res])
        check(cold.setdefault(i, h) == h,
              f"online cache: request {i} served two different results")
    for i in range(8):
        want = srv.pipe.detect_batch(pool[i], key=srv.content_key(pool[i]))
        check(cold[i] == result_hash([want]),
              f"online cache: request {i} differs from detect_batch at its "
              f"content key")
    out = dict(requests=n, hit_exact=hit, dedup_coalesced=dd, miss=miss,
               hit_rate=st["cache_hit_rate"], wall_s=wall)
    print(f"online cache: {n} requests over 8 distinct: {hit} exact hits, "
          f"{dd} coalesced, {miss} misses (hit rate "
          f"{st['cache_hit_rate']:.3f}); every hit and follower == the cold "
          f"result == detect_batch at the content key, bit for bit, on "
          f"{card}")
    return out


def online_embed(dev, card: str) -> dict:
    """The decode with ``with_embed`` at full width, b = 32: its logits
    bitwise the embed-free call's on the flat kernel at every rung and
    on the serve schedule's blocked one, its embedding against the plain
    version's (fp32 within LOGIT_RTOL, the lower rungs within
    RUNG_ATOL)."""
    import torch
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import fused_extractor as fx
    rng = np.random.default_rng(3)
    tiles = torch.as_tensor(rng.normal(size=(32, 64, 64, 3)).astype(
        np.float32)).to(dev)
    out = {}
    for dtype in ("fp32", *RUNGS):
        packed = rung_pack(dev, dtype)
        _, g_plain = fx.fused_extractor_plain(tiles, packed, with_embed=True)
        ref = g_plain.cpu().numpy()
        tol = logit_tol(ref) if dtype == "fp32" else RUNG_ATOL
        for sched in (None, autotune.Schedule.from_string(SERVE_SCHEDULE)):
            name = f"{dtype}-{'flat' if sched is None else SERVE_SCHEDULE}"
            lg, g = ops.fused_extractor(tiles, packed, schedule=sched,
                                        with_embed=True)
            plain_lg = ops.fused_extractor(tiles, packed, schedule=sched)
            check(torch.equal(lg, plain_lg),
                  f"online embed {name}: with_embed changed the logits")
            err = float(np.abs(g.cpu().numpy() - ref).max())
            check(err <= tol, f"online embed {name}: embedding off the "
                  f"plain version by {err} > {tol}")
            out[name] = err
    print(f"online embed: with_embed logits == embed-free bit for bit, "
          f"embedding max |err| vs plain {json.dumps(out)}, on {card}")
    return out


def online_escalation(card: str, dev: str = "cuda", geo=FULL, width=WIDTH,
                      raw_hw: int = RAW, b: int = 32,
                      rms: float = ESC_RMS) -> dict:
    """escalate_tiles=3 through the server on the escalation phase's
    workload (4 damaged batches as in ``lane_escalation``, each one
    request under batch key i): escalation rounds re-submitted as
    payloads of the groups' true rows, every request equal to
    ``detect_batch`` with escalation bit for bit."""
    from repro_torch.core import tiling
    from repro_torch.core.detect import DetectionConfig
    p, msg, clean_f = esc_workload(geo, width, raw_hw, b, rms)
    srv = online_server(DetectionConfig(**geo, escalate_tiles=ESC_K), p, dev)
    st, o = srv.registry, (raw_hw - geo["img_size"]) // 2
    damaged = [i for i in ESC_DAMAGED if i < b]
    stream = []
    for i in range(4):
        offs = tiling.tile_first_offsets(
            "random_grid", st.image_keys(st.batch_key(i), b),
            img_size=geo["img_size"], tile=geo["tile"]).numpy()
        stream.append(esc_damage(clean_f, offs + o, damaged, geo["tile"],
                                 sigma=ESC_SIGMA))
    keys = [st.batch_key(i) for i in range(4)]
    try:
        srv.warmup(stream[0][0])
        srv.start()
        srv.metrics.reset()
        results, _, wall, _ = online_submit(srv, stream, [0.0] * 4, keys)
        stats = srv.stats()
    finally:
        srv.close()
    online_hold(srv, stream, results, keys, "escalation")
    used = np.stack([r["tiles_used"] for r in results])
    match = np.stack([(r["message_bits"] == msg).all(axis=1)
                      for r in results])
    check((used[:, damaged] > 1).mean() >= 0.8 and match.mean() >= 0.8 and
          stats["escalation_batches"] > 0,
          f"online escalation: tiles_used {used.tolist()}, match "
          f"{match.mean()}")
    out = dict(escalation_batches=stats["escalation_batches"],
               escalation_rate=stats["escalation_rate"],
               tiles_used=used.sum(axis=1).tolist(),
               match=float(match.mean()), wall_s=wall)
    print(f"online escalation (k = {ESC_K}, 4 damaged requests of {b}): "
          f"{out['escalation_batches']} escalation micro-batches, "
          f"escalation rate {out['escalation_rate']:.4f}, tiles_used a "
          f"request {out['tiles_used']}, match {out['match']:.3f}; each "
          f"== detect_batch with escalation bit for bit, on {card}")
    return out


def online_launcher(card: str, dev: str = "cuda", lane_args=LANE_ARGS,
                    duration: float = 5.0) -> dict:
    """``python -m repro_torch.launch.serve --online`` through its
    ``main`` in this process: at the default flags, at full width under
    open-loop load, and with the caches and escalation on a Zipf pool;
    each prints a report with no failed, rejected-then-lost or
    unresolved request."""
    from repro_torch.launch import serve as serve_lib
    d = ["--duration", str(duration)]
    runs = {
        "default": d,
        "full_width_load": [*lane_args, *d, "--qps", str(ONLINE_QPS),
                            "--group", str(ONLINE_GROUP), "--max-batch",
                            str(ONLINE_MAX_BATCH)],
        "cache_zipf_escalation": [
            *d, "--pool", "64", "--zipf", "1.2", "--cache-exact",
            "--cache-embed-threshold", "0.95", "--escalate-tiles", "3"]}
    out = {}
    for name, flags in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_lib.main(["--online", "--device", dev, *flags])
        text = buf.getvalue()
        line, _, rest = text.partition("\n")
        check(line.startswith("online: warmed buckets"),
              f"serve --online {name}: {text[:200]}")
        rep = json.loads(rest)
        check(rep["failed"] == 0 and rep["unresolved"] == 0 and
              rep["completed"] == rep["offered"] - rep["rejected"],
              f"serve --online {name}: report {rep}")
        if "--cache-exact" in flags:
            check("cache" in rep and "escalation_rate" in rep,
                  f"serve --online {name}: no cache/escalation block")
        out[name] = rep
        print(f"serve --online {' '.join(flags)}: {json.dumps(rep)} on "
              f"{card}")
    return out


def phase_online(batches, card: str, dev: str = "cuda") -> dict:
    """The online server at full width (C 64, D 7, 60 bits, tile 64,
    img 256, raw 288): a seeded stream of ONLINE_REQUESTS requests of 1
    to 8 images at fp32 and int8, each equal to ``detect_batch`` under
    its key; the exact tier; the embedding decode; escalation through
    the server; launches per micro-batch matched to a trace; the
    launcher's ``--online``."""
    from repro_torch.launch import serve as serve_lib
    pool = np.concatenate(list(batches))
    reqs, gaps = online_stream(pool, ONLINE_REQUESTS)
    out = {"rungs": {}}
    for dtype in ("fp32", "int8"):
        args = serve_lib.parse_args([*LANE_ARGS, "--device", dev,
                                     "--decode-dtype", dtype])
        cfg, params = serve_lib.build_config(args)
        out["rungs"][dtype] = online_rung(cfg, params, reqs, gaps, card,
                                          dtype, dev)
        if dtype == "fp32":
            out["cache"] = online_cache(cfg, params, reqs, card, dev)
    out["embed"] = online_embed(dev, card)
    out["escalation"] = online_escalation(card, dev)
    out["launcher"] = online_launcher(card, dev)
    return out


# -- phase 9: the fleet ----------------------------------------------------
FLEET_REQUESTS = 100     # the seeded request stream the fleet serves
FLEET_REPLICAS = 2       # replicas sharing the card, each with its streams
FLEET_CRASH_AT = 10      # r0 crashes after admitting its 11th request
FLEET_ROLL = {"ingest": 1, "decode": 2, "rs": 1}   # the roll's lane map
FLEET_ROLL_REQUESTS = 40  # requests resent while the roll runs


def fleet_router(cfg, params, dev: str, plans=None):
    """FLEET_REPLICAS replicas (replica i on ``fleet_devices``' device i:
    all on the one card) behind a FleetRouter, not yet warmed or
    started."""
    from repro_torch.launch.serve import fleet_devices
    from repro_torch.serving import BatcherConfig, FleetRouter, Replica
    devs = fleet_devices(FLEET_REPLICAS, dev)
    return FleetRouter([Replica(
        f"r{i}", cfg, params, batcher=BatcherConfig(
            max_batch=ONLINE_MAX_BATCH, max_wait_ms=ONLINE_WAIT_MS),
        fault_plan=(plans or {}).get(f"r{i}"), device=devs[i])
        for i in range(FLEET_REPLICAS)])


def fleet_run(router, reqs, gaps, keys):
    """The stream through a started router at its gaps: (results,
    handles, wall s); every handle resolved and the router drained."""
    hs = []
    t0 = time.perf_counter()
    for r, g, k in zip(reqs, gaps, keys):
        hs.append(router.submit(r, key=k))
        if g:
            time.sleep(g)
    results = [h.result(300) for h in hs]
    wall = time.perf_counter() - t0
    check(router.drain(60), "fleet: a request was left unresolved")
    for r in router._replicas.values():
        executor_idle(r.srv)
    return results, hs, wall


def fleet_hold(results, want, label: str):
    for i, (g, w) in enumerate(zip(results, want)):
        check(result_hash([g]) == result_hash([w]),
              f"fleet {label}: request {i} differs from one "
              f"DetectionServer's result")


def fleet_runs(router) -> int:
    """Runs of a micro-batch over the fleet's replicas (micro-batches
    plus straggler retries): one launch of each main-path kernel each."""
    return sum(s.get("batch_images", {}).get("n", 0) +
               s["straggler_retries"]
               for s in (r.stats() for r in router._replicas.values()))


def phase_fleet(batches, card: str, dev: str = "cuda") -> dict:
    """The fleet at full width (C 64, D 7, 60 bits, tile 64, img 256, raw
    288): a seeded stream of FLEET_REQUESTS requests of 1 to 8 images
    through FLEET_REPLICAS replicas on the card behind the FleetRouter,
    each request equal to one DetectionServer's result bit for bit; the
    main-path kernels' launches counted over the run; a rolling
    reconfigure under traffic with no drop; the stream again with r0
    crashed after admission, every request resolved through its
    sibling; ``serve --fleet --replicas 2`` at its defaults."""
    import torch
    from repro_torch.core import prng
    from repro_torch.data.pipeline import synth_image
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.serving import AdmissionError, FaultPlan
    t_phase = time.perf_counter()
    cfg, params = serve_lib.build_config(serve_lib.parse_args(
        [*LANE_ARGS, "--device", dev]))
    reqs, gaps = online_stream(np.concatenate(list(batches)),
                               FLEET_REQUESTS, seed=3)
    keys = [prng.key(20_000 + i) for i in range(len(reqs))]
    n_img = sum(r.shape[0] for r in reqs)
    sample = synth_image(0, RAW)
    srv = online_server(cfg, params, dev)
    srv.warmup(sample)
    srv.start()
    try:
        want = online_submit(srv, reqs, gaps, keys)[0]
    finally:
        srv.close()
    out = {"requests": len(reqs), "images": n_img,
           "replicas": FLEET_REPLICAS}

    router = fleet_router(cfg, params, dev)
    try:
        router.warmup(sample)
        router.start()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        router.metrics.reset()
        results, hs, wall = fleet_run(router, reqs, gaps, keys)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        runs = fleet_runs(router)
        st = router.stats()
        fleet_hold(results, want, f"{FLEET_REPLICAS} replicas")
        served = sorted({h.replica for h in hs})
        check(len(served) == FLEET_REPLICAS,
              f"fleet: the stream reached only {served}")
        check(st["reroutes"] == 0 and st["unhealthy"] == 0 and
              st["counters"].get("requests_failed", 0) == 0,
              f"fleet: a healthy run rerouted or failed: {st}")
        check(runs > 0 and all(counts[k] == runs for k in ONLINE_KERNELS)
              and sum(counts.values()) == runs * len(ONLINE_KERNELS),
              f"fleet: launches {counts} for {runs} micro-batch runs")
        lat = st.get("request_latency_s", {})
        out["stream"] = {
            "requests_s": len(reqs) / wall, "images_s": n_img / wall,
            "latency_ms": {q: lat.get(q, float("nan")) * 1e3
                           for q in ("p50", "p95", "p99", "mean")},
            "reroutes": st["reroutes"], "spillovers": st["spillovers"],
            "micro_batch_runs": runs, "launches": counts,
            "by_replica": {n: sum(h.replica == n for h in hs)
                           for n in served}}
        print(f"fleet of {FLEET_REPLICAS} on one card: {len(reqs)} "
              f"requests ({n_img} images) == one DetectionServer; "
              f"{out['stream']['requests_s']:.1f} requests/s, "
              f"{out['stream']['images_s']:.1f} images/s, latency ms "
              f"{out['stream']['latency_ms']}, reroutes {st['reroutes']}, "
              f"{runs} micro-batch runs, launches {counts}, on {card}")

        # the roll under traffic: the stream's first half resent at once
        # (queued on both replicas when the roll starts), the second half
        # while it runs
        half = FLEET_ROLL_REQUESTS // 2
        handles = [(i, router.submit(reqs[i], key=keys[i]))
                   for i in range(half)]
        refused = []

        def pump():
            for i in range(half, FLEET_ROLL_REQUESTS):
                try:
                    handles.append((i, router.submit(reqs[i],
                                                     key=keys[i])))
                except AdmissionError as e:
                    refused.append(e)
                time.sleep(0.001)

        t = threading.Thread(target=pump, daemon=True)
        queued = sum(not h.done() for _, h in handles)
        t0 = time.perf_counter()
        t.start()
        applied = router.rolling_reconfigure(FLEET_ROLL, drain_timeout=60)
        roll_s = time.perf_counter() - t0
        t.join(60)
        got = [(i, h.result(300)) for i, h in handles]
        check(not refused and len(got) == FLEET_ROLL_REQUESTS,
              f"fleet roll: {len(refused)} refused, {len(got)} served")
        check(applied == {f"r{i}": FLEET_ROLL
                          for i in range(FLEET_REPLICAS)},
              f"fleet roll: applied {applied}")
        fleet_hold([r for _, r in got], [want[i] for i, _ in got], "roll")
        during = sum(t0 <= h.t_submit <= t0 + roll_s for _, h in handles)
        out["roll"] = {"seconds": roll_s, "applied": applied,
                       "requests": len(got), "queued_at_start": queued,
                       "submitted_during": during, "refused": len(refused)}
        print(f"fleet rolling reconfigure to {FLEET_ROLL} under traffic: "
              f"{roll_s * 1e3:.1f} ms, {queued} requests in flight at its "
              f"start, {during} of {len(got)} submitted during it, none "
              f"refused, all equal, on {card}")
    finally:
        router.close()

    router = fleet_router(cfg, params, dev, plans={
        "r0": FaultPlan(crash_after_admit=FLEET_CRASH_AT)})
    try:
        router.warmup(sample)
        router.start()
        results, hs, wall = fleet_run(router, reqs, gaps, keys)
        st = router.stats()
    finally:
        router.close()
    fleet_hold(results, want, "r0 crashed")
    rerouted = [h for h in hs if h.reroutes]
    check(st["reroutes"] >= 1 and st["unhealthy"] == 1 and rerouted and
          all(h.replica == "r1" for h in rerouted) and
          st["counters"].get("requests_failed", 0) == 0,
          f"fleet crash: {st['reroutes']} reroutes, {st['unhealthy']} "
          f"unhealthy, {len(rerouted)} rerouted handles")
    out["crash"] = {"reroutes": st["reroutes"],
                    "unhealthy": st["unhealthy"],
                    "requests_s": len(reqs) / wall}
    print(f"fleet with r0 crashed after admission: {st['reroutes']} "
          f"re-executions on r1, every request equal, on {card}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_lib.main(["--fleet", "--replicas", "2", "--device", dev,
                        "--compilation-cache", str(OUT / "compile_cache")])
    text = buf.getvalue()
    lines = text.split("\n", 2)
    check(lines[0].startswith("compilation cache:") and
          lines[1].startswith("fleet: 2 replicas"),
          f"serve --fleet: {text[:300]}")
    rep = json.loads(lines[2])
    check(rep["failed"] == 0 and rep["unresolved"] == 0 and
          rep["completed"] == rep["offered"] - rep["rejected"] and
          rep["devices"] == ["cuda:0", "cuda:0"],
          f"serve --fleet: report {rep}")
    out["launcher"] = rep
    print(f"serve --fleet --replicas 2: {json.dumps(rep)} on {card}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- phase 10: training ---------------------------------------------------
TRAIN_STEPS = 20          # steps of the card's training run
TRAIN_EVAL_IMAGES = 64
TRAIN_EVAL_ATTACKS = ("none", "jpeg_50", "blur")
TRAIN_GRAD_RTOL = 1e-3    # a leaf's gradient, card vs CPU, of its max
TRAIN_LOSS_RTOL = 1e-5
WIDTH_GEO = dict(n_bits=60, depth=4, tile=32)   # the trainer's extractor
WIDTHS = (8, 24, 64)      # 8 and 24 newly built; 64 beside them


def decode_widths(dev, rng, card: str) -> dict:
    """The decode kernels at hidden widths 8 and 24 (and 64 beside
    them), the trainer's geometry (tile 32, depth 4): flat at every rung
    against its plain version at b 32 and a ragged 5, blocked on every
    candidate schedule and channel tile against its plain version and
    bit for bit against flat; call ms of both and the plain versions,
    bound at the rung's peak."""
    import torch
    from repro_torch.core.extractor import (init_extractor_numpy,
                                            pack_params, params_from_numpy)
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fused_extractor as fx
    out = {}
    for C in WIDTHS:
        p = params_from_numpy(init_extractor_numpy(
            2, channels=C, bias_scale=0.1, **WIDTH_GEO), dev)
        l = WIDTH_GEO["tile"]
        scheds = {s.to_string(): s
                  for s in at.candidate_schedules(32, C, "cuda")}
        for ct in fx.blocked_channel_tiles(C):
            s = at.Schedule(2, ct, True)
            scheds[s.to_string()] = s
        rec = {}
        for dtype in ("fp32", *RUNGS):
            pk = pack_params(p, dtype)
            err, berr = 0.0, 0.0
            for b in (32, 5):
                tiles = torch.as_tensor(rng.uniform(
                    -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
                flat = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
                want = fx.fused_extractor_plain(tiles, pk, with_embed=True)
                for g, w in zip(flat, want):
                    w = w.cpu().numpy()
                    e = float(np.abs(g.cpu().numpy() - w).max())
                    tol = logit_tol(w) if dtype == "fp32" else RUNG_ATOL
                    check(np.isfinite(e) and e <= tol,
                          f"width {C} {dtype} flat b={b}: max |err| {e} > "
                          f"{tol}")
                    err = max(err, e)
                if b != 32:
                    continue
                main = tiles
                for name, s in scheds.items():
                    kw = dict(batch_block=s.batch_block,
                              channel_tile=s.channel_tile,
                              double_buffer=s.double_buffer, with_embed=True)
                    got = fx.fused_extractor_blocked_cuda(tiles, pk, **kw)
                    bw = fx.fused_extractor_blocked_plain(tiles, pk, **kw)
                    torch.cuda.synchronize()
                    check(torch.equal(got[0], flat[0]) and
                          torch.equal(got[1], flat[1]),
                          f"width {C} {dtype} blocked {name} != flat")
                    e = float((got[0] - bw[0]).abs().max())
                    check(e <= (logit_tol(bw[0].cpu().numpy())
                                if dtype == "fp32" else RUNG_ATOL),
                          f"width {C} {dtype} blocked {name}: |err| {e}")
                    berr = max(berr, e)
            times = timings(lambda: fx.fused_extractor_cuda(main, pk),
                            lambda: fx.fused_extractor_plain(main, pk))
            bound_ms, by = decode_bound(pk, main, dtype)
            rec[dtype] = dict(max_abs_err=err, blocked_max_abs_err=berr,
                              schedules=len(scheds), bound_ms=bound_ms,
                              bound_by=by, **times)
            print(f"decode width {C} {dtype}: flat {times['ms']:.4f} ms, "
                  f"plain {times['plain_ms']:.4f} ms, bound "
                  f"{bound_ms:.3g} ms ({by}) at b=32, l=32, depth 4; max "
                  f"|err| {err:.3g}; {len(scheds)} blocked schedules == "
                  f"flat bit for bit, |err| vs plain {berr:.3g}; on {card}")
        out[str(C)] = rec
    return out


def phase_train(dev, rng, card: str) -> dict:
    """Training at ``ExtractorTrainConfig()``'s widths (tile 32, 128^2
    images, channels 24, depth 4, encoder 24 / 3, batch 32): one step's
    loss and gradients on the card against the CPU (every training
    attack in the batch); TRAIN_STEPS steps on the card, ms a step;
    ``evaluate`` on the card through the decode and RS kernels (their
    launches counted over it) against the CPU's; the decode kernels at
    widths 8 and 24; a few LDM pretrain and fine-tune steps."""
    import dataclasses
    import torch
    from repro_torch.core import extractor as ex
    from repro_torch.core import ldm, prng
    from repro_torch.core import train_extractor as te
    from repro_torch.kernels import ops
    from repro_torch.train import optimizer as opt_lib
    t_phase = time.perf_counter()
    cfg = te.ExtractorTrainConfig()
    pn = ex.params_to_numpy(te.init_train_params(cfg))
    tiles = te.batch_tiles(cfg, 0, prng.key(1))
    msgs = prng.randint(prng.key(2), (cfg.batch, 60), 0, 2)
    idx = (torch.arange(cfg.batch) % len(cfg.train_attacks)).to(torch.int32)
    loss_fn = te.make_loss_fn(cfg)
    res = {d: te.value_and_grad(loss_fn, ex.params_from_numpy(pn, d),
                                tiles.to(d), msgs.to(d), idx.to(d))
           for d in ("cpu", dev)}
    (lc, _), gc = res["cpu"]
    (lg, _), gg = res[dev]
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    grad_rel = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(
        min=1e-30)) for a, b in zip(opt_lib.tree_leaves(gg),
                                    opt_lib.tree_leaves(gc)))
    check(loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL,
          f"train step card vs CPU: loss rel {loss_rel:.3g} (limit "
          f"{TRAIN_LOSS_RTOL}), gradients rel {grad_rel:.3g} (limit "
          f"{TRAIN_GRAD_RTOL}): TF32 or a wrong kernel")
    out = {"step_vs_cpu": {"loss": float(lg), "loss_rel_err": loss_rel,
                           "grad_rel_err": grad_rel}}
    print(f"train step at ExtractorTrainConfig() widths, every attack in "
          f"the batch: loss {float(lg):.6f}, card vs CPU loss rel "
          f"{loss_rel:.3g}, gradients rel {grad_rel:.3g}, on {card}")

    run = te.train(dataclasses.replace(cfg, steps=TRAIN_STEPS),
                   log_every=1, verbose=False, device=dev, init_params=pn)
    losses = [r["loss"] for r in run["history"]]
    walls = [r["wall_s"] for r in run["history"]]
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
          f"train: losses {losses}")
    step_ms = statistics.median(np.diff(walls)) * 1e3
    out["run"] = {"steps": TRAIN_STEPS, "losses": losses,
                  "ms_a_step": step_ms, "wall_s": walls[-1]}
    print(f"train {TRAIN_STEPS} steps on the card: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {step_ms:.2f} ms a step (median), on {card}")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ev = te.evaluate(run["params"], cfg, n_images=TRAIN_EVAL_IMAGES,
                     attacks=TRAIN_EVAL_ATTACKS, device=dev)
    torch.cuda.synchronize()
    counts, kcounts = ops.launch_counts(), ops.kernel_launch_counts()
    n = len(TRAIN_EVAL_ATTACKS)
    check(counts["fused_extractor"] == n and counts["rs_decode"] == n and
          sum(counts.values()) == 2 * n,
          f"evaluate: launches {counts}")
    check(kcounts.get("conv_regtile_kernel<qr::RF32,24,24>") == 3 * n and
          kcounts.get("gap_corr_regtile_kernel<qr::RF32,24>") == n,
          f"evaluate: decode kernels {kcounts}")
    ev_cpu = te.evaluate(ex.params_to_numpy(run["params"]), cfg,
                         n_images=TRAIN_EVAL_IMAGES,
                         attacks=TRAIN_EVAL_ATTACKS, device="cpu")
    for atk in TRAIN_EVAL_ATTACKS:
        d = abs(ev[atk]["bit_acc"] - ev_cpu[atk]["bit_acc"])
        check(d <= 0.01, f"evaluate {atk}: bit_acc card "
              f"{ev[atk]['bit_acc']} vs CPU {ev_cpu[atk]['bit_acc']}")
    out["evaluate"] = {"card": ev, "cpu": ev_cpu, "launches": counts,
                       "kernel_launches": kcounts}
    print(f"evaluate on the card ({TRAIN_EVAL_IMAGES} images, "
          f"{TRAIN_EVAL_ATTACKS}): {json.dumps(ev)}; launches {counts}; "
          f"CPU bit_acc {[ev_cpu[a]['bit_acc'] for a in TRAIN_EVAL_ATTACKS]}"
          f", on {card}")

    out["widths"] = decode_widths(dev, rng, card)

    t0 = time.perf_counter()
    ae = ldm.pretrain_autoencoder(torch.Generator().manual_seed(0),
                                  img_size=64, steps=3, batch=8, device=dev)
    ft = ldm.finetune_decoder(ae, run["params"]["dec"], tile=cfg.tile,
                              img_size=64, steps=3, batch=4, device=dev)
    check(all(np.isfinite(h["loss"]) for h in ft.history),
          f"finetune: {ft.history}")
    out["finetune"] = {"history": ft.history,
                       "seconds": time.perf_counter() - t0}
    print(f"ldm: 3 pretrain and 3 finetune_decoder steps on the card, "
          f"{ft.history}, {out['finetune']['seconds']:.1f} s, on {card}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- phase 11: the LM seed code ---------------------------------------------
LM_LOSS_RTOL = 1e-5       # fp32 loss, card vs CPU
LM_GRAD_RTOL = 1e-3       # a gradient leaf, of 1 + its max |g| on the CPU
LM_BF16_RTOL = 1e-2       # bf16 loss, card vs CPU; resumed vs uninterrupted
LM_DECODE_ATOL = 0.15     # a decode step's logits vs a prefill's
LM_SMOLLM = dict(batch=8, seq=512, steps=6, ckpt_every=2, crash_at=5)
LM_DECODE = dict(batch=4, prompt=512, steps=16)
# the other families at their published widths, cut in depth only:
# (arch, layers kept, (b, s) of the train step or None, prefill batch,
# prompt, decode steps)
LM_FAMILIES = (("granite-moe-3b-a800m", 2, (4, 512), 4, 512, 4),
               ("mamba2-2.7b", 2, (4, 512), 4, 512, 4),
               ("h2o-danube-3-4b", 1, None, 1, 4608, 8))


def lm_batch(cfg, b: int, s: int, dev, seed: int = 0) -> dict:
    """The launcher's first batch (``lm_batches``) for ``cfg`` on ``dev``."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import lm_batches
    batch = next(lm_batches(cfg, ShapeSpec("smoke", s, b, "train"),
                            n_steps=1, seed=seed))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def lm_loss_grads(model, batch, dtype):
    """The train step's loss and gradients (one per leaf of
    ``param_tree``), without the update."""
    import torch
    from repro_torch.models import lm
    from repro_torch.train.optimizer import tree_leaves
    leaves = tree_leaves(lm.param_tree(model))
    loss = lm.forward_train(model, batch, compute_dtype=dtype, remat=False)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def lm_card_vs_cpu(dev, card: str) -> dict:
    """Every arch at ``reduced``: one fp32 train step's loss and gradients
    on the card against the CPU from the same weights (TF32 off: the step
    refuses it), the MoE layers' routing on the same inputs, and the bf16
    loss; then one ``make_train_step`` step on the card."""
    import torch
    from repro_torch.configs import base
    from repro_torch.models import lm, moe
    from repro_torch.train import optimizer as opt_lib, step as step_lib
    check(torch.get_float32_matmul_precision() == "highest" and
          not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls are set to TF32")
    out = {}
    for arch in sorted(base.all_configs()):
        cfg = base.reduced(base.get_config(arch))
        tree = lm.lm_params_to_numpy(lm.init_params(cfg, 0, device="cpu"))
        models = {d: lm.lm_params_from_numpy(tree, cfg, d)
                  for d in ("cpu", dev)}
        seen = []
        hooks = [l.moe.register_forward_pre_hook(
            lambda m, a: seen.append((m, a[0].detach().reshape(
                -1, a[0].shape[-1]))))
            for l in models["cpu"].layers if hasattr(l, "moe")]
        res = {d: lm_loss_grads(models[d], lm_batch(cfg, 2, 32, d),
                                torch.float32) for d in models}
        for h in hooks:
            h.remove()
        (lc, gc), (lg, gg) = res["cpu"], res[dev]
        loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
        grad_rel = max(float((a.cpu() - b).abs().max() / (1 + b.abs().max()))
                       for a, b in zip(gg, gc))
        card_moes = [l.moe for l in models[dev].layers if hasattr(l, "moe")]
        routes_equal = all(torch.equal(
            moe.route(cm, x.to(dev), cfg.moe)[2].cpu(),
            moe.route(m, x, cfg.moe)[2]) for (m, x), cm in zip(seen,
                                                                 card_moes))
        bf = {d: float(lm.forward_train(models[d], lm_batch(cfg, 2, 32, d),
                                        remat=False).detach())
              for d in models}
        bf_rel = abs(bf[dev] - bf["cpu"]) / abs(bf["cpu"])
        step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(),
                                        compute_dtype=torch.float32)
        ost = opt_lib.init_opt_state(lm.param_tree(models[dev]))
        _, _, met = step(models[dev], ost, lm_batch(cfg, 2, 32, dev))
        step_rel = abs(float(met["loss"]) - float(lc)) / abs(float(lc))
        check(loss_rel <= LM_LOSS_RTOL and grad_rel <= LM_GRAD_RTOL and
              routes_equal and bf_rel <= LM_BF16_RTOL and
              step_rel <= LM_LOSS_RTOL,
              f"{arch} reduced card vs CPU: fp32 loss rel {loss_rel:.3g}, "
              f"gradients {grad_rel:.3g}, routes equal {routes_equal}, "
              f"bf16 loss rel {bf_rel:.3g}, step loss rel {step_rel:.3g}")
        out[arch] = {"loss": float(lc), "loss_rel_err": loss_rel,
                     "grad_err": grad_rel, "moe_layers": len(seen),
                     "routes_equal": routes_equal,
                     "bf16_loss_rel_err": bf_rel,
                     "step_loss_rel_err": step_rel}
    print(f"lm: the ten archs at reduced, card vs CPU: fp32 loss rel <= "
          f"{max(r['loss_rel_err'] for r in out.values()):.3g}, gradients "
          f"<= {max(r['grad_err'] for r in out.values()):.3g}, MoE routes "
          f"equal in {sum(r['moe_layers'] for r in out.values())} layers, "
          f"bf16 loss rel <= "
          f"{max(r['bf16_loss_rel_err'] for r in out.values()):.3g}, "
          f"on {card}")
    return out


def lm_launch(ckpt_dir, *extra) -> tuple:
    """``python -m repro_torch.launch.train`` at smollm-360m's full width
    (LM_SMOLLM) -> (exit code, stdout, the history JSON it printed)."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "smollm-360m", "--batch", str(LM_SMOLLM["batch"]),
           "--seq", str(LM_SMOLLM["seq"]), "--steps",
           str(LM_SMOLLM["steps"]), "--ckpt-every",
           str(LM_SMOLLM["ckpt_every"]), "--ckpt-dir", str(ckpt_dir),
           "--log-every", "1", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    hist = None
    if p.returncode == 0:
        hist = json.loads(p.stdout[p.stdout.rindex("\n[\n") + 1:])
    return p.returncode, p.stdout + p.stderr[-3000:], hist


def lm_smollm_train(dev, card: str) -> dict:
    """smollm-360m at full width and depth through the launcher: a run
    killed before step 5, its resume, and an uninterrupted run in this
    process (ms a step, tokens/s, peak memory)."""
    import shutil
    import torch
    from repro_torch.ckpt import checkpoint as ckpt_lib
    from repro_torch.configs import base
    from repro_torch.launch import train
    ckpt = OUT / "lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    rc, log, _ = lm_launch(ckpt, "--simulate-failure",
                           str(LM_SMOLLM["crash_at"]))
    last = ckpt_lib.latest_step(ckpt)
    check(rc == 42 and last in (2, 4),
          f"smollm crash run: exit {rc}, latest step {last}: {log[-2000:]}")
    t_crash = time.perf_counter() - t0
    rc, log, resumed = lm_launch(ckpt)
    check(rc == 0 and f"resumed from step {last}" in log,
          f"smollm resume: exit {rc}: {log[-2000:]}")
    t_resume = time.perf_counter() - t0 - t_crash
    shutil.rmtree(ckpt, ignore_errors=True)

    cfg = base.get_config("smollm-360m")
    b, s = LM_SMOLLM["batch"], LM_SMOLLM["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = train.train_loop(cfg, base.ShapeSpec("smoke", s, b, "train"),
                           steps=LM_SMOLLM["steps"], device=dev,
                           log_every=1, verbose=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in run["history"]]
    by_step = {h["step"]: h["loss"] for h in run["history"]}
    rel = max(abs(h["loss"] - by_step[h["step"]]) / abs(by_step[h["step"]])
              for h in resumed)
    check(all(np.isfinite(losses)) and
          all(np.isfinite(h["loss"]) for h in resumed) and
          rel <= LM_BF16_RTOL,
          f"smollm: losses {losses}, resumed {resumed}, rel {rel:.3g}")
    walls = [h["wall_s"] for h in run["history"]]
    step_ms = statistics.median(np.diff(walls)) * 1e3
    n = sum(p.numel() for p in run["model"].parameters())
    out = {"params": n, "batch": b, "seq": s, "losses": losses,
           "resumed_from": last, "resumed": resumed,
           "resumed_loss_rel_err": rel, "ms_a_step": step_ms,
           "tokens_per_s": b * s / step_ms * 1e3,
           "first_step_s": walls[0], "max_memory_allocated": peak,
           "n_micro": run["plan"].n_micro, "crash_run_s": t_crash,
           "resume_run_s": t_resume}
    del run
    torch.cuda.empty_cache()
    print(f"lm: smollm-360m full width ({n} parameters), b {b} s {s} bf16: "
          f"crashed before step {LM_SMOLLM['crash_at']} (exit 42), resumed "
          f"from step {last}, resumed losses rel {rel:.3g} of an "
          f"uninterrupted run's; {step_ms:.2f} ms a step (median), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB; on {card}")
    return out


def lm_decode(model, tokens, steps: int, hold: bool = True,
              dtype=None) -> dict:
    """Prefill ``tokens`` (b, s) with room for ``steps`` more, then
    ``steps`` greedy decode steps, each step's logits held (unless not
    ``hold``) against a prefill of the extended prompt; prefill ms
    (median of 3) and ms a decode step (median).  bf16 compute unless
    ``dtype`` says otherwise."""
    import torch
    from repro_torch.train import step as step_lib
    cfg = model.cfg
    s = tokens.shape[1]
    kw = dict(compute_dtype=dtype or torch.bfloat16)
    prefill = step_lib.make_prefill_step(cfg, max_len=s + steps, **kw)
    plain = step_lib.make_prefill_step(cfg, **kw)
    decode = step_lib.make_decode_step(cfg, **kw)
    pre_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    tok = logits.argmax(-1)
    seq, errs, dec_ms = tokens, [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = decode(model, tok, state)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t0) * 1e3)
        seq = torch.cat([seq, tok], dim=1)
        want, _ = plain(model, {"tokens": seq})
        errs.append(float((logits.float() - want.float()).abs().max()))
        check(np.isfinite(errs[-1]) and (errs[-1] < LM_DECODE_ATOL or
                                         not hold),
              f"{cfg.name} decode step {len(errs)}: |logits - prefill| "
              f"{errs[-1]:.4g} (limit {LM_DECODE_ATOL})")
        tok = logits.argmax(-1)
    return {"batch": tokens.shape[0], "prompt": s, "steps": steps,
            "compute_dtype": str(kw["compute_dtype"]).split(".")[-1],
            "max_abs_err": max(errs), "errs": errs,
            "prefill_ms": statistics.median(pre_ms),
            "ms_a_decode_step": statistics.median(dec_ms)}


def lm_full_width(dev, card: str) -> dict:
    """smollm-360m's prefill and decode at full width and depth, then the
    other families at their published widths, cut in depth only."""
    import dataclasses
    import torch
    from repro_torch.configs import base
    from repro_torch.data.pipeline import token_batch
    from repro_torch.models import lm, moe
    from repro_torch.train import optimizer as opt_lib, step as step_lib
    out = {}
    cfg = base.get_config("smollm-360m")
    model = lm.init_params(cfg, 1, device=dev)
    d = LM_DECODE
    toks = torch.from_numpy(token_batch(0, d["batch"], d["prompt"],
                                        cfg.vocab)).to(dev)
    out["smollm-360m"] = {"cut": None, **lm_decode(model, toks, d["steps"])}
    del model
    for arch, layers, train_bs, b, prompt, steps in LM_FAMILIES:
        cfg = dataclasses.replace(base.get_config(arch), n_layers=layers)
        model = lm.init_params(cfg, 1, device=dev)
        rec = {"cut": f"n_layers {base.get_config(arch).n_layers} -> "
                      f"{layers}"}
        if train_bs is not None:
            tb, ts = train_bs
            step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig())
            ost = opt_lib.init_opt_state(lm.param_tree(model))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, ost, met = step(model, ost, lm_batch(cfg, tb, ts, dev))
            loss = float(met["loss"])
            check(np.isfinite(loss), f"{arch}: train step loss {loss}")
            rec["train"] = {"batch": tb, "seq": ts, "loss": loss,
                            "first_step_s": time.perf_counter() - t0}
            if cfg.moe is not None:
                rec["train"]["capacity"] = moe.capacity(tb * ts, cfg.moe)
            del ost
        toks = torch.from_numpy(token_batch(0, b, prompt,
                                            cfg.vocab)).to(dev)
        kw = {}
        if cfg.moe is not None:
            # a prefill of b x s tokens drops the choices past an
            # expert's capacity, a decode step of b tokens none, and in
            # bf16 a near tie among the router's top-k can fall either
            # way on the two paths: recorded as published (bf16), held
            # in fp32 at a capacity no expert can fill
            rec["published_capacity"] = lm_decode(model, toks, steps,
                                                  hold=False)
            cf = cfg.moe.n_experts / cfg.moe.top_k
            for layer in model.layers:
                if hasattr(layer, "moe"):
                    layer.moe.moe = dataclasses.replace(
                        layer.moe.moe, capacity_factor=cf)
            rec["decode_capacity_factor"] = cf
            kw = dict(dtype=torch.float32)
        rec.update(lm_decode(model, toks, steps, **kw))
        out[arch] = rec
        del model
        torch.cuda.empty_cache()
    for arch, r in out.items():
        print(f"lm: {arch} ({r['cut'] or 'full depth'}): prefill "
              f"{r['batch']} x {r['prompt']} {r['prefill_ms']:.2f} ms, "
              f"{r['steps']} decode steps {r['ms_a_decode_step']:.2f} ms a "
              f"step, |decode - prefill| <= {r['max_abs_err']:.4g}"
              + f" ({r['compute_dtype']}"
              + (f", capacity factor {r['decode_capacity_factor']}; "
                 f"{r['published_capacity']['max_abs_err']:.4g} at bf16 "
                 f"and the published one" if "published_capacity" in r
                 else "") + ")"
              + (f", train step loss {r['train']['loss']:.4f}"
                 if "train" in r else "") + f"; on {card}")
    return out


def phase_lm(dev, card: str) -> dict:
    """The LM seed code on the card (none of the hand kernels): the ten
    archs at ``reduced`` against the CPU, smollm-360m at full width
    through the launcher (crash, resume) and through prefill and decode,
    and the other families at their published widths, cut in depth."""
    t0 = time.perf_counter()
    out = {"card_vs_cpu": lm_card_vs_cpu(dev, card)}
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    out["smollm_train"] = lm_smollm_train(dev, card)
    out["full_width"] = lm_full_width(dev, card)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"lm": out, "card": card}))
    return out


# The LM's dry-run (phase_dryrun): the cells run as ``python -m
# repro_torch.launch.dryrun``, one process a row, all at once, while the
# one-card check uses the card
DRYRUN_CELLS = (("smollm-360m", "train_4k", "both"),
                ("smollm-360m", "prefill_32k", "both"),
                ("smollm-360m", "decode_32k", "both"),
                ("smollm-360m", "long_500k", "both"),
                ("granite-moe-3b-a800m", "train_4k", "single"),
                ("mamba2-2.7b", "long_500k", "single"))
DRYRUN_TIMEOUT_S = 300    # the cell processes' limit (each ~10-60 s)
# the one-card check at the LM phase's own shapes: (mode, batch, seq)
DRYRUN_CARD = (("train", LM_SMOLLM["batch"], LM_SMOLLM["seq"]),
               ("prefill", 4, 512), ("decode", 4, 512))


def dryrun_start(out_dir: Path) -> list:
    """Start one ``python -m repro_torch.launch.dryrun`` a DRYRUN_CELLS
    row (probes on), each writing its cells' records into ``out_dir``."""
    import os
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out",
               str(out_dir), "--force"]
        procs.append(((arch, shape, mesh), subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def dryrun_finish(procs: list, out_dir: Path, t0: float, card: str) -> dict:
    """Wait for the cell processes (killing any still running on a
    failure) and hold their records: every enabled cell ``ok`` with its
    derived terms, every other ``skipped`` with ``cell_enabled``'s
    reason."""
    from repro_torch.configs import base
    try:
        for cell, p in procs:
            log, _ = p.communicate(timeout=max(
                1.0, t0 + DRYRUN_TIMEOUT_S - time.perf_counter()))
            check(p.returncode == 0, f"dryrun {cell}: exit {p.returncode}: "
                  f"{log[-3000:]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cells = {}
    for arch, shape_name, mesh in DRYRUN_CELLS:
        cfg = base.get_config(arch)
        shape = base.SHAPES_BY_NAME[shape_name]
        enabled, why = base.cell_enabled(cfg, shape)
        for m in (("single", "multi") if mesh == "both" else (mesh,)):
            rec = json.loads((out_dir / f"{arch}__{shape_name}__{m}__"
                              "baseline.json").read_text())
            key = f"{arch}/{shape_name}/{m}"
            if not enabled:
                check(rec["status"] == "skipped" and rec["reason"] == why,
                      f"dryrun {key}: {rec.get('status')} "
                      f"{rec.get('reason')!r}, want skipped {why!r}")
                cells[key] = {"status": "skipped", "reason": rec["reason"]}
                print(f"dryrun: {key} skipped: {rec['reason']}")
                continue
            check(rec["status"] == "ok" and "derived" in rec,
                  f"dryrun {key}: {rec.get('status')}: "
                  f"{rec.get('error', '')}")
            d = rec["derived"]
            counted = d["flops_per_device"] * rec["plan"]["n_chips"]
            cells[key] = {
                "status": "ok", "plan": rec["plan"],
                "probe_s": rec["probe_s"], "memory": rec["memory"],
                **{k: d[k] for k in (
                    "dominant", "roofline_bound_s", "t_compute_s",
                    "t_memory_s", "t_collective_s", "flops_per_device",
                    "hbm_bytes_per_device", "coll_bytes_per_device",
                    "model_flops", "useful_flops_ratio")},
                "counted_over_model_flops": counted / d["model_flops"]}
            print(f"dryrun: {key} ok: dominant {d['dominant']}, roofline "
                  f"bound {d['roofline_bound_s']:.6g} s a step at the H100 "
                  f"peaks (compute {d['t_compute_s']:.4g}, memory "
                  f"{d['t_memory_s']:.4g}, collective "
                  f"{d['t_collective_s']:.4g}), counted FLOPs "
                  f"{cells[key]['counted_over_model_flops']:.4f}x the "
                  f"model's, probes {rec['probe_s']:.1f} s (host)")
    return cells


def dryrun_step(cfg, shape, dev) -> dict:
    """The real step of a DRYRUN_CARD row on the card: median ms of 5
    after a warm-up, and the peak bytes allocated above what its
    arguments hold."""
    import gc
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib, step as step_lib
    gc.collect()  # the traces' models, held in reference cycles
    torch.cuda.empty_cache()
    model = dryrun.build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    if shape.mode == "train":
        opt = opt_lib.init_opt_state(lm.param_tree(model))
        tokens = torch.randint(0, cfg.vocab, (shape.global_batch,
                                              shape.seq_len),
                               generator=gen, device=dev)
        train_step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig())

        def run():
            train_step(model, opt, {"tokens": tokens})
    else:
        inputs = dryrun.step_inputs(cfg, shape, dev)

        @torch.no_grad()
        def run():
            if shape.mode == "prefill":
                lm.forward_prefill(model, inputs["batch"])
            else:
                lm.forward_decode(model, inputs["tokens"], inputs["state"])
    run()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(5):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del model, run
    torch.cuda.empty_cache()
    return {"ms": statistics.median(ms), "resident_bytes": resident,
            "max_memory_allocated": peak, "peak_above_resident": peak - resident}


def dryrun_card(dev, card: str) -> dict:
    """smollm-360m at a 1 x 1 plan, full depth, at DRYRUN_CARD's shapes:
    the FLOPs the meta trace counts equal ``FlopCounterMode``'s count of
    the same step on the card, and the argument bytes from the specs
    equal the bytes of the parameters, AdamW moments and inputs made on
    the card; beside them (not gated) the unfused bytes of both, the temp
    estimate against the real step's peak, and its ms against the
    roofline bound."""
    import torch
    from repro_torch.configs import base
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.sharding import planner
    cfg = base.get_config("smollm-360m")
    mesh = mesh_lib.ShapeMesh(("data", "model"), (1, 1))
    out = {}
    for mode, b, s in DRYRUN_CARD:
        shape = base.ShapeSpec(f"card_{mode}", s, b, mode)
        plan = planner.make_plan(cfg, shape, mesh)
        meta = dryrun.trace_cell(cfg, shape, plan)
        on_card = dryrun.trace_cell(cfg, shape, plan, device=dev)
        check(meta["flops"] == on_card["flops"],
              f"dryrun {mode}: meta counted {meta['flops']} FLOPs, the "
              f"card {on_card['flops']}")
        rec = dryrun.cell_record(cfg, shape, mesh, plan)
        args = rec["memory"]["argument_size_in_bytes"]
        made = dryrun.materialized_argument_bytes(cfg, shape, dev)
        torch.cuda.empty_cache()
        check(args == made, f"dryrun {mode}: argument bytes {args} from the "
              f"specs, {made} made on the card")
        step = dryrun_step(cfg, shape, dev)
        temp = rec["memory"]["temp_size_in_bytes"]
        bound = rec["derived"]["roofline_bound_s"] * 1e3
        out[mode] = {
            "batch": b, "seq": s, "flops": meta["flops"],
            "flops_equal": True, "argument_bytes": args,
            "argument_bytes_equal": True,
            "unfused_bytes_meta": meta["bytes"],
            "unfused_bytes_card": on_card["bytes"],
            "temp_estimate": temp, **step,
            "temp_over_peak_above_resident":
                temp / max(step["peak_above_resident"], 1),
            "roofline_bound_ms": bound,
            "dominant": rec["derived"]["dominant"],
            "ms_over_bound": step["ms"] / bound,
            "probe_s": rec["probe_s"], "meta_trace_s": meta["seconds"],
            "card_trace_s": on_card["seconds"]}
        print(f"dryrun: smollm-360m {mode} b {b} s {s} on a 1 x 1 plan: "
              f"{meta['flops']} FLOPs counted on meta == on the card; "
              f"argument bytes {args} == made on the card; unfused bytes "
              f"meta {meta['bytes']}, card {on_card['bytes']}; temp "
              f"estimate {temp / 2**20:.1f} MiB vs "
              f"{step['peak_above_resident'] / 2**20:.1f} MiB above the "
              f"resident arguments at the step's peak (max_memory_allocated"
              f" {step['max_memory_allocated'] / 2**30:.2f} GiB), ratio "
              f"{out[mode]['temp_over_peak_above_resident']:.3f}; "
              f"{step['ms']:.3f} ms a step (median of 5) vs a roofline bound"
              f" of {bound:.4f} ms ({rec['derived']['dominant']}); on {card}")
    return out


def phase_dryrun(dev, card: str) -> dict:
    """The LM's dry-run: the DRYRUN_CELLS cells through the CLI in
    parallel processes on the host (meta), and meanwhile the one-card
    check on the card."""
    t0 = time.perf_counter()
    out_dir = OUT / "dryrun"
    procs = dryrun_start(out_dir)
    try:
        card_check = dryrun_card(dev, card)
    except BaseException:
        for _, p in procs:
            p.kill()
            p.wait()
        raise
    t_card = time.perf_counter() - t0
    cells = dryrun_finish(procs, out_dir, t0, card)
    out = {"cells": cells, "card_check": card_check, "card_check_s": t_card,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"dryrun": out, "card": card}))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir() \
            or not GOLDEN.is_file():
        print(f"chip_smoke: the repository's sources are not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t_script = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.build_info['path']})")
    OUT.mkdir(parents=True, exist_ok=True)
    log = str(_build.build_info.get("log", ""))
    (OUT / "ptxas.log").write_text(log)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    regs = _build.kernel_registers(log)
    phases = {"fused_tile_preprocess": phase_ingest(dev, rng),
              "fused_extractor": phase_extractor(dev, rng),
              "rs_decode": phase_rs(dev, rng, card, regs),
              "fused_preprocess": phase_preprocess(dev, rng, regs)}
    tile_plan = phase_tile_plan(dev, card, regs)
    phases["fused_extractor_blocked"], cache, winner = phase_blocked(
        dev, rng, card, regs)
    rungs, winner8 = phase_rungs(dev, rng, card, cache, regs)
    parts, cudnn_ms = phase_decode_parts(dev, rng, card, regs)
    phases["fused_extractor"].update(parts=parts,
                                     cudnn_conv_yardstick_ms=cudnn_ms)
    parts8, int_mm_ms = phase_decode_parts(dev, rng, card, regs, "int8")
    rungs["int8"]["fused_extractor"].update(
        parts=parts8, int_mm_yardstick_ms=int_mm_ms, imma_sass=imma_sass(card))
    for name, r in phases.items():
        print(f"{name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.3g} ms ({r['bound_by']}), max |err| "
              f"{r['max_abs_err']:.3g}, batch 32, on {card}")
    counts, kernel_counts, pipe, batches, results = phase_end_to_end(card)
    window_ips = phase_throughput(pipe, batches, card)
    traced = profile_path(pipe, batches, card)
    check_part_launches(parts, kernel_counts, traced, len(batches))
    # the ingest's and RS's device ms a launch in that pass
    head = parts[3]
    hits = [v for k, v in (traced or {}).items()
            if f"::{head['kernel']}(" in k]
    head["serve_device_ms"] = hits[0][1] / hits[0][0] if hits else None
    phases["fused_extractor"]["serve_device_ms"] = decode_device_ms(
        traced, len(batches))
    print(f"{head['kernel']}: {head['serve_device_ms']} ms of device time a "
          f"launch, the decode {phases['fused_extractor']['serve_device_ms']}"
          f" ms a batch, in the default path's profiled pass, on {card}")
    for name, kernel in (("fused_tile_preprocess", INGEST_KERNEL),
                         ("rs_decode", RS_KERNEL)):
        hits = [v for k, v in (traced or {}).items() if f"::{kernel}(" in k]
        phases[name]["serve_device_ms"] = (hits[0][1] / hits[0][0]
                                           if hits else None)
        print(f"{name}: {phases[name]['serve_device_ms']} ms of device time "
              f"a launch in the default path's profiled pass, on {card}")
    configs = phase_configs(batches, results,
                            statistics.median(window_ips), cache, winner,
                            winner8, card, parts8)
    phases["fused_preprocess"]["serve_device_ms"] = \
        configs["staged"]["ingest_device_ms"]
    print(f"fused_preprocess: {phases['fused_preprocess']['serve_device_ms']}"
          f" ms of device time a launch in the staged path's profiled pass, "
          f"on {card}")
    escalation = phase_escalation(dev, rng, card, batches)
    t_lanes = time.perf_counter()
    lanes = phase_lanes(batches, card)
    print(f"lanes phase: {time.perf_counter() - t_lanes:.1f} s")
    t_online = time.perf_counter()
    online = phase_online(batches, card)
    print(f"online phase: {time.perf_counter() - t_online:.1f} s")
    fleet = phase_fleet(batches, card)
    print(f"fleet phase: {fleet['seconds']:.1f} s")
    train = phase_train(dev, rng, card)
    print(f"train phase: {train['seconds']:.1f} s")
    lm_phase = phase_lm(dev, card)
    print(f"lm phase: {lm_phase['seconds']:.1f} s")
    dryrun = phase_dryrun(dev, card)
    print(f"dryrun phase: {dryrun['seconds']:.1f} s")
    phase_golden()
    phases["rs_decode"]["device_ms"] = rs_device_ms(dev, rng, card)

    # launches: each kernel's count on the path that runs it (the
    # default path, or its own configuration's serve run)
    launches = dict(counts)
    launches["fused_preprocess"] = \
        configs["staged"]["launches"]["fused_preprocess"]
    launches["fused_extractor_blocked"] = \
        configs["blocked"]["launches"]["fused_extractor_blocked"]
    meta = {
        "fused_tile_preprocess": (
            "src/repro_torch/kernels/csrc/tile_preprocess.cu",
            "src/repro/kernels/fused_tile_preprocess.py:68"),
        "fused_extractor": (
            "src/repro_torch/kernels/csrc/fused_extractor.cu",
            "src/repro/kernels/fused_extractor.py:82"),
        "rs_decode": ("src/repro_torch/kernels/csrc/rs_decode.cu",
                      "src/repro/kernels/rs_decode.py:202"),
        "fused_preprocess": (
            "src/repro_torch/kernels/csrc/tile_preprocess.cu",
            "src/repro/kernels/fused_preprocess.py:63"),
        "fused_extractor_blocked": (
            "src/repro_torch/kernels/csrc/fused_extractor.cu",
            "src/repro/kernels/fused_extractor.py:149"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the decode kernels' lower rungs: launches from the serve runs that
    # drive them (the blocked bf16 rung has none, its launches null)
    rung_launches = {
        "fused_extractor": {
            "bf16": configs["bf16"]["launches"]["fused_extractor"],
            "int8": configs["int8"]["launches"]["fused_extractor"]},
        "fused_extractor_blocked": {
            "bf16": configs["bf16-blocked"]["launches"][
                "fused_extractor_blocked"],
            "int8": configs["int8-blocked"]["launches"][
                "fused_extractor_blocked"]}}
    kernels = []
    for name, (src, rep) in meta.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches[name],
                 **{k: phases[name][k] for k in keys}}
        if name == "fused_extractor":
            # each CUDA kernel of the flat decode, with its launches in
            # the main path's run
            entry["parts"] = phases[name]["parts"]
            entry["cudnn_conv_yardstick_ms"] = \
                phases[name]["cudnn_conv_yardstick_ms"]
        if name == "rs_decode":
            entry.update({k: phases[name][k] for k in (
                "kernel", "device_ms", "serve_device_ms", "registers",
                "stack_bytes", "cumulative_stack_bytes", "spill_bytes",
                "large_b")})
        if name in ("fused_tile_preprocess", "fused_extractor",
                    "fused_preprocess"):
            entry["serve_device_ms"] = phases[name]["serve_device_ms"]
        if name in ONLINE_KERNELS:
            # launches a micro-batch of the online server's seeded
            # stream, at fp32 and int8
            entry["online_launches_a_micro_batch"] = {
                dt: online["rungs"][dt]["launches_a_micro_batch"][name]
                for dt in ("fp32", "int8")}
            # launches over the fleet's run of its seeded stream
            entry["fleet_launches"] = fleet["stream"]["launches"][name]
        if name in ("fused_extractor", "rs_decode"):
            # launches over the trained pair's evaluate on the card
            entry["train_evaluate_launches"] = \
                train["evaluate"]["launches"][name]
        if name == "fused_extractor":
            # flat at hidden widths 8, 24 (and 64), every rung, b = 32
            entry["widths"] = {c: {dt: {k: r[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
                for dt, r in w.items()} for c, w in train["widths"].items()}
        if name == "fused_extractor_blocked":
            entry["widths"] = {c: {dt: {
                "max_abs_err": r["blocked_max_abs_err"],
                "schedules_bitwise_flat": r["schedules"]}
                for dt, r in w.items()} for c, w in train["widths"].items()}
        if name in ("fused_tile_preprocess", "fused_extractor",
                    "rs_decode"):
            # each counted run of the escalation path: one launch a
            # round that ran (one for all k tiles in decode_all_keyed)
            entry["escalation_launches"] = {
                "detect_batch_k3": escalation["counts"][name],
                **{f"serve_{dt}_k3": escalation["serve"][dt]["launches"][
                    name] for dt in ("fp32", "int8")}}
            if name != "rs_decode":
                entry["escalation_launches"]["decode_all_keyed"] = \
                    escalation["decode_all_counts"][name]
        if name == "fused_preprocess":
            entry.update({k: phases[name][k] for k in (
                "kernel", "registers", "spill_bytes",
                "interpolate_yardstick_ms")})
        if name == "fused_extractor_blocked":
            # each blocked conv instantiation alone, and the decode's
            # device ms a batch on the serve schedule's profiled pass
            entry["instantiations"] = phases[name]["instantiations"]
            entry["serve_device_ms"] = configs["blocked"]["decode_device_ms"]
        if name in rung_launches:
            entry["rungs"] = ["fp32", *RUNGS]
            entry["by_rung"] = {dt: {"launches": rung_launches[name][dt],
                                     **{k: rungs[dt][name][k] for k in keys}}
                                for dt in RUNGS}
            if name == "fused_extractor":
                # each CUDA kernel of the flat int8 decode, with its
                # launches in the --decode-dtype int8 serve run
                entry["by_rung"]["int8"].update(
                    {k: rungs["int8"][name][k] for k in (
                        "parts", "int_mm_yardstick_ms", "imma_sass")})
                for dt in RUNGS:
                    entry["by_rung"][dt]["serve_device_ms"] = \
                        configs[dt]["decode_device_ms"]
            else:
                for dt, cfg in (("bf16", "bf16-blocked"),
                                ("int8", "int8-blocked")):
                    entry["by_rung"][dt].update(
                        instantiations=rungs[dt][name]["instantiations"],
                        serve_device_ms=configs[cfg]["decode_device_ms"])
                entry["by_rung"]["int8"]["source"] = \
                    "src/repro_torch/kernels/csrc/fused_extractor_int8.cu"
        kernels.append(entry)
    # added by the port (no Pallas counterpart): launches of the counted
    # k = 3 detect_batch on the damaged batch, one a batch that escalated
    kernels.append({"name": "escalation_plan", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/tile_plan.cu",
                    "replaces": None,
                    "launches": escalation["counts"].get("escalation_plan",
                                                         0),
                    **tile_plan})
    phases["escalation_plan"] = tile_plan
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "phases": phases,
         "rungs": rungs, "window_ips": window_ips, "configs": configs,
         "escalation": escalation, "lanes": lanes, "online": online,
         "fleet": fleet, "train": train, "lm": lm_phase,
         "dryrun": dryrun},
        indent=1))
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all, "
          f"the kernels' build included, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
