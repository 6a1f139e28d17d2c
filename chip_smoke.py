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
   flat kernel, then an autotune sweep into
   ``build/chip_smoke/decode_schedules.json``; then the bf16 and int8
   rungs of both decode kernels at full width (flat at b=32, 1 and a
   ragged 5, blocked on every candidate and the explicit points at
   b=32 and 5, and the serve point at b=1) against their plain
   versions and, bitwise, blocked against flat; call ms of each and the
   ``ptxas -v`` registers and spills; and an int8 sweep into the same
   cache under its own key; then the flat fp32 decode's kernels one by
   one at b=32 (layer 0, a 64 -> 64 block, to_bits + GAP + corr, the
   head: ms per launch, bound, registers, spills) beside cuDNN's fp32
   conv2d on the same layer as a yardstick the port never calls; the RS
   syndrome kernel against the Berlekamp-Welch plain version on every
   single-symbol pattern of 16 codewords (and of 256 at B = 65536), on
   2-4 symbol errors and uniform words, its one kernel per call traced
   by the profiler, its call ms and ``ptxas -v`` registers, stack frame
   and spills (none);
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
   ``--decode-dtype bf16``, ``--decode-dtype int8`` and ``--decode-dtype
   int8 --schedule auto`` (from the int8 sweep) — checking each one's
   launch counts and its results against the default path's (the rungs'
   bits wherever the fp32 logit clears the rungs' margin), and prints
   images/s for each and the ratio of the default path's median window
   to each sequential run;
6. checks the default and the staged path, and the bf16 and int8 rungs,
   against the JAX package's golden outputs
   (``tests/data/torch_port_golden.npz``);
7. prints one ``{"kernels": [...]}`` line and, last, the status line.

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
def phase_preprocess(dev, rng):
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
    print("preprocess: staged tiles equal tile-first tiles exactly at "
          "every geometry")
    return dict(max_abs_err=err, bound_ms=bound_ms, bound_by=by,
                library_ms=None, **times)


# -- phase 3e: blocked decode schedules + autotune --------------------------
SERVE_SCHEDULE = "bb4-ct32-db"   # the explicit blocked point the serve
                                 # phase runs and the kernels line times
# explicit points outside the sweep: narrower channel tiles and a batch
# block that leaves ragged blocks at b=32
EXTRA_SCHEDULES = ("bb2-ct16", "bb3-ct8-db", "bb1-ct4")


def phase_blocked(dev, rng, card: str):
    """Every candidate schedule (and the extra points) at b=32 and a
    ragged b=5: the blocked kernel against its plain version on the same
    tiles (logits and embedding within the logit tolerance) and bitwise
    against the flat kernel; call ms of each at b=32."""
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
                **times), cache, winner


# -- phase 3f: the bf16 and int8 rungs of both decode kernels --------------
def kernel_registers(log: str) -> dict:
    """``ptxas -v`` per kernel: {name: (registers, spill stores, spill
    loads, stack frame bytes)}, names demangled where ``c++filt`` is
    there."""
    import re
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1))) + frame)
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [r[0] for r in rows]
    return {_without_args(n): r[1:] for n, r in zip(names, rows)}


def _without_args(name: str) -> str:
    """A demangled name without its trailing argument list (the name
    itself may hold parentheses: ``(anonymous namespace)::f``)."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += (name[i] == ")") - (name[i] == "(")
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


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
    at b=32 and 5, the serve point also at b=1; call ms (median of 20)
    of every schedule at b=32, the plain versions' ms, the bounds at the
    rung's peak.  Then an int8 autotune sweep into the same cache,
    under the int8 key, and "auto" at int8 resolving from it."""
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
            for sc in (scheds if b != 1 else [serve_sc]):
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
              f"{', '.join(EXTRA_SCHEDULES)}); on {card}:")
        for k in ("fused_extractor", "fused_extractor_blocked"):
            print(f"  {k}: {r[k]['ms']:.4f} ms, plain {r[k]['plain_ms']:.4f}"
                  f" ms, bound {r[k]['bound_ms']:.3g} ms ({by}), batch 32")
        print("  call ms at b=32: " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in sorted(sched_ms.items(),
                                               key=lambda kv: kv[1])))
        tag = {"bf16": "RBF16", "int8": "RI8"}[dtype]
        extra = {"bf16": "__nv_bfloat16", "int8": "quantize_rows"}[dtype]
        mine = {k: v for k, v in regs.items() if tag in k or extra in k}
        print("  registers / spill stores / spill loads: " + "; ".join(
            f"{k.replace('qr::', '').replace('void ', '')} {v[0]}/{v[1]}/"
            f"{v[2]}" for k, v in sorted(mine.items())))
        r["registers"] = mine
    pk8 = rung_pack(dev, "int8")
    winner = at.autotune(pk8, tile=l, batch=32, dtype="int8",
                         cache_path=cache, iters=5, warmup=2)
    entries = at.load_cache(cache)["entries"]
    check(sorted(k.split("|")[1] for k in entries) == ["fp32", "int8"],
          f"the cache should hold an fp32 and an int8 entry: {list(entries)}")
    hint = io.StringIO()
    with contextlib.redirect_stderr(hint):
        got = at.resolve_schedule("auto", dtype="int8", tile=l,
                                  channels=WIDTH["channels"],
                                  depth=WIDTH["depth"],
                                  n_bits=WIDTH["n_bits"], cache_path=cache,
                                  device=dev)
    check(hint.getvalue() == "" and got == winner,
          f"int8 auto did not resolve from the cache: {got} / "
          f"{hint.getvalue()}")
    name = "flat" if winner is None else winner.to_string()
    print(f"autotune int8: winner {name}, its own entry beside fp32's in "
          f"{cache.relative_to(ROOT)}; auto at int8 resolves to it")
    out["int8"]["winner"] = name
    return out, winner


# -- phase 3g: the flat fp32 decode's kernels one by one --------------------
def _regs_of(regs: dict, pattern: str):
    hits = [v for k, v in regs.items() if pattern in k.replace(" ", "")]
    return hits[0] if len(hits) == 1 else None


def phase_decode_parts(dev, rng, card: str, regs: dict):
    """The fp32 flat decode's CUDA kernels alone at b=32, full width, each
    on the inputs the decode gives it: layer 0 (cin 3 -> 64), a 64 -> 64
    hidden block, to_bits + GAP + corr, the head.  Per kernel: ms per
    launch (``call_ms`` over 10 back-to-back launches), its bound, the
    ``ptxas -v`` registers and spill bytes; its launches come from the
    main path's run (:func:`check_part_launches`).  Beside them, as a
    yardstick
    the port never calls, cuDNN's fp32 conv2d (TF32 off, channels_last)
    on the same 64 -> 64 layer: the conv alone, without bias, norm or
    ReLU, so not the kernel's library_ms."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_extractor as fx
    l, b, C, nb = FULL["tile"], 32, WIDTH["channels"], WIDTH["n_bits"]
    pk = rung_pack(dev, "fp32")
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = torch.as_tensor(rng.uniform(-2.0, 2.5, (b, l, l, 3)).astype(
        np.float32)).to(dev)
    blk0, blk1 = pk["blocks"][0], pk["blocks"][1]
    x1 = fx.conv_block(lib, tiles, blk0, 0, stream)
    x2 = fx.conv_block(lib, x1, blk1, 0, stream)
    parts = fx.to_bits_partials(lib, tiles, x2, pk, 0, stream)
    npix, n_parts = b * l * l, parts[0].shape[0]

    def conv_work(x, blk):
        cin, cout = x.shape[3], blk["w"].shape[-1]
        return (4 * (x.numel() + blk["w"].numel() + cout + npix * cout),
                npix * (2 * 9 * cin * cout + 8 * cout))

    tb = pk["to_bits"]
    rows = [
        ("conv layer 0 (3 -> 64)", fx.conv_kernel_name(0, 3, C),
         lambda: fx.conv_block(lib, tiles, blk0, 0, stream),
         *conv_work(tiles, blk0)),
        (f"conv hidden ({C} -> {C})", fx.conv_kernel_name(0, C, C),
         lambda: fx.conv_block(lib, x1, blk1, 0, stream),
         *conv_work(x1, blk1)),
        ("to_bits + GAP + corr", fx.to_bits_kernel_name(0, C, nb),
         lambda: fx.to_bits_partials(lib, tiles, x2, pk, 0, stream),
         4 * (x2.numel() + tiles.numel() + tb["w"].numel() + nb +
              pk["corr"].numel() + 2 * n_parts * nb),
         npix * (2 * 9 * C * nb + 2 * nb) + npix * 3 * (11 + 2 * nb)),
        ("head", fx.head_kernel_name(0, nb),
         lambda: fx.head_logits(lib, *parts, pk, 0, l, False, stream),
         4 * (2 * n_parts * nb + pk["head"]["w"].numel() + 2 * nb + b * nb),
         b * (2 * nb * nb + 2 * (n_parts // b) * nb + 3 * nb)),
    ]
    out = []
    for name, kernel, fn, n_bytes, n_ops in rows:
        bound_ms, by = bound(n_bytes, n_ops, PEAK_FP32_S)
        r = _regs_of(regs, kernel)
        out.append(dict(name=name, kernel=kernel, ms=call_ms(fn, reps=10),
                        bound_ms=bound_ms, bound_by=by,
                        registers=None if r is None else r[0],
                        spill_bytes=None if r is None else r[1] + r[2]))
    # the yardstick: the same 64 -> 64 conv through cuDNN, fp32 throughout
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
        check(dev_err <= 1e-3, f"cuDNN yardstick: its conv + norm differs "
              f"from the kernel's block by {dev_err}")
        cudnn_ms = call_ms(lambda: F.conv2d(xin, wt, padding=1), reps=10)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"flat fp32 decode kernels alone, b=32, full width, on {card} "
          f"(ms per launch, median of 20 samples of 10 launches):")
    for r in out:
        print(f"  {r['name']}: {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4g} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.1%} of it; registers "
              f"{r['registers']}, spill bytes {r['spill_bytes']}")
    print(f"  yardstick, never called by the port: cuDNN conv2d fp32 (TF32 "
          f"off, channels_last) {C} -> {C}, conv alone: {cudnn_ms:.4f} ms "
          f"(+ bias/norm/ReLU in torch within {dev_err:.3g} of the kernel)")
    return out, cudnn_ms


def check_part_launches(parts, kernel_counts, traced, n_batches: int):
    """Set each flat-decode kernel's ``launches`` to its count in the
    main path's run (``ops.kernel_launch_counts``, zeroed just before
    it), and fail unless each ran: layer 0, to_bits and the head once a
    batch, the hidden conv depth - 1 times, and no other decode kernel.
    Where the profiled pass over the same batches saw device time, its
    trace must show each kernel launched as often (``traced``: the
    profiler's kernel names, spaces removed, and their counts)."""
    want = {parts[0]["kernel"]: n_batches,
            parts[1]["kernel"]: (WIDTH["depth"] - 1) * n_batches,
            parts[2]["kernel"]: n_batches, parts[3]["kernel"]: n_batches}
    check(kernel_counts == want,
          f"the default path's decode kernels launched {kernel_counts}, "
          f"expected {want}")
    for p in parts:
        p["launches"] = kernel_counts[p["kernel"]]
        if traced:
            seen = sum(n for k, n in traced.items()
                       if f"::{p['kernel']}(" in k)
            check(seen == p["launches"],
                  f"{p['kernel']}: the profiled pass traced {seen} "
                  f"launches, the counter {p['launches']}")
    print(f"default path, {n_batches} batches: decode kernel launches "
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
    from repro_torch.kernels import ops
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
    r = _regs_of(regs, RS_KERNEL)
    check(r is not None and r[1] == r[2] == r[3] == 0,
          f"rs: ptxas -v shows a stack frame or spills: {r}")
    print(f"rs_decode ({RS_KERNEL}) on {card}: equal to the plain version "
          f"on {', '.join(str(len(c)) for c in cases)} words; B=32: "
          f"{times['ms']:.4f} ms a call, bound {bound_ms:.3g} ms ({by}), plain "
          f"{times['plain_ms']:.4f} ms; registers {r[0]}, stack {r[3]} B, "
          f"spill stores {r[1]} B, spill loads {r[2]} B; B={len(cases[-1])}: "
          f"{big_ms:.4f} ms a launch, bound {big_bound:.3g} ms")
    return dict(max_abs_err=0.0, bound_ms=bound_ms, bound_by=by,
                library_ms=None, kernel=RS_KERNEL, registers=r[0],
                stack_bytes=r[3], spill_bytes=r[1] + r[2],
                large_b=dict(b=len(cases[-1]), ms=big_ms,
                             bound_ms=big_bound), **times)


def rs_device_ms(dev, rng, card: str, calls: int = 20):
    """``calls`` calls of the RS wrapper at B = 32 under the profiler:
    every device kernel they launch must be the RS kernel (no cast kernel
    after it); returns its device ms per launch, or None where the
    profiler saw no device time.  Run after the main path's profiled
    pass, whose launch counts are checked: a later profiler session in
    the process can miss its first few device events, so the launches
    are read and reported here, not required to equal ``calls``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import rs_decode as rs
    bits = torch.as_tensor(rs_words(rng, 1, 8)[:32]).to(dev)
    rs.rs_decode_cuda(bits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            rs.rs_decode_cuda(bits)
        torch.cuda.synchronize()
    traced = {e.key: (e.count, e.self_device_time_total / 1e3 / e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count}
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


def profile_path(pipe, batches, card: str, name: str = "serve"):
    """One more pass over the batches under ``torch.profiler``: device
    busy time by kernel against the wall time (the profiler's own host
    cost inflates the wall, so the idle share is an upper bound).  The
    trace goes to build/chip_smoke/<name>_trace.json.  Returns the
    launches per device kernel name (spaces removed), or None where the
    profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    return {e.key.replace(" ", ""): e.count for e in rows}


# -- phase 5: the other configurations through the serve launcher ---------
def serve_config(flags, batches, card: str, profile: str = ""):
    """Build the launcher's pipeline for ``flags`` at full width, warm it
    up, zero the counters, serve ``batches``; return (report, results,
    launch counts).  With ``profile``, one more pass runs under the
    profiler (device time by kernel) after the counted one."""
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
        if profile:
            profile_path(pipe, batches, card, profile)
    finally:
        pipe.close()
    print(f"serve {' '.join(flags)}: {rep.images} images in "
          f"{rep.wall_s:.4f} s = {rep.throughput_ips:.1f} images/s on "
          f"{card}; launches {json.dumps(counts)}")
    return rep, results, counts


def phase_configs(batches, default_results, default_ips, cache, winner,
                  winner8, card: str):
    """Each configuration of the second slice on the default path's 3
    batches of 32: launch counts per batch, and its results against the
    default path's (the same keys: batch k of each stream).
    ``default_ips`` is the default path's median window (images/s), the
    qrmark side of the ratios to the sequential baseline."""
    n = len(batches)
    zero = dict(fused_tile_preprocess=0, fused_preprocess=0,
                fused_extractor=0, fused_extractor_blocked=0, rs_decode=0)
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
        ("int8", ["--decode-dtype", "int8"],
         dict(fused_tile_preprocess=n, fused_extractor=n, rs_decode=n),
         "rung"),
        ("int8-auto", ["--decode-dtype", "int8", "--schedule", "auto",
                       "--autotune-cache", str(cache)],
         {"fused_tile_preprocess": n, auto8_kernel: n, "rs_decode": n},
         "rung"),
    ]
    out = {}
    for name, flags, want, relation in configs:
        rep, results, counts = serve_config(
            flags, batches, card,
            profile=name if name in ("staged", "blocked",
                                     "sequential-device", "bf16", "int8",
                                     "int8-auto") else "")
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
        if name == "int8-auto":
            for r, f in zip(results, out["int8"]["results"]):
                for k in ("logits", "message_bits", "ok", "n_corrected"):
                    check(np.array_equal(r[k], f[k]),
                          f"int8-auto: {k} differs from int8 on the flat "
                          f"schedule")
        out[name] = dict(images_per_s=rep.throughput_ips, launches=counts,
                         flags=flags)
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
    for name in ("bf16", "int8", "int8-auto"):
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
    regs = kernel_registers(log)
    phases = {"fused_tile_preprocess": phase_ingest(dev, rng),
              "fused_extractor": phase_extractor(dev, rng),
              "rs_decode": phase_rs(dev, rng, card, regs),
              "fused_preprocess": phase_preprocess(dev, rng)}
    phases["fused_extractor_blocked"], cache, winner = phase_blocked(
        dev, rng, card)
    rungs, winner8 = phase_rungs(dev, rng, card, cache, regs)
    parts, cudnn_ms = phase_decode_parts(dev, rng, card, regs)
    phases["fused_extractor"].update(parts=parts,
                                     cudnn_conv_yardstick_ms=cudnn_ms)
    for name, r in phases.items():
        print(f"{name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.3g} ms ({r['bound_by']}), max |err| "
              f"{r['max_abs_err']:.3g}, batch 32, on {card}")
    counts, kernel_counts, pipe, batches, results = phase_end_to_end(card)
    window_ips = phase_throughput(pipe, batches, card)
    traced = profile_path(pipe, batches, card)
    check_part_launches(parts, kernel_counts, traced, len(batches))
    configs = phase_configs(batches, results,
                            statistics.median(window_ips), cache, winner,
                            winner8, card)
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
            "bf16": None,
            "int8": configs["int8-auto"]["launches"][
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
                "kernel", "device_ms", "registers", "stack_bytes",
                "spill_bytes", "large_b")})
        if name in rung_launches:
            entry["rungs"] = ["fp32", *RUNGS]
            entry["by_rung"] = {dt: {"launches": rung_launches[name][dt],
                                     **{k: rungs[dt][name][k] for k in keys}}
                                for dt in RUNGS}
        kernels.append(entry)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "phases": phases,
         "rungs": rungs, "window_ips": window_ips, "configs": configs},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
