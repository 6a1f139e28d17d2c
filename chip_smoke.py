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
   tolerance — and times both with CUDA events (median call time);
4. drives the serve launcher's code path (``repro_torch.launch.serve``)
   at full width for 3 batches of 32 synthetic images, checks that every
   kernel of the path was launched, replays one batch through the plain
   versions, and prints images/s; then times three longer windows of
   the same stream (images/s), and profiles one more pass (device busy
   time by kernel, idle share);
5. checks the default path against the JAX package's golden outputs
   (``tests/data/torch_port_golden.npz``);
6. prints one ``{"kernels": [...]}`` line and, last, the status line.

Every failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available or when
the repository's sources are not beside it.  Imports nothing of JAX and
nothing of the JAX package ``repro``.
"""
from __future__ import annotations

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
# the tensor cores, int32 ALU (64 lanes/SM x 132 SMs x 1.98 GHz)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_INT32_S = 16.7e12

INGEST_ATOL = 1e-5        # ingest vs plain: a few float32 ulps
LOGIT_RTOL = 1e-4         # logits vs plain/golden: 1e-4 * (1 + max|ref|)
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


def call_ms(fn, iters: int = 20) -> float:
    """Median per-call time as an eager caller sees it: CUDA events
    around each call after warm-up, host work in the wrapper included
    whenever the card waits for it.  Device time alone by kernel comes
    from the profiled pass of the serve path."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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
    ry_idx, _, rx_idx, _ = (t.cpu().numpy() for t in ftp._device_tables(
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


# -- phase 3c: RS decode ---------------------------------------------------
def rs_words(rng, n_each: int) -> np.ndarray:
    """Codewords with 0, 1 and 2 symbol errors, and uniform words."""
    from repro_torch.core.rs.codec import DEFAULT_CODE, rs_encode
    rows = []
    for n_err in (0, 1, 2):
        for _ in range(n_each):
            cw = rs_encode(DEFAULT_CODE, rng.integers(0, 2, 48)).copy()
            for sym in rng.choice(15, n_err, replace=False):
                flip = int(rng.integers(1, 16))
                cw[sym * 4: sym * 4 + 4] ^= (flip >> np.arange(3, -1, -1)) & 1
            rows.append(cw)
    rows += list(rng.integers(0, 2, (n_each, 60)))
    words = np.stack(rows).astype(np.int32)
    return words[rng.permutation(len(words))]


def rs_int_ops(n_words: int) -> float:
    """int32 ops of the least work a t=1 decode of one word needs, times
    the words: unpack 60 bits (2 ops each), two syndromes over 15
    symbols (a table multiply and an xor each), locate and size the one
    error through the log/exp tables (~10), and pack the 108 output bits
    (2 ops each).  The kernel runs the reference's Berlekamp-Welch
    elimination instead, far more work; the bound counts the function's,
    not the kernel's."""
    return float(n_words * (2 * 60 + 2 * 15 * 2 + 10 + 2 * 108))


def phase_rs(dev, rng):
    import torch
    from repro_torch.kernels import rs_decode as rs
    cases = [rs_words(rng, 8), rs_words(rng, 1)[:1], rs_words(rng, 2)[:5],
             rs_words(rng, 1024)]
    main = None
    for words in cases:
        bits = torch.as_tensor(words).to(dev)
        got = rs.rs_decode_cuda(bits)
        want = rs.rs_decode_plain(bits)
        torch.cuda.synchronize()
        for k in want:
            check(torch.equal(got[k], want[k]),
                  f"rs B={len(words)}: {k} differs from the plain version")
        if main is None:
            main = (words, bits)
    words, bits = main
    times = timings(lambda: rs.rs_decode_cuda(bits),
                    lambda: rs.rs_decode_plain(bits), plain_iters=5)
    n_bytes = 4 * len(words) * (60 + 48 + 60 + 1 + 1)
    bound_ms, by = bound(n_bytes, rs_int_ops(len(words)), PEAK_INT32_S)
    return dict(max_abs_err=0.0, bound_ms=bound_ms, bound_by=by,
                library_ms=None, **times)


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
    print(f"end-to-end: launches {json.dumps(counts)}")
    check(all(c > 0 for c in counts.values()),
          f"a kernel of the main path was never launched: {counts}")
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
    return counts, pipe, batches


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


def profile_path(pipe, batches, card: str):
    """One more pass over the batches under ``torch.profiler``: device
    busy time by kernel against the wall time (the profiler's own host
    cost inflates the wall, so the idle share is an upper bound).  The
    trace goes to build/chip_smoke/serve_trace.json."""
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
    prof.export_chrome_trace(str(OUT / "serve_trace.json"))
    if busy_ms == 0:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile: {len(batches)} batches, wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms, idle share <= "
          f"{1 - busy_ms / wall_ms:.3f} on {card}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


# -- phase 5: golden JAX outputs ------------------------------------------
def phase_golden():
    from repro_torch.core import tiling
    from repro_torch.core.detect import DetectionConfig, DetectionPipeline
    from repro_torch.data.pipeline import synth_image
    g = np.load(GOLDEN)
    params = golden_params(int(g["seed"]), float(g["margin"]))
    pipe = DetectionPipeline(DetectionConfig(**FULL), params, device="cuda")
    raw = np.stack([synth_image(int(i), RAW) for i in g["image_ids"]])
    out = pipe.detect_batch(raw)            # key fold_in(key(0), 0)
    keys = pipe.stages.image_keys(pipe.stages.batch_key(0), raw.shape[0])
    offs = tiling.tile_first_offsets("random_grid", keys, img_size=256,
                                     tile=64).numpy()
    check((offs == g["offsets"]).all(), "golden offsets differ")
    ref = g["logits"]
    e = float(np.abs(out["logits"] - ref).max())
    check(e <= logit_tol(ref), f"golden logits: max |err| {e}")
    margined = np.abs(ref).min(axis=1) > 10 * logit_tol(ref)
    check(margined.any(), "no margined golden row")
    for k in ("message_bits", "ok", "n_corrected"):
        check((out[k][margined] == g[k][margined]).all(),
              f"golden {k} differs on a margined row")
    print(f"golden: {int(margined.sum())}/{len(ref)} margined rows exact, "
          f"logits max |err| {e:.3g} (tol {logit_tol(ref):.3g}), ok "
          f"{out['ok'].astype(int).tolist()}, n_corrected "
          f"{out['n_corrected'].tolist()}")


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
    phases = {"fused_tile_preprocess": phase_ingest(dev, rng),
              "fused_extractor": phase_extractor(dev, rng),
              "rs_decode": phase_rs(dev, rng)}
    for name, r in phases.items():
        print(f"{name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.3g} ms ({r['bound_by']}), max |err| "
              f"{r['max_abs_err']:.3g}, batch 32, on {card}")
    counts, pipe, batches = phase_end_to_end(card)
    window_ips = phase_throughput(pipe, batches, card)
    profile_path(pipe, batches, card)
    phase_golden()

    meta = {
        "fused_tile_preprocess": (
            "src/repro_torch/kernels/csrc/tile_preprocess.cu",
            "src/repro/kernels/fused_tile_preprocess.py:68"),
        "fused_extractor": (
            "src/repro_torch/kernels/csrc/fused_extractor.cu",
            "src/repro/kernels/fused_extractor.py:82"),
        "rs_decode": ("src/repro_torch/kernels/csrc/rs_decode.cu",
                      "src/repro/kernels/rs_decode.py:202"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": counts[name],
                **{k: phases[name][k] for k in keys}}
               for name, (src, rep) in meta.items()]
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "phases": phases,
         "window_ips": window_ips}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
