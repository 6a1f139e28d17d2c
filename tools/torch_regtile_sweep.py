#!/usr/bin/env python3
"""Thread-tile sizes of the port's register-tiled flat decode kernels
(``src/repro_torch/kernels/csrc/extractor.cuh``), measured on one CUDA
card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_regtile_sweep.py [--variants TM4-TN16-U2,...]
        [--parent DIR]

A variant ``TM<a>-TN<b>-U<c>`` is the header with a thread's tile set to
``a`` pixels x ``b`` columns and the input-channel loop unrolled ``c``
times.  Each variant's extractor sources are built into
``build/regtile_sweep/<variant>/`` (every source of every variant in one
parallel round of ``nvcc``) and loaded beside the checkout's own build.
Then, at b=32 and full width (C 64, D 7, l 64, 60 bits, correlation
bank), at fp32 and bf16, in two interleaved rounds:

* ms per launch (median of 20 samples of 10 back-to-back launches
  between CUDA events) of the 64 -> 64 hidden conv and of to_bits + GAP
  + corr, through each variant's C entry points;
* ms of the whole flat decode call (median of 20 calls);
* the variant's logits and embedding against the checkout's kernels, bit
  for bit (a variant that differs fails the run);
* ``ptxas -v`` registers and spill bytes of its 64 -> 64 conv kernel.

Besides, ``nvidia-smi`` reads the SM clock, its maximum and the power
draw while the checkout's fp32 64 -> 64 conv runs back to back.

``--parent DIR`` adds the extractor sources of another checkout (for
example an unpacked parent commit) as one more variant, ``parent``, held
to the same bits and timed in the same rounds.

Prints one line per variant and writes ``build/regtile_sweep/sweep.json``.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "regtile_sweep"
DEFAULT = "TM8-TN8-U4,TM8-TN8-U2,TM4-TN16-U4,TM4-TN16-U2,TM4-TN8-U2"
SOURCES = ("fused_extractor.cu", "fused_extractor_bf16.cu",
           "fused_extractor_int8.cu")
TILE_LINE = "constexpr int TM = 8, TN = 8, RSTAGES = 3;"
UNROLL_LINE = "#pragma unroll 4\n  for (int c4 = 0;"
ENTRIES = ("qr_conv3x3_norm_relu", "qr_conv3x3_norm_relu_blocked",
           "qr_conv3x3_gap_corr", "qr_extractor_head")


def clocks_during(fn, seconds: float = 1.0) -> str:
    """The card's SM clock, its maximum and the power draw, as
    ``nvidia-smi`` reads them halfway through ``seconds`` of ``fn`` run
    back to back."""
    import torch
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()

    worker = threading.Thread(target=spin)
    worker.start()
    try:
        time.sleep(seconds / 2)
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
    finally:
        time.sleep(seconds / 2)
        stop.set()
        worker.join()


def variant_header(text: str, name: str) -> str:
    m = re.fullmatch(r"TM(\d+)-TN(\d+)-U(\d+)", name)
    if not m:
        raise SystemExit(f"bad variant {name!r}: want TM<a>-TN<b>-U<c>")
    tm, tn, u = map(int, m.groups())
    for line in (TILE_LINE, UNROLL_LINE):
        if text.count(line) != 1:
            raise SystemExit(f"extractor.cuh no longer has {line!r}")
    text = text.replace(TILE_LINE, f"constexpr int TM = {tm}, TN = {tn}, "
                                   f"RSTAGES = 3;")
    return text.replace(UNROLL_LINE, f"#pragma unroll {u}\n  for (int c4 "
                                     f"= 0;")


def build(variants, parent=None):
    """Every variant's sources (and the parent checkout's, as variant
    "parent") in one parallel nvcc round; returns {variant: (library
    path, ptxas log)}."""
    from repro_torch.kernels import _build
    csrc = _build.CSRC
    header = (csrc / "extractor.cuh").read_text()
    dirs = {}
    for v in variants:
        d = dirs[v] = OUT / v
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        src_dir = csrc
        if v == "parent":
            src_dir = Path(parent) / "src" / "repro_torch" / "kernels" / "csrc"
            shutil.copy(src_dir / "extractor.cuh", d / "extractor.cuh")
        else:
            (d / "extractor.cuh").write_text(variant_header(header, v))
        for src in SOURCES:
            shutil.copy(src_dir / src, d / src)
    return _build.build_variants(dirs)


def conv_registers(log: str):
    """(registers, spill bytes) of conv_regtile_kernel<RF32, 64, 64>."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_extractor as fx
    r = _build.registers_of(_build.kernel_registers(log),
                            fx.conv_kernel_name(fx.RUNGS["fp32"], 64, 64))
    return None if r is None else (r[0], r[1] + r[2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--parent", default=None,
                    help="a checkout whose extractor sources to add")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import call_ms, card_line
    from repro_torch.core.extractor import (init_extractor_numpy,
                                            pack_params, params_from_numpy)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_extractor as fx
    card = card_line()
    variants = args.variants.split(",") + (["parent"] if args.parent
                                            else [])
    base = _build.library()
    built = build(variants, args.parent)
    libs = {v: _build.load(p, ENTRIES) for v, (p, _) in built.items()}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    b, l = 32, 64
    tiles = torch.as_tensor(rng.uniform(-2.0, 2.5, (b, l, l, 3)).astype(
        np.float32)).to(dev)
    params = params_from_numpy(init_extractor_numpy(
        1, n_bits=60, channels=64, depth=7, tile=l, bias_scale=0.1), dev)
    res = {v: {"registers": conv_registers(built[v][1])} for v in variants}
    for dtype in ("fp32", "bf16"):
        pk = pack_params(params, dtype)
        rung = fx.RUNGS[dtype]
        x1 = fx.conv_block(base, tiles, pk["blocks"][0], rung, stream)
        xl = x1
        for blk in pk["blocks"][1:]:
            xl = fx.conv_block(base, xl, blk, rung, stream)
        want = fx._launch_flat(base, tiles, pk, rung, True, stream)
        samples = {v: {"conv": [], "to_bits": [], "decode": []}
                   for v in variants}
        for _ in range(2):
            for v, lib in libs.items():
                got = fx._launch_flat(lib, tiles, pk, rung, True, stream)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and
                        torch.equal(got[1], want[1])):
                    print(f"{v} {dtype}: differs from the checkout's "
                          f"kernels", file=sys.stderr)
                    return 1
                s = samples[v]
                s["conv"].append(call_ms(lambda: fx.conv_block(
                    lib, x1, pk["blocks"][1], rung, stream), reps=10))
                s["to_bits"].append(call_ms(lambda: fx.to_bits_partials(
                    lib, tiles, xl, pk, rung, stream), reps=10))
                s["decode"].append(call_ms(lambda: fx._launch_flat(
                    lib, tiles, pk, rung, False, stream)))
        for v in variants:
            res[v][dtype] = {k: statistics.median(x)
                             for k, x in samples[v].items()}
        if dtype == "fp32":
            clocks = clocks_during(lambda: fx.conv_block(
                base, x1, pk["blocks"][1], rung, stream))
    print(f"register-tile variants, b=32, C 64, D 7, l 64, on {card}; ms "
          f"(conv 64->64 and to_bits per launch, decode per call); "
          f"every variant bitwise equal to the checkout's kernels:")
    for v in variants:
        r = res[v]
        regs, spill = r["registers"] or (None, None)
        print(f"  {v:<12} fp32 conv {r['fp32']['conv']:.4f} to_bits "
              f"{r['fp32']['to_bits']:.4f} decode {r['fp32']['decode']:.4f}"
              f" | bf16 conv {r['bf16']['conv']:.4f} to_bits "
              f"{r['bf16']['to_bits']:.4f} decode {r['bf16']['decode']:.4f}"
              f" | conv<RF32,64,64> {regs} registers, {spill} spill bytes")
    print(f"  SM clock, max SM clock, power draw during the checkout's "
          f"fp32 64->64 conv back to back: {clocks}")
    (OUT / "sweep.json").write_text(json.dumps(
        {"card": card, "variants": res, "clocks_during_conv": clocks},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
