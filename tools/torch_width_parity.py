#!/usr/bin/env python3
"""The decode kernels at hidden widths 16, 32 and 64 against another
checkout's (for example the parent commit unpacked with ``git archive``),
bit for bit, on one CUDA card; and both kernel builds' wall time.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_width_parity.py --parent DIR

Copies the extractor sources (``fused_extractor*.cu`` and
``extractor.cuh``) of DIR and of this checkout into
``build/width_parity/{parent,checkout}/`` and builds each with
``_build.build_variants`` (one parallel ``nvcc`` round a build, one
build after the other: the wall time of each is the time a cold build
of that decode takes).  Then, through each library's C entry points, at
fp32, bf16 and int8, for C 16 and 32 (tile 32, depth 3) and C 64 (tile
64, depth 7; the serve launcher's width), with the correlation bank, at
b = 32 and a ragged 5: the flat decode, and the blocked decode at bb 4
with ct = C and with ct = C / 2 and double buffering, logits and
embedding equal to the other checkout's bit for bit.  Fails on the first
difference.  Prints a line per width and rung and writes
``build/width_parity/parity.json``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "width_parity"
SOURCES = ("fused_extractor.cu", "fused_extractor_bf16.cu",
           "fused_extractor_int8.cu", "extractor.cuh")
ENTRIES = ("qr_conv3x3_norm_relu", "qr_conv3x3_norm_relu_blocked",
           "qr_conv3x3_gap_corr", "qr_extractor_head", "qr_conv3x3_imma",
           "qr_conv3x3_imma_blocked", "qr_conv3x3_gap_corr_imma")
CASES = ((16, 32, 3), (32, 32, 3), (64, 64, 7))   # (C, tile, depth)


def build(name: str, csrc: Path):
    """``csrc``'s decode sources built alone into OUT/name: (library
    path, wall s)."""
    from repro_torch.kernels import _build
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for src in SOURCES:
        shutil.copy(csrc / src, d / src)
    t0 = time.perf_counter()
    path = _build.build_variants({name: d})[name][0]
    return path, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the checkout whose decode kernels to match")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import card_line
    from repro_torch.core.extractor import (init_extractor_numpy,
                                            pack_params, params_from_numpy)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_extractor as fx
    card = card_line()
    built = {"parent": build("parent", Path(args.parent) / "src" /
                             "repro_torch" / "kernels" / "csrc"),
             "checkout": build("checkout", _build.CSRC)}
    libs = {k: _build.load(p, ENTRIES) for k, (p, _) in built.items()}
    out = {"card": card,
           "build_s": {k: s for k, (_, s) in built.items()}, "cases": []}
    print(f"decode builds, cold, one parallel nvcc round each: parent "
          f"{out['build_s']['parent']:.1f} s, checkout "
          f"{out['build_s']['checkout']:.1f} s, on {card}")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    for C, l, depth in CASES:
        params = params_from_numpy(init_extractor_numpy(
            1, n_bits=60, channels=C, depth=depth, tile=l, bias_scale=0.1),
            dev)
        for dtype in ("fp32", "bf16", "int8"):
            pk = pack_params(params, dtype)
            fx.device_constants(pk)
            rung = fx.RUNGS[dtype]
            n = 0
            for b in (32, 5):
                tiles = torch.as_tensor(rng.uniform(
                    -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
                runs = [("flat", lambda lib: fx._launch_flat(
                    lib, tiles, pk, rung, True, stream))]
                for ct, db in ((C, False), (C // 2, True)):
                    runs.append((f"bb4-ct{ct}{'-db' if db else ''}",
                                 lambda lib, ct=ct, db=db: fx._launch_blocked(
                                     lib, tiles, pk, rung, 4, ct, db, True,
                                     stream)))
                for name, run in runs:
                    got = run(libs["checkout"])
                    want = run(libs["parent"])
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0]) and
                            torch.equal(got[1], want[1])):
                        print(f"C {C} {dtype} b={b} {name}: differs from "
                              f"the parent's kernels", file=sys.stderr)
                        return 1
                    n += 1
            out["cases"].append({"channels": C, "tile": l, "depth": depth,
                                 "dtype": dtype, "calls_equal": n})
            print(f"C {C} (tile {l}, depth {depth}) {dtype}: {n} calls "
                  f"(flat, bb4-ct{C}, bb4-ct{C // 2}-db at b = 32 and 5) "
                  f"equal to the parent's bit for bit, on {card}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "parity.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
