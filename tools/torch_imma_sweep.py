#!/usr/bin/env python3
"""Where the time of the int8 flat decode's tensor-core kernels goes
(``src/repro_torch/kernels/csrc/fused_extractor_int8.cu``), measured on
one CUDA card by timing source variants.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_imma_sweep.py [--variants nomma,noquant,...]
        [--base DIR]

A variant is the int8 source with a few lines replaced (each replaced
text must occur in the source exactly once, or the run stops).  Two kinds:

* ablations (``ABLATIONS``) leave a part of the kernels' work out (the
  tensor-core dots, the dequantize fold's products, the norm, the
  quantize, the whole epilogue); their outputs are wrong by design and
  only their time is read: the checkout's time less an ablation's is
  about what that part costs where it is not hidden behind the rest;
* designs (``DESIGNS``) compute the same function another way; each is
  held to the checkout's kernels bit for bit (words, scales and GAP /
  correlation partials), and a variant that differs fails the run.
  ``--base DIR`` adds another checkout's int8 source (for example an
  earlier version of the kernels) as variant ``base``, held likewise.

Each variant's source is built into ``build/imma_sweep/<variant>/`` (all
in one parallel round of ``nvcc``) and loaded beside the checkout's own
build.  At b = 32 and full width (C 64, l 64, 60 bits, correlation bank),
in two interleaved rounds: ms per launch (median of 20 samples of 10
back-to-back launches between CUDA events) of layer 0
(``conv_imma_kernel<3,64>``), the 64 -> 64 block
(``conv_imma_kernel<64,64>``) and to_bits + GAP + corr
(``gap_corr_imma_kernel<64>``), and the ``ptxas -v`` registers and
spill bytes of the 64 -> 64 kernel.

Prints one line per variant and writes ``build/imma_sweep/sweep.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "imma_sweep"
SOURCE = "fused_extractor_int8.cu"
ENTRIES = ("qr_conv3x3_imma", "qr_conv3x3_gap_corr_imma")

_DOT = "        const float dot = __fsub_rn(__int_as_float(c[i]), kMagicF);\n"
_FOLD = """        const float d = __fmul_rn(__fmul_rn(dot, sx[m][i >> 1]),
                                  (i & 1) ? ws.y : ws.x);"""
_MMA = "for (int kk = 0; kk < G::KS; ++kk) mma_s8(c, a[m][kk], b[kk]);"
_QUANT = "w[k] |= quant_byte_rcp(u[16 * v + 4 * k + j], sc, rsc) << (8 * j);"
_NOQUANT = "w[k] |= (__float_as_uint(u[16 * v + 4 * k + j]) & 0xffu) << (8 * j);"
_NORM = """  float sum = 0.f;
#pragma unroll
  for (int co = 0; co < COUT; ++co) sum = __fadd_rn(sum, u[co]);
  const float mu = __fdiv_rn(sum, (float)COUT);
  float ss = 0.f;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    const float d = __fsub_rn(u[co], mu);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(ss, (float)COUT);
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
"""
_STAGE = "s_pre[frag_pixel(m, i) * SP + frag_col(j, i)] = acc[m][j][i];"

ABLATIONS = {
    # the dots: each mma replaced by one integer add of its B fragment
    "nomma": [(_MMA, "for (int kk = 0; kk < G::KS; ++kk) "
                     "c[0] += b[kk].x ^ (int)a[m][kk][0];")],
    # the fold's two products (the subtract and the sum stay)
    "nofold": [(_FOLD, "        const float d = dot;")],
    # the whole dequantize (the sum in tap order stays)
    "nofold2": [(_DOT + _FOLD,
                 "        const float d = __int_as_float(c[i]);")],
    # the weights' copies into shared memory (the taps read stale words)
    "noload": [("      cp_async16(dst + 16 * e, src + 16 * e);",
                "      (void)src;")],
    # the staging of the pre-norm tile (the epilogue reads stale rows)
    "nostage": [(_STAGE, "if (acc[m][j][i] == 12345.f) s_pre[0] = 0.f;")],
    # the norm's two sums (mu 0, rs 1)
    "nonorm": [(_NORM, "  const float mu = 0.f, rs = 1.f;\n")],
    # the quantize's products, rint and clip (the words pack u's bits)
    "noquant": [(_QUANT, _NOQUANT)],
    # norm and quantize both
    "noepi": [(_NORM, "  const float mu = 0.f, rs = 1.f;\n"),
              (_QUANT, _NOQUANT)],
}

_OCC_AT = "#undef QR_IMMA\n  return (int)cudaErrorInvalidValue;\n}\n"
_OCC = _OCC_AT + """
// blocks of conv_imma_kernel<64, 64> an SM holds at once (sweep only)
extern "C" int qr_imma_blocks_per_sm() {
  constexpr int smem = qr::ISmem<64, 8, qr::kHiddenEpi<64>>::END;
  if (qr::set_smem(qr::conv_imma_kernel<64, 64>, smem) != cudaSuccess)
    return -1;
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, qr::conv_imma_kernel<64, 64>, qr::ITHREADS, smem);
  return n;
}
"""
DESIGNS = {
    # the checkout, reporting its blocks an SM
    "occ": [(_OCC_AT, _OCC)],
    # one block an SM (launch bounds of 1): occupancy halved
    "1blk": [("__launch_bounds__(ITHREADS, 2)\nconv_imma_kernel",
              "__launch_bounds__(ITHREADS, 1)\nconv_imma_kernel"),
             (_OCC_AT, _OCC)],
    # every tap's weights waited for before tap 0: one barrier, not three
    "onegroup": [("  cp_async_wait<2>();  // the halo and taps 0-2 have "
                  "landed", "  cp_async_wait<0>();"),
                 ("""    if (tap == 3 || tap == 6) {  // the next group of taps has landed
      if (tap == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
""", "")],
}

DEFAULT = ",".join([*ABLATIONS, *DESIGNS])


def variant_source(text: str, name: str) -> str:
    subs = {**ABLATIONS, **DESIGNS}.get(name)
    if subs is None:
        raise SystemExit(f"unknown variant {name!r}: one of "
                         f"{', '.join([*ABLATIONS, *DESIGNS])}")
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{SOURCE} no longer has, once: {old!r}")
        text = text.replace(old, new)
    return text


def build(variants, base=None):
    """Each variant's int8 source (with the checkout's extractor.cuh), and
    ``base``'s (a checkout's csrc directory, as variant "base"), in one
    parallel nvcc round; returns {variant: (library path, ptxas log)}."""
    from repro_torch.kernels import _build
    csrc = _build.CSRC
    text = (csrc / SOURCE).read_text()
    dirs = {}
    for v in variants:
        d = dirs[v] = OUT / v
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        src_dir = base if v == "base" else csrc
        shutil.copy(src_dir / "extractor.cuh", d / "extractor.cuh")
        (d / SOURCE).write_text((src_dir / SOURCE).read_text() if v == "base"
                                else variant_source(text, v))
    return _build.build_variants(dirs)


def conv_registers(log: str):
    """(registers, spill bytes) of conv_imma_kernel<64, 64>."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_extractor as fx
    r = _build.registers_of(_build.kernel_registers(log),
                            fx.conv_kernel_name(fx.INT8, 64, 64))
    return None if r is None else (r[0], r[1] + r[2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--base", type=Path, default=None,
                    help="a checkout whose int8 source to add as variant "
                         "'base', held to the same bits")
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
    variants = [v for v in args.variants.split(",") if v]
    csrc_base = None
    if args.base is not None:
        csrc_base = args.base.resolve() / "src" / "repro_torch" / "kernels" \
            / "csrc"
        variants.append("base")
    base = _build.library()
    built = build(variants, csrc_base)
    libs = {"checkout": base, **{v: _build.load(p, ENTRIES)
                                 for v, (p, _) in built.items()}}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    b, l, i8 = 32, 64, fx.INT8
    tiles = torch.as_tensor(np.random.default_rng(0).uniform(
        -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
    pk = pack_params(params_from_numpy(init_extractor_numpy(
        1, n_bits=60, channels=64, depth=7, tile=l, bias_scale=0.1), dev),
        "int8")
    blk0, blk1 = pk["blocks"][0], pk["blocks"][1]

    def outputs(lib):
        x1 = fx.conv_block(lib, tiles, blk0, i8, stream)
        x2 = fx.conv_block(lib, x1, blk1, i8, stream)
        parts = fx.to_bits_partials(lib, tiles, x2, pk, i8, stream)
        torch.cuda.synchronize()
        return [x1.q, x1.s, x2.q, x2.s, *parts]

    want = outputs(base)
    x1 = fx.conv_block(base, tiles, blk0, i8, stream)
    res = {v: {"registers": conv_registers(built[v][1]) if v in built
               else None, "kind": "ablation" if v in ABLATIONS else
               ("design" if v in DESIGNS or v == "base" else "checkout")}
           for v in libs}
    samples = {v: {"layer0": [], "hidden": [], "to_bits": []} for v in libs}
    for _ in range(2):
        for v, lib in libs.items():
            if (v in DESIGNS or v == "base") and not all(
                    torch.equal(g, w) for g, w in zip(outputs(lib), want)):
                print(f"{v}: differs from the checkout's kernels",
                      file=sys.stderr)
                return 1
            x2 = fx.conv_block(lib, x1, blk1, i8, stream)
            s = samples[v]
            s["layer0"].append(call_ms(lambda: fx.conv_block(
                lib, tiles, blk0, i8, stream), reps=10))
            s["hidden"].append(call_ms(lambda: fx.conv_block(
                lib, x1, blk1, i8, stream), reps=10))
            s["to_bits"].append(call_ms(lambda: fx.to_bits_partials(
                lib, tiles, x2, pk, i8, stream), reps=10))
    for v in libs:
        res[v].update({k: statistics.median(x)
                       for k, x in samples[v].items()})
    print(f"int8 tensor-core kernel variants, b=32, C 64, l 64, on {card}; "
          f"ms per launch; designs bitwise equal to the checkout's kernels, "
          f"ablations wrong by design:")
    for v, lib in libs.items():
        occ = getattr(lib, "qr_imma_blocks_per_sm", None) if v != \
            "checkout" else None
        if occ is not None:
            occ.restype = ctypes.c_int
            res[v]["blocks_per_sm"] = occ()
    for v, r in res.items():
        regs = r["registers"] or ("-", "-")
        print(f"  {v:<10} {r['kind']:<9} layer0 {r['layer0']:.4f} hidden "
              f"{r['hidden']:.4f} to_bits {r['to_bits']:.4f} | "
              f"conv_imma<64,64> {regs[0]} registers, {regs[1]} spill bytes"
              + (f", {r['blocks_per_sm']} blocks an SM"
                 if "blocks_per_sm" in r else ""))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "sweep.json").write_text(json.dumps(
        {"card": card, "variants": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
