"""Operations and bytes of the extractor decode, and the card's peaks.

``extractor_flops`` counts what the decode computes for ``b`` tiles of
``l`` x ``l`` pixels: each 3x3 conv's multiply-adds (2 * 9 * cin * cout a
pixel) with its bias, normalisation and ReLU (8 * cout a pixel), the
``to_bits`` conv with the global average (2 * n a pixel), the head (2 *
n * n a tile), and the high-pass and the correlation with the bank at
the tile's own size (3 * (11 + 2 n) a pixel).  ``decode_bytes`` counts each
input byte read once and each output byte written once: the float32
tiles, the weights at the rung's width, the float32 logits.
"""
from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data
# sheet): float32 outside the tensor cores, int8 and bf16 on them, HBM3
# bandwidth.  Keyed by the name torch.cuda.get_device_name() gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "bf16": 989e12,
                              "int8": 1979e12, "bytes_s": 3.35e12},
}
WEIGHT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def extractor_flops(b: int, l: int, *, channels: int, depth: int,
                    n_bits: int) -> float:
    ops, cin = 0.0, 3
    for _ in range(depth):
        ops += b * l * l * (2 * 9 * cin * channels + 8 * channels)
        cin = channels
    ops += b * l * l * (2 * 9 * cin * n_bits + 2 * n_bits)
    ops += b * 2 * n_bits * n_bits
    ops += b * l * l * 3 * (11 + 2 * n_bits)
    return ops


def decode_bytes(b: int, l: int, *, channels: int, depth: int, n_bits: int,
                 dtype: str) -> float:
    w = 9 * (3 * channels + (depth - 1) * channels * channels
             + channels * n_bits) * WEIGHT_BYTES[dtype]
    small = 4 * (depth * channels + 3 * n_bits + n_bits * n_bits
                 + n_bits * l * l * 3)
    return b * l * l * 3 * 4 + w + small + b * n_bits * 4


def least_seconds(b: int, l: int, ex: dict, dtype: str, peaks: dict
                  ) -> float:
    """The least time the card could decode ``b`` tiles in: the larger of
    operations over the rung's peak and bytes over the bandwidth."""
    kw = dict(channels=ex["channels"], depth=ex["depth"],
              n_bits=ex["n_bits"])
    return max(extractor_flops(b, l, **kw) / peaks[dtype],
               decode_bytes(b, l, dtype=dtype, **kw) / peaks["bytes_s"])
