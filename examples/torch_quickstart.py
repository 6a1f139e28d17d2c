"""Quickstart (PyTorch port): the QRMark pipeline in ~60 lines.

1. Load a trained encoder/extractor pair, or train a tiny one.
2. RS-encode a 48-bit key and embed it into images.
3. Detect: random-grid tiling, the fused decode kernel and the RS
   kernel (their plain versions with --device cpu).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import prng, tiling
from repro_torch.core.detect import resolve_device
from repro_torch.core.extractor import (encoder_forward, pack_params,
                                        params_from_numpy)
from repro_torch.core.rs.codec import rs_encode
from repro_torch.core.train_extractor import ExtractorTrainConfig, train
from repro_torch.data.pipeline import synth_image
from repro_torch.kernels import ops

EXTRACTOR = Path("experiments/extractor_torch/tile16_params.pkl")


def get_pair(device):
    if EXTRACTOR.exists():
        with open(EXTRACTOR, "rb") as f:
            d = pickle.load(f)
        print(f"loaded trained pair from {EXTRACTOR}")
        return params_from_numpy(d["params"], device), d["cfg"]
    print("no trained pair found - training a tiny one")
    cfg = ExtractorTrainConfig(steps=80, batch=16, tile=16, img_size=64,
                               channels=16, depth=3, enc_channels=12,
                               enc_depth=2, curriculum_frac=1.0)
    return train(cfg, log_every=40, device=device)["params"], cfg


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    dev = resolve_device(ap.parse_args().device)
    params, cfg = get_pair(dev)
    code, tile = cfg.code, cfg.tile

    # --- the 48-bit watermark key, RS-encoded to 60 bits ----------------
    rng = np.random.default_rng(0)
    key_bits = rng.integers(0, 2, code.message_bits)
    codeword = torch.as_tensor(np.asarray(rs_encode(code, key_bits)),
                               device=dev)
    print(f"key: {''.join(map(str, key_bits[:16]))}... "
          f"({code.message_bits}b -> RS({code.n},{code.k}) "
          f"{code.codeword_bits}b)")

    # --- embed into every grid tile of 8 images -------------------------
    size = tile * 4
    imgs = torch.as_tensor(np.stack([synth_image(i, size) for i in range(8)]),
                           device=dev).float() / 127.5 - 1.0
    tiles = tiling.grid_partition(imgs, tile)
    b, g = tiles.shape[:2]
    cw = codeword.expand(b * g, code.codeword_bits)
    xw_flat, _ = encoder_forward(params["enc"],
                                 tiles.reshape(-1, tile, tile, 3), cw)
    gy = size // tile
    xw = xw_flat.reshape(b, gy, gy, tile, tile, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(b, size, size, 3)
    psnr = 10 * torch.log10(4.0 / torch.mean(torch.square(xw - imgs)))
    print(f"embedded watermark at PSNR {float(psnr):.1f} dB")

    # --- detect: one random-grid tile per image, the decode + RS kernels -
    sel, _ = tiling.select_tiles("random_grid", prng.key(1), xw, tile)
    logits = ops.fused_extractor(sel.contiguous(),
                                 pack_params(params["dec"]))
    bits = (logits > 0).to(torch.int32)
    out = ops.rs_decode(bits, code=code)
    ok = out["ok"].cpu().numpy().astype(bool)
    rec = out["message_bits"].cpu().numpy()
    match = ok & np.all(rec == key_bits[None, :], axis=1)
    raw_acc = float((bits == codeword).float().mean())
    print(f"raw tile bit accuracy : {raw_acc:.3f}")
    print(f"RS-corrected recovery : {match.sum()}/{len(match)} images")
    print("QRMark quickstart complete.")


if __name__ == "__main__":
    main()
