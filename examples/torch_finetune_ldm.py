"""Example (PyTorch port): QRMark §4.2 — fine-tune the (stand-in) LDM
decoder D_m so every generated image carries the RS-encoded signature
m_s, recoverable by the frozen tile extractor H_D from a single
random-grid tile; the fine-tuned decoder is saved as a numpy tree.

  PYTHONPATH=src python examples/torch_finetune_ldm.py [--steps 120] \
      [--device cpu]

Needs a tile-16 extractor: examples/torch_train_extractor.py --tile 16.
"""
import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import ldm, prng, tiling
from repro_torch.core.detect import resolve_device
from repro_torch.core.extractor import (pack_params, params_from_numpy,
                                        params_to_numpy)
from repro_torch.data.pipeline import synth_image
from repro_torch.kernels import ops

EXTRACTOR = Path("experiments/extractor_torch/tile16_params.pkl")
OUT = Path("experiments/ldm_torch/decoder_params.pkl")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # frozen extractor H_D from the offline stage
    if not EXTRACTOR.exists():
        raise SystemExit("run examples/torch_train_extractor.py --tile 16 "
                         "first")
    with open(EXTRACTOR, "rb") as f:
        d = pickle.load(f)
    hd = params_from_numpy(d["params"]["dec"], dev)
    code, tile = d["cfg"].code, d["cfg"].tile
    print(f"loaded extractor (tile {tile})")

    print("[1/3] pretraining the autoencoder (stand-in LDM VAE)...")
    ae = ldm.pretrain_autoencoder(torch.Generator().manual_seed(0),
                                  img_size=args.img, steps=120, batch=8,
                                  verbose=True, device=dev)

    print("[2/3] fine-tuning D_m against the frozen extractor...")
    res = ldm.finetune_decoder(ae, hd, code=code, tile=tile,
                               img_size=args.img, steps=args.steps,
                               batch=4, lr=5e-3, lam_i=0.1, verbose=True,
                               device=dev)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with open(OUT, "wb") as f:
        pickle.dump({"decoder": params_to_numpy(res.decoder),
                     "autoencoder": params_to_numpy(ae),
                     "signature": res.signature}, f)

    print("[3/3] verifying: generate -> tile -> extract -> RS decode")
    with torch.no_grad():
        imgs = np.stack([synth_image(9_000_000 + i, args.img)
                         for i in range(16)])
        x = torch.as_tensor(imgs, device=dev).float() / 127.5 - 1.0
        z = ldm.encode(ae, x)
        xw = ldm.decode(res.decoder, z)  # watermarked reconstructions
        sel, _ = tiling.select_tiles("random_grid", prng.key(7), xw, tile)
        logits = ops.fused_extractor(sel.contiguous(), pack_params(hd))
        bits = (logits > 0).to(torch.int32)
        out = ops.rs_decode(bits, code=code)
        mse = float(torch.mean(torch.square(xw - ldm.decode(ae["dec"], z))))
    gt = res.signature[: code.message_bits]
    ok = out["ok"].cpu().numpy().astype(bool)
    hit = ok & np.all(out["message_bits"].cpu().numpy() == gt[None], axis=1)
    raw = float((bits.cpu().numpy() == res.signature[None]).mean())
    print(f"raw tile bit accuracy : {raw:.3f}")
    print(f"RS-exact recovery     : {hit.sum()}/{len(hit)} generations")
    print(f"distortion vs D(z)    : mse {mse:.5f}")
    print(f"saved the fine-tuned decoder to {OUT}")
    if raw < 0.95:
        print("note: the 3-conv stand-in decoder saturates below the "
              "paper's pretrained LDM; accuracy keeps rising with "
              "--steps (mechanism check: should exceed 0.6 vs the 0.5 "
              "chance floor)")
    assert raw > 0.6, "fine-tune failed to move extraction accuracy"


if __name__ == "__main__":
    main()
