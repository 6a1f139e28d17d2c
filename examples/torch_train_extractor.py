"""Example (PyTorch port): QRMark offline stage — train the tile-based
watermark encoder/extractor pair with the RS-aware loss, evaluate it
under the paper's attack set through the decode and RS kernels, and
save the pair as a tree of numpy arrays.

Usage (on the card; --device cpu runs everything on the CPU):
  PYTHONPATH=src python examples/torch_train_extractor.py \
      --tile 32 --steps 400 --out experiments/extractor_torch
"""
import argparse
import json
import pickle
import time
from pathlib import Path

from repro_torch.core import transforms
from repro_torch.core.extractor import params_to_numpy
from repro_torch.core.train_extractor import (ExtractorTrainConfig,
                                              evaluate, train)


def save(path: Path, result: dict, cfg: ExtractorTrainConfig):
    """The trained pair and its AdamW state as numpy trees, beside the
    config."""
    with open(path, "wb") as f:
        pickle.dump({"params": params_to_numpy(result["params"]),
                     "opt_state": params_to_numpy(result["opt_state"]),
                     "cfg": cfg}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--channels", type=int, default=24)
    ap.add_argument("--out", default="experiments/extractor_torch")
    ap.add_argument("--eval-images", type=int, default=128)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()

    cfg = ExtractorTrainConfig(tile=args.tile, img_size=args.img_size,
                               steps=args.steps, batch=args.batch,
                               channels=args.channels)
    tag = args.tag or f"tile{args.tile}"
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    print(f"[train_extractor] {tag}: tile={cfg.tile} steps={cfg.steps} "
          f"code=({cfg.code.n},{cfg.code.k}) over GF(2^{cfg.code.m})",
          flush=True)
    t0 = time.time()
    result = train(cfg, log_every=25, device=args.device)
    # persist BEFORE eval so a failed eval never loses the training run
    save(out_dir / f"{tag}_params.pkl", result, cfg)

    attacks = ("none",) + transforms.STABLE_SIG_ATTACKS
    ev = evaluate(result["params"], cfg, n_images=args.eval_images,
                  attacks=attacks, device=args.device)
    for atk, r in ev.items():
        print(f"  {atk:14s} bit_acc={r['bit_acc']:.3f} "
              f"rs_word_acc={r.get('rs_word_acc', float('nan')):.3f} "
              f"psnr={r['psnr']:.1f}", flush=True)
    (out_dir / f"{tag}_report.json").write_text(json.dumps({
        "history": result["history"], "eval": ev,
        "wall_s": time.time() - t0,
        "config": {"tile": cfg.tile, "img_size": cfg.img_size,
                   "steps": cfg.steps, "batch": cfg.batch,
                   "channels": cfg.channels,
                   "code": [cfg.code.m, cfg.code.n, cfg.code.k]},
    }, indent=1))
    print(f"[train_extractor] saved {tag} in {time.time()-t0:.0f}s",
          flush=True)


if __name__ == "__main__":
    main()
