"""The whole detection of a raw batch, plainly: keys, tile plans, ingest,
the extractor at a stated precision, RS, and escalation.

Batch ``seq`` of a pipeline seeded ``seed`` gives each image its key and
its k-tile plan (``keys``).  Round 1 decodes every image's first tile;
an image whose RS decode fails is decoded again on the next tile of its
plan, the logits summed in float32 in round order, and RS run on the
sum's signs, until RS succeeds or the k tiles are spent.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import extractor, keys, rs


def plan(cfg: dict, seed: int, seq: int, b: int) -> np.ndarray:
    """(b, k, 2) tile offsets of batch ``seq``."""
    return keys.grid_plan(keys.image_keys(seed, seq, b), cfg["img_size"],
                          cfg["tile"], cfg["escalate_tiles"])


def round_logits(params: dict, raw: torch.Tensor, offsets: np.ndarray,
                 rows: np.ndarray, cfg: dict, mode: str,
                 chunk: int = 256) -> torch.Tensor:
    """Logits of the tiles at ``offsets[rows]`` (one (y, x) a row) of the
    images ``raw[rows]``, computed ``chunk`` tiles at a time."""
    outs = []
    for i in range(0, len(rows), chunk):
        r = torch.as_tensor(rows[i:i + chunk], device=raw.device)
        tiles = extractor.ingest(
            raw.index_select(0, r),
            torch.as_tensor(offsets[rows[i:i + chunk]], device=raw.device),
            resize=cfg["resize_src"], img=cfg["img_size"], tile=cfg["tile"])
        outs.append(extractor.forward(params, tiles, mode))
    if not outs:
        n = params["head"]["b"].shape[0]
        return torch.zeros((0, n), device=raw.device)
    return torch.cat(outs)


def detect(params: dict, raw: torch.Tensor, cfg: dict, seed: int, seq: int,
           mode: str) -> dict:
    """Results of one batch, as the detector reports them: message_bits,
    ok, n_corrected, logits (the summed soft bits), tiles_used."""
    b = raw.shape[0]
    offs = plan(cfg, seed, seq, b)
    acc = round_logits(params, raw, offs[:, 0], np.arange(b), cfg, mode)
    msg, ok, nc = rs.decode((acc > 0).cpu().numpy())
    used = np.ones(b, np.int32)
    for r in range(1, cfg["escalate_tiles"]):
        idx = np.nonzero(~ok)[0]
        if not idx.size:
            break
        i = torch.as_tensor(idx, device=raw.device)
        acc[i] = acc[i] + round_logits(params, raw, offs[:, r], idx, cfg,
                                       mode)
        msg[idx], ok[idx], nc[idx] = rs.decode((acc[i] > 0).cpu().numpy())
        used[idx] = r + 1
    return {"message_bits": msg, "ok": ok, "n_corrected": nc,
            "logits": acc.cpu().numpy(), "tiles_used": used}
