"""The comparison that decides ``correct``: the timed path's results
against the plain reference, batch by batch.

For each checked batch the reference decodes, for every image, the tiles
of its plan that the program says it used (round 1 for every image,
round r for the images whose ``tiles_used`` exceeds r), at the
configuration's precision.  Four numbers are compared, each with its
limit:

* ``logit_gap``: the widest gap between a result's logits and the
  reference's float32 sum of the same tiles' logits, over every row and
  bit (the keys, the plans, the ingest and the decode at the rung);
* ``rs_mismatch_rows``: rows whose ``message_bits``, ``ok`` or
  ``n_corrected`` differ from the reference RS decoder's on the result's
  own signs (the RS stage, on every row, marked or not);
* ``escalation_mismatch_rows``: rows that stopped escalating while RS
  failed with tiles left, or went on after a round r whose summed logits
  RS accepts in the reference whatever the signs of its entries within
  the round's margin of zero (the escalation's decisions).  The margin
  is ``MARGIN`` times r times the widest gap the batch's one-tile rows
  read (the program's error on one tile, measured; the whole batch's
  widest gap where no row stopped at one tile), and never more than
  ``logit_gap``'s limit;
* ``missing_rows``: rows of a checked batch without a result.

Rows whose decision the reference cannot settle (more than
``MAX_THIN`` entries within the margin of zero, or signs that RS decides
both ways) are counted as ``undecided_rows`` and reported; their logits
and RS outputs are still compared.
"""
from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from reference import detect as ref_detect
from reference import rs

MAX_THIN = 4
MARGIN = 2.0
NUMBERS = ("logit_gap", "rs_mismatch_rows", "escalation_mismatch_rows",
           "missing_rows")


def reference_rounds(params: dict, raw: torch.Tensor, cfg: dict, seed: int,
                     seq: int, used: np.ndarray, mode: str) -> List[np.ndarray]:
    """Per round r, (b, n_bits) reference logits of plan column r,
    computed for the rows whose ``used`` exceeds r (NaN elsewhere)."""
    b = raw.shape[0]
    offs = ref_detect.plan(cfg, seed, seq, b)
    n = params["head"]["b"].shape[0]
    out = []
    for r in range(cfg["escalate_tiles"]):
        rows = np.nonzero(used > r)[0]
        lg = np.full((b, n), np.nan, np.float32)
        if rows.size:
            lg[rows] = ref_detect.round_logits(params, raw, offs[:, r], rows,
                                               cfg, mode).cpu().numpy()
        out.append(lg)
    return out


def _accepts(sums: np.ndarray, tau: float) -> np.ndarray:
    """Per row: 1 where RS accepts the signs of ``sums`` however the
    entries within ``tau`` of zero fall, 0 where it rejects them all
    ways, -1 where it cannot be settled."""
    thin = np.abs(sums) <= tau
    n_thin = thin.sum(axis=1)
    out = np.full(len(sums), -1, np.int64)
    clear = n_thin == 0
    if clear.any():
        out[clear] = rs.decode(sums[clear] > 0)[1]
    for i in np.nonzero((n_thin > 0) & (n_thin <= MAX_THIN))[0]:
        pos = np.nonzero(thin[i])[0]
        words = np.repeat((sums[i] > 0)[None], 2 ** len(pos), axis=0)
        words[:, pos] = list(itertools.product((0, 1), repeat=len(pos)))
        oks = rs.decode(words)[1]
        out[i] = 1 if oks.all() else (0 if not oks.any() else -1)
    return out


def judge(res: Dict[str, np.ndarray], rounds: List[np.ndarray], k: int,
          tau: float) -> Dict[str, float]:
    """The numbers of one batch (see the module's docstring); ``tau`` is
    ``logit_gap``'s limit, the most a round's margin may be."""
    b = rounds[0].shape[0]
    logits = np.asarray(res["logits"], np.float32)
    m = min(b, logits.shape[0])
    out = {"missing_rows": float(b - m), "rows_checked": float(m),
           "undecided_rows": 0.0}
    logits = logits[:m]
    used = np.asarray(res.get("tiles_used", np.ones(m)), np.int64)[:m]
    bad_used = (used < 1) | (used > k)
    u = np.clip(used, 1, k)
    sums, acc = np.zeros_like(logits), rounds[0][:m].copy()
    partial = []
    for r in range(1, k + 1):
        sums[u == r] = acc[u == r]
        partial.append(acc.copy())
        if r < k:
            acc = (acc + rounds[r][:m]).astype(np.float32)
    gap = np.abs(logits - sums)
    out["logit_gap"] = float(np.nanmax(gap)) if m else 0.0
    if np.isnan(gap).any():
        out["logit_gap"] = float("inf")
    msg, ok, nc = rs.decode(logits > 0)
    rs_bad = ((np.asarray(res["message_bits"])[:m] != msg).any(axis=1)
              | (np.asarray(res["ok"])[:m].astype(bool) != ok)
              | (np.asarray(res["n_corrected"])[:m] != nc))
    out["rs_mismatch_rows"] = float(rs_bad.sum())
    esc_bad = bad_used | ((u < k) & ~np.asarray(res["ok"])[:m].astype(bool))
    one = (used == 1) & np.isfinite(gap).all(axis=1)
    per_tile = float(gap[one].max()) if one.any() else out["logit_gap"]
    undecided = np.zeros(m, bool)
    for r in range(1, k):
        rows = np.nonzero(u > r)[0]
        if rows.size:
            margin = min(tau, MARGIN * r * per_tile)
            verdict = _accepts(partial[r - 1][rows], margin)
            esc_bad[rows[verdict == 1]] = True
            undecided[rows[verdict == -1]] = True
    out["escalation_mismatch_rows"] = float(esc_bad.sum())
    out["undecided_rows"] = float(undecided.sum())
    return out


def merge(per_batch: List[Dict[str, float]]) -> Dict[str, float]:
    """The numbers over all checked batches: the widest gap, the sums of
    the counts."""
    out = {}
    for name in per_batch[0]:
        vals = [d[name] for d in per_batch]
        out[name] = max(vals) if name == "logit_gap" else float(sum(vals))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(np.isfinite(numbers[n]) and numbers[n] <= limits[n]
               for n in NUMBERS)
