"""ML-based tile-size predictor (QRMark Appendix B.2; counterpart of
``repro.core.predictor``).

Features are the shifted autocorrelations of the high-passed image at
each candidate pitch (both axes) and coarse FFT band energies
(``torch.fft.rfft2``), on the images' device; the regressor is
gradient-boosted depth-1 trees (stumps) in numpy, a copy of the
reference's.  Embedding the same pattern bank in every l x l grid cell
makes the high-passed image periodic with pitch l, which these features
see.  Training data and fitting run offline.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import tiling
from repro_torch.core.detect import resolve_device
from repro_torch.core.extractor import (encoder_forward, highpass,
                                        params_from_numpy)
from repro_torch.core.transforms import resize_to
from repro_torch.data.pipeline import synth_image

CANDIDATE_TILES = (16, 32, 48, 64, 80)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


@torch.no_grad()
def tile_features(images) -> np.ndarray:
    """images (b, H, W, 3) float in [-1, 1] (numpy or a tensor on any
    device) -> (b, F) float32 features."""
    x = highpass(torch.as_tensor(images).to(torch.float32))
    x = x - x.mean(dim=(1, 2, 3), keepdim=True)
    b, H, W, _ = x.shape
    denom = torch.mean(torch.square(x), dim=(1, 2, 3)) + 1e-8
    zero = torch.zeros((b,), dtype=x.dtype, device=x.device)
    feats = []
    for l in CANDIDATE_TILES:
        ac_y = (torch.mean(x[:, l:] * x[:, :-l], dim=(1, 2, 3)) / denom
                if l < H else zero)
        ac_x = (torch.mean(x[:, :, l:] * x[:, :, :-l], dim=(1, 2, 3)) / denom
                if l < W else zero)
        feats += [ac_y, ac_x]
    # coarse spectral bands of the mean channel
    g = x.mean(-1)
    F = torch.abs(torch.fft.rfft2(g))
    low = torch.mean(F[:, : H // 8, : W // 8], dim=(1, 2))
    mid = torch.mean(F[:, H // 8: H // 4, : W // 4], dim=(1, 2))
    high = torch.mean(F[:, H // 4:, :], dim=(1, 2))
    tot = low + mid + high + 1e-8
    feats += [low / tot, mid / tot, high / tot]
    return torch.stack(feats, dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# gradient-boosted stumps (from-scratch XGBoost stand-in), numpy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stump:
    feature: int
    threshold: float
    left: float
    right: float

    def predict(self, X):
        return np.where(X[:, self.feature] <= self.threshold, self.left,
                        self.right)


@dataclasses.dataclass
class BoostedStumps:
    base: float
    stumps: List[Stump]
    lr: float

    def predict(self, X) -> np.ndarray:
        out = np.full(X.shape[0], self.base)
        for s in self.stumps:
            out += self.lr * s.predict(X)
        return out


def fit_boosted_stumps(X, y, *, n_rounds=120, lr=0.15,
                       n_thresholds=16) -> BoostedStumps:
    """L2 gradient boosting with depth-1 trees."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    base = float(y.mean())
    pred = np.full_like(y, base)
    stumps: List[Stump] = []
    for _ in range(n_rounds):
        resid = y - pred
        best = None
        for f in range(X.shape[1]):
            xs = X[:, f]
            qs = np.quantile(xs, np.linspace(0.05, 0.95, n_thresholds))
            for t in qs:
                m = xs <= t
                if m.sum() == 0 or m.sum() == len(xs):
                    continue
                lmean = resid[m].mean()
                rmean = resid[~m].mean()
                sse = (np.square(resid[m] - lmean).sum()
                       + np.square(resid[~m] - rmean).sum())
                if best is None or sse < best[0]:
                    best = (sse, Stump(f, float(t), float(lmean),
                                       float(rmean)))
        if best is None:
            break
        stumps.append(best[1])
        pred += lr * best[1].predict(X)
    return BoostedStumps(base, stumps, lr)


# ---------------------------------------------------------------------------
# end-to-end predictor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TileSizePredictor:
    model: BoostedStumps
    candidates: Sequence[int] = CANDIDATE_TILES

    def predict(self, images) -> np.ndarray:
        raw = self.model.predict(tile_features(images))
        cands = np.asarray(self.candidates, np.float64)
        return cands[np.argmin(np.abs(raw[:, None] - cands[None, :]),
                               axis=1)].astype(int)


@torch.no_grad()
def build_training_set(encoder_params_by_tile: dict, *, n_per_tile=64,
                       img_size=128, seed=0, device=None):
    """Watermark synthetic images at each tile size with the trained
    encoders ({tile: (encoder params, code)}) on ``device`` (None: the
    card, raising if there is none); returns (features, labels)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    Xs, ys = [], []
    for tile, (enc_params, code) in encoder_params_by_tile.items():
        enc_params = params_from_numpy(enc_params, device)
        gy = img_size // tile
        size = gy * tile
        imgs = np.stack([synth_image(seed * 100000 + tile * 1000 + i, size)
                         for i in range(n_per_tile)])
        x = torch.as_tensor(imgs, device=device).to(torch.float32) / 127.5 \
            - 1.0
        tiles_ = tiling.grid_partition(x, tile)
        b, g = tiles_.shape[:2]
        msgs = torch.as_tensor(rng.integers(0, 2, (b, code.codeword_bits)),
                               device=device)
        msgs = torch.repeat_interleave(msgs, g, dim=0)
        xw_flat, _ = encoder_forward(enc_params,
                                     tiles_.reshape(-1, tile, tile, 3),
                                     msgs)
        xw = xw_flat.reshape(b, gy, gy, tile, tile, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(b, size, size, 3)
        if size != img_size:
            xw = resize_to(xw, img_size)
        Xs.append(tile_features(xw))
        ys.append(np.full(b, tile, np.float64))
    return np.concatenate(Xs), np.concatenate(ys)


def train_predictor(encoder_params_by_tile: dict, **kw) -> TileSizePredictor:
    X, y = build_training_set(encoder_params_by_tile, **kw)
    return TileSizePredictor(fit_boosted_stumps(X, y))
