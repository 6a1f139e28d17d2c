"""End-to-end watermark detection pipeline, default path (counterpart of
``repro.core.detect``).

:meth:`DetectionPipeline.detect_batch` runs the default
``DetectionConfig`` — ``mode="qrmark"``, tile-first fused ingest, fused
fp32 decode on the flat schedule, on-device RS, no escalation — through
the registry's fused path (``StageRegistry.fused_keyed``): a raw uint8
batch in, verified 48-bit keys out.

The pipeline runs on the card by default: ``device=None`` means
``"cuda"``, and raises if no GPU is present.  ``device="cpu"`` runs the
kernels' plain PyTorch versions on the CPU, as the tests do.

RNG discipline (as in the reference): batch k uses ``fold_in(key(seed),
k)`` and image i of a batch ``fold_in(batch_key, i)``, so the same
images with the same keys produce the same tiles — and the same keys as
the JAX package — in any batch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.rs.codec import DEFAULT_CODE, RSCode
from repro_torch.core.stages import StageRegistry


@dataclasses.dataclass
class DetectionConfig:
    """Configuration of the detection engines, with the reference's
    fields, names and defaults.  This slice runs the defaults; any
    other mode, ingest path, RS engine, code, dtype, schedule,
    escalation or cache setting raises ``NotImplementedError`` when a
    pipeline is built (see ``stages.check_config``)."""
    tile: int = 64
    img_size: int = 256
    resize_src: int = 288          # raw -> resize -> centercrop(img_size)
    strategy: str = "random_grid"
    code: RSCode = DEFAULT_CODE
    mode: str = "qrmark"           # sequential | tiled | qrmark
    rs_mode: str = "device"        # device | cpu_pool | cpu_sync
    fused_preprocess: bool = True
    tile_first: bool = True        # fuse tile selection into ingest
    fused_decode: bool = True      # fused extractor decode kernel
    decode_dtype: str = "fp32"     # fp32 | bf16 | int8
    decode_schedule: str = "flat"  # flat | auto | "bb<N>-ct<N>[-db]"
    autotune_cache: str = ""       # schedule cache path for "auto"
    interleave: bool = True
    rs_threads: int = 32
    lane_budget: int = 8
    escalate_tiles: int = 1        # max tiles/image (1 = no escalation)
    escalate_margin: float = 0.0   # mean-|logit| floor (0 = RS-only)
    cache_exact: bool = False      # tier-1 exact sha256 cache + dedup
    cache_embedding_threshold: float = 0.0  # tier-2 cosine floor (0=off)
    cache_capacity: int = 256      # tier-1 LRU entries (requests)
    cache_embedding_capacity: int = 512  # tier-2 LRU entries (images)
    seed: int = 0


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first CUDA device, raising if there is none; a
    CPU run has to be asked for (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the kernels' plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class DetectionPipeline:
    """Drives (ingest -> tile decode -> RS) over raw image batches on
    one device.  All stage compute lives in the registry
    (``self.stages``)."""

    def __init__(self, cfg: DetectionConfig, extractor_params: dict,
                 ground_truth_bits: Optional[np.ndarray] = None, *,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gt = ground_truth_bits
        self.stages = StageRegistry(cfg, extractor_params, self.device)
        self._seq = 0                 # batch counter (keys)

    def _finish(self, msg, ok, ncorr, logits) -> Dict[str, np.ndarray]:
        """The sink: the single place device tensors become numpy."""
        out = {"message_bits": msg.cpu().numpy(),
               "ok": ok.cpu().numpy(),
               "n_corrected": ncorr.cpu().numpy(),
               "logits": logits.cpu().numpy()}
        if self.gt is not None:
            out["match"] = np.all(
                out["message_bits"] == self.gt[None, : msg.shape[1]],
                axis=1)
        return out

    def detect_batch(self, raw_batch, *, key: Optional[torch.Tensor] = None,
                     true_b: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
        """Synchronous detection of one raw uint8 batch (numpy or torch,
        (b, H, W, 3)).  ``key`` (a (2,) key from ``prng``) defaults to
        the offline discipline ``fold_in(key(seed), batch_seq)``.
        ``true_b`` only matters with escalation, which this slice does
        not run; it is accepted for the reference's signature."""
        raw = self.stages.to_device(raw_batch)
        b = raw.shape[0]
        if key is None:
            key = self.stages.batch_key(self._seq)
            self._seq += 1
        keys = self.stages.image_keys(key, b)
        rs_out, logits = self.stages.fused_keyed(raw, keys)
        return self._finish(rs_out["message_bits"], rs_out["ok"],
                            rs_out["n_corrected"], logits)


def verify_against_key(message_bits: np.ndarray, key_bits: np.ndarray,
                       fpr: float = 1e-6) -> np.ndarray:
    """Statistical verification: match if the bit agreement exceeds the
    threshold tau solving  P[Binomial(n, 0.5) >= tau] <= fpr."""
    n = key_bits.shape[-1]
    tau = binomial_threshold(n, fpr)
    agree = np.sum(message_bits == key_bits[None, :], axis=-1)
    return agree >= tau


@functools.lru_cache(maxsize=None)
def binomial_threshold(n: int, fpr: float) -> int:
    """Smallest tau with  P[Binomial(n, 1/2) >= tau] <= fpr  (exact
    tail via the binomial coefficients); n + 1 when even full agreement
    cannot reach the target, so verification fails closed.  Cached: tau
    depends only on (n, fpr)."""
    probs = np.array([math.comb(n, i) for i in range(n + 1)], dtype=float)
    probs /= probs.sum()
    cum = np.cumsum(probs[::-1])[::-1]
    sat = np.nonzero(cum <= fpr)[0]
    return int(sat[0]) if sat.size else n + 1
