"""Stage registry for the default detection path (counterpart of
``repro.core.stages.StageRegistry``).

The single definition of the ingest / decode / RS stage functions and
the RNG-key discipline, built once per (config, params, device):

1. per-image ``fold_in`` keys (:meth:`StageRegistry.image_keys`);
2. ``random_grid`` tile offsets (``tiling.tile_first_offsets``);
3. tile-first ingest, raw uint8 -> (b, l, l, 3) f32
   (``ops.fused_tile_preprocess``);
4. fused fp32 extractor decode -> (b, n_bits) logits
   (``ops.fused_extractor``);
5. ``logits > 0`` then batched Berlekamp-Welch RS(15,12)
   (``ops.rs_decode``).

PyTorch runs eagerly, so there is no ``jit``: :meth:`fused_keyed` is
the five steps in sequence.  Keys are integer hashing, bit-exact
anywhere, and live on the host; the offsets they give are copied to the
device with the raw batch.  Configurations outside this slice raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core import extractor as extractor_lib
from repro_torch.core import prng, tiling
from repro_torch.core.rs.codec import RSCode
from repro_torch.kernels import ops as kops
from repro_torch.kernels.rs_decode import check_code


def make_device_rs(code: RSCode) -> Callable:
    """The on-device batched RS engine: the Berlekamp-Welch kernel for
    the default code it is specialised for (other codes raise)."""
    check_code(code)

    def decode(bits: torch.Tensor) -> Dict[str, torch.Tensor]:
        return kops.rs_decode(bits, code=code)

    return decode


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1 "
        f"item {item}); this slice runs the default qrmark path")


def check_config(cfg):
    """Raise for a configuration outside the ported default path."""
    if cfg.mode not in ("sequential", "tiled", "qrmark"):
        raise ValueError(f"unknown pipeline mode {cfg.mode!r}")
    if cfg.rs_mode not in ("device", "cpu_pool", "cpu_sync"):
        raise ValueError(f"unknown rs_mode {cfg.rs_mode!r}")
    if cfg.strategy not in tiling.STRATEGIES:
        raise ValueError(f"unknown tiling strategy {cfg.strategy!r}")
    if cfg.escalate_tiles < 1:
        raise ValueError(
            f"escalate_tiles must be >= 1, got {cfg.escalate_tiles}")
    if cfg.escalate_margin > 0.0 and cfg.escalate_tiles == 1:
        raise ValueError(
            "escalate_margin > 0 has no effect with escalate_tiles=1 — "
            "set escalate_tiles > 1 (or margin to 0)")
    if not 0.0 <= cfg.cache_embedding_threshold <= 1.0:
        raise ValueError("cache_embedding_threshold must be in [0, 1]")
    if cfg.cache_capacity < 1 or cfg.cache_embedding_capacity < 1:
        raise ValueError("cache capacities must be >= 1")
    if cfg.mode != "qrmark":
        _unported(f"mode={cfg.mode!r}", "8")
    if cfg.rs_mode != "device":
        _unported(f"rs_mode={cfg.rs_mode!r}", "8")
    if not (cfg.tile_first and cfg.fused_preprocess):
        _unported("the staged ingest (tile_first=False or "
                  "fused_preprocess=False)", "8")
    if not cfg.fused_decode:
        _unported("the unfused decode (fused_decode=False)", "8")
    if cfg.escalate_tiles > 1:
        _unported("escalation (escalate_tiles > 1)", "9")
    if cfg.decode_dtype != "fp32":
        _unported(f"decode_dtype={cfg.decode_dtype!r}", "10")
    if cfg.decode_schedule != "flat":
        _unported(f"decode_schedule={cfg.decode_schedule!r}", "10")
    if cfg.cache_exact or cfg.cache_embedding_threshold > 0.0:
        _unported("the serving cache (cache_exact / "
                  "cache_embedding_threshold)", "13")


class StageRegistry:
    """The detection stage functions, built once per (cfg, params,
    device).  ``params`` is the extractor tree (torch tensors, e.g. from
    ``extractor.params_from_numpy``, or numpy arrays); it is packed
    once onto ``device``."""

    def __init__(self, cfg, params: dict, device: torch.device):
        check_config(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.base_key = prng.key(cfg.seed)
        self._device_rs = make_device_rs(cfg.code)
        self.packed_params = extractor_lib.pack_params(
            extractor_lib.params_from_numpy(params, self.device),
            cfg.decode_dtype)

    # -- RNG-key discipline --------------------------------------------
    def batch_key(self, seq: int) -> torch.Tensor:
        """Offline key for batch ``seq``: fold_in(key(cfg.seed), seq)."""
        return prng.fold_in(self.base_key, seq)

    def image_keys(self, key: torch.Tensor, b: int) -> torch.Tensor:
        """Per-image keys fold_in(key, 0..b-1), (b, 2)."""
        key = torch.as_tensor(key, dtype=torch.int64)
        return prng.fold_in(key[None].expand(b, 2),
                            torch.arange(b, dtype=torch.int64))

    # -- stages ----------------------------------------------------------
    def to_device(self, raw) -> torch.Tensor:
        """Raw uint8 batch (numpy or torch) -> contiguous tensor on the
        pipeline's device."""
        raw = torch.as_tensor(raw)
        if raw.dtype != torch.uint8:
            raise TypeError(f"raw images must be uint8, got {raw.dtype}")
        return raw.to(self.device).contiguous()

    def ingest_keyed(self, raw: torch.Tensor, keys: torch.Tensor
                     ) -> torch.Tensor:
        cfg = self.cfg
        offs = tiling.tile_first_offsets(cfg.strategy, keys,
                                         img_size=cfg.img_size,
                                         tile=cfg.tile)
        return kops.fused_tile_preprocess(
            raw, offs.to(raw.device).contiguous(), resize=cfg.resize_src,
            crop=cfg.img_size, tile=cfg.tile)

    def decode_keyed(self, x: torch.Tensor, keys: torch.Tensor
                     ) -> torch.Tensor:
        return kops.fused_extractor(x, self.packed_params)

    @staticmethod
    def bits(logits: torch.Tensor) -> torch.Tensor:
        return (logits > 0).to(torch.int32)

    def rs_correct(self, bits: torch.Tensor):
        """(msg, ok, ncorr) via the device RS engine."""
        out = self._device_rs(bits.to(self.device).contiguous())
        return out["message_bits"], out["ok"], out["n_corrected"]

    def fused_keyed(self, raw: torch.Tensor, keys: torch.Tensor):
        """The whole default path: raw batch + per-image keys ->
        (RS outputs, logits)."""
        x = self.ingest_keyed(raw, keys)
        logits = self.decode_keyed(x, keys)
        return self._device_rs(self.bits(logits)), logits
