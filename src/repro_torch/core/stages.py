"""Stage registry (counterpart of ``repro.core.stages.StageRegistry``).

The single definition of the ingest / decode / RS stage functions and
the RNG-key discipline, built once per (config, params, device):

1. per-image ``fold_in`` keys (:meth:`StageRegistry.image_keys`);
2. ingest: tile-first (``random_grid`` offsets from the keys, then
   ``ops.fused_tile_preprocess`` straight to the (b, l, l, 3) decode
   input), or staged: the full (b, crop, crop, 3) image through
   ``ops.fused_preprocess`` (qrmark) or the unfused
   ``transforms.preprocess_reference`` (``sequential``, ``tiled``,
   ``fused_preprocess=False``);
3. decode: tiles picked per image from the staged image
   (``tiling.select_tiles_per_image``; ``sequential`` decodes the full
   image), then the fused extractor (``ops.fused_extractor`` on the
   flat or a blocked schedule, on weights packed once at
   ``cfg.decode_dtype``: fp32, bf16 or int8) or, with ``fused_decode``
   off or outside qrmark, the plain fp32 ``extractor_forward``;
4. ``logits > 0`` then RS: the batched Berlekamp-Welch kernel
   (``rs_mode="device"``), the scalar codec per row (``cpu_sync``), or
   the thread pool with its codebook (``cpu_pool``).

PyTorch runs eagerly, so there is no ``jit``: :meth:`fused_keyed` (qrmark
with device RS) is the steps in sequence.  Keys are integer hashing,
bit-exact anywhere, and live on the host; the offsets they give are
copied to the device with the raw batch.  Configurations outside the
ported slices raise ``NotImplementedError`` naming the ROADMAP item
that brings them.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import extractor as extractor_lib
from repro_torch.core import prng, tiling, transforms
from repro_torch.core.rs.codec import RSCode, rs_decode
from repro_torch.core.rs.cpu_pool import RSCorrectionPool
from repro_torch.kernels import autotune as autotune_lib
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused_extractor import check_blocked_schedule
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
        f"item {item})")


def check_config(cfg):
    """Raise for an invalid configuration, or one outside the ported
    slices."""
    if cfg.mode not in ("sequential", "tiled", "qrmark"):
        raise ValueError(f"unknown pipeline mode {cfg.mode!r}")
    if cfg.rs_mode not in ("device", "cpu_pool", "cpu_sync"):
        raise ValueError(f"unknown rs_mode {cfg.rs_mode!r}")
    if cfg.decode_dtype not in extractor_lib.DECODE_DTYPES:
        raise ValueError(f"unknown decode_dtype {cfg.decode_dtype!r}")
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
    if cfg.rs_mode == "device":
        check_code(cfg.code)  # other codes need the batched jax_rs twin
    if cfg.escalate_tiles > 1:
        _unported("escalation (escalate_tiles > 1)", "9")
    if cfg.cache_exact or cfg.cache_embedding_threshold > 0.0:
        _unported("the serving cache (cache_exact / "
                  "cache_embedding_threshold)", "13")


class StageRegistry:
    """The detection stage functions, built once per (cfg, params,
    device).  ``params`` is the extractor tree (torch tensors, e.g. from
    ``extractor.params_from_numpy``, or numpy arrays); it is moved once
    onto ``device`` and, for the fused decode, packed once there."""

    def __init__(self, cfg, params: dict, device: torch.device):
        check_config(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.base_key = prng.key(cfg.seed)
        self.tile_first = (cfg.tile_first and cfg.mode == "qrmark"
                           and cfg.fused_preprocess)
        self.fused_decode = cfg.fused_decode and cfg.mode == "qrmark"
        self.decode_schedule = None
        if self.fused_decode:
            # "flat" -> None (the flat kernel), "auto" -> the autotune
            # cache entry of this dtype (flat fallback with a printed
            # hint on a miss), or an explicit "bb<N>-ct<N>[-db]" point:
            # resolved once here, and on a card held to what the blocked
            # kernel runs (at every rung) before anything moves to the
            # device
            blocks = params["blocks"]
            channels = blocks[0]["w"].shape[-1]
            self.decode_schedule = autotune_lib.resolve_schedule(
                cfg.decode_schedule, dtype=cfg.decode_dtype, tile=cfg.tile,
                channels=channels, depth=len(blocks),
                n_bits=params["head"]["b"].shape[0],
                cache_path=cfg.autotune_cache, device=self.device)
            if self.decode_schedule is not None and \
                    self.device.type == "cuda":
                check_blocked_schedule(
                    channels=channels, tile=cfg.tile,
                    channel_tile=self.decode_schedule.channel_tile)
        self.params = extractor_lib.params_from_numpy(params, self.device)
        self.packed_params = (extractor_lib.pack_params(
            self.params, cfg.decode_dtype) if self.fused_decode else None)
        self._device_rs = None
        self._rs_pool: Optional[RSCorrectionPool] = None
        self._pool_seq = 0            # RS-pool job id counter
        self._pool_lock = threading.Lock()
        if cfg.rs_mode == "device":
            self._device_rs = make_device_rs(cfg.code)
        elif cfg.rs_mode == "cpu_pool":
            self._rs_pool = RSCorrectionPool(cfg.code,
                                             n_threads=cfg.rs_threads)
        # the fast path, where the reference builds one: qrmark with
        # device RS; None otherwise
        self.fused_keyed = (self._fused_keyed if cfg.mode == "qrmark"
                            and cfg.rs_mode == "device" else None)

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

    def preprocess(self, raw: torch.Tensor) -> torch.Tensor:
        """Full-image Resize -> CenterCrop -> Normalize: the fused
        kernel in qrmark with ``fused_preprocess``, the unfused ops
        otherwise."""
        cfg = self.cfg
        if cfg.fused_preprocess and cfg.mode == "qrmark":
            return kops.fused_preprocess(raw, resize=cfg.resize_src,
                                         crop=cfg.img_size)
        return transforms.preprocess_reference(raw, resize=cfg.resize_src,
                                               crop=cfg.img_size)

    def ingest_keyed(self, raw: torch.Tensor, keys: torch.Tensor
                     ) -> torch.Tensor:
        """raw uint8 batch + per-image keys -> the decode input: the
        selected tiles directly (tile-first) or the full preprocessed
        images (staged)."""
        cfg = self.cfg
        if not self.tile_first:
            return self.preprocess(raw)
        offs = tiling.tile_first_offsets(cfg.strategy, keys,
                                         img_size=cfg.img_size,
                                         tile=cfg.tile)
        return kops.fused_tile_preprocess(
            raw, offs.to(raw.device).contiguous(), resize=cfg.resize_src,
            crop=cfg.img_size, tile=cfg.tile)

    def extract(self, tiles: torch.Tensor) -> torch.Tensor:
        """Decode-ready tiles -> bit logits: the fused kernel on the
        resolved schedule, or the plain ``extractor_forward``."""
        if self.fused_decode:
            return kops.fused_extractor(tiles, self.packed_params,
                                        schedule=self.decode_schedule)
        return extractor_lib.extractor_forward(self.params, tiles)

    def decode_keyed(self, x: torch.Tensor, keys: torch.Tensor
                     ) -> torch.Tensor:
        """Decode input + per-image keys -> (b, n_bits) logits; the
        staged path picks each image's tile here (``sequential`` decodes
        the full image)."""
        cfg = self.cfg
        if not (self.tile_first or cfg.mode == "sequential"):
            x, _ = tiling.select_tiles_per_image(cfg.strategy, keys, x,
                                                 cfg.tile)
        return self.extract(x)

    @staticmethod
    def bits(logits: torch.Tensor) -> torch.Tensor:
        return (logits > 0).to(torch.int32)

    # -- RS correction ---------------------------------------------------
    def _rs_host(self, bits: np.ndarray):
        """(msg, ok, ncorr) as numpy via the configured host RS engine.
        The pool reports no correction counts: ``ncorr`` stays 0, as in
        the reference."""
        cfg, code = self.cfg, self.cfg.code
        b = bits.shape[0]
        msg = np.zeros((b, code.message_bits), np.int32)
        ok = np.zeros((b,), bool)
        ncorr = np.zeros((b,), np.int32)
        if cfg.rs_mode == "cpu_pool":
            with self._pool_lock:
                base = self._pool_seq
                self._pool_seq += b
            self._rs_pool.submit_batch(bits, base)
            for i, (mi, oki) in enumerate(
                    self._rs_pool.drain(range(base, base + b))):
                msg[i], ok[i] = mi[: code.message_bits], oki
        else:  # cpu_sync
            for i in range(b):
                res = rs_decode(code, bits[i])
                msg[i] = res.message_bits
                ok[i] = res.ok
                ncorr[i] = res.n_corrected
        return msg, ok, ncorr

    def rs_correct(self, bits: torch.Tensor):
        """(msg, ok, ncorr) via the configured RS engine: tensors on the
        pipeline's device from the device engine, numpy arrays from the
        host engines, which pull the bits to the host here."""
        if self.cfg.rs_mode == "device":
            out = self._device_rs(bits.to(self.device).contiguous())
            return out["message_bits"], out["ok"], out["n_corrected"]
        return self._rs_host(bits.cpu().numpy())

    def _fused_keyed(self, raw: torch.Tensor, keys: torch.Tensor):
        """The whole qrmark path with device RS: raw batch + per-image
        keys -> (RS outputs, logits)."""
        x = self.ingest_keyed(raw, keys)
        logits = self.decode_keyed(x, keys)
        return self._device_rs(self.bits(logits)), logits

    def close(self):
        if self._rs_pool is not None:
            self._rs_pool.close()
            self._rs_pool = None
