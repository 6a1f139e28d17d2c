"""Stage registry (counterpart of ``repro.core.stages.StageRegistry``).

The single definition of the ingest / decode / RS stage functions, the
RNG-key discipline and adaptive escalation, built once per (config,
params, device):

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
4. ``logits > 0`` then RS: ``ops.rs_decode`` (``rs_mode="device"``: the
   t = 1 kernel for the default code, the batched ``torch_rs`` for any
   other), the scalar codec per row (``cpu_sync``), or the thread pool
   with its codebook (``cpu_pool``);
5. with ``escalate_tiles`` k > 1 (:class:`EscalationPolicy`), images
   whose RS failed, or whose mean |logit| is below ``escalate_margin``,
   are decoded again on tile r of their k-tile plan
   (``tiling.escalation_offsets``) in round r, their soft bits summed,
   and RS run again on the sums (:meth:`StageRegistry.escalate`).

The same functions make the payload stage graph of the lane executor
(:meth:`StageRegistry.build_stages`, ``ingest`` -> ``decode`` -> ``rs``,
:data:`STAGE_NAMES`), which ``DetectionPipeline.run_stream`` and the
offline ``DetectionService`` run; on a card each lane runs its stage on
a CUDA stream of its own (``lanes.LaneStreams``).

PyTorch runs eagerly, so there is no ``jit``: :meth:`fused_keyed` (qrmark
with device RS) is the steps in sequence.  Keys are integer hashing,
bit-exact anywhere, and live on the host; the offsets they give are
copied to the device with the raw batch.  The serving tier adds the
content-derived request key (:meth:`StageRegistry.content_key`) and the
embedding-emitting decode (:meth:`StageRegistry.decode_keyed_embed`,
``build_stages(emit_embed=True)``), whose logits are bitwise the
embed-free decode's.

Spans (:mod:`repro_torch.core.trace`): ``ingest.offsets``,
``escalate`` with its ``escalate.plan``, ``escalate.round`` and
``escalate.gather``, and ``sync`` around every copy of a tensor back to
the host (:func:`host_numpy`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import extractor as extractor_lib
from repro_torch.core import lanes as lanes_lib
from repro_torch.core import prng, tiling, trace, transforms
from repro_torch.core.rs import torch_rs
from repro_torch.core.rs.codec import RSCode, rs_decode
from repro_torch.core.rs.cpu_pool import RSCorrectionPool
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as autotune_lib
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused_extractor import (check_blocked_schedule,
                                                 device_constants)
from repro_torch.kernels.fused_preprocess import ingest_tables
from repro_torch.kernels.rs_decode import is_kernel_code

STAGE_NAMES = ("ingest", "decode", "rs")


def make_device_rs(code: RSCode) -> Callable:
    """The on-device batched RS engine: the t = 1 kernel for the default
    code it is specialised for, the batched Berlekamp-Welch ``torch_rs``
    otherwise, as the reference falls back to ``jax_rs``."""
    if not is_kernel_code(code):
        return torch_rs.make_batch_decoder(code)

    def decode(bits: torch.Tensor) -> Dict[str, torch.Tensor]:
        return kops.rs_decode(bits, code=code)

    return decode


def host_numpy(a) -> np.ndarray:
    """A tensor (copied to the host) or array-like as a numpy array: the
    one place a tensor comes back to the host, so its copy is the
    ``sync`` span, where the host waits for the card (with the thread
    CPU time it used, which a stage span around it leaves out)."""
    if isinstance(a, torch.Tensor):
        with trace.span("sync", wait=True, cpu=True):
            return a.cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """When and how far to escalate beyond the one-tile fast path
    (``DetectionConfig.escalate_tiles`` / ``escalate_margin``).

    ``max_tiles`` is the tile budget of an image: round r decodes tile r
    of its plan, so an image uses 1 to ``max_tiles`` tiles.  An image
    escalates after a round when RS failed on its summed soft bits, or,
    with ``margin > 0``, when their mean absolute value is below
    ``margin``.  ``max_tiles == 1`` turns escalation off."""
    max_tiles: int = 1
    margin: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.max_tiles > 1

    def wants_escalation(self, ok, logits) -> np.ndarray:
        """Per-image bool mask over (ok, summed logits), on the host: the
        mean |logit| is numpy's, as the reference computes it, so equal
        logits give the reference's decision bit for bit."""
        need = ~host_numpy(ok).astype(bool)
        if self.margin > 0.0:
            need = need | (np.abs(host_numpy(logits)).mean(axis=-1)
                           < self.margin)
        return need


def check_config(cfg):
    """Raise ``ValueError`` for an invalid configuration (the
    reference's rules).  The serving cache's fields are checked for
    range only: the offline engines ignore them, as in the reference,
    and ``serving.DetectionServer`` reads them."""
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
    k = cfg.escalate_tiles
    if k > 1:
        if cfg.mode == "sequential":
            raise ValueError(
                "escalate_tiles > 1 needs a tile-decoding mode "
                "(tiled/qrmark); sequential decodes the full image")
        cap = tiling.max_escalation_tiles(
            cfg.strategy, (cfg.img_size, cfg.img_size), cfg.tile)
        if k > cap:
            raise ValueError(
                f"escalate_tiles={k} exceeds the {cap} distinct "
                f"{cfg.strategy!r} tiles of a {cfg.img_size}^2/"
                f"{cfg.tile}^2 image")


class StageRegistry:
    """The detection stage functions, built once per (cfg, params,
    device).  ``params`` is the extractor tree (torch tensors, e.g. from
    ``extractor.params_from_numpy``, or numpy arrays); it is moved once
    onto ``device`` and, for the fused decode, packed once there."""

    def __init__(self, cfg, params: dict, device: torch.device):
        check_config(cfg)
        self.cfg = cfg
        self.policy = EscalationPolicy(max_tiles=cfg.escalate_tiles,
                                       margin=cfg.escalate_margin)
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

    def content_key(self, fingerprint: int) -> torch.Tensor:
        """Content-addressed request key: ``fold_in(key(cfg.seed),
        fingerprint32(content digest))``.  The serving tier uses it for
        keyless requests when the exact result cache is on: identical
        pixels then get identical per-image keys, which is what makes a
        cache hit bitwise equal to the cold path (the contract of
        :meth:`batch_key`, with content in place of arrival order)."""
        return prng.fold_in(self.base_key, int(fingerprint) & 0xFFFFFFFF)

    # -- stages ----------------------------------------------------------
    def to_device(self, raw) -> torch.Tensor:
        """Raw uint8 batch (numpy or torch) -> contiguous tensor on the
        pipeline's device."""
        raw = torch.as_tensor(raw)
        if raw.dtype != torch.uint8:
            raise TypeError(f"raw images must be uint8, got {raw.dtype}")
        return raw.to(self.device).contiguous()

    def upload(self, raw) -> torch.Tensor:
        """Raw uint8 batch -> the pipeline's device, once: on a card
        through pinned host memory and a non-blocking copy on the current
        stream (``lanes.upload``); the ingest lane's upload."""
        raw = torch.as_tensor(raw)
        if raw.dtype != torch.uint8:
            raise TypeError(f"raw images must be uint8, got {raw.dtype}")
        return lanes_lib.upload(raw, self.device)

    def prepare(self, raw_shape):
        """Build every device constant that lanes read for raw batches of
        ``raw_shape`` (b, H, W, 3) — the kernel library, the ingest
        tables of the geometry, the int8 weight fragments, the device RS
        tables of another code — then wait for the device, so that no
        lane stream reads one before it is complete (the packed weights
        of ``__init__`` included).  On the CPU there is nothing to do."""
        if self.device.type != "cuda":
            return
        cfg = self.cfg
        _build.library()
        if cfg.mode == "qrmark" and cfg.fused_preprocess:
            ingest_tables(raw_shape[1], raw_shape[2], cfg.resize_src,
                          cfg.img_size, None, None, str(self.device))
        if self.packed_params is not None:
            device_constants(self.packed_params)
        if self._device_rs is not None and not is_kernel_code(cfg.code):
            torch_rs.field(cfg.code, self.device)
        torch.cuda.synchronize(self.device)

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
        with trace.span("ingest.offsets"):
            offs = tiling.tile_first_offsets(cfg.strategy, keys,
                                             img_size=cfg.img_size,
                                             tile=cfg.tile)
            offs = offs.to(raw.device).contiguous()
        return kops.fused_tile_preprocess(
            raw, offs, resize=cfg.resize_src, crop=cfg.img_size,
            tile=cfg.tile)

    def extract(self, tiles: torch.Tensor) -> torch.Tensor:
        """Decode-ready tiles -> bit logits: the fused kernel on the
        resolved schedule, or the plain ``extractor_forward``."""
        if self.fused_decode:
            return kops.fused_extractor(tiles, self.packed_params,
                                        schedule=self.decode_schedule)
        return extractor_lib.extractor_forward(self.params, tiles)

    def extract_embed(self, tiles: torch.Tensor):
        """:meth:`extract` that also returns the (b, n_bits) GAP
        embedding: the fused kernel with ``with_embed`` (the same
        launches, the head also writing the embedding) or the plain
        ``extractor_forward_embed``.  The logits are bitwise
        :meth:`extract`'s."""
        if self.fused_decode:
            return kops.fused_extractor(tiles, self.packed_params,
                                        schedule=self.decode_schedule,
                                        with_embed=True)
        return extractor_lib.extractor_forward_embed(self.params, tiles)

    def _keyed_tiles(self, x: torch.Tensor, keys: torch.Tensor
                     ) -> torch.Tensor:
        """The decode input's tiles: the staged path picks each image's
        tile here (``sequential`` decodes the full image)."""
        cfg = self.cfg
        if not (self.tile_first or cfg.mode == "sequential"):
            x, _ = tiling.select_tiles_per_image(cfg.strategy, keys, x,
                                                 cfg.tile)
        return x

    def decode_keyed(self, x: torch.Tensor, keys: torch.Tensor
                     ) -> torch.Tensor:
        """Decode input + per-image keys -> (b, n_bits) logits."""
        return self.extract(self._keyed_tiles(x, keys))

    def decode_keyed_embed(self, x: torch.Tensor, keys: torch.Tensor):
        """:meth:`decode_keyed` that also returns the GAP embedding:
        (logits, embed), the same tile selection, the logits bitwise
        :meth:`decode_keyed`'s (the near-duplicate cache's probe)."""
        return self.extract_embed(self._keyed_tiles(x, keys))

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

    def rs_correct(self, bits):
        """(msg, ok, ncorr) via the configured RS engine, for bits as a
        tensor or a numpy array: tensors on the pipeline's device from
        the device engine, numpy arrays from the host engines, which pull
        the bits to the host here."""
        if self.cfg.rs_mode == "device":
            out = self._device_rs(torch.as_tensor(bits).to(
                self.device).contiguous())
            return out["message_bits"], out["ok"], out["n_corrected"]
        return self._rs_host(host_numpy(bits))

    def _fused_keyed(self, raw: torch.Tensor, keys: torch.Tensor):
        """The whole qrmark path with device RS: raw batch + per-image
        keys -> (RS outputs, logits)."""
        x = self.ingest_keyed(raw, keys)
        logits = self.decode_keyed(x, keys)
        return self._device_rs(self.bits(logits)), logits

    # -- adaptive multi-tile escalation --------------------------------
    def escalation_plan(self, keys: torch.Tensor) -> torch.Tensor:
        """(b, k, 2) int32 tile offsets a batch on the host: column 0 is
        the one-tile draw, so round 1 is the unchanged fast path."""
        cfg = self.cfg
        return tiling.escalation_offsets(
            cfg.strategy, keys, (cfg.img_size, cfg.img_size), cfg.tile,
            self.policy.max_tiles)

    def _tiles_at(self, raw: torch.Tensor, offs: torch.Tensor
                  ) -> torch.Tensor:
        """(b, 2) or (b, k, 2) offsets -> decode-ready tiles (b*k image
        major), through the tile-first kernel or the staged preprocess
        and a gather."""
        cfg = self.cfg
        # pageable host memory is staged before the call returns, so the
        # copy needs no wait on the stream
        offs = offs.contiguous().to(raw.device, non_blocking=True)
        if self.tile_first:
            return kops.fused_tile_preprocess(
                raw, offs, resize=cfg.resize_src, crop=cfg.img_size,
                tile=cfg.tile)
        x = self.preprocess(raw)
        if offs.dim() == 3:
            return tiling.extract_tiles_k(x, offs, cfg.tile)
        return tiling.extract_tiles(x, offs, cfg.tile)

    def escalation_tiles(self, raw: torch.Tensor, keys: torch.Tensor,
                         r: int) -> torch.Tensor:
        """Decode-ready tiles of column ``r`` of each image's plan."""
        return self._tiles_at(raw, self.escalation_plan(keys)[:, r])

    def decode_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """Decode-ready tiles -> logits (an escalation round's decode)."""
        return self.extract(tiles)

    def decode_all_keyed(self, raw: torch.Tensor, keys: torch.Tensor
                         ) -> torch.Tensor:
        """All k tiles of every image at once -> (b, k, n_bits) logits:
        one ingest of the (b, k, 2) plan and one decode of b*k tiles."""
        plan = self.escalation_plan(keys)
        b, k = plan.shape[:2]
        return self.extract(self._tiles_at(raw, plan)).reshape(b, k, -1)

    def escalate_round(self, raw: torch.Tensor, keys: torch.Tensor,
                       r: int) -> torch.Tensor:
        """Soft bits of plan column ``r``: the round's ingest, then its
        decode."""
        return self.decode_tiles(self.escalation_tiles(raw, keys, r))

    def escalate(self, raw: torch.Tensor, keys: torch.Tensor, msg, ok,
                 ncorr, logits) -> Tuple:
        """Adaptive escalation after round 1: each round gathers the
        images the policy flags from ``raw`` (on the device already),
        decodes tile r of their plan, adds the soft bits to their sums
        (float32, round by round) and runs RS on the sums' signs, until
        no image is flagged or the budget is spent.  The sub-batch is the
        flagged rows themselves (no padding: every op is batch-stable,
        so a row's result does not depend on who shares its round).  The
        plan is drawn once, for the rows round 2 takes (a row's plan
        depends on its key only, so these are :meth:`escalate_round`'s
        tiles).  The host waits once a round, for ``ok`` (and with a
        margin for the sums).  Returns (msg, ok, ncorr, summed logits,
        tiles_used): RS outputs where the engine made them (tensors on
        the device, numpy from a host engine), tiles_used numpy; with
        escalation off, the inputs as they are and tiles_used all
        ones."""
        b = logits.shape[0]
        tiles_used = np.ones(b, np.int32)
        if not self.policy.enabled:
            return msg, ok, ncorr, logits, tiles_used
        with trace.span("escalate"):
            on_dev = isinstance(ok, torch.Tensor)
            msg, ok, ncorr = (a.clone() if on_dev else np.array(a)
                              for a in (msg, ok, ncorr))
            acc = logits.to(torch.float32).clone()
            need = self.policy.wants_escalation(ok, acc)
            plan_rows = plan = None
            for r in range(1, self.policy.max_tiles):
                idx = np.nonzero(need)[0]
                if idx.size == 0:
                    break
                if plan is None:
                    with trace.span("escalate.plan"):
                        plan_rows = idx
                        plan = self.escalation_plan(
                            keys[torch.as_tensor(idx)])
                with trace.span("escalate.round"):
                    with trace.span("escalate.gather"):
                        at_plan = torch.as_tensor(
                            np.searchsorted(plan_rows, idx))
                        idx_d = torch.as_tensor(idx).to(raw.device,
                                                        non_blocking=True)
                        sub_raw = raw.index_select(0, idx_d)
                    new = self.decode_tiles(self._tiles_at(
                        sub_raw, plan[at_plan, r]))
                    with trace.span("escalate.gather"):
                        sub_acc = acc[idx_d] + new
                        acc[idx_d] = sub_acc
                    m2, o2, c2 = self.rs_correct(self.bits(sub_acc))
                    at = idx_d if on_dev else idx
                    msg[at], ok[at], ncorr[at] = m2, o2, c2
                    tiles_used[idx] = r + 1
                    need[:] = False
                    need[idx] = self.policy.wants_escalation(o2, sub_acc)
        return msg, ok, ncorr, acc, tiles_used

    def escalate_prefix(self, raw: torch.Tensor, keys: torch.Tensor, msg,
                        ok, ncorr, logits, true_b: Optional[int] = None
                        ) -> Tuple:
        """:meth:`escalate` on the first ``true_b`` rows of a padded
        batch: pad rows keep their round-1 results and never escalate.
        Returns full-size results either way."""
        b = logits.shape[0]
        tb = b if true_b is None else min(true_b, b)
        if tb >= b:
            return self.escalate(raw, keys, msg, ok, ncorr, logits)
        m, o, c, lg, tu = self.escalate(raw[:tb], keys[:tb], msg[:tb],
                                        ok[:tb], ncorr[:tb], logits[:tb])
        msg, ok, ncorr = (a.clone() if isinstance(a, torch.Tensor)
                          else np.array(a) for a in (msg, ok, ncorr))
        logits = logits.to(torch.float32).clone()
        tiles = np.ones(b, np.int32)
        msg[:tb], ok[:tb], ncorr[:tb] = m, o, c
        logits[:tb], tiles[:tb] = lg, tu
        return msg, ok, ncorr, logits, tiles

    # -- the stage graph ---------------------------------------------
    def build_stages(self, lanes: Dict[str, int],
                     finish: Optional[Callable[[dict], Any]] = None,
                     depth: int = 2,
                     escalate_inline: bool = True,
                     emit_embed: bool = False
                     ) -> List[lanes_lib.Stage]:
        """The detection stage graph: the payload contract every
        executor-driven engine shares.

        Payloads are dicts carrying ``raw`` (a uint8 batch on the host)
        and ``keys`` (per-image fold_in keys, derived before the payload
        enters, so stage functions are pure and any lane count or
        arrival order equals serial execution bit for bit).  Ingest
        uploads ``raw`` once and puts the device copy in its place, then
        adds ``x``; decode adds ``logits``; rs adds ``msg`` / ``ok`` /
        ``ncorr`` and returns ``finish(p)``, the sink, where one is
        given (the one place device tensors should become numpy).  Extra
        fields flow through untouched.  On a card each lane runs on a
        stream of its own and a payload's tensors reach the next stage
        through an event (``lanes.LaneStreams``); call :meth:`prepare`
        before the first payload.

        Escalation: payloads may carry ``round`` (int, default 0) and
        ``acc_logits``.  A round-r > 0 payload ingests column r of each
        image's escalation plan (:meth:`escalation_tiles`), decodes it
        with :meth:`decode_tiles` and adds the soft bits to
        ``acc_logits``.  With ``escalate_inline`` (the offline engines)
        round-0 payloads instead run the whole adaptive loop on the rs
        lane (:meth:`escalate_prefix`, on the first ``true_b`` rows when
        the payload carries one), adding ``tiles_used``.

        ``emit_embed`` (the server with the near-duplicate cache on)
        makes round-0 decode also put the GAP embedding in the payload
        as ``embed``; the logits are bitwise unchanged."""
        streams = lanes_lib.LaneStreams(self.device)

        def st_ingest(p):
            r = p.get("round", 0)
            raw = self.upload(p["raw"])
            p["raw"] = raw
            if r > 0:
                # escalation round: ingest emits tile r of the plan
                # directly (decode-ready), whatever the ingest mode
                p["x"] = self.escalation_tiles(raw, p["keys"], r)
            else:
                p["x"] = self.ingest_keyed(raw, p["keys"])
            return p

        def st_decode(p):
            if p.get("round", 0) > 0:
                logits = self.decode_tiles(p["x"])
            elif emit_embed:
                logits, p["embed"] = self.decode_keyed_embed(p["x"],
                                                             p["keys"])
            else:
                logits = self.decode_keyed(p["x"], p["keys"])
            if p.get("acc_logits") is not None:
                logits = logits + torch.as_tensor(p["acc_logits"]).to(
                    logits.device)
            p["logits"] = logits
            return p

        def st_rs(p):
            p["msg"], p["ok"], p["ncorr"] = self.rs_correct(
                self.bits(p["logits"]))
            if (escalate_inline and self.policy.enabled
                    and p.get("round", 0) == 0):
                # a padded feeder's payload carries "true_b": only the
                # real rows escalate
                (p["msg"], p["ok"], p["ncorr"], p["logits"],
                 p["tiles_used"]) = self.escalate_prefix(
                    p["raw"], p["keys"], p["msg"], p["ok"], p["ncorr"],
                    p["logits"], p.get("true_b"))
            return finish(p) if finish is not None else p

        def stage(name, fn, **kw):
            return lanes_lib.Stage(name, streams.wrap(fn),
                                   lanes=max(1, lanes.get(name, 1)),
                                   depth=depth, **kw)

        return [stage("ingest", st_ingest),
                stage("decode", st_decode, gpu_intensive=True),
                stage("rs", st_rs)]

    def close(self):
        if self._rs_pool is not None:
            self._rs_pool.close()
            self._rs_pool = None
