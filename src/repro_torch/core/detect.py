"""End-to-end watermark detection pipeline (counterpart of
``repro.core.detect``).

:meth:`DetectionPipeline.detect_batch` takes a raw uint8 batch to
verified 48-bit keys in one of three modes:

* ``sequential`` — the paper's baseline: unfused preprocess, full-image
  decode (plain ``extractor_forward``);
* ``tiled`` — + per-image tile decode (naive tiling);
* ``qrmark`` — tile-first fused ingest (or, with ``tile_first=False``,
  the fused full-image ingest kernel then tile selection), the fused
  decode kernel on the flat or a blocked schedule (``decode_schedule``)
  at the precision ``decode_dtype`` picks: fp32; bf16 (bf16 operands,
  fp32 sums); int8 (per-channel weight scales, per-pixel activation
  quantization, exact integer tap dots, fp32 dequantization).  The
  lower rungs move logits by up to a few 1e-2 against fp32, which RS
  absorbs.

RS runs on the card (``rs_mode="device"``), per row on the host
(``cpu_sync``) or in a thread pool with a codebook (``cpu_pool``).
qrmark with device RS goes through the registry's fused path
(``StageRegistry.fused_keyed``); every other configuration through the
staged one (ingest -> decode -> bits -> ``rs_correct``).  With
``escalate_tiles`` k > 1 (``tiled`` or ``qrmark``), images whose round-1
RS failed, or whose mean |logit| is below ``escalate_margin``, are
decoded again on up to k - 1 more tiles of their plan, their soft bits
summed (``StageRegistry.escalate``); the result gains a ``tiles_used``
column.  The serving cache's fields configure the online server
(``repro_torch.serving.DetectionServer``); the offline engines here
ignore them, as in the reference.

Execution engines, all on the one registry:

* :meth:`DetectionPipeline.detect_batch` — one batch, synchronous;
* :meth:`DetectionPipeline.run_stream` — a stream of batches through
  the :class:`repro_torch.core.lanes.LaneExecutor` (ingest ► decode ►
  rs, N lanes a stage; on a card each lane a CUDA stream of its own);
* :meth:`DetectionPipeline.run_batch` — one (possibly ragged) batch
  split data-parallel over devices, one contiguous chunk each.

The pipeline runs on the card by default: ``device=None`` means
``"cuda"``, and raises if no GPU is present.  ``device="cpu"`` runs the
kernels' plain PyTorch versions on the CPU, as the tests do.

RNG discipline (as in the reference): batch k uses ``fold_in(key(seed),
k)`` and image i of a batch ``fold_in(batch_key, i)``, so the same
images with the same keys produce the same tiles — and the same keys as
the JAX package — in any batch, on any engine, lane count, padding or
device split.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import interleave, lanes as lanes_lib, trace
from repro_torch.core.rs.codec import DEFAULT_CODE, RSCode
from repro_torch.core.stages import STAGE_NAMES, StageRegistry, host_numpy


@dataclasses.dataclass
class DetectionConfig:
    """Configuration of the detection engines, with the reference's
    fields, names and defaults.  Every mode, ingest path, RS engine and
    code, decode schedule and decode dtype runs, and escalation
    (``escalate_tiles``, ``escalate_margin``).  The serving cache's
    fields (``cache_exact``, ``cache_embedding_threshold`` and the
    capacities) are range-checked when a pipeline is built
    (``stages.check_config``) and read by the online server only."""
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
    decode_dtype: str = "fp32"     # fp32 | bf16 | int8 (fused decode)
    decode_schedule: str = "flat"  # flat | auto | "bb<N>-ct<N>[-db]"
    autotune_cache: str = ""       # schedule cache path ("auto", by dtype)
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


def _index(device: torch.device) -> torch.device:
    """``device`` with its index: a CUDA device without one is the
    current device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
        self._registry_lock = threading.Lock()
        self._shard_registries: Dict[torch.device, StageRegistry] = {}

    def _finish(self, msg, ok, ncorr, logits,
                tiles_used=None) -> Dict[str, np.ndarray]:
        """The sink: the single place device tensors become numpy (the
        host RS engines hand numpy already).  ``tiles_used`` is reported
        only when escalation is configured, so ``escalate_tiles=1``
        results keep the schema they had without it.  It counts the
        ``batches`` it finishes (``core.trace``)."""
        with trace.span("finish"):
            trace.count("batches")
            out = {"message_bits": host_numpy(msg), "ok": host_numpy(ok),
                   "n_corrected": host_numpy(ncorr),
                   "logits": host_numpy(logits)}
            if tiles_used is not None and self.stages.policy.enabled:
                out["tiles_used"] = np.asarray(tiles_used)
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
        the offline discipline ``fold_in(key(seed), batch_seq)``.  With
        ``escalate_tiles > 1`` the escalation rounds run after the
        unchanged one-tile round: the result gains ``tiles_used`` and
        ``logits`` are the summed soft bits of escalated images.  A
        caller that padded the batch passes ``true_b``, the count of
        real rows, so pad rows never escalate."""
        raw = self.stages.to_device(raw_batch)
        b = raw.shape[0]
        if key is None:
            key = self.stages.batch_key(self._seq)
            self._seq += 1
        keys = self.stages.image_keys(key, b)
        if self.stages.fused_keyed is not None:
            rs_out, logits = self.stages.fused_keyed(raw, keys)
            msg, ok, ncorr = (rs_out["message_bits"], rs_out["ok"],
                              rs_out["n_corrected"])
        else:
            x = self.stages.ingest_keyed(raw, keys)
            logits = self.stages.decode_keyed(x, keys)
            msg, ok, ncorr = self.stages.rs_correct(
                self.stages.bits(logits))
        tiles_used = None
        if self.stages.policy.enabled:
            msg, ok, ncorr, logits, tiles_used = \
                self.stages.escalate_prefix(raw, keys, msg, ok, ncorr,
                                            logits, true_b)
        return self._finish(msg, ok, ncorr, logits, tiles_used)

    # -- staged compute, shared by the service's warm-up ------------
    def _ingest(self, raw, key):
        """Raw uint8 batch (uploaded here) -> (decode input, per-image
        keys)."""
        raw = self.stages.to_device(raw)
        keys = self.stages.image_keys(key, raw.shape[0])
        return self.stages.ingest_keyed(raw, keys), keys

    def _decode_x(self, x, keys):
        """Decode input + per-image keys -> bit logits."""
        return self.stages.decode_keyed(x, keys)

    def _bits(self, logits):
        return self.stages.bits(logits)

    def _rs_correct(self, bits):
        """(msg, ok, ncorr) via the registry's configured RS engine."""
        return self.stages.rs_correct(bits)

    # -- stage graph ----------------------------------------------------
    def default_lanes(self) -> Dict[str, int]:
        """Static lane split within ``cfg.lane_budget`` (Algorithm 1's
        warm start: decode, the device-bound stage, gets the most lanes;
        ``allocator.assign`` gives the profiled allocation)."""
        cfg = self.cfg
        if cfg.mode != "qrmark":
            return {n: 1 for n in STAGE_NAMES}
        budget = max(3, cfg.lane_budget)
        decode = min(4, max(1, budget // 2))
        rs = min(4, max(1, budget - decode - 1))
        return {"ingest": 1, "decode": decode, "rs": rs}

    def _finish_payload(self, p: dict) -> Dict[str, np.ndarray]:
        """The stage graph's sink for the offline engines."""
        return self._finish(p["msg"], p["ok"], p["ncorr"], p["logits"],
                            p.get("tiles_used"))

    def build_stages(self, lanes: Optional[Dict[str, int]] = None
                     ) -> List[lanes_lib.Stage]:
        """The detection stage graph for the lane executor, with
        :meth:`_finish` as the sink (see
        :meth:`StageRegistry.build_stages`)."""
        ln = {**self.default_lanes(), **(lanes or {})}
        return self.stages.build_stages(
            ln, finish=self._finish_payload,
            depth=2 if self.cfg.interleave else 1)

    def run_stream(self, batches: Iterable, *, scheduled: bool = True,
                   lanes: Union[None, int, Dict[str, int]] = None,
                   on_result: Optional[Callable[[int, dict], None]] = None
                   ) -> dict:
        """Detect a stream of batches; returns throughput metrics and the
        results in input order.

        Batch i of the stream uses key ``fold_in(key(cfg.seed), seq0 +
        i)`` (the pipeline's running batch counter), so for any lane
        configuration the results equal serial :meth:`detect_batch`
        calls over the same stream, bit for bit, escalation included.

        ``lanes``: None -> the lane executor with :meth:`default_lanes`
        for qrmark (the prefetch loop otherwise); int n -> n decode and
        n RS lanes; dict -> explicit lane counts a stage.  Items are raw
        batches, or ``(raw, true_b)`` tuples from a padding feeder (pad
        rows then never escalate).  ``on_result(i, res)`` fires as
        result i leaves the executor.  The device constants the lanes
        read are built, and the device waited for, before the first
        payload enters (:meth:`StageRegistry.prepare`)."""
        cfg = self.cfg
        use_exec = lanes is not None or cfg.mode == "qrmark"
        if isinstance(lanes, int):
            lanes = {"ingest": 1, "decode": max(1, lanes),
                     "rs": max(1, lanes)}
        n_img = 0
        results = []
        t0 = time.perf_counter()
        if use_exec:
            stages = self.build_stages(lanes)
            ex = lanes_lib.LaneExecutor(stages, name="detect")
            seq0 = self._seq

            def feed():
                for i, item in enumerate(batches):
                    raw, tb = (item if isinstance(item, tuple)
                               else (item, None))
                    if i == 0:
                        self.stages.prepare(raw.shape)
                    with trace.span("feed.keys", seq0 + i):
                        bkey = self.stages.batch_key(seq0 + i)
                        keys = self.stages.image_keys(bkey, raw.shape[0])
                    p = {"raw": raw, "seq": seq0 + i, "keys": keys}
                    if tb is not None:
                        p["true_b"] = tb
                    yield p

            for r in ex.run(feed()):
                if on_result is not None:
                    on_result(len(results), r)
                results.append(r)
                n_img += r["logits"].shape[0]
            self._seq = seq0 + len(results)
            lane_map = {s.name: s.lanes for s in stages}
        else:
            it = interleave.interleaved(
                batches, prepare=None,
                enabled=(cfg.interleave and cfg.mode == "qrmark"),
                device=self.device)
            for item in it:
                raw, tb = (item if isinstance(item, tuple)
                           else (item, None))
                r = self.detect_batch(raw, true_b=tb)
                if on_result is not None:
                    on_result(len(results), r)
                results.append(r)
                n_img += raw.shape[0]
            lane_map = {n: 1 for n in STAGE_NAMES}
        wall = time.perf_counter() - t0
        return {"images": n_img, "wall_s": wall,
                "throughput_ips": n_img / wall if wall > 0 else 0.0,
                "lanes": lane_map, "results": results}

    # -- data parallel --------------------------------------------------
    def _registry_on(self, device: torch.device) -> StageRegistry:
        """The registry of ``device``: the pipeline's own on its device,
        else one made at first use with the weights copied there once.
        Those run ingest, decode and device RS only (a host RS engine
        runs on the pipeline's own), so they are built with device RS
        and no thread pool."""
        if _index(device) == _index(self.device):
            return self.stages
        with self._registry_lock:   # run_batch's chunk threads
            reg = self._shard_registries.get(device)
            if reg is None:
                reg = StageRegistry(
                    dataclasses.replace(self.cfg, rs_mode="device"),
                    self.stages.params, device)
                self._shard_registries[device] = reg
            return reg

    def run_batch(self, raw_batch, *, mesh=None,
                  key: Optional[torch.Tensor] = None
                  ) -> Dict[str, np.ndarray]:
        """One (possibly ragged) batch, data-parallel across devices.

        ``mesh`` is a list of devices (``launch.mesh.make_detection_mesh``
        by default: the visible CUDA devices).  The batch is padded up to
        a multiple of their count by repeating its last row, split into
        one contiguous chunk a device (``sharding.planner``), and each
        chunk runs ingest, decode and — with device RS — RS on its own
        device's registry, all chunks at once; the pipeline's device
        gathers the outputs and slices them to the true batch.  A host
        RS engine runs on the gathered bits.  Escalation runs unsharded
        on the pipeline's device, on the true rows.  Per-image keys make
        the pad rows inert: every real row equals :meth:`detect_batch`
        on the whole batch with the same key, bit for bit."""
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.sharding import planner

        if key is None:
            key = self.stages.batch_key(self._seq)
            self._seq += 1
        raw_np = np.asarray(raw_batch)
        b = raw_np.shape[0]
        devices = mesh_lib.make_detection_mesh(mesh)
        pad = (-b) % len(devices)
        if pad:
            raw_np = np.concatenate(
                [raw_np, np.repeat(raw_np[-1:], pad, axis=0)])
        keys = self.stages.image_keys(key, raw_np.shape[0])
        chunks = planner.shard_detection_batch(devices, raw_np)
        device_rs = self.cfg.rs_mode == "device"
        outs: list = [None] * len(chunks)

        def run_chunk(i, dev, raw, rows):
            try:
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    reg = self._registry_on(dev)
                    kc = keys[rows]
                    logits = reg.decode_keyed(reg.ingest_keyed(raw, kc), kc)
                    rs = (reg.rs_correct(reg.bits(logits)) if device_rs
                          else ())
                outs[i] = (logits, *rs)
            except Exception as e:  # re-raised on the calling thread
                outs[i] = e

        threads = [threading.Thread(target=run_chunk, args=(i, *c),
                                    name=f"run_batch/{c[0]}")
                   for i, c in enumerate(chunks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for o in outs:
            if isinstance(o, Exception):
                raise o
        dev0 = self.device
        gathered = [torch.cat([o[j].to(dev0) for o in outs])[:b]
                    for j in range(len(outs[0]))]
        logits = gathered[0]
        if device_rs:
            msg, ok, ncorr = gathered[1:]
        else:
            msg, ok, ncorr = self.stages.rs_correct(self.stages.bits(logits))
        tiles_used = None
        if self.stages.policy.enabled:
            msg, ok, ncorr, logits, tiles_used = self.stages.escalate(
                self.stages.to_device(raw_np[:b]), keys[:b], msg, ok,
                ncorr, logits)
        return self._finish(msg, ok, ncorr, logits, tiles_used)

    def close(self):
        """Stop the RS pool's threads (``rs_mode="cpu_pool"``)."""
        self.stages.close()
        for reg in self._shard_registries.values():
            reg.close()


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
