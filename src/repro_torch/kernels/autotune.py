"""Autotune harness for the blocked decode schedule (counterpart of
``repro.kernels.autotune``).

The blocked kernel (``fused_extractor_blocked``) exposes a small
schedule space — batch block x channel tile x weight double-buffering —
whose winner depends on the card, the dtype, the tile size and the
network width.  This module sweeps the candidates on a representative
workload, times each with warm-up + median, and persists the winner in
a small JSON cache keyed by ``backend|dtype|tile|channels|depth|n_bits``
— ``serve --autotune`` populates it and ``--schedule auto`` (or
``DetectionConfig.decode_schedule="auto"``) loads it when a pipeline is
built.  The backend is ``cuda:<device name>`` on a card (a schedule
tuned on one card type is not taken for another) and ``cpu`` on the
CPU, where the plain versions run.

Schedules are interchangeable bitwise on the card at every rung (the
blocked kernel equals the flat one at every candidate), so a stale or
missing cache can always fall back to the flat schedule — loudly, never
silently.  Each dtype has its own cache entry: the pack's dtype is part
of the key.

CLI::

    PYTHONPATH=src python -m repro_torch.kernels.autotune \\
        --tile 64 --batch 32 [--dtype fp32|bf16|int8] \\
        --cache experiments/autotune/decode_schedules.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.extractor import packed_dtype

CACHE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One blocked-kernel schedule point.

    ``batch_block`` images per block, ``channel_tile`` output channels
    per accumulation pass (0 = full width), ``double_buffer`` stages the
    next channel tile's weights while the current one computes.  The
    string form ("bb2-ct32-db") is what the JSON cache and the
    ``--schedule`` flag speak.
    """
    batch_block: int = 1
    channel_tile: int = 0
    double_buffer: bool = True

    def to_string(self) -> str:
        s = f"bb{self.batch_block}-ct{self.channel_tile}"
        return s + "-db" if self.double_buffer else s

    @classmethod
    def from_string(cls, s: str) -> "Schedule":
        parts = s.strip().lower().split("-")
        if (len(parts) not in (2, 3)
                or not parts[0].startswith("bb")
                or not parts[1].startswith("ct")
                or (len(parts) == 3 and parts[2] != "db")):
            raise ValueError(
                f"bad schedule string {s!r}: expected 'flat', 'auto' or "
                f"'bb<N>-ct<N>[-db]' (e.g. 'bb2-ct32-db')")
        try:
            bb, ct = int(parts[0][2:]), int(parts[1][2:])
        except ValueError:
            raise ValueError(f"bad schedule string {s!r}: "
                             f"non-integer block sizes") from None
        if bb < 1 or ct < 0:
            raise ValueError(f"bad schedule string {s!r}: "
                             f"need bb >= 1 and ct >= 0")
        return cls(bb, ct, len(parts) == 3)


def backend_name(device) -> str:
    """``cuda:<device name>`` for a CUDA device, else ``cpu``."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return "cpu"


def schedule_key(*, backend: str, dtype: str, tile: int, channels: int,
                 depth: int, n_bits: int) -> str:
    """Cache key: every axis that changes the winner (or the kernel)."""
    return f"{backend}|{dtype}|t{tile}|c{channels}|d{depth}|n{n_bits}"


# cache_lookup's "no entry" sentinel: distinct from None, because the
# cached WINNER can legitimately be the flat schedule (represented as
# None everywhere a kernel schedule is passed around)
MISS = object()


def _from_cached(s: str):
    """Cached schedule string -> kernel schedule ("flat" -> None)."""
    return None if s == "flat" else Schedule.from_string(s)


def candidate_schedules(batch: int, channels: int, backend: str = "cpu",
                        quick: bool = False):
    """The sweep space for one key: batch blocks up to the batch, full
    or half channel tiles, and on a card weight double-buffering on and
    off (the plain versions on the CPU have no buffering to tune)."""
    bbs = [b for b in (1, 2, 4, 8) if b <= max(batch, 1)]
    cts = [0, channels // 2]
    dbs = (True, False) if backend.startswith("cuda") else (True,)
    if quick:
        bbs, cts, dbs = bbs[:2], [0], (True,)
    return [Schedule(bb, ct, db)
            for bb in bbs for ct in cts for db in dbs]


def time_fn(fn, *args, iters: int = 3, warmup: int = 1,
            device="cpu") -> float:
    """Median seconds per call after warm-up (median resists the one-off
    scheduling spikes a mean would absorb): CUDA events around each
    call on a card, the host clock on the CPU."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    cuda = torch.device(device).type == "cuda"
    samples = []
    for _ in range(max(iters, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def _check_dtype(packed, dtype: str):
    if packed_dtype(packed) != dtype:
        raise ValueError(f"dtype {dtype!r} does not match the pack's "
                         f"{packed_dtype(packed)!r}")


def sweep(packed, tile: int, batch: int, *, dtype: str = "fp32",
          iters: int = 3, warmup: int = 1, candidates=None,
          quick: bool = False, log=print) -> dict:
    """Time the flat kernel and every candidate blocked schedule on a
    synthetic (batch, tile, tile, 3) workload on the pack's device, at
    the pack's rung (``dtype`` must name it); return the record that
    goes into the cache.  Flat itself is a candidate: when every blocked
    schedule loses to it, the cached winner is "flat" — the tuner never
    crowns a schedule slower than the baseline.  The record keeps the
    full swept list either way."""
    from repro_torch.kernels import ops as kops
    _check_dtype(packed, dtype)

    device = packed["head"]["b"].device
    backend = backend_name(device)
    channels = packed["blocks"][0]["w"].shape[-1]
    tiles = torch.as_tensor(np.random.default_rng(0).uniform(
        -1.0, 1.0, (batch, tile, tile, 3)).astype(np.float32)).to(device)
    wall_flat = time_fn(lambda: kops.fused_extractor(tiles, packed),
                        iters=iters, warmup=warmup, device=device)
    log(f"[autotune] flat: {wall_flat * 1e3:.3f}ms "
        f"(tile={tile} batch={batch} dtype={dtype} backend={backend})")

    candidates = candidates or candidate_schedules(
        batch, channels, backend, quick=quick)
    swept = [{"schedule": "flat", "wall_ms": wall_flat * 1e3,
              "speedup_vs_flat": 1.0}]
    best, best_wall = "flat", wall_flat
    for sc in candidates:
        wall = time_fn(lambda _sc=sc: kops.fused_extractor(
            tiles, packed, schedule=_sc), iters=iters, warmup=warmup,
            device=device)
        swept.append({"schedule": sc.to_string(),
                      "wall_ms": wall * 1e3,
                      "speedup_vs_flat": wall_flat / wall})
        log(f"[autotune]   {sc.to_string():<14} {wall * 1e3:8.3f}ms  "
            f"speedup={wall_flat / wall:.3f}")
        if wall < best_wall:
            best, best_wall = sc.to_string(), wall
    return {
        "schedule": best,
        "wall_flat_ms": wall_flat * 1e3,
        "wall_best_ms": best_wall * 1e3,
        "speedup_vs_flat": wall_flat / best_wall,
        "batch": batch,
        "swept": swept,
    }


# ---------------------------------------------------------------------------
# JSON cache
# ---------------------------------------------------------------------------


def load_cache(path) -> dict:
    """Load the schedule cache; a corrupt or stale (version-mismatched)
    file degrades to an empty cache with a LOUD warning — every caller
    then falls back to the flat schedule, which is always correct."""
    path = Path(path)
    if not path.exists():
        return {"version": CACHE_VERSION, "entries": {}}
    try:
        data = json.loads(path.read_text())
    except (json.JSONDecodeError, OSError) as e:
        print(f"[autotune] WARNING: schedule cache {path} is corrupt "
              f"({e}); ignoring it and falling back to the flat "
              f"schedule", file=sys.stderr)
        return {"version": CACHE_VERSION, "entries": {}}
    if (not isinstance(data, dict)
            or data.get("version") != CACHE_VERSION
            or not isinstance(data.get("entries"), dict)):
        print(f"[autotune] WARNING: schedule cache {path} has stale or "
              f"unknown format (version="
              f"{data.get('version') if isinstance(data, dict) else '?'}"
              f", want {CACHE_VERSION}); ignoring it and falling back "
              f"to the flat schedule", file=sys.stderr)
        return {"version": CACHE_VERSION, "entries": {}}
    return data


def save_cache(path, cache) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cache, indent=2, sort_keys=True) + "\n")


def cache_lookup(cache: dict, key: str):
    """Cached winner for ``key``: a blocked ``Schedule``, None (the
    winner was flat), or the ``MISS`` sentinel when there is no entry;
    an unparseable stored schedule is reported loudly and treated as a
    miss (flat fallback)."""
    entry = cache.get("entries", {}).get(key)
    if entry is None:
        return MISS
    try:
        return _from_cached(entry["schedule"])
    except (ValueError, KeyError, TypeError) as e:
        print(f"[autotune] WARNING: cache entry for {key!r} is invalid "
              f"({e}); falling back to the flat schedule",
              file=sys.stderr)
        return MISS


def autotune(packed, *, tile: int, batch: int, dtype: str,
             cache_path, iters: int = 3, warmup: int = 1,
             quick: bool = False, force: bool = False, log=print):
    """Cache-through autotune: return the winning Schedule for this
    (backend, dtype, tile, net) key, sweeping and persisting only on a
    cache miss (or ``force``).  ``dtype`` must be the pack's.  Prints
    "cache hit" on reuse so smoke tests can assert the sweep was
    skipped."""
    _check_dtype(packed, dtype)
    key = schedule_key(backend=backend_name(packed["head"]["b"].device),
                       dtype=dtype, tile=tile,
                       channels=packed["blocks"][0]["w"].shape[-1],
                       depth=len(packed["blocks"]),
                       n_bits=packed["head"]["b"].shape[0])
    cache = load_cache(cache_path)
    if not force:
        hit = cache_lookup(cache, key)
        if hit is not MISS:
            log(f"[autotune] cache hit: {key} -> "
                f"{'flat' if hit is None else hit.to_string()}")
            return hit
    record = sweep(packed, tile, batch, dtype=dtype, iters=iters,
                   warmup=warmup, quick=quick, log=log)
    cache["entries"][key] = record
    save_cache(cache_path, cache)
    log(f"[autotune] cached: {key} -> {record['schedule']} "
        f"(speedup {record['speedup_vs_flat']:.3f} vs flat) -> "
        f"{cache_path}")
    return _from_cached(record["schedule"])


def resolve_schedule(spec: str, *, dtype: str, tile: int, channels: int,
                     depth: int, n_bits: int, cache_path="",
                     device="cpu"):
    """DetectionConfig.decode_schedule -> kernel schedule.

    "flat" (default) -> None (the flat kernel); "auto" -> cache lookup
    under ``device``'s backend, with a printed hint + flat fallback when
    the cache has no entry for this key; "bb<N>-ct<N>[-db]" -> that
    explicit schedule.  Raises ValueError on anything else so config
    typos fail at build, not in the hot path."""
    spec = (spec or "flat").strip().lower()
    if spec == "flat":
        return None
    if spec == "auto":
        key = schedule_key(backend=backend_name(device), dtype=dtype,
                           tile=tile, channels=channels, depth=depth,
                           n_bits=n_bits)
        if not cache_path:
            print(f"[autotune] decode_schedule='auto' but no autotune "
                  f"cache path configured; run `python -m "
                  f"repro_torch.kernels.autotune` or `serve --autotune` "
                  f"and set autotune_cache.  Falling back to the flat "
                  f"schedule for {key}", file=sys.stderr)
            return None
        sc = cache_lookup(load_cache(cache_path), key)
        if sc is MISS:
            print(f"[autotune] no cached schedule for {key} in "
                  f"{cache_path}; run `python -m "
                  f"repro_torch.kernels.autotune` or `serve --autotune` "
                  f"to populate it.  Falling back to the flat schedule",
                  file=sys.stderr)
            return None
        return sc
    return Schedule.from_string(spec)


def main(argv=None):
    from repro_torch.core.extractor import init_extractor, pack_params

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="Sweep blocked decode schedules and cache winners")
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="fp32",
                    choices=("fp32", "bf16", "int8"),
                    help="decode rung to tune (its own cache entry)")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--depth", type=int, default=7)
    ap.add_argument("--n-bits", type=int, default=60)
    ap.add_argument("--cache",
                    default="experiments/autotune/decode_schedules.json")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--quick", action="store_true",
                    help="tiny candidate set (CI smoke)")
    ap.add_argument("--force", action="store_true",
                    help="re-sweep even on a cache hit")
    ap.add_argument("--device", default="cuda",
                    help="torch device to tune on (default: cuda)")
    args = ap.parse_args(argv)

    params = init_extractor(torch.Generator().manual_seed(2),
                            n_bits=args.n_bits, channels=args.channels,
                            depth=args.depth, tile=args.tile,
                            device=args.device)
    packed = pack_params(params, args.dtype)
    sc = autotune(packed, tile=args.tile, batch=args.batch,
                  dtype=args.dtype, cache_path=args.cache,
                  iters=args.iters, warmup=args.warmup,
                  quick=args.quick, force=args.force)
    print(f"[autotune] schedule: "
          f"{'flat' if sc is None else sc.to_string()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
