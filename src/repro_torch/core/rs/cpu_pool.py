"""Paper-faithful CPU-side RS correction: input queue + thread pool +
codebook cache (QRMark §5.3).

The decoded raw messages m' are dispatched to idle CPU threads for
correction and the corrected outputs c_s are collected asynchronously, so
device->host transfers and CPU compute never stall the accelerator
pipeline.  A codebook cb maps recurring m' to c_s, with an access counter
per entry (the embedded message set is small and detection accuracy is
high, so raw messages recur constantly).

This is the BASELINE path; the port's on-device decoder is the RS
kernel (``kernels/rs_decode.py``).  Copied from
``repro.core.rs.cpu_pool`` (numpy and threads) over the port's scalar
codec.  Worker threads are daemons and :meth:`RSCorrectionPool.close`
joins them.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.rs.codec import RSCode, rs_decode


class RSCodebook:
    """m' -> c_s cache with LRU-ish counter eviction (QRMark §5.3)."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._cb: Dict[bytes, Tuple[np.ndarray, bool]] = {}
        self._count: Dict[bytes, int] = {}  # images since last access
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, raw_bits: np.ndarray):
        key = np.packbits(raw_bits.astype(np.uint8)).tobytes()
        with self._lock:
            for k in list(self._count):
                self._count[k] += 1
            if key in self._cb:
                self._count[key] = 0
                self.hits += 1
                return self._cb[key]
            self.misses += 1
            return None

    def insert(self, raw_bits: np.ndarray, corrected: np.ndarray, ok: bool):
        key = np.packbits(raw_bits.astype(np.uint8)).tobytes()
        with self._lock:
            if len(self._cb) >= self.capacity:
                # evict the stalest entry
                stale = max(self._count, key=self._count.get)
                self._cb.pop(stale, None)
                self._count.pop(stale, None)
            self._cb[key] = (corrected, ok)
            self._count[key] = 0

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


@dataclass
class RSWorkItem:
    seq: int
    raw_bits: np.ndarray


class RSCorrectionPool:
    """Thread-pool RS corrector with an input queue (QRMark §5.3).

    submit() is non-blocking; results are collected with drain()/result().
    """

    def __init__(self, code: RSCode, n_threads: int = 32,
                 codebook: Optional[RSCodebook] = None):
        self.code = code
        self.codebook = codebook if codebook is not None else RSCodebook()
        self._in: "queue.Queue[Optional[RSWorkItem]]" = queue.Queue()
        self._results: Dict[int, Tuple[np.ndarray, bool]] = {}
        self._rlock = threading.Lock()
        self._rcond = threading.Condition(self._rlock)
        self._threads: List[threading.Thread] = []
        self._stop = False
        for _ in range(n_threads):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        while True:
            item = self._in.get()
            if item is None:
                return
            cached = self.codebook.lookup(item.raw_bits)
            if cached is not None:
                msg, ok = cached
            else:
                res = rs_decode(self.code, item.raw_bits)
                msg, ok = res.message_bits, res.ok
                self.codebook.insert(item.raw_bits, msg, ok)
            with self._rcond:
                self._results[item.seq] = (msg, ok)
                self._rcond.notify_all()

    def submit(self, seq: int, raw_bits: np.ndarray):
        self._in.put(RSWorkItem(seq, np.asarray(raw_bits)))

    def submit_batch(self, raw_bits_batch: np.ndarray, base_seq: int = 0):
        for i, rb in enumerate(raw_bits_batch):
            self.submit(base_seq + i, rb)

    def result(self, seq: int, timeout: float = 30.0):
        with self._rcond:
            while seq not in self._results:
                if not self._rcond.wait(timeout):
                    raise TimeoutError(f"RS result {seq} not ready")
            return self._results.pop(seq)

    def drain(self, seqs, timeout: float = 30.0):
        return [self.result(s, timeout) for s in seqs]

    def close(self):
        for _ in self._threads:
            self._in.put(None)
        for t in self._threads:
            t.join(timeout=5)
