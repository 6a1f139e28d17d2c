"""Synthetic procedural images for detection and training runs, and the
synthetic token stream of LM training (numpy copies of
``repro.data.pipeline``'s ``synth_image``, ``image_batches``,
``ImageShard``, ``token_batch`` and ``lm_batches``, so the port never
imports the JAX package).  Deterministic given (seed, index), so every
worker can slice its own shard without coordination, and a restarted
run sees the same batches (the stream is indexed by global step)."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def synth_image(idx: int, size: int = 256, seed: int = 0) -> np.ndarray:
    """Deterministic procedural RGB image (uint8 HWC): mixed gradients,
    sinusoids and rectangles."""
    rng = np.random.default_rng(np.uint64(seed) * 1_000_003 + np.uint64(idx))
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    img = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        a, b, ph = rng.uniform(1, 6, 3)
        img[..., c] = 0.5 + 0.25 * np.sin(2 * np.pi * (a * yy + b * xx) + ph)
    # random soft rectangles
    for _ in range(6):
        y0, x0 = rng.integers(0, max(size - 8, 1), 2)
        h, w = rng.integers(min(8, size // 4 + 1), max(size // 2, 9), 2)
        col = rng.uniform(0, 1, 3)
        alpha = rng.uniform(0.2, 0.7)
        img[y0:y0 + h, x0:x0 + w] = (1 - alpha) * img[y0:y0 + h, x0:x0 + w] \
            + alpha * col
    noise = rng.normal(0, 0.02, img.shape)
    return np.clip((img + noise) * 255, 0, 255).astype(np.uint8)


def image_batches(n_images: int, batch: int, *, size: int = 256,
                  seed: int = 0, start: int = 0) -> Iterator[np.ndarray]:
    for b0 in range(start, start + n_images, batch):
        n = min(batch, start + n_images - b0)
        yield np.stack([synth_image(b0 + i, size, seed) for i in range(n)])


@dataclasses.dataclass
class ImageShard:
    """Deterministic per-worker slice of the image stream."""
    worker: int
    n_workers: int
    batch: int
    size: int = 256
    seed: int = 0

    def batches(self, n_batches: int, epoch: int = 0):
        base = epoch * 1_000_000_000 + self.worker
        for k in range(n_batches):
            idx0 = base + k * self.n_workers * self.batch
            yield np.stack([synth_image(idx0 + i * self.n_workers,
                                        self.size, self.seed)
                            for i in range(self.batch)])


# ---------------------------------------------------------------------------
# synthetic token stream for LM training
# ---------------------------------------------------------------------------


def token_batch(step: int, batch: int, seq: int, vocab: int,
                seed: int = 0) -> np.ndarray:
    """Markov-ish synthetic tokens: deterministic in (seed, step)."""
    rng = np.random.default_rng(np.uint64(seed) * 7_919 + np.uint64(step))
    # low-entropy structure so the loss actually decreases
    base = rng.integers(0, vocab, (batch, 1 + seq // 8))
    toks = np.repeat(base, 8, axis=1)[:, :seq]
    noise = rng.integers(0, vocab, toks.shape)
    mask = rng.random(toks.shape) < 0.15
    return np.where(mask, noise, toks).astype(np.int32)


def lm_batches(cfg, shape, *, n_steps: int, seed: int = 0,
               start_step: int = 0):
    """Train batches for an arch config: tokens, or the encoder's frame
    embeddings and target tokens, or a vision prefix of patch embeddings
    and the text tokens."""
    b, s = shape.global_batch, shape.seq_len
    for step in range(start_step, start_step + n_steps):
        if cfg.is_encoder_decoder:
            rng = np.random.default_rng(seed * 31 + step)
            tgt = max(64, s // 8)
            yield {"frame_embeds": rng.normal(
                0, 1, (b, s, cfg.d_model)).astype(np.float32),
                "tgt_tokens": token_batch(step, b, tgt, cfg.vocab, seed)}
        elif cfg.frontend == "vision":
            rng = np.random.default_rng(seed * 37 + step)
            nf = cfg.n_frontend_tokens
            yield {"tokens": token_batch(step, b, s - nf, cfg.vocab, seed),
                   "patch_embeds": rng.normal(
                       0, 1, (b, nf, cfg.d_model)).astype(np.float32)}
        else:
            yield {"tokens": token_batch(step, b, s, cfg.vocab, seed)}
