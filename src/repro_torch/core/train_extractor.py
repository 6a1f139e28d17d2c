"""QRMark offline stage (§4.1): pre-train the tile-based watermark
encoder H_E and extractor H_D with the RS-aware loss (counterpart of
``repro.core.train_extractor``).

The reference differentiates its plain XLA forward with
``jax.value_and_grad``; no Pallas kernel has a backward.  Here the same
forward runs as plain PyTorch ops under autograd: the encoder's convs as
tap matmuls (``extractor.conv2d``), the attacks of
``transforms.ATTACKS``, the extractor through its packed body
(``extractor.extractor_forward``), the losses of :mod:`losses`, then
AdamW (``train.optimizer``).  Float32 means float32: on a card the
trainer refuses to run unless the matmul precision is "highest" (no
TF32), and no convolution library is asked.

Keys are the port's threefry (``prng``), so ``train(cfg,
init_params=...)`` draws the reference's batches, tile offsets,
messages and attack indices exactly.  Keys and batches are made on the
host and uploaded, as the reference prepares its batches on the host.

:func:`evaluate` embeds with the trained encoder and decodes through
``kernels.ops``: on a card the hand-written CUDA decode (flat fp32) and
RS kernels, on the CPU their plain versions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import losses, prng, tiling, transforms
from repro_torch.core.detect import resolve_device
from repro_torch.core.extractor import (encoder_forward, extractor_forward,
                                        init_encoder, init_extractor,
                                        pack_params, params_from_numpy)
from repro_torch.core.rs.codec import DEFAULT_CODE, RSCode, rs_encode
from repro_torch.data.pipeline import synth_image
from repro_torch.kernels import ops
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class ExtractorTrainConfig:
    code: RSCode = DEFAULT_CODE
    tile: int = 32
    img_size: int = 128
    alpha: float = 1.0
    lam_rs: float = 1.0
    lam_img: float = 0.0  # PSNR pinned by power-normalised embedding
    channels: int = 24
    depth: int = 4
    enc_channels: int = 24
    enc_depth: int = 3
    batch: int = 32
    steps: int = 400
    lr: float = 3e-3
    seed: int = 0
    strategy: str = "random_grid"
    # training transform set T (differentiable surrogates)
    train_attacks: Tuple[str, ...] = ("none", "none", "blur", "jpeg_50",
                                      "brightness_2", "contrast_2",
                                      "resize_0.5")
    # curriculum: first this fraction of steps trains clean (attack 0 =
    # 'none'), then the full transform set T kicks in
    curriculum_frac: float = 0.5


TRAIN_ATTACK_FNS = transforms.ATTACKS


def check_fp32(device: torch.device):
    """Raise unless float32 matmuls on ``device`` run at full float32
    precision: the reference trains in float32, and a TF32 matmul would
    change the gradients.  Nothing global is changed here."""
    if device.type == "cuda" and \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "training runs float32 matmuls; torch's float32 matmul "
            "precision is set to "
            f"{torch.get_float32_matmul_precision()!r} (TF32); set it to "
            "'highest' first")


def apply_attacks(names, xw: torch.Tensor, attack_idx: torch.Tensor
                  ) -> torch.Tensor:
    """Row i of ``xw`` through attack ``names[attack_idx[i]]``: the
    reference applies every attack to the whole batch and picks a row's
    per sample; only the attacks some row picks run here (an attack acts
    on each image alone, so the rows are the same)."""
    idx = attack_idx.to(device=xw.device, dtype=torch.int64)
    out = None
    for a in sorted(set(idx.tolist())):
        ya = TRAIN_ATTACK_FNS[names[a]](xw)
        out = ya if out is None else torch.where(
            (idx == a)[:, None, None, None], ya, out)
    return out


def make_loss_fn(cfg: ExtractorTrainConfig):
    """The trainer's loss on {"enc", "dec"} params: -> (loss, parts)."""

    def loss_fn(params, tiles, messages, attack_idx):
        xw, delta = encoder_forward(params["enc"], tiles, messages,
                                    alpha=cfg.alpha)
        xw_t = apply_attacks(cfg.train_attacks, xw, attack_idx)
        logits = extractor_forward(params["dec"], xw_t)
        total, parts = losses.qrmark_loss(logits, messages, code=cfg.code,
                                          lam=cfg.lam_rs)
        l_img = torch.mean(torch.square(delta))
        parts["L_img"] = l_img
        parts["bit_acc"] = losses.bit_accuracy(logits, messages)
        return total + cfg.lam_img * l_img, parts

    return loss_fn


def value_and_grad(loss_fn, params, *args):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    -> ((loss, parts), grads), grads a tree like ``params`` (zeros where
    the loss does not reach a leaf), everything detached."""
    leaves = opt_lib.tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, parts = loss_fn(opt_lib.tree_unflatten(params, live), *args)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(live, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
            opt_lib.tree_unflatten(params, grads))


def adamw_config(cfg: ExtractorTrainConfig) -> opt_lib.AdamWConfig:
    return opt_lib.AdamWConfig(lr=cfg.lr, warmup_steps=40,
                               total_steps=cfg.steps, weight_decay=0.01,
                               clip_norm=10.0, b2=0.99)


def make_train_step(cfg: ExtractorTrainConfig):
    """One optimisation step: (params, opt_state, tiles, messages,
    attack_idx, key) -> (params, opt_state, parts).  ``key`` is unused,
    as in the reference.  ``step.loss_fn`` is the loss it
    differentiates."""
    opt_cfg = adamw_config(cfg)
    loss_fn = make_loss_fn(cfg)

    def step(params, opt_state, tiles, messages, attack_idx, key=None):
        (loss, parts), grads = value_and_grad(loss_fn, params, tiles,
                                              messages, attack_idx)
        params, opt_state, m = opt_lib.adamw_update(opt_cfg, params, grads,
                                                    opt_state)
        parts["loss"] = loss
        parts["grad_norm"] = m["grad_norm"]
        return params, opt_state, parts

    step.loss_fn = loss_fn
    return step


def batch_tiles(cfg: ExtractorTrainConfig, step_idx: int,
                key: torch.Tensor) -> torch.Tensor:
    """Host-side batch prep: images -> normalized tiles on the host (the
    key's device)."""
    imgs = np.stack([synth_image(step_idx * cfg.batch + i, cfg.img_size,
                                 cfg.seed) for i in range(cfg.batch)])
    x = torch.as_tensor(imgs).to(torch.float32) / 127.5 - 1.0  # [-1, 1]
    tiles_, _ = tiling.select_tiles(cfg.strategy, key, x, cfg.tile)
    return tiles_


def init_train_params(cfg: ExtractorTrainConfig, device="cpu") -> dict:
    """{"enc", "dec"} drawn from a ``torch.Generator`` seeded with
    ``cfg.seed`` (the reference draws from its JAX key), the extractor's
    correlation bank tied to the encoder's patterns (warm start)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    n_bits = cfg.code.codeword_bits
    enc = init_encoder(gen, n_bits=n_bits, channels=cfg.enc_channels,
                       depth=cfg.enc_depth, tile=cfg.tile, device=device)
    dec = init_extractor(gen, n_bits=n_bits, channels=cfg.channels,
                         depth=cfg.depth, tile=cfg.tile,
                         patterns=enc["patterns"], device=device)
    return {"enc": enc, "dec": dec}


def train(cfg: ExtractorTrainConfig, *, log_every: int = 50,
          init_params: Optional[dict] = None, verbose: bool = True,
          device=None) -> dict:
    """``cfg.steps`` steps on ``device`` (None: the card, raising if
    there is none).  ``init_params``: {"enc", "dec"} as numpy arrays or
    tensors (the reference's weights carried across), else drawn by
    :func:`init_train_params`."""
    dev = resolve_device(device)
    check_fp32(dev)
    key = prng.key(cfg.seed)
    n_bits = cfg.code.codeword_bits
    _, _, key = prng.split(key, 3)
    params = (init_train_params(cfg, dev) if init_params is None
              else params_from_numpy(init_params, dev))
    opt_state = opt_lib.init_opt_state(params)
    step = make_train_step(cfg)
    history = []
    t0 = time.time()
    for i in range(cfg.steps):
        key, kt, km, ka, ks = prng.split(key, 5)
        tiles_ = batch_tiles(cfg, i, kt).to(dev)
        messages = prng.randint(km, (cfg.batch, n_bits), 0, 2).to(dev)
        if i < cfg.curriculum_frac * cfg.steps:
            attack_idx = torch.zeros((cfg.batch,), dtype=torch.int32)
        else:
            attack_idx = prng.randint(ka, (cfg.batch,), 0,
                                      len(cfg.train_attacks))
        params, opt_state, parts = step(params, opt_state, tiles_, messages,
                                        attack_idx.to(dev), ks)
        if i % log_every == 0 or i == cfg.steps - 1:
            rec = {k: float(v) for k, v in parts.items()}
            rec["step"] = i
            rec["wall_s"] = time.time() - t0
            history.append(rec)
            if verbose:
                print(f"step {i:4d} loss={rec['loss']:.4f} "
                      f"bit_acc={rec['bit_acc']:.3f} "
                      f"L_RS={rec['L_RS']:.4f} ({rec['wall_s']:.0f}s)",
                      flush=True)
    return {"params": params, "history": history, "config": cfg,
            "opt_state": opt_state}


# ---------------------------------------------------------------------------
# evaluation: embed -> (attack) -> extract -> RS decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def evaluate(params, cfg: ExtractorTrainConfig, *, n_images: int = 128,
             attacks: Tuple[str, ...] = ("none",),
             tile: Optional[int] = None, strategy: Optional[str] = None,
             use_rs: bool = True, message_bits: Optional[np.ndarray] = None,
             seed: int = 1234, device=None
             ) -> Dict[str, Dict[str, float]]:
    """Returns {attack: {bit_acc, word_acc_raw, psnr, rs_word_acc,
    rs_bit_acc}}.  Decodes through ``ops.fused_extractor`` (flat, fp32)
    and ``ops.rs_decode``: the CUDA kernels on a card (``device`` None:
    the card, raising if there is none), their plain versions on the
    CPU."""
    dev = resolve_device(device)
    check_fp32(dev)
    params = params_from_numpy(params, dev)
    tile = tile or cfg.tile
    strategy = strategy or cfg.strategy
    code = cfg.code
    n_bits = code.codeword_bits
    key = prng.key(seed)
    if message_bits is None:
        rng = np.random.default_rng(seed)
        message_bits = rng.integers(0, 2, code.message_bits)
    # the embedded payload is the RS-encoded signature m_s (paper §4.2)
    codeword = torch.as_tensor(np.asarray(rs_encode(
        code, np.asarray(message_bits))).astype(np.int32), device=dev)
    msg = codeword.expand(n_images, n_bits)
    packed = pack_params(params["dec"], "fp32")

    imgs = np.stack([synth_image(10_000_000 + i, cfg.img_size, seed)
                     for i in range(n_images)])
    x = torch.as_tensor(imgs, device=dev).to(torch.float32) / 127.5 - 1.0

    # embed into EVERY grid tile so any sampled tile carries the watermark
    gy = cfg.img_size // tile
    all_tiles = tiling.grid_partition(x, tile)  # (b, g, l, l, 3)
    b, g = all_tiles.shape[:2]
    flat = all_tiles.reshape(b * g, tile, tile, 3)
    msg_rep = torch.repeat_interleave(msg, g, dim=0)
    xw_flat, _ = encoder_forward(params["enc"], flat, msg_rep,
                                 alpha=cfg.alpha)
    xw = xw_flat.reshape(b, gy, gy, tile, tile, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(b, gy * tile, gy * tile, 3)
    # PSNR over the watermarked region
    mse = torch.mean(torch.square(
        xw - x[:, : gy * tile, : gy * tile])) + 1e-12
    psnr = float(10 * torch.log10(4.0 / mse))  # range [-1,1] -> peak 2

    out = {}
    for attack in attacks:
        xa = transforms.ATTACKS[attack](xw)
        key, kt = prng.split(key)
        tiles_, _ = tiling.select_tiles(strategy, kt, xa, tile)
        logits = ops.fused_extractor(tiles_.contiguous(), packed)
        bits = (logits > 0).to(torch.int32)
        rec = {"bit_acc": float(losses.bit_accuracy(logits, msg)),
               "word_acc_raw": float(losses.word_accuracy(bits, msg)),
               "psnr": psnr}
        if use_rs:
            dec = ops.rs_decode(bits, code=code)
            ok = dec["ok"].cpu().numpy().astype(bool)
            m_out = dec["message_bits"].cpu().numpy()
            gt = np.asarray(message_bits)
            match = ok & np.all(m_out == gt[None, :], axis=1)
            rec["rs_word_acc"] = float(match.mean())
            rec["rs_bit_acc"] = float((m_out == gt[None, :]).mean())
        out[attack] = rec
    return out
