"""Tile-based LDM decoder fine-tuning (QRMark §4.2, Stable-Signature
recipe at container scale; counterpart of ``repro.core.ldm``).

A small conv autoencoder stands in for the LDM VAE (f = 4 downsampling,
c-channel latents).  :func:`finetune_decoder` fine-tunes a copy D_m of
the decoder so that every reconstructed image carries the RS-encoded
signature m_s, recoverable by the FROZEN tile extractor H_D from a
randomly sampled grid tile:

    z = E(x);  x' = D_m(z);  tile -> H_D -> BCE(m', m_s)
    + lambda_i * perceptual(x', D(z))      [frozen original decoder]

The perceptual loss is an L2 in the frozen extractor's early conv
feature space plus a pixel L2, as in the reference.  Plain PyTorch ops
under autograd (the reference differentiates its plain XLA graph): the
convs as tap matmuls (``extractor.conv2d``), ``_down2`` a 2x2 mean,
``_up2`` nearest x2 (each pixel repeated, what ``jax.image.resize``'s
"nearest" gives at an exact factor of 2).  Keys are the port's threefry,
so the tile offsets are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import losses, prng, tiling
from repro_torch.core.detect import resolve_device
from repro_torch.core.extractor import (_block, conv2d, conv_init,
                                        extractor_forward,
                                        params_from_numpy)
from repro_torch.core.rs.codec import DEFAULT_CODE, rs_encode
from repro_torch.core.train_extractor import check_fp32, value_and_grad
from repro_torch.data.pipeline import synth_image
from repro_torch.train import optimizer as opt_lib


# ---------------------------------------------------------------------------
# tiny VAE-style autoencoder (f=4)
# ---------------------------------------------------------------------------


def init_autoencoder(gen: torch.Generator, *, ch: int = 32, latent: int = 8,
                     device="cpu") -> dict:
    z = lambda n: torch.zeros(n, device=device)
    return {
        "enc": {
            "c1": {"w": conv_init(gen, 3, 3, 3, ch, device=device),
                   "b": z(ch)},
            "c2": {"w": conv_init(gen, 3, 3, ch, ch, device=device),
                   "b": z(ch)},
            "to_z": {"w": conv_init(gen, 1, 1, ch, latent, device=device),
                     "b": z(latent)},
        },
        "dec": init_decoder(gen, ch=ch, latent=latent, device=device),
    }


def init_decoder(gen: torch.Generator, *, ch: int = 32, latent: int = 8,
                 device="cpu") -> dict:
    z = lambda n: torch.zeros(n, device=device)
    return {
        "from_z": {"w": conv_init(gen, 3, 3, latent, ch, device=device),
                   "b": z(ch)},
        "c1": {"w": conv_init(gen, 3, 3, ch, ch, device=device), "b": z(ch)},
        "c2": {"w": conv_init(gen, 3, 3, ch, ch, device=device), "b": z(ch)},
        "out": {"w": conv_init(gen, 3, 3, ch, 3, device=device), "b": z(3)},
    }


def init_autoencoder_numpy(seed: int, *, ch: int = 32, latent: int = 8
                           ) -> dict:
    """:func:`init_autoencoder`'s structure and scales drawn by numpy
    from ``seed``: weights both packages take."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, cin, cout):
        scale = (2.0 / (kh * kw * cin)) ** 0.5
        return {"w": (scale * rng.standard_normal((kh, kw, cin, cout))
                      ).astype(np.float32),
                "b": np.zeros((cout,), np.float32)}

    return {"enc": {"c1": conv(3, 3, 3, ch), "c2": conv(3, 3, ch, ch),
                    "to_z": conv(1, 1, ch, latent)},
            "dec": {"from_z": conv(3, 3, latent, ch),
                    "c1": conv(3, 3, ch, ch), "c2": conv(3, 3, ch, ch),
                    "out": conv(3, 3, ch, 3)}}


def _down2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling, stride 2 (the reference's reduce_window sum,
    divided by 4)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4.0


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour upsampling by 2: each pixel repeated 2x2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    e = params["enc"]
    h = _down2(_block(e["c1"], x))
    h = _down2(_block(e["c2"], h))
    return conv2d(h, e["to_z"]["w"]) + e["to_z"]["b"]


def decode(dec: dict, z: torch.Tensor) -> torch.Tensor:
    h = _block(dec["from_z"], z)
    h = _block(dec["c1"], _up2(h))
    h = _block(dec["c2"], _up2(h))
    return torch.tanh(conv2d(h, dec["out"]["w"]) + dec["out"]["b"])


def _images(idx0: int, n: int, size: int, device) -> torch.Tensor:
    imgs = np.stack([synth_image(idx0 + j, size) for j in range(n)])
    return torch.as_tensor(imgs, device=device).to(torch.float32) / 127.5 \
        - 1.0


# ---------------------------------------------------------------------------
# stage 0: pretrain the autoencoder (reconstruction)
# ---------------------------------------------------------------------------


def pretrain_autoencoder(gen: Optional[torch.Generator] = None, *,
                         img_size=64, steps=150, batch=16, verbose=False,
                         params: Optional[dict] = None, device=None):
    """AdamW on the reconstruction L2, from ``params`` (numpy or
    tensors) or weights drawn from ``gen``; on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    check_fp32(dev)
    if params is None:
        params = init_autoencoder(
            gen if gen is not None else torch.Generator().manual_seed(0),
            device=dev)
    params = params_from_numpy(params, dev)
    opt_cfg = opt_lib.AdamWConfig(lr=2e-3, warmup_steps=20,
                                  total_steps=steps, weight_decay=0.0,
                                  clip_norm=10.0)
    opt = opt_lib.init_opt_state(params)

    def loss_fn(p, x):
        return torch.mean(torch.square(decode(p["dec"], encode(p, x)) - x)), {}

    for i in range(steps):
        x = _images(i * batch, batch, img_size, dev)
        (loss, _), g = value_and_grad(loss_fn, params, x)
        params, opt, _ = opt_lib.adamw_update(opt_cfg, params, g, opt)
        if verbose and i % 50 == 0:
            print(f"[ae] step {i} recon={float(loss):.4f}", flush=True)
    return params


# ---------------------------------------------------------------------------
# stage 1: fine-tune D_m against the frozen extractor (paper §4.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FinetuneResult:
    decoder: dict
    history: list
    signature: np.ndarray  # the RS-encoded codeword bits m_s


def extractor_features(hd_params: dict, x: torch.Tensor, n_blocks: int = 2
                       ) -> torch.Tensor:
    h = x
    for blk in hd_params["blocks"][:n_blocks]:
        h = _block(blk, h)
    return h


def make_finetune_loss(ae_params: dict, hd_params: dict, m_s: torch.Tensor,
                       *, tile: int, lam_i: float):
    """The fine-tune loss of the decoder copy ``dm`` on a batch ``x``
    under ``key``: (dm, x, key) -> (loss, {"L_m", "L_i", "bit_acc"}).
    The encoder, the original decoder and H_D stay frozen."""
    frozen_dec = ae_params["dec"]

    def loss_fn(dm, x, key):
        with torch.no_grad():
            z = encode(ae_params, x)  # frozen encoder
            x_o = decode(frozen_dec, z)
        x_w = decode(dm, z)
        tiles_, _ = tiling.select_tiles("random_grid", key, x_w, tile)
        logits = extractor_forward(hd_params, tiles_)
        msg = m_s.expand(x.shape[0], m_s.shape[0])
        l_m = losses.message_loss(logits, msg)
        # perceptual proxy: frozen-extractor feature L2 vs D(z)
        l_i = torch.mean(torch.square(
            extractor_features(hd_params, x_w)
            - extractor_features(hd_params, x_o)))
        l_i = l_i + torch.mean(torch.square(x_w - x_o))
        acc = losses.bit_accuracy(logits, msg)
        return l_m + lam_i * l_i, {"L_m": l_m, "L_i": l_i, "bit_acc": acc}

    return loss_fn


def finetune_decoder(ae_params, hd_params, *, code=DEFAULT_CODE,
                     message_bits: Optional[np.ndarray] = None,
                     tile: int = 16, img_size: int = 64, steps: int = 100,
                     batch: int = 4, lam_i: float = 2.0, lr: float = 1e-4,
                     seed: int = 0, verbose=False,
                     device=None) -> FinetuneResult:
    """AdamW for ``steps`` iterations (paper: 100 iters, batch 4, warmup
    20 to 1e-4 then decay), on ``device`` (None: the card)."""
    dev = resolve_device(device)
    check_fp32(dev)
    ae_params = params_from_numpy(ae_params, dev)
    hd_params = params_from_numpy(hd_params, dev)
    rng = np.random.default_rng(seed)
    if message_bits is None:
        message_bits = rng.integers(0, 2, code.message_bits)
    m_s = torch.as_tensor(np.asarray(rs_encode(code, message_bits)
                                     ).astype(np.int32), device=dev)
    dec_m = opt_lib.tree_map(torch.clone, ae_params["dec"])  # D_m init = D
    opt_cfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps,
                                  weight_decay=0.0, clip_norm=10.0,
                                  min_lr_frac=0.01)
    opt = opt_lib.init_opt_state(dec_m)
    loss_fn = make_finetune_loss(ae_params, hd_params, m_s, tile=tile,
                                 lam_i=lam_i)
    key = prng.key(seed)
    hist = []
    for i in range(steps):
        x = _images(5_000_000 + i * batch, batch, img_size, dev)
        key, k = prng.split(key)
        (loss, parts), g = value_and_grad(loss_fn, dec_m, x, k)
        dec_m, opt, _ = opt_lib.adamw_update(opt_cfg, dec_m, g, opt)
        if i % 20 == 0 or i == steps - 1:
            hist.append({"step": i, "loss": float(loss),
                         "L_m": float(parts["L_m"]),
                         "L_i": float(parts["L_i"]),
                         "bit_acc": float(parts["bit_acc"])})
            if verbose:
                print(f"[ft] step {i:3d} loss={float(loss):.4f} "
                      f"L_m={hist[-1]['L_m']:.4f} "
                      f"acc={hist[-1]['bit_acc']:.3f}", flush=True)
    return FinetuneResult(dec_m, hist, m_s.cpu().numpy())
