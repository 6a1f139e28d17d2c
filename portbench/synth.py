"""Weights and traffic made from the run's seed.

Everything is drawn by one ``torch.Generator`` on the run's device, in a
few large calls: the extractor's weights (the detector's structure and
initial scales, the head scaled by the configuration's ``head_scale``),
and a ring of raw uint8 batches.  Each raw image is procedural content
(per-channel sinusoids, soft rectangles, pixel noise, as the detector's
own synthetic images are made), and a marked image carries a watermark:
the correlation bank's patterns signed by the RS codeword of a random
48-bit message, scaled to an RMS of ``wm_rms`` raw units and added to
every tile cell of the centre crop.  A batch holds exactly
``round(marked_share * batch)`` marked images, at places drawn from the
seed, and ``round(attacked_share * marked)`` of those carry the mix's
``attack`` on top of their watermark, so every batch of every seed asks
for the same work.

The attack ``splice`` replaces the bottom quarter of an attacked image's
centre crop with the same rows of fresh, unmarked content (a caption bar
or a pasted strip, as uploads are edited).  It erases the watermark from
the bottom row of tile cells and leaves the other twelve whole: the
localized damage that escalation's later tiles recover.  A spliced tile
decodes to a random word, as an unmarked image does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import rs


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def make_params(gen: torch.Generator, cfg: dict) -> dict:
    """The extractor's weights (float32, on the generator's device)."""
    ex = cfg["extractor"]
    c, d, nb, tile = ex["channels"], ex["depth"], ex["n_bits"], cfg["tile"]
    shapes = [(3, 3, 3, c)] + [(3, 3, c, c)] * (d - 1) + [(3, 3, c, nb),
                                                          (nb, nb)]
    sizes = [math.prod(s) for s in shapes]
    n_bias = d * c + 2 * nb
    flat = torch.randn(sum(sizes) + n_bias + nb * tile * tile * 3,
                       generator=gen, device=gen.device)
    parts = list(torch.split(flat, sizes + [n_bias, nb * tile * tile * 3]))
    ws = [p.reshape(s) for p, s in zip(parts, shapes)]
    biases = parts[-2] * ex["bias_scale"]
    blocks, cin = [], 3
    for i in range(d):
        blocks.append({"w": ws[i] * (2.0 / (9 * cin)) ** 0.5,
                       "b": biases[i * c:(i + 1) * c].clone()})
        cin = c
    bank = parts[-1].reshape(nb, tile, tile, 3)
    bank = bank - bank.mean(dim=(1, 2, 3), keepdim=True)
    bank = bank / bank.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()
    return {
        "blocks": blocks,
        "to_bits": {"w": ws[d] * (2.0 / (9 * c)) ** 0.5,
                    "b": biases[d * c:d * c + nb].clone()},
        "head": {"w": ws[d + 1] * (0.2 * ex["head_scale"]),
                 "b": biases[d * c + nb:].clone()},
        "corr": bank.contiguous(),
        "corr_scale": torch.ones(nb, device=gen.device),
    }


def _content(gen: torch.Generator, b: int, size: int, mix: dict
             ) -> torch.Tensor:
    """(b, size, size, 3) float32 raw content in 0..255."""
    dev = gen.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def integers(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    ax = torch.linspace(0.0, 1.0, size, device=dev)
    yy, xx = ax[:, None, None], ax[None, :, None]
    a, f, ph = (uniform((b, 1, 1, 3), 1.0, 6.0) for _ in range(3))
    img = 0.5 + 0.25 * torch.sin(2 * math.pi * (a * yy + f * xx) + ph)
    pos = torch.arange(size, device=dev)
    for _ in range(mix["rectangles"]):
        y0, x0 = (integers((b, 1, 1), 0, size - 8) for _ in range(2))
        h, w = (integers((b, 1, 1), 8, size // 2) for _ in range(2))
        col = uniform((b, 1, 1, 3), 0.0, 1.0)
        alpha = uniform((b, 1, 1, 1), 0.2, 0.7)
        inside = ((pos[:, None] >= y0) & (pos[:, None] < y0 + h)
                  & (pos[None, :] >= x0) & (pos[None, :] < x0 + w))
        img = torch.where(inside[..., None], (1 - alpha) * img + alpha * col,
                          img)
    noise = torch.randn(img.shape, generator=gen, device=dev)
    return ((img + mix["noise"] * noise) * 255.0).clamp(0.0, 255.0)


def splice(gen: torch.Generator, crop: torch.Tensor, mix: dict
           ) -> torch.Tensor:
    """(n, h, w, 3) raw float crops with their bottom quarter replaced by
    fresh content drawn from ``gen``."""
    n, h, w, _ = crop.shape
    fresh = _content(gen, n, h, mix)
    out = crop.clone()
    out[:, h * 3 // 4:] = fresh[:, h * 3 // 4:, :w]
    return out


ATTACKS = {"splice": splice}


def make_batch(gen: torch.Generator, cfg: dict, mix: dict, bank: torch.Tensor
               ) -> tuple:
    """One raw batch, (batch, raw, raw, 3) uint8 on the host, with the
    rows that carry a watermark, their 48-bit messages and the rows under
    the attack (numpy)."""
    b, size, tile, img = mix["batch"], mix["raw_size"], cfg["tile"], \
        cfg["img_size"]
    dev = gen.device
    x = _content(gen, b, size, mix)
    n_marked = round(mix["marked_share"] * b)
    marked = torch.randperm(b, generator=gen, device=dev)[:n_marked]
    msgs = torch.randint(0, 2, (n_marked, 48), generator=gen,
                         device=dev).cpu().numpy()
    if n_marked:
        cw = rs.encode(msgs)
        signs = torch.as_tensor(2.0 * cw - 1.0, dtype=torch.float32,
                                device=dev)
        wm = (signs @ bank.reshape(bank.shape[0], -1)).reshape(
            n_marked, tile, tile, 3)
        wm = wm * (mix["wm_rms"] / wm.square().mean(dim=(1, 2, 3),
                                                    keepdim=True).sqrt())
        o = (size - img) // 2
        cells = x[marked, o:o + img, o:o + img].reshape(
            n_marked, img // tile, tile, img // tile, tile, 3)
        cells = cells + wm[:, None, :, None]
        x[marked, o:o + img, o:o + img] = cells.reshape(n_marked, img, img, 3)
    attacked = marked[:round(mix.get("attacked_share", 0.0) * n_marked)]
    if len(attacked):
        x[attacked, o:o + img, o:o + img] = ATTACKS[mix["attack"]](
            gen, x[attacked, o:o + img, o:o + img], mix)
    raw = torch.round(x).clamp(0, 255).to(torch.uint8).cpu().numpy()
    return raw, marked.cpu().numpy(), msgs, attacked.cpu().numpy()


def make_ring(gen: torch.Generator, cfg: dict, mix: dict, bank: torch.Tensor
              ) -> list:
    """The ring of ``mix["ring"]`` raw batches a run cycles through."""
    return [make_batch(gen, cfg, mix, bank)[0] for _ in range(mix["ring"])]
