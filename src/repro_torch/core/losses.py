"""QRMark training losses (§4.1; counterpart of ``repro.core.losses``).

L = L_m + lambda * L_RS, where L_m is the standard BCE message loss and
L_RS = [max(0, E - t)]^2 penalises only bit errors beyond the
Reed-Solomon correction capacity (errors the code can fix are free).
E is counted over the first k symbols' bits with a soft surrogate so
the hinge is differentiable.

Maxima are ``torch.maximum`` against a tensor, whose gradient splits a
tie in half as ``jnp.maximum``'s does (``torch.clamp`` would pass all of
it), and |x| has JAX's slope of 1 at 0.
"""
from __future__ import annotations

import torch


def message_loss(logits: torch.Tensor, messages: torch.Tensor
                 ) -> torch.Tensor:
    """BCE with logits.  logits / messages: (b, n_bits)."""
    m = messages.to(torch.float32)
    # |x| as JAX differentiates it: slope 1 at 0 (torch.abs: 0)
    mag = torch.where(logits >= 0, logits, -logits)
    return torch.mean(
        torch.maximum(logits, torch.zeros_like(logits)) - logits * m
        + torch.log1p(torch.exp(-mag)))


def rs_aware_loss(logits: torch.Tensor, messages: torch.Tensor, *,
                  t_symbols: float, symbol_bits: int,
                  k_symbols: int = None, temp: float = 1.0
                  ) -> torch.Tensor:
    """[max(0, E - t)]^2 with a soft SYMBOL error count: a symbol is
    wrong if any of its bits is, soft_sym_err = 1 - prod(1 - p_bit_err);
    E sums over the first k symbols."""
    m_pm = 2.0 * messages.to(torch.float32) - 1.0
    margin = logits * m_pm  # > 0 means correct
    p_err = torch.sigmoid(-margin / temp)  # (b, n_bits)
    b = p_err.shape[0]
    sym = p_err.reshape(b, -1, symbol_bits)
    if k_symbols is not None:
        sym = sym[:, :k_symbols]
    sym_err = 1.0 - torch.prod(1.0 - sym, dim=-1)  # (b, n_sym)
    E = sym_err.sum(dim=-1)
    hinge = torch.maximum(E - t_symbols, torch.zeros_like(E))
    return torch.mean(torch.square(hinge))


def qrmark_loss(logits: torch.Tensor, messages: torch.Tensor, *, code,
                lam: float = 1.0):
    lm = message_loss(logits, messages)
    lrs = rs_aware_loss(logits, messages, t_symbols=float(code.t),
                        symbol_bits=code.m, k_symbols=code.k)
    return lm + lam * lrs, {"L_m": lm, "L_RS": lrs}


def bit_accuracy(logits: torch.Tensor, messages: torch.Tensor
                 ) -> torch.Tensor:
    pred = (logits > 0).to(torch.int32)
    return torch.mean((pred == messages.to(torch.int32)).to(torch.float32))


def word_accuracy(bits_pred: torch.Tensor, messages: torch.Tensor
                  ) -> torch.Tensor:
    eq = torch.all(bits_pred.to(torch.int32) == messages.to(torch.int32),
                   dim=-1)
    return torch.mean(eq.to(torch.float32))
