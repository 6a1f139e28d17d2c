"""PyTorch port: the RS(15,12) GF(16) decode against the JAX package.

The port's plain batched decoder must give exactly the JAX Pallas
kernel's ``message_bits``, ``codeword_bits``, ``ok`` and ``n_corrected``
on random words and on codewords with 0, 1 and 2 symbol errors
(degenerate words included), and the scalar numpy codec copies must
behave like the originals.

The CUDA kernel (``csrc/rs_decode.cu``) decodes by syndromes, not by
Berlekamp-Welch; it runs only on the card, where ``test_torch_cuda.py``
holds it to the plain version.  Here a numpy model of its arithmetic
(lane for lane: its GF(16) LOG/EXP immediates, read from the source,
the per-lane syndrome shares and their XOR reduction, the S1 S3 = S2^2
test, the output bit packing) is held exactly to JAX's Pallas kernel
and to the plain version on every single-symbol pattern of several
codewords, on words with 2, 3 and 4 symbol errors and on the words
above.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rs import codec as jcodec
from repro.kernels import ops as jops
from repro_torch.core.rs import codec
from repro_torch.core.rs import gf
from repro_torch.kernels import ops
from repro_torch.kernels import rs_decode as rs

torch.set_num_threads(1)

CODE = codec.DEFAULT_CODE
FIELDS = ["message_bits", "codeword_bits", "ok", "n_corrected"]


def _words(seed: int = 0) -> np.ndarray:
    """(160, 60) int32: 64 random words, 24 codewords each with 0, 1 and
    2 symbol errors, and degenerate words (all 0, all 1, alternating,
    single bits)."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 2, (64, 60))]
    for n_err in (0, 1, 2):
        for _ in range(24):
            cw = codec.rs_encode(CODE, rng.integers(0, 2, 48)).copy()
            for sym in rng.choice(15, n_err, replace=False):
                flip = rng.integers(1, 16)
                for j in range(4):
                    cw[sym * 4 + j] ^= (flip >> (3 - j)) & 1
            rows.append(cw[None])
    degenerate = [np.zeros(60), np.ones(60), np.arange(60) % 2,
                  (np.arange(60) // 4) % 2]
    for i in (0, 7, 59):
        e = np.zeros(60)
        e[i] = 1
        degenerate.append(e)
    rows.append(np.stack(degenerate))
    return np.concatenate(rows).astype(np.int32)


@pytest.fixture(scope="module")
def words_and_ref():
    words = _words()
    out = jax.jit(jops.rs_decode)(jnp.asarray(words))
    return words, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("field", FIELDS)
def test_plain_equals_jax_kernel(words_and_ref, field):
    words, ref = words_and_ref
    got = ops.rs_decode(torch.as_tensor(words))
    assert got[field].dtype == (torch.bool if field == "ok"
                                else torch.int32)
    np.testing.assert_array_equal(got[field].numpy(), ref[field])


def test_outcomes_cover_success_and_failure(words_and_ref):
    _, ref = words_and_ref
    assert set(np.unique(ref["n_corrected"])) >= {-1, 0, 1}


def test_plain_equals_scalar_codec(words_and_ref):
    """Within the t=1 radius the decode is unique, so the scalar
    Berlekamp-Welch codec agrees on ok and n_corrected for every word,
    and on the message wherever decoding succeeded (on failure the
    batched decoders return the received word, the scalar codec its
    interpolated guess)."""
    words, _ = words_and_ref
    got = ops.rs_decode(torch.as_tensor(words))
    for i, w in enumerate(words):
        res = codec.rs_decode(CODE, w)
        assert bool(got["ok"][i]) == res.ok
        assert int(got["n_corrected"][i]) == res.n_corrected
        want = res.message_bits if res.ok else w[:48]
        np.testing.assert_array_equal(got["message_bits"][i].numpy(), want)


def test_codec_copy_matches_reference():
    rng = np.random.default_rng(5)
    for _ in range(8):
        msg = rng.integers(0, 2, 48)
        np.testing.assert_array_equal(codec.rs_encode(CODE, msg),
                                      jcodec.rs_encode(jcodec.DEFAULT_CODE,
                                                       msg))
        word = rng.integers(0, 2, 60)
        a, b = codec.rs_decode(CODE, word), jcodec.rs_decode(
            jcodec.DEFAULT_CODE, word)
        assert (a.ok, a.n_corrected) == (b.ok, b.n_corrected)
        np.testing.assert_array_equal(a.message_bits, b.message_bits)
    np.testing.assert_array_equal(CODE.eval_points,
                                  jcodec.DEFAULT_CODE.eval_points)


def test_row_independent_of_batch(words_and_ref):
    words, ref = words_and_ref
    one = ops.rs_decode(torch.as_tensor(words[70:71]))
    np.testing.assert_array_equal(one["message_bits"].numpy(),
                                  ref["message_bits"][70:71])


def test_other_code_raises():
    """(Named when other codes raised.)  ``ops.rs_decode`` at the
    (4, 15, 11) code equals the reference's ``jax_rs`` on all four
    outputs."""
    from repro.core.rs import jax_rs
    code = codec.RSCode(m=4, n=15, k=11)
    words = np.random.default_rng(11).integers(0, 2, (24, 60)).astype(
        np.int32)
    words[:8] = np.stack([codec.rs_encode(code, m) for m in np.random.
                          default_rng(12).integers(0, 2, (8, 44))])
    words[4:8, 3] ^= 1
    got = ops.rs_decode(torch.as_tensor(words), code=code)
    want = jax_rs.make_batch_decoder(jcodec.RSCode(m=4, n=15, k=11))(
        jnp.asarray(words))
    assert np.asarray(want["ok"])[:8].all()
    for k in ("message_bits", "codeword_bits", "ok", "n_corrected"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -- a numpy model of the CUDA kernel's arithmetic ---------------------------
def _kernel_constants() -> dict:
    """The kernel's 64-bit GF(16) EXP and LOG immediates, read from its
    source so that the model runs on the kernel's own constants."""
    src = (Path(rs.__file__).parent / "csrc" / "rs_decode.cu").read_text()
    found = dict(re.findall(
        r"constexpr unsigned long long (EXP|LOG) = (0x[0-9a-f]+)ull;", src))
    assert sorted(found) == ["EXP", "LOG"], found
    return {k: int(v, 16) for k, v in found.items()}


def _nibble(table: int, idx: np.ndarray) -> np.ndarray:
    """``(table >> 4 idx) & 15`` elementwise, as the kernel reads a field."""
    return (np.uint64(table) >> (idx.astype(np.uint64) * np.uint64(4))
            ).astype(np.int64) & 15


def _mod15(e: np.ndarray) -> np.ndarray:
    return np.where(e >= 15, e - 15, e)


def _lane_syndromes(bits: np.ndarray, EXP: int, LOG: int):
    """Per lane (B, 32): the kernel's two loaded bits, and its share of
    S1 | S2 << 4 | S3 << 8 (the lane's 2-bit part of symbol l // 2 times
    alpha^(s (l // 2)))."""
    B = bits.shape[0]
    lane = np.arange(32)
    b = np.zeros((B, 32, 2), np.int64)
    b[:, :30] = bits.reshape(B, 30, 2) & 1
    sym, sh = lane >> 1, np.where(lane & 1, 0, 2)
    part = ((b[..., 0] << 1) | b[..., 1]) << sh
    e1 = _mod15(_nibble(LOG, part) + sym)
    e2 = _mod15(e1 + sym)
    e3 = _mod15(e2 + sym)
    share = np.where(part != 0, _nibble(EXP, e1) | _nibble(EXP, e2) << 4 |
                     _nibble(EXP, e3) << 8, 0)
    return b, share


def _kernel_model(bits: np.ndarray) -> dict:
    """What ``rs_syndrome_decode_kernel`` computes, lane for lane."""
    c = _kernel_constants()
    EXP, LOG = c["EXP"], c["LOG"]
    B = bits.shape[0]
    lane = np.arange(32)
    sym, sh = lane >> 1, np.where(lane & 1, 0, 2)
    b, share = _lane_syndromes(bits, EXP, LOG)
    synd = np.bitwise_xor.reduce(share, axis=1)[:, None]  # every lane
    s1, s2, s3 = synd & 15, (synd >> 4) & 15, synd >> 8
    l1, l2, l3 = (_nibble(LOG, s) for s in (s1, s2, s3))
    zero = synd == 0
    one = (s1 != 0) & (s2 != 0) & (s3 != 0) & (
        _mod15(l1 + l3) == _mod15(2 * l2))
    pos = _mod15(l2 + 15 - l1)
    val = _nibble(EXP, _mod15(l1 + _mod15(l1 + 15 - l2)))
    flip = np.where(one & (sym == pos), (val >> sh) & 3, 0)
    b[..., 0] ^= flip >> 1
    b[..., 1] ^= flip & 1
    cw = b[:, :30].reshape(B, 60).astype(np.int32)
    return {"message_bits": cw[:, :48], "codeword_bits": cw,
            "ok": (zero | one)[:, 0],
            "n_corrected": np.where(zero, 0, np.where(one, 1, -1))[
                :, 0].astype(np.int32)}


def _flip_symbol(word: np.ndarray, pos: int, value: int) -> np.ndarray:
    out = word.copy()
    out[4 * pos:4 * pos + 4] ^= (value >> np.arange(3, -1, -1)) & 1
    return out


def _codewords(rng, n: int) -> np.ndarray:
    """(n, 60) random codewords: the code is linear over GF(2) bit by
    bit, so a message's codeword is the XOR of the unit messages'."""
    gen = np.stack([codec.rs_encode(CODE, e) for e in np.eye(48, dtype=int)])
    return rng.integers(0, 2, (n, 48)) @ gen % 2


def _syndrome_words(seed: int = 1) -> np.ndarray:
    """(2543, 60) int32: every single-symbol pattern (15 positions x 16
    values, 0 included) on 5 random codewords, 400 codewords each with
    2, 3 and 4 symbol errors, and the words of :func:`_words`."""
    rng = np.random.default_rng(seed)
    rows = [_flip_symbol(cw, p, v) for cw in _codewords(rng, 5)
            for p in range(15) for v in range(16)]
    for n_err in (2, 3, 4):
        for w in _codewords(rng, 400):
            for p in rng.choice(15, n_err, replace=False):
                w = _flip_symbol(w, int(p), int(rng.integers(1, 16)))
            rows.append(w)
    return np.concatenate([np.stack(rows), _words(seed)]).astype(np.int32)


@pytest.fixture(scope="module")
def syndrome_case():
    words = _syndrome_words()
    # in chunks of the other fixture's batch, so JAX compiles one shape
    step = len(_words())
    pad = np.concatenate([words, np.zeros((-len(words) % step, 60),
                                          np.int32)])
    chunks = [jax.jit(jops.rs_decode)(jnp.asarray(pad[i:i + step]))
              for i in range(0, len(pad), step)]
    plain = rs.rs_decode_plain(torch.as_tensor(words))
    return words, _kernel_model(words), {
        "jax": {k: np.concatenate([np.asarray(c[k]) for c in chunks])[
            :len(words)] for k in FIELDS},
        "plain": {k: v.numpy() for k, v in plain.items()}}


@pytest.mark.parametrize("ref", ["jax", "plain"])
@pytest.mark.parametrize("field", FIELDS)
def test_kernel_model_equals_references(syndrome_case, field, ref):
    words, got, refs = syndrome_case
    want = refs[ref][field]
    assert got[field].shape == want.shape
    np.testing.assert_array_equal(got[field], want)


def test_kernel_model_set_covers_every_outcome(syndrome_case):
    words, got, _ = syndrome_case
    # every single-symbol pattern decodes, with 0 or 1 correction
    singles = got["n_corrected"][:5 * 15 * 16]
    assert (singles >= 0).all() and (singles == 0).sum() == 5 * 15
    # no 2-symbol error is within the t = 1 radius of any codeword; some
    # 3- and 4-symbol errors are, and decode to another codeword
    assert (got["n_corrected"][1200:1600] == -1).all()
    assert (got["n_corrected"][1600:2400] == 1).any()


def test_kernel_constants_are_the_field():
    """EXP's nibble e is alpha^e (e = 0..14, and 1 at e = 15), LOG's
    nibble a is log_alpha(a) (a = 1..15), alpha^i = 1, 2, 4, 8, 3, ...
    as the code's evaluation points."""
    c = _kernel_constants()
    exp, log = gf.tables(4)
    assert [(c["EXP"] >> 4 * e) & 15 for e in range(16)] == \
        list(exp[:15]) + [1]
    assert [(c["LOG"] >> 4 * a) & 15 for a in range(1, 16)] == \
        list(log[1:16])
    np.testing.assert_array_equal(CODE.eval_points, exp[:15])


def test_lane_shares_sum_to_the_bit_sliced_syndromes(syndrome_case):
    """The lanes' XOR-reduced shares are the syndromes written bit by
    bit: bit k = 4i + j (j = 0 the symbol's MSB) adds
    H_s[k] = alpha^((i s + 3 - j) mod 15) to S_s, s = 1, 2, 3."""
    words = syndrome_case[0]
    exp, _ = gf.tables(4)
    k = np.arange(60)
    i, j = k // 4, k % 4
    H = sum(exp[(i * s + 3 - j) % 15].astype(np.int64) << 4 * (s - 1)
            for s in (1, 2, 3))
    want = np.bitwise_xor.reduce(np.where(words != 0, H, 0), axis=1)
    c = _kernel_constants()
    _, share = _lane_syndromes(words, c["EXP"], c["LOG"])
    np.testing.assert_array_equal(np.bitwise_xor.reduce(share, axis=1),
                                  want)


# -- integer bits outside {0, 1} ---------------------------------------------
def _out_of_domain_words(seed: int = 2) -> np.ndarray:
    """(143, 60) int32 words with entries outside {0, 1}, as many rows as
    :func:`_words` (JAX compiles one shape): codewords and single-error
    words with one to four entries set to 2, -1, 3, -2 or 5; random words
    over [-2, 3]; words with entries at and near the int32 limits (whose
    symbol sums and GF(16) shifts wrap in the reference's int32
    arithmetic: -2^31 times a symbol weight of 2, 4 or 8 is 0 there); and
    {0, 1} words beside them."""
    rng = np.random.default_rng(seed)
    rows = []
    for cw in _codewords(rng, 64):
        w = cw.astype(np.int64)
        if len(rows) % 2:
            w = _flip_symbol(w, int(rng.integers(15)), int(rng.integers(16)))
        for i in rng.choice(60, int(rng.integers(1, 5)), replace=False):
            w[i] = rng.choice([2, -1, 3, -2, 5])
        rows.append(w)
    rows += list(rng.integers(-2, 4, (32, 60)))
    big = [2 ** 30, 2 ** 29, -2 ** 31, 2 ** 31 - 1, -2 ** 30 - 7]
    for i in range(32):
        w = rng.integers(0, 2, 60) if i % 2 else np.zeros(60, np.int64)
        w[(7 * i) % 60] = -2 ** 31
        w[(11 * i + 3) % 60] = big[i % 5]
        rows.append(w)
    rows += list(_codewords(rng, 15))
    return np.stack(rows).astype(np.int32)


@pytest.fixture(scope="module")
def out_of_domain_case():
    words = _out_of_domain_words()
    assert words.shape == _words().shape
    out = jax.jit(jops.rs_decode)(jnp.asarray(words))
    return words, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("field", FIELDS)
def test_plain_equals_jax_kernel_outside_01(out_of_domain_case, field):
    """Entries of 2, -1 and others, down to the int32 limits: the plain
    version computes the reference's int32 arithmetic (its symbol sums
    and carry-less products wrap at 32 bits), so every output agrees."""
    words, ref = out_of_domain_case
    got = rs.rs_decode_plain(torch.as_tensor(words))
    np.testing.assert_array_equal(got[field].numpy(), ref[field])


@pytest.mark.parametrize("dtype", [torch.int64, torch.int16, torch.bool])
def test_plain_casts_bits_as_the_reference(out_of_domain_case, dtype):
    """Any integer (or bool) bits are cast to int32 first, as the
    reference's ``astype(jnp.int32)``: int64 words that wrap to the
    int32 words decode as those; bool words as their 0/1 values."""
    words, ref = out_of_domain_case
    if dtype == torch.bool:
        src = torch.as_tensor(words != 0)
        want = rs.rs_decode_plain(src.to(torch.int32))
    elif dtype == torch.int16:
        small = np.clip(words, -3, 5)
        src = torch.as_tensor(small).to(dtype)
        want = rs.rs_decode_plain(torch.as_tensor(small))
    else:
        src = torch.as_tensor(words.astype(np.int64) + (1 << 32) *
                              np.sign(words.astype(np.int64)))
        want = {k: torch.as_tensor(v.copy()) for k, v in ref.items()}
    got = ops.rs_decode(src)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
