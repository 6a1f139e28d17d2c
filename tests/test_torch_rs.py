"""PyTorch port: the RS(15,12) GF(16) decode against the JAX package.

The port's plain batched decoder must give exactly the JAX Pallas
kernel's ``message_bits``, ``codeword_bits``, ``ok`` and ``n_corrected``
on random words and on codewords with 0, 1 and 2 symbol errors
(degenerate words included), and the scalar numpy codec copies must
behave like the originals.  (The CUDA kernel is held to the plain
version on the card in ``test_torch_cuda.py``.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rs import codec as jcodec
from repro.kernels import ops as jops
from repro_torch.core.rs import codec
from repro_torch.kernels import ops

torch.set_num_threads(1)

CODE = codec.DEFAULT_CODE


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


@pytest.mark.parametrize("field", ["message_bits", "codeword_bits", "ok",
                                   "n_corrected"])
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
    with pytest.raises(NotImplementedError, match="item 8"):
        ops.rs_decode(torch.zeros((1, 60), dtype=torch.int32),
                      code=codec.RSCode(m=4, n=15, k=11))
