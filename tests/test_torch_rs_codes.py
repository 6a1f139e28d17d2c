"""PyTorch port: the batched Reed-Solomon decoder and encoder for any code
(``core.rs.torch_rs``) against the JAX package's ``jax_rs``.

For each code of the reference's own RS tests, on clean codewords, words
with at most t symbol errors and words beyond capacity, as int32, int64
and bool bits, ``message_bits``, ``codeword_bits``, ``n_corrected`` and
``ok`` equal the reference's exactly, dtypes included; so do words with
entries outside {0, 1} (the symbols leave the field and index the
tables as JAX's gathers index them), and the systematic encoder.  The
routing: ``ops.rs_decode``, ``stages.make_device_rs`` and a pipeline
with ``rs_mode="device"`` send other codes to ``torch_rs`` and keep the
t = 1 kernel's plain version for the default code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rs import codec as jcodec
from repro.core.rs import jax_rs
from repro_torch.core import stages
from repro_torch.core.rs import codec, torch_rs
from repro_torch.kernels import ops
from repro_torch.kernels import rs_decode as rs

torch.set_num_threads(1)

CODES = [(4, 15, 12), (4, 15, 11), (8, 32, 24)]   # tests/test_rs.py
FIELDS = ("message_bits", "codeword_bits", "n_corrected", "ok")


def _words(mnk, rng, per=24):
    """Clean codewords, then 1..t+2 symbol errors, then uniform words."""
    m, n, k = mnk
    code = jcodec.RSCode(m=m, n=n, k=k)
    msgs = rng.integers(0, 2, (per, k * m))
    cw = np.stack([jcodec.rs_encode(code, x) for x in msgs])
    out = [cw]
    for n_err in range(1, code.t + 3):
        w = cw.copy()
        for row in w:
            for pos in rng.choice(n, n_err, replace=False):
                flip = int(rng.integers(1, 1 << m))
                row[pos * m:(pos + 1) * m] ^= (flip >> np.arange(m - 1, -1,
                                                                 -1)) & 1
        out.append(w)
    out.append(rng.integers(0, 2, (per, n * m)))
    return msgs, np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module", params=CODES, ids=lambda c: "-".join(map(
    str, c)))
def code_words(request):
    m, n, k = request.param
    msgs, words = _words(request.param, np.random.default_rng(m * n + k))
    jdec = jax_rs.make_batch_decoder(jcodec.RSCode(m=m, n=n, k=k))
    ref = {f: np.asarray(v) for f, v in jdec(jnp.asarray(words)).items()}
    return codec.RSCode(m=m, n=n, k=k), jdec, msgs, words, ref


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.bool])
def test_decoder_equals_jax_rs(code_words, dtype):
    code, _, _, words, ref = code_words
    got = torch_rs.make_batch_decoder(code)(torch.as_tensor(words).to(dtype))
    for f in FIELDS:
        assert got[f].numpy().dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f].numpy(), ref[f], err_msg=f)
    # the words cover every outcome: clean, corrected and failed rows
    assert set(np.unique(ref["n_corrected"])) >= {-1, 0, code.t}


def test_decoder_outside_01_equals_jax_rs(code_words):
    code, jdec, _, words, _ = code_words
    rng = np.random.default_rng(code.n)
    uniform = rng.integers(-2 ** 31, 2 ** 31, words.shape, dtype=np.int64)
    one_off = words.copy()
    one_off[np.arange(len(words)), rng.integers(0, words.shape[1],
                                                len(words))] = \
        rng.integers(-5, 7, len(words))
    for w in (uniform.astype(np.int32), one_off):
        got = torch_rs.make_batch_decoder(code)(torch.as_tensor(w))
        want = jdec(jnp.asarray(w))             # the fixture's shape
        for f in FIELDS:
            np.testing.assert_array_equal(got[f].numpy(),
                                          np.asarray(want[f]), err_msg=f)


def test_encoder_equals_jax_rs(code_words):
    code, _, msgs, _, _ = code_words
    jcode = jcodec.RSCode(m=code.m, n=code.n, k=code.k)
    got = torch_rs.make_encoder(code)(torch.as_tensor(msgs))
    want = np.asarray(jax_rs.make_encoder(jcode)(jnp.asarray(msgs)))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_routing(code_words):
    """Other codes decode through ``torch_rs`` behind every device-RS
    entry point; the default code keeps the kernel's plain version."""
    code, _, _, words, ref = code_words
    bits = torch.as_tensor(words)
    outs = [ops.rs_decode(bits, code=code), stages.make_device_rs(code)(bits)]
    assert rs.is_kernel_code(code) == ((code.m, code.n, code.k)
                                       == (4, 15, 12))
    if rs.is_kernel_code(code):
        outs.append(rs.rs_decode_plain(bits))
    for got in outs:
        for f in FIELDS:
            np.testing.assert_array_equal(got[f].numpy(), ref[f], err_msg=f)


def test_pipeline_with_another_code_runs():
    """A device-RS pipeline at (4, 15, 11): 44 message bits from 60
    logits, the RS outputs of ``torch_rs`` on its bits."""
    from repro_torch.core import extractor as ex
    from repro_torch.core.detect import DetectionConfig, DetectionPipeline
    code = codec.RSCode(m=4, n=15, k=11)
    p = ex.init_extractor_numpy(0, n_bits=60, channels=8, depth=2, tile=16)
    pipe = DetectionPipeline(DetectionConfig(tile=16, img_size=32,
                                             resize_src=40, code=code),
                             p, device="cpu")
    raw = np.random.default_rng(0).integers(0, 256, (4, 48, 48, 3),
                                            dtype=np.uint8)
    out = pipe.detect_batch(raw)
    assert out["message_bits"].shape == (4, 44)
    want = torch_rs.make_batch_decoder(code)(
        torch.as_tensor(out["logits"] > 0))
    for f in ("message_bits", "ok", "n_corrected"):
        np.testing.assert_array_equal(out[f], want[f].numpy(), err_msg=f)
