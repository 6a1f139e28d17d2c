"""PyTorch port: ``detect_batch`` end to end against the JAX package, at
the small size the reference's own tests use (tile 16, img 32,
resize_src 40, raw 64; extractor channels 16, depth 3, with the bank).

The same raw batches and keys go through both pipelines.  Logits agree
within 1e-4 * (1 + max|logit|); ``message_bits`` / ``ok`` /
``n_corrected`` are exactly equal on every row whose smallest JAX
|logit| exceeds 10x that tolerance (a thinner row may flip a bit), and
the RS outputs are exactly equal on every row when both decoders are
fed the same bits.  The head bias carries a codeword with one symbol
error, so some rows decode (ok, n_corrected 1) and others fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.detect import DetectionConfig as JConfig
from repro.core.detect import DetectionPipeline as JPipeline
from repro_torch.core import extractor as ex
from repro_torch.core import prng
from repro_torch.core.detect import (DetectionConfig, DetectionPipeline,
                                     binomial_threshold, verify_against_key)
from repro_torch.core.rs import codec
from repro_torch.kernels import ops

torch.set_num_threads(1)

SMALL = dict(tile=16, img_size=32, resize_src=40)
RTOL = 1e-4
INT_FIELDS = ("message_bits", "ok", "n_corrected")


def _params():
    p = ex.init_extractor_numpy(0, n_bits=60, channels=16, depth=3,
                                tile=16, bias_scale=0.1)
    rng = np.random.default_rng(7)
    cw = codec.rs_encode(codec.DEFAULT_CODE, rng.integers(0, 2, 48)).copy()
    cw[5] ^= 1
    p["head"]["b"] = (p["head"]["b"] + 4.0 * (2 * cw - 1)).astype(
        np.float32)
    return p


def _raw(seed, b=6):
    return np.random.default_rng(seed).integers(0, 256, (b, 64, 64, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def runs():
    """Three batches through both pipelines: two on the default key
    sequence, one with an explicit key."""
    p = _params()
    jpipe = JPipeline(JConfig(**SMALL), jax.tree.map(jnp.asarray, p))
    tpipe = DetectionPipeline(DetectionConfig(**SMALL),
                              ex.params_from_numpy(p), device="cpu")
    out = []
    for i, key in enumerate((None, None, 5)):
        raw = _raw(i)
        jk = None if key is None else jax.random.key(key)
        tk = None if key is None else prng.key(key)
        out.append((jpipe.detect_batch(jnp.asarray(raw), key=jk),
                    tpipe.detect_batch(raw, key=tk)))
    return out


def _tol(logits):
    return RTOL * (1.0 + float(np.abs(logits).max()))


def test_logits_within_tolerance(runs):
    for j, t in runs:
        assert t["logits"].shape == j["logits"].shape == (6, 60)
        np.testing.assert_allclose(t["logits"], j["logits"], rtol=0,
                                   atol=_tol(j["logits"]))


@pytest.mark.parametrize("field", INT_FIELDS)
def test_rs_outputs_exact_on_margined_rows(runs, field):
    n_margined = 0
    for j, t in runs:
        margined = np.abs(j["logits"]).min(axis=1) > 10 * _tol(j["logits"])
        n_margined += int(margined.sum())
        assert t[field].dtype == j[field].dtype
        np.testing.assert_array_equal(t[field][margined], j[field][margined])
    assert n_margined >= 12


def test_outcomes_are_mixed(runs):
    ok = np.concatenate([j["ok"] for j, _ in runs])
    assert ok.any() and not ok.all()
    ncorr = np.concatenate([j["n_corrected"] for j, _ in runs])
    assert set(np.unique(ncorr)) <= {-1, 0, 1} and 1 in ncorr


def test_rs_exact_on_the_same_bits(runs):
    """The JAX pipeline decoded the bits of its own logits; the port's RS
    fed those bits — the op, and the registry's ``rs_correct`` — returns
    its outputs on every row."""
    stages = DetectionPipeline(DetectionConfig(**SMALL), _params(),
                               device="cpu").stages
    for j, _ in runs:
        bits = torch.as_tensor((j["logits"] > 0).astype(np.int32))
        for got in (ops.rs_decode(bits),
                    dict(zip(INT_FIELDS, stages.rs_correct(bits)))):
            for k in INT_FIELDS:
                np.testing.assert_array_equal(got[k].numpy(), j[k])


def test_rows_independent_of_batch():
    """Image i's result depends on its key and pixels only: a prefix of
    the batch with the same per-image keys decodes the same rows."""
    pipe = DetectionPipeline(DetectionConfig(**SMALL),
                             ex.params_from_numpy(_params()), device="cpu")
    raw = _raw(9, b=5)
    keys = pipe.stages.image_keys(prng.key(2), 5)
    full, lg_full = pipe.stages.fused_keyed(torch.as_tensor(raw), keys)
    part, lg_part = pipe.stages.fused_keyed(torch.as_tensor(raw[:3]),
                                            keys[:3])
    np.testing.assert_allclose(lg_part.numpy(), lg_full[:3].numpy(),
                               rtol=0, atol=_tol(lg_full.numpy()))
    for k in INT_FIELDS:
        np.testing.assert_array_equal(part[k].numpy(), full[k][:3].numpy())


@pytest.mark.parametrize("knob,item", [
    (dict(mode="tiled"), "item 8"), (dict(rs_mode="cpu_pool"), "item 8"),
    (dict(tile_first=False), "item 8"), (dict(fused_decode=False), "item 8"),
    (dict(code=codec.RSCode(m=4, n=15, k=11)), "item 8"),
    (dict(escalate_tiles=2), "item 9"), (dict(decode_dtype="bf16"), "item 10"),
    (dict(decode_schedule="auto"), "item 10"),
    (dict(cache_exact=True), "item 13")])
def test_unported_config_raises(knob, item):
    with pytest.raises(NotImplementedError, match=item):
        DetectionPipeline(DetectionConfig(**SMALL, **knob), _params(),
                          device="cpu")


def test_config_defaults_match_reference():
    import dataclasses
    mine = {f.name: f.default for f in dataclasses.fields(DetectionConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert mine.keys() == ref.keys()
    for name, value in ref.items():
        if name == "code":
            assert (mine[name].m, mine[name].n, mine[name].k) == \
                (value.m, value.n, value.k)
        else:
            assert mine[name] == value, name


@pytest.mark.parametrize("n", [48, 60])
@pytest.mark.parametrize("fpr", [1e-3, 1e-6])
def test_binomial_threshold_matches_reference(n, fpr):
    from repro.core.detect import binomial_threshold as jthr
    assert binomial_threshold(n, fpr) == jthr(n, fpr)
    key = np.random.default_rng(0).integers(0, 2, n)
    near = np.tile(key, (3, 1))
    near[:, 0] ^= 1
    assert verify_against_key(near, key, fpr=fpr).all()
