"""The frozen reference against the port's plain path on the CPU, at a
tiny width: keys, plans and RS exactly; the whole detection's integers
exactly and its logits within float32 rounding."""
import json

import numpy as np
import pytest
import torch

import run
import synth
from conftest import tiny
from reference import detect as ref_detect
from reference import extractor, keys, rs

# float32 sums in another order: a few ulps of logits of order 1
LOGIT_TOL = 1e-5


@pytest.mark.parametrize("seed,seq", [(0, 0), (2 ** 31 - 1, 7), (-3, 1000)])
def test_keys_and_plans_equal_the_port(seed, seq):
    from repro_torch.core import prng, tiling
    k = keys.image_keys(seed, seq, 33)
    kt = prng.fold_in(prng.fold_in(prng.key(seed), seq)[None].expand(33, 2),
                      torch.arange(33))
    assert np.array_equal(k.astype(np.int64), kt.numpy())
    assert np.array_equal(
        keys.grid_plan(k, 256, 64, 3),
        tiling.escalation_offsets("random_grid", kt, (256, 256), 64,
                                  3).numpy())


def test_rs_equals_the_port_on_every_kind_of_word():
    from repro_torch.core.rs.codec import DEFAULT_CODE, rs_encode
    from repro_torch.kernels.rs_decode import rs_decode_plain
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 2, (64, 48))
    cw = rs.encode(msgs)
    assert np.array_equal(cw, np.stack([rs_encode(DEFAULT_CODE, m)
                                        for m in msgs]))
    one = cw.copy()
    one[np.arange(64), rng.integers(0, 60, 64)] ^= 1
    two = cw.copy()
    two[:, 0] ^= 1
    two[:, 59] ^= 1
    words = np.concatenate([cw, one, two, rng.integers(0, 2, (512, 60))])
    got = rs.decode(words)
    want = rs_decode_plain(torch.as_tensor(words))
    for g, n in zip(got, ("message_bits", "ok", "n_corrected")):
        assert np.array_equal(g, want[n].numpy()), n


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_detection_equals_the_port_plain_path(dtype):
    from repro_torch.core.detect import DetectionPipeline
    cfg, mix = tiny(f"qrmark-{dtype}", "mixed")
    gen = synth.generator(5, "cpu")
    params = synth.make_params(gen, cfg)
    ref_params = run.clone_tree(params)
    raw = synth.make_batch(gen, cfg, mix, params["corr"])[0]
    pipe = DetectionPipeline(run.pipeline_config(cfg, 5), params,
                             device="cpu")
    try:
        got = [pipe.detect_batch(raw) for _ in range(2)]
    finally:
        pipe.close()
    for seq, g in enumerate(got):
        want = ref_detect.detect(ref_params, torch.as_tensor(raw), cfg, 5,
                                 seq, cfg["reference_precision"])
        assert np.abs(g["logits"] - want["logits"]).max() < LOGIT_TOL
        for n in ("message_bits", "ok", "n_corrected", "tiles_used"):
            assert np.array_equal(g[n], want[n]), n
    assert (got[0]["tiles_used"] > 1).any()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    assert extractor.to_tf32(x).tolist() == [1.0 + 2 ** -10,
                                             1.0 + 2 ** -10, -3.0]
