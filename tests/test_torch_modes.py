"""PyTorch port: ``detect_batch`` in every mode, ingest path and RS
engine of the second slice against the JAX package, at the small size
the reference's own tests use (tile 16, img 32, resize_src 40, raw 64;
extractor channels 8, depth 2, with the bank).

Same raw batches, same keys: offsets (from the per-image keys), ``ok``
and ``n_corrected`` exactly equal; ``message_bits`` exactly equal where
``ok`` (on a failed decode the scalar codec of ``cpu_sync`` /
``cpu_pool`` returns its interpolated guess, the batched decoders the
received word's message bits; ROADMAP §3); logits within
1e-4 * (1 + max|logit|).  The head bias carries a codeword with one
symbol error, so rows decode (ok, one correction) and, on the
tile-first paths, rows fail.

The JAX pipeline runs its staged engine (``fused_keyed`` set to None,
so ``detect_batch`` goes ingest -> decode -> ``rs_correct``; the
reference holds its fused fast path bitwise equal to that), and its
``make_device_rs`` is ``jax_rs``'s batched decoder, memoized per code
for this module (``tests/shared_rs.py``): the JAX package's own tests
hold it bit-equal to its Pallas RS kernel, which compiles in about 15 s
in interpret mode where ``jax_rs`` takes a second
(``tests/test_torch_rs.py`` holds the port's RS to the Pallas kernel
itself).  Nothing in the JAX package changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stages as jstages
from repro.core import tiling as jtiling
from repro.core.detect import DetectionConfig as JConfig
from repro.core.detect import DetectionPipeline as JPipeline
from repro.core.rs import jax_rs
from repro_torch.core import extractor as ex
from repro_torch.core import tiling
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.rs import codec
from repro_torch.kernels import autotune
from shared_rs import memoized

torch.set_num_threads(1)

SMALL = dict(tile=16, img_size=32, resize_src=40)
CONFIGS = {
    "qrmark-staged": dict(tile_first=False),
    "qrmark-unfused-preprocess": dict(fused_preprocess=False),
    "qrmark-unfused-decode": dict(fused_decode=False),
    "tiled": dict(mode="tiled"),
    "sequential": dict(mode="sequential"),
    "qrmark-cpu_sync": dict(rs_mode="cpu_sync"),
    "qrmark-cpu_pool": dict(rs_mode="cpu_pool", rs_threads=4),
    "qrmark-blocked": dict(decode_schedule="bb2-ct4-db"),
}
# configurations whose rows include failed decodes (the unfused
# antialiased ingest happens to decode every row of these inputs)
MIXED = {"qrmark-staged", "qrmark-unfused-decode", "qrmark-cpu_sync",
         "qrmark-cpu_pool", "qrmark-blocked"}


def _params():
    p = ex.init_extractor_numpy(0, n_bits=60, channels=8, depth=2,
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
def shared_device_rs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstages, "make_device_rs",
                   memoized(jax_rs.make_batch_decoder))
        yield


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, shared_device_rs):
    """Two batches on the default key sequence through both pipelines;
    both pipelines are closed when the module is done with them."""
    knobs = CONFIGS[request.param]
    p = _params()
    jpipe = JPipeline(JConfig(**SMALL, **knobs),
                      jax.tree.map(jnp.asarray, p))
    jpipe.stages.fused_keyed = None
    tpipe = DetectionPipeline(DetectionConfig(**SMALL, **knobs),
                              ex.params_from_numpy(p), device="cpu")
    try:
        out = [(jpipe.detect_batch(jnp.asarray(_raw(i))),
                tpipe.detect_batch(_raw(i))) for i in range(2)]
        yield request.param, jpipe, tpipe, out
    finally:
        tpipe.close()
        jpipe.close()


def cfg_fast(cfg) -> bool:
    """Where the reference builds its fused fast path."""
    return cfg.mode == "qrmark" and cfg.rs_mode == "device"


def _tol(logits):
    return 1e-4 * (1.0 + float(np.abs(logits).max()))


def test_logits_within_tolerance(run):
    _, _, _, out = run
    for j, t in out:
        assert t["logits"].shape == j["logits"].shape == (6, 60)
        np.testing.assert_allclose(t["logits"], j["logits"], rtol=0,
                                   atol=_tol(j["logits"]))


def test_ok_and_corrections_exact_messages_where_ok(run):
    name, _, _, out = run
    oks = []
    for j, t in out:
        np.testing.assert_array_equal(t["ok"], j["ok"])
        np.testing.assert_array_equal(t["n_corrected"], j["n_corrected"])
        ok = j["ok"]
        np.testing.assert_array_equal(t["message_bits"][ok],
                                      j["message_bits"][ok])
        assert t["message_bits"].dtype == j["message_bits"].dtype
        oks.append(ok)
    oks = np.concatenate(oks)
    assert oks.any() and (name not in MIXED or not oks.all()), name


def test_offsets_and_paths_match(run):
    """The staged paths pick the reference's tiles from the same keys,
    and each registry resolves tile-first / fused decode / the fast path
    as the reference does."""
    name, jpipe, tpipe, _ = run
    js, ts = jpipe.stages, tpipe.stages
    assert ts.tile_first == js.tile_first
    assert ts.fused_decode == js.fused_decode
    assert (ts.fused_keyed is None) == (cfg_fast(tpipe.cfg) is False)
    cfg = tpipe.cfg
    jkeys = js.image_keys(js.batch_key(0), 6)
    tkeys = ts.image_keys(ts.batch_key(0), 6)
    hw = (cfg.img_size, cfg.img_size)
    np.testing.assert_array_equal(
        tiling.per_image_offsets(cfg.strategy, tkeys, hw, cfg.tile).numpy(),
        np.asarray(jtiling.per_image_offsets(cfg.strategy, jkeys, hw,
                                             cfg.tile)))
    if name == "qrmark-blocked":
        assert ts.decode_schedule == autotune.Schedule(2, 4, True)
    if name == "qrmark-cpu_pool":
        assert all(t["n_corrected"].max() == 0 for _, t in run[3])
