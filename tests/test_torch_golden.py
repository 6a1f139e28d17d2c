"""Golden outputs of the default detection path at full width, for the
card: ``tests/data/torch_port_golden.npz``.

The JAX package's default path — tile-first ingest (Pallas kernel,
interpret mode), the flat fp32 fused extractor (Pallas kernel,
interpret mode), ``logits > 0`` and the batched RS decode — runs at
full width (channels 64, depth 7, 60 bits, 64x64 correlation bank;
tile 64, img 256, resize_src 288, raw 288) on 4 synthetic images with
the offline key of batch 0, ``fold_in(key(0), 0)``.  Weights come from
``chip_smoke.golden_params(seed, margin)`` (numpy; seed and margin are
stored in the file).  RS runs through ``repro.core.rs.jax_rs``, which
the JAX package's own tests hold bit-equal to its Pallas RS kernel
(tests/test_rs_kernel.py) and which compiles in a second instead of
fifteen.  The file stores the offsets, logits, message_bits, ok and
n_corrected.

Here the JAX outputs are recomputed and held to the file (so it cannot
go stale) and the port's plain path at full width on the CPU is held to
it; ``chip_smoke.py`` holds the port's kernel path on the card to it.
Logits within 1e-4 * (1 + max|logit|); integers exact on every row
whose smallest |logit| exceeds 10x that (all four rows here).

Regenerate with:  PYTHONPATH=src python tests/test_torch_golden.py
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro.core import extractor as jex  # noqa: E402
from repro.core import tiling as jtiling  # noqa: E402
from repro.core.rs import jax_rs  # noqa: E402
from repro.core.rs.codec import DEFAULT_CODE as JCODE  # noqa: E402
from repro.data.pipeline import synth_image as jsynth  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.detect import (DetectionConfig,  # noqa: E402
                                     DetectionPipeline)
from repro_torch.data.pipeline import synth_image  # noqa: E402

torch.set_num_threads(1)

GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
SEED, MARGIN, IMAGE_IDS = 0, 3.5, np.arange(4)
INT_FIELDS = ("message_bits", "ok", "n_corrected")


def jax_golden(seed: int, margin: float, image_ids) -> dict:
    """The JAX package's default path on the golden inputs."""
    params = jax.tree.map(jnp.asarray, chip_smoke.golden_params(seed,
                                                                margin))
    raw = jnp.asarray(np.stack([jsynth(int(i), chip_smoke.RAW)
                                for i in image_ids]))
    bkey = jax.random.fold_in(jax.random.key(0), 0)
    keys = jax.vmap(lambda i: jax.random.fold_in(bkey, i))(
        jnp.arange(raw.shape[0]))
    full = chip_smoke.FULL
    offs = jtiling.tile_first_offsets("random_grid", keys,
                                      img_size=full["img_size"],
                                      tile=full["tile"])
    tiles = jops.fused_tile_preprocess(raw, offs,
                                       resize=full["resize_src"],
                                       crop=full["img_size"],
                                       tile=full["tile"])
    logits = jops.fused_extractor(tiles, jex.pack_params(params))
    rs = jax_rs.make_batch_decoder(JCODE)((logits > 0).astype(jnp.int32))
    return {"seed": np.int64(seed), "margin": np.float64(margin),
            "image_ids": np.asarray(image_ids), "offsets": np.asarray(offs),
            "logits": np.asarray(logits),
            "message_bits": np.asarray(rs["message_bits"]),
            "ok": np.asarray(rs["ok"]),
            "n_corrected": np.asarray(rs["n_corrected"])}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _tol(logits):
    return 1e-4 * (1.0 + float(np.abs(logits).max()))


def _hold(out: dict, golden: dict):
    ref = golden["logits"]
    np.testing.assert_allclose(out["logits"], ref, rtol=0, atol=_tol(ref))
    margined = np.abs(ref).min(axis=1) > 10 * _tol(ref)
    assert margined.all()
    for k in INT_FIELDS:
        np.testing.assert_array_equal(out[k][margined], golden[k][margined])


def test_golden_file_matches_jax_recompute(golden):
    assert int(golden["seed"]) == SEED and float(golden["margin"]) == MARGIN
    out = jax_golden(SEED, MARGIN, golden["image_ids"])
    np.testing.assert_array_equal(out["offsets"], golden["offsets"])
    _hold(out, golden)


def test_golden_outcomes_are_mixed(golden):
    assert golden["ok"].any() and not golden["ok"].all()
    assert set(golden["n_corrected"].tolist()) == {-1, 1}


def test_port_plain_path_matches_golden_at_full_width(golden):
    pipe = DetectionPipeline(
        DetectionConfig(**chip_smoke.FULL),
        chip_smoke.golden_params(int(golden["seed"]),
                                 float(golden["margin"])), device="cpu")
    raw = np.stack([synth_image(int(i), chip_smoke.RAW)
                    for i in golden["image_ids"]])
    out = pipe.detect_batch(raw)      # batch 0: key fold_in(key(0), 0)
    keys = pipe.stages.image_keys(pipe.stages.batch_key(0), raw.shape[0])
    from repro_torch.core import tiling
    offs = tiling.tile_first_offsets("random_grid", keys, img_size=256,
                                     tile=64)
    np.testing.assert_array_equal(offs.numpy(), golden["offsets"])
    _hold(out, golden)


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, **jax_golden(SEED, MARGIN, IMAGE_IDS))
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
