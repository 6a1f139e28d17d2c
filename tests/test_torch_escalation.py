"""PyTorch port: adaptive multi-tile escalation against the JAX package,
at small size (tile 16, img 32 cropped from raw 40 at an identity
resize, extractor channels 8, depth 2, batches of 8).

* ``prng.permutation`` equals ``jax.random.permutation`` (one sort round
  up to n = 1625, two beyond), on draws without a 32-bit collision, so
  the stable sort's tie order never decides;
* ``tiling.escalation_offsets`` equals the reference bit for bit for the
  three strategies at every k up to the cap, and so do
  ``max_escalation_tiles``, ``extract_tiles_k``, the over-budget errors,
  ``EscalationPolicy`` and the configuration rules;
* ``detect_batch`` at ``escalate_tiles=3`` equals the reference's on a
  margined workload: watermarked images (the correlation bank's patterns
  signed by an RS codeword in every grid cell, numpy only), a corr-only
  detector (head weights zeroed), and damage on the tile round 1 picks
  (Gaussian noise, or a flat fill that only the margin trigger catches).
  ``tiles_used``, ``ok``, ``message_bits`` and ``n_corrected`` exact;
  logits within k * 1e-4 * (1 + max|logit|).  Tile-first with device RS
  (also padded, with ``true_b``), ``tiled`` with device RS, and staged
  with ``cpu_sync`` and a margin;
* in the port alone: clean images at k = 3 equal k = 1 bit for bit,
  ``decode_all_keyed`` equals the per-round decodes, and a row's
  escalation does not depend on the rows that share its rounds.

The reference's pipelines use ``jax_rs`` as their device RS engine
(patched in for this module), which the JAX package's own tests hold
bit-equal to its Pallas RS kernel and which compiles in a second instead
of fifteen a shape.  Nothing in the JAX package changes.
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
from repro_torch.core import prng, stages, tiling
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.rs import codec
from repro_torch.data.pipeline import synth_image

torch.set_num_threads(1)

TILE, IMG, RAW, B, K = 16, 32, 40, 8, 3
GEO = dict(tile=TILE, img_size=IMG, resize_src=RAW)
INT_FIELDS = ("message_bits", "ok", "n_corrected", "tiles_used")
NOISED = [0, 2, 3, 5, 6]        # an odd count: ragged sub-batches
FLAT = [1, 4]                   # flat-filled: only the margin fires
MARGIN = 0.5


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _jkeys(n, seed):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed),
                                                 i))(jnp.arange(n))


# -- prng.permutation ---------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 16, 100, 2000])
def test_permutation_exact(n):
    jkeys = _jkeys(5, seed=n)
    keys = torch.as_tensor(_kd(jkeys))
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    assert rounds == (0 if n == 1 else 1 if n < 1625 else 2)
    # no two draws of a round collide, so the sort's order is the bits'
    k = keys
    for _ in range(rounds):
        s = prng.split(k, 2)
        k, sub = s[:, 0], s[:, 1]
        bits = prng.random_bits(sub, (n,))
        assert all(len(set(row.tolist())) == n for row in bits)
    got = prng.permutation(keys, n)
    want = np.stack([np.asarray(jax.random.permutation(kk, n))
                     for kk in jkeys])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- escalation plans ---------------------------------------------------------
@pytest.mark.parametrize("strategy", tiling.STRATEGIES)
def test_escalation_offsets_exact(strategy):
    jkeys = _jkeys(9, seed=3)
    keys = torch.as_tensor(_kd(jkeys))
    # a 3 x 3 grid (k up to its 9 cells), or for ``random`` (no cap)
    # a non-square image and k up to 4
    hw, t = ((40, 32), 16) if strategy == "random" else ((48, 48), 16)
    cap = tiling.max_escalation_tiles(strategy, hw, t)
    assert cap == jtiling.max_escalation_tiles(strategy, hw, t)
    top = min(cap, 4) if strategy == "random" else cap
    # the reference's plan at k is its plan at the cap cut to k columns
    # (so it is called at 1, 2 and the cap only: an eager call costs
    # about a second on the CPU); the port is held to it at every k
    ref = {k: np.asarray(jtiling.escalation_offsets(strategy, jkeys, hw, t,
                                                    k)) for k in (1, 2, top)}
    for k in (1, 2):
        np.testing.assert_array_equal(ref[top][:, :k], ref[k])
    for k in range(1, top + 1):
        got = tiling.escalation_offsets(strategy, keys, hw, t, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref[top][:, :k],
                                      err_msg=f"k={k}")
    if cap < 2 ** 30:
        with pytest.raises(ValueError, match="at most") as mine:
            tiling.escalation_offsets(strategy, keys, hw, t, cap + 1)
        with pytest.raises(ValueError) as ref:
            jtiling.escalation_offsets(strategy, jkeys, hw, t, cap + 1)
        assert str(mine.value) == str(ref.value)


def test_extract_tiles_k_exact():
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(3, 40, 40, 3)).astype(np.float32)
    plans = rng.integers(0, 25, (3, 4, 2)).astype(np.int32)
    got = tiling.extract_tiles_k(torch.as_tensor(imgs),
                                 torch.as_tensor(plans), 16)
    want = np.asarray(jtiling.extract_tiles_k(jnp.asarray(imgs),
                                              jnp.asarray(plans), 16))
    np.testing.assert_array_equal(got.numpy(), want)


def test_policy_and_config_rules():
    ok = np.array([True, False, True])
    logits = np.array([[2.0, -2.0], [2.0, 2.0], [0.1, -0.1]], np.float32)
    for k, margin in ((1, 0.0), (3, 0.0), (3, 0.5)):
        mine = stages.EscalationPolicy(k, margin)
        ref = jstages.EscalationPolicy(k, margin)
        assert mine.enabled == ref.enabled
        np.testing.assert_array_equal(
            mine.wants_escalation(torch.as_tensor(ok),
                                  torch.as_tensor(logits)),
            ref.wants_escalation(ok, logits))
    p = ex.init_extractor_numpy(0, n_bits=60, channels=4, depth=1)
    for knob, match in ((dict(mode="sequential", escalate_tiles=2),
                         "sequential"),
                        (dict(**GEO, escalate_tiles=5), "exceeds"),
                        (dict(escalate_tiles=0), ">= 1"),
                        (dict(escalate_margin=0.5), "no effect")):
        with pytest.raises(ValueError, match=match):
            DetectionPipeline(DetectionConfig(**knob), p, device="cpu")
        with pytest.raises(ValueError, match=match):
            JPipeline(JConfig(**knob), jax.tree.map(jnp.asarray, p))


# -- detect_batch on the margined workload ------------------------------------
def _params():
    p = ex.init_extractor_numpy(3, n_bits=60, channels=8, depth=2,
                                tile=TILE)
    p["head"]["w"] = p["head"]["w"] * 0.0        # the correlation path only
    return p


def _watermarked(p, cw, rms=30.0):
    """Raw float images: the bank's patterns signed by ``cw``, scaled to
    RMS ``rms`` in 0..255 units, added to every grid cell of the crop."""
    wm = np.tensordot((2.0 * cw - 1.0).astype(np.float32), p["corr"],
                      axes=1)
    wm *= rms / np.sqrt(np.mean(wm * wm))
    raw = np.stack([synth_image(i, RAW) for i in range(B)]).astype(
        np.float32)
    o = (RAW - IMG) // 2
    for y in range(o, o + IMG, TILE):
        for x in range(o, o + IMG, TILE):
            raw[:, y:y + TILE, x:x + TILE] += wm
    return raw


def _damaged(raw, key, noised=(), flat=()):
    """Noise (sigma 90) or a flat fill on the tile round 1 picks."""
    keys = prng.fold_in(key[None].expand(B, 2), torch.arange(B))
    offs = tiling.tile_first_offsets("random_grid", keys, img_size=IMG,
                                     tile=TILE).numpy() + (RAW - IMG) // 2
    rng = np.random.default_rng(1)
    out = raw.copy()
    for i, (y, x) in enumerate(offs):
        if i in noised:
            out[i, y:y + TILE, x:x + TILE] += rng.normal(0, 90.0,
                                                        (TILE, TILE, 3))
        if i in flat:
            out[i, y:y + TILE, x:x + TILE] = 128.0
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


CONFIGS = {
    "qrmark-device": dict(),
    "tiled-device": dict(mode="tiled"),
    "staged-cpu_sync-margin": dict(tile_first=False, rs_mode="cpu_sync",
                                   escalate_margin=MARGIN),
}


@pytest.fixture(scope="module")
def workload():
    p = _params()
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 2, 48)
    raw = _watermarked(p, codec.rs_encode(codec.DEFAULT_CODE, msg))
    key = prng.key(5)
    return dict(p=p, msg=msg, key=key,
                clean=_damaged(raw, key),
                noised=_damaged(raw, key, noised=NOISED),
                margin=_damaged(raw, key, noised=[0, 3], flat=FLAT))


@pytest.fixture(scope="module")
def runs(workload):
    """Each configuration's reference and port results at k = 3, and the
    padded batch (two repeats of the last row, ``true_b`` 8) through the
    tile-first device-RS pipelines."""
    w = workload
    jp = jax.tree.map(jnp.asarray, w["p"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstages, "make_device_rs", jax_rs.make_batch_decoder)
        for name, knob in CONFIGS.items():
            raw = w["margin" if "margin" in name else "noised"]
            cfg = dict(**GEO, escalate_tiles=K, **knob)
            jpipe = JPipeline(JConfig(**cfg), jp, ground_truth_bits=w["msg"])
            tpipe = DetectionPipeline(DetectionConfig(**cfg), w["p"],
                                      ground_truth_bits=w["msg"],
                                      device="cpu")
            out[name] = (jpipe.detect_batch(jnp.asarray(raw),
                                            key=jax.random.key(5)),
                         tpipe.detect_batch(raw, key=w["key"]))
            if name == "qrmark-device":
                padded = np.concatenate([raw, raw[-1:], raw[-1:]])
                out["qrmark-device-padded"] = (
                    jpipe.detect_batch(jnp.asarray(padded),
                                       key=jax.random.key(5), true_b=B),
                    tpipe.detect_batch(padded, key=w["key"], true_b=B))
            tpipe.close()
    return out


def _tol(logits):
    return K * 1e-4 * (1.0 + float(np.abs(logits).max()))


@pytest.mark.parametrize("name", [*CONFIGS, "qrmark-device-padded"])
def test_escalated_detect_batch_equals_reference(runs, name):
    j, t = runs[name]
    for f in INT_FIELDS:
        assert t[f].dtype == np.asarray(j[f]).dtype, f
        np.testing.assert_array_equal(t[f], np.asarray(j[f]), err_msg=f)
    np.testing.assert_allclose(t["logits"], np.asarray(j["logits"]),
                               rtol=0, atol=_tol(np.asarray(j["logits"])))
    np.testing.assert_array_equal(t["match"], np.asarray(j["match"]))


def test_escalation_fires_where_round_1_failed(runs):
    """The noised rows escalate, over two and three tiles (ragged rounds),
    and most recover; the flat rows escalate only under the margin."""
    _, t = runs["qrmark-device"]
    used = t["tiles_used"]
    assert (used[NOISED] > 1).all() and (used[[1, 4, 7]] == 1).all()
    assert {2, 3} <= set(used.tolist())
    assert t["match"][NOISED].mean() >= 0.8
    _, m = runs["staged-cpu_sync-margin"]
    assert (m["tiles_used"][FLAT] > 1).all() and m["match"].all()
    _, pad = runs["qrmark-device-padded"]
    assert (pad["tiles_used"][B:] == 1).all()
    for f in (*INT_FIELDS, "logits"):
        np.testing.assert_array_equal(pad[f][:B], t[f], err_msg=f)


# -- the port alone ------------------------------------------------------------
def _pipe(p, k=K, **kw):
    return DetectionPipeline(DetectionConfig(**GEO, escalate_tiles=k, **kw),
                             p, device="cpu")


def test_clean_images_at_k3_equal_k1(workload):
    w = workload
    o1 = _pipe(w["p"], k=1).detect_batch(w["clean"], key=w["key"])
    o3 = _pipe(w["p"]).detect_batch(w["clean"], key=w["key"])
    assert "tiles_used" not in o1 and (o3["tiles_used"] == 1).all()
    for f in ("message_bits", "ok", "n_corrected", "logits"):
        np.testing.assert_array_equal(o1[f], o3[f], err_msg=f)


@pytest.mark.parametrize("knob", [dict(), dict(tile_first=False),
                                  dict(mode="tiled")])
def test_decode_all_keyed_equals_rounds(workload, knob):
    reg = _pipe(workload["p"], **knob).stages
    raw = torch.as_tensor(workload["noised"])
    keys = reg.image_keys(prng.key(7), B)
    all_k = reg.decode_all_keyed(raw, keys)
    assert all_k.shape == (B, K, 60)
    np.testing.assert_array_equal(
        all_k[:, 0].numpy(),
        reg.decode_keyed(reg.ingest_keyed(raw, keys), keys).numpy())
    for r in range(1, K):
        np.testing.assert_array_equal(
            all_k[:, r].numpy(), reg.escalate_round(raw, keys, r).numpy())


def test_rows_do_not_depend_on_the_sub_batch(workload):
    """Rows 0..5 escalated alone equal the same rows escalated among the
    others (other failing rows share their rounds there)."""
    w = workload
    pipe = _pipe(w["p"])
    keys = pipe.stages.image_keys(w["key"], B)
    full = pipe.detect_batch(w["noised"], key=w["key"])
    reg = pipe.stages
    raw = reg.to_device(w["noised"][:6])
    rs_out, logits = reg.fused_keyed(raw, keys[:6])
    part = reg.escalate(raw, keys[:6], rs_out["message_bits"],
                        rs_out["ok"], rs_out["n_corrected"], logits)
    for f, a in zip(("message_bits", "ok", "n_corrected", "logits",
                     "tiles_used"), part):
        np.testing.assert_array_equal(np.asarray(a), full[f][:6],
                                      err_msg=f)


def test_chip_smoke_escalation_checks_on_cpu():
    """``chip_smoke.py``'s escalation checks 1-5 (workload, k = 1 and 3,
    margin, ``decode_all_keyed``, the plain replay) rehearsed on the CPU
    at this file's size, its launch counts left to the card."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    out = chip_smoke.esc_checks(
        "cpu", geo=GEO, width=dict(n_bits=60, channels=8, depth=2),
        raw_hw=RAW, b=B, damaged=tuple(NOISED), rms=30.0)
    assert out["match_k1"] == 0.0 and out["match_k3"] == 1.0
    assert out["rounds"] == 2 and out["sub_batches"][0] == len(NOISED)
