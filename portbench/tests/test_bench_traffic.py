"""The traffic and the weights: deterministic per seed, with the stated
shares of marked, unmarked and attacked images, whole marked images
decoding to their message, spliced ones only off the spliced rows."""
import numpy as np
import pytest
import torch

import synth
from conftest import load
from reference import extractor, keys, rs


def _cfg():
    cfg = load("configs", "qrmark-fp32")
    cfg["extractor"].update(channels=8, depth=1)
    return cfg


@pytest.mark.parametrize("traffic,share,attacked",
                         [("clean", 1.0, 0.0), ("mixed", 0.5, 0.5)])
def test_batches_repeat_per_seed_with_the_stated_share(traffic, share,
                                                       attacked):
    cfg, mix = _cfg(), dict(load("traffic", traffic), batch=8)
    assert mix.get("attacked_share", 0.0) == attacked
    runs = []
    for seed in (2 ** 31 + 5, 2 ** 31 + 5, 7):
        gen = synth.generator(seed, "cpu")
        p = synth.make_params(gen, cfg)
        runs.append((p["blocks"][0]["w"], synth.make_batch(gen, cfg, mix,
                                                            p["corr"])))
    (w0, (r0, m0, g0, a0)), (w1, (r1, m1, g1, a1)), (w2, (r2, _, _, _)) = \
        runs
    assert torch.equal(w0, w1) and not torch.equal(w0, w2)
    assert np.array_equal(r0, r1) and np.array_equal(m0, m1)
    assert np.array_equal(g0, g1) and not np.array_equal(r0, r2)
    assert np.array_equal(a0, a1)
    assert r0.shape == (8, 288, 288, 3) and r0.dtype == np.uint8
    assert len(m0) == len(set(m0.tolist())) == round(share * 8)
    assert set(a0.tolist()) <= set(m0.tolist())
    assert len(a0) == round(attacked * len(m0))
    assert g0.shape == (len(m0), 48)


def _first_tiles(p, raw, offs):
    tiles = extractor.ingest(torch.as_tensor(raw), torch.as_tensor(offs),
                             resize=288, img=256, tile=64)
    return extractor.forward(p, tiles)


def test_marked_images_decode_to_their_message():
    """At the configuration's geometry, through the reference: every
    whole marked image's first tile decodes to its message, and most
    unmarked images fail RS (a random word passes with probability
    226 / 4096)."""
    cfg = _cfg()
    mix = dict(load("traffic", "mixed"), batch=16, attacked_share=0.0)
    gen = synth.generator(11, "cpu")
    p = synth.make_params(gen, cfg)
    raw, marked, msgs, attacked = synth.make_batch(gen, cfg, mix, p["corr"])
    assert not len(attacked)
    offs = keys.grid_plan(keys.image_keys(3, 0, 16), 256, 64, 1)[:, 0]
    msg, ok, _ = rs.decode((_first_tiles(p, raw, offs) > 0).numpy())
    assert ok[marked].all() and np.array_equal(msg[marked], msgs)
    unmarked = np.setdiff1d(np.arange(16), marked)
    assert ok[unmarked].sum() <= 2


def test_spliced_rows_lose_the_mark_and_a_whole_tile_restores_it():
    """An attacked image's tile cells in the spliced bottom row decode to
    random words; its other cells decode to its message, and so does the
    sum of a spliced cell's logits and a whole cell's."""
    cfg = _cfg()
    mix = dict(load("traffic", "mixed"), batch=8, marked_share=1.0,
               attacked_share=1.0)
    gen = synth.generator(12, "cpu")
    p = synth.make_params(gen, cfg)
    raw, marked, msgs, attacked = synth.make_batch(gen, cfg, mix, p["corr"])
    assert sorted(attacked.tolist()) == list(range(8))
    want = np.zeros((8, 48), msgs.dtype)
    want[marked] = msgs
    spliced = _first_tiles(p, raw, np.tile([[192, 64]], (8, 1)))
    whole = _first_tiles(p, raw, np.tile([[64, 128]], (8, 1)))
    _, ok, _ = rs.decode((spliced > 0).numpy())
    assert ok.sum() <= 2
    msg, ok, _ = rs.decode((whole > 0).numpy())
    assert ok.all() and np.array_equal(msg, want)
    msg, ok, _ = rs.decode((spliced + whole > 0).numpy())
    assert ok.all() and np.array_equal(msg, want)


def test_weights_follow_the_configuration():
    cfg = _cfg()
    p = synth.make_params(synth.generator(1, "cpu"), cfg)
    assert [b["w"].shape for b in p["blocks"]] == [(3, 3, 3, 8)]
    assert p["to_bits"]["w"].shape == (3, 3, 8, 60)
    norms = p["corr"].square().sum(dim=(1, 2, 3))
    assert torch.allclose(norms, torch.ones(60), atol=1e-5)
    assert float(p["corr"].mean(dim=(1, 2, 3)).abs().max()) < 1e-6
