"""PyTorch port: the QRMark training stage against the JAX package, at
small size (tile 16, 32^2 images, extractor channels 8 and depth 2,
encoder 8 / 1, batches of 4).

* the losses, ``lr_schedule`` and ``adamw_update`` (on the same numpy
  gradients) against the reference: losses within 1e-6 relative,
  AdamW's parameters and moments within 1e-6 relative + 1e-7 absolute;
* ``encoder_forward`` within 1e-5, ``highpass`` within 1e-6, and
  ``grid_partition`` exactly;
* the trainer's loss and gradients (every leaf of {"enc", "dec"}) from
  the same weights and batch, with every attack of the training set in
  the batch, against ``jax.value_and_grad`` of the reference's loss:
  loss within 1e-5 relative, each leaf's gradient within 1e-3 of its
  largest entry (the two stacks sum the convolutions' taps and the
  reductions in other orders);
* ``train`` for 3 steps from the reference's weights carried across as
  numpy: the same batches, tiles, messages and attack indices (the
  port's threefry), the loss history within 1e-3 relative (AdamW's
  first steps move each weight by about lr * g / |g|, so a gradient at
  noise level can step the two stacks apart; the parameters after the
  steps are compared within 1e-3 absolute), and the state carried back
  to numpy;
* ``evaluate``'s bit and word accuracies and RS decisions (under the
  JPEG attack);
* the autoencoder's ``encode`` / ``decode`` within 1e-5 and one
  fine-tune step's loss and decoder gradients against
  ``jax.value_and_grad`` (1e-3 of the largest entry);
* ``tile_features`` (through ``build_training_set``) within 1e-4 and the
  boosted stumps exactly equal on the same (X, y).

One module fixture holds the file's one jitted JAX function (the
reference's loss, gradients and AdamW step, reused by the gradient and
the 3-step tests).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extractor as jex
from repro.core import ldm as jldm
from repro.core import losses as jlosses
from repro.core import predictor as jpred
from repro.core import tiling as jtiling
from repro.core import train_extractor as jte
from repro.core.rs.codec import DEFAULT_CODE as JCODE
from repro.train import optimizer as jopt
from repro_torch.core import extractor as ex
from repro_torch.core import ldm, losses, predictor, tiling
from repro_torch.core import train_extractor as te
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

N_BITS = 60
SMALL = dict(tile=16, img_size=32, channels=8, depth=2, enc_channels=8,
             enc_depth=1, batch=4, steps=3, curriculum_frac=0.34)
JCFG = jte.ExtractorTrainConfig(**SMALL)
TCFG = te.ExtractorTrainConfig(**SMALL)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed=0):
    """{"enc", "dec"} numpy weights, the extractor's bank tied to the
    encoder's patterns as the trainers tie them."""
    enc = ex.init_encoder_numpy(seed, n_bits=N_BITS, channels=8, depth=1,
                                tile=16)
    dec = ex.init_extractor_numpy(seed + 1, n_bits=N_BITS, channels=8,
                                  depth=2, tile=16, bias_scale=0.1)
    dec["corr"] = enc["patterns"].copy()
    return {"enc": enc, "dec": dec}


def _ref_loss(params, tiles, messages, attack_idx):
    """The reference trainer's loss (``make_train_step``'s loss_fn), from
    the reference's own functions."""
    xw, delta = jex.encoder_forward(params["enc"], tiles, messages,
                                    alpha=JCFG.alpha)
    stack = jnp.stack([jte.TRAIN_ATTACK_FNS[a](xw)
                       for a in JCFG.train_attacks])
    xw_t = jnp.take_along_axis(
        stack, attack_idx[None, :, None, None, None], axis=0)[0]
    logits = jex.extractor_forward(params["dec"], xw_t)
    total, parts = jlosses.qrmark_loss(logits, messages, code=JCFG.code,
                                       lam=JCFG.lam_rs)
    return total + JCFG.lam_img * jnp.mean(jnp.square(delta)), parts


@pytest.fixture(scope="module")
def ref_step():
    """(params, opt_state, tiles, messages, attack_idx) -> (loss, grads,
    params, opt_state): the reference's loss, its gradients and its
    AdamW step at the trainer's settings, jitted once."""
    ocfg = jopt.AdamWConfig(lr=JCFG.lr, warmup_steps=40,
                            total_steps=JCFG.steps, weight_decay=0.01,
                            clip_norm=10.0, b2=0.99)

    @jax.jit
    def step(params, opt_state, tiles, messages, attack_idx):
        (loss, _), g = jax.value_and_grad(_ref_loss, has_aux=True)(
            params, tiles, messages, attack_idx)
        p, o, _ = jopt.adamw_update(ocfg, params, g, opt_state)
        return loss, g, p, o

    return step


def _batch(i, key):
    """The reference trainer's batch i under ``key`` (raw key data):
    tiles, messages, attack indices, as ``jte.train`` draws them."""
    k = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
    key, kt, km, ka, _ = jax.random.split(k, 5)
    tiles = jte.batch_tiles(JCFG, i, kt)
    msgs = jax.random.randint(km, (JCFG.batch, N_BITS), 0, 2)
    idx = (jnp.zeros((JCFG.batch,), jnp.int32)
           if i < JCFG.curriculum_frac * JCFG.steps else
           jax.random.randint(ka, (JCFG.batch,), 0,
                              len(JCFG.train_attacks)))
    return np.asarray(jax.random.key_data(key)), tiles, msgs, idx


def _close_tree(got, want, rel, what):
    for g, w in zip(opt.tree_leaves(got), jax.tree.leaves(want)):
        g = g.detach().cpu().numpy() if torch.is_tensor(g) else g
        w = np.asarray(w)
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(1e-12, np.abs(w).max()),
                                   err_msg=what)


# -- losses, schedule, AdamW ---------------------------------------------------
def test_losses_match_reference():
    rng = np.random.default_rng(0)
    logits = (rng.normal(0, 3, (8, N_BITS))).astype(np.float32)
    logits[0, :4] = 0.0                       # ties at the maxima
    msgs = rng.integers(0, 2, (8, N_BITS)).astype(np.int32)
    lt, mt = torch.as_tensor(logits), torch.as_tensor(msgs)
    got, gp = losses.qrmark_loss(lt, mt, code=TCFG.code, lam=0.7)
    want, wp = jlosses.qrmark_loss(jnp.asarray(logits), jnp.asarray(msgs),
                                   code=JCODE, lam=0.7)
    for g, w in ((got, want), (gp["L_m"], wp["L_m"]),
                 (gp["L_RS"], wp["L_RS"])):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    # means of 0/1 values, summed in other orders: an ulp apart at most
    assert float(losses.bit_accuracy(lt, mt)) == pytest.approx(float(
        jlosses.bit_accuracy(jnp.asarray(logits), jnp.asarray(msgs))),
        rel=1e-6)
    bits = (logits > 0).astype(np.int32)
    bits[3] = msgs[3]
    assert float(losses.word_accuracy(torch.as_tensor(bits), mt)) == \
        pytest.approx(float(jlosses.word_accuracy(jnp.asarray(bits),
                                                  jnp.asarray(msgs))),
                      rel=1e-6)
    # the maxima split a tie's gradient as jnp.maximum does
    lg = lt.clone().requires_grad_(True)
    losses.message_loss(lg, mt).backward()
    jg = jax.grad(lambda x: jlosses.message_loss(x, jnp.asarray(msgs)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)


def test_lr_schedule_matches_reference():
    """Warm-up, its end, the cosine and past the total."""
    cfg = dict(lr=3e-3, warmup_steps=40, total_steps=400, min_lr_frac=0.1)
    for step in (0, 1, 39, 40, 41, 200, 10_000, 20_000):
        got = opt.lr_schedule(opt.AdamWConfig(**cfg),
                              torch.tensor(step, dtype=torch.int32))
        want = jopt.lr_schedule(jopt.AdamWConfig(**cfg), jnp.int32(step))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=str(step))


def test_adamw_update_matches_reference_on_same_grads():
    p = _params(3)
    rng = np.random.default_rng(4)
    g = jax.tree.map(lambda a: rng.normal(0, 0.3, a.shape).astype(
        np.float32), p)
    cfg = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.01,
               clip_norm=1.0, b2=0.99)
    tp, tg = ex.params_from_numpy(p), ex.params_from_numpy(g)
    ts = opt.init_opt_state(tp)
    js = jopt.init_opt_state(jax.tree.map(jnp.asarray, p))
    jp = jax.tree.map(jnp.asarray, p)
    jupd = jax.jit(lambda p_, g_, s_: jopt.adamw_update(
        jopt.AdamWConfig(**cfg), p_, g_, s_))
    for _ in range(3):
        tp, ts, tm = opt.adamw_update(opt.AdamWConfig(**cfg), tp, tg, ts)
        jp, js, jm = jupd(jp, jax.tree.map(jnp.asarray, g), js)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for a, b in zip(opt.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


# -- encoder, highpass, grid ---------------------------------------------------
def test_encoder_highpass_and_grid_match_reference():
    p = _params(5)
    rng = np.random.default_rng(6)
    tiles = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    msgs = rng.integers(0, 2, (3, N_BITS)).astype(np.int32)
    got, gd = ex.encoder_forward(ex.params_from_numpy(p["enc"]),
                                 torch.as_tensor(tiles),
                                 torch.as_tensor(msgs), alpha=0.8)
    want, wd = jex.encoder_forward(jax.tree.map(jnp.asarray, p["enc"]),
                                   jnp.asarray(tiles), jnp.asarray(msgs),
                                   alpha=0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        ex.highpass(torch.as_tensor(tiles)).numpy(),
        np.asarray(jex.highpass(jnp.asarray(tiles))), rtol=0, atol=1e-6)
    imgs = rng.uniform(-1, 1, (2, 40, 36, 3)).astype(np.float32)
    assert np.array_equal(
        tiling.grid_partition(torch.as_tensor(imgs), 16).numpy(),
        np.asarray(jtiling.grid_partition(jnp.asarray(imgs), 16)))


# -- the trainer -----------------------------------------------------------------
def test_train_step_loss_and_grads_match_reference(ref_step):
    """Every attack of the training set in one batch (two rows each of
    'none'), so the gradients run through all of them."""
    p = _params(7)
    _, tiles, msgs, _ = _batch(2, np.asarray([0, 11], np.uint32))
    idx = np.arange(JCFG.batch * 2, dtype=np.int32) % len(
        JCFG.train_attacks)
    tiles = jnp.concatenate([tiles, tiles[::-1]])
    msgs = jnp.concatenate([msgs, msgs[::-1]])
    jp = jax.tree.map(jnp.asarray, p)
    loss, grads, _, _ = ref_step(jp, jopt.init_opt_state(jp), tiles, msgs,
                                 jnp.asarray(idx))
    step = te.make_train_step(TCFG)
    (tl, parts), tg = te.value_and_grad(
        step.loss_fn, ex.params_from_numpy(p),
        torch.as_tensor(np.array(tiles)), torch.as_tensor(np.array(msgs)),
        torch.as_tensor(idx))
    np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
    assert set(parts) == {"L_m", "L_RS", "L_img", "bit_acc"}
    for name in ("enc", "dec"):
        for a, b in zip(opt.tree_leaves(tg[name]),
                        jax.tree.leaves(grads[name])):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-3 * np.abs(b).max() + 1e-12)


def test_train_three_steps_match_reference(ref_step):
    """``train`` from the reference's weights: the reference trainer's
    loop (its batches, keys and jitted step) against the port's."""
    p = _params(9)
    jp = jax.tree.map(jnp.asarray, p)
    jo = jopt.init_opt_state(jp)
    key = jax.random.key(JCFG.seed)
    _, _, key = jax.random.split(key, 3)
    key = np.asarray(jax.random.key_data(key))
    want = []
    for i in range(JCFG.steps):
        key, tiles, msgs, idx = _batch(i, key)
        loss, _, jp, jo = ref_step(jp, jo, tiles, msgs, idx)
        want.append(float(loss))
    out = te.train(TCFG, init_params=p, log_every=1, verbose=False,
                   device="cpu")
    got = [r["loss"] for r in out["history"]]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert [r["step"] for r in out["history"]] == [0, 1, 2]
    for a, b in zip(opt.tree_leaves(out["params"]), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3)
    # the trained state goes back to numpy and forth, unchanged
    back = ex.params_to_numpy({"params": out["params"],
                               "opt": out["opt_state"]})
    again = ex.params_from_numpy(back)
    assert int(again["opt"]["step"]) == JCFG.steps
    for a, b in zip(opt.tree_leaves(again), opt.tree_leaves(
            {"params": out["params"], "opt": out["opt_state"]})):
        assert torch.equal(a, b)


def test_evaluate_decisions_match_reference():
    """A watermark the corr bank decodes (the encoder's patterns are the
    bank, the head zeroed): accuracies and RS decisions as the
    reference's, through the plain decode and RS on the CPU."""
    p = _params(11)
    p["dec"]["head"]["w"][:] = 0.0
    p["dec"]["head"]["b"][:] = 0.0
    kw = dict(n_images=3, attacks=("jpeg_50",), seed=5)
    got = te.evaluate(p, TCFG, device="cpu", **kw)
    want = jte.evaluate(jax.tree.map(jnp.asarray, p), JCFG, **kw)
    for attack in kw["attacks"]:
        for k in ("bit_acc", "word_acc_raw", "rs_word_acc", "rs_bit_acc"):
            assert got[attack][k] == pytest.approx(want[attack][k],
                                                   abs=1e-6), (attack, k)
        assert got[attack]["psnr"] == pytest.approx(want[attack]["psnr"],
                                                    rel=1e-5)


# -- LDM fine-tuning ---------------------------------------------------------------
def _ae():
    return ldm.init_autoencoder_numpy(3, ch=8, latent=4)


def test_ldm_encode_decode_match_reference():
    ae = _ae()
    x = np.random.default_rng(12).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    z = ldm.encode(ex.params_from_numpy(ae), torch.as_tensor(x))
    jz = jldm.encode(jax.tree.map(jnp.asarray, ae), jnp.asarray(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-5)
    y = ldm.decode(ex.params_from_numpy(ae["dec"]), z)
    jy = jldm.decode(jax.tree.map(jnp.asarray, ae["dec"]), jz)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    up = ldm._up2(torch.as_tensor(x[:, :8, :8]))
    assert np.array_equal(up.numpy(), np.asarray(jldm._up2(
        jnp.asarray(x[:, :8, :8]))))


def test_finetune_step_grads_match_reference():
    """One fine-tune step's loss and the decoder copy's gradients, the
    reference's loss written from its own functions (``finetune_decoder``'s
    step), under the same tile key."""
    ae = _ae()
    hd = _params(13)["dec"]
    rng = np.random.default_rng(14)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    m_s = rng.integers(0, 2, N_BITS).astype(np.int32)
    kd = np.asarray([0, 21], np.uint32)
    jae, jhd = jax.tree.map(jnp.asarray, ae), jax.tree.map(jnp.asarray, hd)
    key = jax.random.wrap_key_data(jnp.asarray(kd))

    def jloss(dm):
        z = jldm.encode(jae, jnp.asarray(x))
        x_w = jldm.decode(dm, z)
        tiles_, _ = jtiling.select_tiles("random_grid", key, x_w, 16)
        logits = jex.extractor_forward(jhd, tiles_)
        msg = jnp.broadcast_to(jnp.asarray(m_s), (2, N_BITS))
        x_o = jldm.decode(jae["dec"], z)
        l_i = jnp.mean(jnp.square(jldm.extractor_features(jhd, x_w)
                                  - jldm.extractor_features(jhd, x_o)))
        l_i = l_i + jnp.mean(jnp.square(x_w - x_o))
        return jlosses.message_loss(logits, msg) + 2.0 * l_i

    want, wg = jax.jit(jax.value_and_grad(jloss))(jae["dec"])
    loss_fn = ldm.make_finetune_loss(
        ex.params_from_numpy(ae), ex.params_from_numpy(hd),
        torch.as_tensor(m_s), tile=16, lam_i=2.0)
    (got, _), g = te.value_and_grad(
        loss_fn, ex.params_from_numpy(ae["dec"]), torch.as_tensor(x),
        torch.as_tensor(kd.astype(np.int64)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for a, b in zip(opt.tree_leaves(g), jax.tree.leaves(wg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-3 * np.abs(b).max() + 1e-12)


# -- tile-size predictor -----------------------------------------------------------
def test_predictor_features_and_stumps_match_reference():
    """``tile_features`` through ``build_training_set`` (watermarked
    images resized 32 -> 40, so the features see the bilinear resize)."""
    enc = _params(15)["enc"]
    X, y = predictor.build_training_set({16: (enc, TCFG.code)},
                                        n_per_tile=3, img_size=40, seed=2,
                                        device="cpu")
    jX, jy = jpred.build_training_set(
        {16: (jax.tree.map(jnp.asarray, enc), JCODE)}, n_per_tile=3,
        img_size=40, seed=2)
    assert X.dtype == np.float32 and X.shape == jX.shape
    np.testing.assert_allclose(X, jX, rtol=0, atol=1e-4)
    assert np.array_equal(y, jy)
    rng = np.random.default_rng(17)
    Xs = rng.normal(size=(40, 5))
    ys = rng.choice([16.0, 32.0, 64.0], 40)
    a = predictor.fit_boosted_stumps(Xs, ys, n_rounds=20)
    b = jpred.fit_boosted_stumps(Xs, ys, n_rounds=20)
    assert a.base == b.base and a.lr == b.lr
    assert [dataclasses.astuple(s) for s in a.stumps] == \
        [dataclasses.astuple(s) for s in b.stumps]
    pa = predictor.TileSizePredictor(a)
    pb = jpred.TileSizePredictor(b)
    assert np.array_equal(pa.model.predict(Xs), pb.model.predict(Xs))
