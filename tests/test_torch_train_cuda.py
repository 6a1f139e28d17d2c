"""PyTorch port: the training stage on the card.  Every test here needs
a CUDA device (``gpu`` marker) and is skipped without one; the file
imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_cuda.py

At ``ExtractorTrainConfig()``'s widths (tile 32, 128^2 images, extractor
channels 24 and depth 4, encoder 24 / 3) one training step's loss and
gradients on the card equal the CPU's within float32 tolerance (loss
1e-5 relative, each leaf's gradient within 1e-3 of its largest entry),
with every training attack in the batch: a TF32 matmul anywhere would
miss that by orders of magnitude.  The trainer refuses a TF32 matmul
precision, ``evaluate`` decodes on the card through the CUDA decode and
RS kernels with the CPU's decisions, and one fine-tune step of the LDM
decoder matches the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import extractor as ex
from repro_torch.core import ldm
from repro_torch.core import train_extractor as te
from repro_torch.kernels import ops
from repro_torch.train import optimizer as opt

pytestmark = pytest.mark.gpu

CFG = te.ExtractorTrainConfig(batch=14)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params():
    enc = ex.init_encoder_numpy(0, n_bits=60, channels=24, depth=3, tile=32)
    dec = ex.init_extractor_numpy(1, n_bits=60, channels=24, depth=4,
                                  tile=32, bias_scale=0.1)
    dec["corr"] = enc["patterns"].copy()
    return {"enc": enc, "dec": dec}


def _close(got, want, rel):
    for a, b in zip(opt.tree_leaves(got), opt.tree_leaves(want)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * np.abs(b).max() + 1e-12)


def test_train_step_on_the_card_equals_the_cpu(dev):
    p = _params()
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (CFG.batch, 32, 32, 3)).astype(np.float32)
    msgs = rng.integers(0, 2, (CFG.batch, 60)).astype(np.int32)
    idx = (np.arange(CFG.batch) % len(CFG.train_attacks)).astype(np.int32)
    loss_fn = te.make_loss_fn(CFG)
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = te.value_and_grad(
            loss_fn, ex.params_from_numpy(p, d),
            torch.as_tensor(imgs, device=d), torch.as_tensor(msgs, device=d),
            torch.as_tensor(idx, device=d))
    (lc, _), gc = out["cpu"]
    (lg, _), gg = out[str(dev)]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    _close(gg, gc, 1e-3)


def test_trainer_refuses_tf32(dev):
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            te.train(CFG, device=dev)
    finally:
        torch.set_float32_matmul_precision(before)


def test_evaluate_on_the_card_uses_the_kernels(dev):
    p = _params()
    ops.reset_launch_counts()
    got = te.evaluate(p, CFG, n_images=8, attacks=("none", "jpeg_50"),
                      device=dev)
    counts = ops.launch_counts()
    assert counts["fused_extractor"] == 2 and counts["rs_decode"] == 2
    want = te.evaluate(p, CFG, n_images=8, attacks=("none", "jpeg_50"),
                       device="cpu")
    for attack, rec in want.items():
        for k, v in rec.items():
            assert got[attack][k] == pytest.approx(v, rel=1e-4, abs=0.02), \
                (attack, k)


def test_finetune_step_on_the_card_equals_the_cpu(dev):
    ae = ldm.init_autoencoder_numpy(0)
    hd = _params()["dec"]
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    m_s = rng.integers(0, 2, 60).astype(np.int32)
    key = torch.tensor([0, 5], dtype=torch.int64)
    out = {}
    for d in ("cpu", dev):
        fn = ldm.make_finetune_loss(ex.params_from_numpy(ae, d),
                                    ex.params_from_numpy(hd, d),
                                    torch.as_tensor(m_s, device=d), tile=32,
                                    lam_i=2.0)
        out[str(d)] = te.value_and_grad(fn, ex.params_from_numpy(ae["dec"], d),
                                        torch.as_tensor(x, device=d), key)
    (lc, _), gc = out["cpu"]
    (lg, _), gg = out[str(dev)]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    _close(gg, gc, 1e-3)
