"""PyTorch port: the LM seed code on the card.  Every test here needs a
CUDA device (``gpu`` marker) and is skipped without one; the file
imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_cuda.py

* each of the ten archs at ``reduced``: one float32 train step's loss
  (1e-5 relative) and every gradient leaf (1e-3 * (1 + max|g|)) on the
  card against the CPU from the same weights, the MoE layers' routing on
  the same inputs equal, and the bf16 loss within 1e-2 relative — the
  tolerances of ``chip_smoke.py``'s LM phase;
* at float32 compute the train step refuses a TF32 matmul precision;
* a checkpoint saved from the card (parameters, optimizer state and a
  bf16 leaf, synchronously and through ``AsyncCheckpointer``) restores on
  the CPU bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.configs import base
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import lm_batches
from repro_torch.models import lm, moe
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

pytestmark = pytest.mark.gpu

ARCHS = sorted(base.all_configs())


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(cfg, device):
    b = next(lm_batches(cfg, ShapeSpec("t", 32, 2, "train"), n_steps=1))
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _loss_grads(model, batch, dtype):
    leaves = opt_lib.tree_leaves(lm.param_tree(model))
    loss = lm.forward_train(model, batch, compute_dtype=dtype, remat=False)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_card_matches_cpu(arch, dev):
    cfg = base.reduced(base.get_config(arch))
    tree = lm.lm_params_to_numpy(lm.init_params(cfg, 0, device="cpu"))
    models = {d: lm.lm_params_from_numpy(tree, cfg, d) for d in ("cpu", dev)}
    seen = []
    hooks = [l.moe.register_forward_pre_hook(
        lambda m, a: seen.append((m, a[0].detach().reshape(
            -1, a[0].shape[-1]))))
        for l in models["cpu"].layers if hasattr(l, "moe")]
    (lc, gc) = _loss_grads(models["cpu"], _batch(cfg, "cpu"), torch.float32)
    for h in hooks:
        h.remove()
    (lg, gg) = _loss_grads(models[dev], _batch(cfg, dev), torch.float32)
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(gg, gc):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-3 * (1 + float(b.abs().max()))
    card_moes = [l.moe for l in models[dev].layers if hasattr(l, "moe")]
    assert len(seen) == len(card_moes) == sum(
        cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    for (m, x), cm in zip(seen, card_moes):
        assert torch.equal(moe.route(cm, x.to(dev), cfg.moe)[2].cpu(),
                           moe.route(m, x, cfg.moe)[2])
    with torch.no_grad():
        bf = [float(lm.forward_train(models[d], _batch(cfg, d), remat=False))
              for d in ("cpu", dev)]
    assert abs(bf[1] - bf[0]) <= 1e-2 * abs(bf[0])


def test_fp32_step_refuses_tf32(dev):
    cfg = base.reduced(base.get_config("smollm-360m"))
    model = lm.init_params(cfg, 0, device=dev)
    ost = opt_lib.init_opt_state(lm.param_tree(model))
    step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(),
                                    compute_dtype=torch.float32)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            step(model, ost, _batch(cfg, dev))
    finally:
        torch.set_float32_matmul_precision(prev)
    _, _, met = step(model, ost, _batch(cfg, dev))
    assert np.isfinite(float(met["loss"]))


def test_checkpoint_from_card_restores_on_cpu(dev, tmp_path):
    cfg = base.reduced(base.get_config("jamba-1.5-large-398b"))
    model = lm.init_params(cfg, 3, device=dev)
    ost = opt_lib.init_opt_state(lm.param_tree(model))
    step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig())
    model, ost, _ = step(model, ost, _batch(cfg, dev))
    params = lm.to_reference(lm.param_tree(model), cfg)
    tree = {"params": params, "m": lm.to_reference(ost["m"], cfg),
            "step": ost["step"],
            "bf16": params["embed"][:5].to(torch.bfloat16)}
    ckpt_lib.save(tmp_path / "sync", 1, tree)
    acp = ckpt_lib.AsyncCheckpointer(tmp_path / "async")
    acp.save(1, tree)
    acp.wait()
    for d in ("sync", "async"):
        out = ckpt_lib.restore(tmp_path / d, 1, tree, device="cpu")
        for (n, a), (_, b) in zip(opt_lib.tree_items(out),
                                  opt_lib.tree_items(tree)):
            assert a.device.type == "cpu" and a.dtype == b.dtype, n
            assert torch.equal(a, b.detach().cpu()), n
