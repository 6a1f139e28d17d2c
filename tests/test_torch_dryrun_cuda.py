"""PyTorch port: the LM dry-run's one-card check on the card, at reduced
width.  Every test here needs a CUDA device (``gpu`` marker) and is
skipped without one; the file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dryrun_cuda.py

For a dense, a MoE, an SSM and an encoder-decoder arch at ``reduced``,
at a 1 x 1 plan, in train, prefill and decode: the FLOPs and unfused
bytes the meta trace counts equal the counts of the same step on the
card, and the argument bytes from the specs equal the bytes of the
parameters, AdamW moments and inputs made on the card — exactly, as
``chip_smoke.py``'s dry-run phase holds smollm-360m at full width.
"""
import pytest
import torch

from repro_torch.configs import base
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.sharding import planner

pytestmark = pytest.mark.gpu

ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "mamba2-2.7b",
         "seamless-m4t-medium")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_meta_counts_equal_the_card(mode, dev):
    mesh = mesh_lib.ShapeMesh(("data", "model"), (1, 1))
    for arch in ARCHS:
        cfg = base.reduced(base.get_config(arch))
        shape = base.ShapeSpec(f"card_{mode}", 64, 4, mode)
        plan = planner.make_plan(cfg, shape, mesh)
        meta = dryrun.trace_cell(cfg, shape, plan)
        card = dryrun.trace_cell(cfg, shape, plan, device=dev)
        assert meta["flops"] > 0
        for k in ("flops", "bytes", "saved_bytes"):
            assert meta[k] == card[k], (arch, k)
        rec = dryrun.cell_record(cfg, shape, mesh, plan)
        assert rec["memory"]["argument_size_in_bytes"] == \
            dryrun.materialized_argument_bytes(cfg, shape, dev), arch
