"""PyTorch port: isolation from JAX and the CUDA-by-default contract.

``repro_torch``, ``chip_smoke.py``, the port's card tools
(``tools/torch_*.py``) and its examples (``examples/torch_*.py``) must
import nothing of ``jax`` and nothing of the JAX package ``repro``: a
subprocess with both blocked in ``sys.modules`` imports every port
module and example and runs ``detect_batch``, an LM train step and one
reduced cell of the LM's dry-run CLI (``python -m
repro_torch.launch.dryrun``) on the CPU.  The entry points run on the card unless the caller asks for
the CPU (``python -m repro_torch.launch.train`` without a card and
without ``--device cpu`` exits non-zero), and ``chip_smoke.py`` exits
non-zero with no result line when there is no card or when the
repository is not beside it.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import extractor as ex
from repro_torch.core.detect import DetectionConfig, DetectionPipeline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))

_ISOLATED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import numpy as np, torch
torch.set_num_threads(1)
import repro_torch, chip_smoke
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import runpy
for path in {examples!r}:
    runpy.run_path(path, run_name="example")   # its imports, not main()
from repro_torch.core import extractor as ex
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
p = ex.init_extractor_numpy(0, n_bits=60, channels=16, depth=3, tile=16)
pipe = DetectionPipeline(DetectionConfig(tile=16, img_size=32,
                                         resize_src=40), p, device="cpu")
raw = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3), np.uint8)
out = pipe.detect_batch(raw)
assert out["message_bits"].shape == (3, 48)
assert out["logits"].shape == (3, 60) and np.isfinite(out["logits"]).all()
from repro_torch.configs import base
from repro_torch.models import lm
from repro_torch.train import optimizer as opt, step
cfg = base.reduced(base.get_config("jamba-1.5-large-398b"))
model = lm.init_params(cfg, 0, device="cpu")
tok = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16)))
model, _, met = step.make_train_step(cfg, opt.AdamWConfig())(
    model, opt.init_opt_state(lm.param_tree(model)), {{"tokens": tok}})
assert np.isfinite(float(met["loss"]))
import json, pathlib, shutil, tempfile
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.planner import (batch_specs, decode_state_specs,
                                          opt_specs, param_specs,
                                          shard_shape, to_shardings)
out = tempfile.mkdtemp()
sys.argv = ["dryrun", "--arch", "smollm-360m", "--reduced", "--shape",
            "decode_32k", "--mesh", "single", "--out", out]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
rec = json.loads((pathlib.Path(out) / "smollm-360m-reduced__decode_32k__"
                  "single__baseline.json").read_text())
shutil.rmtree(out)
assert rec["status"] == "ok" and rec["derived"]["flops_per_device"] > 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert all(sys.modules[m] is None for m in bad), bad
print("ISOLATED-OK")
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_runs_with_jax_and_repro_blocked():
    code = _ISOLATED.format(src=str(ROOT / "src"), root=str(ROOT),
                            examples=[str(p) for p in EXAMPLES])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"] +
                         sorted((ROOT / "tools").glob("torch_*.py")) +
                         EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_pipeline_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = ex.init_extractor_numpy(0, n_bits=60, channels=16, depth=3, tile=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionPipeline(DetectionConfig(tile=16, img_size=32,
                                          resize_src=40), p)


def test_training_and_fleet_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core import ldm, predictor, train_extractor as te
    from repro_torch.launch.serve import fleet_devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = te.ExtractorTrainConfig(steps=0)
    for call in (lambda: te.train(cfg, verbose=False),
                 lambda: te.evaluate({}, cfg),
                 lambda: ldm.pretrain_autoencoder(steps=0),
                 lambda: ldm.finetune_decoder({}, {}, steps=0),
                 lambda: predictor.build_training_set({}),
                 lambda: fleet_devices(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert fleet_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_lm_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import base
    from repro_torch.launch import train
    from repro_torch.models import lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = base.reduced(base.get_config("smollm-360m"))
    shape = base.ShapeSpec("t", 16, 2, "train")
    for call in (lambda: lm.init_params(cfg),
                 lambda: train.train_loop(cfg, shape, steps=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert next(lm.init_params(cfg, device="cpu").parameters()).is_cpu


_NO_CUDA_LAUNCH = r"""
import runpy, sys, torch
torch.cuda.is_available = lambda: False
sys.argv = ["train", "--reduced", "--steps", "1", "--batch", "2",
            "--seq", "16"]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
"""


def test_lm_launcher_without_card_exits_nonzero(tmp_path):
    env = dict(_env(), PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _NO_CUDA_LAUNCH],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=tmp_path)
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert "[train]" not in res.stdout


_FAKE_CUDA = r"""
import runpy, sys, torch
torch.cuda.is_available = lambda: {avail}
sys.argv = [{script!r}]
runpy.run_path({script!r}, run_name="__main__")
"""


@pytest.mark.parametrize("avail,alone", [(False, False), (True, True)],
                         ids=["no-cuda", "script-alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, avail, alone):
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    code = _FAKE_CUDA.format(avail=avail, script=str(script))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
