"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port; a run
without a card, or without the program beside it, prints no result."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import run

BENCH = Path(run.HERE)
ROOT = Path(run.ROOT)
MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_sources_name_no_forbidden_module(path):
    names = set(top_imports(path))
    assert not names & set(run.FORBIDDEN), names
    if "reference" in path.parts:
        assert "repro_torch" not in names, path


def test_a_whole_run_loads_no_forbidden_module():
    """Every benchmark module and a tiny run of a cell on the CPU, with
    the forbidden names refused, in a fresh interpreter."""
    code = f"""
import sys, json
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(BENCH)!r}, {str(BENCH / 'tests')!r}]
import run
sys.meta_path.insert(0, run.RefuseForbidden())
import importlib, torch
torch.set_num_threads(2)
for m in {[str(p.relative_to(BENCH).with_suffix('')).replace('/', '.', 1)
           for p in MODULES if p.stem != '__init__']!r}:
    if m.startswith('metrics.'):
        run.load_reader(m[len('metrics.'):])
    else:
        importlib.import_module(m)
from conftest import tiny, load
cfg, mix = tiny('qrmark-int8', 'mixed')
out = run.run_cell(cfg, mix, load('limits', 'int8-mixed'), seed=4,
                   seconds=0.3, device='cpu', t_start=0.0, log=lambda m: None)
print(json.dumps({{"correct": out["correct"], "leaked": run.forbidden_loaded(),
                  "repro_torch": "repro_torch" in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "leaked": [], "repro_torch": True}


def test_forbidden_names_are_refused_whole():
    finder = run.RefuseForbidden()
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "repro",
                 "repro.core.detect"):
        with pytest.raises(ModuleNotFoundError):
            finder.find_spec(name)
    for name in ("repro_torch", "repro_torch.core", "jaxtyping", "numpy"):
        assert finder.find_spec(name) is None


def no_result(p) -> bool:
    lines = p.stdout.strip().splitlines()
    try:
        json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        return True
    return False


def test_a_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "fp32-clean", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode != 0 and no_result(p)
    assert "no CUDA device" in p.stderr


def test_a_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "fp32-clean", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and no_result(p)
