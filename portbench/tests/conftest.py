"""CPU tests of the benchmark (``python -m pytest portbench/tests -q``).
Tests marked ``gpu`` need a CUDA device and decide inside the test
whether to skip."""
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def tiny(config: str, traffic: str, **mix_over):
    """A cell's configuration and mix at a size the CPU runs in seconds:
    tile 16 in a 32 crop of 36-pixel raw images, width 8, depth 2,
    batches of 6."""
    cfg = load("configs", config)
    cfg.update(tile=16, img_size=32, resize_src=36)
    cfg["extractor"].update(channels=8, depth=2)
    mix = load("traffic", traffic)
    mix.update(batch=6, raw_size=36, ring=3, warmup_batches=3,
               check_batches=4, **mix_over)
    return cfg, mix


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
