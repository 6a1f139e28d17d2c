"""PyTorch port: the escalation plan's wrapper on the CPU.  The kernel
(``csrc/tile_plan.cu``) runs only on a card, where
``tests/test_torch_cuda.py`` holds it to its plain version,
``tiling.escalation_offsets``; here:

* ``ops.escalation_plan`` on CPU keys is the plain version for each
  strategy and geometry, k from 1 up, and counts no launch;
* arguments neither version takes — keys that are not (n, 2) int64, k
  below 1 or over the strategy's cap, an unknown strategy, a tile the
  geometry cannot hold — raise ValueError from ``ops`` and from the CUDA
  wrapper alike before anything launches, and the CUDA wrapper refuses
  CPU keys;
* a CPU ``StageRegistry.escalation_plan`` takes the plain path.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import tiling
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.extractor import init_extractor_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import tile_plan

torch.set_num_threads(1)

# (strategy, image (H, W), tile): random_grid on 256 images at the three
# tile sizes (64, 16 and 4 cells), random on a non-square image, fixed on
# a 3 x 3 grid
GEOMS = [("random_grid", (256, 256), 32), ("random_grid", (256, 256), 64),
         ("random_grid", (256, 256), 128), ("random", (40, 32), 16),
         ("fixed", (48, 48), 16)]


def _keys(n: int, seed: int = 0) -> torch.Tensor:
    """(n, 2) int64 uint32 words, the extreme words 0 and 0xFFFFFFFF in
    the first rows."""
    w = np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2),
                                             dtype=np.uint64)
    m = min(n, 3)
    w[:m] = np.array([(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0, 0xFFFFFFFF)],
                     np.uint64)[:m]
    return torch.as_tensor(w.astype(np.int64))


@pytest.mark.parametrize("strategy,hw,tile", GEOMS)
def test_cpu_keys_take_the_plain_version(strategy, hw, tile):
    keys = _keys(7)
    cap = tiling.max_escalation_tiles(strategy, hw, tile)
    ops.reset_launch_counts()
    for k in sorted({1, 2, 3, min(cap, 5)}):
        got = ops.escalation_plan(strategy, keys, hw, tile, k)
        want = tiling.escalation_offsets(strategy, keys, hw, tile, k)
        assert got.dtype == torch.int32 and got.device == keys.device
        assert torch.equal(got, want), k
    assert ops.launch_counts()["escalation_plan"] == 0


# case -> (strategy, keys, image (H, W), tile, k, message)
_K = _keys(4)
BAD = {
    "int32 keys": ("random_grid", _K.to(torch.int32), (256, 256), 64, 3,
                   "int64"),
    "float keys": ("random_grid", _K.double(), (256, 256), 64, 3, "int64"),
    "(n, 3) keys": ("random_grid", torch.zeros((4, 3), dtype=torch.int64),
                    (256, 256), 64, 3, r"\(n, 2\)"),
    "(n,) keys": ("random_grid", _K[:, 0].contiguous(), (256, 256), 64, 3,
                  r"\(n, 2\)"),
    "k = 0": ("random_grid", _K, (256, 256), 64, 0, "k >= 1"),
    "k over the grid's cap": ("random_grid", _K, (256, 256), 64, 17,
                              "at most 16"),
    "k over fixed's cap": ("fixed", _K, (32, 32), 16, 5, "at most 4"),
    "unknown strategy": ("spiral", _K, (256, 256), 64, 3, "unknown"),
    "tile 0": ("random", _K, (256, 256), 0, 3, "outside"),
    "tile wider than the grid": ("random_grid", _K, (64, 32), 48, 1,
                                 "width"),
}


@pytest.mark.parametrize("wrapper", ["ops", "cuda"])
@pytest.mark.parametrize("case", sorted(BAD))
def test_rejected_before_any_launch(case, wrapper):
    strategy, keys, hw, tile, k, match = BAD[case]
    fn = (ops.escalation_plan if wrapper == "ops"
          else tile_plan.escalation_plan_cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        fn(strategy, keys, hw, tile, k)
    assert ops.launch_counts()["escalation_plan"] == 0


def test_cuda_wrapper_refuses_cpu_keys():
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA keys"):
        tile_plan.escalation_plan_cuda("random_grid", _K, (256, 256), 64, 3)
    assert ops.launch_counts()["escalation_plan"] == 0


@pytest.mark.parametrize("strategy", tiling.STRATEGIES)
def test_cpu_registry_draws_the_plain_plan(strategy, monkeypatch):
    def no_kernel(*args, **kw):
        raise AssertionError("a CPU registry launched the plan kernel")

    monkeypatch.setattr(tile_plan, "escalation_plan_cuda", no_kernel)
    p = init_extractor_numpy(0, n_bits=60, channels=8, depth=2, tile=16)
    pipe = DetectionPipeline(DetectionConfig(
        tile=16, img_size=48, resize_src=48, strategy=strategy,
        escalate_tiles=3), p, device="cpu")
    reg = pipe.stages
    keys = reg.image_keys(reg.batch_key(0), 6)
    got = reg.escalation_plan(keys)
    want = tiling.escalation_offsets(strategy, keys, (48, 48), 16, 3)
    assert got.device.type == "cpu" and torch.equal(got, want)
