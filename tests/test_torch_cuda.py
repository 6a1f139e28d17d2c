"""PyTorch port: each CUDA kernel against its plain PyTorch version on
the card.  Every test here needs a CUDA device (``gpu`` marker) and is
skipped without one; the file imports nothing of JAX, so it runs on a
machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: ingest 1e-5 absolute (a few float32 ulps on values in about
[-2.2, 2.7]); extractor logits and embedding 1e-4 * (1 + max|ref|)
(the kernel and cuBLAS accumulate the fp32 tap dots in other orders);
RS outputs exactly equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import extractor as ex
from repro_torch.core.rs import codec
from repro_torch.kernels import fused_extractor as fx
from repro_torch.kernels import fused_tile_preprocess as ftp
from repro_torch.kernels import ops
from repro_torch.kernels import rs_decode as rs

pytestmark = pytest.mark.gpu

INGEST_ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tol(ref: np.ndarray) -> float:
    return 1e-4 * (1.0 + float(np.abs(ref).max()))


@pytest.mark.parametrize("raw_hw,resize,crop,tile", [
    (64, 40, 32, 16), (50, 36, 32, 16), (288, 288, 256, 64),
    (400, 288, 256, 64)])
@pytest.mark.parametrize("k", [None, 3])
def test_ingest_kernel_matches_plain(dev, raw_hw, resize, crop, tile, k):
    rng = np.random.default_rng(raw_hw)
    b = 5
    raw = torch.as_tensor(rng.integers(0, 256, (b, raw_hw, raw_hw, 3),
                                       dtype=np.uint8)).to(dev)
    shape = (b, 2) if k is None else (b, k, 2)
    offs = rng.integers(0, crop - tile + 1, shape)
    offs.reshape(-1, 2)[0] = (0, 0)
    offs.reshape(-1, 2)[-1] = (crop - tile, crop - tile)
    offs = torch.as_tensor(offs.astype(np.int32)).to(dev)
    kw = dict(resize=resize, crop=crop, tile=tile)
    got = ftp.fused_tile_preprocess_cuda(raw, offs, **kw)
    want = ftp.fused_tile_preprocess_plain(raw, offs, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=INGEST_ATOL)


@pytest.mark.parametrize("b,l,channels,depth,corr", [
    (5, 16, 16, 3, True), (3, 32, 32, 2, False), (32, 64, 64, 7, True),
    (1, 64, 64, 7, True), (5, 64, 64, 2, False)])
def test_extractor_kernel_matches_plain(dev, b, l, channels, depth, corr):
    p = ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=channels, depth=depth, tile=l if corr else 0,
        bias_scale=0.1), dev)
    pk = ex.pack_params(p)
    tiles = torch.as_tensor(np.random.default_rng(b).uniform(
        -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
    want = fx.fused_extractor_plain(tiles, pk, with_embed=True)
    got = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
    alone = fx.fused_extractor_cuda(tiles, pk)
    torch.cuda.synchronize()
    assert torch.equal(alone, got[0])  # embed output leaves logits as is
    for g, w in zip(got, want):
        w = w.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                   atol=_tol(w))


def test_extractor_rows_do_not_depend_on_batch(dev):
    p = ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=64, depth=3, tile=64), dev)
    pk = ex.pack_params(p)
    tiles = torch.as_tensor(np.random.default_rng(0).uniform(
        -2.0, 2.5, (6, 64, 64, 3)).astype(np.float32)).to(dev)
    full = fx.fused_extractor_cuda(tiles, pk)
    part = fx.fused_extractor_cuda(tiles[2:5].contiguous(), pk)
    torch.cuda.synchronize()
    assert torch.equal(full[2:5], part)


def _rs_words(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = list(rng.integers(0, 2, (256, 60)))
    for n_err in (0, 1, 2):
        for _ in range(128):
            cw = codec.rs_encode(codec.DEFAULT_CODE,
                                 rng.integers(0, 2, 48)).copy()
            for sym in rng.choice(15, n_err, replace=False):
                cw[sym * 4: sym * 4 + 4] ^= (
                    int(rng.integers(1, 16)) >> np.arange(3, -1, -1)) & 1
            rows.append(cw)
    rows += [np.zeros(60), np.ones(60), np.arange(60) % 2]
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("n", [1, 5, 32, 643])
def test_rs_kernel_equals_plain(dev, n):
    words = torch.as_tensor(_rs_words(n)[-n:]).to(dev)
    want = rs.rs_decode_plain(words)
    got = rs.rs_decode_cuda(words)
    torch.cuda.synchronize()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


def test_cuda_input_goes_to_the_kernels(dev):
    ops.reset_launch_counts()
    bits = torch.zeros((4, 60), dtype=torch.int32, device=dev)
    ops.rs_decode(bits)
    assert ops.launch_counts()["rs_decode"] == 1
    with pytest.raises(ValueError):
        ops.rs_decode(bits.to(torch.int64))  # the kernel takes int32 only
