"""PyTorch port: each CUDA kernel against its plain PyTorch version on
the card.  Every test here needs a CUDA device (``gpu`` marker) and is
skipped without one; the file imports nothing of JAX, so it runs on a
machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: ingest 1e-5 absolute (a few float32 ulps on values in about
[-2.2, 2.7]); extractor logits and embedding 1e-4 * (1 + max|ref|)
(the kernel and cuBLAS accumulate the fp32 tap dots in other orders);
at the bf16 and int8 rungs 0.02 absolute (RUNG_ATOL: where the two fp32
sums of an activation differ by an ulp, its bf16 rounding or int8
quantization can land one step apart, which moves a logit by up to
about 1e-3 at full width); RS outputs exactly equal.  Between kernels
of the port the contracts are exact: staged ingest (full-image kernel,
then the tile gather) equals tile-first ingest, and the blocked decode
kernel equals the flat one, bit for bit, on every candidate schedule
and channel tile, at every rung; so does each hidden block alone (the
flat kernel's C entry point against the blocked one's, fp32 and bf16),
and a row's logits do not depend on the batch it came in.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import extractor as ex
from repro_torch.core.rs import codec
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as at
from repro_torch.kernels import fused_extractor as fx
from repro_torch.kernels import fused_preprocess as fp
from repro_torch.kernels import fused_tile_preprocess as ftp
from repro_torch.kernels import ops
from repro_torch.kernels import rs_decode as rs

pytestmark = pytest.mark.gpu

INGEST_ATOL = 1e-5
RUNG_ATOL = 0.02


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


def _flip_symbol(word: np.ndarray, pos: int, value: int) -> np.ndarray:
    out = word.copy()
    out[4 * pos:4 * pos + 4] ^= (value >> np.arange(3, -1, -1)) & 1
    return out


def _rs_exhaustive_words(seed: int = 0) -> np.ndarray:
    """Every single-symbol pattern (15 positions x 16 values, 0 included)
    on 16 random codewords, 512 codewords each with 2, 3 and 4 symbol
    errors, and 512 uniform words: 5888 rows.  Codewords are XORs of the
    unit messages' (the code is linear over GF(2) bit by bit)."""
    rng = np.random.default_rng(seed)
    gen = np.stack([codec.rs_encode(codec.DEFAULT_CODE, e)
                    for e in np.eye(48, dtype=int)])
    rows = [_flip_symbol(cw, p, v)
            for cw in rng.integers(0, 2, (16, 48)) @ gen % 2
            for p in range(15) for v in range(16)]
    for n_err in (2, 3, 4):
        for w in rng.integers(0, 2, (512, 48)) @ gen % 2:
            for p in rng.choice(15, n_err, replace=False):
                w = _flip_symbol(w, int(p), int(rng.integers(1, 16)))
            rows.append(w)
    rows += list(rng.integers(0, 2, (512, 60)))
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("n", [1, 5, 32, 643, "exhaustive"])
def test_rs_kernel_equals_plain(dev, n):
    """The syndrome kernel equals the Berlekamp-Welch plain version on
    all four outputs, dtypes included (``ok`` is bool)."""
    words = _rs_exhaustive_words() if n == "exhaustive" else \
        _rs_words(n)[-n:]
    words = torch.as_tensor(words).to(dev)
    want = rs.rs_decode_plain(words)
    got = rs.rs_decode_cuda(words)
    torch.cuda.synchronize()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


def test_rs_kernel_rejects_misaligned_bits(dev):
    """The kernel loads two bits a lane as one 8-byte int2."""
    flat = torch.zeros(61, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        rs.rs_decode_cuda(flat[1:].view(1, 60))


def test_cuda_input_goes_to_the_kernels(dev):
    ops.reset_launch_counts()
    bits = torch.zeros((4, 60), dtype=torch.int32, device=dev)
    ops.rs_decode(bits)
    assert ops.launch_counts()["rs_decode"] == 1
    with pytest.raises(ValueError):
        ops.rs_decode(bits.to(torch.int64))  # the kernel takes int32 only


GEOMS = [(64, 40, 32, 16), (50, 36, 32, 16), (288, 288, 256, 64),
         (400, 288, 256, 64)]


@pytest.mark.parametrize("raw_hw,resize,crop,tile", GEOMS)
@pytest.mark.parametrize("b", [1, 5])
def test_preprocess_kernel_matches_plain(dev, raw_hw, resize, crop, tile, b):
    raw = torch.as_tensor(np.random.default_rng(raw_hw + b).integers(
        0, 256, (b, raw_hw, raw_hw, 3), dtype=np.uint8)).to(dev)
    got = fp.fused_preprocess_cuda(raw, resize=resize, crop=crop)
    want = fp.fused_preprocess_plain(raw, resize=resize, crop=crop)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, crop, crop, 3)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=INGEST_ATOL)


@pytest.mark.parametrize("raw_hw,resize,crop,tile", GEOMS)
def test_staged_ingest_equals_tile_first_exactly(dev, raw_hw, resize, crop,
                                                 tile):
    rng = np.random.default_rng(raw_hw)
    b = 5
    raw = torch.as_tensor(rng.integers(0, 256, (b, raw_hw, raw_hw, 3),
                                       dtype=np.uint8)).to(dev)
    offs = rng.integers(0, crop - tile + 1, (b, 2))
    offs[0], offs[-1] = (0, 0), (crop - tile, crop - tile)
    offs = torch.as_tensor(offs.astype(np.int32)).to(dev)
    staged = tiling.extract_tiles(
        fp.fused_preprocess_cuda(raw, resize=resize, crop=crop), offs, tile)
    first = ftp.fused_tile_preprocess_cuda(raw, offs, resize=resize,
                                           crop=crop, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(staged, first)


@pytest.mark.parametrize("b,l,channels,depth", [
    (32, 64, 64, 7), (1, 64, 64, 7), (5, 64, 64, 7), (5, 16, 16, 3),
    (3, 32, 32, 2)])
def test_blocked_kernel_equals_flat_bitwise(dev, b, l, channels, depth):
    pk = ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=channels, depth=depth, tile=l,
        bias_scale=0.1), dev))
    tiles = torch.as_tensor(np.random.default_rng(b).uniform(
        -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
    flat = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
    for sc in at.candidate_schedules(max(b, 8), channels, "cuda"):
        got = fx.fused_extractor_blocked_cuda(
            tiles, pk, batch_block=sc.batch_block,
            channel_tile=sc.channel_tile, double_buffer=sc.double_buffer,
            with_embed=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], flat[0]), sc.to_string()
        assert torch.equal(got[1], flat[1]), sc.to_string()


@pytest.mark.parametrize("channels", [16, 32, 64])
def test_blocked_kernel_every_channel_tile_equals_flat(dev, channels):
    """Every channel tile the kernel is built for (multiples of 4 that
    divide C), with and without double buffering, at a batch block that
    leaves a ragged last block."""
    pk = ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=channels, depth=2, tile=32,
        bias_scale=0.1), dev))
    tiles = torch.as_tensor(np.random.default_rng(channels).uniform(
        -2.0, 2.5, (5, 32, 32, 3)).astype(np.float32)).to(dev)
    flat = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
    for ct in fx.blocked_channel_tiles(channels):
        for db in (True, False):
            got = fx.fused_extractor_blocked_cuda(
                tiles, pk, batch_block=2, channel_tile=ct, double_buffer=db,
                with_embed=True)
            torch.cuda.synchronize()
            assert torch.equal(got[0], flat[0]), (ct, db)
            assert torch.equal(got[1], flat[1]), (ct, db)


def test_new_ops_count_their_launches(dev):
    ops.reset_launch_counts()
    raw = torch.zeros((2, 64, 64, 3), dtype=torch.uint8, device=dev)
    ops.fused_preprocess(raw, resize=40, crop=32)
    pk = ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=16, depth=2, tile=16), dev))
    tiles = torch.zeros((2, 16, 16, 3), device=dev)
    ops.fused_extractor(tiles, pk, schedule=at.Schedule(2, 8, True))
    counts = ops.launch_counts()
    assert counts["fused_preprocess"] == 1
    assert counts["fused_extractor_blocked"] == 1
    assert counts["fused_extractor"] == 0
    with pytest.raises(ValueError, match="channel tiles"):
        ops.fused_extractor(tiles, pk, schedule=at.Schedule(1, 12))


def _rung_pack(dev, dtype, *, channels, depth, tile, corr=True):
    return ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=channels, depth=depth,
        tile=tile if corr else 0, bias_scale=0.1), dev), dtype)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("b,l,channels,depth,corr", [
    (5, 16, 16, 3, True), (3, 32, 32, 2, False), (32, 64, 64, 7, True),
    (1, 64, 64, 7, True)])
def test_rung_kernel_matches_plain(dev, dtype, b, l, channels, depth, corr):
    """The bf16 / int8 kernels against their plain versions, logits and
    GAP embedding; the embedding output leaves the logits as they are."""
    pk = _rung_pack(dev, dtype, channels=channels, depth=depth, tile=l,
                    corr=corr)
    tiles = torch.as_tensor(np.random.default_rng(b).uniform(
        -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
    want = fx.fused_extractor_plain(tiles, pk, with_embed=True)
    got = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
    alone = fx.fused_extractor_cuda(tiles, pk)
    torch.cuda.synchronize()
    assert torch.equal(alone, got[0])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=RUNG_ATOL)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("channels", [16, 32, 64])
def test_rung_blocked_equals_flat_every_channel_tile(dev, dtype, channels):
    """Every channel tile the blocked kernel is built for, with and
    without double buffering, at a ragged batch block: bitwise the flat
    kernel at the rung; rows do not depend on the batch."""
    pk = _rung_pack(dev, dtype, channels=channels, depth=2, tile=32)
    tiles = torch.as_tensor(np.random.default_rng(channels).uniform(
        -2.0, 2.5, (5, 32, 32, 3)).astype(np.float32)).to(dev)
    flat = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
    part = fx.fused_extractor_cuda(tiles[1:4].contiguous(), pk)
    torch.cuda.synchronize()
    assert torch.equal(part, flat[0][1:4])
    for ct in fx.blocked_channel_tiles(channels):
        for db in (True, False):
            got = fx.fused_extractor_blocked_cuda(
                tiles, pk, batch_block=2, channel_tile=ct, double_buffer=db,
                with_embed=True)
            torch.cuda.synchronize()
            assert torch.equal(got[0], flat[0]), (ct, db)
            assert torch.equal(got[1], flat[1]), (ct, db)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_rung_ops_count_their_launches(dev, dtype):
    """ops.fused_extractor runs a rung's pack through the kernels: one
    count per call on the flat or the blocked counter."""
    pk = _rung_pack(dev, dtype, channels=16, depth=2, tile=16)
    tiles = torch.zeros((2, 16, 16, 3), device=dev)
    ops.reset_launch_counts()
    ops.fused_extractor(tiles, pk)
    ops.fused_extractor(tiles, pk, schedule=at.Schedule(2, 8, True))
    ops.fused_extractor(tiles, pk, schedule=at.Schedule(1, 0, False))
    counts = ops.launch_counts()
    assert counts["fused_extractor"] == 1
    assert counts["fused_extractor_blocked"] == 2
    with pytest.raises(ValueError, match="pack"):
        bad = dict(pk, head=dict(pk["head"], w=pk["head"]["w"].double()))
        ops.fused_extractor(tiles, bad)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_decode_kernels_count_their_launches(dev, dtype):
    """Each CUDA kernel of a decode call counts its own launches, under
    the name the per-layer launchers give it: depth 3 at C=16 is layer 0,
    two hidden blocks, to_bits and the head (at int8 one quantize pass
    before each conv); a blocked call counts the blocked conv instead."""
    pk = _rung_pack(dev, dtype, channels=16, depth=3, tile=16)
    tiles = torch.zeros((2, 16, 16, 3), device=dev)
    r = fx.RUNGS[dtype]
    tail = {fx.to_bits_kernel_name(r, 16, 60): 1,
            fx.head_kernel_name(r, 60): 1}
    if dtype == "int8":
        tail["quantize_rows_kernel"] = 4
        flat = {fx.conv_kernel_name(r, 3, 16): 3}
    else:
        flat = {fx.conv_kernel_name(r, 3, 16): 1,
                fx.conv_kernel_name(r, 16, 16): 2}
    ops.reset_launch_counts()
    ops.fused_extractor(tiles, pk)
    assert ops.kernel_launch_counts() == {**flat, **tail}
    ops.reset_launch_counts()
    ops.fused_extractor(tiles, pk, schedule=at.Schedule(2, 8, True))
    assert ops.kernel_launch_counts() == {
        fx.conv_kernel_name(r, 16, 16, 8): 3, **tail}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("channels", [16, 32, 64])
@pytest.mark.parametrize("l", [16, 32, 64])
@pytest.mark.parametrize("b", [1, 5, 32])
def test_hidden_block_flat_equals_blocked_bitwise(dev, dtype, channels, l,
                                                  b):
    """Each hidden block alone: layer 0 (cin 3) and a C -> C block, the
    flat kernel (``qr_conv3x3_norm_relu``) bitwise equal to the blocked
    one (``qr_conv3x3_norm_relu_blocked``) at ct = C and at ct = C / 2
    with double buffering, on a batch block that leaves b = 5 ragged."""
    pk = _rung_pack(dev, dtype, channels=channels, depth=2, tile=l)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rung = fx.RUNGS[dtype]
    x = torch.as_tensor(np.random.default_rng(b * l + channels).uniform(
        -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
    for layer, blk in enumerate(pk["blocks"]):
        flat = fx.conv_block(lib, x, blk, rung, stream)
        for ct, db in ((channels, False), (channels // 2, True)):
            got = fx.conv_block(lib, x, blk, rung, stream,
                                blocked=(2, ct, db))
            torch.cuda.synchronize()
            assert torch.isfinite(flat).all()
            assert torch.equal(got, flat), (layer, ct)
        x = flat


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_full_width_rows_do_not_depend_on_batch(dev, dtype):
    """Full width (C 64, D 7, l 64, correlation bank) at b=32: rows 7..19
    decoded alone equal the same rows of the whole batch, logits and
    embedding."""
    pk = _rung_pack(dev, dtype, channels=64, depth=7, tile=64)
    tiles = torch.as_tensor(np.random.default_rng(7).uniform(
        -2.0, 2.5, (32, 64, 64, 3)).astype(np.float32)).to(dev)
    full = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
    part = fx.fused_extractor_cuda(tiles[7:20].contiguous(), pk,
                                   with_embed=True)
    torch.cuda.synchronize()
    assert torch.equal(part[0], full[0][7:20])
    assert torch.equal(part[1], full[1][7:20])
