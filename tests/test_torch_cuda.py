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
flat kernel's C entry point against the blocked one's; at int8 the words
and scales each writes for the next layer, ``QuantAct``: no int8 path
launches a quantize pass), and a row's logits do not depend on the batch
it came in.  The RS kernel equals the plain version on words with
entries outside {0, 1} and on int64 and bool bits.  The escalation plan
kernel, which the port added, equals ``tiling.escalation_offsets``
exactly, on every strategy and k up to the cap.
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
    (1, 64, 64, 7, True), (5, 64, 64, 2, False), (5, 32, 24, 4, True),
    (3, 16, 8, 2, True), (32, 32, 24, 4, True)])
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
    """One kernel launch a call; int64 and bool bits are cast to int32 as
    the reference casts them, float bits are refused."""
    ops.reset_launch_counts()
    bits = torch.zeros((4, 60), dtype=torch.int32, device=dev)
    ops.rs_decode(bits)
    assert ops.launch_counts()["rs_decode"] == 1
    for other in (bits.to(torch.int64), bits.bool()):
        got = ops.rs_decode(other)
        assert torch.equal(got["ok"], torch.ones(4, dtype=torch.bool,
                                                 device=dev))
    assert ops.launch_counts()["rs_decode"] == 3
    with pytest.raises(ValueError):
        ops.rs_decode(bits.float())


def _rs_out_of_domain_words(seed: int) -> np.ndarray:
    """Codewords and single-error words with one to four entries of 2,
    -1, 3, -2 or 5; words over [-2, 3]; words with entries at the int32
    limits (-2^31 times a symbol weight wraps to 0); {0, 1} words beside
    them, so warps of both kinds share blocks."""
    rng = np.random.default_rng(seed)
    gen = np.stack([codec.rs_encode(codec.DEFAULT_CODE, e)
                    for e in np.eye(48, dtype=int)])
    rows = []
    for i, cw in enumerate(rng.integers(0, 2, (64, 48)) @ gen % 2):
        w = cw.astype(np.int64)
        if i % 2:
            w = _flip_symbol(w, int(rng.integers(15)), int(rng.integers(16)))
        if i % 4 != 3:
            for j in rng.choice(60, int(rng.integers(1, 5)), replace=False):
                w[j] = rng.choice([2, -1, 3, -2, 5])
        rows.append(w)
    rows += list(rng.integers(-2, 4, (32, 60)))
    big = [2 ** 30, 2 ** 29, -2 ** 31, 2 ** 31 - 1, -2 ** 30 - 7]
    for i in range(32):
        w = rng.integers(0, 2, 60) if i % 2 else np.zeros(60, np.int64)
        w[(7 * i) % 60] = -2 ** 31
        w[(11 * i + 3) % 60] = big[i % 5]
        rows.append(w)
    words = np.stack(rows).astype(np.int32)
    return words[rng.permutation(len(words))]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.bool])
@pytest.mark.parametrize("n", [1, 5, 128])
def test_rs_kernel_equals_plain_outside_01(dev, dtype, n):
    """Entries outside {0, 1}: the kernel decodes such a word by the
    reference's algorithm, and equals the plain version (held to JAX's
    kernel on the CPU) on all four outputs; int64 bits that wrap to the
    int32 words decode as those, bool bits as 0/1."""
    words = _rs_out_of_domain_words(n)[:n]
    if dtype == torch.int64:
        w64 = words.astype(np.int64)
        bits = torch.as_tensor(w64 + (1 << 32) * np.sign(w64)).to(dev)
    elif dtype == torch.bool:
        bits = torch.as_tensor(words != 0).to(dev)
    else:
        bits = torch.as_tensor(words).to(dev)
    want = rs.rs_decode_plain(torch.as_tensor(words).to(dev)
                              if dtype != torch.bool else bits)
    got = rs.rs_decode_cuda(bits)
    torch.cuda.synchronize()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


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


@pytest.mark.parametrize("channels", [8, 16, 24, 32, 64])
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
    (1, 64, 64, 7, True), (5, 32, 24, 4, True), (3, 16, 8, 2, True),
    (32, 32, 24, 4, True)])
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
@pytest.mark.parametrize("channels", [8, 16, 24, 32, 64])
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
    two hidden blocks, to_bits and the head (at int8 no quantize pass:
    the tensor-core kernels quantize in their epilogue); a blocked call
    counts the blocked conv instead, beside the same to_bits and head."""
    pk = _rung_pack(dev, dtype, channels=16, depth=3, tile=16)
    tiles = torch.zeros((2, 16, 16, 3), device=dev)
    r = fx.RUNGS[dtype]
    tail = {fx.to_bits_kernel_name(r, 16, 60): 1,
            fx.head_kernel_name(r, 60): 1}
    flat = {fx.conv_kernel_name(r, 3, 16): 1,
            fx.conv_kernel_name(r, 16, 16): 2, **tail}
    blocked = {fx.conv_kernel_name(r, 3, 16, 8): 1,
               fx.conv_kernel_name(r, 16, 16, 8): 2, **tail}
    ops.reset_launch_counts()
    ops.fused_extractor(tiles, pk)
    assert ops.kernel_launch_counts() == flat
    ops.reset_launch_counts()
    ops.fused_extractor(tiles, pk, schedule=at.Schedule(2, 8, True))
    assert ops.kernel_launch_counts() == blocked


@pytest.mark.parametrize("schedule", ["bb4-ct0", "bb4-ct32-db"])
def test_blocked_int8_call_launches_nine_kernels(dev, schedule):
    """A blocked int8 decode call at depth 7 (C 64, l 64) launches 9
    kernels: the seven blocked convs, the flat to_bits and the head, no
    quantize pass; each launch counted under its kernel's name."""
    pk = _rung_pack(dev, "int8", channels=64, depth=7, tile=64)
    tiles = torch.zeros((2, 64, 64, 3), device=dev)
    ops.reset_launch_counts()
    ops.fused_extractor(tiles, pk, schedule=at.Schedule.from_string(schedule))
    torch.cuda.synchronize()
    counts = ops.kernel_launch_counts()
    ct = at.Schedule.from_string(schedule).channel_tile or 64
    r = fx.INT8
    assert counts == {fx.conv_kernel_name(r, 3, 64, ct): 1,
                      fx.conv_kernel_name(r, 64, 64, ct): 6,
                      fx.to_bits_kernel_name(r, 64, 60): 1,
                      fx.head_kernel_name(r, 60): 1}
    assert sum(counts.values()) == 9
    assert not any("quantize" in k for k in counts)


def _same(got, want) -> bool:
    """Bitwise equal activations: fp32 tensors, or at int8 the words and
    scales of two ``QuantAct``s."""
    if isinstance(want, fx.QuantAct):
        return torch.equal(got.q, want.q) and torch.equal(got.s, want.s)
    return torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("channels", [8, 16, 24, 32, 64])
@pytest.mark.parametrize("l", [16, 32, 64])
@pytest.mark.parametrize("b", [1, 5, 32])
def test_hidden_block_flat_equals_blocked_bitwise(dev, dtype, channels, l,
                                                  b):
    """Each hidden block alone: layer 0 (cin 3) and a C -> C block, the
    flat kernel (``qr_conv3x3_norm_relu``; int8: ``qr_conv3x3_imma``)
    bitwise equal to the blocked one (``qr_conv3x3_norm_relu_blocked``;
    int8: ``qr_conv3x3_imma_blocked``) at ct = C and at ct = C / 2 with
    double buffering, on a batch block that leaves b = 5 ragged.  At int8
    in the form the next layer reads (``QuantAct``: the words and
    scales); and the whole decode, flat against blocked, logits and
    embedding."""
    pk = _rung_pack(dev, dtype, channels=channels, depth=2, tile=l)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rung = fx.RUNGS[dtype]
    x = torch.as_tensor(np.random.default_rng(b * l + channels).uniform(
        -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
    xf = x  # the flat schedule's layer input (int8: a QuantAct after 0)
    for layer, blk in enumerate(pk["blocks"]):
        flat = fx.conv_block(lib, xf, blk, rung, stream)
        for ct, db in ((channels, False), (channels // 2, True)):
            got = fx.conv_block(lib, x, blk, rung, stream,
                                blocked=(2, ct, db))
            torch.cuda.synchronize()
            assert torch.isfinite(got.s if dtype == "int8" else got).all()
            assert _same(got, flat), (layer, ct)
        xf, x = flat, got
    if dtype == "int8":
        tiles = torch.as_tensor(np.random.default_rng(l).uniform(
            -2.0, 2.5, (b, l, l, 3)).astype(np.float32)).to(dev)
        want = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
        got = fx.fused_extractor_blocked_cuda(
            tiles, pk, batch_block=2, channel_tile=channels // 2,
            double_buffer=True, with_embed=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b", [1, 3])
def test_blocked_small_batch_full_width_equals_flat(dev, dtype, b):
    """Full width (C 64, l 64, correlation bank; depth cut to 3) at b = 1
    and 3: schedules whose batch block exceeds the batch (clamped by the
    op, so the block's slots are part idle), at ct = C, C / 2 and 4, equal
    the flat kernel bit for bit, logits and embedding; and each hidden
    block launched with the unclamped bb 8 > b (layer 0 and 64 -> 64)
    equals the flat block."""
    pk = _rung_pack(dev, dtype, channels=64, depth=3, tile=64)
    tiles = torch.as_tensor(np.random.default_rng(b + 40).uniform(
        -2.0, 2.5, (b, 64, 64, 3)).astype(np.float32)).to(dev)
    flat = fx.fused_extractor_cuda(tiles, pk, with_embed=True)
    for sc in ("bb4-ct0", "bb8-ct32-db", "bb8-ct32", "bb2-ct4-db"):
        s = at.Schedule.from_string(sc)
        got = fx.fused_extractor_blocked_cuda(
            tiles, pk, batch_block=s.batch_block,
            channel_tile=s.channel_tile, double_buffer=s.double_buffer,
            with_embed=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], flat[0]), sc
        assert torch.equal(got[1], flat[1]), sc
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rung = fx.RUNGS[dtype]
    x = tiles
    for blk in pk["blocks"][:2]:
        want = fx.conv_block(lib, x, blk, rung, stream)
        for ct, db in ((64, False), (32, True)):
            got = fx.conv_block(lib, x, blk, rung, stream,
                                blocked=(8, ct, db))
            torch.cuda.synchronize()
            assert _same(got, want), (blk["w"].shape[0], ct)
        x = want


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
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


# -- escalation plans ---------------------------------------------------------
# (strategy, image (H, W), tile, the k to hold, or None for 1 to the cap):
# random_grid at tile 32, 64 and 128 on 256 images (64, 16 and 4 cells),
# random on a square and a non-square image, fixed on 256 and a 3 x 3 grid
PLAN_GEOMS = [("random_grid", (256, 256), 32, None),
              ("random_grid", (256, 256), 64, None),
              ("random_grid", (256, 256), 128, None),
              ("random", (256, 256), 64, (1, 2, 3, 4, 8, 33)),
              ("random", (40, 32), 16, (1, 2, 3, 5)),
              ("fixed", (256, 256), 64, None),
              ("fixed", (48, 48), 16, None)]


def _plan_keys(n: int, seed: int) -> torch.Tensor:
    """(n, 2) int64 uint32 words on the CPU, the words 0 and 0xFFFFFFFF
    in the first rows."""
    w = np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2),
                                             dtype=np.uint64)
    m = min(n, 3)
    w[:m] = np.array([(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0, 0xFFFFFFFF)],
                     np.uint64)[:m]
    return torch.as_tensor(w.astype(np.int64))


@pytest.mark.parametrize("n", [0, 1, 192, 256, 1000])
@pytest.mark.parametrize("strategy,hw,tile,ks", PLAN_GEOMS)
def test_plan_kernel_equals_plain(dev, strategy, hw, tile, ks, n):
    """The kernel's plan equals ``tiling.escalation_offsets`` on the same
    keys on the CPU, bit for bit, at every k (up to the cap, which raises
    one past it as the plain version does): an int32 contiguous plan on
    the keys' device, one launch a call (none for no rows)."""
    keys = _plan_keys(n, seed=n + tile)
    kd = keys.to(dev)
    cap = tiling.max_escalation_tiles(strategy, hw, tile)
    for k in (range(1, cap + 1) if ks is None else ks):
        ops.reset_launch_counts()
        got = ops.escalation_plan(strategy, kd, hw, tile, k)
        assert ops.launch_counts()["escalation_plan"] == (1 if n else 0)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert got.device == kd.device and got.shape == (n, k, 2)
        want = tiling.escalation_offsets(strategy, keys, hw, tile, k)
        assert torch.equal(got.cpu(), want), k
    if ks is None:
        ops.reset_launch_counts()
        with pytest.raises(ValueError, match="at most") as mine:
            ops.escalation_plan(strategy, kd, hw, tile, cap + 1)
        with pytest.raises(ValueError) as plain:
            tiling.escalation_offsets(strategy, keys, hw, tile, cap + 1)
        assert str(mine.value) == str(plain.value)
        assert ops.launch_counts()["escalation_plan"] == 0


@pytest.mark.parametrize("hw,tile,ks", [
    ((128, 128), 2, (2, 7, 4096)),   # 4,096 cells: two sort rounds, 48 KB
    ((256, 256), 2, (2, 9)),         # 16,384 cells: 192 KB of shared memory
    ((512, 512), 2, (2,))])          # 65,536 cells: the scratch buffer
def test_plan_kernel_large_grids(dev, hw, tile, ks):
    keys = _plan_keys(3, seed=tile)
    for k in ks:
        got = ops.escalation_plan("random_grid", keys.to(dev), hw, tile, k)
        torch.cuda.synchronize()
        want = tiling.escalation_offsets("random_grid", keys, hw, tile, k)
        assert torch.equal(got.cpu(), want), (hw, k)
