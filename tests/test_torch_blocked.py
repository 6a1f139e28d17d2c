"""PyTorch port: the blocked decode's fp32 / bf16 conv kernel and the head
kernel (``src/repro_torch/kernels/csrc/extractor.cuh``), modelled on the
CPU, where no CUDA kernel runs.

* A numpy model of ``conv_blocked_kernel`` at fp32 and bf16
  (``conv_blocked_rt``), thread for thread: the grid (``bk_blocks``)
  and each block's images and region (``bk_region``), the four 8x8
  slots a round and the (image, subtile) pair of each, each slot's halo
  as the kernel lays it out (pitch ``rt_pitch(cin)``, zero outside the
  image, bf16-rounded), the thread's slot row of 8 pixels and its
  register columns (``rt_column``) in each channel-tile pass, the
  weight slice staged once a block (or, fp32 at ct = C = 64, the
  three-slot ring), db's prefetch of the next slice tap by tap over the
  one just used, and ``rt_tap``'s
  chain (a fresh partial over the input channels in order by fmaf, the
  taps folded in [ky, kx] order).  Its pre-norm output equals the plain
  blocked conv (``conv3x3_mm`` with the channel tile, the body of
  ``fused_extractor_blocked_plain``) bit for bit, each output is written
  once, idle slots of a ragged block write nothing, and its epilogue
  (``norm_relu`` in channel order) agrees with the plain
  ``relu(channel_norm(.))`` within 1e-5 absolute (a few float32 ulps of
  O(1) outputs: the kernel sums the channel mean and variance in channel
  order and takes 1 / sqrt, torch does neither).  With the model in
  place of the hidden convs on the whole batch (its grid, masking and
  all), the decode's logits and embedding equal
  ``fused_extractor_blocked_plain``'s (which pads the batch to a
  multiple of bb) bit for bit.  The fmaf model rounds a float64 product
  and sum to float32: the product of two floats is exact in float64, and
  torch's CPU matmul gives these same bits (the last test checks it).
* A numpy model of the head kernel's shared-memory sum: the block's
  float4 copies of its image's partials, HEAD_TILES tiles a chunk, then
  thread n's sum of column n in tile order, equals the first design's
  chain over global memory bit for bit.

The expressions the models copy are checked against the source text.
The card tests (``tests/test_torch_cuda.py``, ``-m gpu``) hold the
kernels themselves to the flat kernels bit for bit.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import extractor as ex
from repro_torch.kernels import _build
from repro_torch.kernels import fused_extractor as fx

torch.set_num_threads(1)

SRC = (_build.CSRC / "extractor.cuh").read_text()
FLAT = " ".join(SRC.split())
F32 = np.float32


def _consts():
    m = re.search(r"constexpr int BS = (\d+), BSLOTS = (\d+), "
                  r"BHW = BS \+ 2, BTM = BS;", SRC)
    h = re.search(r"constexpr int HEAD_THREADS = (\d+), HEAD_TILES = (\d+);",
                  SRC)
    k = re.search(r"constexpr int kMaxSmem = (\d+);", SRC)
    r = re.search(r"constexpr int TM = 8, TN = 8, RSTAGES = (\d+);", SRC)
    assert m and h and k and r
    return (int(m.group(1)), int(m.group(2)), int(h.group(1)),
            int(h.group(2)), int(k.group(1)), int(r.group(1)))


BS, BSLOTS, HEAD_THREADS, HEAD_TILES, MAX_SMEM, RSTAGES = _consts()
BHW = BS + 2   # a slot's halo side and row pitch (pixels)
BTM = BS       # pixels a thread owns: one slot row
NB = 60


def rt_pitch(cin: int) -> int:
    return (cin + 3) // 4 * 4 if cin % 4 else cin + 4


def bk_region(bb: int) -> int:
    return 1 if bb >= 4 else 2 if bb >= 2 else 4


def bk_blocks(b: int, l: int, bb: int) -> int:
    """The launch grid of the fp32 / bf16 blocked conv."""
    return -(-b // bb) * ((l // BS) * (l // BS) // bk_region(bb))


def bk_tile(ct: int):
    """(TNB columns a thread, NCG column groups, threads a block)."""
    tnb = 8 if ct >= 64 else 4
    return tnb, ct // tnb, BSLOTS * BS * (ct // tnb)


def bk_smem(C: int, ct: int, cin: int, elem: int):
    """(resident, bytes) of ``Bk<R, C, ct, cin>`` (elem: bytes a weight)."""
    slot = BHW * BHW * rt_pitch(cin)
    halo = BSLOTS * slot * 4
    stage = BSLOTS * BS * BS * (C + 1) * 4 if C == ct else 0
    w = (max(halo, stage) + 15) & ~15
    resident = w + 9 * cin * ct * elem <= MAX_SMEM
    return resident, w + (9 * cin * ct if resident else
                          RSTAGES * cin * ct) * elem


def test_source_constants():
    """The model runs on the kernel's constants: four 8 x 8 slots a
    round, 128 head threads, 32 tiles a head chunk, and the card's
    227 KB of dynamic shared memory a block."""
    assert (BS, BSLOTS, HEAD_THREADS, HEAD_TILES) == (8, 4, 128, 32)
    assert MAX_SMEM == 232448 and RSTAGES == 3


def test_model_index_math_is_the_kernels():
    """The expressions the models copy, as the kernel writes them."""
    for expr in (
            # the grid, the block's images and region, a slot's pair
            "return bb >= 4 ? 1 : bb >= 2 ? 2 : 4;",
            "return (b + bb - 1) / bb * ((l / BS) * (l / BS) / bk_region(bb));",
            "constexpr int smem = Bk<R, COUT, CT, CIN>::END;",
            "<<<bk_blocks(b, l, bb), BkTile<CT>::THREADS, smem, stream>>>(",
            "conv_blocked_rt<R, COUT, CT, CIN>(x, w, bias, out, b, l, bb, db);",
            "const int q = bk_region(bb), qw = q == 1 ? 1 : 2, "
            "qh = q == 4 ? 2 : 1;",
            "const int rcols = l / (BS * qw), regions = rcols * (l / (BS * qh));",
            "const int img0 = blockIdx.x / regions * bb, "
            "reg = blockIdx.x % regions;",
            "const int ry0 = reg / rcols * BS * qh, rx0 = reg % rcols * BS * qw;",
            "const int pairs = min(bb, b - img0) * q;",
            "const int rounds = (pairs + BSLOTS - 1) / BSLOTS;",
            "img = img0 + p / q; y0 = ry0 + (p % q) / qw * BS; "
            "x0 = rx0 + (p % q) % qw * BS; return p < pairs;",
            "if (origin(r * BSLOTS + s, img, y0, x0)) "
            "rt_load_halo<R, CIN, BHW, BHW>(x, s_in + s * K::SLOT, img, y0, "
            "x0, l);",
            # the thread tile
            "static constexpr int TNB = CT >= 64 ? 8 : 4;",
            "static constexpr int NCG = CT / TNB;",
            "static constexpr int THREADS = BSLOTS * BS * NCG;",
            "const int cg = threadIdx.x % T::NCG, pg = threadIdx.x / T::NCG;",
            "const int slot = pg / BS, row = pg % BS;",
            "const float* a0 = s_in + slot * K::SLOT + row * BHW * K::SIN;",
            "rt_tap<R, CT, CIN, BTM, T::TNB, 1>(a0 + (t / 3 * BHW + t % 3) * "
            "K::SIN, wt + 4 * cg, t, acc);",
            "return 4 * NCG * (n / 4) + 4 * (threadIdx.x % NCG) + n % 4;",
            "return cin % 4 ? (cin + 3) / 4 * 4 : cin + 4;",
            # the shared memory and where the slice fits
            "static constexpr int SLOT = BHW * BHW * SIN;",
            "static constexpr int HALO = BSLOTS * SLOT * 4;",
            "static constexpr int STAGE = NT == 1 ? BSLOTS * BS * BS * "
            "(COUT + 1) * 4 : 0;",
            "static constexpr int W = ((HALO > STAGE ? HALO : STAGE) + 15) "
            "& ~15;",
            "static constexpr int SLICE = 9 * CIN * CT * (int)sizeof(SW);",
            "static constexpr bool RESIDENT = W + SLICE <= kMaxSmem;",
            "W + (RESIDENT ? SLICE : RSTAGES * CIN * CT * (int)sizeof(SW));",
            # rt_tap's chain, the halo, the staging
            "a[m] = *reinterpret_cast<const float4*>(a0 + PSTEP * m * SIN + "
            "c4);",
            "wv[q] = load_w4(wt + (c4 + j) * NP + 4 * NCG * q);",
            "part[m][4 * q + 0] = fmaf(xv, wv[q].x, part[m][4 * q + 0]);",
            "acc[m][n] = tap == 0 ? part[m][n] : "
            "__fadd_rn(acc[m][n], part[m][n]);",
            "const int gy = y0 + hy - 1, gx = x0 + hx - 1;",
            "cp_async16_zfill(s_in + (hy * HP + hx) * SIN + 4 * q,",
            "s_in[(hy * HP + hx) * SIN + c] = v;",
            "const W* src = w + (long long)r * COUT + jt * CT + E * q; "
            "W* dst = s_w + r * CT + E * q;",
            "if (jt == 0 || !db) {",
            "stage_rows<R, COUT, CT>(w, s_w, 0, 9 * CIN, jt);",
            "const bool fresh = jt == 0 || rounds > 1;",
            "const bool prefetch = db && jt + 1 < K::NT && r + 1 == rounds;",
            "tap(t, s_w + t * CIN * CT, acc);",
            "stage_rows<R, COUT, CT>(w, s_w, t * CIN, (t + 1) * CIN, jt + 1);",
            "tap_fn(tap, s_w + (tap % RSTAGES) * WTAP);",
            "char* d = dst + r * NP * (int)sizeof(W) + q * CH;",
            # the stores and the epilogues
            "s_pre[(pg * BTM + m) * SP + rt_column<T::NCG>(n)] = acc[m][n];",
            "o[((long long)(p / BS) * l + p % BS) * COUT + co] = "
            "s_pre[(s * BS * BS + p) * SP + co];",
            "float* o = out + ((img * l + y0 + row) * l + x0) * COUT + "
            "jt * CT + 4 * cg;",
            "*reinterpret_cast<float4*>(o + m * COUT + 4 * T::NCG * g) = "
            "make_float4(acc[m][4 * g], acc[m][4 * g + 1], acc[m][4 * g + 2], "
            "acc[m][4 * g + 3]);",
            "origin(e / (BS * BS), img, y0, x0); const int p = e % (BS * BS); "
            "float* o = out + ((img * l + y0 + p / BS) * l + x0 + p % BS) * "
            "COUT;",
            # norm_relu's chain
            "sum = __fadd_rn(sum, __fadd_rn(pre(co), bias[co]));",
            "const float mu = __fdiv_rn(sum, (float)COUT);",
            "const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, "
            "1e-5f)));",
            # the head's chunks and sums
            "const int nt = min(HEAD_TILES, tiles - t0);",
            "const long long first = (img * tiles + t0) * NB / 4;",
            "s_part[e] = pg[e]; if (has_corr) s_part[CH4 + e] = pc[e];",
            "for (int t = 0; t < nt; ++t) sg = __fadd_rn(sg, "
            "s_gap[t * NB + n]);",
            "for (int t = 0; t < nt; ++t) sc = __fadd_rn(sc, "
            "s_corr[t * NB + n]);",
            "g[n] = __fdiv_rn(sg, (float)(l * l));",
            "head_kernel<typename R::H, NB><<<b, HEAD_THREADS, 0, stream>>>("):
        assert expr in FLAT, expr


def fmaf(x, w, acc):
    """CUDA's fmaf: x * w is exact in float64, one rounding of the sum
    (to float64, then float32)."""
    return (x.astype(np.float64) * w.astype(np.float64) +
            acc.astype(np.float64)).astype(F32)


def bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def norm_relu(pre: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """``norm_relu_to`` on rows (npix, C) of pre-norm outputs, in float32
    op for op: sums in channel order, 1 / sqrt."""
    C = pre.shape[1]
    y = [(pre[:, co] + bias[co]).astype(F32) for co in range(C)]
    s = np.zeros(pre.shape[0], F32)
    for co in range(C):
        s = (s + y[co]).astype(F32)
    mu = (s / F32(C)).astype(F32)
    ss = np.zeros_like(s)
    for co in range(C):
        d = (y[co] - mu).astype(F32)
        ss = (ss + (d * d).astype(F32)).astype(F32)
    var = (ss / F32(C)).astype(F32)
    rs = (F32(1) / np.sqrt((var + F32(1e-5)).astype(F32))).astype(F32)
    return np.stack([np.maximum(((y[co] - mu).astype(F32) * rs).astype(F32),
                                F32(0)) for co in range(C)], axis=1)


def model_launch(x, w, bias, *, bb, ct, db, rung):
    """One ``conv_blocked_kernel`` launch at fp32 / bf16 on x (b, l, l,
    cin) with the packed weight w (9 * cin, C) (bf16: its values) and
    bias (C,): (pre-norm output, output, writes per output)."""
    b, l, _, cin = x.shape
    C = w.shape[1]
    NT = C // ct
    tnb, ncg, threads = bk_tile(ct)
    sin = rt_pitch(cin)
    slot_f = BHW * BHW * sin
    resident, _ = bk_smem(C, ct, cin, 4 if rung == "fp32" else 2)
    if rung == "bf16":
        x = bf16(x)  # the halo, rounded in place once it lands
    xpad = np.pad(x.astype(F32), ((0, 0), (1, 1), (1, 1), (0, 0)))
    q = bk_region(bb)
    qw, qh = (1 if q == 1 else 2), (2 if q == 4 else 1)
    rcols = l // (BS * qw)
    regions = rcols * (l // (BS * qh))
    grid = bk_blocks(b, l, bb)
    pre = np.full((b, l, l, C), np.nan, F32)
    writes = np.zeros((b, l, l, C), np.int64)
    t = np.arange(threads)
    cg, pg = t % ncg, t // ncg
    slot, row = pg // BS, pg % BS
    # rt_tap's weight offset of register column n, beyond wt + 4 * cg
    wcol = np.array([4 * ncg * (n // 4) + n % 4 for n in range(tnb)])
    col = 4 * cg[:, None] + wcol[None, :]  # rt_column: (threads, tnb)
    m_ = np.arange(BTM)
    wflat = w.astype(F32)
    for blk in range(grid):
        img0, reg = blk // regions * bb, blk % regions
        ry0, rx0 = reg // rcols * BS * qh, reg % rcols * BS * qw
        pairs = min(bb, b - img0) * q
        rounds = -(-pairs // BSLOTS)

        def origin(p):
            return (img0 + p // q, ry0 + (p % q) // qw * BS,
                    rx0 + (p % q) % qw * BS, p < pairs)

        s_w = np.full(9 * cin * ct, np.nan, F32)  # NaN: never staged

        def stage(r0, r1, jt):  # stage_rows
            s_w[r0 * ct: r1 * ct] = wflat[r0:r1, jt * ct:(jt + 1) * ct] \
                .reshape(-1)

        s_in = np.full(BSLOTS * slot_f, np.nan, F32)
        slot_rows = s_in.reshape(BSLOTS, BHW, BHW, sin)  # a view
        for jt in range(NT):
            if resident and (jt == 0 or not db):
                stage(0, 9 * cin, jt)
            for r in range(rounds):
                if not resident or jt == 0 or rounds > 1:  # fresh halos
                    s_in[:] = np.nan
                    for s in range(BSLOTS):
                        img, y0, x0, act = origin(r * BSLOTS + s)
                        if act:  # halo pixel (hy, hx) is x[y0+hy-1, x0+hx-1]
                            slot_rows[s, :, :, :cin] = \
                                xpad[img, y0:y0 + BHW, x0:x0 + BHW]
                prefetch = resident and db and jt + 1 < NT and \
                    r + 1 == rounds
                acc = None
                for tap in range(9):
                    if resident:
                        wt = tap * cin * ct + 4 * cg
                        src = s_w
                    else:  # the ring slot of the tap, pitch NP = ct
                        src = wflat[tap * cin:(tap + 1) * cin].reshape(-1)
                        wt = 4 * cg
                    a0 = slot * slot_f + row * BHW * sin + \
                        (tap // 3 * BHW + tap % 3) * sin
                    part = np.zeros((threads, BTM, tnb), F32)
                    for c in range(cin):
                        xv = s_in[a0[:, None] + m_[None, :] * sin + c]
                        wv = src[wt[:, None] + c * ct + wcol[None, :]]
                        part = fmaf(xv[:, :, None], wv[:, None, :], part)
                    acc = part if tap == 0 else (acc + part).astype(F32)
                    if prefetch:  # tap t of slice jt + 1 over tap t
                        stage(tap * cin, (tap + 1) * cin, jt + 1)
                # each thread's stores: its slot row, BTM pixels by its
                # tnb register columns
                img, y0, x0, act = (np.array(v) for v in zip(*(
                    origin(r * BSLOTS + sl) for sl in range(BSLOTS))))
                th = np.nonzero(act[slot])[0]
                idx = (img[slot[th]][:, None, None],
                       (y0[slot[th]] + row[th])[:, None, None],
                       (x0[slot[th]][:, None] + m_[None, :])[:, :, None],
                       (jt * ct + col[th])[:, None, :])
                pre[idx] = acc[th]
                np.add.at(writes, idx, 1)
    out = norm_relu(pre.reshape(-1, C), bias).reshape(pre.shape)
    return pre, out, writes


def _case(seed, b, l, cin, C, rung):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.5, (b, l, l, cin)).astype(F32)
    w = (rng.standard_normal((9 * cin, C)) * 0.2).astype(F32)
    if rung == "bf16":
        w = bf16(w)
    bias = (rng.standard_normal(C) * 0.1).astype(F32)
    return x, w, bias


def _plain_pre(x, w, ct, rung):
    """The plain blocked conv (bias and norm not yet applied)."""
    wt = torch.from_numpy(w).to(torch.bfloat16 if rung == "bf16"
                                else torch.float32)
    b, l = x.shape[0], x.shape[1]
    return ex.conv3x3_mm(torch.from_numpy(x), wt, channel_tile=ct) \
        .numpy().reshape(b, l, l, -1)


def _hold(x, w, bias, bb, ct, db, rung):
    pre, out, writes = model_launch(x, w, bias, bb=bb, ct=ct, db=db,
                                    rung=rung)
    assert (writes == 1).all()
    want = _plain_pre(x, w, ct, rung)
    assert np.array_equal(pre.view(np.int32), want.view(np.int32))
    y = torch.from_numpy(want + bias)
    ref = torch.relu(ex.channel_norm(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rung", ["fp32", "bf16"])
@pytest.mark.parametrize("l,bb", [(16, 2), (16, 4), (32, 2), (32, 4)])
@pytest.mark.parametrize("ct", fx.blocked_channel_tiles(16))
@pytest.mark.parametrize("db", [True, False])
def test_model_equals_plain_blocked_conv(rung, l, bb, ct, db):
    """C 16, b 5 (ragged at bb 2 and 4), layer 0 (cin 3) and a 16 -> 16
    block: the model's pre-norm output equals the plain blocked conv bit
    for bit, each output written once; its norm within 1e-5 of torch's."""
    for cin in (3, 16):
        x, w, bias = _case(l * 100 + bb * 10 + ct + cin, 5, l, cin, 16, rung)
        _hold(x, w, bias, bb, ct, db, rung)


@pytest.mark.parametrize("bb", [1, 3, 8])
def test_model_every_region_shape(bb):
    """The other region shapes: bb 1 (a 16x16 region of one image), 3 (an
    8x16 region, two rounds, the second half idle) and 8 > b (one group,
    two rounds, part idle), C 16, b 5, l 32, ct 8 with db."""
    x, w, bias = _case(bb, 5, 32, 16, 16, "fp32")
    _hold(x, w, bias, bb, 8, True, "fp32")


@pytest.mark.parametrize("rung", ["fp32", "bf16"])
def test_model_full_width_slices(rung):
    """C 64 (b 2, l 16, bb 4): at fp32 ct = 64 the weights stream through
    the ring, at ct = 32 and at bf16 ct = 64 the slice is resident."""
    for ct in (64, 32):
        resident, nbytes = bk_smem(64, ct, 64, 4 if rung == "fp32" else 2)
        assert nbytes <= MAX_SMEM
        assert resident == (rung == "bf16" or ct < 64)
        x, w, bias = _case(ct, 2, 16, 64, 64, rung)
        _hold(x, w, bias, 4, ct, True, rung)


@pytest.mark.parametrize("rung", ["fp32", "bf16"])
@pytest.mark.parametrize("ct", [24, 12])
def test_model_trainer_width(rung, ct):
    """C 24, the trainer's width (b 3, l 16, bb 2, ragged): layer 0 and a
    24 -> 24 block at ct = C and at ct 12 (bf16: 24-byte weight rows,
    staged in 8-byte chunks)."""
    for cin in (3, 24):
        x, w, bias = _case(ct + cin, 3, 16, cin, 24, rung)
        _hold(x, w, bias, 2, ct, True, rung)


def test_grid_fills_the_card_and_every_slice_fits():
    """At b = 32, l = 64 every candidate batch block gives at least 132
    blocks (the H100's SMs); every instantiation's shared memory fits;
    the slice is resident everywhere but fp32 ct = C = 64."""
    for bb in (1, 2, 3, 4, 8):
        assert bk_blocks(32, 64, bb) >= 132
    for C in fx.HIDDEN_CHANNELS:
        for ct in fx.blocked_channel_tiles(C):
            for cin in (3, C):
                for elem in (4, 2):
                    resident, nbytes = bk_smem(C, ct, cin, elem)
                    assert nbytes <= MAX_SMEM
                    assert resident or (C, ct, cin, elem) == (64, 64, 64, 4)


@pytest.mark.parametrize("rung", ["fp32", "bf16"])
@pytest.mark.parametrize("bb,ct", [(2, 0), (4, 8), (3, 4)])
def test_model_decode_equals_blocked_plain(monkeypatch, rung, bb, ct):
    """The decode with the model in place of every hidden conv, on the
    whole ragged batch (b 5, C 16, D 3, l 32, correlation bank), equals
    ``fused_extractor_blocked_plain`` bit for bit, logits and embedding."""
    pk = ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=NB, channels=16, depth=3, tile=32, bias_scale=0.1)), rung)
    tiles = torch.as_tensor(np.random.default_rng(9).uniform(
        -2.0, 2.5, (5, 32, 32, 3)).astype(F32))
    want = fx.fused_extractor_blocked_plain(
        tiles, pk, batch_block=bb, channel_tile=ct, with_embed=True)
    plain_conv = ex.conv3x3_mm
    ct_ = ct or 16

    def conv(x, w2d, scale=None, channel_tile=0):
        if w2d.shape[1] == NB:  # to_bits: the flat kernel's
            return plain_conv(x, w2d, scale, channel_tile)
        assert channel_tile == ct_
        pre, _, writes = model_launch(
            x.numpy(), w2d.float().numpy(), np.zeros(16, F32), bb=bb,
            ct=ct_, db=True, rung=rung)
        assert (writes == 1).all()
        return torch.from_numpy(pre.reshape(-1, w2d.shape[1]))

    monkeypatch.setattr(ex, "conv3x3_mm", conv)
    got = ex.extractor_forward_packed_embed(pk, tiles, ct_)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32),
                              w.numpy().view(np.int32))


def test_fmaf_model_is_torch_matmul():
    """The fmaf chain the model runs gives torch's CPU matmul bits on
    these shapes (one tap's dot of a 16 -> 16 block and of layer 0)."""
    rng = np.random.default_rng(3)
    for k, n in ((16, 16), (3, 8), (64, 32)):
        x = rng.uniform(-2, 2, (512, k)).astype(F32)
        w = rng.standard_normal((k, n)).astype(F32)
        part = np.zeros((512, n), F32)
        for c in range(k):
            part = fmaf(x[:, c:c + 1], w[c:c + 1], part)
        want = (torch.from_numpy(x) @ torch.from_numpy(w)).numpy()
        assert np.array_equal(part.view(np.int32), want.view(np.int32))


def model_head_sums(part: np.ndarray, b: int, tiles: int) -> np.ndarray:
    """The head kernel's sums: per image, chunks of HEAD_TILES tiles
    copied as float4s (flat indices 4 e .. 4 e + 3 of the chunk) into
    shared memory, then thread n adds column n of each tile in order."""
    flat = part.reshape(-1)
    out = np.zeros((b, NB), F32)
    for img in range(b):
        s = np.zeros(NB, F32)
        for t0 in range(0, tiles, HEAD_TILES):
            nt = min(HEAD_TILES, tiles - t0)
            first = (img * tiles + t0) * NB // 4
            smem = np.empty(HEAD_TILES * NB, F32)
            for e in range(nt * NB // 4):
                smem[4 * e: 4 * e + 4] = flat[4 * (first + e): 4 * (first + e)
                                              + 4]
            for t in range(nt):
                s = (s + smem[t * NB: (t + 1) * NB]).astype(F32)
        out[img] = s
    return out


@pytest.mark.parametrize("l", [16, 64, 128])
def test_head_shared_sum_is_the_tile_chain(l):
    """Tiles of 8 x 16 pixels: 2 (l 16, one part chunk), 32 (l 64, one
    full chunk) and 128 (l 128, four chunks): the shared-memory sums
    equal the first design's chain, tile after tile from global memory,
    bit for bit; GAP is that sum / l^2 (the plain mean agrees within
    1e-6 relative: it sums in another order)."""
    tiles, b = (l // 8) * (l // 16), 3
    part = np.random.default_rng(l).standard_normal(
        (b * tiles, NB)).astype(F32)
    chain = np.zeros((b, NB), F32)
    for img in range(b):
        for t in range(tiles):
            chain[img] = (chain[img] + part[img * tiles + t]).astype(F32)
    got = model_head_sums(part, b, tiles)
    assert np.array_equal(got.view(np.int32), chain.view(np.int32))
    g = (got / F32(l * l)).astype(F32)
    mean = part.reshape(b, tiles, NB).astype(np.float64).sum(1) / (l * l)
    np.testing.assert_allclose(g, mean, rtol=1e-6, atol=1e-9)
