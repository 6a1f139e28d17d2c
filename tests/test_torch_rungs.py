"""PyTorch port: the bf16 and int8 decode rungs against the JAX package,
at small size.

* the quantizers exactly: int8 values and scales equal the jitted
  reference's for activations (``quantize_rows_int8``, whose ``/ 127``
  XLA turns into a multiply by float32(1/127)) and the eager
  reference's for weights (``quantize_weight_int8``, true division, as
  ``pack_params`` runs at registry build);
* ``pack_params`` leaf for leaf, ``unpack_params`` equal to the
  reference's, and pack -> unpack -> pack exact, at every dtype;
* the plain flat decode against ``repro.kernels.ops.fused_extractor``
  (Pallas, interpret mode), with and without the embedding (bitwise
  the same logits), and the
  plain blocked decode against the reference's blocked kernel at a
  channel tile below C on a ragged batch (tile 16, channels 8,
  depth 2);
* ``detect_batch`` at ``mode="qrmark"`` for both rungs on the flat and
  a blocked schedule (tile 16, img 32, channels 8, depth 2), against
  the reference's pipeline at the rung (flat schedule; the reference
  holds its blocked schedule to it) on the same raw batch and keys:
  offsets
  exact; on the rows whose |logits| all clear the tolerance, RS ``ok``
  and ``n_corrected`` exact and messages exact where ``ok``.  The head
  bias carries a codeword with one symbol error, so rows decode with
  one correction.

Logits and embeddings within RUNG_ATOL = 0.02 absolute, below the JAX
package's own rung bounds (bf16 0.05 against fp32; int8 0.15 + 5 %
against the dequantized-weight oracle).  Observed on the CPU at these
sizes: at most 2.4e-6; at full width 1.0e-3 (bf16) and 1.3e-4 (int8),
where the fp32 sums of the two stacks differ by an ulp and a bf16
rounding or an int8 quantization lands one step apart.

The reference's pipelines use ``jax_rs`` as their device RS engine
(patched in for this module), which the JAX package's own tests hold
bit-equal to its Pallas RS kernel, and which compiles in a second
instead of fifteen.  Nothing in the JAX package changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extractor as jex
from repro.core import stages as jstages
from repro.core import tiling as jtiling
from repro.core.detect import DetectionConfig as JConfig
from repro.core.detect import DetectionPipeline as JPipeline
from repro.core.rs import jax_rs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_extractor import fused_extractor_blocked as jblocked
from repro_torch.core import extractor as ex
from repro_torch.core import tiling
from repro_torch.core.detect import DetectionConfig, DetectionPipeline
from repro_torch.core.rs import codec
from repro_torch.kernels import fused_extractor as fx
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

RUNG_ATOL = 0.02
L, C, DEPTH = 16, 8, 2
SMALL = dict(tile=16, img_size=32, resize_src=40)


def _params(margin=0.0):
    p = ex.init_extractor_numpy(0, n_bits=60, channels=C, depth=DEPTH,
                                tile=L, bias_scale=0.1)
    if margin:
        rng = np.random.default_rng(7)
        cw = codec.rs_encode(codec.DEFAULT_CODE,
                             rng.integers(0, 2, 48)).copy()
        cw[5] ^= 1
        p["head"]["b"] = (p["head"]["b"] + margin * (2 * cw - 1)).astype(
            np.float32)
    return p


def _tiles(b, seed=1):
    return np.random.default_rng(seed).uniform(
        -2.0, 2.5, (b, L, L, 3)).astype(np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


# -- quantizers -------------------------------------------------------------
def test_quantize_rows_matches_jitted_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4000, 16)) *
         rng.uniform(0.0, 3.0, (4000, 1))).astype(np.float32)
    x[0] = 0.0                                   # a padding row
    x[1] = np.arange(16, dtype=np.float32) - 7.5  # halves on the grid
    x[2, :] = np.float32(-2.0)
    jq, js = jax.jit(jex.quantize_rows_int8)(jnp.asarray(x))
    tq, ts = ex.quantize_rows_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_weight_matches_eager_reference():
    w = (np.random.default_rng(1).standard_normal((9 * 8, 16)) *
         0.1).astype(np.float32)
    w[:, 3] = 0.0
    jq, js = jex.quantize_weight_int8(jnp.asarray(w))
    tq, ts = ex.quantize_weight_int8(torch.as_tensor(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_pack_matches_reference_and_round_trips(dtype):
    """Leaf for leaf the reference's pack (bf16 compared as its exact
    float32 values), the reference's unpack, and pack(unpack(pack))
    equal to the pack."""
    p = _params()
    jpk = jex.pack_params(jax.tree.map(jnp.asarray, p), dtype)
    tpk = ex.pack_params(ex.params_from_numpy(p), dtype)
    assert ex.packed_dtype(tpk) == dtype
    assert [pa for pa, _ in _leaves(jpk)] == \
        [pa for pa, _ in _leaves(ex.params_to_numpy(tpk))]
    for (_, a), b in zip(_leaves(jpk), jax.tree.leaves(tpk)):
        assert str(a.dtype) == {torch.bfloat16: "bfloat16"}.get(
            b.dtype, str(b.dtype).replace("torch.", ""))
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      b.double().numpy())
    up = ex.unpack_params(tpk)
    for (_, a), b in zip(_leaves(jex.unpack_params(jpk)),
                         jax.tree.leaves(up)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(ex.pack_params(up, dtype)),
                    jax.tree.leaves(tpk)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_check_pack_takes_each_rung_and_refuses_mixed_packs():
    """The CUDA wrappers' pack check (device-independent): the rung id
    of each pack, and a ValueError for leaves of another rung."""
    tiles = torch.zeros((2, L, L, 3))
    p = ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=16, depth=2, tile=L))
    packs = {d: ex.pack_params(p, d) for d in ("fp32", "bf16", "int8")}
    for dtype, pk in packs.items():
        assert fx._check_pack(tiles, pk) == fx.RUNGS[dtype]
    bad = [dict(packs["bf16"], head=packs["fp32"]["head"]),
           dict(packs["int8"], corr=packs["bf16"]["corr"]),
           dict(packs["int8"], to_bits=packs["fp32"]["to_bits"]),
           dict(packs["fp32"], to_bits=packs["int8"]["to_bits"])]
    for pk in bad:
        with pytest.raises(ValueError):
            fx._check_pack(tiles, pk)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("where", ["blocks", "to_bits"])
def test_check_pack_refuses_unaligned_conv_weights(dtype, where):
    """The decode kernels copy conv weights in 16-byte chunks: a pack
    whose conv weight starts off a 16-byte boundary is refused, as is a
    tile size the 16x16 pixel tiles do not divide."""
    tiles = torch.zeros((2, L, L, 3))
    pk = ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=16, depth=2, tile=L)), dtype)
    assert fx._check_pack(tiles, pk) == fx.RUNGS[dtype]
    entry = pk["blocks"][1] if where == "blocks" else pk["to_bits"]
    w = entry["w"]
    shifted = torch.empty(w.numel() + 16, dtype=w.dtype)
    off = next(k for k in range(1, 16)
               if (shifted.data_ptr() + k * w.element_size()) % 16)
    entry["w"] = shifted[off: off + w.numel()].view(w.shape)
    entry["w"].copy_(w)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fx._check_pack(tiles, pk)
    entry["w"] = w
    with pytest.raises(ValueError, match="multiple of 16"):
        fx._check_pack(torch.zeros((2, 24, 24, 3)), pk)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_kernel_names_name_instantiated_kernels(dtype):
    """The names under which the decode's per-layer launchers count
    their launches (``kernel_launches``) are those of ``__global__``
    templates in the CUDA sources, with as many template arguments and
    a rung type the sources define; the flat and blocked schedules
    count distinct kernels (to_bits is the flat one on both), no name is
    a quantize pass's, and a reset clears the counts."""
    import re
    from repro_torch.kernels import _build, ops
    src = "".join(f.read_text() for f in sorted(_build.CSRC.glob("*.cu*")))
    rung = fx.RUNGS[dtype]
    names = {fx.head_kernel_name(rung, 60)}
    for c in fx.HIDDEN_CHANNELS:
        names |= {fx.conv_kernel_name(rung, cin, c) for cin in (3, c)}
        names |= {fx.conv_kernel_name(rung, c, c, ct)
                  for ct in fx.blocked_channel_tiles(c)}
        names.add(fx.to_bits_kernel_name(rung, c, 60))
    assert not any("quantize" in n for n in names)
    assert "quantize_rows_kernel" not in src
    for name in names:
        fn, _, args = name.partition("<")
        decl = re.search(r"template\s*<([^>]*)>\s*__global__ void\s*"
                         r"(?:__launch_bounds__\(.*\)\s*)?" + fn + r"\(",
                         src)
        if not args:
            assert re.search(r"__global__ void " + fn + r"\(", src), name
            continue
        assert decl, name
        args = args.rstrip(">").split(",")
        assert len(args) == len(decl.group(1).split(",")), name
        typ = args[0].removeprefix("qr::")
        assert re.search(r"struct " + typ + r"\b", src) or \
            typ in ("float", "__nv_bfloat16") or typ.isdigit(), name
    assert fx.conv_kernel_name(rung, 64, 64) != \
        fx.conv_kernel_name(rung, 64, 64, 64)
    _build.kernel_launches["x"] = 1
    ops.reset_launch_counts()
    assert ops.kernel_launch_counts() == {}


# ``ptxas -v`` lines of three kernels as nvcc prints them for sm_90a (one
# with its own stack frame and spills, one in an anonymous namespace)
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN2qr16conv_imma_kernelILi64ELi64EEEvPKvPKfPK4int2S4_S4_PiPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN2qr16conv_imma_kernelILi64ELi64EEEvPKvPKfPK4int2S4_S4_PiPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2qr24conv_blocked_imma_kernelILi16ELi16ELi4EEEvPKvPKfPK4int2S4_S4_PiPfS9_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN2qr24conv_blocked_imma_kernelILi16ELi16ELi4EEEvPKvPKfPK4int2S4_S4_PiPfS9_iiii
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__730f3e01_12_rs_decode_cu_979a838825rs_syndrome_decode_kernelEPKiPiS2_PbS2_i' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__730f3e01_12_rs_decode_cu_979a838825rs_syndrome_decode_kernelEPKiPiS2_PbS2_i
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 4896 bytes smem
"""


def test_ptxas_log_is_read_per_kernel():
    """``_build.kernel_registers`` (the registers, spills and stack that
    ``chip_smoke.py`` checks and the sweep tools print): each kernel's
    own frame and spills, its cumulative stack, names demangled without
    their arguments and found by the names the launchers count under."""
    from repro_torch.kernels import _build
    regs = _build.kernel_registers(PTXAS_LOG)
    assert sorted(regs) == [
        "(anonymous namespace)::rs_syndrome_decode_kernel",
        "qr::conv_blocked_imma_kernel<16, 16, 4>",
        "qr::conv_imma_kernel<64, 64>"]
    i8 = fx.RUNGS["int8"]
    assert _build.registers_of(regs, fx.conv_kernel_name(i8, 64, 64)) == \
        (118, 0, 0, 0, 0)
    assert _build.registers_of(regs, fx.conv_kernel_name(i8, 16, 16, 4)) \
        == (48, 16, 12, 16, 16)
    assert _build.registers_of(regs, "rs_syndrome_decode_kernel") == \
        (40, 0, 0, 0, 0)
    assert _build.registers_of(regs, "conv_") is None  # not one kernel

def test_both_schedules_refuse_the_same_tile_sizes():
    """One pixel-tile rule for both schedules: l a multiple of 16."""
    for tile in (16, 32, 48, 64):
        fx.check_tile(tile)
        fx.check_blocked_schedule(channels=16, tile=tile, channel_tile=0)
    for tile in (8, 24, 40):
        with pytest.raises(ValueError, match="multiple of 16"):
            fx.check_tile(tile)
        with pytest.raises(ValueError, match="multiple of 16"):
            fx.check_blocked_schedule(channels=16, tile=tile,
                                      channel_tile=0)


# -- the decode kernels' plain versions ----------------------------------------
@pytest.fixture(scope="module", params=["bf16", "int8"])
def rung(request):
    """The reference's flat kernel (with the embedding output; its
    logits are bitwise the same without) and its blocked kernel (bb2-ct4
    on a ragged batch of 5), computed once per rung."""
    dtype = request.param
    p = _params()
    jpk = jex.pack_params(jax.tree.map(jnp.asarray, p), dtype)
    tiles = _tiles(5)
    jt = jnp.asarray(tiles)
    ref = {"flat": [np.asarray(a) for a in
                    jops.fused_extractor(jt, jpk, with_embed=True)],
           "blocked": [np.asarray(a) for a in jblocked(
               jt, jpk, batch_block=2, channel_tile=4, with_embed=True)]}
    return dtype, ex.pack_params(ex.params_from_numpy(p), dtype), tiles, ref


def test_plain_flat_matches_reference_kernel(rung):
    _, pk, tiles, ref = rung
    t = torch.as_tensor(tiles)
    logits, g = fx.fused_extractor_plain(t, pk, with_embed=True)
    alone = fx.fused_extractor_plain(t, pk)
    assert torch.equal(alone, logits)
    for got, want in ((logits, ref["flat"][0]), (g, ref["flat"][1])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RUNG_ATOL)


def test_plain_blocked_matches_reference_kernel(rung):
    _, pk, tiles, ref = rung
    got = fx.fused_extractor_blocked_plain(torch.as_tensor(tiles), pk,
                                           batch_block=2, channel_tile=4,
                                           with_embed=True)
    for g, want in zip(got, ref["blocked"]):
        assert g.shape == want.shape == (5, 60)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=RUNG_ATOL)


def test_int8_dequant_oracle():
    """The port's oracle equals the reference's at the fp32 tolerance,
    and the int8 rung sits within the reference's bound of it."""
    p, tiles = _params(), _tiles(5)
    jpk = jex.pack_params(jax.tree.map(jnp.asarray, p), "int8")
    want = np.asarray(jax.jit(jref.fused_extractor_int8_ref)(
        jpk, jnp.asarray(tiles)))
    pk = ex.pack_params(ex.params_from_numpy(p), "int8")
    t = torch.as_tensor(tiles)
    oracle = tref.fused_extractor_int8_ref(pk, t).numpy()
    np.testing.assert_allclose(oracle, want, rtol=0,
                               atol=1e-4 * (1 + np.abs(oracle).max()))
    np.testing.assert_allclose(fx.fused_extractor_plain(t, pk).numpy(),
                               oracle, rtol=0.05, atol=0.15)


# -- detect_batch at each rung --------------------------------------------
SCHEDULES = ("flat", "bb2-ct4-db")


@pytest.fixture(scope="module")
def jax_rs_engine():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstages, "make_device_rs", jax_rs.make_batch_decoder)
        yield


@pytest.fixture(scope="module", params=["bf16", "int8"])
def run(request, jax_rs_engine):
    """One raw batch through the reference's pipeline at the rung (flat
    schedule) and through the port's on each schedule."""
    dtype = request.param
    p = _params(margin=4.0)
    raw = np.random.default_rng(3).integers(0, 256, (6, 64, 64, 3),
                                            dtype=np.uint8)
    jpipe = JPipeline(JConfig(**SMALL, decode_dtype=dtype),
                      jax.tree.map(jnp.asarray, p))
    ports = {s: DetectionPipeline(DetectionConfig(**SMALL, decode_dtype=dtype,
                                                  decode_schedule=s),
                                  ex.params_from_numpy(p), device="cpu")
             for s in SCHEDULES}
    try:
        yield (jpipe, jpipe.detect_batch(jnp.asarray(raw)), ports,
               {s: pipe.detect_batch(raw) for s, pipe in ports.items()})
    finally:
        for pipe in ports.values():
            pipe.close()
        jpipe.close()


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_detect_batch_matches_reference(run, schedule):
    jpipe, j, ports, outs = run
    tpipe, t = ports[schedule], outs[schedule]
    cfg = tpipe.cfg
    assert tpipe.stages.packed_params["blocks"][0]["w"].dtype == \
        ex.DECODE_DTYPES[cfg.decode_dtype]
    assert (tpipe.stages.decode_schedule is None) == (schedule == "flat")
    hw = (cfg.img_size, cfg.img_size)
    keys = tpipe.stages.image_keys(tpipe.stages.batch_key(0), 6)
    jkeys = jpipe.stages.image_keys(jpipe.stages.batch_key(0), 6)
    np.testing.assert_array_equal(
        tiling.per_image_offsets(cfg.strategy, keys, hw, cfg.tile).numpy(),
        np.asarray(jtiling.per_image_offsets(cfg.strategy, jkeys, hw,
                                             cfg.tile)))
    np.testing.assert_allclose(t["logits"], j["logits"], rtol=0,
                               atol=RUNG_ATOL)
    margined = np.abs(j["logits"]).min(axis=1) > RUNG_ATOL
    assert margined.sum() >= 4
    for k in ("ok", "n_corrected"):
        np.testing.assert_array_equal(t[k][margined], j[k][margined])
    ok = j["ok"] & margined
    assert ok.any()
    np.testing.assert_array_equal(t["message_bits"][ok],
                                  j["message_bits"][ok])
