"""PyTorch port: the blocked decode schedule and its autotune harness
(``repro_torch.kernels.autotune``) against the JAX package.

* ``Schedule`` strings parse, print and are rejected exactly as the
  reference's are; cache keys keep the reference's format, with the
  backend ``cpu`` or ``cuda:<device name>``;
* the JSON cache: a hit skips the sweep, a miss sweeps and persists,
  corrupt / stale files and invalid entries fall back to flat loudly;
  ``resolve_schedule`` for flat, auto and explicit points;
* ``fused_extractor_blocked_plain`` against the JAX package's
  ``fused_extractor_blocked`` (Pallas, interpret mode) within
  1e-4 * (1 + max|logit|), ragged batches included (tile 16,
  channels 8, depth 2);
* the channel tiles the blocked CUDA kernel runs, and a pipeline for a
  card rejecting any other when it is built, naming the limit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels.fused_extractor import fused_extractor_blocked as jblocked
from repro.core import extractor as jex
from repro_torch.core import extractor as ex
from repro_torch.core.detect import DetectionConfig
from repro_torch.core.stages import StageRegistry
from repro_torch.kernels import autotune as at
from repro_torch.kernels import fused_extractor as fx
from repro_torch.kernels import ops

torch.set_num_threads(1)

L, C, DEPTH = 16, 8, 2


def _np_params():
    return ex.init_extractor_numpy(0, n_bits=60, channels=C, depth=DEPTH,
                                   tile=L, bias_scale=0.1)


def _packed():
    return ex.pack_params(ex.params_from_numpy(_np_params()))


def _tiles(b, seed=0):
    return np.random.default_rng(seed).uniform(
        -2.0, 2.5, (b, L, L, 3)).astype(np.float32)


def _tol(ref):
    return 1e-4 * (1.0 + float(np.abs(ref).max()))


# -- Schedule strings and keys -------------------------------------------
@pytest.mark.parametrize("s", [
    "bb2-ct32-db", "bb1-ct0", " BB4-CT16-DB ", "bb8-ct0-db", "bb3-ct5",
    "flat", "auto", "bb2", "bb2-ct4-xx", "bbx-ct2", "bb0-ct2", "bb2-ct-1",
    "bb2-ct4-db-db", "ct4-bb2", ""])
def test_schedule_strings_match_reference(s):
    def parse(mod):
        try:
            sc = mod.Schedule.from_string(s)
        except ValueError as e:
            return "ValueError", str(e)
        return (sc.batch_block, sc.channel_tile, sc.double_buffer,
                sc.to_string())
    assert parse(at) == parse(jat)


def test_schedule_key_format():
    kw = dict(dtype="fp32", tile=64, channels=64, depth=7, n_bits=60)
    assert at.schedule_key(backend="cpu", **kw) == \
        jat.schedule_key(backend="cpu", **kw) == "cpu|fp32|t64|c64|d7|n60"
    assert at.schedule_key(backend="cuda:NVIDIA H100 80GB HBM3", **kw) == \
        "cuda:NVIDIA H100 80GB HBM3|fp32|t64|c64|d7|n60"
    assert at.backend_name("cpu") == "cpu"


def test_candidates_by_backend():
    cpu = at.candidate_schedules(8, 64, "cpu")
    assert [s.to_string() for s in cpu] == [
        s.to_string() for s in jat.candidate_schedules(8, 64, "cpu")]
    cuda = at.candidate_schedules(32, 64, "cuda:NVIDIA H100 80GB HBM3")
    assert len(cuda) == 16 and {s.double_buffer for s in cuda} == {True,
                                                                   False}
    assert {(s.batch_block, s.channel_tile) for s in cuda} == {
        (bb, ct) for bb in (1, 2, 4, 8) for ct in (0, 32)}
    assert at.candidate_schedules(3, 64, "cpu", quick=True) == [
        at.Schedule(1, 0, True), at.Schedule(2, 0, True)]


# -- the cache ------------------------------------------------------------
def test_autotune_miss_sweeps_then_hits(tmp_path):
    path = tmp_path / "sched.json"
    pk = _packed()
    logs = []
    first = at.autotune(pk, tile=L, batch=2, dtype="fp32", cache_path=path,
                        iters=1, warmup=1, quick=True, log=logs.append)
    data = json.loads(path.read_text())
    assert data["version"] == at.CACHE_VERSION
    (key, rec), = data["entries"].items()
    assert key == f"cpu|fp32|t{L}|c{C}|d{DEPTH}|n60"
    assert [e["schedule"] for e in rec["swept"]] == [
        "flat", "bb1-ct0-db", "bb2-ct0-db"]
    assert rec["schedule"] in {e["schedule"] for e in rec["swept"]}
    assert any("[autotune] flat:" in m for m in logs)
    logs.clear()
    again = at.autotune(pk, tile=L, batch=2, dtype="fp32", cache_path=path,
                        quick=True, log=logs.append)
    assert again == first
    assert len(logs) == 1 and logs[0].startswith("[autotune] cache hit")


def test_each_dtype_has_its_own_cache_entry(tmp_path, capsys):
    """An int8 sweep fills the int8 key beside the fp32 one; "auto"
    resolves int8 from it, silently, and still misses at bf16; a dtype
    that is not the pack's is refused instead of poisoning a key."""
    path = tmp_path / "sched.json"
    p = ex.params_from_numpy(_np_params())
    fp32 = at.autotune(ex.pack_params(p), tile=L, batch=2, dtype="fp32",
                       cache_path=path, iters=1, quick=True, log=str)
    pk8 = ex.pack_params(p, "int8")
    won = at.autotune(pk8, tile=L, batch=2, dtype="int8", cache_path=path,
                      iters=1, quick=True, log=str)
    keys = sorted(json.loads(path.read_text())["entries"])
    assert keys == [f"cpu|{d}|t{L}|c{C}|d{DEPTH}|n60"
                    for d in ("fp32", "int8")]
    kw = dict(tile=L, channels=C, depth=DEPTH, n_bits=60, cache_path=path)
    capsys.readouterr()
    assert at.resolve_schedule("auto", dtype="int8", **kw) == won
    assert at.resolve_schedule("auto", dtype="fp32", **kw) == fp32
    assert capsys.readouterr().err == ""
    assert at.resolve_schedule("auto", dtype="bf16", **kw) is None
    assert "no cached schedule for cpu|bf16" in capsys.readouterr().err
    with pytest.raises(ValueError, match="does not match the pack"):
        at.autotune(pk8, tile=L, batch=2, dtype="fp32", cache_path=path,
                    force=True, log=str)


def test_corrupt_and_stale_caches_fall_back_loudly(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert at.load_cache(bad) == {"version": at.CACHE_VERSION,
                                  "entries": {}}
    assert "corrupt" in capsys.readouterr().err
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 0, "entries": {}}))
    assert at.load_cache(stale)["entries"] == {}
    assert "stale or unknown format" in capsys.readouterr().err
    entry = {"version": at.CACHE_VERSION,
             "entries": {"k": {"schedule": "bb0-ct2"}}}
    assert at.cache_lookup(entry, "k") is at.MISS
    assert "invalid" in capsys.readouterr().err
    assert at.cache_lookup(entry, "other") is at.MISS


def test_resolve_schedule_modes(tmp_path, capsys):
    kw = dict(dtype="fp32", tile=L, channels=C, depth=DEPTH, n_bits=60)
    assert at.resolve_schedule("flat", **kw) is None
    assert at.resolve_schedule("bb2-ct4-db", **kw) == at.Schedule(2, 4, True)
    with pytest.raises(ValueError, match="bad schedule string"):
        at.resolve_schedule("fast", **kw)
    assert at.resolve_schedule("auto", **kw) is None        # no cache path
    assert "no autotune cache path" in capsys.readouterr().err
    path = tmp_path / "c.json"
    assert at.resolve_schedule("auto", cache_path=path, **kw) is None
    assert "Falling back to the flat schedule" in capsys.readouterr().err
    key = at.schedule_key(backend="cpu", **kw)
    for stored, want in (("bb4-ct0", at.Schedule(4, 0, False)),
                         ("flat", None)):
        at.save_cache(path, {"version": at.CACHE_VERSION,
                             "entries": {key: {"schedule": stored}}})
        assert at.resolve_schedule("auto", cache_path=path, **kw) == want
        assert capsys.readouterr().err == ""                # a hit: silent


# -- the blocked plain decode against the JAX blocked kernel --------------
@pytest.mark.parametrize("bb,ct", [(1, 0), (2, C // 2), (4, 0)])
@pytest.mark.parametrize("b", [4, 5])
def test_blocked_plain_matches_jax_blocked(bb, ct, b):
    p = _np_params()
    tiles = _tiles(b, seed=b)
    want = np.asarray(jblocked(jnp.asarray(tiles), jex.pack_params(
        jax.tree.map(jnp.asarray, p)), batch_block=bb, channel_tile=ct))
    got = fx.fused_extractor_blocked_plain(
        torch.as_tensor(tiles), ex.pack_params(ex.params_from_numpy(p)),
        batch_block=bb, channel_tile=ct)
    assert got.shape == want.shape == (b, 60)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(want))


def test_blocked_plain_schedules_agree_with_flat():
    """Every CPU candidate, through the op, gives the flat logits and
    embedding within the tolerance; pad rows never reach real rows."""
    pk = _packed()
    tiles = torch.as_tensor(_tiles(5, seed=1))
    flat = ops.fused_extractor(tiles, pk, with_embed=True)
    for sc in at.candidate_schedules(5, C, "cpu") + [at.Schedule(8, 2)]:
        got = ops.fused_extractor(tiles, pk, schedule=sc, with_embed=True)
        for g, f in zip(got, flat):
            np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=0,
                                       atol=_tol(f.numpy()))
    part = ops.fused_extractor(tiles[:3], pk, schedule=at.Schedule(4, 0))
    np.testing.assert_allclose(part.numpy(), flat[0][:3].numpy(), rtol=0,
                               atol=_tol(flat[0].numpy()))


# -- what the blocked CUDA kernel runs, checked when a pipeline is built ---
@pytest.mark.parametrize("channels,ct,ok", [
    (64, 0, True), (64, 4, True), (64, 16, True), (64, 32, True),
    (64, 128, True), (64, 12, False), (64, 6, False), (64, 2, False),
    (16, 8, True), (32, 24, False), (8, 4, True), (8, 0, True),
    (24, 12, True), (24, 16, False)])
def test_blocked_cuda_channel_tiles(channels, ct, ok):
    assert fx.blocked_channel_tiles(channels) == tuple(
        t for t in range(4, channels + 1, 4) if channels % t == 0)
    kw = dict(channels=channels, tile=64, channel_tile=ct)
    if ok:
        fx.check_blocked_schedule(**kw)
    else:
        with pytest.raises(ValueError, match=r"channel tiles .* multiples "
                           r"of 4 that divide C; got ct%d" % ct):
            fx.check_blocked_schedule(**kw)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("channels", [8, 24])
def test_cuda_checks_take_the_trainer_and_fleet_widths(dtype, channels):
    """Hidden widths 8 (the fleet tests') and 24 (the trainer's): the
    CUDA decode's pack check passes them at every rung, and the blocked
    schedule check every channel tile that divides them; width 12 is
    refused."""
    pk = ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=channels, depth=2, tile=16)), dtype)
    tiles = torch.zeros((2, 16, 16, 3))
    assert fx._check_pack(tiles, pk) == fx.RUNGS[dtype]
    assert channels in fx.HIDDEN_CHANNELS
    cts = fx.blocked_channel_tiles(channels)
    assert cts == ((4, 8) if channels == 8 else (4, 8, 12, 24))
    for ct in cts + (0,):
        fx.check_blocked_schedule(channels=channels, tile=16,
                                  channel_tile=ct)
    p12 = ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=12, depth=2, tile=16)), dtype)
    with pytest.raises(ValueError, match="hidden width 12"):
        fx._check_pack(tiles, p12)


def test_registry_rejects_unrunnable_schedule_for_a_card_at_build():
    """bb2-ct6 at C=16: the reference and the plain version run it, the
    CUDA kernel does not.  A pipeline for a card refuses it, and a width
    or tile size the kernel is not built for, when built and before
    anything moves to the device; one for the CPU runs it."""
    p16 = ex.init_extractor_numpy(0, n_bits=60, channels=16, depth=1,
                                  tile=L, bias_scale=0.1)
    cfg = DetectionConfig(tile=L, img_size=32, resize_src=40,
                          decode_schedule="bb2-ct6")
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match=r"channel tiles \(4, 8, 16\)"):
        StageRegistry(cfg, p16, cuda)
    p12 = ex.init_extractor_numpy(0, n_bits=60, channels=12, depth=1,
                                  tile=L)
    with pytest.raises(ValueError,
                       match=r"hidden widths \(8, 16, 24, 32, 64\)"):
        StageRegistry(cfg, p12, cuda)                            # C=12
    with pytest.raises(ValueError, match="multiple of 16"):
        StageRegistry(DetectionConfig(tile=8, img_size=32, resize_src=40,
                                      decode_schedule="bb2-ct4"), p16, cuda)
    st = StageRegistry(cfg, p16, torch.device("cpu"))
    try:
        assert st.decode_schedule == at.Schedule(2, 6, False)
        got = st.extract(torch.as_tensor(_tiles(3)))
        assert got.shape == (3, 60) and torch.isfinite(got).all()
    finally:
        st.close()
