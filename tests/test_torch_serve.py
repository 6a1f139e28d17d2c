"""PyTorch port: the offline serve launcher (``repro_torch.launch.serve``)
on the CPU at a small size — report shape, key discipline, ragged
batches, and the flags it rejects instead of ignoring."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.extractor import packed_dtype
from repro_torch.launch import serve

torch.set_num_threads(1)

SMALL = ["--img", "32", "--tile", "16", "--device", "cpu"]


def _report(out: str):
    """The ``allocation:`` line and the ServiceReport JSON after it."""
    line, _, rest = out.partition("\n")
    assert line.startswith("allocation: streams=")
    return line, json.loads(rest)


def test_main_prints_service_report(capsys):
    """Algorithm 1's allocation line, then the report of the scheduled
    stream through the lane executor (adaptive lanes)."""
    serve.main(["--batches", "2", "--batch", "3", *SMALL])
    line, rep = _report(capsys.readouterr().out)
    assert rep["images"] == 6 and rep["throughput_ips"] > 0
    assert len(rep["allocation"]) == 3 and "J*=" in line
    assert set(rep["lanes"]) == {"ingest", "decode", "rs"}
    assert f"lanes={rep['lanes']}" in line
    assert len(rep["lane_loads"]) == sum(rep["lanes"].values())
    assert rep["straggler_retries"] == 0 and rep["device"] == "cpu"


def test_batches_use_the_offline_key_discipline():
    """Batch k of the stream is detected with fold_in(key(seed), k), as
    the reference's run_stream does; the warm-up does not move it."""
    args = serve.parse_args(["--batches", "2", "--batch", "2", *SMALL])
    pipe = serve.build_pipeline(args)
    sample, batches = serve.make_batches(args)
    serve.warm_up(pipe, sample)
    _, results = serve.serve(pipe, batches)
    for k, (raw, res) in enumerate(zip(batches, results)):
        again = pipe.detect_batch(
            raw, key=prng.fold_in(prng.key(pipe.cfg.seed), k))
        np.testing.assert_array_equal(again["logits"], res["logits"])


def test_ragged_batches():
    args = serve.parse_args(["--batches", "3", "--batch", "4", "--ragged",
                             *SMALL])
    _, batches = serve.make_batches(args)
    sizes = [b.shape[0] for b in batches]
    assert all(1 <= n <= 4 for n in sizes)
    rep, results = serve.serve(serve.build_pipeline(args), batches)
    assert rep.images == sum(sizes)
    assert [r["ok"].shape[0] for r in results] == sizes


# The case ids stay fixed from slice to slice.  Every flag here was once
# unported; the online flags (item 13b) are accepted with the reference's
# meanings now, and the fleet's (item 13c) is still rejected.
_ONLINE_FLAGS = {"--cache-embed-threshold=0.5": ("cache_embed_threshold",
                                                 0.5),
                 "--classes=a:5": ("classes", "a:5"),
                 "--online": ("online", True), "--qps=5": ("qps", 5.0),
                 "--realloc-every": ("realloc_every", 2),
                 "--cache-exact": ("cache_exact", True)}


@pytest.mark.parametrize("flags", [
    ["--cache-embed-threshold=0.5"], ["--classes=a:5"], ["--online"],
    ["--fleet"], ["--qps=5"], ["--realloc-every", "2"], ["--cache-exact"]])
def test_unported_flags_are_rejected(capsys, flags):
    if flags[0] in _ONLINE_FLAGS:
        name, value = _ONLINE_FLAGS[flags[0]]
        args = serve.parse_args([*flags, *SMALL])
        assert getattr(args, name) == value
        return
    with pytest.raises(SystemExit) as exc:
        serve.parse_args([*flags, *SMALL])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" in err and flags[0] in err
    with pytest.raises(SystemExit):
        serve.parse_args(["--help"])
    assert "item 13c" in capsys.readouterr().out


def test_fixed_lanes(capsys):
    """--lanes 4: four decode and four RS lanes, bypassing Algorithm 1's
    assignment (the allocation is still computed and reported)."""
    serve.main(["--batches", "1", "--batch", "2", "--lanes", "4", *SMALL])
    line, rep = _report(capsys.readouterr().out)
    assert rep["lanes"] == {"ingest": 1, "decode": 4, "rs": 4}
    assert len(rep["allocation"]) == 3 and rep["images"] == 2
    assert len(rep["lane_loads"]) == 9


def test_ragged_stream_is_padded_and_sliced():
    """--ragged batches through the service: each LPT task is padded to
    its bucket (here multiples of 3 rows) and its result sliced to the
    true rows, equal to detect_batch of the padded task under the
    stream's key."""
    args = serve.parse_args(["--batches", "2", "--batch", "4", "--ragged",
                             "--lanes", "2", *SMALL])
    cfg, params = serve.build_config(args)
    svc = serve.DetectionService(cfg, params, lanes=2, device="cpu",
                                 pad_bucket=3)
    _, batches = serve.make_batches(args)
    svc.warmup_stats[cfg.tile] = (1e-3, 1e3)
    work, _ = svc.plan(batches)
    assert sum(tb for _, tb in work) == sum(b.shape[0] for b in batches)
    assert all(sl.shape[0] % 3 == 0 for sl, _ in work)
    rep = svc.serve(batches)
    assert rep.images == sum(b.shape[0] for b in batches)
    pipe = serve.build_pipeline(args)
    for i, ((sl, tb), res) in enumerate(zip(work, svc.results)):
        want = pipe.detect_batch(sl, key=prng.fold_in(prng.key(0), i),
                                 true_b=tb)
        assert res["ok"].shape == (tb,)
        np.testing.assert_array_equal(res["logits"], want["logits"][:tb])
    svc.close()


def test_sharded_serve(capsys):
    """--sharded: each batch through run_batch over the pipeline's
    device; the report has the reference's fields (no lane allocation:
    the sharded path does not pipeline)."""
    serve.main(["--batches", "2", "--batch", "3", "--sharded", *SMALL])
    line, rep = _report(capsys.readouterr().out)
    assert rep["images"] == 6 and rep["device"] == "cpu"
    assert rep["allocation"] is None and rep["lanes"] is None
    assert rep["lane_loads"] is None


@pytest.mark.parametrize("flags,want", [
    ([], dict(mode="qrmark", rs_mode="device", tile_first=True,
              fused_decode=True, decode_schedule="flat",
              decode_dtype="fp32")),
    (["--mode", "sequential", "--rs-mode", "cpu_sync"],
     dict(mode="sequential", rs_mode="cpu_sync")),
    (["--mode", "tiled", "--rs-mode", "cpu_pool"],
     dict(mode="tiled", rs_mode="cpu_pool")),
    (["--staged-ingest", "--unfused-decode"],
     dict(tile_first=False, fused_decode=False)),
    (["--schedule", "bb4-ct8-db", "--autotune-cache", "x.json"],
     dict(decode_schedule="bb4-ct8-db", autotune_cache="x.json")),
    (["--decode-dtype", "bf16"], dict(decode_dtype="bf16")),
    (["--decode-dtype", "int8", "--schedule", "bb2-ct16-db"],
     dict(decode_dtype="int8", decode_schedule="bb2-ct16-db")),
    (["--escalate-tiles", "3", "--escalate-margin", "0.5"],
     dict(escalate_tiles=3, escalate_margin=0.5)),
    (["--mode", "tiled", "--decode-dtype", "int8", "--escalate-tiles", "2"],
     dict(mode="tiled", escalate_tiles=2))])
def test_configuration_flags(flags, want):
    """The reference launcher's configuration flags, with its meanings;
    the pipeline is built (its decode weights packed at the dtype) and
    closed (the pool's threads joined)."""
    pipe = serve.build_pipeline(serve.parse_args([*flags, *SMALL]))
    try:
        for k, v in want.items():
            assert getattr(pipe.cfg, k) == v, k
        if pipe.stages.fused_decode:
            assert packed_dtype(pipe.stages.packed_params) == \
                pipe.cfg.decode_dtype
    finally:
        pipe.close()


def test_mode_choices_are_checked(capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--mode", "fast", *SMALL])
    assert "invalid choice" in capsys.readouterr().err


def test_decode_dtype_choices_are_checked(capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--decode-dtype", "fp16", *SMALL])
    assert "invalid choice" in capsys.readouterr().err


def test_autotune_flag_sweeps_then_serves_auto(tmp_path, capsys):
    """--autotune fills the cache for this configuration, then serves
    with decode_schedule="auto", which resolves from the cache."""
    cache = tmp_path / "sched.json"
    serve.main(["--batches", "1", "--batch", "2", "--autotune",
                "--autotune-cache", str(cache), *SMALL])
    out = capsys.readouterr()
    assert "[autotune] cached:" in out.out and out.err == ""
    entries = json.loads(cache.read_text())["entries"]
    assert list(entries) == ["cpu|fp32|t16|c64|d7|n60"]
    rep = json.loads(out.out[out.out.index("{\n"):])
    assert rep["images"] == 2


def test_int8_autotune_serves_auto_from_its_own_entry(tmp_path, capsys):
    """--decode-dtype int8 --autotune sweeps the int8 key of a cache that
    already holds an fp32 entry, then serves "auto" from the int8 one."""
    cache = tmp_path / "sched.json"
    other = "cpu|fp32|t16|c64|d7|n60"
    cache.write_text(json.dumps({"version": 1, "entries": {
        other: {"schedule": "bb4-ct0"}}}))
    serve.main(["--batches", "1", "--batch", "2", "--decode-dtype", "int8",
                "--autotune", "--autotune-cache", str(cache), *SMALL])
    out = capsys.readouterr()
    assert "[autotune] cached: cpu|int8|t16|c64|d7|n60" in out.out
    assert out.err == ""                       # auto hit the cache
    entries = json.loads(cache.read_text())["entries"]
    assert sorted(entries) == [other, "cpu|int8|t16|c64|d7|n60"]
    assert entries[other] == {"schedule": "bb4-ct0"}
    assert json.loads(out.out[out.out.index("{\n"):])["images"] == 2


def test_escalation_runs(capsys):
    """--escalate-tiles 3 on the launcher's untrained weights: nearly
    every image fails RS(15,12) and uses all three tiles; the report keeps
    its shape, and the results equal the pipeline's own escalation."""
    args = serve.parse_args(["--batches", "1", "--batch", "3",
                             "--escalate-tiles", "3", *SMALL])
    pipe = serve.build_pipeline(args)
    _, batches = serve.make_batches(args)
    rep, results = serve.serve(pipe, batches)
    assert rep.images == 3
    used = results[0]["tiles_used"]
    assert used.shape == (3,) and ((1 <= used) & (used <= 3)).all()
    assert (used[~results[0]["ok"]] == 3).all()
    serve.main(["--batches", "1", "--batch", "2", "--escalate-tiles", "3",
                *SMALL])
    _, rep = _report(capsys.readouterr().out)
    assert set(rep) == {"images", "wall_s", "throughput_ips", "allocation",
                        "lanes", "lane_loads", "straggler_retries", "device"}
