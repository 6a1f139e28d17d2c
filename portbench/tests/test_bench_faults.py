"""The comparison that decides ``correct``, driven through a whole run
of a cell at a tiny size on the CPU (``run.run_cell`` with the cell's
limits): a sound run passes; the control and each fault the cells can
have, planted under the timed path, fail it."""
import numpy as np
import pytest
import torch

import calibrate
import check
import run
from conftest import load, tiny
from repro_torch.core.stages import StageRegistry

CELLS = [("qrmark-fp32", "clean", "fp32-clean"),
         ("qrmark-fp32", "mixed", "fp32-mixed"),
         ("qrmark-int8", "mixed", "int8-mixed")]


def run_tiny(config, traffic, cell, seed=2 ** 31 + 9):
    cfg, mix = tiny(config, traffic)
    return run.run_cell(cfg, mix, load("limits", cell), seed=seed,
                        seconds=0.5, device="cpu", t_start=0.0,
                        log=lambda m: None)


@pytest.mark.parametrize("config,traffic,cell", CELLS)
def test_sound_run_is_correct(config, traffic, cell):
    out = run_tiny(config, traffic, cell)
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["numbers"]["rows_checked"] == 24


def stale_decode(monkeypatch):
    """The decode returns what its previous call returned."""
    real, last = StageRegistry.decode_keyed, {}

    def decode_keyed(self, x, keys):
        fresh = real(self, x, keys)
        out = last.get("logits", fresh)
        if out.shape != fresh.shape:
            out = fresh
        last["logits"] = fresh
        return out

    monkeypatch.setattr(StageRegistry, "decode_keyed", decode_keyed)


def half_batch(monkeypatch):
    """Ingest computes the first half of the batch and repeats it."""
    real = StageRegistry.ingest_keyed

    def ingest_keyed(self, raw, keys):
        h = max(1, raw.shape[0] // 2)
        x = real(self, raw[:h], keys[:h])
        return torch.cat([x, x, x])[:raw.shape[0]]

    monkeypatch.setattr(StageRegistry, "ingest_keyed", ingest_keyed)


def altered_answer(monkeypatch):
    """RS flips one message bit of the first row it returns."""
    real = StageRegistry.rs_correct

    def rs_correct(self, bits):
        msg, ok, ncorr = real(self, bits)
        msg = msg.clone()
        msg[0, 0] ^= 1
        return msg, ok, ncorr

    monkeypatch.setattr(StageRegistry, "rs_correct", rs_correct)


@pytest.mark.parametrize("fault", [stale_decode, half_batch, altered_answer])
@pytest.mark.parametrize("config,traffic,cell", CELLS)
def test_each_fault_is_caught(monkeypatch, fault, config, traffic, cell):
    fault(monkeypatch)
    out = run_tiny(config, traffic, cell)
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("config,traffic,cell", CELLS)
def test_control_fails(config, traffic, cell):
    """The reference one precision below the configuration's (TF32 for
    fp32, int4 for int8) in the program's place."""
    cfg, mix = tiny(config, traffic)
    limits = load("limits", cell)
    nums = calibrate.control_numbers(cfg, mix, limits, 3, device="cpu")
    assert not check.verdict(nums, limits), nums


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["fp32-clean", "fp32-mixed", "int8-mixed"])
def test_control_fails_at_the_cell_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    spec = {w["name"]: w for w in load("..", "BENCHMARK")["workloads"]}[cell]
    cfg = load("configs", spec["config"])
    mix = load("traffic", spec["traffic"])
    limits = load("limits", cell)
    for seed in (21, 22, 23):
        nums = calibrate.control_numbers(cfg, mix, limits, seed)
        assert not check.verdict(nums, limits), (seed, nums)


def test_escalation_margin_follows_the_measured_gap():
    """A row that went on to a second tile although its first tile's
    logits, as the reference reads them, pass RS: caught where the gap
    the one-tile rows read is small next to the entry RS's verdict hangs
    on, left undecided where it is not."""
    from reference import rs
    n = 60
    cw = rs.encode(np.random.default_rng(0).integers(0, 2, (1, 48)))[0]
    whole = (2.0 * cw - 1.0).astype(np.float32)
    word = whole.copy()
    word[0] = -word[0]  # one symbol in error, which RS corrects

    def rejects_with_flip(j):
        w = word.copy()
        w[j] = -w[j]
        return not rs.decode((w > 0)[None])[1][0]

    j = next(j for j in range(8, n) if rejects_with_flip(j))
    word[j] *= 1e-4  # a thin entry on whose sign RS's verdict hangs

    def judge(one_tile_gap):
        r0 = np.stack([whole, word])
        r1 = np.stack([np.full(n, np.nan, np.float32), whole])
        r2 = np.full((2, n), np.nan, np.float32)
        logits = np.stack([whole + np.float32(one_tile_gap), word + whole])
        msg, ok, nc = rs.decode(logits > 0)
        res = {"logits": logits, "message_bits": msg, "ok": ok,
               "n_corrected": nc, "tiles_used": np.array([1, 2])}
        return check.judge(res, [r0, r1, r2], 3, 5e-3)

    tight = judge(1e-6)
    assert tight["escalation_mismatch_rows"] == 1
    assert tight["undecided_rows"] == 0
    loose = judge(1e-3)
    assert loose["escalation_mismatch_rows"] == 0
    assert loose["undecided_rows"] == 1


def test_traced_run_reads_the_tail_before_the_profiler(monkeypatch):
    """A traced run hands the p95's reader only the batches that came
    back before the profiler started, and mfu the window's images/s."""
    monkeypatch.setattr(run, "TRACE_AT", 0.6)  # room for slow CPU batches
    cfg, mix = tiny("qrmark-fp32", "clean")
    out = run.run_cell(cfg, mix, load("limits", "fp32-clean"),
                       seed=2 ** 31 + 9, seconds=8.0, trace=True,
                       device="cpu", t_start=0.0, log=lambda m: None)
    ctx = out["ctx"]
    assert out["correct"], out["numbers"]
    assert 0 < len(ctx["batch_ms"]) < len(ctx["tiles_used"]) // mix["batch"]
    assert ctx["images_per_s"] == out["e2e"]["images_per_s"]
    assert "batch_p95_ms" not in out["e2e"]
