"""PyTorch port: the offline serve launcher (``repro_torch.launch.serve``)
on the CPU at a small size — report shape, key discipline, ragged
batches, and the flags it rejects instead of ignoring."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.launch import serve

torch.set_num_threads(1)

SMALL = ["--img", "32", "--tile", "16", "--device", "cpu"]


def test_main_prints_service_report(capsys):
    serve.main(["--batches", "2", "--batch", "3", *SMALL])
    rep = json.loads(capsys.readouterr().out)
    assert rep["images"] == 6 and rep["throughput_ips"] > 0
    assert rep["allocation"] is None and rep["lanes"] is None
    assert rep["device"] == "cpu"


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


@pytest.mark.parametrize("flags", [
    ["--lanes", "2"], ["--sharded"], ["--online"], ["--fleet"],
    ["--decode-dtype=bf16"], ["--escalate-tiles", "2"], ["--staged-ingest"]])
def test_unported_flags_are_rejected(capsys, flags):
    with pytest.raises(SystemExit) as exc:
        serve.parse_args([*flags, *SMALL])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" in err and flags[0] in err
