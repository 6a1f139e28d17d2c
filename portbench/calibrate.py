#!/usr/bin/env python3
"""The readings the limits of ``portbench/limits/<cell>.json`` are set
from, in one process on the card.

    python3 portbench/calibrate.py --workload fp32-mixed \\
        --seeds 101,...,112 --control-seeds 101,102,103 [--seconds 3]

For each of ``--seeds`` it makes a run of the cell with a short window
(``run.run_cell``: the cell's own batch, ring and lanes) and prints the
numbers the comparison reads.  For each of ``--control-seeds`` it puts
the control in the program's place, the reference computed at the
configuration's ``control_precision`` (TF32 for fp32, int4 for int8),
on as many batches of the cell's size as a run checks, and holds it to
the reference at the configuration's precision the same way.  The
lower reading of a number is the largest the program gives; the upper
the smallest the control gives.
"""
import argparse
import json
import sys
import time

import numpy as np

import run  # noqa: F401  (puts src and portbench on the path)
import check
import synth
from reference import detect as ref_detect


def control_numbers(cfg, mix, limits, seed: int, device: str = "cuda"
                    ) -> dict:
    import torch
    gen = synth.generator(seed, device)
    params = synth.make_params(gen, cfg)
    ring = synth.make_ring(gen, cfg, mix, params["corr"])
    rng = np.random.default_rng(seed)
    seqs = sorted(mix["warmup_batches"]
                  + rng.choice(300, mix["check_batches"], replace=False))
    per = []
    for seq in seqs:
        raw = torch.from_numpy(ring[seq % len(ring)]).to(device)
        res = ref_detect.detect(params, raw, cfg, seed % 2 ** 31, int(seq),
                                cfg["control_precision"])
        rounds = check.reference_rounds(params, raw, cfg, seed % 2 ** 31,
                                        int(seq), res["tiles_used"],
                                        cfg["reference_precision"])
        per.append(check.judge(res, rounds, cfg["escalate_tiles"],
                               limits["logit_gap"]))
    return check.merge(per)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell, conf, _, _ = run.cell_spec(bench, args.workload)
    cfg = json.loads((run.ROOT / conf["file"]).read_text())
    mix = json.loads((run.HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((run.HERE / "limits" / f"{cell['name']}.json")
                        .read_text())
    rows = {"program": [], "control": []}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        out = run.run_cell(cfg, mix, limits, seed=seed, seconds=args.seconds,
                           t_start=t, log=lambda m: None)
        rows["program"].append(out["numbers"])
        print(f"{args.workload} program seed {seed}: "
              f"{json.dumps(out['numbers'])} correct {out['correct']} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        nums = control_numbers(cfg, mix, limits, seed)
        rows["control"].append(nums)
        print(f"{args.workload} control ({cfg['control_precision']}) seed "
              f"{seed}: {json.dumps(nums)} ({time.perf_counter() - t:.1f} s)",
              flush=True)
    for name in check.NUMBERS:
        lo = [r[name] for r in rows["program"]]
        up = [r[name] for r in rows["control"]]
        print(f"READING {args.workload} {name}: lower (program max) "
              f"{max(lo) if lo else None!r} over {len(lo)} seeds "
              f"{lo}; upper (control min) {min(up) if up else None!r} over "
              f"{len(up)} seeds {up}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
