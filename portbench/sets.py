#!/usr/bin/env python3
"""Runs of cells, one process each, one after another, with their
spreads: what the bounds of ``BENCHMARK.json`` are set from.

    python3 portbench/sets.py --out DIR --workload fp32-clean \\
        --seeds 11,12,13,14,15,16 [--sets 2] [--trace 0] [--seconds S]

Each run is ``run.py --workload W --seed N --seconds S --trace T``
(``S`` is ``run_seconds`` by default).  A run's standard output and
error go to ``DIR/<workload>-s<seed>-t<trace>-<set>-<run>.log``, its result
line to ``DIR/results.jsonl``.  For each set and metric it prints the
median and the spread: the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) over the median.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    rc = 0
    for wl in args.workload:
        for k in range(args.sets):
            rows = []
            for n, seed in enumerate(seeds):
                t = time.perf_counter()
                p = subprocess.run(
                    [sys.executable, str(HERE / "run.py"), "--workload", wl,
                     "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(args.trace)], cwd=ROOT,
                    capture_output=True, text=True, timeout=args.timeout)
                wall = time.perf_counter() - t
                log = out / f"{wl}-s{seed}-t{args.trace}-{k}-{n}.log"
                log.write_text(p.stdout + "\n--- stderr ---\n" + p.stderr)
                lines = p.stdout.strip().splitlines()
                try:
                    res = json.loads(lines[-1])
                except (IndexError, json.JSONDecodeError):
                    res = None
                if p.returncode != 0 or res is None:
                    rc = 1
                    print(f"{wl} seed {seed} set {k}: rc {p.returncode}, "
                          f"no result; tail:\n{p.stderr[-3000:]}", flush=True)
                    continue
                rec = {"workload": wl, "seed": seed, "set": k,
                       "trace": args.trace, "wall_s": wall, **res}
                with open(out / "results.jsonl", "a") as f:
                    f.write(json.dumps(rec) + "\n")
                rows.append(rec)
                vals = {n: m["value"] for n, m in res["metrics"].items()}
                print(f"{wl} seed {seed} set {k}: correct {res['correct']} "
                      f"wall {wall:.1f} s {json.dumps(vals)} checks "
                      f"{json.dumps(res['checks'])}", flush=True)
            if not rows:
                continue
            for name in rows[0]["metrics"]:
                vals = [r["metrics"][name]["value"] for r in rows
                        if name in r["metrics"]]
                print(f"SET {wl} {k} {name}: n {len(vals)} median "
                      f"{statistics.median(vals)!r} spread "
                      f"{spread(vals)!r} values {vals}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
