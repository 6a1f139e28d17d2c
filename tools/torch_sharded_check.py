#!/usr/bin/env python3
"""The port's data-parallel ``run_batch`` over every visible CUDA card,
held to ``detect_batch`` on one card, and its images/s.

Run from the root of a checkout on a machine with one or more CUDA
cards:

    python3 tools/torch_sharded_check.py [--windows 3]

At the serve launcher's full width (C 64, D 7, 60 bits, tile 64, img
256, raw 288, seeded weights) it builds one pipeline on the first card
for each configuration — fp32, int8, and fp32 with ``escalate_tiles=3``
(escalation runs on the first card after the chunks) — and checks that
``run_batch`` over ``launch.mesh.make_detection_mesh()`` gives every real
row of a batch of 32 and of a ragged batch of 29 exactly what
``detect_batch`` gives on the first card with the same key (result
hashes).  Then images/s of ``detect_batch`` against ``run_batch`` over
the 3 batches of 32 of the launcher's stream, ``--windows`` windows
each, alternating; and the launcher's ``--sharded`` report.  Prints the
card's name and power limit, one JSON line per check and a last JSON
line with everything, also written to ``build/sharded_check/check.json``.
Fails on any mismatch.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "sharded_check"
ARGS = ["--batch", "32", "--img", "256", "--tile", "64", "--device", "cuda"]


def result_hash(results) -> str:
    h = hashlib.sha256()
    for r in results:
        for k in sorted(r):
            a = np.ascontiguousarray(r[k])
            h.update(f"{k}|{a.dtype}|{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import prng
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.mesh import make_detection_mesh
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    print(card)
    mesh = make_detection_mesh()
    out = {"card": card, "devices": [str(d) for d in mesh], "checks": {}}
    _, batches = serve_lib.make_batches(
        serve_lib.parse_args([*ARGS, "--batches", "3"]))
    for name, flags in (("fp32", []), ("int8", ["--decode-dtype", "int8"]),
                        ("k3", ["--escalate-tiles", "3"])):
        pipe = serve_lib.build_pipeline(serve_lib.parse_args([*ARGS,
                                                              *flags]))
        for b in (32, 29):
            raw = batches[0][:b]
            key = prng.key(7)
            want = result_hash([pipe.detect_batch(raw, key=key)])
            got = result_hash([pipe.run_batch(raw, mesh=mesh, key=key)])
            out["checks"][f"{name}_b{b}"] = got == want
            print(json.dumps({"config": name, "b": b, "devices": len(mesh),
                              "equal": got == want, "hash": want}))
            if got != want:
                raise SystemExit(f"run_batch differs from detect_batch: "
                                 f"{name}, b = {b}")
        if name == "fp32":
            ips = {"detect_batch": [], "run_batch": []}
            n_img = sum(r.shape[0] for r in batches)
            for _ in range(args.windows):
                for side in ("detect_batch", "run_batch", "run_batch",
                             "detect_batch"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for raw in batches:
                        if side == "run_batch":
                            pipe.run_batch(raw, mesh=mesh)
                        else:
                            pipe.detect_batch(raw)
                    ips[side].append(n_img / (time.perf_counter() - t0))
            out["images_per_s"] = ips
            print(json.dumps({"images_per_s": {
                k: [round(v, 1) for v in vs] for k, vs in ips.items()},
                "devices": len(mesh), "card": card}))
        pipe.close()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_lib.main([*ARGS, "--batches", "8", "--sharded"])
    line, _, rest = buf.getvalue().partition("\n")
    out["serve_sharded"] = json.loads(rest)
    print(line)
    print(json.dumps({"serve_sharded_images_per_s":
                      out["serve_sharded"]["throughput_ips"],
                      "devices": len(mesh), "card": card}))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "check.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
