#!/usr/bin/env python3
"""Benchmark of the QRMark detector's PyTorch and CUDA port
(``src/repro_torch``) on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One run is one process.  It reads its cell in ``BENCHMARK.json``: the
configuration's file (``portbench/configs/``), the traffic mix
(``portbench/traffic/<traffic>.json``) and the cell's limits
(``portbench/limits/<cell>.json``).  In order it

1. loads the port's kernel library (built into ``build/repro_torch_kernels``
   of the checkout by the first run there);
2. draws the extractor's weights from the seed on the card
   (``synth.make_params``) and builds a ``DetectionPipeline`` on them with
   the configuration's settings and the seed (modulo 2^31) as its seed;
3. draws a ring of raw batches from the seed (``synth.make_ring``);
4. drives ``DetectionPipeline.run_stream`` at the pipeline's default
   lanes with a generator that cycles the ring: first the mix's warm-up
   batches, waited for to the last result, then the measured window,
   which yields batches until ``--seconds`` have passed since its first
   yield and ends with the last result;
5. with ``--trace 1`` profiles a steady sub-window of it (kernels, copies
   and the CUDA runtime calls of every thread), started and stopped on the
   generator's thread, and reduces the trace and the results to the
   per-layer metrics (``portbench/metrics/<name>.py``);
6. reads the peak device memory, frees the pipeline, and holds a sample
   of the window's batches, drawn from the seed, to the plain reference
   (``check.py``, ``portbench/reference``);
7. prints each compared number beside its limit as the last lines of
   standard error, and one JSON object as the last line of standard
   output: ``correct``, ``attempted`` and ``failed`` (images), the
   cell's end-to-end metrics (``--trace 0``) or per-layer metrics
   (``--trace 1``), ``device``, ``breakdown`` (traced runs) and, last,
   ``checks``.

A run exits non-zero and prints no result where no CUDA device is
available, where fewer cards than the cell asks for are visible, or
where ``jax``, ``jaxlib``, ``flax`` or ``repro`` was imported (an import
of them fails from the start).
"""
import time

T_START = time.perf_counter()  # set-up is counted from process start

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT / "src"), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_AT = 0.4        # the traced sub-window starts at this share of --seconds
TRACE_SHARE = 0.3     # and lasts this share of it,
TRACE_MAX_S = 3.0     # at most this long


class RefuseForbidden:
    """A meta path finder that makes every import of a forbidden top-level
    name fail (compared whole: ``repro_torch`` is not ``repro``)."""

    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in FORBIDDEN:
            raise ModuleNotFoundError(
                f"the benchmark may not import {name!r}", name=name)
        return None


def forbidden_loaded():
    return sorted({m.partition(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def nvidia_smi(fields: str) -> str:
    """One line of ``nvidia-smi --query-gpu`` for the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {e}"


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pipeline_config(cfg: dict, seed: int):
    from repro_torch.core.detect import DetectionConfig
    from repro_torch.core.rs.codec import RSCode
    fields = {k: cfg[k] for k in (
        "tile", "img_size", "resize_src", "strategy", "mode", "rs_mode",
        "fused_preprocess", "tile_first", "fused_decode", "decode_dtype",
        "decode_schedule", "interleave", "lane_budget", "escalate_tiles",
        "escalate_margin")}
    return DetectionConfig(code=RSCode(*cfg["code"]), seed=seed % 2 ** 31,
                           **fields)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone()


def _percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=float), q))


def run_cell(cfg: dict, mix: dict, limits: dict, *, seed: int,
             seconds: float, trace: bool = False, device: str = "cuda",
             t_start: float = None, mid_window=None, log=print) -> dict:
    """One run of a cell (steps 1-6 of the module's docstring) on
    ``device``; returns what the result line is made of.  ``mid_window``,
    where given, runs on a thread of its own halfway through the
    window."""
    import numpy as np
    import torch

    import check
    import devtrace
    import synth
    from repro_torch.core.detect import DetectionPipeline

    t_start = T_START if t_start is None else t_start
    on_card = device.startswith("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = {}
    t = time.perf_counter()
    if on_card:
        from repro_torch.kernels import _build
        _build.library()
        parts["library_s"] = time.perf_counter() - t
        parts["library_built"] = not _build.build_info.get("cached", True)
        t = time.perf_counter()
    gen = synth.generator(seed, device)
    params = synth.make_params(gen, cfg)
    ref_params = clone_tree(params)
    pipe = DetectionPipeline(pipeline_config(cfg, seed), params,
                             device=device)
    parts["pipeline_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ring = synth.make_ring(gen, cfg, mix, ref_params["corr"])
    parts["ring_s"] = time.perf_counter() - t
    del params
    if trace:
        # the first profiler session of a process initialises CUPTI, which
        # takes seconds: done here, so the traced sub-window starts at once
        t = time.perf_counter()
        prof = start_profiler(on_card)
        torch.ones(8, device=device).sum()
        prof.stop()
        parts["profiler_s"] = time.perf_counter() - t
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    warm, n_ring = mix["warmup_batches"], len(ring)
    yielded, done = [], {}
    warm_done = threading.Event()
    st = {"t0": None, "trace_start": None, "trace_on": None,
          "trace_off": None, "prof": None}
    trace_at = TRACE_AT * seconds
    trace_len = min(TRACE_MAX_S, TRACE_SHARE * seconds)

    def toggle_trace(now, last=False):
        """Starts, then stops, the profiler on the generator's thread, so
        that no result waits on it; the window's end stops it too."""
        if st["prof"] is None and now - st["t0"] >= trace_at and not last:
            st["trace_start"] = now
            st["prof"] = start_profiler(on_card)
            st["trace_on"] = time.perf_counter()
            st["start_s"] = st["trace_on"] - now
        elif (st["trace_off"] is None and st["prof"] is not None
              and (now - st["trace_on"] >= trace_len or last)):
            st["trace_off"] = now
            st["prof"].stop()
            st["stop_s"] = time.perf_counter() - now

    def batches():
        i = 0
        while True:
            if i == warm:
                if not warm_done.wait(timeout=900):
                    raise RuntimeError("the warm-up batches never came back")
                st["t0"] = time.perf_counter()
                if mid_window is not None:
                    st["timer"] = threading.Timer(seconds / 2, mid_window)
                    st["timer"].start()
            now = time.perf_counter()
            if i >= warm:
                if now - st["t0"] >= seconds:
                    if trace:
                        toggle_trace(now, last=True)
                    return
                if trace:
                    toggle_trace(now)
                    now = time.perf_counter()
            yielded.append(now)
            yield ring[i % n_ring]
            i += 1

    def on_result(i, res):
        done[i] = time.perf_counter()
        if i == warm - 1:
            warm_done.set()

    t = time.perf_counter()
    try:
        out = pipe.run_stream(batches(), on_result=on_result)
    finally:
        if "timer" in st:
            st["timer"].join()
        if st["prof"] is not None and st["trace_off"] is None:
            st["prof"].stop()
    t_end = max(done.values())
    results = out["results"]
    window = list(range(warm, len(results)))
    if not window:
        raise RuntimeError("the window yielded no batch")
    parts["warmup_s"] = st["t0"] - t
    setup_s = st["t0"] - t_start
    images = sum(results[i]["logits"].shape[0] for i in window)
    attempted = len(window) * mix["batch"]
    lat_ms = [(done[i] - yielded[i]) * 1e3 for i in window]
    e2e = {"images_per_s": images / (t_end - st["t0"]), "setup_s": setup_s}
    per_s = np.bincount([int(done[i] - st["t0"]) for i in window],
                        minlength=int(t_end - st["t0"]) + 1) * mix["batch"]
    log(f"images a second of the window: {per_s.tolist()}")
    log(f"lanes: {json.dumps(out['lanes'])}; batches: {warm} warm-up, "
        f"{len(window)} in the window of {t_end - st['t0']:.3f} s "
        f"({attempted} images); batch ms p50 {_percentile(lat_ms, 50):.3f} "
        f"p95 {_percentile(lat_ms, 95):.3f} p99 {_percentile(lat_ms, 99):.3f}; "
        f"images/s {e2e['images_per_s']:.1f}")
    log("set-up: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in parts.items())
        + f", total {setup_s:.3f} s")

    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    pipe.close()
    del pipe, out
    if on_card:
        torch.cuda.empty_cache()

    # batches that came back before the profiler started: it slows those
    # in flight beside it, and a tail is made of the slowest
    untraced = [i for i in window
                if st["trace_start"] is None or done[i] < st["trace_start"]]
    ctx = {"cfg": cfg, "images_per_s": e2e["images_per_s"],
           "batch_ms": [(done[i] - yielded[i]) * 1e3 for i in untraced],
           "tiles_used": np.concatenate(
               [np.asarray(results[i].get("tiles_used",
                                          np.ones(results[i]["logits"]
                                                  .shape[0])))
                for i in window])}
    dev_info = {}
    breakdown = None
    if trace:
        if st["trace_off"] is None:
            raise RuntimeError("the traced sub-window did not close inside "
                               "the window: lengthen --seconds")
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            st["prof"].export_chrome_trace(path)
            tr = devtrace.load(path)
        finally:
            os.unlink(path)
        pre = [i for i in window if done[i] <= st["trace_on"]]
        pre_ips = (sum(results[i]["logits"].shape[0] for i in pre)
                   / (st["trace_on"] - st["t0"]) if pre else None)
        ctx.update(trace=tr,
                   batches_traced=sum(1 for i in window
                                      if st["trace_on"] <= done[i]
                                      <= st["trace_off"]))
        busy = devtrace.busy_us(tr.device)
        dev_info = {"busy_s": busy / 1e6, "window_s": tr.window_us / 1e6}
        breakdown = {"device_ops": devtrace.device_ops(tr),
                     "idle_gaps": devtrace.idle_gaps(tr)}
        traced_ips = (sum(results[i]["logits"].shape[0] for i in window
                          if st["trace_on"] <= done[i] <= st["trace_off"])
                      / (st["trace_off"] - st["trace_on"]))
        log(f"profiler start {st['start_s']:.3f} s, stop "
            f"{st['stop_s']:.3f} s; traced sub-window: "
            f"{tr.window_us / 1e6:.3f} s, "
            f"{len(tr.device)} device and {len(tr.host)} host events, "
            f"{ctx['batches_traced']} batches; images/s before it "
            f"{pre_ips}, inside it {traced_ips:.1f}; batch p95 before it "
            f"over {len(untraced)} batches")

    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    n_check = min(mix["check_batches"], len(window))
    picks = sorted(warm + rng.choice(len(window), n_check, replace=False))
    per_batch = []
    for i in picks:
        raw = torch.from_numpy(ring[i % n_ring]).to(device)
        rounds = check.reference_rounds(
            ref_params, raw, cfg, seed % 2 ** 31, i,
            np.asarray(results[i].get("tiles_used",
                                      np.ones(raw.shape[0], np.int64))),
            cfg["reference_precision"])
        per_batch.append(check.judge(results[i], rounds,
                                     cfg["escalate_tiles"],
                                     limits["logit_gap"]))
    numbers = check.merge(per_batch)
    log(f"reference: {n_check} batches ({int(numbers['rows_checked'])} "
        f"rows, {int(numbers['undecided_rows'])} undecided) in "
        f"{time.perf_counter() - t:.3f} s")
    return {"correct": check.verdict(numbers, limits),
            "attempted": attempted, "failed": attempted - images,
            "e2e": e2e, "ctx": ctx, "numbers": numbers,
            "memory_peak_bytes": memory_peak, "device": dev_info,
            "breakdown": breakdown}


def start_profiler(on_card: bool):
    """A started profiler: on a card CUPTI's device activity and CUDA
    runtime calls of every thread (recording every thread's CPU
    operators as well slows the host-bound lanes several times over); on
    the CPU its operators."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA if on_card
                               else ProfilerActivity.CPU])
    prof.start()
    return prof


def cell_spec(bench: dict, workload: str):
    """(cell, configuration entry, end-to-end metrics, per-layer metrics)
    of ``workload`` in ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{', '.join(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]

    return cell, conf, mine(bench["end_to_end"]), mine(bench["per_layer"])


def main(argv=None) -> int:
    sys.meta_path.insert(0, RefuseForbidden())
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, conf, e2e_ms, layer_ms = cell_spec(bench, args.workload)
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json")
                        .read_text())
    readers = {m["name"]: load_reader(m["name"]) for m in layer_ms}

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available: this benchmark runs on the card "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (the system under test; fails loudly)
    kind = torch.cuda.get_device_name(0)
    print(f"card: {nvidia_smi('name,power.limit,clocks.max.sm')} (torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}); cell "
          f"{cell['name']}, seed {args.seed}, {args.seconds} s, trace "
          f"{args.trace}", flush=True)
    def mid_window():
        print(f"card in the window: SM clock, power, temperature "
              f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}",
              flush=True)

    out = run_cell(cfg, mix, limits, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), mid_window=mid_window,
                   log=lambda msg: print(msg, flush=True))

    from flops import PEAKS
    ctx = dict(out["ctx"], peaks=PEAKS.get(kind))
    metrics = {}
    if args.trace:
        for m in layer_ms:
            v = readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e_ms:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"],
              **out["device"]}
    leaked = forbidden_loaded()
    if leaked:
        print(f"forbidden modules loaded: {', '.join(leaked)}",
              file=sys.stderr)
        return 4
    import check
    checks = {n: {"value": out["numbers"][n], "limit": limits[n]}
              for n in check.NUMBERS}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    sys.stdout.flush()
    for n, c in checks.items():
        print(f"check {n}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
