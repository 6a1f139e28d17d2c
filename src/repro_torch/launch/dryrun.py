"""Dry-run of the LM's cells on the ``meta`` device (counterpart of
``repro.launch.dryrun``): every (architecture x input shape x mesh) cell
traced without storage, its roofline terms derived at the H100's peaks.

The reference lowers and compiles each cell with XLA over 256 or 512
host placeholder devices and reads FLOPs and bytes from
``cost_analysis``, memory from ``memory_analysis`` and collectives from
the compiled HLO text.  PyTorch has no SPMD compiler: here the cell's
step runs once on ``meta`` tensors (shapes and dtypes, no storage) under
two counters — ``torch.utils.flop_counter.FlopCounterMode`` for FLOPs
and :class:`ByteCounter` for the bytes every aten op reads and writes,
unfused (XLA's "bytes accessed" counts after fusion) — and the
collectives come from the partition specs
(``hlo_analysis.spec_collective_stats``).  The step is the reference's
probe step: train is the forward and backward under ``remat`` at
``global_batch // n_micro``, prefill ``forward_prefill``, decode one
token's ``forward_decode`` against ``abstract_decode_state``.

The meta counts are global.  The reference's are per device, its module
being SPMD; they are divided by ``n_chips`` when ``batch_specs`` shards
the batch dim, by ``model_size`` alone when the batch replicates (a
batch of 1).  Memory per device comes from the specs (arguments and
outputs, exact) and from the bytes autograd saves for the backward
(train) or the decode state (prefill, decode); XLA's alias and code
sizes have no counterpart and stay ``None``.

The reference's method stays: a traced layer loop is as slow as its
Python (a mistral-large prefill of 32k tokens ~13 s a layer), so the
step is traced at depth 1 and 2 layer groups and the full depth rebuilt
as A + n_groups * B (x n_micro in train, plus an analytic AdamW term).
``--no-probes`` traces the full depth instead (slow).  The reference's
``force_placeholder_devices`` has no counterpart: meta needs no devices.
:func:`trace_cell` takes a ``device``, so the same count runs on a card
or the CPU, where it must equal the meta count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import base as cfgbase
from repro_torch.launch import hlo_analysis, mesh as mesh_lib
from repro_torch.models import blocks, lm, moe as moe_lib
from repro_torch.sharding import planner
from repro_torch.train.optimizer import tree_leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun"

METHOD = {
    "flops": "torch.utils.flop_counter.FlopCounterMode over the step on "
             "the meta device",
    "bytes": "unfused bytes: every aten op that moves data reads each "
             "tensor operand once and writes each result once (views "
             "and empty allocations move none)",
    "coll_bytes": hlo_analysis.SPEC_MODEL,
    "per_device": "global meta counts / n_chips when batch_specs shards "
                  "the batch dim, / model_size when it replicates",
    "memory": "arguments and outputs from the specs' shard shapes; temp "
              "the bytes autograd saves for the backward (train) or the "
              "decode state (prefill, decode), by the same division",
}

_aten = torch.ops.aten
_NO_DATA = {_aten._unsafe_view, _aten.detach, _aten.alias, _aten.lift_fresh,
            _aten.empty, _aten.empty_like, _aten.empty_strided,
            _aten.new_empty, _aten.new_empty_strided}


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every aten op's tensor operands and results
    (``bytes``), views and empty allocations excepted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _NO_DATA:
            return out
        for t in _pytree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


# ---------------------------------------------------------------------------
# abstract inputs + specs per cell
# ---------------------------------------------------------------------------


def _batch_sharded(shape, plan) -> bool:
    b = shape.global_batch
    if shape.mode == "decode" and not plan.decode_batch_shard:
        return False
    return b % plan.data_size == 0


def _divisor(shape, plan) -> int:
    """Global count -> one device's."""
    return plan.n_chips if _batch_sharded(shape, plan) else plan.model_size


def _spec_bytes(tree, specs, mesh) -> int:
    total = 0
    for _, leaf, spec in planner.leaves_with_specs(tree, specs):
        n = 1
        for d in planner.shard_shape(tuple(leaf.shape), spec, mesh):
            n *= d
        total += n * leaf.element_size()
    return total


def _replicated(tree):
    return tree_map(lambda l: planner.Spec([None] * l.dim()), tree)


def prefill_state(cfg, b, s, compute_dtype=torch.bfloat16) -> dict:
    """The state a prefill of ``s`` tokens leaves, abstract, in the
    reference's layout (encoder-decoder: caches over the target tokens,
    the cross K/V over the ``s`` frames)."""
    if not cfg.is_encoder_decoder:
        return lm.abstract_decode_state(cfg, b, s, compute_dtype)
    state = lm.abstract_decode_state(cfg, b, max(64, s // 8), compute_dtype)
    ng, kvh, hd = blocks.n_groups(cfg), cfg.n_kv_heads, cfg.head_dim
    state["cross"] = tuple(lm.sds((ng, b, s, kvh, hd), compute_dtype)
                           for _ in range(2))
    return state


def _abstract_cell(cfg, shape, plan, *, with_opt, param_dtype=None):
    """(abstract tree, its specs) of each argument of the cell's step."""
    aparams = lm.abstract_params(cfg, dtype=param_dtype or torch.float32)
    out = {"params": (aparams, planner.param_specs(cfg, aparams, plan))}
    specs = lm.input_specs(cfg, shape)
    if shape.mode == "decode":
        tokens = specs["tokens"]
        tspec = planner.batch_specs(cfg, shape, plan, tokens) \
            if plan.decode_batch_shard else _replicated(tokens)
        out["tokens"] = (tokens, tspec)
        out["state"] = (specs["state"], planner.decode_state_specs(
            cfg, plan, specs["state"]))
    else:
        out["batch"] = (specs["batch"], planner.batch_specs(
            cfg, shape, plan, specs["batch"]))
    if with_opt:
        ospec = planner.opt_specs(cfg, aparams, plan)
        moments = tree_map(lambda l: lm.sds(l.shape, torch.float32), aparams)
        out["opt"] = ({"m": moments, "v": moments,
                       "step": lm.sds((), torch.int32)},
                      {"m": ospec, "v": ospec, "step": planner.Spec()})
    return out


def _memory(cfg, shape, plan, *, with_opt, param_dtype, temp) -> dict:
    """The reference's five ``memory_analysis`` keys, per device."""
    mesh = plan.mesh
    ab = _abstract_cell(cfg, shape, plan, with_opt=with_opt,
                        param_dtype=param_dtype)
    args = sum(_spec_bytes(t, s, mesh) for t, s in ab.values())
    params = _spec_bytes(*ab["params"], mesh)
    if shape.mode == "train":
        # the step's new params and moments and three float32 metrics;
        # the probe's gradients
        outs = (params + _spec_bytes(*ab["opt"], mesh) + 12 if with_opt
                else params)
    else:
        b = shape.global_batch
        logits = b * cfg.vocab * torch.finfo(torch.bfloat16).bits // 8
        state = ab["state"] if shape.mode == "decode" else None
        if state is None:
            st = prefill_state(cfg, b, shape.seq_len)
            state = (st, planner.decode_state_specs(cfg, plan, st))
        outs = logits + _spec_bytes(*state, mesh)
    return {"argument_size_in_bytes": args,
            "output_size_in_bytes": outs,
            "temp_size_in_bytes": temp,
            "alias_size_in_bytes": None,
            "generated_code_size_in_bytes": None}


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def _materialize(t: torch.Tensor, device, gen) -> torch.Tensor:
    if t.is_floating_point():
        return (torch.randn(t.shape, generator=gen, device=device) * 0.02
                ).to(t.dtype)
    return torch.zeros(t.shape, dtype=t.dtype, device=device)


def build_model(cfg, device, param_dtype=torch.float32, moe_groups=0,
                seed=0):
    """``LM(cfg)`` on ``device``: storage-free on meta, small seeded
    normal weights elsewhere (a count does not read values)."""
    device = torch.device(device)
    with torch.device("meta"):
        model = lm.LM(cfg, None, dtype=param_dtype)
    if device.type != "meta":
        model = model.to_empty(device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(_materialize(p, device, gen))
    for mod in model.modules():
        if isinstance(mod, moe_lib.MoE):
            mod.groups = moe_groups
    return model


def step_inputs(cfg, shape, device, compute_dtype=torch.bfloat16, seed=1):
    """The step's inputs on ``device`` (``input_specs``' shapes; on a real
    device token ids 0, embeddings small seeded normals, caches zeros)
    in the port's layout: {"batch"} or {"tokens", "state"}."""
    device = torch.device(device)
    specs = lm.input_specs(cfg, shape, compute_dtype=compute_dtype)
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
        specs = tree_map(lambda t: _materialize(t, device, gen), specs)
    if shape.mode != "decode":
        return specs
    return {"tokens": specs["tokens"], "state": lm.decode_state_from_reference(
        specs["state"], cfg, index=shape.seq_len - 1)}


def materialized_argument_bytes(cfg, shape, device,
                                param_dtype=torch.float32) -> int:
    """The summed bytes of the step's arguments made on ``device``: the
    parameters, in train the AdamW moments and step, and the inputs
    (``input_specs``' tree, a decode state's index included) — the
    counterpart of ``_memory``'s arguments at a 1 x 1 plan."""
    from repro_torch.train.optimizer import init_opt_state
    device = torch.device(device)
    tree = lm.param_tree(build_model(cfg, device, param_dtype))
    leaves = tree_leaves(tree)
    if shape.mode == "train":
        leaves += tree_leaves(init_opt_state(tree))
    gen = torch.Generator(device=device).manual_seed(1)
    leaves += tree_leaves(tree_map(lambda t: _materialize(t, device, gen),
                                   lm.input_specs(cfg, shape)))
    return sum(t.nbytes for t in leaves)


_TRACES: dict = {}


def trace_cell(cfg, shape, plan=None, *, device="meta",
               param_dtype=torch.float32, compute_dtype=torch.bfloat16,
               moe_groups=0) -> dict:
    """Run the cell's step once on ``device`` under the counters (the
    counterpart of ``lower_cell``): train the forward and backward under
    ``remat`` at ``global_batch // plan.n_micro`` (the reference's
    probe), prefill ``forward_prefill``, decode one step at the last
    slot of a ``seq_len`` cache.  Returns global counts: ``flops``,
    ``bytes`` (unfused), ``saved_bytes`` (what autograd keeps for the
    backward, parameters excepted; 0 outside train), ``seconds``, and
    the ``shape`` traced.  Meta traces are kept for the process."""
    device = torch.device(device)
    if shape.mode == "train" and plan is not None and plan.n_micro > 1:
        shape = dataclasses.replace(
            shape, global_batch=max(shape.global_batch // plan.n_micro, 1))
    key = (cfg, shape, param_dtype, compute_dtype, moe_groups)
    if device.type == "meta" and key in _TRACES:
        return _TRACES[key]
    t0 = time.perf_counter()
    model = build_model(cfg, device, param_dtype, moe_groups)
    inputs = step_inputs(cfg, shape, device, compute_dtype)
    params = list(model.parameters())
    pstore = {p.untyped_storage()._cdata for p in params}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in pstore:
            saved[st._cdata] = st.nbytes()
        return t

    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        if shape.mode == "train":
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = lm.forward_train(model, inputs["batch"],
                                        compute_dtype=compute_dtype,
                                        remat=True)
            torch.autograd.grad(loss, params)
        elif shape.mode == "prefill":
            with torch.no_grad():
                lm.forward_prefill(model, inputs["batch"],
                                   compute_dtype=compute_dtype)
        else:
            with torch.no_grad():
                lm.forward_decode(model, inputs["tokens"], inputs["state"],
                                  compute_dtype=compute_dtype)
    out = {"flops": int(fc.get_total_flops()), "bytes": int(bc.bytes),
           "saved_bytes": int(sum(saved.values())),
           "seconds": time.perf_counter() - t0, "shape": shape}
    if device.type == "meta":
        _TRACES[key] = out
    return out


def _analyze(cfg, shape, plan, tr, *, with_opt, param_dtype):
    """One trace -> the reference's ``_analyze`` record, per device."""
    div = _divisor(tr["shape"], plan)
    aparams = lm.abstract_params(cfg, dtype=param_dtype)
    coll = hlo_analysis.spec_collective_stats(
        cfg, tr["shape"], plan, aparams,
        planner.param_specs(cfg, aparams, plan))
    if shape.mode == "train":
        temp = tr["saved_bytes"] / div
    else:
        st = lm.input_specs(cfg, shape)["state"] if shape.mode == "decode" \
            else prefill_state(cfg, shape.global_batch, shape.seq_len)
        temp = sum(t.numel() * t.element_size() for t in tree_leaves(st)
                   ) / div
    return {
        "flops": tr["flops"] / div,
        "bytes": tr["bytes"] / div,
        "coll_bytes": coll.total_bytes,
        "coll_counts": coll.counts,
        "coll_by_kind": coll.bytes_by_kind,
        "memory": _memory(cfg, tr["shape"], plan, with_opt=with_opt,
                          param_dtype=param_dtype, temp=temp),
        "trace_s": tr["seconds"],
    }


def _probe_cfg(cfg, depth_groups):
    """Config truncated to ``depth_groups`` layer groups (for cost probes)."""
    gs = blocks.group_size(cfg)
    changes = {"n_layers": gs * depth_groups,
               "name": f"{cfg.name}-probe{depth_groups}"}
    if cfg.is_encoder_decoder:
        changes["n_enc_layers"] = depth_groups
    return dataclasses.replace(cfg, **changes)


def _local_param_bytes(cfg, plan, mesh):
    aparams = lm.abstract_params(cfg)
    return _spec_bytes(aparams, planner.param_specs(cfg, aparams, plan),
                       mesh)


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


def cell_record(cfg, shape, mesh, plan, *, probes=True, param_dtype=None,
                moe_groups=0) -> dict:
    """The traced part of a cell's record: ``probe`` (or ``real`` without
    probes), ``memory`` and ``derived``, per device."""
    param_dtype = param_dtype or torch.float32
    rec = {"method": METHOD}
    if probes:
        rec["probe"] = _run_probes(cfg, shape, mesh, plan,
                                   param_dtype=param_dtype,
                                   moe_groups=moe_groups)
        d1, d2 = rec["probe"]["d1"], rec["probe"]["d2"]
        ng = blocks.n_groups(cfg)
        B = max(d2["memory"]["temp_size_in_bytes"]
                - d1["memory"]["temp_size_in_bytes"], 0.0)
        A = max(d1["memory"]["temp_size_in_bytes"] - B, 0.0)
        temp = A + ng * B
        rec["probe_s"] = d1["trace_s"] + d2["trace_s"]
    else:
        print(f"dryrun: --no-probes traces all {cfg.n_layers} layers of "
              f"{cfg.name} on meta; a long prefill takes many minutes",
              file=sys.stderr, flush=True)
        tr = trace_cell(cfg, shape, plan, param_dtype=param_dtype,
                        moe_groups=moe_groups)
        rec["real"] = _analyze(cfg, shape, plan, tr, with_opt=False,
                               param_dtype=param_dtype)
        temp = rec["real"]["memory"]["temp_size_in_bytes"]
        rec["trace_s"] = tr["seconds"]
    rec["memory"] = _memory(cfg, shape, plan,
                            with_opt=shape.mode == "train",
                            param_dtype=param_dtype, temp=temp)
    rec["derived"] = _derive_roofline(cfg, shape, mesh, plan, rec)
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, probes=True,
             out_dir: Path = OUT_DIR, force=False, plan_overrides=None,
             tag="baseline", serve_bf16=False, moe_scan=False,
             moe_local=False, reduced=False):
    """One cell's record, written to ``out_dir`` (and read back from there
    unless ``force``); ``reduced`` takes ``configs.base.reduced`` of the
    arch (named ``<arch>-reduced``), a CPU-sized cell."""
    cfg = cfgbase.get_config(arch)
    if reduced:
        cfg = cfgbase.reduced(cfg)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{cfg.name}__{shape_name}__{mesh_kind}__{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    shape = cfgbase.SHAPES_BY_NAME[shape_name]
    enabled, why = cfgbase.cell_enabled(cfg, shape)
    rec = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
           "tag": tag, "timestamp": time.time()}
    if not enabled:
        rec.update(status="skipped", reason=why)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    mesh = mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    plan = planner.make_plan(cfg, shape, mesh, **(plan_overrides or {}))
    # moe_scan: the port's one cumulative sum gives the scan's integers,
    # so it changes nothing here; recorded as the reference records it
    rec["plan"] = {"fsdp": plan.fsdp, "n_micro": plan.n_micro,
                   "data_axes": plan.data_axes,
                   "n_chips": plan.n_chips,
                   "cache_seq_model": plan.cache_seq_model,
                   "decode_batch_shard": plan.decode_batch_shard,
                   "serve_bf16": serve_bf16, "moe_scan": moe_scan,
                   "moe_local": moe_local}
    pdtype = (torch.bfloat16 if serve_bf16 and shape.mode != "train"
              else torch.float32)
    try:
        rec.update(cell_record(cfg, shape, mesh, plan, probes=probes,
                               param_dtype=pdtype,
                               moe_groups=plan.data_size if moe_local
                               else 0))
    except Exception as e:  # a failing cell is a bug: record it loudly
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        out_path.write_text(json.dumps(rec, indent=1))
        return rec
    rec["status"] = "ok"
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _run_probes(cfg, shape, mesh, plan, param_dtype=None, moe_groups=0):
    """Depth-1/2 probes under the cell's plan (train: one microbatch)."""
    out = {}
    for d in (1, 2):
        pcfg = _probe_cfg(cfg, d)
        tr = trace_cell(pcfg, shape, plan, param_dtype=param_dtype,
                        moe_groups=moe_groups)
        pplan = dataclasses.replace(plan, n_micro=1)
        out[f"d{d}"] = _analyze(pcfg, shape, pplan, tr, with_opt=False,
                                param_dtype=param_dtype)
    return out


def _derive_roofline(cfg, shape, mesh, plan, rec):
    """Combine probes + analytic optimizer into per-device roofline terms."""
    ng = cfg.n_layers // blocks.group_size(cfg)
    n_chips = plan.n_chips
    if "probe" in rec:
        d1, d2 = rec["probe"]["d1"], rec["probe"]["d2"]
        terms = {}
        for key in ("flops", "bytes", "coll_bytes"):
            B = max(d2[key] - d1[key], 0.0)
            A = max(d1[key] - B, 0.0)
            terms[key] = A + ng * B
        method = "probe"
    else:
        # the full depth traced: every layer counted, nothing to rebuild
        terms = {k: rec["real"][k] for k in ("flops", "bytes", "coll_bytes")}
        method = "real(full-depth meta trace)"
    if shape.mode == "train":
        for key in terms:
            terms[key] *= plan.n_micro
        # analytic AdamW: read p/m/v/g + write p/m/v (fp32), ~12 flop/p
        pl_bytes = _local_param_bytes(cfg, plan, mesh)
        terms["bytes"] += 7 * pl_bytes
        terms["flops"] += 3 * pl_bytes  # 12 flops per 4-byte param
        # grad sync was inside every probe; real pipeline syncs once
        if plan.n_micro > 1:
            dsz = plan.data_size
            gsync = 2 * (1 - 1 / dsz) * pl_bytes
            terms["coll_bytes"] -= (plan.n_micro - 1) * gsync
            terms["coll_bytes"] = max(terms["coll_bytes"], 0.0)

    t_c = terms["flops"] / mesh_lib.PEAK_FLOPS_BF16
    t_m = terms["bytes"] / mesh_lib.HBM_BW
    t_x = terms["coll_bytes"] / mesh_lib.ICI_LINK_BW
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    n_active = cfg.param_counts()["active"]
    if shape.mode == "train":
        model_flops = 6 * n_active * shape.tokens
    elif shape.mode == "prefill":
        model_flops = 2 * n_active * shape.tokens
    else:
        model_flops = 2 * n_active * shape.global_batch
    flops_global = terms["flops"] * n_chips
    return {
        "method": method,
        "flops_per_device": terms["flops"],
        "hbm_bytes_per_device": terms["bytes"],
        "coll_bytes_per_device": terms["coll_bytes"],
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "dominant": dom,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / flops_global
                               if flops_global else 0.0),
        "roofline_bound_s": max(t_c, t_m, t_x),
        "roofline_fraction": (t_c / max(t_c, t_m, t_x)
                              if max(t_c, t_m, t_x) > 0 else 0.0),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="trace the full depth (slow)")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="bf16 params for prefill/decode cells")
    ap.add_argument("--moe-scan", action="store_true",
                    help="associative-scan MoE dispatch (the same "
                         "integers as the cumulative sum: recorded only)")
    ap.add_argument("--moe-local", action="store_true",
                    help="group-local MoE dispatch (no token exchange)")
    ap.add_argument("--fsdp", default="auto", choices=("auto", "on", "off"))
    ap.add_argument("--cache-seq-model", action="store_true",
                    help="shard decode KV cache length over model axis")
    ap.add_argument("--no-decode-batch-shard", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="configs.base.reduced of each arch (CPU-sized)")
    args = ap.parse_args(argv)
    plan_overrides = {"cache_seq_model": args.cache_seq_model,
                      "decode_batch_shard": not args.no_decode_batch_shard}
    if args.fsdp != "auto":
        plan_overrides["fsdp"] = args.fsdp == "on"
    if args.n_micro:
        plan_overrides["n_micro"] = args.n_micro

    archs = ([args.arch] if args.arch
             else sorted(cfgbase.all_configs().keys()))
    shapes = ([args.shape] if args.shape
              else [s.name for s in cfgbase.SHAPES])
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    results = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                t0 = time.time()
                rec = run_cell(a, s, m, probes=not args.no_probes,
                               out_dir=Path(args.out), force=args.force,
                               tag=args.tag, serve_bf16=args.serve_bf16,
                               moe_scan=args.moe_scan,
                               moe_local=args.moe_local,
                               plan_overrides=plan_overrides,
                               reduced=args.reduced)
                dt = time.time() - t0
                st = rec.get("status", "?")
                dom = rec.get("derived", {}).get("dominant", "-")
                print(f"[{st:8s}] {a:28s} {s:12s} {m:6s} dom={dom:10s} "
                      f"({dt:.1f}s)", flush=True)
                if st == "FAILED":
                    print("    " + rec.get("error", ""), flush=True)
                results.append(rec)
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    n_fail = sum(r.get("status") == "FAILED" for r in results)
    print(f"\ndry-run cells: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
