"""LM training launcher (counterpart of ``repro.launch.train``): state
init, checkpoint / restart, async saves and the interleaved input
pipeline, on one device — the card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 200 --reduced --batch 8 --seq 128 [--device cpu]

Fault-tolerance behaviour, as the reference's:
* saves every ``--ckpt-every`` steps — the parameters asynchronously, the
  optimizer state synchronously into ``<ckpt-dir>/opt`` — each atomic,
  in the reference's layout and entry names;
* on start, resumes from the latest valid checkpoint if present;
* ``--simulate-failure N`` exits the process hard (``os._exit(42)``)
  before step N, with no cleanup: a parameter save still in flight may
  be torn, and the restart then takes the one before it.

The local mesh (this device) feeds the plan's accounting (``n_micro``);
training runs on the one device.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.configs import base as cfgbase
from repro_torch.core.interleave import interleaved
from repro_torch.data import pipeline as data_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.sharding import planner
from repro_torch.train import optimizer as opt_lib, step as step_lib


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "(device='cpu') to train on the CPU")
    return device


def build_state(cfg, device, seed=0):
    """(model, optimizer state) on ``device``: the weights drawn from
    ``seed``, the moments zero."""
    model = lm.init_params(cfg, seed, device=device)
    return model, opt_lib.init_opt_state(lm.param_tree(model))


def _meta(tree):
    return opt_lib.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def opt_to_numpy(opt_state, cfg) -> dict:
    """The optimizer state in the reference's layout, as numpy arrays."""
    return {"m": lm.to_reference(lm.numpy_tree(opt_state["m"]), cfg),
            "v": lm.to_reference(lm.numpy_tree(opt_state["v"]), cfg),
            "step": lm.numpy_tree(opt_state["step"])}


def restore_state(ckpt_dir, step, model, opt_state, device):
    """The checkpoint of ``step`` loaded into ``model``, and the optimizer
    state of ``<ckpt_dir>/opt`` at that step (if that directory exists)."""
    cfg = model.cfg
    target = lm.to_reference(_meta(lm.param_tree(model)), cfg)
    lm.load_tree(model, lm.from_reference(
        ckpt_lib.restore(ckpt_dir, step, target, device=device), cfg))
    opt_dir = Path(ckpt_dir) / "opt"
    if opt_dir.exists():
        m = _meta(opt_state["m"])
        target = {"m": lm.to_reference(m, cfg), "v": lm.to_reference(m, cfg),
                  "step": _meta(opt_state["step"])}
        r = ckpt_lib.restore(opt_dir, step, target, device=device)
        opt_state = {"m": lm.from_reference(r["m"], cfg),
                     "v": lm.from_reference(r["v"], cfg), "step": r["step"]}
    return model, opt_state


def train_loop(cfg, shape, *, steps, device="cuda", mesh=None, opt_cfg=None,
               ckpt_dir=None, ckpt_every=50, keep=3, seed=0,
               simulate_failure=None, log_every=10, verbose=True,
               compute_dtype=torch.bfloat16):
    device = resolve_device(device)
    mesh = mesh or mesh_lib.make_local_mesh(devices=[device])
    plan = planner.make_plan(cfg, shape, mesh.data, mesh.model)
    opt_cfg = opt_cfg or opt_lib.AdamWConfig(
        total_steps=steps, lr=1e-3,
        warmup_steps=max(1, min(100, steps // 10)))
    model, opt_state = build_state(cfg, device, seed)

    start_step = 0
    ckpt = None
    if ckpt_dir is not None:
        ckpt = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=keep)
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            model, opt_state = restore_state(ckpt_dir, last, model,
                                             opt_state, device)
            start_step = last
            if verbose:
                print(f"[train] resumed from step {last}", flush=True)

    step_fn = step_lib.make_train_step(cfg, opt_cfg, n_micro=plan.n_micro,
                                       compute_dtype=compute_dtype)
    batches = interleaved(
        data_lib.lm_batches(cfg, shape, n_steps=steps - start_step,
                            seed=seed, start_step=start_step),
        depth=2, device=device)
    hist = []
    t0 = time.time()
    try:
        for i, batch in enumerate(batches):
            step_idx = start_step + i
            if simulate_failure is not None and step_idx == simulate_failure:
                os._exit(42)  # hard crash: no cleanup, no final save
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            if ckpt is not None and (step_idx + 1) % ckpt_every == 0:
                ckpt.save(step_idx + 1, lm.lm_params_to_numpy(model))
                ckpt_lib.save(Path(ckpt_dir) / "opt", step_idx + 1,
                              opt_to_numpy(opt_state, cfg), keep=keep)
            if step_idx % log_every == 0 or step_idx == steps - 1:
                loss = float(metrics["loss"])
                hist.append({"step": step_idx, "loss": loss,
                             "grad_norm": float(metrics["grad_norm"]),
                             "wall_s": time.time() - t0})
                if verbose:
                    print(f"[train] step {step_idx:5d} loss={loss:.4f} "
                          f"gnorm={hist[-1]['grad_norm']:.2f}", flush=True)
        if ckpt is not None:
            ckpt.wait()
    finally:
        if hasattr(batches, "close"):
            batches.close()
    return {"model": model, "opt_state": opt_state, "history": hist,
            "plan": plan}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = cfgbase.get_config(args.arch)
    if args.reduced:
        cfg = cfgbase.reduced(cfg)
    shape = cfgbase.ShapeSpec("custom", args.seq, args.batch, "train")
    out = train_loop(cfg, shape, steps=args.steps, device=args.device,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     simulate_failure=args.simulate_failure,
                     seed=args.seed, log_every=args.log_every)
    print(json.dumps(out["history"][-3:], indent=1))


if __name__ == "__main__":
    main()
