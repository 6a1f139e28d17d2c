"""Checkpointing with async save, atomic commit and retention
(counterpart of ``repro.ckpt.checkpoint``), in the reference's on-disk
layout, so a checkpoint written by either package restores in the other:

    ckpt_dir/step_000010/
        manifest.json      # entry names, shapes, dtypes, shard map
        shard_000.npz      # flat arrays, ~shard_mb each
        ...
        COMMIT             # written last: a checkpoint without it is torn

Entry names are the leaves' paths as ``jax.tree_util.keystr`` writes them
(``['groups'][0]['attn']['wq']``), in JAX's leaf order (dict keys
sorted); trees are dicts, lists and tuples of tensors or numpy arrays.
bf16 leaves are stored as ``uint16`` words (dtype ``"bfloat16"`` in the
manifest), viewed through torch, not through ``ml_dtypes``.

* ``save`` is atomic: a temporary directory, renamed, then COMMIT — a
  crash mid-save never spoils the latest valid checkpoint.
* ``AsyncCheckpointer`` copies tensors to the host, then writes on a
  background thread; one save is in flight at a time.
* ``restore`` reads into the structure, shapes and dtypes of a target
  tree of tensors, onto a device; a shape mismatch raises.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.train.optimizer import tree_items, tree_map, tree_unflatten

_BF16 = "bfloat16"


def _to_storable(leaf):
    """A leaf -> (numpy array npz can hold, its manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == _BF16:  # an ml_dtypes array, viewed, not cast
            return arr.view(np.uint16), _BF16
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir, step: int, tree, *, shard_mb: int = 512,
         keep: Optional[int] = None) -> Path:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: Dict[str, Any] = {"step": step, "entries": [], "shards": 0,
                                "time": time.time()}
    shard_bytes = shard_mb * 1024 * 1024
    cur: Dict[str, np.ndarray] = {}
    cur_sz = 0
    shard_idx = 0

    def flush():
        nonlocal cur, cur_sz, shard_idx
        if not cur:
            return
        np.savez(tmp / f"shard_{shard_idx:03d}.npz", **cur)
        shard_idx += 1
        cur, cur_sz = {}, 0

    for i, (name, leaf) in enumerate(tree_items(tree)):
        key = f"a{i:05d}"
        arr, dtype_name = _to_storable(leaf)
        manifest["entries"].append(
            {"name": name, "key": key, "shard": shard_idx,
             "shape": list(arr.shape), "dtype": dtype_name})
        cur[key] = arr
        cur_sz += arr.nbytes
        if cur_sz >= shard_bytes:
            flush()
    flush()
    manifest["shards"] = shard_idx
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    (final / "COMMIT").write_text(str(time.time()))
    if keep is not None:
        gc(ckpt_dir, keep=keep)
    return final


def valid_steps(ckpt_dir) -> List[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for p in ckpt_dir.glob("step_*"):
        if (p / "COMMIT").exists() and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir) -> Optional[int]:
    s = valid_steps(ckpt_dir)
    return s[-1] if s else None


def gc(ckpt_dir, keep: int = 3):
    steps = valid_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(Path(ckpt_dir) / f"step_{s:08d}", ignore_errors=True)


def restore(ckpt_dir, step: int, target_tree, *, device=None):
    """Restore into the structure of ``target_tree`` (tensors, ``meta``
    ones too, whose shapes and dtypes it takes): a tree of tensors on
    ``device`` (None: each target tensor's device)."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    if not (path / "COMMIT").exists():
        raise FileNotFoundError(f"checkpoint {path} is torn or missing")
    manifest = json.loads((path / "manifest.json").read_text())
    by_shard: Dict[int, List[dict]] = {}
    for e in manifest["entries"]:
        by_shard.setdefault(e["shard"], []).append(e)
    arrays: Dict[str, torch.Tensor] = {}
    for sidx, entries in by_shard.items():
        with np.load(path / f"shard_{sidx:03d}.npz") as z:
            for e in entries:
                arrays[e["name"]] = _from_storable(z[e["key"]], e["dtype"])

    out = []
    for name, leaf in tree_items(target_tree):
        if name not in arrays:
            raise KeyError(f"checkpoint missing entry {name}")
        t = arrays[name]
        want_shape = tuple(leaf.shape)
        if tuple(t.shape) != want_shape:
            raise ValueError(
                f"{name}: checkpoint shape {tuple(t.shape)} != {want_shape}")
        out.append(t.to(dtype=leaf.dtype,
                        device=device if device is not None else leaf.device))
    return tree_unflatten(target_tree, out)


def _snapshot(leaf):
    """A host copy of a tensor (the caller may write it in place later);
    an array as it is, as the reference keeps it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


class AsyncCheckpointer:
    """Non-blocking saves: snapshot to host, persist on a worker thread."""

    def __init__(self, ckpt_dir, *, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, step: int, tree):
        self.wait()  # one in-flight save at a time
        host = tree_map(_snapshot, tree)

        def work():
            try:
                save(self.ckpt_dir, step, host, keep=self.keep)
            except BaseException as e:  # re-raised by wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
