"""The detection batch's data-parallel split (counterpart of
``repro.sharding.planner.shard_detection_batch``) and the LM's sharding
plan (counterpart of the rest of ``repro.sharding.planner``).

The reference places a padded batch on a 1-D ``data`` mesh with a
``NamedSharding`` and lets ``jit`` propagate it through the per-image
stages.  PyTorch has no such propagation: the batch is cut into one
contiguous chunk a device, each uploaded to its device, and
``DetectionPipeline.run_batch`` runs each chunk on its own device.

For the LM, ``make_plan`` keeps the reference's arithmetic — the
gradient-accumulation microbatches that fit the activation budget, and
whether the float32 master weights need FSDP — over a mesh (anything
with ``shape`` and ``axis_names``) or a (data, model) grid of two
sizes.  The spec functions map every tensor of (params, optimizer
state, batch, decode state) to a :class:`Spec`, rule for rule as the
reference's ``PartitionSpec`` s, with divisibility-checked fallbacks:

* TP — weight matrices shard their head/ff/vocab-sized dim on ``model``;
* DP — batch dims shard on ``(pod, data)`` when divisible;
* FSDP — for models whose float32 master would not fit replicated on
  the data axis, weights also shard a d_model-sized dim on the data
  axes (ZeRO-3);
* ZeRO-1 — optimizer moments shard on the data axes when the weight
  does not;
* decode caches shard batch on data, kv-heads (or head_dim) on
  ``model``.

Everything degrades to replication when a dim does not divide.
``to_shardings`` gives each spec as DTensor placements and
``shard_shape`` one device's shard; the dry-run
(``repro_torch.launch.dryrun``) reads both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lanes import upload
from repro_torch.launch.mesh import ShapeMesh


def shard_detection_batch(devices: Sequence[torch.device], batch
                          ) -> List[Tuple[torch.device, torch.Tensor, slice]]:
    """A (padded) batch whose size the device count divides -> one
    (device, chunk on that device, its rows in the batch) a device, in
    order: contiguous chunks of equal size."""
    batch = np.asarray(batch)
    n = len(devices)
    if n == 0 or batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} does not split "
                         f"evenly over {n} devices")
    per = batch.shape[0] // n
    out = []
    for i, dev in enumerate(devices):
        rows = slice(i * per, (i + 1) * per)
        out.append((dev, upload(batch[rows], torch.device(dev)), rows))
    return out


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The LM's plan over a mesh: anything with ``shape`` (axis name ->
    size) and ``axis_names`` — :func:`repro_torch.launch.mesh.
    make_production_mesh`'s, or a (data, model) :class:`ShapeMesh`."""
    mesh: Any
    data_axes: tuple      # e.g. ("pod", "data") or ("data",)
    model_axis: str       # "model"
    fsdp: bool            # shard weights on the data axes too
    n_micro: int          # gradient-accumulation microbatches (train)
    cache_seq_model: bool = False    # shard the decode cache's length on model
    decode_batch_shard: bool = True  # shard the decode batch on data

    @property
    def data_size(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.data_axes]))

    @property
    def model_size(self) -> int:
        return int(self.mesh.shape[self.model_axis])

    @property
    def n_chips(self) -> int:
        return self.data_size * self.model_size


def make_plan(cfg, shape, mesh=1, model_size: int = 1, *,
              act_budget_bytes: float = 1.0e9,
              param_budget_bytes: float = 2.0e9,
              n_micro: Optional[int] = None,
              fsdp: Optional[bool] = None,
              cache_seq_model: bool = False,
              decode_batch_shard: bool = True) -> MeshPlan:
    """The plan over ``mesh``, or over a (``mesh``, ``model_size``)
    (data, model) grid when ``mesh`` is an int.  ``fsdp`` when the
    float32 weights over the model axis exceed ``param_budget_bytes``;
    ``n_micro`` doubled (while it divides the global batch) until the
    bf16 residual stream of every layer, spread over the chips, fits
    ``act_budget_bytes``."""
    if isinstance(mesh, int):
        mesh = ShapeMesh(("data", "model"), (mesh, model_size))
    axes = tuple(mesh.axis_names)
    data_axes = tuple(a for a in axes if a != "model")
    msize = int(mesh.shape["model"])
    dsize = int(np.prod([mesh.shape[a] for a in data_axes]))
    n_chips = msize * dsize
    total_params = cfg.param_counts()["total"]
    if fsdp is None:
        fsdp = (total_params * 4 / msize) > param_budget_bytes
    if n_micro is None:
        n_micro = 1
        if shape.mode == "train":
            carry_bytes = cfg.n_layers * shape.tokens * cfg.d_model * 2
            while (carry_bytes / n_micro / n_chips > act_budget_bytes
                   and n_micro < shape.global_batch
                   and shape.global_batch % (n_micro * 2) == 0):
                n_micro *= 2
    return MeshPlan(mesh=mesh, data_axes=data_axes, model_axis="model",
                    fsdp=fsdp, n_micro=n_micro,
                    cache_seq_model=cache_seq_model,
                    decode_batch_shard=decode_batch_shard)


# ---------------------------------------------------------------------------
# partition specs: a tuple with one entry a dimension, each None, an axis
# name or a tuple of axis names (as ``PartitionSpec`` reads them)
# ---------------------------------------------------------------------------


def _div(n, k):
    return k > 0 and n % k == 0


def _shard_dim(spec_list, dim, size, axes, mesh):
    """Try to assign ``axes`` (tuple) to dim if divisible; returns bool."""
    ax_prod = int(np.prod([mesh.shape[a] for a in axes]))
    if _div(size, ax_prod) and spec_list[dim] is None:
        spec_list[dim] = axes if len(axes) > 1 else axes[0]
        return True
    return False


def spec_axes(entry) -> tuple:
    """The mesh axes one entry of a spec names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Spec(tuple):
    """A partition spec: one entry a dimension of the tensor, each
    ``None`` (replicated), a mesh axis name or a tuple of them (the
    dimension split over those axes, major to minor), as
    ``PartitionSpec`` reads it.  A tuple, so a spec tree's leaves stand
    apart from its tuples of subtrees."""

    def __new__(cls, entries=()):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def map_with_path(fn, tree, path=(), is_leaf=None):
    """``fn(path, leaf)`` over a tree of dicts and tuples/lists, keeping
    its structure; ``path`` the keys down to the leaf (an index written
    ``[i]``, as ``jax.tree_util`` writes a sequence key)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,), is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (f"[{i}]",), is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _map2(fn, a, b):
    """``fn(leaf_a, leaf_b)`` over two trees of one structure."""
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def leaves_with_specs(tree, specs, path=()) -> list:
    """(path, leaf, spec) for every leaf of ``tree`` in JAX's order (dict
    keys sorted), ``specs`` the spec tree of the same structure."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_specs(tree[k], specs[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, (t, s) in enumerate(zip(tree, specs))
                for x in leaves_with_specs(t, s, path + (f"[{i}]",))]
    return [(path, tree, specs)]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def param_specs(cfg, abstract, plan: MeshPlan):
    """The spec tree matching ``abstract`` (``lm.abstract_params``): rules
    by leaf name and whether the leaf is layer-stacked, with shape
    divisibility deciding each dim."""
    mesh = plan.mesh
    m = plan.model_axis
    d_axes = plan.data_axes

    def spec_for(names, leaf):
        name = names[-1]
        stacked = any(n in ("groups", "encoder") for n in names)
        nd = len(leaf.shape)
        off = 1 if stacked else 0  # leading layer-stack axis never sharded
        s = [None] * nd
        if name in ("ln1", "ln2", "ln_cross", "final_norm", "enc_norm",
                    "norm", "A_log", "D", "dt_bias"):
            pass  # replicate small vectors
        elif name == "embed":
            _shard_dim(s, 0, leaf.shape[0], (m,), mesh)
            if plan.fsdp:
                _shard_dim(s, 1, leaf.shape[1], d_axes, mesh)
        elif name == "head":
            _shard_dim(s, 1, leaf.shape[1], (m,), mesh)
            if plan.fsdp:
                _shard_dim(s, 0, leaf.shape[0], d_axes, mesh)
        elif name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
            if nd - off == 3:  # MoE expert-stacked (E, d, ff)
                if not _shard_dim(s, off, leaf.shape[off], (m,), mesh):
                    _shard_dim(s, off + 2, leaf.shape[off + 2], (m,), mesh)
                if plan.fsdp:
                    _shard_dim(s, off + 1, leaf.shape[off + 1], d_axes, mesh)
            else:
                _shard_dim(s, off + 1, leaf.shape[off + 1], (m,), mesh)
                if plan.fsdp:
                    _shard_dim(s, off, leaf.shape[off], d_axes, mesh)
        elif name in ("wo", "w_down", "out_proj"):
            if nd - off == 3:  # (E, ff, d)
                if not _shard_dim(s, off, leaf.shape[off], (m,), mesh):
                    _shard_dim(s, off + 1, leaf.shape[off + 1], (m,), mesh)
                if plan.fsdp:
                    _shard_dim(s, off + 2, leaf.shape[off + 2], d_axes, mesh)
            else:
                _shard_dim(s, off, leaf.shape[off], (m,), mesh)
                if plan.fsdp:
                    _shard_dim(s, off + 1, leaf.shape[off + 1], d_axes, mesh)
        elif name == "conv_w":
            _shard_dim(s, off + 1, leaf.shape[off + 1], (m,), mesh)
        # the router (d, E) and anything else: replicated
        return Spec(s)

    return map_with_path(spec_for, abstract)


def opt_specs(cfg, abstract_params, plan: MeshPlan):
    """AdamW moments: as the parameters, plus ZeRO-1: a leaf not already
    on the data axes shards its largest dim that divides over them."""
    pspecs = param_specs(cfg, abstract_params, plan)
    mesh = plan.mesh

    def zero1(leaf, spec):
        s = list(spec) + [None] * (len(leaf.shape) - len(spec))
        used = [a for e in s for a in spec_axes(e)]
        if any(a in used for a in plan.data_axes):
            return Spec(s)  # already data-sharded (FSDP)
        order = sorted(range(len(leaf.shape)), key=lambda i: -leaf.shape[i])
        for i in order:
            if s[i] is None and _shard_dim(s, i, leaf.shape[i],
                                           plan.data_axes, mesh):
                break
        return Spec(s)

    return _map2(zero1, abstract_params, pspecs)


# ---------------------------------------------------------------------------
# batch / decode-state specs
# ---------------------------------------------------------------------------


def batch_specs(cfg, shape, plan: MeshPlan, batch_abstract):
    """Input batch: the leading batch dim on the data axes."""
    def spec_for(_, leaf):
        s = [None] * len(leaf.shape)
        _shard_dim(s, 0, leaf.shape[0], plan.data_axes, plan.mesh)
        return Spec(s)

    return map_with_path(spec_for, batch_abstract)


def decode_state_specs(cfg, plan: MeshPlan, state_abstract):
    """Decode caches: (ng, b, S, kvh, hd) attention caches, their ring
    positions (ng, b, S), SSM states (ng, b, g, hg, p, n) and conv
    windows (ng, b, cw-1, conv_dim), the cross K/V; the index replicated."""
    mesh = plan.mesh
    m = plan.model_axis

    def spec_for(names, leaf):
        name = names[-1] if names else ""
        nd = len(leaf.shape)
        s = [None] * nd
        if nd == 0:
            return Spec()
        if name == "pos":  # (ng, b, S)
            if plan.decode_batch_shard:
                _shard_dim(s, 1, leaf.shape[1], plan.data_axes, mesh)
            if plan.cache_seq_model:
                _shard_dim(s, 2, leaf.shape[2], (m,), mesh)
            return Spec(s)
        if name in ("k", "v") or (nd == 5 and name not in ("state",)):
            # (ng, b, S, kvh, hd) attn cache or cross-kv tuple leaf
            if plan.decode_batch_shard:
                _shard_dim(s, 1, leaf.shape[1], plan.data_axes, mesh)
            if plan.cache_seq_model:
                # flash-decode style: the cache length over model
                _shard_dim(s, 2, leaf.shape[2], (m,), mesh)
            elif not _shard_dim(s, 3, leaf.shape[3], (m,), mesh):
                _shard_dim(s, 4, leaf.shape[4], (m,), mesh)
            return Spec(s)
        if name == "state":  # (ng, b, g, hg, p, n)
            if plan.decode_batch_shard:
                _shard_dim(s, 1, leaf.shape[1], plan.data_axes, mesh)
            _shard_dim(s, 3, leaf.shape[3], (m,), mesh)
            return Spec(s)
        if name == "conv":  # (ng, b, cw-1, conv_dim)
            if plan.decode_batch_shard:
                _shard_dim(s, 1, leaf.shape[1], plan.data_axes, mesh)
            _shard_dim(s, 3, leaf.shape[3], (m,), mesh)
            return Spec(s)
        if nd >= 2:
            _shard_dim(s, 1 if nd > 2 else 0, leaf.shape[1 if nd > 2 else 0],
                       plan.data_axes, mesh)
        return Spec(s)

    return map_with_path(spec_for, state_abstract)


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec`` (each sharded dim divided by its axes' sizes, which must
    divide it, as ``NamedSharding.shard_shape`` requires)."""
    out = []
    for d, size in enumerate(shape):
        n = int(np.prod([mesh.shape[a] for a in
                         spec_axes(spec[d] if d < len(spec) else None)]))
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {spec[d]}")
        out.append(size // n)
    return tuple(out)


def to_shardings(specs, mesh):
    """Each spec as DTensor placements over ``mesh``: one
    ``Shard(dim)`` or ``Replicate()`` a mesh axis, in
    ``mesh.axis_names``' order (a dim on several axes is split by them
    major to minor, as the spec's tuple lists them in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    def placements(_, spec):
        where = {a: d for d, e in enumerate(spec) for a in spec_axes(e)}
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in mesh.axis_names)

    return map_with_path(placements, specs,
                         is_leaf=lambda x: isinstance(x, Spec))
