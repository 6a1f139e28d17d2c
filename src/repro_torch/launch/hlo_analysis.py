"""Collective-traffic accounting and roofline terms (counterpart of
``repro.launch.hlo_analysis``; its text parser and ``roofline_terms``
are copies, so the port never imports the JAX package).

The reference parses a compiled SPMD module's text (per-partition
shapes) and sums the operand sizes of every collective, weighted by the
ring-algorithm transfer factor for its group size ``n``:

    all-reduce        2 (n-1)/n  x bytes     (reduce-scatter + all-gather)
    all-gather          (n-1)/n  x out bytes
    reduce-scatter      (n-1)/n  x in bytes
    all-to-all          (n-1)/n  x bytes
    collective-permute          1 x bytes

:func:`collective_stats` parses such text as the reference does.  A
one-card PyTorch program has no compiled SPMD module to parse, so
:func:`spec_collective_stats` builds the same record from the partition
specs instead (``SPEC_MODEL`` names its rules): a model of the traffic
the specs imply, with the same ring factors, not a measurement.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "fp8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "token": 0,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"=\s*(?:\(?)([a-z0-9]+\[[0-9,]*\][^ ]*|\([^)]*\))\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]  # ring-transfer bytes per device
    raw_bytes_by_kind: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def _ring(kind: str, n: int, size: float):
    """(factor, base) of one collective of ``size`` bytes (the output's;
    a reduce-scatter's shard) over a group of ``n``, as above."""
    if kind == "all-reduce":
        return 2 * (n - 1) / n, size
    if kind == "reduce-scatter":
        return (n - 1) / n, size * n
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n, size
    return 1.0, size


def collective_stats(hlo_text: str) -> CollectiveStats:
    counts: Dict[str, int] = {}
    xfer: Dict[str, float] = {}
    raw: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        out_shape, kind = m.group(1), m.group(2)
        if "-done(" in line:
            continue  # async pair: count only the -start
        size = _shape_bytes(out_shape)
        # group size n
        n = 0
        g = _GROUPS_RE.search(line)
        if g:
            n = int(g.group(2))
        else:
            ge = _GROUPS_EXPLICIT_RE.search(line)
            if ge:
                n = len(ge.group(1).split(","))
        n = max(n, 2)
        factor, base = _ring(kind, n, size)
        counts[kind] = counts.get(kind, 0) + 1
        xfer[kind] = xfer.get(kind, 0.0) + factor * base
        raw[kind] = raw.get(kind, 0.0) + float(base)
    return CollectiveStats(counts, xfer, raw)


SPEC_MODEL = (
    "spec model: FSDP leaves (sharded on the data axes) all-gather their "
    "model-local bytes over the data group once a forward (every mode) "
    "and once more a backward, and reduce-scatter their gradient (train); "
    "other leaves all-reduce their gradient over the data group (train); "
    "row-parallel matmuls with their input dim on model (wo, w_down, "
    "out_proj, MoE w_down) all-reduce their bf16 output over the model "
    "group, and in train the column-parallel ones (wq, wk, wv, w_gate, "
    "w_up, in_proj, head, MoE w_gate / w_up) all-reduce dx; one "
    "collective a layer, ring factors as in HLO; a group of one moves "
    "nothing")

_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "head")
_ROW = ("wo", "w_down", "out_proj")


def _matmul_rows(cfg, shape, plan, names) -> int:
    """Rows (tokens, or expert-buffer rows for a MoE weight) through the
    matmul of a weight at ``names`` on one device in one step: the
    batch's share of a data shard when the batch dim shards, all of it
    otherwise."""
    from repro_torch.models.moe import capacity
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        sharded = plan.decode_batch_shard and b % plan.data_size == 0
    else:
        sharded = b % plan.data_size == 0
    b_dev = b // plan.data_size if sharded else b
    name = names[-1]
    enc_dec = cfg.is_encoder_decoder
    if shape.mode == "decode":
        if "encoder" in names or ("cross" in names and name in ("wk", "wv")):
            return 0  # the encoder and the cross K/V ran in the prefill
        t = b_dev
    elif "encoder" in names or ("cross" in names and name in ("wk", "wv")):
        t = b_dev * s
    elif name == "head":
        t = b_dev * (max(64, s // 8) if enc_dec else s)
        if shape.mode == "prefill":
            t = b_dev  # the last position only
    else:
        t = b_dev * (max(64, s // 8) if enc_dec else s)
    if "moe" in names:
        moe = cfg.moe
        return moe.n_experts * capacity(t, moe)
    return t


def spec_collective_stats(cfg, shape, plan, abstract_params, param_specs,
                          *, act_bytes: int = 2) -> CollectiveStats:
    """The collectives one step of ``shape`` would run under the specs
    (``SPEC_MODEL``), per device, as a :class:`CollectiveStats`."""
    from repro_torch.sharding.planner import leaves_with_specs, spec_axes
    mesh = plan.mesh
    dsz, msz = plan.data_size, plan.model_size
    train = shape.mode == "train"
    counts: Dict[str, int] = {}
    xfer: Dict[str, float] = {}
    raw: Dict[str, float] = {}

    def add(kind, n, size, times):
        if n < 2 or times == 0 or size == 0:
            return
        factor, base = _ring(kind, n, size)
        counts[kind] = counts.get(kind, 0) + times
        xfer[kind] = xfer.get(kind, 0.0) + times * factor * base
        raw[kind] = raw.get(kind, 0.0) + times * float(base)

    for names, leaf, spec in leaves_with_specs(abstract_params, param_specs):
        stacked = any(n in ("groups", "encoder") for n in names)
        layers = leaf.shape[0] if stacked else 1
        off = 1 if stacked else 0
        axes = [spec_axes(spec[d]) for d in range(len(leaf.shape))]
        # the leaf a layer, sharded on model alone
        n = leaf.numel() // layers
        for dim_axes in axes:
            if plan.model_axis in dim_axes:
                n //= msz
        local = n * leaf.element_size()
        if any(a in plan.data_axes for ax in axes for a in ax):
            add("all-gather", dsz, local, layers * (2 if train else 1))
            if train:
                add("reduce-scatter", dsz, local // dsz, layers)
        elif train:
            add("all-reduce", dsz, local, layers)
        name = names[-1]
        if name not in _COLUMN + _ROW or msz < 2:
            continue
        rows = _matmul_rows(cfg, shape, plan, names)
        act = rows * cfg.d_model * act_bytes
        moe3 = len(leaf.shape) - off == 3
        if name in _ROW:
            in_dim = off + 1 if moe3 else off
            if plan.model_axis in axes[in_dim]:
                add("all-reduce", msz, act, layers)
        elif train:
            out_dim = off + 2 if moe3 else len(leaf.shape) - 1
            if plan.model_axis in axes[out_dim]:
                add("all-reduce", msz, act, layers)
    return CollectiveStats(counts, xfer, raw)


def roofline_terms(cost: dict, coll: CollectiveStats, n_chips: int,
                   *, peak_flops: float, hbm_bw: float, link_bw: float,
                   ici_links: int = 1) -> dict:
    """Seconds per step for each roofline term.

    cost_analysis() FLOPs/bytes on a post-SPMD module are per-partition on
    the CPU backend (the module IS the per-device program); collective
    bytes from the HLO are per-device already.
    """
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / peak_flops
    t_memory = bytes_hbm / hbm_bw
    t_coll = coll.total_bytes / (link_bw * max(ici_links, 1))
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "flops_per_device": flops,
        "hbm_bytes_per_device": bytes_hbm,
        "collective_bytes_per_device": coll.total_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "collective_counts": coll.counts,
        "collective_bytes_by_kind": coll.bytes_by_kind,
    }
