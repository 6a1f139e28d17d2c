"""PyTorch port: the LM's dry-run (``repro_torch.launch.dryrun``,
``hlo_analysis``, the planner's specs, ``make_production_mesh``,
``lm.abstract_params`` / ``input_specs`` / ``abstract_decode_state``)
against the JAX package.

* every abstract leaf's shape and dtype equal to the reference's
  ``jax.eval_shape`` leaf at the same path, ten archs, four shapes;
* ``param_specs`` / ``opt_specs`` / ``batch_specs`` /
  ``decode_state_specs`` equal to the reference's ``PartitionSpec`` s
  entry for entry on the 16x16 and 2x16x16 meshes (``FakeMesh``), and
  ``make_plan`` on a mesh equal (fsdp, n_micro, axes);
* ``collective_stats`` and the derived roofline terms equal to the
  reference's on the same inputs (the times after scaling by the ratio
  of the two packages' constants); ``_local_param_bytes`` equal to the
  shard bytes of the reference's specs; the skip reason word for word;
* the meta trace's FLOPs and bytes equal to the same step's counts on
  the CPU, the probes' A + ng * B equal to a full-depth trace, and the
  spec collective model on one leaf worked by hand.

Loops over archs stay inside the tests (few cases, shared compiles).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import base as jbase
from repro.launch import dryrun as jdryrun, hlo_analysis as jhlo
from repro.models import lm as jlm
from repro.sharding import planner as jplanner
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun, hlo_analysis, mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.sharding import planner

torch.set_num_threads(1)

ARCHS = sorted(tbase.all_configs())
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Shape-only mesh stand-in, as tests/test_sharding.py's."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _abstract_mesh(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _tflat(tree, path=""):
    """(path, shape, dtype name) of a port tree's leaves, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tflat(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _tflat(v, f"{path}/{i}")]
    return [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def _jflat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = []
    for path, leaf in leaves:
        keys = "".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                       for k in path)
        out.append((keys, tuple(leaf.shape), str(leaf.dtype)))
    return out


def _tspecs(tree, specs):
    return [tuple(s) for _, _, s in planner.leaves_with_specs(tree, specs)]


def _jspecs(specs):
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]


def test_abstract_params_inputs_and_state_match_reference():
    for arch in ARCHS:
        tc, jc = tbase.get_config(arch), jbase.get_config(arch)
        for dt, jdt in ((torch.float32, np.float32),
                        (torch.bfloat16, jax.numpy.bfloat16)):
            got = lm.abstract_params(tc, dtype=dt)
            assert all(t.device.type == "meta" for t in
                       jax.tree.leaves(got, is_leaf=torch.is_tensor))
            assert _tflat(got) == _jflat(jlm.abstract_params(jc, dtype=jdt))
        for ts in tbase.SHAPES:
            js = jbase.SHAPES_BY_NAME[ts.name]
            assert _tflat(lm.input_specs(tc, ts)) == \
                _jflat(jlm.input_specs(jc, js)), (arch, ts.name)
        assert _tflat(lm.abstract_decode_state(tc, 3, 40, torch.float32)) \
            == _jflat(jlm.abstract_decode_state(jc, 3, 40, np.float32))


def test_make_plan_on_a_mesh_matches_reference():
    for mesh in MESHES.values():
        fake = FakeMesh(mesh)
        for arch in ARCHS:
            tc, jc = tbase.get_config(arch), jbase.get_config(arch)
            for ts in tbase.SHAPES:
                js = jbase.SHAPES_BY_NAME[ts.name]
                for kw in ({}, {"n_micro": 4, "fsdp": True,
                                "cache_seq_model": True,
                                "decode_batch_shard": False}):
                    got = planner.make_plan(tc, ts, fake, **kw)
                    want = jplanner.make_plan(jc, js, fake, **kw)
                    assert (got.fsdp, got.n_micro, got.data_axes,
                            got.model_axis, got.data_size, got.model_size,
                            got.n_chips, got.cache_seq_model,
                            got.decode_batch_shard) == \
                        (want.fsdp, want.n_micro, want.data_axes,
                         want.model_axis, want.data_size, want.model_size,
                         want.n_chips, want.cache_seq_model,
                         want.decode_batch_shard), (arch, ts.name)
    # the (data, model) sizes of the launcher's callers: the same plan
    cfg = tbase.get_config("smollm-360m")
    ts = tbase.SHAPES_BY_NAME["train_4k"]
    a = planner.make_plan(cfg, ts, 16, 16)
    b = planner.make_plan(cfg, ts, FakeMesh(MESHES["single"]))
    assert (a.fsdp, a.n_micro, a.data_axes, a.n_chips) == \
        (b.fsdp, b.n_micro, b.data_axes, b.n_chips)
    prod = mesh_lib.make_production_mesh(multi_pod=True)
    assert (prod.axis_names, prod.shape) == (("pod", "data", "model"),
                                             MESHES["multi"])


def test_specs_match_reference():
    for mname, mesh in MESHES.items():
        fake = FakeMesh(mesh)
        for arch in ARCHS:
            tc, jc = tbase.get_config(arch), jbase.get_config(arch)
            ts, js = (tbase.SHAPES_BY_NAME["train_4k"],
                      jbase.SHAPES_BY_NAME["train_4k"])
            tp, jp = (planner.make_plan(tc, ts, fake),
                      jplanner.make_plan(jc, js, fake))
            ta, ja = lm.abstract_params(tc), jlm.abstract_params(jc)
            assert _tspecs(ta, planner.param_specs(tc, ta, tp)) == \
                _jspecs(jplanner.param_specs(jc, ja, jp)), (arch, mname)
            assert _tspecs(ta, planner.opt_specs(tc, ta, tp)) == \
                _jspecs(jplanner.opt_specs(jc, ja, jp)), (arch, mname)
            tb = lm.input_specs(tc, ts)["batch"]
            assert _tspecs(tb, planner.batch_specs(tc, ts, tp, tb)) == \
                _jspecs(jplanner.batch_specs(
                    jc, js, jp, jlm.input_specs(jc, js)["batch"]))
            for name in ("decode_32k", "long_500k"):
                ts, js = tbase.SHAPES_BY_NAME[name], jbase.SHAPES_BY_NAME[name]
                for kw in ({}, {"cache_seq_model": True,
                                "decode_batch_shard": False}):
                    tp = planner.make_plan(tc, ts, fake, **kw)
                    jp = jplanner.make_plan(jc, js, fake, **kw)
                    st = lm.input_specs(tc, ts)["state"]
                    assert _tspecs(st, planner.decode_state_specs(
                        tc, tp, st)) == _jspecs(jplanner.decode_state_specs(
                            jc, jp, jlm.input_specs(jc, js)["state"])), \
                        (arch, name, kw)


def test_shard_shape_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["multi"]
    fake, am = FakeMesh(mesh), _abstract_mesh(mesh)
    for spec in ((("pod", "data"), "model"), (None, "model"),
                 ("data", None), (None, None)):
        got = planner.shard_shape((64, 32), planner.Spec(spec), fake)
        assert got == NamedSharding(am, P(*spec)).shard_shape((64, 32))
    pl = planner.to_shardings(
        {"a": planner.Spec([("pod", "data"), "model"]),
         "b": (planner.Spec([None, "model"]), planner.Spec())}, fake)
    assert pl["a"] == (Shard(0), Shard(0), Shard(1))
    assert pl["b"] == ((Replicate(), Replicate(), Shard(1)),
                       (Replicate(),) * 3)
    with pytest.raises(ValueError):
        planner.shard_shape((10, 32), planner.Spec(["data", None]), fake)


HLO = """
  %ag = f32[64,512]{1,0} all-gather(%x), channel_id=1, replica_groups=[16,32]<=[512], dimensions={0}
  %ar = bf16[1024]{0} all-reduce(%y), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = f32[8,8]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %rs = f32[32]{0} reduce-scatter(%w), replica_groups=[4,8]<=[32], dimensions={0}
  %a2a = bf16[16,128]{1,0} all-to-all(%v), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %ags = (f32[8,64]{1,0}, f32[64,64]{1,0}) all-gather-start(%u), replica_groups=[64,8]<=[512], dimensions={0}
  %agd = f32[64,64]{1,0} all-gather-done(%ags)
  %ars = bf16[4096]{0} all-reduce-start(%t), replica_groups={{0,1}}, to_apply=%add
  %ard = bf16[4096]{0} all-reduce-done(%ars)
"""


def test_collective_stats_and_roofline_terms_match_reference():
    got, want = hlo_analysis.collective_stats(HLO), jhlo.collective_stats(HLO)
    assert (got.counts, got.bytes_by_kind, got.raw_bytes_by_kind) == \
        (want.counts, want.bytes_by_kind, want.raw_bytes_by_kind)
    assert got.counts["all-gather"] == 2 and got.counts["all-reduce"] == 2
    assert got.total_bytes == want.total_bytes
    cost = {"flops": 3.5e15, "bytes accessed": 2.25e12}
    kw = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9, ici_links=2)
    assert hlo_analysis.roofline_terms(cost, got, 256, **kw) == \
        jhlo.roofline_terms(cost, want, 256, **kw)


def _ref_local_param_bytes(jc, jp):
    """The reference's ``_local_param_bytes``: the shard bytes of its
    specs on an abstract mesh."""
    ap = jlm.abstract_params(jc)
    specs = _jspecs(jplanner.param_specs(jc, ap, jp))
    return sum(int(np.prod(NamedSharding(jp.mesh, P(*s)).shard_shape(
        l.shape))) * l.dtype.itemsize
        for l, s in zip(jax.tree.leaves(ap), specs))


def test_local_param_bytes_match_reference_specs():
    for mname, mesh in MESHES.items():
        am = _abstract_mesh(mesh)
        for arch in ARCHS:
            tc, jc = tbase.get_config(arch), jbase.get_config(arch)
            ts = tbase.SHAPES_BY_NAME["train_4k"]
            tp = planner.make_plan(tc, ts, FakeMesh(mesh))
            jp = jplanner.make_plan(jc, jbase.SHAPES_BY_NAME["train_4k"], am)
            assert dryrun._local_param_bytes(tc, tp, tp.mesh) == \
                _ref_local_param_bytes(jc, jp), (arch, mname)


def test_derive_roofline_matches_reference(monkeypatch):
    monkeypatch.setattr(jdryrun, "_local_param_bytes",
                        lambda cfg, plan, mesh: _ref_local_param_bytes(
                            cfg, plan))
    from repro.launch import mesh as jmesh
    ratio = {"t_compute_s": jmesh.PEAK_FLOPS_BF16 / mesh_lib.PEAK_FLOPS_BF16,
             "t_memory_s": jmesh.HBM_BW / mesh_lib.HBM_BW,
             "t_collective_s": jmesh.ICI_LINK_BW / mesh_lib.ICI_LINK_BW}
    rng = np.random.default_rng(0)
    n_micros = []
    cases = [("mistral-large-123b", "train_4k", "single"),
             ("smollm-360m", "train_4k", "multi"),
             ("granite-moe-3b-a800m", "prefill_32k", "single"),
             ("jamba-1.5-large-398b", "decode_32k", "multi"),
             ("mamba2-2.7b", "long_500k", "single")]
    for arch, sname, mname in cases:
        mesh = MESHES[mname]
        tc, jc = tbase.get_config(arch), jbase.get_config(arch)
        ts, js = tbase.SHAPES_BY_NAME[sname], jbase.SHAPES_BY_NAME[sname]
        tp = planner.make_plan(tc, ts, FakeMesh(mesh))
        jp = jplanner.make_plan(jc, js, _abstract_mesh(mesh))
        d1 = {k: float(rng.integers(1, 10**12)) for k in
              ("flops", "bytes", "coll_bytes")}
        d2 = {k: d1[k] + float(rng.integers(1, 10**12)) for k in d1}
        rec = {"probe": {"d1": d1, "d2": d2}}
        got = dryrun._derive_roofline(tc, ts, tp.mesh, tp, rec)
        want = jdryrun._derive_roofline(jc, js, jp.mesh, jp, rec)
        for k in ("method", "flops_per_device", "hbm_bytes_per_device",
                  "coll_bytes_per_device", "model_flops",
                  "useful_flops_ratio"):
            assert got[k] == want[k], (arch, k)
        for k, r in ratio.items():
            assert got[k] == pytest.approx(want[k] * r, rel=1e-12), (arch, k)
        assert tp.n_micro == jp.n_micro
        n_micros.append(tp.n_micro)
    assert max(n_micros) > 1  # the gradient-sync correction ran


def test_skip_reason_matches_reference(tmp_path):
    got = dryrun.run_cell("mistral-large-123b", "long_500k", "single",
                          out_dir=tmp_path / "t", probes=False)
    want = jdryrun.run_cell("mistral-large-123b", "long_500k", "single",
                            out_dir=tmp_path / "j", probes=False)
    assert got["status"] == want["status"] == "skipped"
    assert got["reason"] == want["reason"]
    on_disk = json.loads((tmp_path / "t" / "mistral-large-123b__long_500k__"
                          "single__baseline.json").read_text())
    assert on_disk["reason"] == want["reason"]


def test_meta_trace_equals_cpu_and_probes_equal_full_depth(tmp_path,
                                                           monkeypatch):
    cfg = dryrun._probe_cfg(tbase.reduced(tbase.get_config("smollm-360m")), 3)
    monkeypatch.setattr(tbase, "get_config", lambda name: cfg)
    for mode in ("train", "prefill", "decode"):
        shape = tbase.ShapeSpec(f"tiny_{mode}", 48, 4, mode)
        plan = planner.make_plan(cfg, shape, 1, 1)
        meta = dryrun.trace_cell(cfg, shape, plan)
        cpu = dryrun.trace_cell(cfg, shape, plan, device="cpu")
        assert meta["flops"] > 0 and meta["bytes"] > 0
        for k in ("flops", "bytes", "saved_bytes"):
            assert meta[k] == cpu[k], (mode, k)
        assert (meta["saved_bytes"] > 0) == (mode == "train")
        # through run_cell on the 16x16 mesh: probes, and the full depth
        monkeypatch.setitem(tbase.SHAPES_BY_NAME, shape.name, shape)
        recs = [dryrun.run_cell(cfg.name, shape.name, "single",
                                out_dir=tmp_path, probes=p, tag=str(p))
                for p in (True, False)]
        assert [r["status"] for r in recs] == ["ok", "ok"], mode
        probe, real = recs
        assert real["derived"]["method"].startswith("real")
        for k in ("flops_per_device", "hbm_bytes_per_device",
                  "coll_bytes_per_device"):
            assert probe["derived"][k] == real["derived"][k], (mode, k)
        assert probe["memory"] == real["memory"]
        div = 16  # a batch of 4 replicates over data: model_size alone
        assert real["real"]["flops"] == meta["flops"] / div
        assert set(probe["memory"]) == {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes"}
        assert probe["memory"]["alias_size_in_bytes"] is None


def test_decode_states_and_the_prefill_state():
    for arch in ARCHS:
        cfg = tbase.reduced(tbase.get_config(arch))
        st = lm.abstract_decode_state(cfg, 2, 24)
        port = lm.decode_state_from_reference(st, cfg, index=23)
        assert len(port["caches"]) == cfg.n_layers and port["index"] == 23
        back = lm.decode_state_to_reference(port, cfg)
        assert back.pop("index") == 23
        assert _tflat(dict(back, index=st["index"])) == _tflat(st)
        # prefill_state is what forward_prefill leaves
        shape = tbase.ShapeSpec("p", 40, 2, "prefill")
        model = dryrun.build_model(cfg, "meta")
        batch = dryrun.step_inputs(cfg, shape, "meta")["batch"]
        with torch.no_grad():
            _, state = lm.forward_prefill(model, batch)
        got = lm.decode_state_to_reference(state, cfg)
        got["index"] = lm.sds((), torch.int32)
        assert _tflat(got) == _tflat(dryrun.prefill_state(cfg, 2, 40)), arch


def test_spec_collective_model_on_one_leaf():
    cfg = tbase.get_config("smollm-360m")
    shape = tbase.SHAPES_BY_NAME["train_4k"]
    plan = planner.make_plan(cfg, shape, FakeMesh(MESHES["single"]))
    assert not plan.fsdp
    L, d = cfg.n_layers, cfg.d_model
    leaf = lm.sds((L, d, d), torch.float32)  # wo, 960 x 960 a layer
    tree = {"groups": ({"attn": {"wo": leaf}},)}
    specs = planner.param_specs(cfg, tree, plan)
    assert tuple(specs["groups"][0]["attn"]["wo"]) == (None, "model", None)
    st = hlo_analysis.spec_collective_stats(cfg, shape, plan, tree, specs)
    # the gradient: 960 * 960 * 4 / 16 bytes a layer, all-reduced over
    # the 16 data devices; the output: 256 / 16 * 4096 tokens of 960
    # bf16 values, all-reduced over the 16 model devices
    grad = 960 * 960 * 4 / 16
    act = 256 // 16 * 4096 * 960 * 2
    assert st.counts == {"all-reduce": 2 * L}
    assert st.raw_bytes_by_kind == {"all-reduce": L * (grad + act)}
    assert st.bytes_by_kind["all-reduce"] == pytest.approx(
        L * 2 * 15 / 16 * (grad + act), rel=1e-12)
    # FSDP: all-gathered twice (forward, backward), reduce-scattered once
    fplan = dataclasses.replace(plan, fsdp=True)
    fspecs = planner.param_specs(cfg, tree, fplan)
    assert tuple(fspecs["groups"][0]["attn"]["wo"]) == \
        (None, "model", "data")
    st = hlo_analysis.spec_collective_stats(cfg, shape, fplan, tree, fspecs)
    assert st.counts == {"all-gather": 2 * L, "reduce-scatter": L,
                         "all-reduce": L}
    assert st.raw_bytes_by_kind["all-gather"] == 2 * L * grad
    assert st.raw_bytes_by_kind["reduce-scatter"] == L * grad
    # a 1 x 1 plan moves nothing
    one = planner.make_plan(cfg, shape, 1, 1)
    assert hlo_analysis.spec_collective_stats(
        cfg, shape, one, tree, planner.param_specs(cfg, tree, one)
    ).total_bytes == 0
