"""PyTorch port: the LM seed code's configs, data and models against the
JAX package, on the CPU at the reduced configs (d_model 64, 4 heads, a
vocabulary of 256, two layers or one interleave group).

* exactly equal: every config's fields and ``param_counts`` (full and
  reduced), ``SHAPES`` and ``cell_enabled``; ``token_batch`` and
  ``lm_batches`` for the three input kinds; ``make_plan``'s ``n_micro``
  and ``fsdp`` on ``tests/test_sharding.py``'s fake mesh shapes; the MoE
  routing integers (expert ids, ``keep``, ``dst`` — against both the
  cumulative sum and the associative scan); a reference parameter tree
  carried across and back; the port's parameter count;
* float32 compute: ``blocked_attention`` (q/kv blocks of 8 at s = 33:
  causal, window, ``kv_len``, ``causal_skip`` on and off, a ``q_offset``)
  and ``decode_attention`` (contiguous and ring) within 1e-5; the MoE
  output (global and group-wise dispatch) and its aux loss, and
  ``ssd_chunked`` with a carried-in state, within 1e-5; the
  ``forward_train`` loss of all ten archs within 1e-5 relative;
* bf16 compute (the reference's default): the loss within 1e-2 relative
  for smollm, granite and jamba;
* prefill and decode at bf16 for the five archs of
  ``tests/test_models.py``: the prefill logits and the next decode
  step's logits against the reference's within 2e-2, the port's decode
  against its own prefill of the extended prompt within the reference's
  0.15 — and, with ``max_len`` (room in the cache for the decode step's
  own K/V), within 0.02.

Inputs are numpy draws from fixed seeds; weights are drawn by the port
and carried across as numpy.  One module fixture jits each reference
function once per config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.sharding import planner as jplanner
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.sharding import planner as tplanner
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ARCHS = sorted(jbase.all_configs())
DECODE_ARCHS = ["smollm-360m", "mamba2-2.7b", "jamba-1.5-large-398b",
                "h2o-danube-3-4b", "seamless-m4t-medium"]
BF16_ARCHS = ["smollm-360m", "granite-moe-3b-a800m", "jamba-1.5-large-398b"]


def cfgs(arch):
    return (jbase.reduced(jbase.get_config(arch)),
            tbase.reduced(tbase.get_config(arch)))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tiny_batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"frame_embeds": rng.normal(
            0, 1, (b, s, cfg.d_model)).astype(np.float32),
            "tgt_tokens": rng.integers(0, cfg.vocab, (b, max(8, s // 4)),
                                       dtype=np.int32)}
    if cfg.frontend == "vision":
        nf = cfg.n_frontend_tokens
        return {"tokens": rng.integers(0, cfg.vocab, (b, s - nf),
                                       dtype=np.int32),
                "patch_embeds": rng.normal(
                    0, 1, (b, nf, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's weights (numpy) and jitted functions, made once
    per (arch, function, dtype)."""
    cache = {}

    def get(arch, what, dtype=jnp.float32, seed=0):
        key = (arch, what, dtype, seed)
        if key not in cache:
            jcfg, _ = cfgs(arch)
            if what == "params":
                # drawn by the port (numpy out): the reference's init is
                # not under test, only its tree's layout (round-trip test)
                _, tcfg = cfgs(arch)
                cache[key] = tlm.lm_params_to_numpy(
                    tlm.init_params(tcfg, seed, device="cpu"))
            elif what == "train":
                # the loss at float32 and, for BF16_ARCHS, at bf16 (one
                # jit each arch)
                dts = (jnp.float32, jnp.bfloat16) if arch in BF16_ARCHS \
                    else (jnp.float32,)
                losses = jax.jit(lambda p, b, b16: [
                    jlm.forward_train(p, bt, jcfg, compute_dtype=dt,
                                      remat=False)
                    for dt, bt in zip(dts, (b, b16))])(
                        get(arch, "params"), tiny_batch(jcfg),
                        tiny_batch(jcfg, seed=1))
                cache[key] = dict(zip(dts, map(float, losses)))
            elif what == "decode":
                # prefill of the whole prompt, and a decode step after a
                # prefill of all but its last token: one jit
                def both(p, full, pre, last):
                    la, _ = jlm.forward_prefill(p, full, jcfg,
                                                compute_dtype=dtype)
                    _, st = jlm.forward_prefill(p, pre, jcfg,
                                                compute_dtype=dtype)
                    lb, _ = jlm.forward_decode(p, last, st, jcfg,
                                               compute_dtype=dtype)
                    return la, lb
                cache[key] = jax.jit(both)
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# configs, data, plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_param_counts(arch):
    jfull, tfull = jbase.get_config(arch), tbase.get_config(arch)
    jred, tred = cfgs(arch)
    for j, t in ((jfull, tfull), (jred, tred)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_counts() == j.param_counts()
        assert t.sub_quadratic == j.sub_quadratic
        assert [t.layer_kind(i) for i in range(t.n_layers)] == \
            [j.layer_kind(i) for i in range(j.n_layers)]
        assert [t.layer_is_moe(i) for i in range(t.n_layers)] == \
            [j.layer_is_moe(i) for i in range(j.n_layers)]


def test_shapes_and_cell_enabled():
    assert [dataclasses.asdict(s) for s in tbase.SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.SHAPES]
    assert sorted(tbase.all_configs()) == ARCHS
    for arch in ARCHS:
        for js, ts in zip(jbase.SHAPES, tbase.SHAPES):
            assert tbase.cell_enabled(tbase.get_config(arch), ts) == \
                jbase.cell_enabled(jbase.get_config(arch), js)


@pytest.mark.parametrize("arch", ["smollm-360m", "llava-next-34b",
                                  "seamless-m4t-medium"],
                         ids=["tokens", "vision", "enc-dec"])
def test_token_stream_exact(arch):
    jcfg, tcfg = cfgs(arch)
    for seed, start in ((0, 0), (3, 5)):
        np.testing.assert_array_equal(
            tpipe.token_batch(start, 3, 40, 256, seed),
            jpipe.token_batch(start, 3, 40, 256, seed))
        shape_j = jbase.ShapeSpec("s", 24, 2, "train")
        shape_t = tbase.ShapeSpec("s", 24, 2, "train")
        got = list(tpipe.lm_batches(tcfg, shape_t, n_steps=3, seed=seed,
                                    start_step=start))
        want = list(jpipe.lm_batches(jcfg, shape_j, n_steps=3, seed=seed,
                                     start_step=start))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


class FakeMesh:
    """Shape-only mesh stand-in, as tests/test_sharding.py's."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16},
                                  {"data": 1, "model": 1}],
                         ids=["1pod", "2pod", "local"])
def test_make_plan_accounting(mesh):
    fake = FakeMesh(mesh)
    data = int(np.prod([v for k, v in mesh.items() if k != "model"]))
    for arch in ARCHS:
        for js, ts in zip(jbase.SHAPES, tbase.SHAPES):
            for jc, tc in ((jbase.get_config(arch), tbase.get_config(arch)),
                           cfgs(arch)):
                want = jplanner.make_plan(jc, js, fake)
                got = tplanner.make_plan(tc, ts, data, mesh["model"])
                assert (got.n_micro, got.fsdp, got.n_chips) == \
                    (want.n_micro, want.fsdp, want.n_chips), (arch, js.name)


def test_local_mesh_sizes():
    from repro_torch.launch.mesh import make_local_mesh
    m = make_local_mesh(devices=["cpu"])
    assert (m.data, m.model, list(m.devices)) == (1, 1, [torch.device("cpu")])
    m = make_local_mesh(model=2, devices=["cpu"] * 4)
    assert (m.data, m.model) == (2, 2)
    with pytest.raises(ValueError):
        make_local_mesh(model=2, devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# attention, MoE, SSD
# ---------------------------------------------------------------------------


ATTN_CASES = {
    "causal": dict(causal=True),
    "causal-noskip": dict(causal=True, causal_skip=False),
    "window": dict(causal=True, window=5),
    "window-noskip": dict(causal=True, window=5, causal_skip=False),
    "kvlen": dict(causal=False, kv_len=20),
    "causal-kvlen-offset": dict(causal=True, kv_len=27, q_offset=4,
                                causal_skip=False),
}


@pytest.fixture(scope="module")
def attn_ref():
    """q, k, v and the reference's output of every case (one jit)."""
    rng = np.random.default_rng(1)
    qkv = (rng.normal(0, 1, (2, 33, 4, 16)).astype(np.float32),
           rng.normal(0, 1, (2, 33, 2, 16)).astype(np.float32),
           rng.normal(0, 1, (2, 33, 2, 16)).astype(np.float32))
    outs = jax.jit(lambda q, k, v: {
        c: jattn.blocked_attention(q, k, v, q_block=8, kv_block=8, **kw)
        for c, kw in ATTN_CASES.items()})(*qkv)
    return qkv, {c: np.asarray(o) for c, o in outs.items()}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blocked_attention(case, attn_ref):
    (q, k, v), want = attn_ref
    got = tattn.blocked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_block=8, kv_block=8, **ATTN_CASES[case]).numpy()
    assert np.abs(got - want[case]).max() <= 1e-5


@pytest.mark.parametrize("ring", [False, True], ids=["contiguous", "ring"])
def test_decode_attention(ring):
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32)
    kw = dict(cache_len=9)
    if ring:
        pos = np.array([[12, 13, 14, 15, 16, 17, 6, 7, 8, 9, 10, 11],
                        [12, -1, -1, 3, 4, 5, 6, 7, 8, 9, 10, 11]],
                       np.int32)
        kw = dict(cache_len=17, window=8, positions=pos)
    want = np.asarray(jattn.decode_attention(q, k, v, **kw))
    if ring:
        kw["positions"] = torch.from_numpy(pos)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("arch", ["smollm-360m", "h2o-danube-3-4b",
                                  "jamba-1.5-large-398b"])
def test_empty_caches_match_reference(arch):
    jcfg, tcfg = cfgs(arch)
    for max_len in (8, 40):
        if jcfg.n_heads:
            want = jattn.empty_cache(jcfg, 3, max_len)
            got = tattn.empty_cache(tcfg, 3, max_len)
            assert got.keys() == want.keys()
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype).split(".")[-1] == str(
                    want[k].dtype)
                np.testing.assert_array_equal(
                    got[k].float().numpy(), np.asarray(want[k], np.float32))
    if jcfg.ssm is not None:
        want = jssm.empty_ssm_cache(jcfg, 3)
        got = tssm.empty_ssm_cache(tcfg, 3)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        assert all(v.dtype == torch.bfloat16 for v in got.values())


class _Dims:
    d_model, d_ff = 64, 32


MOE_CASES = {
    "e4-k2": (jbase.MoEConfig(n_experts=4, top_k=2), 64),
    "e4-k2-drops": (jbase.MoEConfig(n_experts=4, top_k=2,
                                    capacity_factor=0.5), 64),
    "e40-k8": (jbase.MoEConfig(n_experts=40, top_k=8), 128),
}


def _ref_dispatch(params, x, moe, scan):
    """The reference's routing and dispatch integers (moe.py, the lines
    of ``_moe_mlp_flat`` up to ``dst``)."""
    T = x.shape[0]
    E, k = moe.n_experts, moe.top_k
    C = jmoe.capacity(T, moe)
    probs = jax.nn.softmax(x.astype(jnp.float32)
                           @ params["router"].astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    eid = idx.reshape(-1)
    oh = jax.nn.one_hot(eid, E, dtype=jnp.int32)
    pos_all = jax.lax.associative_scan(jnp.add, oh, axis=0) if scan \
        else jnp.cumsum(oh, axis=0)
    pos = jnp.take_along_axis(pos_all - 1, eid[:, None], axis=1)[:, 0]
    keep = pos < C
    dst = jnp.where(keep, eid * C + pos, E * C)
    return (idx, keep, dst), C


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_routing_integers_and_output(case, monkeypatch):
    jm, T = MOE_CASES[case]
    tm = tbase.MoEConfig(**dataclasses.asdict(jm))
    params = np_tree(jmoe.init_moe(jax.random.key(3), _Dims, jm))
    x = np.random.default_rng(4).normal(0, 1, (T, 64)).astype(np.float32)
    mod = tmoe.MoE(None, _Dims, tm)
    with torch.no_grad():
        for k, v in params.items():
            getattr(mod, k).copy_(torch.from_numpy(np.array(v)))
    xt = torch.from_numpy(x)
    _, _, idx = tmoe.route(mod, xt, tm)
    C = tmoe.capacity(T, tm)
    _, keep, dst = tmoe.dispatch(idx, tm.n_experts, C)
    both = jax.jit(lambda p, x: [_ref_dispatch(p, x, jm, scan)
                                 for scan in (False, True)])(params, x)
    for (widx, wkeep, wdst), wC in both:
        assert C == int(wC)
        np.testing.assert_array_equal(idx.numpy(), widx)
        np.testing.assert_array_equal(keep.numpy(), wkeep)
        np.testing.assert_array_equal(dst.numpy(), wdst)
    if case == "e4-k2-drops":
        assert not keep.all()  # the drop row takes duplicate writes
    with torch.no_grad():
        out, aux = tmoe.moe_mlp(mod, xt, tm, return_aux=True)
        wout, waux = jax.jit(lambda p, x: jmoe.moe_mlp(
            p, x, jm, return_aux=True))(params, x)
        assert np.abs(out.numpy() - np.asarray(wout)).max() <= 1e-5
        assert abs(float(aux) - float(waux)) <= 1e-5
        monkeypatch.setattr(jmoe, "DISPATCH_GROUPS", 2)
        wg = np.asarray(jax.jit(lambda p, x: jmoe.moe_mlp(p, x, jm))(
            params, x))
        g = tmoe.moe_mlp(mod, xt, tm, groups=2).numpy()
        assert np.abs(g - wg).max() <= 1e-5
        if not keep.all():  # capacity is per group: other choices drop
            assert np.abs(g - out.numpy()).max() > 0


def test_ssd_chunked_with_carried_state():
    rng = np.random.default_rng(5)
    b, l, g, hg, p, n = 2, 24, 1, 4, 8, 6
    x = rng.normal(0, 1, (b, l, g, hg, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, l, g, hg)).astype(np.float32)
    A = -rng.uniform(1, 16, (g * hg,)).astype(np.float32)
    B = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    C = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, g, hg, p, n)).astype(np.float32)
    wy, ws = jax.jit(lambda *a: jssm.ssd_chunked(*a, 8, initial_state=s0))(
        x, dt, A, B, C)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y, s = tssm.ssd_chunked(*t, 8, initial_state=torch.from_numpy(s0))
    assert np.abs(y.numpy() - np.asarray(wy)).max() <= 1e-5
    assert np.abs(s.numpy() - np.asarray(ws)).max() <= 1e-5


# ---------------------------------------------------------------------------
# parameters and the forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_round_trip_and_count(arch):
    """The reference's tree (its layout, names, shapes and dtypes from
    ``init_params``, random values) carried into the port and back is
    the same tree, bit for bit; the port counts ``param_counts()``."""
    jcfg, tcfg = cfgs(arch)
    shapes = jax.eval_shape(lambda: jlm.init_params(jcfg,
                                                    jax.random.key(0)))
    rng = np.random.default_rng(6)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(s.dtype),
                        shapes)
    model = tlm.lm_params_from_numpy(tree, tcfg, "cpu")
    back = tlm.lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = topt.tree_items(back)
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    n = sum(p.numel() for p in model.parameters())
    assert n == tcfg.param_counts()["total"] == \
        sum(x.size for x in jax.tree.leaves(tree))
    fresh = tlm.init_params(tcfg, 0, device="cpu")
    assert sum(p.numel() for p in fresh.parameters()) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_fp32(arch, ref):
    jcfg, tcfg = cfgs(arch)
    params = ref(arch, "params")
    batch = tiny_batch(jcfg)
    want = ref(arch, "train")[jnp.float32]
    model = tlm.lm_params_from_numpy(params, tcfg, "cpu")
    with torch.no_grad():
        got = float(tlm.forward_train(model, to_torch(batch),
                                      compute_dtype=torch.float32,
                                      remat=False))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_forward_train_loss_bf16(arch, ref):
    jcfg, tcfg = cfgs(arch)
    params = ref(arch, "params")
    batch = tiny_batch(jcfg, seed=1)
    want = ref(arch, "train")[jnp.bfloat16]
    model = tlm.lm_params_from_numpy(params, tcfg, "cpu")
    with torch.no_grad():
        got = float(tlm.forward_train(model, to_torch(batch),
                                      compute_dtype=torch.bfloat16,
                                      remat=False))
    assert abs(got - want) <= 1e-2 * abs(want), (got, want)


def _prompts(cfg, b=2, s=33):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    if cfg.is_encoder_decoder:
        fe = rng.normal(0, 1, (b, 24, cfg.d_model)).astype(np.float32)
        return ({"frame_embeds": fe, "tgt_tokens": toks},
                {"frame_embeds": fe, "tgt_tokens": toks[:, :-1]}, toks)
    return {"tokens": toks}, {"tokens": toks[:, :-1]}, toks


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_bf16(arch, ref):
    jcfg, tcfg = cfgs(arch)
    params = ref(arch, "params", seed=1)
    full, pre, toks = _prompts(jcfg)
    want_full, want_dec = ref(arch, "decode", jnp.bfloat16, seed=1)(
        params, full, pre, toks[:, -1:])
    want_full = np.asarray(want_full.astype(jnp.float32))
    want_dec = np.asarray(want_dec.astype(jnp.float32))

    model = tlm.lm_params_from_numpy(params, tcfg, "cpu")
    last = torch.from_numpy(toks[:, -1:])
    prefill = tstep.make_prefill_step(tcfg)
    decode = tstep.make_decode_step(tcfg)
    got_full, _ = prefill(model, to_torch(full))
    _, state = prefill(model, to_torch(pre))
    got_dec, state2 = decode(model, last, state)
    _, roomy = tstep.make_prefill_step(tcfg, max_len=toks.shape[1])(
        model, to_torch(pre))
    got_room, _ = decode(model, last, roomy)
    got_full, got_dec, got_room = (t.float().numpy() for t in
                                   (got_full, got_dec, got_room))
    assert state2["index"] == state["index"] + 1 == toks.shape[1]
    assert np.abs(got_full - want_full).max() <= 2e-2
    assert np.abs(got_dec - want_dec).max() <= 2e-2
    assert np.abs(got_dec - got_full).max() < 0.15
    assert np.abs(got_room - got_full).max() <= 2e-2
