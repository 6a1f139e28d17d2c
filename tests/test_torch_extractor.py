"""PyTorch port: the fp32 extractor decode against the JAX package.

Weights are numpy arrays in ``init_extractor``'s structure (nonzero
biases, so the bias path is exercised); they go to JAX as
``jnp.asarray`` and to the port through ``params_from_numpy``.  The
plain version is held to the JAX fused kernel (interpret mode), with
and without the correlation bank and the GAP embedding, within
1e-4 * (1 + max|logit|): the stacks accumulate the fp32 tap dots in
their own order (observed on this CPU: max |diff| 1.4e-6 at max |logit|
5.0 with the bank, 1.2e-6 at 3.4 without; embedding 9.5e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extractor as jex
from repro.kernels import ops as jops
from repro_torch.core import extractor as ex
from repro_torch.kernels import ops

torch.set_num_threads(1)

RTOL = 1e-4


def _tol(ref):
    return RTOL * (1.0 + float(np.abs(ref).max()))


def _params(tile, channels=16, depth=3, seed=0):
    return ex.init_extractor_numpy(seed, n_bits=60, channels=channels,
                                   depth=depth, tile=tile, bias_scale=0.1)


def _tiles(b, l, seed=1):
    return np.random.default_rng(seed).uniform(
        -2.0, 2.5, (b, l, l, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX fused kernel's (logits, embed) with and without the bank;
    its logits are bitwise the same without ``with_embed`` (the JAX
    package's own tests hold that), so one compile serves both."""
    tiles = _tiles(5, 16)
    out = {}
    for corr in (True, False):
        jpk = jex.pack_params(jax.tree.map(jnp.asarray,
                                           _params(tile=16 if corr else 0)))
        out[corr] = tuple(np.asarray(a) for a in jops.fused_extractor(
            jnp.asarray(tiles), jpk, with_embed=True))
    return tiles, out


@pytest.mark.parametrize("corr", [True, False])
@pytest.mark.parametrize("with_embed", [False, True])
def test_plain_matches_jax_kernel(jax_ref, corr, with_embed):
    tiles, ref = jax_ref
    p = _params(tile=16 if corr else 0)
    got = ops.fused_extractor(torch.as_tensor(tiles),
                              ex.pack_params(ex.params_from_numpy(p)),
                              with_embed=with_embed)
    want = ref[corr] if with_embed else ref[corr][:1]
    got = got if with_embed else (got,)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_tol(w))


def test_corr_path_changes_logits():
    """The bank is live at its native tile size and off elsewhere."""
    p = ex.params_from_numpy(_params(tile=16))
    pk = ex.pack_params(p)
    no_corr = {k: v for k, v in pk.items() if k not in ("corr",
                                                        "corr_scale")}
    t16 = torch.as_tensor(_tiles(2, 16))
    assert not torch.equal(ops.fused_extractor(t16, pk),
                           ops.fused_extractor(t16, no_corr))
    t32 = torch.as_tensor(_tiles(2, 32))
    assert torch.equal(ops.fused_extractor(t32, pk),
                       ops.fused_extractor(t32, no_corr))


def test_unfused_forward_matches_jax():
    p = _params(tile=16)
    tiles = _tiles(3, 16, seed=4)
    want = np.asarray(jax.jit(jex.extractor_forward)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(tiles)))
    got = ex.extractor_forward(ex.params_from_numpy(p),
                               torch.as_tensor(tiles)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


def test_params_from_numpy_pack_unpack_round_trip_exact():
    p = _params(tile=16)
    tp = ex.params_from_numpy(p)
    back = ex.params_to_numpy(ex.unpack_params(ex.pack_params(tp)))
    flat_a = jax.tree_util.tree_leaves_with_path(p)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert flat_b[path].dtype == leaf.dtype
        np.testing.assert_array_equal(flat_b[path], leaf)
    # the port's pack equals the JAX package's pack, leaf for leaf
    jpk = jex.pack_params(jax.tree.map(jnp.asarray, p))
    tpk = ex.params_to_numpy(ex.pack_params(tp))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jpk),
                                jax.tree_util.tree_leaves_with_path(tpk)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)


def test_init_extractor_structure_matches_reference():
    mine = ex.params_to_numpy(ex.init_extractor(
        torch.Generator().manual_seed(0), n_bits=60, channels=16, depth=3,
        tile=16))
    ref = jax.eval_shape(lambda: jex.init_extractor(
        jax.random.key(0), n_bits=60, channels=16, depth=3, tile=16))
    assert jax.tree.map(np.shape, mine) == jax.tree.map(
        lambda a: tuple(a.shape), ref)
    corr = mine["corr"].reshape(60, -1)
    np.testing.assert_allclose((corr ** 2).sum(1), 1.0, rtol=1e-5)


def test_other_dtypes_raise():
    with pytest.raises(NotImplementedError, match="item 10"):
        ex.pack_params(ex.params_from_numpy(_params(tile=0)), "bf16")
