"""PyTorch port: the evaluation attacks (``transforms.ATTACKS``) against
the JAX package's on the same numpy batch.

Every entry is within 1e-5 of the reference on (3, 32, 32, 3) images,
jpeg also on a non-square batch whose sides are no multiples of 8.
``jpeg_50`` rounds each DCT coefficient over its quantiser half to even:
where the two stacks' einsum sums differ by an ulp at an exact
half-step, the rounding may land one quantisation step apart, so an
element may differ by more only where the port's pre-round value lies
within 1e-4 of a half-integer; the test counts those.  ``resize_to``
keeps its square results and takes a (nh, nw) target as
``jax.image.resize`` does.  The attacks are plain differentiable torch
ops.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transforms as jt
from repro_torch.core import transforms as tt

torch.set_num_threads(1)

ATOL = 1e-5
SHAPES = [(3, 32, 32, 3), (2, 36, 28, 3)]


def _batch(shape):
    rng = np.random.default_rng(sum(shape))
    return rng.normal(0.0, 1.0, shape).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    return _batch(SHAPES[0])


def test_registry_matches_reference():
    assert list(tt.ATTACKS) == list(jt.ATTACKS)
    assert tt.STABLE_SIG_ATTACKS == jt.STABLE_SIG_ATTACKS


@pytest.mark.parametrize("name", [n for n in jt.ATTACKS if n != "jpeg_50"])
def test_attack_within_tolerance(batch, name):
    got = tt.ATTACKS[name](torch.as_tensor(batch)).numpy()
    want = np.asarray(jt.ATTACKS[name](jnp.asarray(batch)))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=["32x32", "36x28"])
def test_jpeg_within_tolerance_off_half_steps(shape):
    batch = _batch(shape)
    x = torch.as_tensor(batch)
    got = tt.attack_jpeg(x, 50).numpy()
    want = np.asarray(jt.attack_jpeg(jnp.asarray(batch), 50))
    assert got.shape == want.shape
    scaled, _ = tt.jpeg_coefficients(x, 50)
    frac = scaled.numpy() - np.floor(scaled.numpy())
    near_half = np.abs(frac - 0.5) < 1e-4
    b, h, w, c = batch.shape
    # an element of the output depends on its 8x8 block's coefficients
    block_near = near_half.any(axis=(2, 4))              # (b, h/8, w/8, c)
    elem_near = np.repeat(np.repeat(block_near, 8, axis=1), 8, axis=2)[
        :, :h, :w]
    off = np.abs(got - want) > ATOL
    print(f"jpeg_50 {batch.shape}: {int(near_half.sum())} coefficients "
          f"within 1e-4 of a half-step, {int(off.sum())} elements beyond "
          f"{ATOL}")
    assert not (off & ~elem_near).any()


@pytest.mark.parametrize("size", [24, (20, 40), (32, 17)])
def test_resize_to_rectangular(batch, size):
    import jax
    nh, nw = (size, size) if isinstance(size, int) else size
    got = tt.resize_to(torch.as_tensor(batch), size).numpy()
    b, _, _, c = batch.shape
    want = np.asarray(jax.image.resize(jnp.asarray(batch), (b, nh, nw, c),
                                       method="bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if isinstance(size, int):
        np.testing.assert_array_equal(
            tt.resize_to(torch.as_tensor(batch), (size, size)).numpy(), got)


@pytest.mark.parametrize("name", tt.STABLE_SIG_ATTACKS)
def test_attacks_are_differentiable(name):
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    tt.ATTACKS[name](x).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
