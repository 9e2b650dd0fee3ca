"""The port's losses (mra_gan_tpu_torch/ops/losses.py) and image pool
(``pool_query`` in mra_gan_tpu_torch/models/cycle_gan.py) against the JAX
package's, on the CPU in float32.

Loss values and their gradients are held at rtol 1e-5 (float32 means in
other summation orders); 1 - r^2 also at atol 2e-6, since near r^2 = 1 its
relative error is that of r^2 over 1 - r^2 (about 20 float32 ulps of 1 at
most). The pool is held image for image and exactly: it
only copies images, and the port is given the JAX pool's own (p, slot)
draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.models.cycle_gan import PoolState
from mra_gan_tpu.models.cycle_gan import pool_query as jax_pool_query
from mra_gan_tpu.ops import losses as jl
from mra_gan_tpu_torch.models.cycle_gan import ImagePool, pool_query
from mra_gan_tpu_torch.ops import losses as pl

from torch_port_util import jax_draws

SHAPE = (2, 1, 6, 6, 6)


def _check(port_fn, jax_fn, *arrays, atol=1e-7):
    """Value and gradient (w.r.t. the first argument) of both, same inputs."""
    want, jgrad = jax.value_and_grad(lambda a, *r: jax_fn(a, *r))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    ts[0].requires_grad_()
    got = port_fn(*ts)
    got.backward()
    assert got.dtype == torch.float32 and torch.isfinite(got)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=atol)
    g = ts[0].grad.numpy()
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(g, np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgrad)).max())


@pytest.mark.parametrize("mode", ["lsgan", "vanilla"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    pred = np.random.RandomState(0).uniform(0.01, 0.99, SHAPE).astype(np.float32)
    _check(lambda p: pl.gan_loss(p, real, mode), lambda p: jl.gan_loss(p, real, mode), pred)


@pytest.mark.parametrize("real", [True, False])
def test_vanilla_loss_stays_finite_at_saturation(real):
    """A sigmoid saturated to exactly 0 and 1 in float32: the clip and the
    live-branch log keep the loss and its gradient finite, as in JAX."""
    pred = np.random.RandomState(1).uniform(0, 1, SHAPE).astype(np.float32)
    pred.flat[:5] = 0.0
    pred.flat[5:10] = 1.0
    _check(lambda p: pl.gan_loss(p, real, "vanilla"),
           lambda p: jl.gan_loss(p, real, "vanilla"), pred)
    with pytest.raises(ValueError, match="unknown gan loss"):
        pl.gan_loss(torch.from_numpy(pred), real, "wgan")


def test_l1_and_cor_coe_losses_match_jax():
    rs = np.random.RandomState(2)
    a, b = (rs.uniform(-1, 1, SHAPE).astype(np.float32) for _ in range(2))
    _check(pl.l1_loss, jl.l1_loss, a, b)
    _check(pl.cor_coe_loss, jl.cor_coe_loss, a, b, atol=2e-6)
    _check(pl.cor_coe_loss, jl.cor_coe_loss, a, 0.5 * a + 0.1 * b, atol=2e-6)
    bf = torch.from_numpy(a).to(torch.bfloat16)
    assert pl.l1_loss(bf, bf).dtype == torch.float32


def test_pool_matches_jax_image_for_image():
    """Pool of 3, batches of 2, eight queries: filling, swapping and passing
    through all happen, and every returned image and the pool's contents
    equal JAX's after each query."""
    size, batch = 3, 2
    jpool = PoolState(images=jnp.zeros((size, 4, 4, 4, 1)), count=jnp.zeros((), jnp.int32))
    pool = ImagePool(size, (1, 4, 4, 4), torch.float32, torch.device("cpu"))
    query = jax.jit(lambda pool_, imgs, k: jax_pool_query(pool_, imgs, k, size))
    rs = np.random.RandomState(3)
    swaps = passes = 0
    for q in range(8):
        imgs = rs.uniform(-1, 1, (batch, 4, 4, 4, 1)).astype(np.float32)
        rng = jax.random.PRNGKey(100 + q)
        jpool, want = query(jpool, jnp.asarray(imgs), rng)
        p, slot = jax_draws(rng, batch, size)
        full_before = pool.count >= size
        got = pool_query(pool, torch.from_numpy(np.moveaxis(imgs, -1, 1).copy()),
                         draws=(p, slot))
        np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1), np.asarray(want))
        np.testing.assert_array_equal(np.moveaxis(pool.images.numpy(), 1, -1),
                                      np.asarray(jpool.images))
        assert pool.count == int(jpool.count)
        if full_before:
            swaps += sum(v > 0.5 for v in p)
            passes += sum(v <= 0.5 for v in p)
    assert swaps > 0 and passes > 0


def test_pool_draws_from_its_generator_and_size_zero_passes_through():
    imgs = torch.rand(3, 1, 2, 2, 2)
    empty = ImagePool(0, (1, 2, 2, 2), torch.float32, torch.device("cpu"))
    assert pool_query(empty, imgs) is imgs
    pools = [ImagePool(2, (1, 2, 2, 2), torch.float32, torch.device("cpu")) for _ in range(2)]
    outs = [[pool_query(pl_, imgs + k, torch.Generator().manual_seed(0)) for k in range(4)]
            for pl_ in pools]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b)
    assert pools[0].count == 2
