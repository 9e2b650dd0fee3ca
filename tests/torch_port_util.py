"""Shared fixtures of the PyTorch port's parity tests (tests/test_torch_port_*.py):
one generator's weights, made with numpy from a seed, run through the JAX
package and through the port."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mra_gan_tpu.models.networks import define_g
from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn

# six pytest-xdist workers share the CPU
torch.set_num_threads(2)


def jax_generator(ngf: int = 4, n_blocks: int = 6, use_dropout: bool = False,
                  seed: int = 0):
    """(flax module, numpy param tree). The weights are redrawn with numpy at
    O(1) activation scale (kernel std 1/sqrt(fan_in), bias std 0.1), so that
    a wrong transpose or layer order shows in the output."""
    net = define_g(1, ngf, f"resnet_{n_blocks}blocks", use_dropout=use_dropout)
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.zeros((1, 16, 16, 16, 1)), train=False),
                            jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def redraw(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 5:
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:4]))).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return net, jax.tree.map(redraw, shapes)


def jax_forward(net, params):
    """jitted (B, D, H, W, 1) -> (B, D, H, W, 1) float32 forward, train=False."""
    return jax.jit(lambda x: net.apply(params, x.astype(jnp.float32), train=False))


def port_generate_fn(params, n_blocks: int = 6, ngf: int = 4, use_dropout: bool = False):
    """The port's float32 GenerateFn on the CPU with the same weights."""
    cfg = CycleGANConfig(ngf=ngf, net_g=f"resnet_{n_blocks}blocks",
                         no_dropout=not use_dropout, dtype=torch.float32)
    gen = make_generate_fn(cfg, "g_a", device="cpu")
    gen.net.load_state_dict(state_dict_from_jax(params, cfg.net_g, use_dropout))
    return gen


def to_ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def to_ndhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().float().numpy(), 1, -1)
