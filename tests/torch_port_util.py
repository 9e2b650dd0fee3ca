"""Shared fixtures of the PyTorch port's parity tests (tests/test_torch_port_*.py):
network weights made with numpy from a seed, and paired JAX and port train
states, run through the JAX package and through the port."""
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
    return net, random_conv_tree(shapes, seed)


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


def random_conv_tree(shapes_tree, seed: int):
    """Redraw a JAX param tree (shapes from jax.eval_shape) with numpy at O(1)
    activation scale: kernel std 1/sqrt(fan_in), bias std 0.1."""
    rng = np.random.RandomState(seed)

    def redraw(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 5:
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:4]))).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree.map(redraw, shapes_tree)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# Every full-width instance norm of the port's paths (resnet_6blocks at ngf = 32 on
# 64^3 patches and on the 128x256x256 volume, the 3-layer PatchGAN at
# ndf = 32), written out by the route that uses_slab gives it, forward and
# backward alike: (N, C, D, H, W).
SLAB = [
    (8, 128, 16, 16, 16), (3, 128, 16, 16, 16), (16, 128, 16, 16, 16), (2, 128, 16, 16, 16),
    (1, 128, 16, 16, 16),                                          # generator trunk
    (1, 64, 16, 16, 16), (2, 64, 16, 16, 16), (8, 64, 16, 16, 16), (16, 64, 16, 16, 16),
    (1, 128, 8, 8, 8), (2, 128, 8, 8, 8), (8, 128, 8, 8, 8), (16, 128, 8, 8, 8),
    (1, 256, 7, 7, 7), (2, 256, 7, 7, 7), (8, 256, 7, 7, 7), (16, 256, 7, 7, 7),  # PatchGAN
    (2, 128, 16, 16, 28),                                          # the largest at C = 128
]
TWO_PASS = [
    (8, 32, 64, 64, 64), (3, 32, 64, 64, 64), (16, 32, 64, 64, 64), (2, 32, 64, 64, 64),
    (1, 32, 64, 64, 64), (8, 64, 32, 32, 32), (3, 64, 32, 32, 32), (16, 64, 32, 32, 32),
    (1, 64, 32, 32, 32),
    (1, 32, 128, 256, 256), (1, 64, 64, 128, 128), (1, 128, 32, 64, 64),  # the single pass
    (2, 6, 16, 16, 16),                                            # C = 6
    (2, 128, 16, 16, 29),                                          # one row past the largest
]


# The small train-step configuration of the port's step tests (as
# tests/test_torch_parity_step.py sizes its run): 16^3, ngf = ndf = 4,
# a 2-layer PatchGAN, no pool, float32.
STEP_PATCH = (16, 16, 16)
STEP_LR = 2e-4


def paired_train_states(gan_mode: str, seed: int = 0):
    """(JAX config, JAX state, port config, port state on the CPU) with the
    JAX state's initial weights loaded into the port's four networks."""
    from mra_gan_tpu.models.cycle_gan import CycleGANConfig as JaxConfig
    from mra_gan_tpu.models.cycle_gan import create_state as jax_create_state
    from mra_gan_tpu_torch.checkpoint.io import load_jax_nets
    from mra_gan_tpu_torch.models.cycle_gan import create_state

    common = dict(ngf=4, ndf=4, net_g="resnet_6blocks", net_d="n_layers", n_layers_d=2,
                  norm="instance", gan_mode=gan_mode, pool_size=0)
    jcfg = JaxConfig(**common)
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(seed), STEP_PATCH)
    cfg = CycleGANConfig(**common, dtype=torch.float32)
    state = create_state(cfg, seed, STEP_PATCH, device="cpu")
    load_jax_nets(state.nets, numpy_tree(jstate.g_params), numpy_tree(jstate.d_params))
    return jcfg, jstate, cfg, state


def jax_state_dicts(g_params, d_params) -> dict:
    """{net name: torch-layout state dict} of JAX g_params/d_params trees (or
    of gradient trees of the same structure)."""
    out = {}
    for name, tree, arch in (("g_a", g_params, "resnet_6blocks"),
                             ("g_b", g_params, "resnet_6blocks"),
                             ("d_a", d_params, "n_layers"), ("d_b", d_params, "n_layers")):
        out[name] = state_dict_from_jax(numpy_tree(tree[name]), arch)
    return out


def dead_bias_keys(net) -> set:
    """State-dict keys of the biases the port detaches (norm-dead)."""
    return {f"{name}.bias" for name, m in net.named_modules()
            if getattr(m, "dead_bias", False) and m.bias is not None}
