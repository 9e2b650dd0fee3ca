"""A JAX run's whole train state into the port's (counterpart of the JAX
package's ``CycleGANState`` as ``CheckpointManager.restore_raw`` returns it,
mra_gan_tpu/checkpoint/io.py:152).

The port never reads an Orbax directory itself (it imports no orbax): the
caller hands over the numpy tree that the JAX package's ``restore_raw``
returns, {g_params, d_params, opt_g, opt_d, pool_fake_a, pool_fake_b, step}.

- Parameters go through ``state_dict_from_jax``, for every network of
  the zoo.
- optax ``scale_by_adam`` (count, mu, nu; mra_gan_tpu/models/cycle_gan.py:
  153-155) becomes torch Adam's per-parameter step, exp_avg and exp_avg_sq,
  with the weights' transposes, the norms' scales and biases included
  (batch norm, the Dynet's affine norms). The norm-dead biases are left
  out: JAX keeps zero moments for them, and the port's Adam holds no
  state for a parameter that never had a gradient.
- The pools go from NDHWC to NCDHW. Where the JAX step stored them in its
  S2D(4) cell layout, (P, D/4, H/4, W/4, 64 C) with channel index
  ((pd * 4 + ph) * 4 + pw) * C + c (``_empty_pool``, cycle_gan.py:158-168;
  ops/s2d.py:36), depth-to-space comes first.
- The step comes over. The JAX step's random key is not part of its state,
  and a JAX PRNG key cannot be turned into a ``torch.Generator``'s stream:
  the state's generators keep their own states, so the next pool (and
  dropout) draws are the port's, not JAX's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.cycle_gan import CycleGANConfig, CycleGANState
from .io import load_jax_nets, state_dict_from_jax
from .manager import config_to_dict, relayout_optimizer_state

_CELL = 4  # the JAX step's space-to-depth factor


def depth_to_space(cells: np.ndarray, f: int = _CELL) -> np.ndarray:
    """(N, D, H, W, f^3 C) -> (N, f D, f H, f W, C), channel index
    ((pd * f + ph) * f + pw) * C + c: the JAX package's ``depth_to_space``
    in numpy."""
    n, d, h, w, fc = cells.shape
    c = fc // f ** 3
    x = cells.reshape(n, d, h, w, f, f, f, c).transpose(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(n, d * f, h * f, w * f, c)


def pool_images_from_jax(images: np.ndarray, patch_shape, channels: int) -> torch.Tensor:
    """A JAX pool buffer, plain (P, D, H, W, C) or in cells, as the port's
    (P, C, D, H, W)."""
    images = np.asarray(images)
    plain = (*patch_shape, channels)
    cells = (*(p // _CELL for p in patch_shape), _CELL ** 3 * channels)
    if images.shape[1:] == cells and images.shape[1:] != plain:
        images = depth_to_space(images)
    elif images.shape[1:] != plain:
        raise ValueError(f"JAX pool of shape {images.shape} fits neither {plain} nor the "
                         f"cell layout {cells}")
    return torch.from_numpy(np.array(np.moveaxis(images, -1, 1), order="C"))


def _adam_state(opt: torch.optim.Adam, nets, tree: dict, archs: dict, use_dropout: bool) -> dict:
    """torch Adam ``state_dict`` of optax's {count, mu, nu} over ``nets``
    (name -> module, in the optimizer's parameter order)."""
    step = torch.tensor(float(np.asarray(tree["count"])), dtype=torch.float32)
    state, i = {}, 0
    for name, net in nets.items():
        mu = state_dict_from_jax(tree["mu"][name], archs[name], use_dropout)
        nu = state_dict_from_jax(tree["nu"][name], archs[name], use_dropout)
        dead = {f"{m}.bias" for m, mod in net.named_modules() if getattr(mod, "dead_bias", False)}
        for key, _ in net.named_parameters():
            if key not in dead:
                state[i] = {"step": step.clone(), "exp_avg": mu[key], "exp_avg_sq": nu[key]}
            i += 1
    return {"state": state, "param_groups": opt.state_dict()["param_groups"]}


def load_jax_state(state: CycleGANState, tree: dict,
                   cfg: Optional[CycleGANConfig] = None) -> CycleGANState:
    """Load the JAX state ``tree`` (numpy, from ``restore_raw``) into the
    port's ``state`` in place, on its device, and return it. ``cfg`` is the
    JAX run's configuration in the port's ``CycleGANConfig``; None takes
    ``state.cfg``, and any other must agree with it field for field."""
    cfg = state.cfg if cfg is None else cfg
    have, want = config_to_dict(state.cfg), config_to_dict(cfg)
    for k in want:
        if have[k] != want[k]:
            raise ValueError(f"config field {k!r} is {want[k]!r}, the state's {have[k]!r}")
    use_dropout = not cfg.no_dropout
    archs = {"g_a": cfg.net_g, "g_b": cfg.net_g, "d_a": cfg.net_d, "d_b": cfg.net_d}
    with torch.no_grad():
        load_jax_nets(state.nets, tree["g_params"], tree["d_params"], cfg.net_g, use_dropout,
                      cfg.net_d)
        for opt_name, names in (("opt_g", ("g_a", "g_b")), ("opt_d", ("d_a", "d_b"))):
            opt = getattr(state, opt_name)
            opt.load_state_dict(_adam_state(opt, {n: state.nets[n] for n in names},
                                            tree[opt_name], archs, use_dropout))
            relayout_optimizer_state(opt)
        for name, channels in (("pool_fake_a", cfg.input_nc), ("pool_fake_b", cfg.output_nc)):
            pool = getattr(state, name)
            pool.images.copy_(pool_images_from_jax(tree[name]["images"], state.patch_shape,
                                                   channels))
            pool.count = int(np.asarray(tree[name]["count"]))
    state.step = int(np.asarray(tree["step"]))
    return state
