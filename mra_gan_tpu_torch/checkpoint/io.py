"""Network weights in the reference's torch state-dict layout (counterpart of
mra_gan_tpu/checkpoint/io.py:211,276,487,549).

- ``state_dict_from_jax``: the JAX param tree (numpy arrays) -> a state dict
  that strict-loads into the port's generator or PatchGAN discriminator; the
  same transposes as the JAX package's ``save_torch_network``.
- ``load_jax_nets``: a whole JAX CycleGAN state's ``g_params`` and
  ``d_params`` (numpy) into the port's four networks.
- ``load_reference_pth``: a reference (or ``convert_checkpoint.py
  --to_torch``) ``{epoch}_net_G_A.pth`` -> strict-loaded into a generator,
  after dropping DataParallel ``module.`` prefixes and the dead InstanceNorm
  running-stat buffers.
"""
from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Mapping, Union

import numpy as np
import torch
from torch import nn

_RUNNING_STATS = (".running_mean", ".running_var", ".num_batches_tracked")


def resnet_layout(n_blocks: int, use_dropout: bool) -> list:
    """(JAX param path, torch key base) of every conv of a ResnetGenerator,
    in registration order (the port's copy of ``_resnet_layout``). The
    residual blocks' second conv sits at conv_block.6 with dropout and .5
    without."""
    c2 = 6 if use_dropout else 5
    ents = [(("Conv3D_0",), "model.1"), (("Conv3D_1",), "model.4"),
            (("Conv3D_2",), "model.7")]
    for i in range(n_blocks):
        b = f"model.{10 + i}.conv_block"
        ents.append(((f"ResnetBlock3D_{i}", "Conv3D_0"), f"{b}.1"))
        ents.append(((f"ResnetBlock3D_{i}", "Conv3D_1"), f"{b}.{c2}"))
    base = 10 + n_blocks
    ents += [(("ConvTranspose3D_0",), f"model.{base}"),
             (("ConvTranspose3D_1",), f"model.{base + 3}"),
             (("Conv3D_3",), f"model.{base + 7}")]
    return ents


def nlayer_d_layout(n_layers: int) -> list:
    """(JAX param path, torch key base) of every conv of an
    NLayerDiscriminator (the port's copy of ``_nlayer_d_layout``): model.0,
    then one [conv, norm, lrelu] triple per layer from model.2 on, then the
    head."""
    ents = [(("Conv3D_0",), "model.0")]
    for n in range(1, n_layers + 1):  # the middles and the stride-1 layer
        ents.append(((f"Conv3D_{n}",), f"model.{3 * n - 1}"))
    ents.append(((f"Conv3D_{n_layers + 1}",), f"model.{3 * n_layers + 2}"))
    return ents


def _layout(tree: dict, arch: str, use_dropout: bool) -> list:
    if arch in ("n_layers", "basic"):
        n_layers = sum(1 for k in tree if k.startswith("Conv3D_")) - 2
        if arch == "basic" and n_layers != 3:
            raise ValueError(f"'basic' has 3 layers, the params {n_layers}")
        return nlayer_d_layout(n_layers)
    n_blocks = {"resnet_6blocks": 6, "resnet_9blocks": 9}.get(arch)
    if n_blocks is None:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; see ROADMAP "
                                  f"Queue A, the rest of the zoo")
    found = sum(1 for k in tree if k.startswith("ResnetBlock3D_"))
    if found != n_blocks:
        raise ValueError(f"{arch} has {n_blocks} residual blocks, the params {found}")
    return resnet_layout(n_blocks, use_dropout)


def state_dict_from_jax(params_numpy: dict, arch: str = "resnet_6blocks",
                        use_dropout: bool = False) -> "OrderedDict[str, torch.Tensor]":
    """``params_numpy``: the JAX network's variables ({'params': {...}}) or
    its inner tree, as numpy arrays; ``arch`` a generator name
    ('resnet_6blocks', 'resnet_9blocks') or a discriminator one ('n_layers',
    sized from the tree, or 'basic'). Conv kernels DHWIO -> OIDHW,
    transposed conv kernels DHWIO -> IODHW, biases as they are, all
    float32."""
    tree = params_numpy.get("params", params_numpy)
    sd = OrderedDict()
    for path, key in _layout(tree, arch, use_dropout):
        node = tree
        for p in path:
            node = node[p]
        k = np.asarray(node["kernel"], np.float32)
        perm = (3, 4, 0, 1, 2) if path[-1].startswith("ConvTranspose") else (4, 3, 0, 1, 2)
        sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(k, perm)))
        if "bias" in node:
            sd[key + ".bias"] = torch.from_numpy(np.asarray(node["bias"], np.float32).copy())
    return sd


def load_jax_nets(nets: Mapping[str, nn.Module], g_params: dict, d_params: dict,
                  net_g: str = "resnet_6blocks", use_dropout: bool = False) -> None:
    """Strict-load a JAX CycleGAN state's ``g_params`` ({'g_a', 'g_b'}) and
    ``d_params`` ({'d_a', 'd_b'}), as numpy trees, into ``nets`` (the same
    four names; any device, parameters keep their device and layout)."""
    for name, tree, arch in (("g_a", g_params, net_g), ("g_b", g_params, net_g),
                             ("d_a", d_params, "n_layers"), ("d_b", d_params, "n_layers")):
        nets[name].load_state_dict(state_dict_from_jax(tree[name], arch, use_dropout),
                                   strict=True)


def read_reference_pth(path: Union[str, Path]) -> "OrderedDict[str, torch.Tensor]":
    """The state dict of a reference ``.pth`` without ``module.`` prefixes
    and without InstanceNorm running-stat buffers."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = OrderedDict()
    for k, v in sd.items():
        k = k[7:] if k.startswith("module.") else k
        if not k.endswith(_RUNNING_STATS):
            out[k] = v
    return out


def load_reference_pth(path: Union[str, Path], net: nn.Module) -> nn.Module:
    """Strict-load a reference generator checkpoint into ``net`` (on any
    device; the parameters keep their device and layout)."""
    net.load_state_dict(read_reference_pth(path), strict=True)
    return net
