"""Generator weights in the reference's torch state-dict layout (counterpart of
mra_gan_tpu/checkpoint/io.py:211,487,549).

- ``state_dict_from_jax``: the JAX param tree (numpy arrays) -> a state dict
  that strict-loads into the port's generator; the same transposes as the JAX
  package's ``save_torch_network``.
- ``load_reference_pth``: a reference (or ``convert_checkpoint.py
  --to_torch``) ``{epoch}_net_G_A.pth`` -> strict-loaded into a generator,
  after dropping DataParallel ``module.`` prefixes and the dead InstanceNorm
  running-stat buffers.
"""
from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Union

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


def state_dict_from_jax(params_numpy: dict, arch: str = "resnet_6blocks",
                        use_dropout: bool = False) -> "OrderedDict[str, torch.Tensor]":
    """``params_numpy``: the JAX generator's variables ({'params': {...}}) or
    its inner tree, as numpy arrays. Conv kernels DHWIO -> OIDHW, transposed
    conv kernels DHWIO -> IODHW, biases as they are, all float32."""
    n_blocks = {"resnet_6blocks": 6, "resnet_9blocks": 9}.get(arch)
    if n_blocks is None:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; see ROADMAP "
                                  f"Queue A, the rest of the zoo")
    tree = params_numpy.get("params", params_numpy)
    found = sum(1 for k in tree if k.startswith("ResnetBlock3D_"))
    if found != n_blocks:
        raise ValueError(f"{arch} has {n_blocks} residual blocks, the params {found}")
    sd = OrderedDict()
    for path, key in resnet_layout(n_blocks, use_dropout):
        node = tree
        for p in path:
            node = node[p]
        k = np.asarray(node["kernel"], np.float32)
        perm = (3, 4, 0, 1, 2) if path[-1].startswith("ConvTranspose") else (4, 3, 0, 1, 2)
        sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(k, perm)))
        if "bias" in node:
            sd[key + ".bias"] = torch.from_numpy(np.asarray(node["bias"], np.float32).copy())
    return sd


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
