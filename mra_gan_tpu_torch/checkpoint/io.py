"""Network weights in the reference's torch state-dict layout (counterpart of
mra_gan_tpu/checkpoint/io.py:196-288,487,549).

- ``state_dict_from_jax``: the JAX param tree (numpy arrays) -> a state dict
  that strict-loads into the port's generator or PatchGAN discriminator; the
  same transposes as the JAX package's ``save_torch_network``.
- ``load_jax_nets``: a whole JAX CycleGAN state's ``g_params`` and
  ``d_params`` (numpy) into the port's four networks.
- ``reference_state_dict`` / ``save_reference_pth``: a port network -> the
  reference's state dict, with the InstanceNorm running-stat buffers its
  strict load requires; the file ``save_torch_network`` writes for the same
  weights.
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
    """(JAX param path, torch key base, key base of the norm after the conv
    or None) of every conv of a ResnetGenerator, in registration order (the
    port's copy of ``_resnet_layout``). The residual blocks' second conv
    sits at conv_block.6 with dropout and .5 without; each norm sits right
    after its conv."""
    c2 = 6 if use_dropout else 5
    ents = [(("Conv3D_0",), "model.1", "model.2"), (("Conv3D_1",), "model.4", "model.5"),
            (("Conv3D_2",), "model.7", "model.8")]
    for i in range(n_blocks):
        b = f"model.{10 + i}.conv_block"
        ents.append(((f"ResnetBlock3D_{i}", "Conv3D_0"), f"{b}.1", f"{b}.2"))
        ents.append(((f"ResnetBlock3D_{i}", "Conv3D_1"), f"{b}.{c2}", f"{b}.{c2 + 1}"))
    base = 10 + n_blocks
    ents += [(("ConvTranspose3D_0",), f"model.{base}", f"model.{base + 1}"),
             (("ConvTranspose3D_1",), f"model.{base + 3}", f"model.{base + 4}"),
             (("Conv3D_3",), f"model.{base + 7}", None)]
    return ents


def nlayer_d_layout(n_layers: int) -> list:
    """(JAX param path, torch key base, norm key base or None) of every conv
    of an NLayerDiscriminator (the port's copy of ``_nlayer_d_layout``):
    model.0, then one [conv, norm, lrelu] triple per layer from model.2 on,
    then the head."""
    ents = [(("Conv3D_0",), "model.0", None)]
    for n in range(1, n_layers + 1):  # the middles and the stride-1 layer
        ents.append(((f"Conv3D_{n}",), f"model.{3 * n - 1}", f"model.{3 * n}"))
    ents.append(((f"Conv3D_{n_layers + 1}",), f"model.{3 * n_layers + 2}", None))
    return ents


def _resnet_blocks(arch: str) -> int:
    n_blocks = {"resnet_6blocks": 6, "resnet_9blocks": 9}.get(arch)
    if n_blocks is None:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; see ROADMAP "
                                  f"Queue A, the rest of the zoo")
    return n_blocks


def _layout(tree: dict, arch: str, use_dropout: bool) -> list:
    if arch in ("n_layers", "basic"):
        n_layers = sum(1 for k in tree if k.startswith("Conv3D_")) - 2
        if arch == "basic" and n_layers != 3:
            raise ValueError(f"'basic' has 3 layers, the params {n_layers}")
        return nlayer_d_layout(n_layers)
    n_blocks = _resnet_blocks(arch)
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
    for path, key, _ in _layout(tree, arch, use_dropout):
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


def reference_state_dict(net: nn.Module, arch: str = "resnet_6blocks",
                         use_dropout: bool = False) -> "OrderedDict[str, torch.Tensor]":
    """``net``'s weights as the reference saves them: float32, contiguous,
    on the CPU, in registration order, and after each conv that feeds a
    norm that norm's ``running_mean`` (0), ``running_var`` (1) and
    ``num_batches_tracked`` (0, int64). The reference's norms track running
    statistics, so its strict load requires the buffers; they are dead
    state at its inference, so fresh values are exact (JAX io.py:185-193,
    556-560). ``arch`` and ``use_dropout`` name the layout as in
    ``state_dict_from_jax``; the net's own keys must be exactly its convs'."""
    if arch in ("n_layers", "basic"):
        layout = nlayer_d_layout(3 if arch == "basic" else getattr(net, "n_layers", 0))
    else:
        layout = resnet_layout(_resnet_blocks(arch), use_dropout)
    have = net.state_dict()
    want = {f"{key}.{k}" for _, key, _ in layout for k in ("weight", "bias")}
    if set(have) != want:
        raise ValueError(f"{type(net).__name__} does not have the {arch!r} layout "
                         f"(use_dropout={use_dropout}): unexpected "
                         f"{sorted(set(have) - want)[:4]}, missing {sorted(want - set(have))[:4]}")
    sd = OrderedDict()
    for path, key, norm in layout:
        w = have[key + ".weight"]
        for k in ("weight", "bias"):
            sd[f"{key}.{k}"] = have[f"{key}.{k}"].detach().to("cpu", torch.float32).clone(
                memory_format=torch.contiguous_format)
        if norm is not None:
            cout = w.shape[1] if path[-1].startswith("ConvTranspose") else w.shape[0]
            sd[norm + ".running_mean"] = torch.zeros(cout)
            sd[norm + ".running_var"] = torch.ones(cout)
            sd[norm + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def save_reference_pth(net: nn.Module, path: Union[str, Path], arch: str = "resnet_6blocks",
                       use_dropout: bool = False) -> None:
    """Write ``reference_state_dict(net, arch, use_dropout)`` to ``path``
    with ``torch.save``: the reference's ``{epoch}_net_*.pth``."""
    torch.save(reference_state_dict(net, arch, use_dropout), path)
