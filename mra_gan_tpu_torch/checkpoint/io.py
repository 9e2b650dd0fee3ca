"""Network weights in the reference's torch state-dict layout (counterpart of
mra_gan_tpu/checkpoint/io.py:196-596), for every generator and
discriminator of the zoo.

- ``state_dict_from_jax``: the JAX param tree (numpy arrays) -> a state dict
  that strict-loads into the port's network; the same transposes as the
  JAX package's ``save_torch_network``, and under batch norm each flax
  ``Norm3D_k``'s scale and bias as the norm slot's weight and bias. Every
  leaf of the tree must land somewhere.
- ``load_jax_nets``: a whole JAX CycleGAN state's ``g_params`` and
  ``d_params`` (numpy) into the port's four networks.
- ``reference_state_dict`` / ``save_reference_pth``: a port network -> the
  reference's state dict: at every norm slot of a reference net
  (InstanceNorm3d or BatchNorm3d, both tracking running statistics) the
  ``running_mean`` (0), ``running_var`` (1) and ``num_batches_tracked`` (0)
  its strict load requires, dead state at its inference; for a Dynet,
  MONAI's duplicate ``skip_layers`` keys beside the canonical ones.
- ``read_reference_pth`` / ``load_reference_pth``: a reference (or
  ``convert_checkpoint.py --to_torch``) ``.pth`` -> strict-loaded into a
  port network, after dropping DataParallel ``module.`` prefixes, the
  running-stat buffers, and a Dynet's ``skip_layers`` aliases once each is
  found equal to its twin.

Where the port departs from the JAX package's files: under batch norm it
writes and reads the norms' ``weight``/``bias`` (JAX's export writes only
conv entries and zero conv biases, its import reads only conv weights; ROADMAP
Queue C), and under ``norm='none'`` it writes no buffers at the norm
slots, which hold an identity.
"""
from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Mapping, Union

import numpy as np
import torch
from torch import nn

from ..models.networks import (
    RESNET_BLOCKS,
    UNET_DOWNS,
    BatchNorm3d,
    ConvTranspose3d,
    Dropout,
    DynUNet3D,
    InstanceNormAct3d,
    NLayerDiscriminator3D,
    PixelDiscriminator3D,
    ResnetGenerator3D,
    UnetGenerator3D,
    _ConvBase,
)

_RUNNING_STATS = (".running_mean", ".running_var", ".num_batches_tracked")
# entry kinds: a conv (kernel DHWIO -> OIDHW, bias as it is), a transposed
# conv (DHWIO -> IODHW), a reference norm slot (Norm3D scale/bias -> weight/
# bias under batch norm, nothing otherwise), a Dynet affine instance norm
CONV, CONV_T, NORM, AFFINE = "conv", "conv_t", "norm", "affine"


def resnet_layout(n_blocks: int, use_dropout: bool) -> list:
    """(JAX param path, torch key base, kind) of every conv and norm slot of
    a ResnetGenerator, in registration order (the port's copy of
    ``_resnet_layout``; the norms' paths are the flax ``Norm3D_k`` of batch
    norm, named in creation order in each module). The residual blocks'
    second conv sits at conv_block.6 with dropout and .5 without; each norm
    sits right after its conv."""
    c2 = 6 if use_dropout else 5
    ents = []
    for i, (conv, at) in enumerate((("Conv3D_0", 1), ("Conv3D_1", 4), ("Conv3D_2", 7))):
        ents += [((conv,), f"model.{at}", CONV), ((f"Norm3D_{i}",), f"model.{at + 1}", NORM)]
    for i in range(n_blocks):
        b, blk = f"model.{10 + i}.conv_block", f"ResnetBlock3D_{i}"
        ents += [((blk, "Conv3D_0"), f"{b}.1", CONV), ((blk, "Norm3D_0"), f"{b}.2", NORM),
                 ((blk, "Conv3D_1"), f"{b}.{c2}", CONV), ((blk, "Norm3D_1"), f"{b}.{c2 + 1}", NORM)]
    base = 10 + n_blocks
    for i in range(2):
        at = base + 3 * i
        ents += [((f"ConvTranspose3D_{i}",), f"model.{at}", CONV_T),
                 ((f"Norm3D_{3 + i}",), f"model.{at + 1}", NORM)]
    ents.append((("Conv3D_3",), f"model.{base + 7}", CONV))
    return ents


def unet_layout(num_downs: int) -> list:
    """The U-Net's recursive keys (JAX ``_unet_layout``): per level the
    reference Sequential of ``UnetSkipBlock3D``; the flax blocks are flat
    siblings created innermost first (UnetSkipBlock3D_0 the innermost), a
    middle block's down norm Norm3D_0 and up norm Norm3D_1, the innermost's
    up norm Norm3D_0. Downs outermost first, then ups innermost first:
    registration order."""
    downs, ups = [], []
    prefix = "model.model"
    for lvl in range(num_downs):
        fx = f"UnetSkipBlock3D_{num_downs - 1 - lvl}"
        if lvl == 0:
            downs.append(((fx, "Conv3D_0"), f"{prefix}.0", CONV))
            ups.append([((fx, "ConvTranspose3D_0"), f"{prefix}.3", CONV_T)])
            prefix = f"{prefix}.1.model"
        elif lvl == num_downs - 1:
            downs.append(((fx, "Conv3D_0"), f"{prefix}.1", CONV))
            ups.append([((fx, "ConvTranspose3D_0"), f"{prefix}.3", CONV_T),
                        ((fx, "Norm3D_0"), f"{prefix}.4", NORM)])
        else:
            downs += [((fx, "Conv3D_0"), f"{prefix}.1", CONV),
                      ((fx, "Norm3D_0"), f"{prefix}.2", NORM)]
            ups.append([((fx, "ConvTranspose3D_0"), f"{prefix}.5", CONV_T),
                        ((fx, "Norm3D_1"), f"{prefix}.6", NORM)])
            prefix = f"{prefix}.3.model"
    return downs + [e for level in reversed(ups) for e in level]


def nlayer_d_layout(n_layers: int) -> list:
    """(JAX param path, torch key base, kind) of an NLayerDiscriminator (the
    port's copy of ``_nlayer_d_layout``): model.0, then one [conv, norm,
    lrelu] triple per layer from model.2 on, then the head."""
    ents = [(("Conv3D_0",), "model.0", CONV)]
    for n in range(1, n_layers + 1):  # the middles and the stride-1 layer
        ents += [((f"Conv3D_{n}",), f"model.{3 * n - 1}", CONV),
                 ((f"Norm3D_{n - 1}",), f"model.{3 * n}", NORM)]
    ents.append(((f"Conv3D_{n_layers + 1}",), f"model.{3 * n_layers + 2}", CONV))
    return ents


def pixel_d_layout() -> list:
    """The PixelDiscriminator's keys (JAX ``_pixel_d_layout``): its
    Sequential is ``net``, not ``model``."""
    return [(("Conv3D_0",), "net.0", CONV), (("Conv3D_1",), "net.2", CONV),
            (("Norm3D_0",), "net.3", NORM), (("Conv3D_2",), "net.5", CONV)]


def _count(tree: dict, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _res_block_entries(path: tuple, key: str, block: dict) -> list:
    ents = [(path + (c,), f"{key}.{c}.conv", CONV) for c in ("conv1", "conv2")]
    ents += [(path + (n,), f"{key}.{n}", AFFINE) for n in ("norm1", "norm2")]
    if "conv3" in block:
        ents += [(path + ("conv3",), f"{key}.conv3.conv", CONV),
                 (path + ("norm3",), f"{key}.norm3", AFFINE)]
    return ents


def dynet_layout(tree: dict) -> list:
    """The DynUNet's MONAI keys (JAX ``_dynet_entries``), in the port's
    registration order, sized from the JAX tree: input_block, downsamples.i
    (flax ``downsamples_i``), bottleneck, upsamples.j, output_block."""
    ents = _res_block_entries(("input_block",), "input_block", tree["input_block"])
    for i in range(_count(tree, "downsamples_")):
        ents += _res_block_entries((f"downsamples_{i}",), f"downsamples.{i}",
                                   tree[f"downsamples_{i}"])
    ents += _res_block_entries(("bottleneck",), "bottleneck", tree["bottleneck"])
    for j in range(_count(tree, "upsamples_")):
        u, tu = f"upsamples_{j}", f"upsamples.{j}"
        ents.append(((u, "transp_conv"), f"{tu}.transp_conv.conv", CONV_T))
        ents += _res_block_entries((u, "conv_block"), f"{tu}.conv_block",
                                   tree[u]["conv_block"])
    ents.append((("output_block",), "output_block.conv.conv", CONV))
    return ents


def dynet_alias_map(n_levels: int) -> list:
    """(alias prefix, canonical prefix) of MONAI DynUNet's duplicate keys
    (JAX ``_dynet_alias_map``): its ``skip_layers`` chain registers every
    block a second time, skip_layers(.next_layer)*i.downsample = input_block
    or downsamples.{i-1}, skip_layers(.next_layer)*i.upsample =
    upsamples.{n-2-i}, and the deepest .next_layer the bottleneck."""
    pairs = []
    for i in range(n_levels - 1):
        prefix = "skip_layers" + ".next_layer" * i
        pairs.append((prefix + ".downsample", "input_block" if i == 0 else f"downsamples.{i - 1}"))
        pairs.append((prefix + ".upsample", f"upsamples.{n_levels - 2 - i}"))
    pairs.append(("skip_layers" + ".next_layer" * (n_levels - 1), "bottleneck"))
    return pairs


def _layout(tree: dict, arch: str, use_dropout: bool) -> list:
    if arch in ("n_layers", "basic"):
        n_layers = _count(tree, "Conv3D_") - 2
        if arch == "basic" and n_layers != 3:
            raise ValueError(f"'basic' has 3 layers, the params {n_layers}")
        return nlayer_d_layout(n_layers)
    if arch == "pixel":
        return pixel_d_layout()
    if arch == "Dynet":
        return dynet_layout(tree)
    if arch in UNET_DOWNS:
        found = _count(tree, "UnetSkipBlock3D_")
        if found != UNET_DOWNS[arch]:
            raise ValueError(f"{arch} has {UNET_DOWNS[arch]} levels, the params {found}")
        return unet_layout(found)
    if arch not in RESNET_BLOCKS:
        raise ValueError(f"unknown arch {arch!r}")
    found = _count(tree, "ResnetBlock3D_")
    if found != RESNET_BLOCKS[arch]:
        raise ValueError(f"{arch} has {RESNET_BLOCKS[arch]} residual blocks, the params {found}")
    return resnet_layout(found, use_dropout)


def _leaves(tree: dict, path: tuple = ()) -> set:
    out = set()
    for k, v in tree.items():
        out |= _leaves(v, path + (k,)) if isinstance(v, Mapping) else {path + (k,)}
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def state_dict_from_jax(params_numpy: dict, arch: str = "resnet_6blocks",
                        use_dropout: bool = False) -> "OrderedDict[str, torch.Tensor]":
    """``params_numpy``: the JAX network's variables ({'params': {...}}) or
    its inner tree, as numpy arrays; ``arch`` a netG name or a netD name
    ('n_layers' sized from the tree, 'basic', 'pixel'). Conv kernels DHWIO
    -> OIDHW, transposed conv kernels DHWIO -> IODHW, biases as they are;
    batch-norm and the Dynet's affine-norm scales and biases as the norm's
    weight and bias; all float32. A leaf of the tree that the layout does
    not place raises ValueError."""
    tree = params_numpy.get("params", params_numpy)
    sd, used = OrderedDict(), set()
    for path, key, kind in _layout(tree, arch, use_dropout):
        node = tree
        for p in path:
            node = node.get(p) if isinstance(node, Mapping) else None
        if node is None:
            if kind == NORM:  # no parameters but under batch norm
                continue
            raise ValueError(f"the {arch!r} params lack {'/'.join(path)}")
        if kind in (NORM, AFFINE):
            sd[key + ".weight"], sd[key + ".bias"] = _tensor(node["scale"]), _tensor(node["bias"])
        else:
            perm = (3, 4, 0, 1, 2) if kind == CONV_T else (4, 3, 0, 1, 2)
            sd[key + ".weight"] = _tensor(np.transpose(np.asarray(node["kernel"]), perm))
            if "bias" in node:
                sd[key + ".bias"] = _tensor(node["bias"])
        used |= {path + (k,) for k in node}
    left = _leaves(tree) - used
    if left:
        raise ValueError(f"the {arch!r} layout (use_dropout={use_dropout}) leaves params "
                         f"{sorted('/'.join(p) for p in left)[:4]} unplaced")
    return sd


def load_jax_nets(nets: Mapping[str, nn.Module], g_params: dict, d_params: dict,
                  net_g: str = "resnet_6blocks", use_dropout: bool = False,
                  net_d: str = "n_layers") -> None:
    """Strict-load a JAX CycleGAN state's ``g_params`` ({'g_a', 'g_b'}) and
    ``d_params`` ({'d_a', 'd_b'}), as numpy trees, into ``nets`` (the same
    four names; any device, parameters keep their device and layout)."""
    for name, tree, arch in (("g_a", g_params, net_g), ("g_b", g_params, net_g),
                             ("d_a", d_params, net_d), ("d_b", d_params, net_d)):
        nets[name].load_state_dict(state_dict_from_jax(tree[name], arch, use_dropout),
                                   strict=True)


def _drop_dynet_aliases(sd: "OrderedDict[str, torch.Tensor]") -> None:
    """Remove the ``skip_layers`` keys of a MONAI DynUNet state dict in
    place, after checking each against its canonical twin: a merged or
    edited file whose copies diverged raises ValueError rather than load
    from one half (JAX ``_load_dynet``)."""
    aliases = [k for k in sd if k.startswith("skip_layers.")]
    if not aliases:
        return
    n_levels = 1 + sum(1 for k in sd if k.startswith("upsamples.")
                       and k.endswith(".transp_conv.conv.weight"))
    pairs = sorted(dynet_alias_map(n_levels), key=lambda pc: -len(pc[0]))
    for k in aliases:
        twin = next((canon + k[len(alias):] for alias, canon in pairs
                     if k.startswith(alias + ".")), None)
        if twin is None or twin not in sd:
            raise ValueError(f"Dynet checkpoint key {k} is no alias of a block of a "
                             f"{n_levels}-level DynUNet")
        if not torch.equal(sd[k], sd[twin]):
            raise ValueError(f"Dynet checkpoint alias {k} diverges from its canonical twin "
                             f"{twin}: MONAI DynUNet registers shared modules twice and "
                             f"both copies must be identical; this checkpoint appears "
                             f"merged or edited inconsistently")
        del sd[k]


def read_reference_pth(path: Union[str, Path]) -> "OrderedDict[str, torch.Tensor]":
    """The state dict of a reference ``.pth`` without ``module.`` prefixes,
    without running-stat buffers and, for a Dynet, without the
    ``skip_layers`` aliases (checked equal to their twins first)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = OrderedDict()
    for k, v in sd.items():
        k = k[7:] if k.startswith("module.") else k
        if not k.endswith(_RUNNING_STATS):
            out[k] = v
    _drop_dynet_aliases(out)
    return out


def has_dropout_layout(sd: Mapping[str, torch.Tensor]) -> bool:
    """Whether a resnet state dict has the dropout layout: a residual block's
    second conv at ``conv_block.6`` (a 5-D weight; without dropout, batch
    norm puts its 1-D weight there)."""
    return any(k.endswith(".conv_block.6.weight") and v.dim() == 5 for k, v in sd.items())


def load_reference_pth(path: Union[str, Path], net: nn.Module) -> nn.Module:
    """Strict-load a reference network checkpoint into ``net`` (on any
    device; the parameters keep their device and layout)."""
    net.load_state_dict(read_reference_pth(path), strict=True)
    return net


def _check_arch(net: nn.Module, arch: str, use_dropout: bool) -> None:
    """ValueError unless ``net`` is built as ``arch`` with ``use_dropout``
    names it (dropout shifts only the resnet's keys)."""
    dropout = any(isinstance(m, Dropout) for m in net.modules())
    if arch in RESNET_BLOCKS:
        ok = (isinstance(net, ResnetGenerator3D) and net.n_blocks == RESNET_BLOCKS[arch]
              and dropout == use_dropout)
    elif arch in UNET_DOWNS:
        ok = isinstance(net, UnetGenerator3D) and net.num_downs == UNET_DOWNS[arch]
    elif arch in ("basic", "n_layers"):
        ok = isinstance(net, NLayerDiscriminator3D) and (arch == "n_layers" or net.n_layers == 3)
    else:
        kinds = {"Dynet": DynUNet3D, "pixel": PixelDiscriminator3D}
        if arch not in kinds:
            raise ValueError(f"unknown arch {arch!r}")
        ok = isinstance(net, kinds[arch])
    if not ok:
        raise ValueError(f"{type(net).__name__} does not have the {arch!r} layout "
                         f"(use_dropout={use_dropout})")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).clone(memory_format=torch.contiguous_format)


def reference_state_dict(net: nn.Module, arch: str = "resnet_6blocks",
                         use_dropout: bool = False) -> "OrderedDict[str, torch.Tensor]":
    """``net``'s weights as the reference saves them: float32, contiguous,
    on the CPU, in registration order; at each norm slot of a reference net
    (the port's fused instance norms and batch norms) its ``running_mean``
    (0), ``running_var`` (1) and ``num_batches_tracked`` (0, int64), fresh
    values being exact for state that is dead at the reference's inference
    (JAX io.py:185-193, 556-560); for a Dynet, each block again under its
    ``skip_layers`` alias. ``arch`` and ``use_dropout`` name the layout as
    in ``state_dict_from_jax``; a net of another layout raises ValueError."""
    _check_arch(net, arch, use_dropout)
    sd = OrderedDict()
    channels = 0
    for name, m in net.named_modules():
        base = f"{name}." if name else ""
        for k, p in m.named_parameters(recurse=False):
            sd[base + k] = _cpu(p)
        if isinstance(m, _ConvBase):
            channels = m.weight.shape[1 if isinstance(m, ConvTranspose3d) else 0]
        if isinstance(m, (InstanceNormAct3d, BatchNorm3d)):
            c = m.weight.shape[0] if isinstance(m, BatchNorm3d) else channels
            sd[base + "running_mean"] = torch.zeros(c)
            sd[base + "running_var"] = torch.ones(c)
            sd[base + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    if isinstance(net, DynUNet3D):
        for alias, canon in dynet_alias_map(len(net.upsamples) + 1):
            for key in [k for k in sd if k.startswith(canon + ".")]:
                sd[alias + key[len(canon):]] = sd[key]
    return sd


def save_reference_pth(net: nn.Module, path: Union[str, Path], arch: str = "resnet_6blocks",
                       use_dropout: bool = False) -> None:
    """Write ``reference_state_dict(net, arch, use_dropout)`` to ``path``
    with ``torch.save``: the reference's ``{epoch}_net_*.pth``."""
    torch.save(reference_state_dict(net, arch, use_dropout), path)
