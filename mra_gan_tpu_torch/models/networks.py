"""Generators as torch nn.Modules (counterpart of mra_gan_tpu/models/networks.py).

Ported so far: ``ResnetGenerator3D`` (6 and 9 blocks) with ``ResnetBlock3D``,
affine-free instance norm, and ``define_g``/``spatial_granularity`` for them.
Module attributes follow the reference's torch ``nn.Sequential`` layout, so
the state-dict keys are the reference's (``model.1.weight``,
``model.10.conv_block.1.weight``, ...) and a reference ``.pth`` strict-loads
once its dead InstanceNorm running-stat buffers are dropped
(checkpoint/io.py). Each norm is fused with the ReLU after it; the ReLU's
slot in the Sequential holds an ``nn.Identity`` so the indices stay the
reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.conv import conv3d, conv_transpose3d, replication_pad3d
from ..ops.init import get_initializer, init_conv_
from ..ops.norm import instance_norm_act

_CL = torch.channels_last_3d


class Conv3d(nn.Module):
    """Cubic-kernel conv; weight (Cout, Cin, k, k, k), float32. Initialised
    by ``define_g`` from an explicit generator, never from the global RNG."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, self.stride, self.padding)


class ConvTranspose3d(nn.Module):
    """Transposed conv; weight (Cin, Cout, k, k, k), float32."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 2,
                 padding: int = 1, output_padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        return conv_transpose3d(x, self.weight, self.bias, self.stride, self.padding,
                                self.output_padding)


class ReplicationPad3d(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return replication_pad3d(x, self.pad)


class InstanceNormAct3d(nn.Module):
    """Affine-free InstanceNorm3d fused with its activation; no parameters and
    no running statistics (the reference's are dead state at inference)."""

    def __init__(self, act: str = "none", negative_slope: float = 0.2):
        super().__init__()
        self.act, self.negative_slope = act, negative_slope

    def forward(self, x):
        return instance_norm_act(x, act=self.act, negative_slope=self.negative_slope)

    def extra_repr(self) -> str:
        return f"act={self.act!r}"


def _conv_norm_relu(conv: nn.Module) -> list:
    # [conv, norm, relu] with the relu fused into the norm
    return [conv, InstanceNormAct3d("relu"), nn.Identity()]


class ResnetBlock3D(nn.Module):
    """pad, conv, norm+relu, [dropout], pad, conv, norm; out = x + block(x).
    With dropout the second conv sits at conv_block.6 instead of .5, as in
    the reference."""

    def __init__(self, dim: int, use_dropout: bool = False, use_bias: bool = True):
        super().__init__()
        layers = [ReplicationPad3d(1), *_conv_norm_relu(Conv3d(dim, dim, 3, bias=use_bias))]
        if use_dropout:
            layers.append(nn.Dropout(0.5))
        layers += [ReplicationPad3d(1), Conv3d(dim, dim, 3, bias=use_bias),
                   InstanceNormAct3d("none")]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator3D(nn.Module):
    """c7s1-ngf, two stride-2 downs, ``n_blocks`` residual blocks, two
    stride-2 transposed-conv ups, c7s1-output_nc + Tanh. Sequential indices:
    0 pad, 1 conv, 2 norm, 3 relu | 4-6 down1 | 7-9 down2 | 10.. blocks |
    up1 at 10+n, up2 at 13+n | 16+n pad, 17+n conv, 18+n tanh.

    On CUDA the forward runs in channels_last_3d, the norm kernels' layout."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 32,
                 n_blocks: int = 6, use_dropout: bool = False):
        super().__init__()
        self.n_blocks = n_blocks
        bias = True  # affine-free instance norm keeps the conv biases (reference)
        layers = [ReplicationPad3d(3), *_conv_norm_relu(Conv3d(input_nc, ngf, 7, bias=bias))]
        for i in range(2):
            mult = 2 ** i
            layers += _conv_norm_relu(Conv3d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                             padding=1, bias=bias))
        layers += [ResnetBlock3D(ngf * 4, use_dropout, bias) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += _conv_norm_relu(ConvTranspose3d(ngf * mult, ngf * mult // 2, 3,
                                                      stride=2, padding=1,
                                                      output_padding=1, bias=bias))
        layers += [ReplicationPad3d(3), Conv3d(ngf, output_nc, 7, bias=True), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if x.is_cuda:
            x = x.contiguous(memory_format=_CL)
        return self.model(x)


_ROADMAP_ZOO = "ROADMAP Queue A, the rest of the zoo"


def define_g(input_nc: int, output_nc: int, ngf: int, net_g: str, norm: str = "instance",
             use_dropout: bool = False, init_type: str = "normal", init_gain: float = 0.02,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Generator factory keyed by the reference's netG names; weights drawn
    from ``generator`` (a fresh seed-0 generator when None)."""
    if norm != "instance":
        raise NotImplementedError(f"norm {norm!r} is not ported yet; see {_ROADMAP_ZOO}")
    blocks = {"resnet_6blocks": 6, "resnet_9blocks": 9}.get(net_g)
    if blocks is None:
        raise NotImplementedError(f"generator {net_g!r} is not ported yet; see {_ROADMAP_ZOO}")
    net = ResnetGenerator3D(input_nc, output_nc, ngf, blocks, use_dropout)
    init = get_initializer(init_type, init_gain)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    for m in net.modules():
        if isinstance(m, (Conv3d, ConvTranspose3d)):
            init_conv_(m.weight, m.bias, isinstance(m, ConvTranspose3d), init, gen)
    return net


def spatial_granularity(net: nn.Module) -> Tuple[int, int, int]:
    """Per-axis divisibility a whole-volume forward needs: 4 for resnet (two
    stride-2 halvings)."""
    if isinstance(net, ResnetGenerator3D):
        return (4, 4, 4)
    raise NotImplementedError(f"{type(net).__name__} is not ported yet; see {_ROADMAP_ZOO}")
