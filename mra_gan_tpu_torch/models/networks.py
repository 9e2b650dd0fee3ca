"""Generators and discriminators as torch nn.Modules (counterpart of
mra_gan_tpu/models/networks.py).

Ported so far: ``ResnetGenerator3D`` (6 and 9 blocks) with ``ResnetBlock3D``,
``NLayerDiscriminator3D`` (the PatchGAN), affine-free instance norm, and
``define_g``/``define_d``/``spatial_granularity`` for them. Module
attributes follow the reference's torch ``nn.Sequential`` layout, so the
state-dict keys are the reference's (``model.1.weight``,
``model.10.conv_block.1.weight``, ...) and a reference ``.pth`` strict-loads
once its dead InstanceNorm running-stat buffers are dropped
(checkpoint/io.py). Each norm is fused with the activation after it; the
activation's slot in the Sequential holds an ``nn.Identity`` so the indices
stay the reference's.

A conv whose output goes straight into an instance norm has a dead bias:
the norm subtracts the per-channel mean, so the bias's true gradient is
exactly 0. Such a conv (``dead_bias=True``) adds ``bias.detach()``, as the
JAX package ``stop_gradient``s it (networks.py ``Conv3D.dead_bias``): the
bias keeps its checkpoint slot and its forward add, its ``.grad`` stays
None and Adam leaves it where it is.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.conv import conv3d, conv_transpose3d, replication_pad3d
from ..ops.init import get_initializer, init_conv_
from ..ops.norm import instance_norm_act

_CL = torch.channels_last_3d


class _ConvBase(nn.Module):
    def __init__(self, weight_shape: tuple, out_ch: int, bias: bool, dead_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.dead_bias = dead_bias

    def live_bias(self) -> Optional[torch.Tensor]:
        """The bias as the forward adds it: detached where it is norm-dead."""
        if self.bias is None or not self.dead_bias:
            return self.bias
        return self.bias.detach()


class Conv3d(_ConvBase):
    """Cubic-kernel conv; weight (Cout, Cin, k, k, k), float32. Initialised
    by ``define_g``/``define_d`` from an explicit generator, never from the
    global RNG."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dead_bias: bool = False):
        k = kernel_size
        super().__init__((out_ch, in_ch, k, k, k), out_ch, bias, dead_bias)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return conv3d(x, self.weight, self.live_bias(), self.stride, self.padding)


class ConvTranspose3d(_ConvBase):
    """Transposed conv; weight (Cin, Cout, k, k, k), float32."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 2,
                 padding: int = 1, output_padding: int = 0, bias: bool = True,
                 dead_bias: bool = False):
        k = kernel_size
        super().__init__((in_ch, out_ch, k, k, k), out_ch, bias, dead_bias)
        self.stride, self.padding, self.output_padding = stride, padding, output_padding

    def forward(self, x):
        return conv_transpose3d(x, self.weight, self.live_bias(), self.stride, self.padding,
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


class Dropout(nn.Module):
    """``nn.Dropout`` that draws its mask from ``generator``, a
    ``torch.Generator`` on the input's device that the train state owns
    (``CycleGANState.dropout_generator``), so that a checkpoint holds the
    draws and a resumed run drops the same voxels. With ``generator`` None
    it draws from torch's global RNG. Identity in eval mode; no parameters,
    so it keeps the reference's key layout.

    The JAX package draws six independent masks per step from keys split off
    the step's rng (mra_gan_tpu/models/cycle_gan.py:403-408); a JAX key
    cannot be turned into a torch generator's stream, so the port's masks
    are its own, and only its own resume is exact."""

    def __init__(self, p: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        u = torch.empty_like(x, dtype=torch.float32).uniform_(generator=self.generator)
        return x * (u >= self.p).to(x.dtype) * (1.0 / (1.0 - self.p))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def _conv_norm_act(conv: nn.Module, act: str = "relu") -> list:
    # [conv, norm, act] with the activation fused into the norm
    return [conv, InstanceNormAct3d(act), nn.Identity()]


def _channels_last_on_cuda(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=_CL) if x.is_cuda else x


class ResnetBlock3D(nn.Module):
    """pad, conv, norm+relu, [dropout], pad, conv, norm; out = x + block(x).
    With dropout the second conv sits at conv_block.6 instead of .5, as in
    the reference."""

    def __init__(self, dim: int, use_dropout: bool = False, use_bias: bool = True):
        super().__init__()
        layers = [ReplicationPad3d(1),
                  *_conv_norm_act(Conv3d(dim, dim, 3, bias=use_bias, dead_bias=True))]
        if use_dropout:
            layers.append(Dropout(0.5))
        layers += [ReplicationPad3d(1), Conv3d(dim, dim, 3, bias=use_bias, dead_bias=True),
                   InstanceNormAct3d("none")]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator3D(nn.Module):
    """c7s1-ngf, two stride-2 downs, ``n_blocks`` residual blocks, two
    stride-2 transposed-conv ups, c7s1-output_nc + Tanh. Sequential indices:
    0 pad, 1 conv, 2 norm, 3 relu | 4-6 down1 | 7-9 down2 | 10.. blocks |
    up1 at 10+n, up2 at 13+n | 16+n pad, 17+n conv, 18+n tanh.

    On CUDA the forward runs in channels_last_3d, the norm kernels' layout.
    Every conv but the head feeds a norm and has a dead bias."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 32,
                 n_blocks: int = 6, use_dropout: bool = False):
        super().__init__()
        self.n_blocks = n_blocks
        bias = True  # affine-free instance norm keeps the conv biases (reference)
        layers = [ReplicationPad3d(3),
                  *_conv_norm_act(Conv3d(input_nc, ngf, 7, bias=bias, dead_bias=True))]
        for i in range(2):
            mult = 2 ** i
            layers += _conv_norm_act(Conv3d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                            padding=1, bias=bias, dead_bias=True))
        layers += [ResnetBlock3D(ngf * 4, use_dropout, bias) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += _conv_norm_act(ConvTranspose3d(ngf * mult, ngf * mult // 2, 3,
                                                     stride=2, padding=1, output_padding=1,
                                                     bias=bias, dead_bias=True))
        layers += [ReplicationPad3d(3), Conv3d(ngf, output_nc, 7, bias=True), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(_channels_last_on_cuda(x))


def _patchgan_output_shape(spatial: Sequence[int], n_layers: int) -> Tuple[int, ...]:
    """The PatchGAN's output size per axis: ``n_layers`` k4/s2/p1 convs, then
    two k4/s1/p1 convs that take one voxel each."""
    dims = list(spatial)
    for _ in range(n_layers):
        dims = [(d - 2) // 2 + 1 for d in dims]
    return tuple(d - 2 for d in dims)


class NLayerDiscriminator3D(nn.Module):
    """3D PatchGAN (JAX networks.py:891; reference networks3D.py:381-425).
    Sequential indices: 0 conv k4/s2, 1 leaky_relu, then [conv k4/s2, norm,
    leaky_relu] for each of layers 1..n-1, [conv k4/s1, norm, leaky_relu],
    the 1-channel k4/s1 head conv, and a Sigmoid with ``use_sigmoid``. All
    convs pad 1 voxel with zeros; the norms use leaky_relu at slope 0.2, and
    the convs that feed them have dead biases.

    On CUDA the forward runs in channels_last_3d, as the generator's."""

    def __init__(self, input_nc: int = 1, ndf: int = 32, n_layers: int = 3,
                 use_sigmoid: bool = False):
        super().__init__()
        self.n_layers = n_layers
        layers = [Conv3d(input_nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            layers += _conv_norm_act(Conv3d(ndf * prev, ndf * nf, 4, stride=2, padding=1,
                                            dead_bias=True), "leaky_relu")
        prev, nf = nf, min(2 ** n_layers, 8)
        layers += _conv_norm_act(Conv3d(ndf * prev, ndf * nf, 4, stride=1, padding=1,
                                        dead_bias=True), "leaky_relu")
        layers.append(Conv3d(ndf * nf, 1, 4, stride=1, padding=1))
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        # Too small an input leaves the head's output empty along some axis,
        # and a mean over it is NaN; refuse it as the JAX package does.
        spatial = tuple(x.shape[2:])
        if any(d < 1 for d in _patchgan_output_shape(spatial, self.n_layers)):
            raise ValueError(
                f"NLayerDiscriminator3D with n_layers={self.n_layers} needs every "
                f"spatial dim >= {3 * 2 ** self.n_layers}, got {spatial}: the PatchGAN "
                f"head would output an empty map (and the GAN losses NaN). Use a larger "
                f"patch_size or fewer discriminator layers.")
        return self.model(_channels_last_on_cuda(x))


_ROADMAP_ZOO = "ROADMAP Queue A, the rest of the zoo"


def _check_norm(norm: str) -> None:
    if norm != "instance":
        raise NotImplementedError(f"norm {norm!r} is not ported yet; see {_ROADMAP_ZOO}")


def _init_weights(net: nn.Module, init_type: str, init_gain: float,
                  generator: Optional[torch.Generator]) -> nn.Module:
    init = get_initializer(init_type, init_gain)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    for m in net.modules():
        if isinstance(m, _ConvBase):
            init_conv_(m.weight, m.bias, isinstance(m, ConvTranspose3d), init, gen)
    return net


def define_g(input_nc: int, output_nc: int, ngf: int, net_g: str, norm: str = "instance",
             use_dropout: bool = False, init_type: str = "normal", init_gain: float = 0.02,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Generator factory keyed by the reference's netG names; weights drawn
    from ``generator`` (a fresh seed-0 generator when None)."""
    _check_norm(norm)
    blocks = {"resnet_6blocks": 6, "resnet_9blocks": 9}.get(net_g)
    if blocks is None:
        raise NotImplementedError(f"generator {net_g!r} is not ported yet; see {_ROADMAP_ZOO}")
    net = ResnetGenerator3D(input_nc, output_nc, ngf, blocks, use_dropout)
    return _init_weights(net, init_type, init_gain, generator)


def define_d(input_nc: int, ndf: int, net_d: str, n_layers_d: int = 3, norm: str = "instance",
             use_sigmoid: bool = False, init_type: str = "normal", init_gain: float = 0.02,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Discriminator factory keyed by the reference's netD names (JAX
    networks.py:1015): 'basic' is the 3-layer PatchGAN, 'n_layers' takes
    ``n_layers_d``; weights drawn from ``generator`` (a fresh seed-0
    generator when None)."""
    _check_norm(norm)
    if net_d == "basic":
        n_layers_d = 3
    elif net_d != "n_layers":
        raise NotImplementedError(
            f"discriminator {net_d!r} is not ported yet; see {_ROADMAP_ZOO}")
    net = NLayerDiscriminator3D(input_nc, ndf, n_layers_d, use_sigmoid)
    return _init_weights(net, init_type, init_gain, generator)


def spatial_granularity(net: nn.Module) -> Tuple[int, int, int]:
    """Per-axis divisibility a whole-volume forward needs: 4 for resnet (two
    stride-2 halvings)."""
    if isinstance(net, ResnetGenerator3D):
        return (4, 4, 4)
    raise NotImplementedError(f"{type(net).__name__} is not ported yet; see {_ROADMAP_ZOO}")
