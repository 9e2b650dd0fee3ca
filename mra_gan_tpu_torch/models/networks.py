"""Generators and discriminators as torch nn.Modules (counterpart of
mra_gan_tpu/models/networks.py).

The whole zoo of the JAX package: ``ResnetGenerator3D`` (6 and 9 blocks),
``UnetGenerator3D`` (5, 7 and 8 downs), ``DynUNet3D`` (the reference's
'Dynet', MONAI's DynUNet with a Tanh head), ``NLayerDiscriminator3D`` (the
PatchGAN) and ``PixelDiscriminator3D``, under instance, batch or no norm,
with ``define_g``/``define_d``/``spatial_granularity``/``dynunet_schedule``.
Module attributes follow the reference's torch layout, so the state-dict
keys are the reference's (``model.1.weight``, ``model.model.1.model.1.weight``,
``net.2.weight``, MONAI's ``input_block.conv1.conv.weight``, ...) and a
reference ``.pth`` strict-loads once its dead running-stat buffers (and a
Dynet's ``skip_layers`` aliases) are dropped (checkpoint/io.py).

Instance norm is affine-free and fused with the activation after it; the
activation's slot in a Sequential then holds an ``nn.Identity``, so the
indices stay the reference's. Batch norm is affine and always normalizes
with the batch's statistics, in eval mode as well, keeping no running
averages, as the JAX ``Norm3D`` does (networks.py:356-392); its activation
keeps its own slot. Under ``norm='none'`` the norm slot is an identity.

A conv whose output goes straight into an instance norm has a dead bias:
the norm subtracts the per-channel mean, so the bias's true gradient is
exactly 0. Such a conv (``dead_bias=True``) adds ``bias.detach()``, as the
JAX package ``stop_gradient``s it (networks.py ``Conv3D.dead_bias``): the
bias keeps its checkpoint slot and its forward add, its ``.grad`` stays
None and Adam leaves it where it is. Only instance norm makes a bias dead.

Inside ``core.spatial_ctx.spatial_sharding`` (a volume depth-sharded over a
process group) the convs are shard-aware, as the JAX ``Conv3D`` and
``ConvTranspose3D`` are (networks.py:135-160, 300-316): a conv's depth
padding is a halo of zero rows exchanged with the neighbours
(ops/conv.py ``extend_sharded_d``); the replication pads exchange edge
halos; a kernel == stride transposed conv (the DynUNet's) is shard-local;
a stride-2 transposed conv runs over the shard extended by the rows its
outputs reach into, then is cropped to the shard's outputs. The norms merge
the statistics of all shards (ops/norm.py). Batch norm normalizes each
rank's own tensor, as the JAX package's does under ``shard_map``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.spatial_ctx import data_shard_info, spatial_shard_info
from ..ops.conv import (_keep_layout, _triple, conv3d, conv_transpose3d, extend_sharded_d,
                        param_cast, replication_pad3d)
from ..ops.init import get_initializer, init_conv_
from ..ops.norm import instance_norm_act

_CL = torch.channels_last_3d
NORMS = ("instance", "batch", "none")
# netG name -> the U-Net's number of halvings
UNET_DOWNS = {"unet_custom": 5, "unet_128": 7, "unet_256": 8}
RESNET_BLOCKS = {"resnet_6blocks": 6, "resnet_9blocks": 9}


class _ConvBase(nn.Module):
    def __init__(self, weight_shape: tuple, out_ch: int, bias: bool, dead_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.dead_bias = dead_bias

    def live_bias(self) -> Optional[torch.Tensor]:
        """The bias as the forward adds it: detached where it is norm-dead
        and a gradient is recorded. Where none is (inference), the parameter
        itself, whose cast ``ops.conv`` keeps: a fresh detached view would
        be cast again at every call. Inside ``ops.conv.param_casts`` the
        cast made there, detached."""
        if self.bias is None or not self.dead_bias or not torch.is_grad_enabled():
            return self.bias
        return param_cast(self.bias).detach()


class Conv3d(_ConvBase):
    """Conv with a kernel size, stride and zero padding per axis (an int
    for all three); weight (Cout, Cin, kd, kh, kw), float32. Initialised by
    ``define_g``/``define_d`` from an explicit generator, never from the
    global RNG."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1, padding=0,
                 bias: bool = True, dead_bias: bool = False):
        super().__init__((out_ch, in_ch, *_triple(kernel_size)), out_ch, bias, dead_bias)
        self.stride, self.padding = _triple(stride), _triple(padding)

    def forward(self, x):
        pd = self.padding[0]
        if pd and spatial_shard_info() is not None:
            return conv3d(extend_sharded_d(x, pd, pd, "zero"), self.weight, self.live_bias(),
                          self.stride, (0, *self.padding[1:]))
        return conv3d(x, self.weight, self.live_bias(), self.stride, self.padding)


class ConvTranspose3d(_ConvBase):
    """Transposed conv, per-axis as ``Conv3d``; weight (Cin, Cout, kd, kh,
    kw), float32."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=2, padding=1,
                 output_padding=0, bias: bool = True, dead_bias: bool = False):
        super().__init__((in_ch, out_ch, *_triple(kernel_size)), out_ch, bias, dead_bias)
        self.stride, self.padding = _triple(stride), _triple(padding)
        self.output_padding = _triple(output_padding)

    def forward(self, x):
        if spatial_shard_info() is not None:
            return self._sharded_forward(x)
        return conv_transpose3d(x, self.weight, self.live_bias(), self.stride, self.padding,
                                self.output_padding)

    def _sharded_forward(self, x):
        """The transposed conv of a depth shard: kernel == stride with no
        padding is shard-local; a stride-2 form whose output is twice its
        input (k + output_padding - 2 pad == 2) runs over the shard extended
        by the zero-or-neighbour rows its outputs reach into and is cropped
        to the shard's 2 D/K output rows (the JAX package rewrites it as a
        subpixel conv with halos; the function is the same)."""
        k, s, p, op = (self.weight.shape[2], self.stride[0], self.padding[0],
                       self.output_padding[0])
        if k == s and p == 0 and op == 0:
            return conv_transpose3d(x, self.weight, self.live_bias(), self.stride, self.padding,
                                    self.output_padding)
        if s != 2 or k + op - 2 * p != 2:
            raise ValueError("depth-sharded ConvTranspose3D supports stride-2 (subpixel) or "
                             "kernel==stride (blocked) forms only")
        d = x.shape[2]
        lo = max(0, (k - 1 - p) // 2)  # output row 0 reaches input row -lo
        hi = max(0, (2 * d - 1 + p) // 2 - (d - 1))
        y = conv_transpose3d(extend_sharded_d(x, lo, hi, "zero"), self.weight,
                             self.live_bias(), self.stride, self.padding, self.output_padding)
        return _keep_layout(y[:, :, 2 * lo:2 * lo + 2 * d], x)


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


class BatchNorm3d(nn.Module):
    """The JAX ``Norm3D('batch')``: affine (weight ~ N(1, 0.02), bias 0, as
    the reference's ``init_weights``), normalizing with the statistics of the
    batch over (N, D, H, W) in float32, eps 1e-5, in train and eval mode
    alike; no running averages (``nn.BatchNorm3d.eval()`` would switch to
    them). Plain PyTorch, forward and backward: no kernel."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3, 4), keepdim=True)
        var = (xf - mean).square().mean(dim=(0, 2, 3, 4), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * _bcast(self.weight) + _bcast(self.bias)
        return y.to(x.dtype)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None, None]


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
    are its own, and only its own resume is exact.

    Under the data-parallel step (``core.spatial_ctx.data_sharding`` with
    ``rows``, the step's rows per rank) the module draws the mask of the
    global batch, as one device would, and keeps this rank's rows of each
    stacked block: the masks, and the generator's stream, are the
    one-device step's (JAX gives each device its slice of one global mask,
    parallel/sharding.py:91-113)."""

    def __init__(self, p: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        dp = data_shard_info()
        if dp is not None and dp.size > 1:
            u = _global_rows_uniform(x, dp, self.generator)
        else:
            u = torch.empty_like(x, dtype=torch.float32).uniform_(generator=self.generator)
        return x * (u >= self.p).to(x.dtype) * (1.0 / (1.0 - self.p))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def _global_rows_uniform(x: torch.Tensor, dp, generator) -> torch.Tensor:
    # x stacks blocks of dp.rows rows, each this rank's part of a block of
    # dp.rows * dp.size global rows: draw the global tensor, keep our rows
    if not dp.rows or x.shape[0] % dp.rows:
        raise ValueError(f"data-parallel dropout needs the step's rows per rank "
                         f"(data_sharding(group, rows=...)); got {dp.rows} for a batch of "
                         f"{x.shape[0]}")
    blocks, rows = x.shape[0] // dp.rows, dp.rows
    u = torch.empty((blocks * rows * dp.size, *x.shape[1:]), dtype=torch.float32,
                    device=x.device).uniform_(generator=generator)
    keep = torch.arange(rows, device=x.device) + dp.index * rows
    keep = (torch.arange(blocks, device=x.device)[:, None] * rows * dp.size + keep).reshape(-1)
    return u[keep]


def _act_module(act: str) -> nn.Module:
    return {"relu": nn.ReLU(), "leaky_relu": nn.LeakyReLU(0.2), "none": nn.Identity()}[act]


def _norm_act(norm: str, channels: int, act: str) -> List[nn.Module]:
    """[norm, activation] in the reference's two slots: the fused instance
    norm and an Identity, batch norm and the activation, or an Identity and
    the activation (JAX ``_norm_act``)."""
    if norm == "instance":
        return [InstanceNormAct3d(act), nn.Identity()]
    return [BatchNorm3d(channels) if norm == "batch" else nn.Identity(), _act_module(act)]


def _norm(norm: str, channels: int) -> nn.Module:
    return _norm_act(norm, channels, "none")[0]


def _use_bias(norm: str) -> bool:
    # a conv before batch norm has no bias (reference :180-183, JAX :408)
    return norm != "batch"


def _channels_last_on_cuda(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=_CL) if x.is_cuda else x


class ResnetBlock3D(nn.Module):
    """pad, conv, norm, act, [dropout], pad, conv, norm; out = x + block(x).
    With dropout the second conv sits at conv_block.6 instead of .5, as in
    the reference."""

    def __init__(self, dim: int, use_dropout: bool = False, use_bias: bool = True,
                 norm: str = "instance"):
        super().__init__()
        dead = norm == "instance"
        layers = [ReplicationPad3d(1), Conv3d(dim, dim, 3, bias=use_bias, dead_bias=dead),
                  *_norm_act(norm, dim, "relu")]
        if use_dropout:
            layers.append(Dropout(0.5))
        layers += [ReplicationPad3d(1), Conv3d(dim, dim, 3, bias=use_bias, dead_bias=dead),
                   _norm(norm, dim)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator3D(nn.Module):
    """c7s1-ngf, two stride-2 downs, ``n_blocks`` residual blocks, two
    stride-2 transposed-conv ups, c7s1-output_nc + Tanh. Sequential indices:
    0 pad, 1 conv, 2 norm, 3 act | 4-6 down1 | 7-9 down2 | 10.. blocks |
    up1 at 10+n, up2 at 13+n | 16+n pad, 17+n conv, 18+n tanh.

    On CUDA the forward runs in channels_last_3d, the norm kernels' layout.
    Every conv but the head feeds a norm; under batch norm those convs have
    no bias, under instance norm a dead one."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 32,
                 n_blocks: int = 6, use_dropout: bool = False, norm: str = "instance"):
        super().__init__()
        self.n_blocks, self.norm = n_blocks, norm
        bias, dead = _use_bias(norm), norm == "instance"
        layers = [ReplicationPad3d(3), Conv3d(input_nc, ngf, 7, bias=bias, dead_bias=dead),
                  *_norm_act(norm, ngf, "relu")]
        for i in range(2):
            mult = 2 ** i
            layers += [Conv3d(ngf * mult, ngf * mult * 2, 3, stride=2, padding=1, bias=bias,
                              dead_bias=dead), *_norm_act(norm, ngf * mult * 2, "relu")]
        layers += [ResnetBlock3D(ngf * 4, use_dropout, bias, norm) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += [ConvTranspose3d(ngf * mult, ngf * mult // 2, 3, stride=2, padding=1,
                                       output_padding=1, bias=bias, dead_bias=dead),
                       *_norm_act(norm, ngf * mult // 2, "relu")]
        layers += [ReplicationPad3d(3), Conv3d(ngf, output_nc, 7, bias=True), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(_channels_last_on_cuda(x))


class UnetSkipBlock3D(nn.Module):
    """One U-Net level (reference UnetSkipConnectionBlock, JAX :529): a 4^3
    stride-2 down conv, the submodule, a 4^3 stride-2 transposed up conv,
    and the skip concatenated in channel order (x, up). ``model`` is the
    reference's Sequential:

    - outermost [downconv, submodule, uprelu, upconv, tanh]
    - middle    [downrelu, downconv, downnorm, submodule, uprelu, upconv,
      upnorm, (dropout)]
    - innermost [downrelu, downconv, uprelu, upconv, upnorm]

    downrelu is leaky_relu 0.2 and uprelu relu, each its own module, so the
    norms carry no activation. Every conv is bias-free but the outermost
    upconv: the reference's use_bias test compares against InstanceNorm2d
    and is always False in the 3D zoo (reference :298-301, JAX :545-547)."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "instance", use_dropout: bool = False):
        super().__init__()
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        down = Conv3d(input_nc, inner_nc, 4, stride=2, padding=1, bias=False)
        up_in = inner_nc if innermost else inner_nc * 2
        if outermost:
            layers = [down, submodule, nn.ReLU(),
                      ConvTranspose3d(up_in, outer_nc, 4, stride=2, padding=1, bias=True),
                      nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(),
                      ConvTranspose3d(up_in, outer_nc, 4, stride=2, padding=1, bias=False),
                      _norm(norm, outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, _norm(norm, inner_nc), submodule, nn.ReLU(),
                      ConvTranspose3d(up_in, outer_nc, 4, stride=2, padding=1, bias=False),
                      _norm(norm, outer_nc)]
            if use_dropout:
                layers.append(Dropout(0.5))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return _channels_last_on_cuda(torch.cat([x, self.model(x)], 1))


class UnetGenerator3D(nn.Module):
    """U-Net with ``num_downs`` halvings (reference :270-287, JAX :570): the
    innermost level at ngf*8, num_downs-5 more at ngf*8 (with dropout when
    asked), then ngf*4, ngf*2, ngf and the outermost level. Needs every
    spatial dim >= 2**num_downs, and divisible by it."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, num_downs: int = 5,
                 ngf: int = 32, norm: str = "instance", use_dropout: bool = False):
        super().__init__()
        self.num_downs, self.norm = num_downs, norm
        block = UnetSkipBlock3D(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock3D(ngf * 8, ngf * 8, submodule=block, norm=norm,
                                    use_dropout=use_dropout)
        for outer, inner in ((ngf * 4, ngf * 8), (ngf * 2, ngf * 4), (ngf, ngf * 2)):
            block = UnetSkipBlock3D(outer, inner, submodule=block, norm=norm)
        self.model = UnetSkipBlock3D(output_nc, ngf, input_nc, block, outermost=True, norm=norm)

    def forward(self, x):
        check_unet_input(self.num_downs, tuple(x.shape[2:]))
        return self.model(_channels_last_on_cuda(x))


def check_unet_input(num_downs: int, spatial: Sequence[int]) -> None:
    """The JAX package's ValueError for a U-Net input smaller than
    2**num_downs along some axis (networks.py:586-594)."""
    need = 2 ** num_downs
    if min(spatial) < need:
        raise ValueError(
            f"UnetGenerator3D with num_downs={num_downs} needs every "
            f"spatial dim >= {need}, got {tuple(spatial)}; use a larger "
            f"patch_size or a shallower netG (unet_custom=5 downs, "
            f"unet_128=7, unet_256=8)")


def dynunet_schedule(sizes: Sequence[float] = (128, 128, 64),
                     spacings: Sequence[float] = (1.5, 1.5, 1.5)) -> Tuple[list, list]:
    """nnU-Net's auto kernel/stride configuration (reference :348-363, JAX
    :609): (kernels, strides), one per level, the first stride (1, 1, 1)."""
    sizes, spacings = list(sizes), list(spacings)
    strides, kernels = [], []
    while True:
        ratio = [sp / min(spacings) for sp in spacings]
        stride = [2 if r <= 2 and sz >= 8 else 1 for r, sz in zip(ratio, sizes)]
        kernel = [3 if r <= 2 else 1 for r in ratio]
        if all(s == 1 for s in stride):
            break
        sizes = [i / j for i, j in zip(sizes, stride)]
        spacings = [i * j for i, j in zip(spacings, stride)]
        kernels.append(kernel)
        strides.append(stride)
    strides.insert(0, [1, 1, 1])
    kernels.append([3, 3, 3])
    return kernels, strides


def _monai_pad(kernel, stride) -> Tuple[int, int, int]:
    """MONAI's get_padding, int((k - s + 1) / 2) per axis (JAX ``_monai_pad``)."""
    return tuple(int((k - s + 1) / 2) for k, s in zip(_triple(kernel), _triple(stride)))


class _MonaiConv(nn.Module):
    """MONAI's Convolution wrapper: the conv under ``.conv`` (keys
    ``<name>.conv.weight``)."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


class AffineInstanceNorm3d(nn.Module):
    """torch ``InstanceNorm3d(affine=True)``, MONAI's norm in the DynUNet
    blocks (JAX ``_AffineIN``): the affine-free norm (the kernels on CUDA),
    then ``z * weight + bias`` in PyTorch, in z's dtype, as JAX orders it.
    weight starts at 1, bias at 0; no running statistics, as MONAI's."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        z = instance_norm_act(x, act="none")
        return z * _bcast(self.weight.to(z.dtype)) + _bcast(self.bias.to(z.dtype))


class UnetResBlock(nn.Module):
    """MONAI UnetResBlock (JAX ``_MonaiResBlock``): conv1(k, s) norm1 lrelu
    conv2(k, 1) norm2, plus conv3(1, s) norm3 on the shortcut where the
    channels or the stride change; then add and lrelu(0.01). Convs
    bias-free, norms affine; MONAI's registration order."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride):
        super().__init__()
        self.conv1 = _MonaiConv(Conv3d(in_ch, out_ch, kernel, stride, _monai_pad(kernel, stride),
                                       bias=False))
        self.conv2 = _MonaiConv(Conv3d(out_ch, out_ch, kernel, 1, _monai_pad(kernel, 1),
                                       bias=False))
        self.norm1 = AffineInstanceNorm3d(out_ch)
        self.norm2 = AffineInstanceNorm3d(out_ch)
        self.downsample = in_ch != out_ch or any(s != 1 for s in _triple(stride))
        if self.downsample:
            self.conv3 = _MonaiConv(Conv3d(in_ch, out_ch, 1, stride, 0, bias=False))
            self.norm3 = AffineInstanceNorm3d(out_ch)

    def forward(self, x):
        h = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        h = self.norm2(self.conv2(h))
        if self.downsample:
            x = self.norm3(self.conv3(x))
        return F.leaky_relu(x + h, 0.01)


class UnetBasicBlock(nn.Module):
    """MONAI UnetBasicBlock (JAX ``_MonaiBasicBlock``): conv1(k, 1) norm1
    lrelu conv2(k, 1) norm2 lrelu, no residual; the decoder's block."""

    def __init__(self, in_ch: int, out_ch: int, kernel):
        super().__init__()
        self.conv1 = _MonaiConv(Conv3d(in_ch, out_ch, kernel, 1, _monai_pad(kernel, 1),
                                       bias=False))
        self.conv2 = _MonaiConv(Conv3d(out_ch, out_ch, kernel, 1, _monai_pad(kernel, 1),
                                       bias=False))
        self.norm1 = AffineInstanceNorm3d(out_ch)
        self.norm2 = AffineInstanceNorm3d(out_ch)

    def forward(self, x):
        h = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        return F.leaky_relu(self.norm2(self.conv2(h)), 0.01)


class UnetUpBlock(nn.Module):
    """MONAI UnetUpBlock (JAX ``_MonaiUpBlock``): a bias-free transposed conv
    with kernel = stride = the level's upsample stride and no padding, the
    skip concatenated in channel order (up, skip), then a basic block."""

    def __init__(self, in_ch: int, out_ch: int, kernel, up_stride):
        super().__init__()
        self.transp_conv = _MonaiConv(ConvTranspose3d(in_ch, out_ch, up_stride, up_stride, 0,
                                                      bias=False))
        self.conv_block = UnetBasicBlock(2 * out_ch, out_ch, kernel)

    def forward(self, h, skip):
        up = self.transp_conv(h)
        return self.conv_block(_channels_last_on_cuda(torch.cat([up, skip.to(up.dtype)], 1)))


class UnetOutBlock(nn.Module):
    """MONAI UnetOutBlock: a 1^3 conv with a bias under ``.conv.conv``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = _MonaiConv(Conv3d(in_ch, out_ch, 1, bias=True))

    def forward(self, x):
        return self.conv(x)


class DynUNet3D(nn.Module):
    """MONAI DynUNet with res_block=True and the reference's Tanh head
    ('Dynet', reference :346-377, JAX :804): filters min(32 * 2^i, 320), the
    kernels and strides of ``dynunet_schedule(sizes, spacings)``, an input
    block, downsamples, a bottleneck, upsamples from the bottleneck up (each
    with the next level's kernel and stride), a 1^3 output block, Tanh.
    MONAI's module names, so its state-dict keys (without the duplicate
    ``skip_layers`` registrations, which checkpoint.io writes and checks).
    Its norms are its own affine instance norms: the config's ``norm`` is
    not consulted, as in the JAX package. On CUDA the forward runs in
    channels_last_3d."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 sizes: Sequence[int] = (128, 128, 64),
                 spacings: Sequence[float] = (1.5, 1.5, 1.5)):
        super().__init__()
        self.sizes, self.spacings = tuple(sizes), tuple(spacings)
        kernels, strides = dynunet_schedule(self.sizes, self.spacings)
        n = len(kernels)
        filters = [min(32 * 2 ** i, 320) for i in range(n)]
        self.input_block = UnetResBlock(input_nc, filters[0], kernels[0], strides[0])
        self.downsamples = nn.ModuleList(
            UnetResBlock(filters[i - 1], filters[i], kernels[i], strides[i])
            for i in range(1, n - 1))
        self.bottleneck = UnetResBlock(filters[n - 2], filters[n - 1], kernels[n - 1],
                                       strides[n - 1])
        self.upsamples = nn.ModuleList(
            UnetUpBlock(filters[i + 1], filters[i], kernels[i + 1], strides[i + 1])
            for i in range(n - 2, -1, -1))
        self.output_block = UnetOutBlock(filters[0], output_nc)

    def forward(self, x):
        h = self.input_block(_channels_last_on_cuda(x))
        skips = [h]
        for block in self.downsamples:
            h = block(h)
            skips.append(h)
        h = self.bottleneck(h)
        for block, skip in zip(self.upsamples, reversed(skips)):
            h = block(h, skip)
        return torch.tanh(self.output_block(h))


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
    convs pad 1 voxel with zeros; the activations are leaky_relu at slope
    0.2. The convs that feed norms have dead biases under instance norm and
    none under batch norm.

    On CUDA the forward runs in channels_last_3d, as the generator's."""

    def __init__(self, input_nc: int = 1, ndf: int = 32, n_layers: int = 3,
                 use_sigmoid: bool = False, norm: str = "instance"):
        super().__init__()
        self.n_layers, self.norm = n_layers, norm
        bias, dead = _use_bias(norm), norm == "instance"
        layers = [Conv3d(input_nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            layers += [Conv3d(ndf * prev, ndf * nf, 4, stride=2, padding=1, bias=bias,
                              dead_bias=dead), *_norm_act(norm, ndf * nf, "leaky_relu")]
        prev, nf = nf, min(2 ** n_layers, 8)
        layers += [Conv3d(ndf * prev, ndf * nf, 4, stride=1, padding=1, bias=bias,
                          dead_bias=dead), *_norm_act(norm, ndf * nf, "leaky_relu")]
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


class PixelDiscriminator3D(nn.Module):
    """Per-voxel discriminator (reference :428-450, JAX :951): three 1^3
    convs, the Sequential named ``net``: 0 conv, 1 leaky_relu, 2 conv, 3
    norm, 4 leaky_relu, 5 conv, [6 Sigmoid]. The last two convs have biases
    unless under batch norm; the middle one's is dead under instance norm.

    On CUDA the forward runs in channels_last_3d."""

    def __init__(self, input_nc: int = 1, ndf: int = 32, use_sigmoid: bool = False,
                 norm: str = "instance"):
        super().__init__()
        self.norm = norm
        bias = _use_bias(norm)
        layers = [Conv3d(input_nc, ndf, 1), nn.LeakyReLU(0.2),
                  Conv3d(ndf, ndf * 2, 1, bias=bias, dead_bias=norm == "instance"),
                  *_norm_act(norm, ndf * 2, "leaky_relu"), Conv3d(ndf * 2, 1, 1, bias=bias)]
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(_channels_last_on_cuda(x))


def _check_norm(norm: str) -> None:
    if norm not in NORMS:
        raise NotImplementedError(f"normalization layer [{norm}] is not found")


def _init_weights(net: nn.Module, init_type: str, init_gain: float,
                  generator: Optional[torch.Generator]) -> nn.Module:
    """The reference's ``init_weights``: every conv kernel by ``init_type``
    and its bias 0; batch-norm weights ~ N(1, 0.02) and biases 0; the
    Dynet's affine instance norms keep 1 and 0."""
    init = get_initializer(init_type, init_gain)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    for m in net.modules():
        if isinstance(m, _ConvBase):
            init_conv_(m.weight, m.bias, isinstance(m, ConvTranspose3d), init, gen)
        elif isinstance(m, BatchNorm3d):
            with torch.no_grad():
                m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=gen))
                m.bias.zero_()
    return net


def define_g(input_nc: int, output_nc: int, ngf: int, net_g: str, norm: str = "instance",
             use_dropout: bool = False, init_type: str = "normal", init_gain: float = 0.02,
             generator: Optional[torch.Generator] = None,
             dynet_sizes: Sequence[int] = (128, 128, 64),
             dynet_spacings: Sequence[float] = (1.5, 1.5, 1.5)) -> nn.Module:
    """Generator factory keyed by the reference's netG names (JAX
    networks.py:982): resnet_6blocks, resnet_9blocks, unet_custom (5
    downs), unet_128 (7), unet_256 (8) and Dynet (its schedule from
    ``dynet_sizes``/``dynet_spacings``); weights drawn from ``generator``
    (a fresh seed-0 generator when None)."""
    _check_norm(norm)
    if net_g in RESNET_BLOCKS:
        net = ResnetGenerator3D(input_nc, output_nc, ngf, RESNET_BLOCKS[net_g], use_dropout,
                                norm)
    elif net_g in UNET_DOWNS:
        net = UnetGenerator3D(input_nc, output_nc, UNET_DOWNS[net_g], ngf, norm, use_dropout)
    elif net_g == "Dynet":
        net = DynUNet3D(input_nc, output_nc, dynet_sizes, dynet_spacings)
    else:
        raise NotImplementedError(f"Generator model name [{net_g}] is not recognized")
    return _init_weights(net, init_type, init_gain, generator)


def define_d(input_nc: int, ndf: int, net_d: str, n_layers_d: int = 3, norm: str = "instance",
             use_sigmoid: bool = False, init_type: str = "normal", init_gain: float = 0.02,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Discriminator factory keyed by the reference's netD names (JAX
    networks.py:1015): 'basic' is the 3-layer PatchGAN, 'n_layers' takes
    ``n_layers_d``, 'pixel' the per-voxel one; weights drawn from
    ``generator`` (a fresh seed-0 generator when None)."""
    _check_norm(norm)
    if net_d in ("basic", "n_layers"):
        net = NLayerDiscriminator3D(input_nc, ndf, 3 if net_d == "basic" else n_layers_d,
                                    use_sigmoid, norm)
    elif net_d == "pixel":
        net = PixelDiscriminator3D(input_nc, ndf, use_sigmoid, norm)
    else:
        raise NotImplementedError(f"Discriminator model name [{net_d}] is not recognized")
    return _init_weights(net, init_type, init_gain, generator)


def granularity(net_g: str, dynet_sizes: Sequence[int] = (128, 128, 64),
                dynet_spacings: Sequence[float] = (1.5, 1.5, 1.5)) -> Tuple[int, int, int]:
    """Per-axis divisibility a whole-volume forward of the generator named
    ``net_g`` needs (JAX :632): 4 for resnet (two stride-2 halvings),
    2**num_downs for a U-Net, the per-axis product of the auto-schedule's
    strides for a DynUNet. By name, so that a config's rule needs no
    network."""
    if net_g in RESNET_BLOCKS:
        return (4, 4, 4)
    if net_g in UNET_DOWNS:
        return (2 ** UNET_DOWNS[net_g],) * 3
    if net_g == "Dynet":
        out = [1, 1, 1]
        for s in dynunet_schedule(dynet_sizes, dynet_spacings)[1]:
            out = [o * int(v) for o, v in zip(out, s)]
        return tuple(out)
    raise ValueError(f"unknown generator {net_g!r}")


def spatial_granularity(net: nn.Module) -> Tuple[int, int, int]:
    """``granularity`` of a generator built by ``define_g``."""
    if isinstance(net, UnetGenerator3D):
        return granularity({v: k for k, v in UNET_DOWNS.items()}[net.num_downs])
    if isinstance(net, DynUNet3D):
        return granularity("Dynet", net.sizes, net.spacings)
    if isinstance(net, ResnetGenerator3D):
        return granularity(next(iter(RESNET_BLOCKS)))
    raise TypeError(f"{type(net).__name__} is not a generator")


def remat_segments(net: nn.Module) -> List[nn.Module]:
    """The pieces ``--remat`` recomputes one at a time in the backward (JAX
    cycle_gan.py:259-272). A resnet generator is cut where the JAX one marks
    ``g_trunk_in`` and ``g_trunk_out`` (networks.py:497-508): the stem and
    the two downs, the residual trunk, the two ups and the head, slices of
    its ``model`` (the keys stay the reference's). The U-Nets and the DynUNet
    mark no boundary, so the JAX policy recomputes their whole apply: one
    segment, the net itself."""
    if isinstance(net, ResnetGenerator3D):
        trunk = 10  # pad, conv, norm, act, then two downs of conv, norm, act
        return [nn.Sequential(_ToChannelsLast(), *net.model[:trunk]),
                net.model[trunk:trunk + net.n_blocks], net.model[trunk + net.n_blocks:]]
    return [net]


class _ToChannelsLast(nn.Module):
    def forward(self, x):
        return _channels_last_on_cuda(x)


def check_patch(net_g: str, patch: Sequence[int]) -> None:
    """Raise the JAX package's ValueError where a U-Net cannot take
    ``patch``; every other generator takes what the loader gives."""
    if net_g in UNET_DOWNS:
        check_unet_input(UNET_DOWNS[net_g], patch)
