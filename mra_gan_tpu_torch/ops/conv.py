"""3D convolution primitives over torch.nn.functional (counterpart of
mra_gan_tpu/ops/conv.py:35,65,131).

Weights stay float32 and are cast to the activation's dtype at each call, as
the JAX Conv3D casts its kernel, so bfloat16 compute runs over float32
parameters. torch's ConvTranspose3d already has the reference's semantics
(out = (in - 1) * stride - 2 * pad + k + output_padding).

On CUDA the generator runs in channels_last_3d (NDHWC in memory, the layout of
the norm kernels); each op here returns that layout when its input has it.

Under ``core.spatial_ctx.spatial_sharding`` a volume is depth-sharded over a
process group: ``extend_sharded_d`` grows a shard by halo rows from its
neighbours (edge or zero rows at the volume's two ends), and
``replication_pad3d`` pads depth that way and H and W locally (JAX
ops/conv.py:96-150)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.spatial_ctx import spatial_shard_info
from ..parallel.collectives import neighbour_exchange

_CL = torch.channels_last_3d


def _keep_layout(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda and x.is_contiguous(memory_format=_CL):
        return y.contiguous(memory_format=_CL)
    return y


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride=1, padding=0) -> torch.Tensor:
    """x (N, Cin, D, H, W); weight (Cout, Cin, kd, kh, kw)."""
    b = None if bias is None else bias.to(x.dtype)
    return _keep_layout(F.conv3d(x, weight.to(x.dtype), b, stride, padding), x)


def conv_transpose3d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride=2, padding=1,
                     output_padding=0) -> torch.Tensor:
    """x (N, Cin, D, H, W); weight (Cin, Cout, kd, kh, kw)."""
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv_transpose3d(x, weight.to(x.dtype), b, stride, padding, output_padding)
    return _keep_layout(y, x)


def extend_sharded_d(x: torch.Tensor, lo: int, hi: int, boundary: str = "edge") -> torch.Tensor:
    """Extend a depth shard (N, C, D/K, H, W) by ``lo`` rows above and ``hi``
    below, from the neighbouring shards, and at the volume's ends the edge
    row repeated ('edge') or zeros ('zero'): the shard's part of the whole
    volume padded so (JAX ``extend_sharded_d``). Needs lo, hi <= D/K; only
    inside ``spatial_sharding``."""
    axis = spatial_shard_info()
    if axis is None:
        raise RuntimeError("extend_sharded_d needs spatial_sharding()")
    return neighbour_exchange(x, lo, hi, boundary, axis.group)


def replication_pad3d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate ``pad`` voxels on each side of D, H and W (torch
    nn.ReplicationPad3d); under spatial sharding the depth pad is a halo
    exchange with edge rows at the volume's ends."""
    if spatial_shard_info() is not None:
        x = extend_sharded_d(x, pad, pad, "edge")
        return _keep_layout(F.pad(x, (pad, pad, pad, pad, 0, 0), mode="replicate"), x)
    return _keep_layout(F.pad(x, (pad,) * 6, mode="replicate"), x)
