"""Instance norm for (N, C, D, H, W) volumes (counterpart of
mra_gan_tpu/ops/norm.py:53,99).

torch ``nn.InstanceNorm3d(affine=False)`` numerics: biased variance over the
spatial dims, eps 1e-5 inside the square root, statistics in float32 under
bfloat16 compute. The gradient is the JAX custom VJP's (``_in_vjp_bwd``):
dx = rstd * (g' - mean(g') - z mean(g' z)) with g' = g * act'(z), z
recomputed from the saved (x, mean, rstd) and act' taken at z >= 0, so relu
passes the gradient where z is exactly 0 (autograd of torch's relu would
not). A CPU tensor takes the plain versions, which follow the JAX
``_in_fwd_core`` and ``_in_vjp_bwd`` step by step; a CUDA tensor takes the
hand-written kernels (ops/kernels/csrc/instance_norm.cu), forward and
backward. The JAX package's grouped-lane variant
(``instance_norm_act_grouped``) is a TPU layout rewrite of the same function
and maps to the same call here.

Under ``core.spatial_ctx.spatial_sharding`` x is one rank's depth shard of a
volume split over a process group, and the statistics are those of the
whole volume (JAX ``_spatial_mean`` pmeans the shards' means, norm.py:37-50):
the forward runs stats -> all-gather of the partials -> the K-shard apply,
and the backward bwd stats -> all-gather -> the K-shard bwd apply, over the
group the forward saw (the backward runs after the context has closed).
That route is taken whatever ``uses_slab`` says, on the kernels on CUDA and
their plain versions on the CPU."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core.spatial_ctx import spatial_shard_info
from .kernels.instance_norm import (
    EPS,
    instance_norm_act_bwd_fused,
    instance_norm_act_bwd_plain,
    instance_norm_act_fwd,
    instance_norm_act_plain_fwd,
    instance_norm_bwd_two_pass_sharded,
    instance_norm_two_pass_sharded,
)


class InstanceNormAct(torch.autograd.Function):
    """act(instance_norm(x)) with the analytic backward; saves x, mean and
    rstd (not y). ``axis`` (a core.spatial_ctx.ShardAxis, or None) is the
    depth-shard group the statistics span."""

    @staticmethod
    def forward(ctx, x, eps, act, negative_slope, axis=None):
        y, mean, rstd = _forward(x, eps, act, negative_slope, axis)
        ctx.save_for_backward(x, mean, rstd)
        ctx.act, ctx.negative_slope, ctx.axis = act, negative_slope, axis
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        if ctx.axis is not None:
            dx = instance_norm_bwd_two_pass_sharded(x, g, mean, rstd, ctx.axis.group, ctx.act,
                                                    ctx.negative_slope)
        else:
            bwd = (instance_norm_act_bwd_plain if x.device.type == "cpu"
                   else instance_norm_act_bwd_fused)
            dx = bwd(x, g, mean, rstd, ctx.act, ctx.negative_slope)
        return dx, None, None, None, None


def _forward(x, eps, act, negative_slope, axis):
    # (y, mean, rstd) by the route ``InstanceNormAct`` documents
    if axis is not None:
        return instance_norm_two_pass_sharded(x, axis.group, act, negative_slope, eps)
    fwd = instance_norm_act_plain_fwd if x.device.type == "cpu" else instance_norm_act_fwd
    return fwd(x, act, negative_slope, eps)


def instance_norm_act(x: torch.Tensor, eps: float = EPS, act: str = "none",
                      negative_slope: float = 0.2) -> torch.Tensor:
    """act in {'none', 'relu', 'leaky_relu', 'tanh'}; over the whole volume
    of a depth shard inside ``spatial_sharding``. Where autograd records
    nothing (inference, or an input that needs no gradient) the forward runs
    without the autograd Function, whose cost a decode would pay at every
    norm of every patch batch; the result is the same."""
    axis = spatial_shard_info()
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormAct.apply(x, eps, act, negative_slope, axis)
    return _forward(x, eps, act, negative_slope, axis)[0]


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return instance_norm_act(x, eps, "none")
