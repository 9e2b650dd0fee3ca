"""CycleGAN losses (counterpart of mra_gan_tpu/ops/losses.py:54,75,79): the
GAN loss (LSGAN = MSE, vanilla = BCE on a sigmoid output), the L1 cycle and
identity criterion, and the Pearson correlation loss 1 - r^2. Every
reduction is float32 whatever the compute dtype (float64 for a float64
input, so that a float64 run can serve as a reference).

Inside a shard context (core.spatial_ctx: the depth shards of a volume, the
batch rows of a data-parallel step, or both) every reduction covers all
shards, as JAX ``_gmean``/``_gsum`` do (losses.py:27-50): the local means
are averaged and the local sums added over each group, so the value is the
one-device loss on every rank. The gradient is the local loss's: each rank
differentiates its own shard's term and the train step averages the
parameter gradients over the ranks (models/cycle_gan.py), which gives the
gradient of the global mean exactly once."""
from __future__ import annotations

import torch

from ..core.spatial_ctx import shard_axes
from ..parallel.collectives import all_reduce_

# vanilla GAN's clip: above the float32 ulp at 1.0, so 1 - eps stays below 1
VANILLA_EPS = 1e-6


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _global(local: torch.Tensor, mean: bool) -> torch.Tensor:
    # the value reduced over every shard axis (uniform shards), the gradient
    # the local one's
    axes = shard_axes()
    if not axes:
        return local
    total = local.detach().reshape(1).clone()
    for axis in axes:
        all_reduce_(total, axis.group)
        if mean:
            total /= axis.size
    return local + (total[0] - local.detach())


def _gmean(x: torch.Tensor) -> torch.Tensor:
    return _global(x.mean(), mean=True)


def _gsum(x: torch.Tensor) -> torch.Tensor:
    return _global(x.sum(), mean=False)


def gan_loss(pred: torch.Tensor, target_is_real: bool, mode: str = "lsgan") -> torch.Tensor:
    """LSGAN: mean (pred - t)^2 against t = 1 or 0. Vanilla: mean BCE of a
    probability ``pred``, clipped to [eps, 1 - eps] and taken on the live
    branch only (-log p for real, -log1p(-p) for fake), so a sigmoid
    saturated to exactly 0 or 1 stays finite. This is not torch's BCELoss,
    which clamps the log at -100 instead."""
    pred = _f32(pred)
    if mode == "lsgan":
        return _gmean((pred - (1.0 if target_is_real else 0.0)).square())
    if mode == "vanilla":
        p = pred.clamp(VANILLA_EPS, 1.0 - VANILLA_EPS)
        return _gmean(-torch.log(p) if target_is_real else -torch.log1p(-p))
    raise ValueError(f"unknown gan loss mode {mode!r}")


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _gmean((_f32(pred) - _f32(target)).abs())


def cor_coe_loss(y_pred: torch.Tensor, y_target: torch.Tensor) -> torch.Tensor:
    """1 - Pearson r^2 over all elements (of every shard)."""
    x, y = _f32(y_pred), _f32(y_target)
    xc, yc = x - _gmean(x), y - _gmean(y)
    r = _gsum(xc * yc) / (torch.sqrt(_gsum(xc * xc)) * torch.sqrt(_gsum(yc * yc)))
    return 1.0 - r * r
