"""CycleGAN losses (counterpart of mra_gan_tpu/ops/losses.py:54,75,79): the
GAN loss (LSGAN = MSE, vanilla = BCE on a sigmoid output), the L1 cycle and
identity criterion, and the Pearson correlation loss 1 - r^2. Every
reduction is float32 whatever the compute dtype (float64 for a float64
input, so that a float64 run can serve as a reference)."""
from __future__ import annotations

import torch

# vanilla GAN's clip: above the float32 ulp at 1.0, so 1 - eps stays below 1
VANILLA_EPS = 1e-6


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def gan_loss(pred: torch.Tensor, target_is_real: bool, mode: str = "lsgan") -> torch.Tensor:
    """LSGAN: mean (pred - t)^2 against t = 1 or 0. Vanilla: mean BCE of a
    probability ``pred``, clipped to [eps, 1 - eps] and taken on the live
    branch only (-log p for real, -log1p(-p) for fake), so a sigmoid
    saturated to exactly 0 or 1 stays finite. This is not torch's BCELoss,
    which clamps the log at -100 instead."""
    pred = _f32(pred)
    if mode == "lsgan":
        return (pred - (1.0 if target_is_real else 0.0)).square().mean()
    if mode == "vanilla":
        p = pred.clamp(VANILLA_EPS, 1.0 - VANILLA_EPS)
        return (-torch.log(p) if target_is_real else -torch.log1p(-p)).mean()
    raise ValueError(f"unknown gan loss mode {mode!r}")


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (_f32(pred) - _f32(target)).abs().mean()


def cor_coe_loss(y_pred: torch.Tensor, y_target: torch.Tensor) -> torch.Tensor:
    """1 - Pearson r^2 over all elements."""
    x, y = _f32(y_pred), _f32(y_target)
    xc, yc = x - x.mean(), y - y.mean()
    r = (xc * yc).sum() / (torch.sqrt((xc * xc).sum()) * torch.sqrt((yc * yc).sum()))
    return 1.0 - r * r
