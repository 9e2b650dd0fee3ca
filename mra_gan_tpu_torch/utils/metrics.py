"""Image-quality metrics on the caller's device (counterpart of
mra_gan_tpu/utils/metrics.py:16-123): MAE, MSE, PSNR, Pearson r and a 3D
SSIM, in float32, with the JAX package's formulas. SSIM follows Wang et al.
2004 with a uniform win^3 window over the interior (valid) neighbourhoods and
sample covariances, as skimage's ``structural_similarity`` does for volumes.
Pearson r alone sums in float64 (``_pearson``): for nearly uncorrelated
volumes its numerator cancels, and in float32 its value would depend on the
device's summation order.

Every function takes torch tensors or numpy arrays and returns a 0-d
float32 tensor on the tensors' device (a numpy array goes to the CPU).
"""
from __future__ import annotations

from typing import Optional

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def mae(a, b) -> torch.Tensor:
    return (_f32(a) - _f32(b)).abs().mean()


def mse(a, b) -> torch.Tensor:
    d = _f32(a) - _f32(b)
    return (d * d).mean()


def psnr(a, b, data_range: Optional[float] = None) -> torch.Tensor:
    a, b = _f32(a), _f32(b)
    if data_range is None:
        data_range = (b.max() - b.min()).clamp_min(1e-8)
    return 10.0 * torch.log10(data_range ** 2 / mse(a, b).clamp_min(1e-20))


def _pearson(a: torch.Tensor, b: torch.Tensor, w: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Pearson's r of a and b (restricted to the weights w), centred and
    summed in float64, returned as float32."""
    a, b = a.double(), b.double()
    if w is None:
        ac, bc = a - a.mean(), b - b.mean()
    else:
        w = w.double()
        n = w.sum().clamp_min(1.0)
        ac, bc = (a - (a * w).sum() / n) * w, (b - (b * w).sum() / n) * w
    r = (ac * bc).sum() / ((ac * ac).sum().sqrt() * (bc * bc).sum().sqrt()).clamp_min(1e-12)
    return r.float()


def pearson_r(a, b) -> torch.Tensor:
    return _pearson(_f32(a).ravel(), _f32(b).ravel())


def _uniform_filter3d(x: torch.Tensor, win: int) -> torch.Tensor:
    """Separable box filter over the interior (valid) windows, one axis at
    a time as the JAX package convolves, as a sum of shifted slices: plain
    float32 adds, where a cuDNN conv of a float32 volume would run in TF32
    (about three decimal digits) unless the process turned it off."""
    k = torch.tensor(1.0 / win, dtype=x.dtype, device=x.device)
    y = x
    for axis in range(3):
        n = y.shape[axis] - win + 1
        acc = y.narrow(axis, 0, n) * k
        for i in range(1, win):
            acc = acc + y.narrow(axis, i, n) * k
        y = acc
    return y


def ssim3d(a, b, data_range: Optional[float] = None, win: int = 7) -> torch.Tensor:
    """Mean SSIM over a 3D volume with a win^3 uniform window."""
    a, b = _f32(a), _f32(b)
    if data_range is None:
        data_range = (b.max() - b.min()).clamp_min(1e-8)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _uniform_filter3d(a, win)
    mu_b = _uniform_filter3d(b, win)
    n = win ** 3
    cov_norm = n / (n - 1)  # sample (unbiased) covariances, as skimage
    ex2 = _uniform_filter3d(a * a, win)
    ey2 = _uniform_filter3d(b * b, win)
    exy = _uniform_filter3d(a * b, win)
    va = cov_norm * (ex2 - mu_a * mu_a)
    vb = cov_norm * (ey2 - mu_b * mu_b)
    cab = cov_norm * (exy - mu_a * mu_b)
    num = (2 * mu_a * mu_b + c1) * (2 * cab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)
    return (num / den).mean()


@torch.inference_mode()
def volume_metrics(a, b, mask=None, use_mask: bool = False) -> dict:
    """{"ssim", "psnr", "mae", "pearson_r"} of prediction ``a`` against
    target ``b``. With ``use_mask`` the intensity metrics (PSNR, MAE,
    Pearson r) are restricted to ``mask`` (nonzero = inside) by weighted
    sums; SSIM is always over the whole volumes."""
    a, b = _f32(a), _f32(b)
    if use_mask:
        w = torch.as_tensor(mask, device=a.device).to(torch.float32)
        n = w.sum().clamp_min(1.0)

        def wmean(x):
            return (x * w).sum() / n

        inside = w > 0
        bmax = torch.where(inside, b, -torch.inf).max()
        bmin = torch.where(inside, b, torch.inf).min()
    else:
        wmean = torch.mean
        bmax, bmin = b.max(), b.min()
    d = a - b
    mae_v = wmean(d.abs())
    mse_v = wmean(d * d)
    data_range = (bmax - bmin).clamp_min(1e-8)
    psnr_v = 10.0 * torch.log10(data_range ** 2 / mse_v.clamp_min(1e-20))
    r_v = _pearson(a, b, w if use_mask else None)  # w zeroes the terms outside the mask
    return {"ssim": ssim3d(a, b, None, 7), "psnr": psnr_v, "mae": mae_v, "pearson_r": r_v}
