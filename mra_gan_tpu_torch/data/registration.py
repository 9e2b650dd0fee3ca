"""Affine volume registration (counterpart of mra_gan_tpu/data/registration.py).

The reference registers with SimpleITK: Sobel-gradient images, Mattes mutual
information, gradient descent over a 4/2/1 pyramid (reference
organize_folder_structure.py:99-140). The JAX package rebuilt it as a
soft-binned, differentiable mutual information optimised by Adam over the
same pyramid, in index space of the fixed image after a centre-of-mass
alignment (the CenteredTransformInitializer equivalent, reference
organize_folder_structure.py:110). This module keeps that split of work:

- on the device: the voxel map (``transform_grid``), the trilinear sampling
  and the optimisation of each pyramid level (``register_level``: a torch
  loop with ``torch.optim.Adam``, whose update is optax.adam's);
- on the host, with scipy, as in the JAX package: the Sobel features
  (``sobel_magnitude``), the centre-of-mass initialisation and the final
  resampling of ``apply_transform`` (scipy's ``map_coordinates``, which also
  gives the cubic B-spline order that has no torch counterpart).

That placement is the JAX package's own, not a fallback. Two "constant"
modes meet here: the level's sampling zeroes each out-of-range corner of the
trilinear stencil (JAX ``map_coordinates(mode="constant")``, which is
``grid_sample(padding_mode="zeros", align_corners=True)``), while scipy's
``map_coordinates`` in ``apply_transform`` returns 0 for a point outside
[0, n - 1].

Transforms map fixed-voxel to moving-voxel coordinates, moving = A @ (fixed
- c) + c + t, with c the fixed grid's centre; the parameters are (12,) =
nine row-major entries of A - I and t, or (6,) rigid = three Euler angles
(R = rz @ ry @ rx) and t.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as _ndi

from ..core.device import resolve_device


def sobel_magnitude(vol: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Gradient-magnitude feature volume (the reference's
    GradientMagnitudeRecursiveGaussian, organize_folder_structure.py:103-105)."""
    g = _ndi.gaussian_filter(vol.astype(np.float32), sigma)
    gx = _ndi.sobel(g, 0)
    gy = _ndi.sobel(g, 1)
    gz = _ndi.sobel(g, 2)
    return np.sqrt(gx * gx + gy * gy + gz * gz)


def trilinear_sample(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """vol (D, H, W); coords (3, N) voxel coordinates -> (N,) values, each
    out-of-range corner of the stencil taken as 0 (JAX ``_trilinear_sample``)."""
    norm = [2.0 * coords[i] / max(n - 1, 1) - 1.0 for i, n in enumerate(vol.shape)]
    grid = torch.stack(norm[::-1], dim=-1).view(1, 1, 1, -1, 3)
    return F.grid_sample(vol[None, None], grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True).view(-1)


def affine_matrix(params: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A (3, 3), t (3,)) of a (12,) affine or (6,) rigid parameter vector."""
    if params.shape[0] == 6:
        ca, cb, cg = torch.cos(params[:3])
        sa, sb, sg = torch.sin(params[:3])
        one, zero = torch.ones_like(ca), torch.zeros_like(ca)
        rx = torch.stack([one, zero, zero, zero, ca, -sa, zero, sa, ca]).view(3, 3)
        ry = torch.stack([cb, zero, sb, zero, one, zero, -sb, zero, cb]).view(3, 3)
        rz = torch.stack([cg, -sg, zero, sg, cg, zero, zero, zero, one]).view(3, 3)
        return rz @ ry @ rx, params[3:6]
    return torch.eye(3, dtype=params.dtype, device=params.device) + params[:9].view(3, 3), \
        params[9:12]


def grid_points(shape: Sequence[int], device=None) -> torch.Tensor:
    """(3, N) voxel coordinates of the grid, C order."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in shape]
    return torch.stack([g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij")])


def transform_points(pts: torch.Tensor, params: torch.Tensor,
                     center: Sequence[float]) -> torch.Tensor:
    """A @ (pts - c) + c + t for (3, N) points."""
    a, t = affine_matrix(params)
    c = torch.tensor([float(v) for v in center], dtype=pts.dtype, device=pts.device)[:, None]
    return a @ (pts - c) + c + t[:, None]


def transform_grid(shape: Sequence[int], params: torch.Tensor,
                   center: Sequence[float]) -> torch.Tensor:
    """The voxel map of the whole ``shape`` grid, (3, N), on the device of
    ``params`` (JAX ``_transform_grid``)."""
    return transform_points(grid_points(shape, params.device), params, center)


def soft_mutual_information(fixed: torch.Tensor, moving_sampled: torch.Tensor,
                            n_bins: int = 32, sigma_bins: float = 1.0) -> torch.Tensor:
    """Differentiable MI from a Parzen-windowed joint histogram (the Mattes
    construction) of two flat intensity vectors scaled to [0, 1]."""
    centers = torch.linspace(0.0, 1.0, n_bins, device=fixed.device)

    def soft_hist(x):
        d = (x[:, None] - centers[None, :]) * (n_bins - 1) / sigma_bins
        w = torch.exp(-0.5 * d * d)
        return w / (w.sum(dim=1, keepdim=True) + 1e-8)

    joint = soft_hist(fixed).T @ soft_hist(moving_sampled)
    joint = joint / (joint.sum() + 1e-8)
    pa, pb = joint.sum(dim=1), joint.sum(dim=0)
    eps = 1e-10
    return torch.sum(joint * (torch.log(joint + eps) - torch.log(pa[:, None] + eps)
                              - torch.log(pb[None, :] + eps)))


def normalize01(x: torch.Tensor) -> torch.Tensor:
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + 1e-8)


def register_level(fixed: torch.Tensor, moving: torch.Tensor, params: torch.Tensor, lr: float,
                   n_iters: int = 100, sample_frac: float = 0.1, seed: int = 0,
                   indices: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level (JAX ``_register_level``): ``n_iters`` Adam steps of
    the negative soft MI between ``fixed`` and ``moving`` (both (D, H, W) on
    the device) at ``max(1024, int(N * sample_frac))`` voxels drawn anew
    each iteration from a generator seeded with ``seed``, or the rows of
    ``indices`` ((n_iters, n_sample), a test's JAX draws). Only the sampled
    points are transformed. Returns (params, losses (n_iters,))."""
    shape = tuple(fixed.shape)
    dev = fixed.device
    center = [(s - 1) / 2.0 for s in shape]
    fixed01, moving01 = normalize01(fixed.float()).reshape(-1), normalize01(moving.float())
    n_total = fixed01.numel()
    n_sample = max(1024, int(n_total * sample_frac))
    # Per-block step scaling (JAX :106-120): Adam moves every parameter by
    # ~lr an iteration, but a useful matrix step is ~0.02 and a useful
    # translation ~1 voxel, so q = params / block_scale is optimised.
    n_mat = 3 if params.shape[0] == 6 else 9
    block_scale = torch.tensor([0.02] * n_mat + [1.0] * 3, dtype=torch.float32, device=dev)
    q = (params.to(dev, torch.float32) / block_scale).detach().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    h, w = shape[1], shape[2]
    losses = []
    for it in range(n_iters):
        idx = (indices[it].to(dev) if indices is not None
               else torch.randint(0, n_total, (n_sample,), generator=gen, device=dev))
        pts = torch.stack([idx // (h * w), (idx // w) % h, idx % w]).float()
        m = trilinear_sample(moving01, transform_points(pts, q * block_scale, center))
        loss = -soft_mutual_information(fixed01[idx], m)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return (q * block_scale).detach(), torch.stack(losses)


def center_of_mass_init(fixed: np.ndarray, moving: np.ndarray) -> np.ndarray:
    cf = np.array(_ndi.center_of_mass(np.abs(fixed)))
    cm = np.array(_ndi.center_of_mass(np.abs(moving)))
    t = cm - cf
    params = np.zeros(12, np.float32)
    params[9:12] = t
    return params


def register_affine(
    fixed: np.ndarray,
    moving: np.ndarray,
    mode: str = "affine",
    levels: Tuple[int, ...] = (4, 2, 1),
    iters_per_level: int = 100,
    lr: float = 0.05,
    use_gradient_features: bool = True,
    seed: int = 0,
    device=None,
    times: Optional[dict] = None,
) -> np.ndarray:
    """Estimate the parameters mapping fixed-voxel to moving-voxel
    coordinates: the (12,) affine vector (or (6,) under ``mode="rigid"``).
    The levels run on ``device`` (CUDA unless given; raises without a card),
    level ``li`` at ``lr / (li + 1)`` with seed ``seed + li``, the
    translation rescaled between levels. ``times``, when given, gains the
    seconds of the host features (``"features_s"``) and of the device levels
    (``"levels_s"``)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if use_gradient_features:
        ff, mf = sobel_magnitude(fixed), sobel_magnitude(moving)
    else:
        ff, mf = fixed.astype(np.float32), moving.astype(np.float32)
    params = center_of_mass_init(ff, mf)
    if mode == "rigid":
        p = np.zeros(6, np.float32)
        p[3:6] = params[9:12]
        params = p
    t1 = time.perf_counter()
    for li, level in enumerate(levels):
        f = ff[::level, ::level, ::level] if level > 1 else ff
        m = mf[::level, ::level, ::level] if level > 1 else mf
        scaled = params.copy()
        scaled[-3:] = params[-3:] / level
        p, _ = register_level(torch.from_numpy(np.ascontiguousarray(f)).to(dev),
                              torch.from_numpy(np.ascontiguousarray(m)).to(dev),
                              torch.from_numpy(scaled), lr / (li + 1),
                              n_iters=iters_per_level, seed=seed + li)
        params = p.cpu().numpy().copy()
        params[-3:] *= level
    if times is not None:
        times["features_s"] = times.get("features_s", 0.0) + t1 - t0
        times["levels_s"] = times.get("levels_s", 0.0) + time.perf_counter() - t1
    return params


def apply_transform(moving: np.ndarray, params: np.ndarray,
                    out_shape: Tuple[int, int, int],
                    interpolation: str = "linear", device=None) -> np.ndarray:
    """Resample ``moving`` into the fixed grid of ``out_shape`` under the
    estimated transform: the grid on ``device`` (CUDA unless given), the
    interpolation on the host with scipy (order 0, 1 or 3 for 'nearest',
    'linear', 'bspline'; 0 outside the volume)."""
    dev = resolve_device(device)
    center = [(s - 1) / 2.0 for s in out_shape]
    grid = transform_grid(out_shape, torch.as_tensor(np.asarray(params, np.float32), device=dev),
                          center).cpu().numpy()
    order = {"nearest": 0, "linear": 1, "bspline": 3}[interpolation]
    out = _ndi.map_coordinates(moving.astype(np.float32), grid.reshape(3, -1),
                               order=order, mode="constant")
    return out.reshape(out_shape)
