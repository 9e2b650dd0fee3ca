"""Host-side preprocessing for inference (numpy/scipy).

The port's own copy of the functions of mra_gan_tpu/data/transforms.py that
the decode CLI uses (:83,97,103,265,282,302): the legacy 0-255 rescale, the
[-1, 1] tanh range and back, spacing resample, resample onto a reference
grid, and pad-to-patch-size. The arithmetic is unchanged; keep the two in
step.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage

from .nifti import NiftiImage


def rescale_0_255(data: np.ndarray) -> np.ndarray:
    """Legacy ``Normalization`` (reference utils/NiftiDataset.py:639-654):
    z-score then RescaleIntensity to [0, 255], which is exactly a plain
    min-max rescale (the rescale is invariant to the affine z-score)."""
    x = data.astype(np.float32)
    lo, hi = float(x.min()), float(x.max())
    span = hi - lo
    if span <= 0:
        return np.zeros_like(x)
    return (x - lo) * (255.0 / span)


def to_tanh_range(data: np.ndarray) -> np.ndarray:
    """[0, 255] -> [-1, 1] (reference test.py:152)."""
    return (data.astype(np.float32) - 127.5) / 127.5


def from_tanh_range(data: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 255] (reference test.py:164)."""
    return data.astype(np.float32) * 127.5 + 127.5


def resample_to_spacing(img: NiftiImage, new_spacing: Sequence[float],
                        interpolation: str = "linear") -> NiftiImage:
    """Resample onto a grid with the given spacing, keeping voxel 0's
    centre (the legacy Resample transform, reference
    utils/NiftiDataset.py:837-873)."""
    zoom = np.asarray(img.spacing) / np.asarray(new_spacing, np.float64)
    new_shape = tuple(int(np.ceil(s * z)) for s, z in zip(img.data.shape[:3], zoom))
    new_aff = img.affine.copy()
    new_aff[:3, :3] = img.affine[:3, :3] @ np.diag(1.0 / zoom)
    target = NiftiImage(data=np.zeros(new_shape, np.float32), affine=new_aff)
    return resample_to_reference(img, target, interpolation)


def resample_to_reference(img: NiftiImage, reference: NiftiImage,
                          interpolation: str = "linear") -> NiftiImage:
    """Resample onto another image's grid (the reference's ``resize``,
    utils/NiftiDataset.py:63-106, which maps the decode back to the
    original volume)."""
    order = {"nearest": 0, "linear": 1, "bspline": 3}[interpolation]
    # voxel(ref) -> world -> voxel(img)
    m = np.linalg.inv(img.affine) @ reference.affine
    shape = reference.data.shape[:3]
    coords = np.indices(shape, dtype=np.float64).reshape(3, -1)
    coords = m[:3, :3] @ coords + m[:3, 3:4]
    data = ndimage.map_coordinates(img.data.astype(np.float32), coords, order=order,
                                   mode="nearest").reshape(shape)
    return NiftiImage(data=data, affine=reference.affine.copy(), descrip=img.descrip)


def pad_to_size(data: np.ndarray, size: Sequence[int], mode: str = "constant",
                constant_values: float = 0.0, where: str = "symmetric") -> np.ndarray:
    """Pad (never crop) the three leading spatial dims up to ``size``.
    where='end' zero-extends the high side of each axis, which is exactly the
    reference's same-spacing BSpline Padding (utils/NiftiDataset.py:876-932);
    where='symmetric' centres the content."""
    pads = []
    for ax in range(3):
        need = max(0, int(size[ax]) - data.shape[ax])
        pads.append((0, need) if where == "end" else (need // 2, need - need // 2))
    pads += [(0, 0)] * (data.ndim - 3)
    if all(p == (0, 0) for p in pads):
        return data
    kw = {"constant_values": constant_values} if mode == "constant" else {}
    return np.pad(data, pads, mode=mode, **kw)
