"""Host-side preprocessing (numpy/scipy).

The port's own copy of mra_gan_tpu/data/transforms.py: orientation to RAS,
the z-score, the foreground crop and the pos/neg-weighted patch starts of the
monai chain (:32-540); the legacy 0-255 rescale, the [-1, 1] tanh range and
back, spacing resample, resample onto a reference grid, pad-to-patch-size
and the rejection-sampled crop; and the rest of the legacy chain's
transforms (statistical and manual normalization, the two adaptive
histogram equalizations, intensity inversion, metadata alignment, Laplacian
sharpening, the background and confidence crops). The arithmetic is
unchanged; keep the two in step. Random draws take an explicit
np.random.Generator, so that the same generator gives the JAX package's
draws.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def statistical_normalize(data: np.ndarray, sigma: float = 2.5) -> np.ndarray:
    """Legacy StatisticalNormalization: window to mean±sigma*std, rescale to
    0-255 (reference utils/NiftiDataset.py:654-679)."""
    x = data.astype(np.float32)
    mu, sd = float(x.mean()), float(x.std())
    lo, hi = mu - sigma * sd, mu + sigma * sd
    x = np.clip(x, lo, hi)
    span = hi - lo
    return (x - lo) * (255.0 / span) if span > 0 else np.zeros_like(x)


def manual_normalize(data: np.ndarray, window_min: float, window_max: float) -> np.ndarray:
    """Legacy ManualNormalization: fixed intensity window -> 0-255
    (reference utils/NiftiDataset.py:682-704)."""
    x = np.clip(data.astype(np.float32), window_min, window_max)
    span = window_max - window_min
    return (x - window_min) * (255.0 / span) if span > 0 else np.zeros_like(x)


def adaptive_equalize_itk(data: np.ndarray, alpha: float = 0.7,
                          beta: float = 0.8, radius: int = 5) -> np.ndarray:
    """Reference-parity Adapt_eq_histogram (utils/NiftiDataset.py:935-958):
    ITK's AdaptiveHistogramEqualizationImageFilter with the reference's
    SetAlpha(0.7)/SetBeta(0.8) and default radius 5, followed by the
    reference's RescaleIntensity to [0, 255].

    The filter is Stark's power-law generalization of windowed histogram
    equalization: per voxel u, over its (2r+1)^3 window of neighbors v
    (edge-replicated boundary), accumulate

        C(u, v) = 0.5 * sgn(u - v) * |2(u - v)|^alpha + beta * v

    on min-max-normalized intensities, then mean over the window. The form
    is pinned down by ITK's documented limit behaviors, all of which hold
    here exactly (tests/test_transforms.py): alpha=0, beta=0 is classical
    windowed histogram equalization (the sgn-sum is the window rank);
    alpha=1, beta=0 is an unsharp mask (u - local mean); alpha=1, beta=1 is
    pass-through. Normalization-convention constants (ITK centers on
    [-0.5, 0.5]) cancel in the trailing min-max rescale. Bit-exactness vs
    ITK is unverifiable in this environment (no SimpleITK) — recorded
    residual risk, limited to boundary handling.

    Cost is O(voxels * (2r+1)^3) — ~1.3k whole-volume passes at the default
    radius; intended for offline preprocessing like the reference's use."""
    x = np.asarray(data, np.float32)
    lo, hi = float(x.min()), float(x.max())
    if hi <= lo:
        return np.zeros_like(x)
    u = (x - lo) / (hi - lo)
    r = int(radius)
    up = np.pad(u, r, mode="edge")  # ZeroFluxNeumann
    d0, d1, d2 = u.shape
    acc = np.zeros_like(u)
    vsum = np.zeros_like(u)
    for di in range(2 * r + 1):
        for dj in range(2 * r + 1):
            for dk in range(2 * r + 1):
                v = up[di:di + d0, dj:dj + d1, dk:dk + d2]
                dlt = u - v
                acc += 0.5 * np.sign(dlt) * np.abs(2.0 * dlt) ** alpha
                vsum += v
    n = float((2 * r + 1) ** 3)
    f = acc / n + beta * vsum / n + 0.5
    flo, fhi = float(f.min()), float(f.max())
    if fhi <= flo:
        return np.zeros_like(f)
    return (f - flo) / (fhi - flo) * 255.0


def adaptive_equalize(data: np.ndarray, alpha: float = 0.6, beta: float = 0.3,
                      tiles: int = 4, clip_limit: float = 3.0) -> np.ndarray:
    """Fast tiled-CLAHE variant of local histogram equalization — per-tile
    clip-redistributed histograms with trilinear interpolation of the tile
    mappings. Kept as the cheap approximate option; the reference-parity
    algorithm (reference Adapt_eq_histogram, utils/NiftiDataset.py:935-958)
    is ``adaptive_equalize_itk``. NOTE the parameters here are CLAHE-style
    (``alpha`` blends equalized vs identity), not ITK's Stark alpha/beta."""
    x = data.astype(np.float32)
    lo, hi = np.percentile(x, [1, 99])
    x = np.clip(x, lo, hi)
    if hi > lo:
        x = (x - lo) / (hi - lo)
    else:
        x = np.zeros_like(x)

    nbins = 256
    b = np.minimum((x * (nbins - 1)).astype(np.int32), nbins - 1)
    shape = x.shape
    nt = [max(1, min(tiles, s // 4)) for s in shape]
    # per-tile clipped CDFs
    cdfs = np.empty((*nt, nbins), np.float32)
    bounds = [np.linspace(0, s, n + 1).astype(int) for s, n in zip(shape, nt)]
    centers = [(bd[:-1] + bd[1:]) / 2.0 for bd in bounds]
    for i in range(nt[0]):
        for j in range(nt[1]):
            for k in range(nt[2]):
                tb = b[bounds[0][i]:bounds[0][i + 1],
                       bounds[1][j]:bounds[1][j + 1],
                       bounds[2][k]:bounds[2][k + 1]]
                hist = np.bincount(tb.ravel(), minlength=nbins).astype(np.float32)
                limit = clip_limit * hist.mean()
                excess = np.maximum(hist - limit, 0).sum()
                hist = np.minimum(hist, limit) + excess / nbins
                c = np.cumsum(hist)
                cdfs[i, j, k] = c / c[-1]

    # trilinear interpolation of the 8 surrounding tile mappings
    idx = [np.arange(s, dtype=np.float32) for s in shape]
    fs, los_ = [], []
    for ax in range(3):
        pos = np.interp(idx[ax], centers[ax],
                        np.arange(nt[ax], dtype=np.float32))
        lo_i = np.clip(np.floor(pos).astype(np.int32), 0, nt[ax] - 1)
        fs.append((pos - lo_i).astype(np.float32))
        los_.append(lo_i)
    eq = np.zeros(shape, np.float32)
    for di in (0, 1):
        wi = (1 - fs[0] if di == 0 else fs[0])[:, None, None]
        ii = np.minimum(los_[0] + di, nt[0] - 1)
        for dj in (0, 1):
            wj = (1 - fs[1] if dj == 0 else fs[1])[None, :, None]
            jj = np.minimum(los_[1] + dj, nt[1] - 1)
            for dk in (0, 1):
                wk = (1 - fs[2] if dk == 0 else fs[2])[None, None, :]
                kk = np.minimum(los_[2] + dk, nt[2] - 1)
                m = cdfs[ii[:, None, None], jj[None, :, None],
                         kk[None, None, :], b]
                eq += wi * wj * wk * m

    out = alpha * eq + (1 - alpha) * x ** (1 - beta)
    return np.clip(out * 255.0, 0, 255)


def invert_intensity(data: np.ndarray) -> np.ndarray:
    """Reference Invert (utils/NiftiDataset.py:751-764): max - voxel."""
    return data.max() - data


def align_to(image: NiftiImage, reference: NiftiImage) -> NiftiImage:
    """Reference Align (utils/NiftiDataset.py:815-835): stamp the reference
    volume's physical-space metadata (origin/spacing/direction — i.e. the
    affine) onto the image, voxel data untouched."""
    return NiftiImage(data=image.data, affine=reference.affine.copy(),
                      descrip=getattr(image, "descrip", b""))


def laplacian_sharpen(data: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Laplacian-of-Gaussian sharpening (reference LaplacianRecursive,
    utils/NiftiDataset.py:707-727)."""
    x = data.astype(np.float32)
    return x - ndimage.gaussian_laplace(x, sigma)


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


def orientation_codes(affine: np.ndarray) -> str:
    """Closest axis codes (e.g. 'RAS', 'LPS') of an affine's voxel axes."""
    codes = []
    pos = "RAS"
    neg = "LPI"
    for col in range(3):
        v = affine[:3, col]
        ax = int(np.argmax(np.abs(v)))
        codes.append(pos[ax] if v[ax] >= 0 else neg[ax])
    return "".join(codes)


def to_ras(img: NiftiImage) -> NiftiImage:
    """Reorient voxels so axes run R, A, S (the MONAI Orientationd('RAS')
    equivalent, reference train.py:37). Pure permutation+flip; updates the
    affine so physical space is unchanged."""
    aff = img.affine
    perm = [0, 0, 0]
    flip = [False, False, False]
    taken = set()
    for col in range(3):
        v = aff[:3, col]
        order = np.argsort(-np.abs(v))
        ax = next(int(a) for a in order if int(a) not in taken)
        taken.add(ax)
        perm[ax] = col
        flip[ax] = v[ax] < 0
    data = np.transpose(img.data, perm + list(range(3, img.data.ndim)))
    new_aff = np.eye(4)
    new_aff[:, :3] = aff[:, perm]
    new_aff[:, 3] = aff[:, 3]
    for ax in range(3):
        if flip[ax]:
            data = np.flip(data, axis=ax)
            new_aff[:, ax] = -new_aff[:, ax]
            new_aff[:3, 3] += aff[:3, perm[ax]] * (img.data.shape[perm[ax]] - 1)
    return NiftiImage(data=np.ascontiguousarray(data), affine=new_aff, descrip=img.descrip)


def zscore_normalize(data: np.ndarray, nonzero: bool = False) -> np.ndarray:
    """MONAI NormalizeIntensityd equivalent (reference train.py:38)."""
    x = data.astype(np.float32)
    sel = x[x != 0] if nonzero else x
    std = sel.std()
    return (x - sel.mean()) / (std if std > 0 else 1.0)


def crop_foreground(
    image: np.ndarray,
    label: Optional[np.ndarray] = None,
    threshold: float = 0.0,
    margin: int = 0,
) -> Tuple[np.ndarray, Optional[np.ndarray], Tuple[slice, ...]]:
    """Crop to the bounding box of image > threshold (MONAI CropForegroundd
    equivalent, reference train.py:41)."""
    mask = image > threshold
    if not mask.any():
        sl = tuple(slice(0, s) for s in image.shape[:3])
        return image, label, sl
    slices = []
    for ax in range(3):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        prof = mask.any(axis=other)
        idx = np.where(prof)[0]
        lo = max(0, int(idx[0]) - margin)
        hi = min(image.shape[ax], int(idx[-1]) + 1 + margin)
        slices.append(slice(lo, hi))
    sl = tuple(slices)
    out_img = image[sl]
    out_lbl = label[sl] if label is not None else None
    return out_img, out_lbl, sl


class _CountedMask:
    """Uniform sampling of true-voxel coordinates from a 3-D bool mask
    without materializing the full index list (np.argwhere of a dense
    128^3 mask is a ~50 MB build per call; this is one counting pass plus
    a per-draw slab-local argwhere). nth_true(r) returns the r-th true
    voxel in C order — identical to argwhere(mask)[r]."""

    def __init__(self, mask: np.ndarray):
        self.mask = mask
        self.slab_cum = np.cumsum(
            np.count_nonzero(mask.reshape(mask.shape[0], -1), axis=1))
        self.count = int(self.slab_cum[-1]) if len(self.slab_cum) else 0

    def nth_true(self, r: int) -> Tuple[int, int, int]:
        z = int(np.searchsorted(self.slab_cum, r, side="right"))
        prev = int(self.slab_cum[z - 1]) if z else 0
        within = np.argwhere(self.mask[z])
        yx = within[r - prev]
        return (z, int(yx[0]), int(yx[1]))


def rand_crop_starts_by_pos_neg(
    image: np.ndarray,
    label: np.ndarray,
    patch_size: Sequence[int],
    rng: np.random.Generator,
    num_samples: int = 2,
    pos: float = 20.0,
    neg: float = 0.0,
    image_threshold: float = -1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Like rand_crop_by_pos_neg but returns (padded_image, padded_label,
    starts[n,3]) so callers can gather all patches in one (native,
    multi-threaded) pass instead of slicing per sample."""
    patch = [int(p) for p in patch_size]
    image = pad_to_size(image, patch)
    label = pad_to_size(label, patch)
    shape = image.shape[:3]
    # Counted lazy sampling instead of materializing argwhere index arrays:
    # a full-volume foreground list is ~50 MB and was ~85% of the cold
    # loader's time, and with the default pos=20/neg=0 the negative class is
    # only ever consulted when the label has no positive voxel at all. Draw
    # sequence is unchanged: same rng calls, and _CountedMask selects the
    # r-th true voxel in the same C order argwhere used.
    pos_cls = _CountedMask(label[..., 0] > 0 if label.ndim > 3 else label > 0)
    neg_cls: Optional[_CountedMask] = None
    p_pos = pos / (pos + neg) if (pos + neg) > 0 else 1.0
    starts = np.empty((num_samples, 3), np.int64)
    half_lo = [p // 2 for p in patch]
    for i in range(num_samples):
        take_pos = rng.random() < p_pos
        src = pos_cls
        if not (take_pos and pos_cls.count):
            if neg_cls is None:
                neg_cls = _CountedMask(
                    (image[..., 0] if image.ndim > 3 else image)
                    > image_threshold)
            src = neg_cls
        if src.count == 0:
            center = [rng.integers(half_lo[a], shape[a] - (patch[a] - half_lo[a]) + 1)
                      for a in range(3)]
        else:
            center = src.nth_true(int(rng.integers(src.count)))
        starts[i] = [int(np.clip(center[a] - half_lo[a], 0, shape[a] - patch[a]))
                     for a in range(3)]
    return image, label, starts


def rand_crop_by_pos_neg(
    image: np.ndarray,
    label: np.ndarray,
    patch_size: Sequence[int],
    rng: np.random.Generator,
    num_samples: int = 2,
    pos: float = 20.0,
    neg: float = 0.0,
    image_threshold: float = -1.0,
) -> list:
    """MONAI RandCropByPosNegLabeld equivalent (reference train.py:42):
    sample patch centers at label-positive voxels with probability
    pos/(pos+neg) (here 1.0), else at image>threshold voxels; fall back to
    uniform centers when the requested class is empty."""
    patch = [int(p) for p in patch_size]
    image, label, starts = rand_crop_starts_by_pos_neg(
        image, label, patch, rng, num_samples, pos, neg, image_threshold)
    out = []
    for s in starts:
        sl = tuple(slice(int(s[a]), int(s[a]) + patch[a]) for a in range(3))
        out.append((image[sl], label[sl]))
    return out


def crop_background(
    image: np.ndarray,
    label: np.ndarray,
    patch_size: Sequence[int],
    threshold: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-size crop centered on the foreground centroid (the legacy
    CropBackground transform, reference utils/NiftiDataset.py:961-1010)."""
    patch = [int(p) for p in patch_size]
    image = pad_to_size(image, patch)
    label = pad_to_size(label, patch)
    mask = image > threshold
    if mask.any():
        center = ndimage.center_of_mass(mask)
    else:
        center = [s / 2 for s in image.shape[:3]]
    start = [int(np.clip(round(center[a] - patch[a] / 2), 0,
                         image.shape[a] - patch[a])) for a in range(3)]
    sl = tuple(slice(start[a], start[a] + patch[a]) for a in range(3))
    return image[sl], label[sl]


def confidence_crop(
    image: np.ndarray,
    label: np.ndarray,
    patch_size: Sequence[int],
    rng: np.random.Generator,
    sigma_frac: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Crop centered near a random foreground voxel of the label, jittered by
    a Gaussian whose scale is a fraction of the patch (the legacy
    ConfidenceCrop, reference utils/NiftiDataset.py:1302-1388)."""
    patch = [int(p) for p in patch_size]
    image = pad_to_size(image, patch)
    label = pad_to_size(label, patch)
    fg = np.argwhere(label > 0)
    if len(fg):
        center = fg[rng.integers(len(fg))][:3].astype(np.float64)
    else:
        center = np.array([s / 2 for s in image.shape[:3]])
    center = center + rng.normal(0, sigma_frac * np.asarray(patch), 3)
    start = [int(np.clip(round(center[a] - patch[a] / 2), 0,
                         image.shape[a] - patch[a])) for a in range(3)]
    sl = tuple(slice(start[a], start[a] + patch[a]) for a in range(3))
    return image[sl], label[sl]


def random_crop_start(
    image: np.ndarray,
    label: np.ndarray,
    patch_size: Sequence[int],
    rng: np.random.Generator,
    drop_ratio: float = 0.0,
    min_pixel: int = 1,
    max_attempts: int = 100,
) -> np.ndarray:
    """Start offset of one legacy rejection-sampled crop over the
    already-padded (image, label). The rejection test reads label views
    only — no patch copies."""
    patch = [int(p) for p in patch_size]
    shape = image.shape[:3]
    for _ in range(max_attempts):
        start = [rng.integers(0, shape[a] - patch[a] + 1) for a in range(3)]
        sl = tuple(slice(start[a], start[a] + patch[a]) for a in range(3))
        if np.count_nonzero(label[sl]) >= min_pixel or rng.random() <= drop_ratio:
            break
    return np.asarray(start, np.int64)


def random_crop(
    image: np.ndarray,
    label: np.ndarray,
    patch_size: Sequence[int],
    rng: np.random.Generator,
    drop_ratio: float = 0.0,
    min_pixel: int = 1,
    max_attempts: int = 100,
) -> Tuple[np.ndarray, np.ndarray]:
    """Legacy rejection-sampling RandomCrop (reference
    utils/NiftiDataset.py:1013-1110): uniform random crops, re-drawn while
    the label patch has fewer than ``min_pixel`` non-zero voxels, each
    rejection kept anyway with probability ``drop_ratio``. Attempt-bounded
    (host-side loop; the unbounded reference loop can spin forever)."""
    patch = [int(p) for p in patch_size]
    image = pad_to_size(image, patch)
    label = pad_to_size(label, patch)
    s = random_crop_start(image, label, patch, rng, drop_ratio, min_pixel,
                          max_attempts)
    sl = tuple(slice(int(s[a]), int(s[a]) + patch[a]) for a in range(3))
    return image[sl], label[sl]
