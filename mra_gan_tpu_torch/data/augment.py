"""On-device augmentation of training patches (counterpart of
mra_gan_tpu/data/augment.py).

The reference's ``Augmentation`` transform draws one of 8 active choices per
sample (reference utils/NiftiDataset.py:1113-1300, choice list :1124):
0 none, 1 additive Gaussian noise, 2 Gaussian blur, 3 rotation about x/y/z,
4 B-spline deformation, 5 flip, 6 brightness, 7 contrast. Choices 8-12 (an
in-plane translate, single-axis z/x/y rotations, a gamma imadjust of the
image) are unreachable there; ``extended=True`` (``--augment_extended``)
draws uniformly from all 13, as the JAX package does. The magnitudes are
the reference's, in 0-255 units scaled by (hi - lo)/255 of each member's
value range: the static ``value_range`` when known ((-1, 1) for the legacy
pipeline), else each member's own min/max (the z-scored monai images).
``segmentation=False`` (the reference's setting) applies the intensity
branches to both members; the spatial branches always move both alike.

The JAX package's recorded departures from the reference are kept: the flip
flips (the reference's returns its input), brightness is an additive shift,
contrast keeps the mean in float, and the B-spline warps the sampled patch
with a 10^3 control mesh upsampled trilinearly.

The policy is split into draws and a deterministic apply:

- ``draw_batch`` draws each sample's choice and scalars from an explicit CPU
  ``torch.Generator``, so the step never waits on a device-to-host copy, and
  its tensors (the noise field, the 3 x 10^3 control displacements) from an
  explicit generator on the batch's device. ``step_generators`` seeds both
  from (seed, epoch, step), as the loader keys its draws by (seed, epoch,
  volume), so a run resumed at an epoch boundary draws what the straight
  run drew.
- ``apply_choice`` computes only the drawn branch (the JAX package's vmapped
  ``lax.switch`` evaluates every branch and selects).

Everything runs on the tensors' device. The JAX ops map as follows:
``map_coordinates(order=1, mode="nearest")`` is ``F.grid_sample`` (trilinear,
``padding_mode="border"``, ``align_corners=True``) with the grid's last dim
in (W, H, D) order and each coordinate normalised as 2c/(n-1) - 1; the blur
is an edge-padded separable sum of shifted slices (float32 throughout, no
TF32 convolution); ``jax.image.resize(..., "linear")`` of the control mesh is
``F.interpolate(mode="trilinear", align_corners=False)``, which agrees while
it upsamples: along a patch axis under 10 voxels the JAX resize antialiases
and the two differ.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.replication_pad import replication_pad_fwd

# the branches in the JAX package's order (augment.py:300-307)
BRANCHES = ("none", "noise", "blur", "rotate", "bspline", "flip", "brightness", "contrast",
            "translate", "rotate_z", "rotate_x", "rotate_y", "imadjust")
N_ACTIVE = 8  # the reference's reachable choices
N_EXTENDED = len(BRANCHES)
GRID_POINTS = 10  # the B-spline control mesh per axis
MAX_DISP = 10.0  # control displacements ~ U(0, MAX_DISP) voxels
BLUR_RADIUS = 5
# single-axis rotations of the extended policy: (axis of the angle triple, lo, hi) degrees
_SINGLE_AXIS = {"rotate_z": (2, -180, 180), "rotate_x": (0, -40, 40), "rotate_y": (1, -40, 40)}

Draw = Tuple[int, dict]


# ---------------------------------------------------------------------------
# the ops; x is (N, C, D, H, W) float32 unless stated


def add_gaussian_noise(x: torch.Tensor, noise: torch.Tensor, mean, std) -> torch.Tensor:
    """Additive Gaussian noise with a given standard-normal field (reference
    sitk AdditiveGaussianNoise, utils/NiftiDataset.py:1135-1143)."""
    return x + mean + std * noise


def gauss_kernel1d(sigma: float, radius: int = BLUR_RADIUS) -> List[float]:
    """The normalised taps of JAX ``_gauss_kernel1d``, sigma clamped at 1e-3."""
    t = torch.arange(-radius, radius + 1, dtype=torch.float32)
    s = torch.tensor(sigma, dtype=torch.float32).clamp_min(1e-3)
    k = torch.exp(-0.5 * (t / s) ** 2)
    return (k / k.sum()).tolist()


def gaussian_blur(x: torch.Tensor, sigma: float, radius: int = BLUR_RADIUS) -> torch.Tensor:
    """Separable Gaussian smoothing with edge padding (reference
    RecursiveGaussian order 0, utils/NiftiDataset.py:1148-1159)."""
    taps = gauss_kernel1d(sigma, radius)
    y = x
    for axis in (2, 3, 4):
        pads = [0] * 6
        pads[2 * axis - 4] = pads[2 * axis - 3] = radius
        yp = replication_pad_fwd(y, tuple(pads))
        n = y.shape[axis]
        acc = yp.narrow(axis, 0, n) * taps[0]
        for i in range(1, len(taps)):
            acc = acc + yp.narrow(axis, i, n) * taps[i]
        y = acc
    return y


def _voxel_grid(shape: Sequence[int], device) -> Tuple[torch.Tensor, ...]:
    return torch.meshgrid(*[torch.arange(n, dtype=torch.float32, device=device)
                            for n in shape], indexing="ij")


def sample_nearest(x: torch.Tensor, coords: Sequence[torch.Tensor]) -> torch.Tensor:
    """JAX ``map_coordinates(x, coords, order=1, mode="nearest")`` for each
    (n, c) volume of x: trilinear at the voxel coordinates (d, h, w), each a
    (D', H', W') tensor, clamped to the volume."""
    d, h, w = x.shape[2:]
    norm = [2.0 * c / max(n - 1, 1) - 1.0 for c, n in zip(coords, (d, h, w))]
    grid = torch.stack(norm[::-1], dim=-1)[None].expand(x.shape[0], -1, -1, -1, -1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=True)


def rotation_matrix(angles: Sequence[float]) -> np.ndarray:
    """R = rz @ ry @ rx for Euler angles (x, y, z) in radians (JAX
    ``_rotate_coords``, augment.py:100-114)."""
    a, b, g = (float(v) for v in angles)
    rx = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]])
    rz = np.array([[math.cos(g), -math.sin(g), 0], [math.sin(g), math.cos(g), 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


def rotate3d(x: torch.Tensor, angles: Sequence[float]) -> torch.Tensor:
    """Rotation about the volume centre ((d-1)/2, (h-1)/2, (w-1)/2) by Euler
    angles in radians (the reference's rotation3d helpers,
    utils/NiftiDataset.py:234-275), trilinear, edge-clamped."""
    shape = x.shape[2:]
    rot = rotation_matrix(angles).tolist()
    rel = [g - (n - 1) / 2.0 for g, n in zip(_voxel_grid(shape, x.device), shape)]
    coords = [rot[i][0] * rel[0] + rot[i][1] * rel[1] + rot[i][2] * rel[2] + (shape[i] - 1) / 2.0
              for i in range(3)]
    return sample_nearest(x, coords)


def bspline_deform(x: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Smooth displacement field from a (3, g, g, g) control mesh of
    displacements (reference BSplineTransform, mesh 10^3, U(0,1)*10,
    utils/NiftiDataset.py:1178-1202), upsampled trilinearly to the patch."""
    shape = tuple(x.shape[2:])
    full = F.interpolate(disp[None], size=shape, mode="trilinear", align_corners=False)[0]
    coords = [g + full[i] for i, g in enumerate(_voxel_grid(shape, x.device))]
    return sample_nearest(x, coords)


def flip3d(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Flip over spatial axis ``axis`` (0 or 1, reference :1210); the
    reference's flipit returns its input (recorded bug, :278-294)."""
    return torch.flip(x, dims=(2 + axis,))


def brightness(x: torch.Tensor, shift, lo, hi) -> torch.Tensor:
    """Additive shift clipped to [lo, hi] (reference ``brightness``,
    utils/NiftiDataset.py:297-318)."""
    return torch.clamp(x + shift, lo, hi)


def contrast(x: torch.Tensor, factor: float, lo, hi) -> torch.Tensor:
    """Deviations from the (float) mean scaled by ``factor``, clipped
    (reference ``contrast``, utils/NiftiDataset.py:321-351)."""
    m = x.mean()
    return torch.clamp((x - m) * factor + m, lo, hi)


def translate3d(x: torch.Tensor, shift: Sequence[int]) -> torch.Tensor:
    """In-plane shift by whole voxels along the first two spatial axes,
    edge-clamped (the reference's translateit, utils/NiftiDataset.py:354-369;
    JAX's nearest-mode map_coordinates at integer offsets)."""
    for axis, s in zip((2, 3), shift):
        n = x.shape[axis]
        idx = (torch.arange(n, device=x.device) - int(s)).clamp(0, n - 1)
        x = x.index_select(axis, idx)
    return x


def imadjust(x: torch.Tensor, gamma: float, lo, hi) -> torch.Tensor:
    """Min-max normalise, ``** gamma``, rescale to [lo, hi] (the reference's
    imadjust, utils/NiftiDataset.py:372-387, with gamma drawn per sample)."""
    xmin, xmax = x.min(), x.max()
    z = (x - xmin) / torch.clamp_min(xmax - xmin, 1e-8)
    return z ** gamma * (hi - lo) + lo


# ---------------------------------------------------------------------------
# the policy


def step_generators(seed: int, epoch: int, step: int,
                    device) -> Tuple[torch.Generator, torch.Generator]:
    """(CPU generator, generator on ``device``) for one training step, seeded
    from (seed, epoch, step) through numpy's SeedSequence."""
    s_cpu, s_dev = np.random.SeedSequence([seed, epoch, step]).generate_state(2, np.uint64)
    device = torch.device(device)
    return (torch.Generator().manual_seed(int(s_cpu)),
            torch.Generator(device=device).manual_seed(int(s_dev)))


def draw_params(choice: int, shape: Sequence[int], gen: torch.Generator,
                dev_gen: torch.Generator) -> dict:
    """Branch ``choice``'s parameters at the reference's magnitudes: scalars
    from the CPU ``gen``, the noise field and the control displacements from
    ``dev_gen`` on its device."""
    name = BRANCHES[choice]

    def uniform(hi: float, lo: float = 0.0) -> float:
        return lo + (hi - lo) * torch.rand((), generator=gen).item()

    def randint(lo: int, hi: int, size=()) -> list:
        return torch.randint(lo, hi, size, generator=gen).tolist()

    dev = dev_gen.device
    if name == "noise":
        return {"mean": uniform(1.0), "std": uniform(2.0),
                "noise": torch.randn(tuple(shape), generator=dev_gen, device=dev)}
    if name == "blur":
        return {"sigma": uniform(1.5)}
    if name == "rotate":
        deg = [randint(-40, 40), randint(-40, 40), randint(-180, 180)]
        return {"angles": [d * math.pi / 180.0 for d in deg]}
    if name == "bspline":
        disp = torch.rand((3,) + (GRID_POINTS,) * 3, generator=dev_gen, device=dev)
        return {"disp": disp * MAX_DISP}
    if name == "flip":
        return {"axis": randint(0, 2)}
    if name in ("brightness", "contrast"):
        return {"c": randint(-20, 20)}
    if name == "translate":
        return {"shift": randint(-40, 40, (2,))}
    if name in _SINGLE_AXIS:
        axis, lo, hi = _SINGLE_AXIS[name]
        angles = [0.0, 0.0, 0.0]
        angles[axis] = randint(lo, hi) * math.pi / 180.0
        return {"angles": angles}
    if name == "imadjust":
        return {"gamma": uniform(2.0, 1.0)}
    return {}


def draw_batch(batch: int, shape: Sequence[int], gen: torch.Generator,
               dev_gen: torch.Generator, extended: bool = False) -> List[Draw]:
    """One (choice, params) per sample: the batch's choices, uniform over 8
    (13 when ``extended``), then each sample's parameters in batch order."""
    choices = torch.randint(0, N_EXTENDED if extended else N_ACTIVE, (batch,),
                            generator=gen).tolist()
    return [(c, draw_params(c, shape, gen, dev_gen)) for c in choices]


def apply_choice(image: torch.Tensor, label: torch.Tensor, choice: int, params: dict,
                 value_range: Optional[Tuple[float, float]] = None,
                 segmentation: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branch ``choice`` with ``params`` (``draw_params``'s form) on one
    (D, H, W) float32 image/label pair; JAX ``random_augment``'s branch of
    the same parameters."""
    name = BRANCHES[choice]
    if name == "none":
        return image, label
    if value_range is not None:
        ilo = llo = float(value_range[0])
        ihi = lhi = float(value_range[1])
    else:
        ilo, ihi = image.min(), image.max()
        llo, lhi = label.min(), label.max()
    iscale, lscale = (ihi - ilo) / 255.0, (lhi - llo) / 255.0

    def both(fn_im, fn_lb):
        return fn_im(image), (label if segmentation else fn_lb(label))

    def spatial(fn):  # one transform of both members, stacked as channels
        out = fn(torch.stack([image, label])[None])[0]
        return out[0], out[1]

    if name == "noise":
        m, s, z = params["mean"], params["std"], params["noise"]
        return both(lambda v: add_gaussian_noise(v, z, m * iscale, s * iscale),
                    lambda v: add_gaussian_noise(v, z, m * lscale, s * lscale))
    if name == "blur":
        if segmentation:
            return gaussian_blur(image[None, None], params["sigma"])[0, 0], label
        out = gaussian_blur(torch.stack([image, label])[:, None], params["sigma"])
        return out[0, 0], out[1, 0]
    if name == "rotate" or name in _SINGLE_AXIS:
        return spatial(lambda x: rotate3d(x, params["angles"]))
    if name == "bspline":
        return spatial(lambda x: bspline_deform(x, params["disp"]))
    if name == "flip":
        return spatial(lambda x: flip3d(x, params["axis"]))
    if name == "brightness":
        c = float(params["c"])
        return both(lambda v: brightness(v, c * iscale, ilo, ihi),
                    lambda v: brightness(v, c * lscale, llo, lhi))
    if name == "contrast":
        factor = 1.0 + float(params["c"]) / 100.0
        return both(lambda v: contrast(v, factor, ilo, ihi),
                    lambda v: contrast(v, factor, llo, lhi))
    if name == "translate":
        return spatial(lambda x: translate3d(x, params["shift"]))
    if name == "imadjust":  # the image only (reference :1297)
        return imadjust(image, params["gamma"], ilo, ihi), label
    raise ValueError(f"unknown augmentation choice {choice}")


def apply_batch(images: torch.Tensor, labels: torch.Tensor, draws: Sequence[Draw],
                value_range: Optional[Tuple[float, float]] = None,
                segmentation: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_choice`` of each sample's draw over (B, 1, D, H, W) batches."""
    pairs = [apply_choice(images[i, 0].float(), labels[i, 0].float(), c, p, value_range,
                          segmentation) for i, (c, p) in enumerate(draws)]
    return (torch.stack([p[0] for p in pairs])[:, None],
            torch.stack([p[1] for p in pairs])[:, None])


def augment_batch(images: torch.Tensor, labels: torch.Tensor,
                  generators: Tuple[torch.Generator, torch.Generator],
                  value_range: Optional[Tuple[float, float]] = None,
                  segmentation: bool = False,
                  extended: bool = False, batch: Optional[int] = None,
                  rows: Optional[slice] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random policy over (B, 1, D, H, W) float32 batches (JAX
    ``augment_batch``, augment.py:311-326): ``draw_batch`` from
    ``generators`` (``step_generators``' pair, the second on the batch's
    device), then ``apply_batch``. Given ``rows``, the batches are those rows
    of a global batch of ``batch`` samples (a data-parallel rank's part): the
    draws are still the global batch's, keeping both streams in step, and
    only these rows' are applied, so the result is the global batch's
    augmentation sliced to ``rows``, bit for bit."""
    draws = draw_batch(images.shape[0] if rows is None else batch,
                       tuple(images.shape[2:]), *generators, extended=extended)
    if rows is not None:
        draws = draws[rows]
        if len(draws) != images.shape[0]:
            raise ValueError(f"rows {rows} of a batch of {batch} are not the "
                             f"{images.shape[0]} samples given")
    return apply_batch(images, labels, draws, value_range, segmentation)
