"""Dependency-free NIfTI-1 reader/writer (pure numpy).

The port's own copy of mra_gan_tpu/data/nifti.py (the port imports nothing
of the JAX package); keep the two in step.

The reference reads/writes NIfTI via SimpleITK (reference
utils/NiftiDataset.py:402, test.py:205-206); SimpleITK is not part of this
framework's dependency set, so the format is implemented directly. Supports
.nii and .nii.gz, the common datatypes, scl_slope/inter scaling, and full
qform/sform affine handling; writing preserves physical space (sform+qform)
so outputs land back in the original scanner coordinates like the
reference's from_numpy_to_itk (test.py:13-19).

Array convention: ``data[x, y, z]`` (NIfTI's native Fortran-ordered axes);
``affine`` maps voxel indices (i,j,k,1) to physical RAS+ mm coordinates.
"""
from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_HDR_SIZE = 348


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray  # (nx, ny, nz) or (nx, ny, nz, nt)
    affine: np.ndarray  # 4x4 voxel->RAS mm
    descrip: bytes = b"mra_gan_tpu"

    @property
    def spacing(self) -> np.ndarray:
        return np.linalg.norm(self.affine[:3, :3], axis=0)

    @property
    def shape(self):
        return self.data.shape

    def with_data(self, data: np.ndarray) -> "NiftiImage":
        return NiftiImage(data=data, affine=self.affine.copy(), descrip=self.descrip)


def _quaternion_to_affine(b, c, d, qx, qy, qz, pixdim):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    S = np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
    aff = np.eye(4)
    aff[:3, :3] = R @ S
    aff[:3, 3] = [qx, qy, qz]
    return aff


def _affine_to_quaternion(affine):
    """Decompose an affine into (pixdim, qfac, quaternion, offset). Only exact
    for shear-free affines; used as a secondary qform alongside sform."""
    R = affine[:3, :3].copy()
    spacing = np.linalg.norm(R, axis=0)
    spacing[spacing == 0] = 1.0
    R = R / spacing
    qfac = 1.0
    if np.linalg.det(R) < 0:
        R[:, 2] = -R[:, 2]
        qfac = -1.0
    # orthonormalize (closest rotation)
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        a = 0.25 * s
        b = (R[2, 1] - R[1, 2]) / s
        c = (R[0, 2] - R[2, 0]) / s
        d = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            a = (R[2, 1] - R[1, 2]) / s
            b = 0.25 * s
            c = (R[0, 1] + R[1, 0]) / s
            d = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            a = (R[0, 2] - R[2, 0]) / s
            b = (R[0, 1] + R[1, 0]) / s
            c = 0.25 * s
            d = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            a = (R[1, 0] - R[0, 1]) / s
            b = (R[0, 2] + R[2, 0]) / s
            c = (R[1, 2] + R[2, 1]) / s
            d = 0.25 * s
    if a < 0:
        a, b, c, d = -a, -b, -c, -d
    return spacing, qfac, (b, c, d), affine[:3, 3]


def _open(path: Union[str, Path], mode: str, compresslevel: int = 1):
    path = str(path)
    if path.endswith(".gz"):
        if "w" in mode:
            return gzip.open(path, mode, compresslevel=compresslevel)
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: Union[str, Path]) -> NiftiImage:
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:_HDR_SIZE]
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        endian = ">"
        (sizeof_hdr,) = struct.unpack_from(">i", hdr, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    magic = hdr[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    dim = struct.unpack_from(endian + "8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 3)])
    (datatype, bitpix) = struct.unpack_from(endian + "2h", hdr, 70)
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", hdr, 108)
    (scl_slope, scl_inter) = struct.unpack_from(endian + "2f", hdr, 112)
    (qform_code, sform_code) = struct.unpack_from(endian + "2h", hdr, 252)
    quat = struct.unpack_from(endian + "6f", hdr, 256)
    srow = np.array(struct.unpack_from(endian + "12f", hdr, 280)).reshape(3, 4)

    if datatype not in _DTYPES:
        raise NotImplementedError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    offset = int(vox_offset)
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")
    data = np.asarray(data, dtype=np.dtype(_DTYPES[datatype]))

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    elif qform_code > 0:
        affine = _quaternion_to_affine(quat[0], quat[1], quat[2], quat[3], quat[4], quat[5], pixdim)
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])
    return NiftiImage(data=data, affine=affine, descrip=hdr[148:228].rstrip(b"\x00"))


def save(img: NiftiImage, path: Union[str, Path], dtype: Optional[np.dtype] = None,
         compresslevel: int = 1) -> None:
    """Write a NIfTI-1 file (.nii, or gzipped .nii.gz).

    ``compresslevel`` applies to .nii.gz only and defaults to 1: float
    volumes are nearly incompressible (measured on 256x256x128 f32: level 9
    gains 0.7% size over level 1 at 1.5x the wall time — 2.0 s vs 1.35 s
    per volume), so the fastest level is the right serving default.
    """
    data = img.data
    if dtype is not None:
        data = data.astype(dtype)
    code = _DTYPE_CODES.get(np.dtype(data.dtype))
    if code is None:
        data = data.astype(np.float32)
        code = 16
    shape = data.shape
    ndim = len(shape)
    dim = [ndim] + list(shape) + [1] * (7 - ndim)
    spacing, qfac, (qb, qc, qd), offset = _affine_to_quaternion(img.affine)
    pixdim = [qfac] + [float(s) for s in spacing] + [0.0] * (7 - max(ndim, 3)) + [0.0] * max(0, ndim - 3)
    pixdim = (pixdim + [0.0] * 8)[:8]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<b", hdr, 38, ord("r"))
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, code, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl
    struct.pack_into("<b", hdr, 123, 10)  # xyzt_units: mm | sec
    descrip = (img.descrip or b"")[:79]
    hdr[148 : 148 + len(descrip)] = descrip
    struct.pack_into("<2h", hdr, 252, 1, 1)  # qform_code, sform_code
    struct.pack_into("<6f", hdr, 256, qb, qc, qd, float(offset[0]), float(offset[1]), float(offset[2]))
    struct.pack_into("<12f", hdr, 280, *img.affine[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb", compresslevel=compresslevel) as f:
        f.write(bytes(hdr))
        f.write(b"\x00\x00\x00\x00")  # no extensions
        # asfortranarray-then-tobytes beats tobytes(order="F") on the raw
        # C-contiguous array (75 vs 106 ms for 33 MB — the explicit permuted
        # copy vectorizes better than the strided serializer)
        f.write(np.asfortranarray(np.asarray(data)).tobytes(order="F"))
