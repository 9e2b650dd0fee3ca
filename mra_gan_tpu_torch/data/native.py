"""ctypes bindings for the port's native data path, data/csrc/nifti_io.cc
(counterpart of mra_gan_tpu/data/native.py): a zlib NIfTI-1 reader that
decodes straight into float32 with scl_slope/scl_inter fused in, and a
std::thread patch gather.

The library is built at first use with g++ into
``<repo>/build/native/nifti_io-<hash>.so``, where the hash covers the source,
the flags and the host CPU's features (-march=native builds for them), so an
edited source, or a checkout shared with another CPU, rebuilds and an
unchanged one is reused; concurrent builds (test workers, loader threads)
each write a temporary file and rename it. Where it cannot be built (no g++,
no zlib.h) ``available()`` is False and ``load_nifti``/``extract_patches``
return None, and the loader keeps the pure-Python reader and the numpy
gather, as the JAX package's does; ``build_status()`` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .nifti import _quaternion_to_affine

SOURCE = Path(__file__).resolve().parent / "csrc" / "nifti_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# -ffp-contract=off: s * slope + inter rounds twice, as data/nifti.py's
# numpy does, so the reader is bit-equal to it under -march=native's FMAs
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_status: Optional[dict] = None


class _NiftiInfo(ctypes.Structure):
    _fields_ = [
        ("dims", ctypes.c_int64 * 8),
        ("datatype", ctypes.c_int32),
        ("pixdim", ctypes.c_float * 8),
        ("scl_slope", ctypes.c_float),
        ("scl_inter", ctypes.c_float),
        ("srow", ctypes.c_float * 12),
        ("sform_code", ctypes.c_int32),
        ("qform_code", ctypes.c_int32),
        ("quatern", ctypes.c_float * 6),
    ]


def _cpu_features() -> str:
    """The host CPU's feature flags (/proc/cpuinfo), else its name."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return platform.processor()


class _Voxels:
    """The float32 buffer ``nifti_read`` allocated, as numpy's array
    interface; numpy views keep it alive, and it is freed with the last."""

    def __init__(self, lib: ctypes.CDLL, buf, count: int):
        self._free, self._buf = lib.nifti_free, buf
        self.__array_interface__ = {
            "shape": (count,), "typestr": "<f4", "version": 3,
            "data": (ctypes.cast(buf, ctypes.c_void_p).value, False)}

    def __del__(self):
        self._free(self._buf)


def library_path() -> Path:
    key = " ".join(CXX_FLAGS + LIBS + (platform.machine(), _cpu_features()))
    digest = hashlib.sha256(SOURCE.read_bytes() + key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"nifti_io-{digest}.so"


def build() -> Path:
    """Build the library unless it is built already; returns its path.
    Raises RuntimeError without g++ or when the compiler fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: g++ is not on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.{threading.get_ident()}.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build or load sees all or nothing
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _status
    if _status is not None:
        return _lib
    with _lock:
        if _status is not None:
            return _lib
        t0 = time.perf_counter()
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _status = {"ok": False, "error": str(e), "compiler": shutil.which("g++"),
                       "seconds": time.perf_counter() - t0, "path": None}
            return None
        lib.nifti_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_NiftiInfo),
                                   ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
        lib.nifti_read.restype = ctypes.c_int
        lib.nifti_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.extract_patches.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
        ]
        _lib = lib
        _status = {"ok": True, "error": None, "compiler": shutil.which("g++"),
                   "seconds": time.perf_counter() - t0, "path": lib._name}
        return lib


def available() -> bool:
    return _load() is not None


def build_status() -> dict:
    """The first load's outcome: ok, error (the compiler's text), compiler
    (g++'s path or None), seconds (build and load; ~0 when the library was
    built already) and the library's path."""
    _load()
    return dict(_status)


def load_nifti(path) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(data[x, y, z, ...] float32, 4x4 affine), or None on any failure (the
    caller falls back to data/nifti.py)."""
    lib = _load()
    if lib is None:
        return None
    info = _NiftiInfo()
    buf = ctypes.POINTER(ctypes.c_float)()
    if lib.nifti_read(str(path).encode(), ctypes.byref(info), ctypes.byref(buf)) != 0:
        return None
    ndim = int(info.dims[0])
    shape = tuple(int(info.dims[i + 1]) for i in range(max(ndim, 3)))
    data = np.asarray(_Voxels(lib, buf, int(np.prod(shape)))).reshape(shape, order="F")
    if info.sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = np.asarray(info.srow, np.float64).reshape(3, 4)
    elif info.qform_code > 0:
        q, pix = list(info.quatern), list(info.pixdim)
        affine = _quaternion_to_affine(q[0], q[1], q[2], q[3], q[4], q[5], pix)
    else:
        pix = list(info.pixdim)
        affine = np.diag([pix[1] or 1.0, pix[2] or 1.0, pix[3] or 1.0, 1.0])
    return data, affine


def extract_patches(vol: np.ndarray, starts: np.ndarray, patch: Tuple[int, int, int],
                    n_threads: int = 4) -> Optional[np.ndarray]:
    """(n, p0, p1, p2) float32 patches of the (d0, d1, d2) volume at the
    (n, 3) ``starts``; ValueError for a patch out of bounds. A read-only or
    strided volume (the warm cache's memory map) is made C-contiguous
    float32 first, which copies only where it must."""
    lib = _load()
    if lib is None:
        return None
    vol = np.ascontiguousarray(vol, np.float32)
    starts = np.ascontiguousarray(starts, np.int64).reshape(-1, 3)
    p0, p1, p2 = (int(p) for p in patch)
    if (starts < 0).any() or (starts + [p0, p1, p2] > np.array(vol.shape[:3])).any():
        raise ValueError("patch out of bounds")
    out = np.empty((len(starts), p0, p1, p2), np.float32)
    lib.extract_patches(vol, *vol.shape[:3], starts.ravel(), len(starts), p0, p1, p2, out,
                        n_threads)
    return out
