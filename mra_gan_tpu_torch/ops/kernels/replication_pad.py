"""Replication (edge) padding of (N, C, D, H, W) volumes: the CUDA kernels'
wrappers and their plain PyTorch versions.

The resnet generator's 14 pads a forward (``ops/conv.py``
``replication_pad3d``) run through these kernels on CUDA, forward and
backward; the JAX package leaves them to XLA's edge pad
(mra_gan_tpu/ops/conv.py:131-150). The kernels' design is described in
``csrc/replication_pad.cu``. Pads are per axis, low and high, in the order
(pd0, pd1, ph0, ph1, pw0, pw1) (D first; F.pad's order is the reverse):

- ``replication_pad_fwd``  x (N, C, D, H, W) -> y (N, C, D + pd0 + pd1,
  H + ph0 + ph1, W + pw0 + pw1): y[o] = x[clamp(o - p_lo, 0, n - 1)] on
  each axis
- ``replication_pad_bwd``  g of y's shape -> dx of x's: each input voxel
  the sum of the output gradients that clamp to it (``fold_range`` per
  axis), folded W first, then H, then D, each fold left to right in
  float32 (float64 for a float64 g), rounded once to g's dtype

A wrapper given a CPU tensor runs its plain version, whose arithmetic the
kernel repeats bit for bit (a meta tensor too, which gives the shapes
alone, as FlopCounterMode's pass over a train step needs); given a CUDA
tensor (bfloat16, float32 or float64) it launches its kernel or raises. A
CUDA tensor that is not contiguous in channels_last_3d is copied into that
layout first, and the copy counted in ``RELAYOUTS["count"]``. Each launch adds one to
``LAUNCHES[<kernel name>]``. The host side of a launch is pure functions
here, so the CPU tests reach it: ``vector_width`` (the elements a thread
moves), ``launch_geometry`` (the grid and the block) and ``launch_plan``
(the checks and the parameters of a launch, once a shape)."""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

LAUNCHES = {"replication_pad_fwd": 0, "replication_pad_bwd": 0}
# CUDA inputs or gradients the wrappers copied into channels_last_3d
RELAYOUTS = {"count": 0}
# csrc/replication_pad.cu's kVecBytes and kMaxThreads
VEC_BYTES = 16
MAX_THREADS = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_CL = torch.channels_last_3d
_PLAIN_DEVICES = ("cpu", "meta")

Pads = Tuple[int, int, int, int, int, int]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    RELAYOUTS["count"] = 0


def out_shape(spatial: Sequence[int], pads: Pads) -> Tuple[int, int, int]:
    """The padded box of an input box (D, H, W)."""
    return tuple(s + pads[2 * i] + pads[2 * i + 1] for i, s in enumerate(spatial))


def fold_range(i: int, n: int, lo: int, hi: int) -> Tuple[int, int]:
    """The first and last output, along an axis of n voxels padded by lo
    and hi, whose clamped index is i: its own output i + lo, and every pad
    output at either end."""
    return (0 if i == 0 else i + lo, n - 1 + lo + hi if i == n - 1 else i + lo)


def vector_width(c: int, itemsize: int, aligned: bool = True) -> int:
    """Elements a thread moves: 16 bytes' worth where a voxel's C channels
    fill whole 16-byte units and the tensors are 16-byte aligned, else one."""
    if aligned and (c * itemsize) % VEC_BYTES == 0:
        return VEC_BYTES // itemsize
    return 1


def launch_geometry(rows: int, row_units: int) -> Tuple[int, int]:
    """(blocks, threads) of a launch: one block a row ((n, od, oh) of the
    output forward, (n, d, h) of the input backward), its threads the row's
    units rounded up to whole warps, at most MAX_THREADS (a longer row is
    walked in strides)."""
    return rows, min(MAX_THREADS, -(-row_units // 32) * 32)


# ---------------------------------------------------------------------------
# plain versions


def _clamped(n: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


def replication_pad_fwd_plain(x: torch.Tensor, pads: Pads) -> torch.Tensor:
    """The forward as an index gather with clamped indices, axis by axis
    (an axis with no pad is not copied; the result is never ``x`` itself)."""
    out = x
    for axis in (2, 3, 4):
        lo, hi = pads[2 * axis - 4], pads[2 * axis - 3]
        if lo or hi:
            out = out.index_select(axis, _clamped(out.shape[axis], lo, hi, out.device))
    return x.clone() if out is x else out


def _fold(t: torch.Tensor, axis: int, n: int, lo: int, hi: int) -> torch.Tensor:
    # along ``axis``: each input index's fold_range summed left to right,
    # starting from its first term
    out = t.narrow(axis, lo, n).clone()
    for i in {0, n - 1}:
        first, last = fold_range(i, n, lo, hi)
        if last > first:
            acc = t.narrow(axis, first, 1)
            for o in range(first + 1, last + 1):
                acc = acc + t.narrow(axis, o, 1)
            out.narrow(axis, i, 1).copy_(acc)
    return out


def replication_pad_bwd_plain(g: torch.Tensor, pads: Pads,
                              spatial: Sequence[int]) -> torch.Tensor:
    """The backward as the kernel computes it: in float32 (float64 for a
    float64 g), W folded first, then H, then D, rounded once to g's dtype."""
    t = g.to(torch.float64 if g.dtype == torch.float64 else torch.float32)
    for axis in (4, 3, 2):
        t = _fold(t, axis, spatial[axis - 2], pads[2 * axis - 4], pads[2 * axis - 3])
    return t.to(g.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import build_library

    lib = ctypes.CDLL(str(build_library("replication_pad")))
    for fn in (lib.mra_pad_fwd, lib.mra_pad_bwd):
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    lib.mra_pad_error_string.argtypes = [ctypes.c_int]
    lib.mra_pad_error_string.restype = ctypes.c_char_p
    return lib


# the current stream's handle without a torch.cuda.Stream object, and the
# current device without torch.cuda.current_device's checks, each of which
# costs more than a launch: the pads run 266 times a decoded volume
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_CURRENT_DEVICE = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)


def _stream(t: torch.Tensor) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(t: torch.Tensor, what: str) -> torch.Tensor:
    """t on the current CUDA device, in channels_last_3d (a copy counted)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {t.device}")
    current = _CURRENT_DEVICE()
    if t.device.index != current:
        raise ValueError(f"{what}: tensor on {t.device} but the current device is "
                         f"cuda:{current}")
    if not t.is_contiguous(memory_format=_CL):
        RELAYOUTS["count"] += 1
        t = t.contiguous(memory_format=_CL)
    return t


@functools.lru_cache(maxsize=1024)
def launch_plan(shape: Tuple[int, ...], pads: Pads, box: Tuple[int, int, int],
                dtype: torch.dtype, aligned: bool, backward: bool):
    """The output's shape and the launch's parameters of a forward on an
    input of ``shape``, or of a backward on an output gradient of ``shape``
    for the input box ``box`` (the input's (D, H, W) forward): (shape,
    (dtype code, N, C, D, H, W, *pads, vec, threads), the parameters as a
    C int array, its address). Raises on what the kernels do not take; the
    checks and the geometry run once a shape."""
    what = "replication_pad_bwd" if backward else "replication_pad_fwd"
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dtype} not supported (float32, bfloat16, float64)")
    if len(shape) != 5 or 0 in shape:
        raise ValueError(f"{what}: expected a non-empty (N, C, D, H, W) tensor, got shape "
                         f"{tuple(shape)}")
    if len(pads) != 6 or min(pads) < 0:
        raise ValueError(f"{what}: pads must be six non-negative ints, got {pads}")
    n, c = shape[:2]
    padded = out_shape(box, pads)
    if tuple(shape[2:]) != (padded if backward else tuple(box)):
        raise ValueError(f"{what}: box {tuple(shape[2:])} is not the padded box {padded} "
                         f"of {tuple(box)}")
    vec = vector_width(c, dtype.itemsize, aligned)
    d, h, w = box if backward else padded
    threads = launch_geometry(n * d * h, w * c // vec)[1]
    params = (_DTYPE_CODES[dtype], n, c, *box, *pads, vec, threads)
    arr = (ctypes.c_int * len(params))(*params)
    return (n, c, *(box if backward else padded)), params, arr, ctypes.addressof(arr)


def _launch(fn, src: torch.Tensor, pads: Pads, box, backward: bool, what: str) -> torch.Tensor:
    shape, _, _, params = launch_plan(src.shape, pads, box, src.dtype,
                                      src.data_ptr() % VEC_BYTES == 0, backward)
    dst = torch.empty(shape, device=src.device, dtype=src.dtype, memory_format=_CL)
    err = fn(src.data_ptr(), dst.data_ptr(), params, _stream(src))
    if err != 0:
        msg = _lib().mra_pad_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[what] += 1
    return dst


def replication_pad_fwd(x: torch.Tensor, pads: Pads) -> torch.Tensor:
    """x (N, C, D, H, W) -> padded (N, C, D', H', W'), channels_last_3d on
    CUDA. ``pads`` a tuple."""
    if x.device.type in _PLAIN_DEVICES:
        return replication_pad_fwd_plain(x, pads)
    x = _on_card(x, "replication_pad_fwd")
    return _launch(_lib().mra_pad_fwd, x, pads, x.shape[2:], False, "replication_pad_fwd")


def replication_pad_bwd(g: torch.Tensor, pads: Pads, spatial: Sequence[int]) -> torch.Tensor:
    """g (N, C, D', H', W'), the gradient of ``replication_pad_fwd``'s output
    for an input box ``spatial`` = (D, H, W) -> dx (N, C, D, H, W),
    channels_last_3d on CUDA. ``pads`` and ``spatial`` tuples."""
    if g.device.type in _PLAIN_DEVICES:
        return replication_pad_bwd_plain(g, pads, spatial)
    g = _on_card(g, "replication_pad_bwd")
    return _launch(_lib().mra_pad_bwd, g, pads, spatial, True, "replication_pad_bwd")
