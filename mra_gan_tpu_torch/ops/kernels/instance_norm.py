"""Fused affine-free InstanceNorm3d + activation: the CUDA kernels' wrappers
and their plain PyTorch versions.

Port of mra_gan_tpu/ops/pallas/instance_norm.py (``_fwd`` :108,
``instance_norm_act_tpu`` :196); the kernels' design is described in
``csrc/instance_norm.cu``. Three kernels, one wrapper each:

- ``instance_norm_stats``    x -> per-segment (mean, M2) partials (N, S, C)
- ``instance_norm_finalize`` partials -> mean, rstd (N, C)
- ``instance_norm_apply``    x, mean, rstd -> act((x - mean) * rstd)

A wrapper given a CPU tensor runs its plain version; given a CUDA tensor it
launches its kernel or raises (wrong dtype, shape or layout, failed build,
refused launch). Each launch adds one to ``LAUNCHES[<wrapper name>]``.

``instance_norm_act_plain`` is the plain version of the whole function, step
by step as mra_gan_tpu/ops/norm.py:_in_fwd_core (f32 statistics, centred
variance, elementwise work in x's dtype).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

EPS = 1e-5
ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256          # stats/apply block size, kThreads in the .cu
_TARGET_BLOCKS = 132 * 8  # about 8 resident blocks on each of the H100's 132 SMs
_MIN_VOXELS_PER_LANE = 4

LAUNCHES = {"instance_norm_stats": 0, "instance_norm_finalize": 0,
            "instance_norm_apply": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions


def _act(z: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "none":
        return z
    if act == "relu":
        return torch.relu(z)
    if act == "leaky_relu":
        return torch.where(z >= 0, z, z * slope)
    if act == "tanh":
        return torch.tanh(z)
    raise ValueError(f"unknown activation {act!r}")


def instance_norm_act_plain(x: torch.Tensor, act: str = "none",
                            negative_slope: float = 0.2,
                            eps: float = EPS) -> torch.Tensor:
    """(N, C, D, H, W) -> same shape and dtype."""
    dims = (2, 3, 4)
    mean = x.mean(dim=dims, keepdim=True, dtype=torch.float32)
    xm = x - mean.to(x.dtype)
    var = xm.square().mean(dim=dims, keepdim=True, dtype=torch.float32)
    rstd = torch.rsqrt(var + eps)
    return _act(xm * rstd.to(x.dtype), act, negative_slope).to(x.dtype)


def segment_bounds(voxels: int, segments: int) -> list:
    """First voxel of each of ``segments`` segments, and ``voxels`` last (the
    kernels' seg_begin: segment s is [s * V // S, (s + 1) * V // S))."""
    return [s * voxels // segments for s in range(segments + 1)]


def _segment_sizes(voxels: int, segments: int, device) -> torch.Tensor:
    # built on the device: a host-to-device copy would stall timed queues
    ends = torch.arange(1, segments + 1, device=device) * voxels // segments
    return (ends - torch.arange(segments, device=device) * voxels // segments).float()


def stats_plain(x: torch.Tensor, segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centred (mean, M2) of each voxel segment, (N, S, C) float32; an empty
    segment gives zeros, as in the kernel."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, c, -1)
    voxels = xf.shape[-1]
    # voxel v lies in the last segment s with s * V // S <= v
    seg = ((torch.arange(voxels, device=x.device) + 1) * segments + voxels - 1) // voxels - 1
    counts = _segment_sizes(voxels, segments, x.device)
    mean = xf.new_zeros((n, c, segments)).index_add_(2, seg, xf) / counts.clamp_min(1)
    m2 = xf.new_zeros((n, c, segments)).index_add_(2, seg, (xf - mean[..., seg]).square())
    return mean.transpose(1, 2).contiguous(), m2.transpose(1, 2).contiguous()


def finalize_plain(part_mean: torch.Tensor, part_m2: torch.Tensor, voxels: int,
                   eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chan's parallel merge of the segment partials -> mean, rstd (N, C)."""
    counts = _segment_sizes(voxels, part_mean.shape[1], part_mean.device).view(1, -1, 1)
    mean = (part_mean * counts).sum(1) / voxels
    m2 = part_m2.sum(1) + (counts * (part_mean - mean[:, None]).square()).sum(1)
    return mean, torch.rsqrt(m2 / voxels + eps)


def apply_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                act: str = "none", negative_slope: float = 0.2) -> torch.Tensor:
    z = (x.float() - mean[:, :, None, None, None]) * rstd[:, :, None, None, None]
    return _act(z, act, negative_slope).to(x.dtype)


# ---------------------------------------------------------------------------
# launch geometry (mirrors geometry<VEC>() in the .cu)


def vector_width(x: torch.Tensor) -> int:
    """Channels per thread: one 16-byte access where C and the pointer
    allow it, else one element."""
    vec = 16 // x.element_size()
    if x.shape[1] % vec or x.data_ptr() % 16:
        return 1
    return vec


def num_segments(n: int, voxels: int, c: int, vec: int) -> int:
    """Voxel segments per sample: enough blocks to fill the card about 8
    times over, but at least _MIN_VOXELS_PER_LANE voxels per thread lane."""
    groups = c // vec
    gx = min(groups, _THREADS)
    lanes = _THREADS // gx
    chunks = -(-groups // gx)
    want = -(-_TARGET_BLOCKS // (n * chunks))
    most = max(1, voxels // (lanes * _MIN_VOXELS_PER_LANE))
    return max(1, min(want, most))


# ---------------------------------------------------------------------------
# CUDA wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import build_library

    lib = ctypes.CDLL(str(build_library("instance_norm")))
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.mra_in_stats.argtypes = [p, p, p, i64, i64, i32, i32, i32, i32, p]
    lib.mra_in_finalize.argtypes = [p, p, p, p, i64, i64, i32, i32, f32, p]
    lib.mra_in_apply.argtypes = [p, p, p, p, i64, i64, i32, i32, i32, i32, i32, f32, p]
    for fn in (lib.mra_in_stats, lib.mra_in_finalize, lib.mra_in_apply):
        fn.restype = ctypes.c_int
    lib.mra_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mra_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: tensor on {t.device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")


def _check_volume(x: torch.Tensor, what: str) -> Tuple[int, int, int]:
    _check_cuda(x, what)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"{what}: expected a non-empty (N, C, D, H, W) tensor, "
                         f"got shape {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"{what}: x must be contiguous in channels_last_3d "
                         f"(NDHWC in memory)")
    n, c = x.shape[:2]
    return n, math.prod(x.shape[2:]), c


def _check_stats(t: torch.Tensor, shape: tuple, device, what: str) -> None:
    if (t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{what}: expected contiguous float32 {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().mra_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def instance_norm_stats(x: torch.Tensor, segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C, D, H, W) -> (mean, M2) of each of ``segments`` voxel segments,
    each (N, segments, C) float32."""
    if x.device.type == "cpu":
        return stats_plain(x, segments)
    n, v, c = _check_volume(x, "instance_norm_stats")
    part_mean = torch.empty((n, segments, c), device=x.device, dtype=torch.float32)
    part_m2 = torch.empty_like(part_mean)
    err = _lib().mra_in_stats(x.data_ptr(), part_mean.data_ptr(), part_m2.data_ptr(),
                              n, v, c, segments, _DTYPE_CODES[x.dtype],
                              vector_width(x), _stream(x))
    _raise_on(err, "instance_norm_stats")
    LAUNCHES["instance_norm_stats"] += 1
    return part_mean, part_m2


def instance_norm_finalize(part_mean: torch.Tensor, part_m2: torch.Tensor, voxels: int,
                           eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment partials (N, S, C) -> mean, rstd (N, C) float32."""
    if part_mean.device.type == "cpu":
        return finalize_plain(part_mean, part_m2, voxels, eps)
    _check_cuda(part_mean, "instance_norm_finalize")
    if part_mean.dim() != 3:
        raise ValueError("instance_norm_finalize: partials must be (N, S, C)")
    n, s, c = part_mean.shape
    for t in (part_mean, part_m2):
        _check_stats(t, (n, s, c), part_mean.device, "instance_norm_finalize")
    mean = torch.empty((n, c), device=part_mean.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    err = _lib().mra_in_finalize(part_mean.data_ptr(), part_m2.data_ptr(),
                                 mean.data_ptr(), rstd.data_ptr(), n, voxels, c, s,
                                 eps, _stream(part_mean))
    _raise_on(err, "instance_norm_finalize")
    LAUNCHES["instance_norm_finalize"] += 1
    return mean, rstd


def instance_norm_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                        act: str = "none", negative_slope: float = 0.2) -> torch.Tensor:
    """act((x - mean) * rstd) in x's dtype and layout."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return apply_plain(x, mean, rstd, act, negative_slope)
    n, v, c = _check_volume(x, "instance_norm_apply")
    for t in (mean, rstd):
        _check_stats(t, (n, c), x.device, "instance_norm_apply")
    vec = vector_width(x)
    segments = num_segments(n, v, c, vec)
    y = torch.empty_like(x, memory_format=torch.channels_last_3d)
    err = _lib().mra_in_apply(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), y.data_ptr(),
                              n, v, c, segments, _DTYPE_CODES[x.dtype], vec, ACTS[act],
                              negative_slope, _stream(x))
    _raise_on(err, "instance_norm_apply")
    LAUNCHES["instance_norm_apply"] += 1
    return y


def instance_norm_act_fused(x: torch.Tensor, act: str = "none",
                            negative_slope: float = 0.2, eps: float = EPS) -> torch.Tensor:
    """The kernel path, stats -> finalize -> apply: three launches on CUDA,
    the three plain versions on the CPU."""
    n, c = x.shape[:2]
    voxels = math.prod(x.shape[2:])
    segments = num_segments(n, voxels, c, vector_width(x))
    part_mean, part_m2 = instance_norm_stats(x, segments)
    mean, rstd = instance_norm_finalize(part_mean, part_m2, voxels, eps)
    return instance_norm_apply(x, mean, rstd, act, negative_slope)
