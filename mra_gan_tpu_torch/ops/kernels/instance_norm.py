"""Fused affine-free InstanceNorm3d + activation, forward and backward: the
CUDA kernels' wrappers and their plain PyTorch versions.

Port of mra_gan_tpu/ops/pallas/instance_norm.py (``_fwd`` :108, ``_bwd``
:167, ``instance_norm_act_tpu`` :196); the kernels' design is described in
``csrc/instance_norm.cu``. Six kernels, one wrapper each:

- ``instance_norm_stats``        x -> per-segment (mean, M2) partials (N, S, C)
- ``instance_norm_finalize``     partials -> mean, rstd (N, C)
- ``instance_norm_apply``        x, mean, rstd -> act((x - mean) * rstd)
- ``instance_norm_bwd_stats``    x, g, mean, rstd -> per-segment sums of
  g' = g * act'(z) and g' z (N, S, C)
- ``instance_norm_bwd_finalize`` those sums -> mean(g'), mean(g' z) (N, C)
- ``instance_norm_bwd_apply``    -> dx = rstd * (g' - mean(g') - z mean(g' z))

A wrapper given a CPU tensor runs its plain version; given a CUDA tensor it
launches its kernel or raises (wrong dtype, shape or layout, failed build,
refused launch). Each launch adds one to ``LAUNCHES[<wrapper name>]``;
``instance_norm_act_bwd_fused`` adds one to ``GRAD_RELAYOUTS["count"]`` for
each gradient it had to copy into channels_last_3d.

``instance_norm_act_plain`` and ``instance_norm_act_bwd_plain`` are the plain
versions of the whole function and of its gradient, step by step as
mra_gan_tpu/ops/norm.py:_in_fwd_core and ``_in_vjp_bwd`` (f32 statistics,
centred variance, elementwise work in x's dtype). Given float64 they keep
float64 statistics, which makes them a float64 reference on the card.
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

FORWARD = ("instance_norm_stats", "instance_norm_finalize", "instance_norm_apply")
BACKWARD = ("instance_norm_bwd_stats", "instance_norm_bwd_finalize",
            "instance_norm_bwd_apply")
LAUNCHES = {k: 0 for k in FORWARD + BACKWARD}
GRAD_RELAYOUTS = {"count": 0}


def reset_launches() -> None:
    """Zero every launch counter and the gradient relayout counter."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    GRAD_RELAYOUTS["count"] = 0


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


def act_grad(z: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    """act'(z) from the pre-activation z, float32 (as JAX ``_act_grad``;
    tanh's is formed in z's dtype first, as there). relu and leaky_relu
    pass the gradient at z = 0."""
    if act == "none":
        return torch.ones((), dtype=torch.float32, device=z.device)
    if act == "relu":
        return (z >= 0).float()
    if act == "leaky_relu":
        return torch.where(z >= 0, 1.0, slope).float()
    if act == "tanh":
        return (1.0 - torch.tanh(z).square()).float()
    raise ValueError(f"unknown activation {act!r}")


def _bcast(t: torch.Tensor) -> torch.Tensor:
    return t[:, :, None, None, None]


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    # float32 statistics, or float64 for a float64 input
    return torch.promote_types(x.dtype, torch.float32)


def instance_norm_act_plain_fwd(x: torch.Tensor, act: str = "none",
                                negative_slope: float = 0.2, eps: float = EPS):
    """(N, C, D, H, W) -> (y of x's shape and dtype, mean, rstd (N, C) float32
    or, for float64 x, float64)."""
    dims, sd = (2, 3, 4), _stat_dtype(x)
    mean = x.mean(dim=dims, dtype=sd)
    xm = x - _bcast(mean).to(x.dtype)
    var = xm.square().mean(dim=dims, dtype=sd)
    rstd = torch.rsqrt(var + eps)
    y = _act(xm * _bcast(rstd).to(x.dtype), act, negative_slope).to(x.dtype)
    return y, mean, rstd


def instance_norm_act_plain(x: torch.Tensor, act: str = "none",
                            negative_slope: float = 0.2,
                            eps: float = EPS) -> torch.Tensor:
    """(N, C, D, H, W) -> same shape and dtype."""
    return instance_norm_act_plain_fwd(x, act, negative_slope, eps)[0]


def instance_norm_act_bwd_plain(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                                rstd: torch.Tensor, act: str = "none",
                                negative_slope: float = 0.2) -> torch.Tensor:
    """The input gradient of ``instance_norm_act_plain`` for the output
    gradient g, from the saved (mean, rstd), in g's dtype: JAX
    ``_in_vjp_bwd`` step by step (z recomputed in x's dtype, the two means
    in float32, the rest in g's dtype)."""
    dims, sd = (2, 3, 4), _stat_dtype(g)
    z = (x - _bcast(mean).to(x.dtype)) * _bcast(rstd).to(x.dtype)
    gp = g * act_grad(z, act, negative_slope).to(g.dtype)
    gmean = gp.mean(dim=dims, keepdim=True, dtype=sd)
    gzmean = (gp * z).mean(dim=dims, keepdim=True, dtype=sd)
    dx = _bcast(rstd).to(g.dtype) * (gp - gmean.to(g.dtype) - z * gzmean.to(g.dtype))
    return dx.to(g.dtype)


def segment_bounds(voxels: int, segments: int) -> list:
    """First voxel of each of ``segments`` segments, and ``voxels`` last (the
    kernels' seg_begin: segment s is [s * V // S, (s + 1) * V // S))."""
    return [s * voxels // segments for s in range(segments + 1)]


def _segment_sizes(voxels: int, segments: int, device) -> torch.Tensor:
    # built on the device: a host-to-device copy would stall timed queues
    ends = torch.arange(1, segments + 1, device=device) * voxels // segments
    return (ends - torch.arange(segments, device=device) * voxels // segments).float()


def _segment_of_voxel(voxels: int, segments: int, device) -> torch.Tensor:
    # voxel v lies in the last segment s with s * V // S <= v
    return ((torch.arange(voxels, device=device) + 1) * segments + voxels - 1) // voxels - 1


def stats_plain(x: torch.Tensor, segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centred (mean, M2) of each voxel segment, (N, S, C) float32; an empty
    segment gives zeros, as in the kernel."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, c, -1)
    voxels = xf.shape[-1]
    seg = _segment_of_voxel(voxels, segments, x.device)
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
    z = (x.float() - _bcast(mean)) * _bcast(rstd)
    return _act(z, act, negative_slope).to(x.dtype)


def _z_and_gp(x, g, mean, rstd, act, slope):
    # the kernels' float32 arithmetic: z and g' = g * act'(z)
    z = (x.float() - _bcast(mean)) * _bcast(rstd)
    return z, g.float() * act_grad(z, act, slope)


def bwd_stats_plain(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, segments: int, act: str = "none",
                    negative_slope: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sums of g' and g' z over each voxel segment, (N, S, C) float32; an
    empty segment gives zeros, as in the kernel."""
    n, c = x.shape[:2]
    z, gp = _z_and_gp(x, g, mean, rstd, act, negative_slope)
    gp, gpz = gp.reshape(n, c, -1), (gp * z).reshape(n, c, -1)
    seg = _segment_of_voxel(gp.shape[-1], segments, x.device)
    part_g = gp.new_zeros((n, c, segments)).index_add_(2, seg, gp)
    part_gz = gp.new_zeros((n, c, segments)).index_add_(2, seg, gpz)
    return part_g.transpose(1, 2).contiguous(), part_gz.transpose(1, 2).contiguous()


def bwd_finalize_plain(part_g: torch.Tensor, part_gz: torch.Tensor,
                       voxels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment sums (N, S, C) -> mean(g'), mean(g' z) (N, C)."""
    return part_g.sum(1) / voxels, part_gz.sum(1) / voxels


def bwd_apply_plain(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, gmean: torch.Tensor, gzmean: torch.Tensor,
                    act: str = "none", negative_slope: float = 0.2) -> torch.Tensor:
    """rstd * (g' - mean(g') - z mean(g' z)) in float32, rounded once to g's
    dtype."""
    z, gp = _z_and_gp(x, g, mean, rstd, act, negative_slope)
    return (_bcast(rstd) * (gp - _bcast(gmean) - z * _bcast(gzmean))).to(g.dtype)


# ---------------------------------------------------------------------------
# launch geometry (mirrors geometry<VEC>() in the .cu)


def vector_width(x: torch.Tensor) -> int:
    """Channels per thread: one 16-byte access where C and the pointer
    allow it, else one element."""
    vec = 16 // x.element_size()
    if x.shape[1] % vec or x.data_ptr() % 16:
        return 1
    return vec


def pair_width(x: torch.Tensor, g: torch.Tensor) -> int:
    """The vector width that holds for both pointers of a backward kernel."""
    return min(vector_width(x), vector_width(g))


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
    lib.mra_in_bwd_stats.argtypes = [p, p, p, p, p, p, i64, i64, i32, i32, i32, i32, i32,
                                     f32, p]
    lib.mra_in_bwd_finalize.argtypes = [p, p, p, p, i64, i64, i32, i32, p]
    lib.mra_in_bwd_apply.argtypes = [p, p, p, p, p, p, p, i64, i64, i32, i32, i32, i32, i32,
                                     f32, p]
    for fn in (lib.mra_in_stats, lib.mra_in_finalize, lib.mra_in_apply,
               lib.mra_in_bwd_stats, lib.mra_in_bwd_finalize, lib.mra_in_bwd_apply):
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


def _check_grad(g: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{what}: g must match x in shape, dtype and device, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device} against {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if not g.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"{what}: g must be contiguous in channels_last_3d "
                         f"(NDHWC in memory)")


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


def instance_norm_bwd_stats(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, segments: int, act: str = "none",
                            negative_slope: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, g (N, C, D, H, W) and the forward's mean, rstd (N, C) -> sums of
    g' and g' z over each of ``segments`` voxel segments, each (N, segments,
    C) float32."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return bwd_stats_plain(x, g, mean, rstd, segments, act, negative_slope)
    n, v, c = _check_volume(x, "instance_norm_bwd_stats")
    _check_grad(g, x, "instance_norm_bwd_stats")
    for t in (mean, rstd):
        _check_stats(t, (n, c), x.device, "instance_norm_bwd_stats")
    part_g = torch.empty((n, segments, c), device=x.device, dtype=torch.float32)
    part_gz = torch.empty_like(part_g)
    err = _lib().mra_in_bwd_stats(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                  part_g.data_ptr(), part_gz.data_ptr(), n, v, c, segments,
                                  _DTYPE_CODES[x.dtype], pair_width(x, g), ACTS[act],
                                  negative_slope, _stream(x))
    _raise_on(err, "instance_norm_bwd_stats")
    LAUNCHES["instance_norm_bwd_stats"] += 1
    return part_g, part_gz


def instance_norm_bwd_finalize(part_g: torch.Tensor, part_gz: torch.Tensor,
                               voxels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment sums (N, S, C) -> mean(g'), mean(g' z) (N, C) float32."""
    if part_g.device.type == "cpu":
        return bwd_finalize_plain(part_g, part_gz, voxels)
    _check_cuda(part_g, "instance_norm_bwd_finalize")
    if part_g.dim() != 3:
        raise ValueError("instance_norm_bwd_finalize: partials must be (N, S, C)")
    n, s, c = part_g.shape
    for t in (part_g, part_gz):
        _check_stats(t, (n, s, c), part_g.device, "instance_norm_bwd_finalize")
    gmean = torch.empty((n, c), device=part_g.device, dtype=torch.float32)
    gzmean = torch.empty_like(gmean)
    err = _lib().mra_in_bwd_finalize(part_g.data_ptr(), part_gz.data_ptr(), gmean.data_ptr(),
                                     gzmean.data_ptr(), n, voxels, c, s, _stream(part_g))
    _raise_on(err, "instance_norm_bwd_finalize")
    LAUNCHES["instance_norm_bwd_finalize"] += 1
    return gmean, gzmean


def instance_norm_bwd_apply(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, gmean: torch.Tensor, gzmean: torch.Tensor,
                            act: str = "none", negative_slope: float = 0.2) -> torch.Tensor:
    """dx = rstd * (g' - mean(g') - z mean(g' z)) in g's dtype and x's layout."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return bwd_apply_plain(x, g, mean, rstd, gmean, gzmean, act, negative_slope)
    n, v, c = _check_volume(x, "instance_norm_bwd_apply")
    _check_grad(g, x, "instance_norm_bwd_apply")
    for t in (mean, rstd, gmean, gzmean):
        _check_stats(t, (n, c), x.device, "instance_norm_bwd_apply")
    vec = pair_width(x, g)
    segments = num_segments(n, v, c, vec)
    dx = torch.empty_like(x, memory_format=torch.channels_last_3d)
    err = _lib().mra_in_bwd_apply(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                  gmean.data_ptr(), gzmean.data_ptr(), dx.data_ptr(), n, v, c,
                                  segments, _DTYPE_CODES[x.dtype], vec, ACTS[act],
                                  negative_slope, _stream(x))
    _raise_on(err, "instance_norm_bwd_apply")
    LAUNCHES["instance_norm_bwd_apply"] += 1
    return dx


def instance_norm_act_fwd(x: torch.Tensor, act: str = "none", negative_slope: float = 0.2,
                          eps: float = EPS):
    """The kernel path, stats -> finalize -> apply: three launches on CUDA,
    the three plain versions on the CPU. Returns (y, mean, rstd)."""
    n, c = x.shape[:2]
    voxels = math.prod(x.shape[2:])
    segments = num_segments(n, voxels, c, vector_width(x))
    part_mean, part_m2 = instance_norm_stats(x, segments)
    mean, rstd = instance_norm_finalize(part_mean, part_m2, voxels, eps)
    return instance_norm_apply(x, mean, rstd, act, negative_slope), mean, rstd


def instance_norm_act_fused(x: torch.Tensor, act: str = "none",
                            negative_slope: float = 0.2, eps: float = EPS) -> torch.Tensor:
    """``instance_norm_act_fwd`` without the statistics."""
    return instance_norm_act_fwd(x, act, negative_slope, eps)[0]


def instance_norm_act_bwd_fused(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                                rstd: torch.Tensor, act: str = "none",
                                negative_slope: float = 0.2) -> torch.Tensor:
    """The backward kernel path, bwd_stats -> bwd_finalize -> bwd_apply:
    three launches on CUDA, the three plain versions on the CPU. A CUDA g
    that is not channels_last_3d (autograd may hand one over, for example
    from a replication pad's backward) is copied into that layout first, and
    the copy counted in ``GRAD_RELAYOUTS``."""
    if g.is_cuda and not g.is_contiguous(memory_format=torch.channels_last_3d):
        g = g.contiguous(memory_format=torch.channels_last_3d)
        GRAD_RELAYOUTS["count"] += 1
    n, c = x.shape[:2]
    voxels = math.prod(x.shape[2:])
    segments = num_segments(n, voxels, c, pair_width(x, g))
    part_g, part_gz = instance_norm_bwd_stats(x, g, mean, rstd, segments, act, negative_slope)
    gmean, gzmean = instance_norm_bwd_finalize(part_g, part_gz, voxels)
    return instance_norm_bwd_apply(x, g, mean, rstd, gmean, gzmean, act, negative_slope)
