"""Fused affine-free InstanceNorm3d + activation, forward and backward: the
CUDA kernels' wrappers and their plain PyTorch versions.

Port of mra_gan_tpu/ops/pallas/instance_norm.py (``_fwd`` :108, ``_bwd``
:167, ``instance_norm_act_tpu`` :196); the kernels' design is described in
``csrc/instance_norm.cu``. Six kernels, one wrapper each:

- ``instance_norm_slab``      x -> act((x - mean) * rstd), mean, rstd in one
  launch, for an instance that fits in shared memory (``uses_slab``)
- ``instance_norm_stats``     x -> per-segment (mean, M2) partials (N, S, C)
- ``instance_norm_apply``     x, partials -> act((x - mean) * rstd), mean, rstd
- ``instance_norm_bwd_slab``  x, g, mean, rstd -> dx = rstd * (g' - mean(g') -
  z mean(g' z)) with g' = g * act'(z), in one launch where ``uses_slab`` holds
- ``instance_norm_bwd_stats`` x, g, mean, rstd -> per-segment sums of g' and
  g' z (N, S, C)
- ``instance_norm_bwd_apply`` x, g, mean, rstd, those sums -> dx

Under depth sharding (K ranks of a process group, each holding an equal
(N, C, D/K, H, W) shard) the two apply kernels merge the partials of all K
shards, all-gathered rank-major into one (K, 2, N, S, C) buffer, in their
prologue: ``instance_norm_apply_sharded`` and
``instance_norm_bwd_apply_sharded`` (the same kernels, launched with K).
``instance_norm_two_pass_sharded`` and ``instance_norm_bwd_two_pass_sharded``
are the routes, stats -> gather -> apply, whatever ``uses_slab`` says: a slab
kernel cannot see the other shards. Their segment count follows from the
shape alone, so every rank picks the same S, and keeps the K * S partials
an apply block merges within what one volume's merge reads.

Forward and backward each take one of two routes, picked by ``uses_slab``
from the shape and dtype alone, so a norm's two directions take the same
one: where one (n, 32-byte channel chunk) instance fits in SLAB_BYTES of
shared memory, one launch (``instance_norm_slab``, ``instance_norm_bwd_slab``);
else two, the second merging the first's partials in its prologue
(``instance_norm_two_pass``: stats then apply; ``instance_norm_bwd_two_pass``:
bwd stats then bwd apply).

A wrapper given a CPU tensor runs its plain version; given a CUDA tensor it
launches its kernel or raises (wrong dtype, shape or layout, failed build,
refused launch). Each launch adds one to ``LAUNCHES[<wrapper name>]``, and a launch
of an apply kernel with K > 1 shards also to ``SHARDED_LAUNCHES[<wrapper name>]``;
``instance_norm_act_bwd_fused`` adds one to ``GRAD_RELAYOUTS["count"]`` for
each gradient it had to copy into a fresh channels_last_3d tensor.

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
from typing import Optional, Tuple

import torch

from ...parallel.collectives import all_gather_stacked, group_size

EPS = 1e-5
ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256          # stats/apply block size, kThreads in the .cu
# Blocks the two-pass kernels aim at, at most: one wave on the H100's 132
# SMs. Each apply block merges all S partials of its channels, so fewer,
# longer segments were faster than several waves; and a grid a few blocks
# past a wave waits a whole block's time for those few (the bwd kernels' 77-78
# registers a thread leave room for three 256-thread blocks an SM, 396 in all).
_FWD_TARGET_BLOCKS = 132 * 4
_TARGET_BLOCKS = 132 * 3  # backward
_MIN_VOXELS_PER_LANE = 4
SLAB_BYTES = 224 * 1024  # kSlabBytes in the .cu: one instance's shared memory
SLAB_CHUNK = 32          # kSlabChunk in the .cu: bytes of channels per voxel in one instance

FORWARD = ("instance_norm_slab", "instance_norm_stats", "instance_norm_apply")
BACKWARD = ("instance_norm_bwd_slab", "instance_norm_bwd_stats", "instance_norm_bwd_apply")
LAUNCHES = {k: 0 for k in FORWARD + BACKWARD}
SHARDED_LAUNCHES = {"instance_norm_apply": 0, "instance_norm_bwd_apply": 0}
GRAD_RELAYOUTS = {"count": 0}


def reset_launches() -> None:
    """Zero every launch counter and the gradient relayout counter."""
    for counts in (LAUNCHES, SHARDED_LAUNCHES):
        for k in counts:
            counts[k] = 0
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


def _concat_shards(part: torch.Tensor) -> torch.Tensor:
    # (K, N, S, C) partials of K shards -> (N, K * S, C), shard-major
    k, n, s, c = part.shape
    return part.permute(1, 0, 2, 3).reshape(n, k * s, c)


def finalize_plain(part_mean: torch.Tensor, part_m2: torch.Tensor, voxels: int,
                   eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chan's parallel merge of the segment partials -> mean, rstd (N, C).
    The partials are (N, S, C) of one volume of ``voxels``, or (K, N, S, C)
    of K equal depth shards of ``voxels`` each, merged as their
    concatenation (N, K * S, C) over K * voxels: shard k's segment j is
    segment k * S + j of the whole, and has the same count."""
    if part_mean.dim() == 4:
        voxels *= part_mean.shape[0]
        part_mean, part_m2 = _concat_shards(part_mean), _concat_shards(part_m2)
    counts = _segment_sizes(voxels, part_mean.shape[1], part_mean.device).view(1, -1, 1)
    mean = (part_mean * counts).sum(1) / voxels
    m2 = part_m2.sum(1) + (counts * (part_mean - mean[:, None]).square()).sum(1)
    return mean, torch.rsqrt(m2 / voxels + eps)


def apply_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                act: str = "none", negative_slope: float = 0.2) -> torch.Tensor:
    z = (x.float() - _bcast(mean)) * _bcast(rstd)
    return _act(z, act, negative_slope).to(x.dtype)


def slab_plain(x: torch.Tensor, act: str = "none", negative_slope: float = 0.2,
               eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slab kernel's arithmetic: float32 mean, then the centred variance
    (exact two-pass), z and the activation in float32, rounded once to x's
    dtype. Returns (y, mean, rstd), the statistics (N, C) float32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3, 4))
    xm = xf - _bcast(mean)
    rstd = torch.rsqrt(xm.square().mean(dim=(2, 3, 4)) + eps)
    return _act(xm * _bcast(rstd), act, negative_slope).to(x.dtype), mean, rstd


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
    """Segment sums (N, S, C), or (K, N, S, C) of K equal shards of
    ``voxels`` each -> mean(g'), mean(g' z) (N, C) over all of them: the
    merge in the bwd apply kernel's prologue."""
    if part_g.dim() == 4:
        voxels *= part_g.shape[0]
        part_g, part_gz = _concat_shards(part_g), _concat_shards(part_gz)
    return part_g.sum(1) / voxels, part_gz.sum(1) / voxels


def bwd_apply_plain(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, gmean: torch.Tensor, gzmean: torch.Tensor,
                    act: str = "none", negative_slope: float = 0.2) -> torch.Tensor:
    """rstd * (g' - mean(g') - z mean(g' z)) in float32, rounded once to g's
    dtype."""
    z, gp = _z_and_gp(x, g, mean, rstd, act, negative_slope)
    return (_bcast(rstd) * (gp - _bcast(gmean) - z * _bcast(gzmean))).to(g.dtype)


def bwd_slab_plain(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, act: str = "none",
                   negative_slope: float = 0.2) -> torch.Tensor:
    """The bwd slab kernel's arithmetic: the float32 sums of g' and g' z over
    each whole instance divided by V, then dx in float32, rounded once to g's
    dtype (the two-pass plain versions at one segment)."""
    part_g, part_gz = bwd_stats_plain(x, g, mean, rstd, 1, act, negative_slope)
    gmean, gzmean = bwd_finalize_plain(part_g, part_gz, math.prod(x.shape[2:]))
    return bwd_apply_plain(x, g, mean, rstd, gmean, gzmean, act, negative_slope)


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


def uses_slab(shape, dtype: torch.dtype) -> bool:
    """The route, forward and backward: True where C is a whole number of
    SLAB_CHUNK-byte chunks and one (n, chunk) instance, V voxels of
    SLAB_CHUNK bytes, fits in SLAB_BYTES of shared memory (the 16^3, 8^3 and
    7^3 norms of the path); False sends the norm to the two-pass kernels."""
    return shape[1] * dtype.itemsize % SLAB_CHUNK == 0 and math.prod(shape[2:]) * SLAB_CHUNK <= SLAB_BYTES


def num_segments(n: int, voxels: int, c: int, vec: int,
                 target: int = _TARGET_BLOCKS) -> int:
    """Voxel segments per sample: at most ``target`` blocks in all (one
    segment where n * chunks passes it), and at least _MIN_VOXELS_PER_LANE
    voxels per thread lane."""
    groups = c // vec
    gx = min(groups, _THREADS)
    lanes = _THREADS // gx
    chunks = -(-groups // gx)
    want = max(1, target // (n * chunks))
    most = max(1, voxels // (lanes * _MIN_VOXELS_PER_LANE))
    return max(1, min(want, most))


def _shard_width(x: torch.Tensor, shards: int, width: int) -> int:
    # A depth shard's width from its shape alone, 16 bytes where C allows
    # it: every rank's shard has the same shape, so every rank picks the
    # same S whatever its pointers' alignment, and the gathered partials
    # line up. One volume keeps the width its pointers allow.
    if shards == 1:
        return width
    vec = 16 // x.element_size()
    return 1 if x.shape[1] % vec else vec


def forward_segments(x: torch.Tensor, shards: int = 1) -> int:
    """The two-pass forward's segment count for x, or for x one of
    ``shards`` equal depth shards of a volume: then the whole volume's
    count divided by the shards. Each apply block so merges the whole
    volume's S partials, not K times them, and where K divides that count
    the K shards' segments are the whole volume's, so the merged statistics
    are the unsharded norm's bit for bit."""
    n, c = x.shape[:2]
    voxels = math.prod(x.shape[2:]) * shards
    vec = _shard_width(x, shards, vector_width(x))
    return max(1, num_segments(n, voxels, c, vec, _FWD_TARGET_BLOCKS) // shards)


def backward_segments(x: torch.Tensor, g: torch.Tensor, shards: int = 1) -> int:
    """The two-pass backward's segment count for x and g: ``num_segments``,
    but at most sqrt(V * itemsize / (8 K)). Each bwd apply block reads all
    K * S partial sums of its channels (8 bytes a channel each) besides its
    own V / S voxels of x and g (2 * itemsize bytes a channel each); the
    bound keeps the first under half of the second. Without it the 64^3 and
    32^3 backwards at batch 1 and 2 took several times the segments and
    ran slower on the H100. For x one of K = ``shards`` equal depth shards
    the block target is not divided by K, unlike the forward's count: at
    the 2 x 128^3 shard a backward with half the blocks ran 22% slower."""
    n, c = x.shape[:2]
    voxels = math.prod(x.shape[2:])
    most = max(1, math.isqrt(voxels * x.element_size() // (8 * shards)))
    vec = _shard_width(x, shards, pair_width(x, g))
    return min(num_segments(n, voxels, c, vec), most)


# ---------------------------------------------------------------------------
# CUDA wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import build_library

    lib = ctypes.CDLL(str(build_library("instance_norm")))
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.mra_in_stats.argtypes = [p, p, p, i64, i64, i32, i32, i32, i32, p]
    lib.mra_in_apply.argtypes = [p, p, p, p, p, p, i64, i64, i32, i32, i32, i64, i32, i32,
                                 i32, f32, f32, p]
    lib.mra_in_slab.argtypes = [p, p, p, p, i64, i64, i32, i32, i32, f32, f32, p]
    lib.mra_in_bwd_stats.argtypes = [p, p, p, p, p, p, i64, i64, i32, i32, i32, i32, i32,
                                     f32, p]
    lib.mra_in_bwd_apply.argtypes = [p, p, p, p, p, p, p, i64, i64, i32, i32, i32, i64, i32,
                                     i32, i32, f32, p]
    lib.mra_in_bwd_slab.argtypes = [p, p, p, p, p, i64, i64, i32, i32, i32, f32, p]
    for fn in (lib.mra_in_stats, lib.mra_in_apply, lib.mra_in_slab,
               lib.mra_in_bwd_stats, lib.mra_in_bwd_apply, lib.mra_in_bwd_slab):
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


# the current stream's handle without a torch.cuda.Stream object, which costs
# more than a launch: the wrappers run hundreds of times a decoded volume
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def _partials_out(out: Optional[torch.Tensor], n: int, segments: int, c: int, device,
                  what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    # the two (N, S, C) halves of a (2, N, S, C) buffer, or two fresh tensors
    if out is None:
        return (torch.empty((n, segments, c), device=device, dtype=torch.float32),
                torch.empty((n, segments, c), device=device, dtype=torch.float32))
    _check_stats(out, (2, n, segments, c), device, what)
    return out[0], out[1]


def instance_norm_stats(x: torch.Tensor, segments: int, out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C, D, H, W) -> (mean, M2) of each of ``segments`` voxel segments,
    each (N, segments, C) float32; written into ``out[0]`` and ``out[1]``
    when given a (2, N, segments, C) float32 buffer (the sharded route
    gathers it in one collective)."""
    if x.device.type == "cpu":
        part_mean, part_m2 = stats_plain(x, segments)
        if out is None:
            return part_mean, part_m2
        out[0].copy_(part_mean)
        out[1].copy_(part_m2)
        return out[0], out[1]
    n, v, c = _check_volume(x, "instance_norm_stats")
    part_mean, part_m2 = _partials_out(out, n, segments, c, x.device, "instance_norm_stats")
    err = _lib().mra_in_stats(x.data_ptr(), part_mean.data_ptr(), part_m2.data_ptr(),
                              n, v, c, segments, _DTYPE_CODES[x.dtype],
                              vector_width(x), _stream(x))
    _raise_on(err, "instance_norm_stats")
    LAUNCHES["instance_norm_stats"] += 1
    return part_mean, part_m2


def instance_norm_apply(x: torch.Tensor, part_mean: torch.Tensor, part_m2: torch.Tensor,
                        act: str = "none", negative_slope: float = 0.2, eps: float = EPS
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge the stats kernel's (N, S, C) partials into mean and rstd (N, C)
    float32, and return (act((x - mean) * rstd) in x's dtype and layout,
    mean, rstd)."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        mean, rstd = finalize_plain(part_mean, part_m2, math.prod(x.shape[2:]), eps)
        return apply_plain(x, mean, rstd, act, negative_slope), mean, rstd
    n, v, c = _check_volume(x, "instance_norm_apply")
    if part_mean.dim() != 3 or part_mean.shape[0] != n or part_mean.shape[2] != c:
        raise ValueError(f"instance_norm_apply: partials must be ({n}, S, {c}), got "
                         f"{tuple(part_mean.shape)}")
    segments = part_mean.shape[1]
    for t in (part_mean, part_m2):
        _check_stats(t, (n, segments, c), x.device, "instance_norm_apply")
    return _launch_apply(x, part_mean.data_ptr(), part_m2.data_ptr(), segments, 1, 0, act,
                         negative_slope, eps)


def _launch_apply(x, mean_ptr: int, m2_ptr: int, segments: int, shards: int, kstride: int,
                  act: str, negative_slope: float, eps: float):
    n, v, c = x.shape[0], math.prod(x.shape[2:]), x.shape[1]
    mean = torch.empty((n, c), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    y = torch.empty_like(x, memory_format=torch.channels_last_3d)
    err = _lib().mra_in_apply(x.data_ptr(), mean_ptr, m2_ptr, mean.data_ptr(), rstd.data_ptr(),
                              y.data_ptr(), n, v, c, segments, shards, kstride,
                              _DTYPE_CODES[x.dtype], vector_width(x), ACTS[act], eps,
                              negative_slope, _stream(x))
    _raise_on(err, "instance_norm_apply")
    LAUNCHES["instance_norm_apply"] += 1
    if shards > 1:
        SHARDED_LAUNCHES["instance_norm_apply"] += 1
    return y, mean, rstd


def _check_gathered(partials: torch.Tensor, x: torch.Tensor, what: str) -> Tuple[int, int]:
    # (K, 2, N, S, C) float32, contiguous, on x's device -> (K, S)
    n, c = x.shape[:2]
    if partials.dim() != 5 or partials.shape[1] != 2 or partials.shape[2] != n \
            or partials.shape[4] != c:
        raise ValueError(f"{what}: gathered partials must be (K, 2, {n}, S, {c}), got "
                         f"{tuple(partials.shape)}")
    _check_stats(partials, tuple(partials.shape), x.device, what)
    return partials.shape[0], partials.shape[3]


def instance_norm_apply_sharded(x: torch.Tensor, partials: torch.Tensor, act: str = "none",
                                negative_slope: float = 0.2, eps: float = EPS
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``instance_norm_apply`` of one depth shard x with the statistics of
    all K shards: ``partials`` (K, 2, N, S, C) float32 holds each shard's
    stats-kernel (mean, M2) partials, rank-major, as the all-gather of the
    (2, N, S, C) buffers of ``instance_norm_stats(x, S, out=...)`` leaves
    them. One launch of the apply kernel with K; the plain merge on the
    CPU."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        mean, rstd = finalize_plain(partials[:, 0], partials[:, 1], math.prod(x.shape[2:]), eps)
        return apply_plain(x, mean, rstd, act, negative_slope), mean, rstd
    _check_volume(x, "instance_norm_apply_sharded")
    shards, segments = _check_gathered(partials, x, "instance_norm_apply_sharded")
    half = partials[0, 0].numel()
    return _launch_apply(x, partials.data_ptr(), partials.data_ptr() + 4 * half, segments,
                         shards, 2 * half, act, negative_slope, eps)


def instance_norm_slab(x: torch.Tensor, act: str = "none", negative_slope: float = 0.2,
                       eps: float = EPS
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The one-launch forward: (y in x's dtype and layout, mean, rstd (N, C)
    float32). On CUDA x must pass ``uses_slab`` and lie 16-byte aligned."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return slab_plain(x, act, negative_slope, eps)
    n, v, c = _check_volume(x, "instance_norm_slab")
    if not uses_slab(x.shape, x.dtype) or x.data_ptr() % 16:
        raise ValueError(f"instance_norm_slab: {x.dtype} {tuple(x.shape)} is no whole number "
                         f"of {SLAB_CHUNK}-byte channel chunks, does not fit {SLAB_BYTES} bytes "
                         f"of shared memory at {SLAB_CHUNK} bytes a voxel, or is not 16-byte "
                         f"aligned")
    mean = torch.empty((n, c), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    y = torch.empty_like(x, memory_format=torch.channels_last_3d)
    err = _lib().mra_in_slab(x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                             n, v, c, _DTYPE_CODES[x.dtype], ACTS[act], eps, negative_slope,
                             _stream(x))
    _raise_on(err, "instance_norm_slab")
    LAUNCHES["instance_norm_slab"] += 1
    return y, mean, rstd


def instance_norm_bwd_stats(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, segments: int, act: str = "none",
                            negative_slope: float = 0.2, out: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, g (N, C, D, H, W) and the forward's mean, rstd (N, C) -> sums of
    g' and g' z over each of ``segments`` voxel segments, each (N, segments,
    C) float32; written into ``out[0]`` and ``out[1]`` when given a (2, N,
    segments, C) float32 buffer."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        part_g, part_gz = bwd_stats_plain(x, g, mean, rstd, segments, act, negative_slope)
        if out is None:
            return part_g, part_gz
        out[0].copy_(part_g)
        out[1].copy_(part_gz)
        return out[0], out[1]
    n, v, c = _check_volume(x, "instance_norm_bwd_stats")
    _check_grad(g, x, "instance_norm_bwd_stats")
    for t in (mean, rstd):
        _check_stats(t, (n, c), x.device, "instance_norm_bwd_stats")
    part_g, part_gz = _partials_out(out, n, segments, c, x.device, "instance_norm_bwd_stats")
    err = _lib().mra_in_bwd_stats(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                  part_g.data_ptr(), part_gz.data_ptr(), n, v, c, segments,
                                  _DTYPE_CODES[x.dtype], pair_width(x, g), ACTS[act],
                                  negative_slope, _stream(x))
    _raise_on(err, "instance_norm_bwd_stats")
    LAUNCHES["instance_norm_bwd_stats"] += 1
    return part_g, part_gz


def instance_norm_bwd_apply(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, part_g: torch.Tensor, part_gz: torch.Tensor,
                            act: str = "none", negative_slope: float = 0.2) -> torch.Tensor:
    """Merge the bwd stats kernel's (N, S, C) sums into mean(g') and
    mean(g' z), and return dx = rstd * (g' - mean(g') - z mean(g' z)) in g's
    dtype and x's layout."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        gmean, gzmean = bwd_finalize_plain(part_g, part_gz, math.prod(x.shape[2:]))
        return bwd_apply_plain(x, g, mean, rstd, gmean, gzmean, act, negative_slope)
    n, v, c = _check_volume(x, "instance_norm_bwd_apply")
    _check_grad(g, x, "instance_norm_bwd_apply")
    for t in (mean, rstd):
        _check_stats(t, (n, c), x.device, "instance_norm_bwd_apply")
    if part_g.dim() != 3 or part_g.shape[0] != n or part_g.shape[2] != c:
        raise ValueError(f"instance_norm_bwd_apply: partials must be ({n}, S, {c}), got "
                         f"{tuple(part_g.shape)}")
    segments = part_g.shape[1]
    for t in (part_g, part_gz):
        _check_stats(t, (n, segments, c), x.device, "instance_norm_bwd_apply")
    return _launch_bwd_apply(x, g, mean, rstd, part_g.data_ptr(), part_gz.data_ptr(), segments,
                             1, 0, act, negative_slope)


def _launch_bwd_apply(x, g, mean, rstd, g_ptr: int, gz_ptr: int, segments: int, shards: int,
                      kstride: int, act: str, negative_slope: float) -> torch.Tensor:
    n, v, c = x.shape[0], math.prod(x.shape[2:]), x.shape[1]
    dx = torch.empty_like(x, memory_format=torch.channels_last_3d)
    err = _lib().mra_in_bwd_apply(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                  g_ptr, gz_ptr, dx.data_ptr(), n, v, c, segments, shards,
                                  kstride, _DTYPE_CODES[x.dtype], pair_width(x, g), ACTS[act],
                                  negative_slope, _stream(x))
    _raise_on(err, "instance_norm_bwd_apply")
    LAUNCHES["instance_norm_bwd_apply"] += 1
    if shards > 1:
        SHARDED_LAUNCHES["instance_norm_bwd_apply"] += 1
    return dx


def instance_norm_bwd_apply_sharded(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                                    rstd: torch.Tensor, partials: torch.Tensor,
                                    act: str = "none", negative_slope: float = 0.2
                                    ) -> torch.Tensor:
    """``instance_norm_bwd_apply`` of one depth shard with the sums of all K
    shards: ``partials`` (K, 2, N, S, C) float32 holds each shard's (g', g'
    z) sums, rank-major, as the all-gather of the buffers of
    ``instance_norm_bwd_stats(..., out=...)`` leaves them; the means are
    over K times the shard's voxels. One launch of the bwd apply kernel
    with K; the plain merge on the CPU."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        gmean, gzmean = bwd_finalize_plain(partials[:, 0], partials[:, 1],
                                           math.prod(x.shape[2:]))
        return bwd_apply_plain(x, g, mean, rstd, gmean, gzmean, act, negative_slope)
    n, v, c = _check_volume(x, "instance_norm_bwd_apply_sharded")
    _check_grad(g, x, "instance_norm_bwd_apply_sharded")
    for t in (mean, rstd):
        _check_stats(t, (n, c), x.device, "instance_norm_bwd_apply_sharded")
    shards, segments = _check_gathered(partials, x, "instance_norm_bwd_apply_sharded")
    half = partials[0, 0].numel()
    return _launch_bwd_apply(x, g, mean, rstd, partials.data_ptr(),
                             partials.data_ptr() + 4 * half, segments, shards, 2 * half, act,
                             negative_slope)


def instance_norm_bwd_slab(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                           rstd: torch.Tensor, act: str = "none",
                           negative_slope: float = 0.2) -> torch.Tensor:
    """The one-launch backward: dx in g's dtype and x's layout. On CUDA x
    must pass ``uses_slab``, and x and g lie 16-byte aligned."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return bwd_slab_plain(x, g, mean, rstd, act, negative_slope)
    n, v, c = _check_volume(x, "instance_norm_bwd_slab")
    _check_grad(g, x, "instance_norm_bwd_slab")
    for t in (mean, rstd):
        _check_stats(t, (n, c), x.device, "instance_norm_bwd_slab")
    if not uses_slab(x.shape, x.dtype) or x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError(f"instance_norm_bwd_slab: {x.dtype} {tuple(x.shape)} is no whole "
                         f"number of {SLAB_CHUNK}-byte channel chunks, does not fit "
                         f"{SLAB_BYTES} bytes of shared memory at {SLAB_CHUNK} bytes a voxel, "
                         f"or x or g is not 16-byte aligned")
    dx = torch.empty_like(x, memory_format=torch.channels_last_3d)
    err = _lib().mra_in_bwd_slab(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                 dx.data_ptr(), n, v, c, _DTYPE_CODES[x.dtype], ACTS[act],
                                 negative_slope, _stream(x))
    _raise_on(err, "instance_norm_bwd_slab")
    LAUNCHES["instance_norm_bwd_slab"] += 1
    return dx


def instance_norm_two_pass(x: torch.Tensor, act: str = "none", negative_slope: float = 0.2,
                           eps: float = EPS):
    """The two-launch forward, stats -> apply (with the merge): on CUDA two
    launches, on the CPU the plain versions. Returns (y, mean, rstd)."""
    part_mean, part_m2 = instance_norm_stats(x, forward_segments(x))
    return instance_norm_apply(x, part_mean, part_m2, act, negative_slope, eps)


def instance_norm_two_pass_sharded(x: torch.Tensor, group, act: str = "none",
                                   negative_slope: float = 0.2, eps: float = EPS):
    """The forward of one depth shard of a volume split over the ranks of
    ``group``, rank r holding depth rows [r D/K, (r + 1) D/K): stats into a
    (2, N, S, C) buffer, one all-gather of it over the group (rank-major),
    and the K-shard apply. On CUDA two launches, on the CPU the plain
    versions. Returns (y, mean, rstd), mean and rstd those of the whole
    volume, equal bit for bit on every rank."""
    n, c = x.shape[:2]
    segments = forward_segments(x, group_size(group))
    buf = torch.empty((2, n, segments, c), device=x.device, dtype=torch.float32)
    instance_norm_stats(x, segments, out=buf)
    return instance_norm_apply_sharded(x, all_gather_stacked(buf, group), act,
                                       negative_slope, eps)


def instance_norm_act_fwd(x: torch.Tensor, act: str = "none", negative_slope: float = 0.2,
                          eps: float = EPS):
    """The kernel path: one slab launch where ``uses_slab`` holds, else the
    two-pass kernels; each route's plain versions on the CPU. Returns (y,
    mean, rstd)."""
    route = instance_norm_slab if uses_slab(x.shape, x.dtype) else instance_norm_two_pass
    return route(x, act, negative_slope, eps)


def instance_norm_act_fused(x: torch.Tensor, act: str = "none",
                            negative_slope: float = 0.2, eps: float = EPS) -> torch.Tensor:
    """``instance_norm_act_fwd`` without the statistics."""
    return instance_norm_act_fwd(x, act, negative_slope, eps)[0]


def instance_norm_bwd_two_pass(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor, act: str = "none",
                               negative_slope: float = 0.2) -> torch.Tensor:
    """The two-launch backward, bwd stats -> bwd apply (with the merge): on
    CUDA two launches, on the CPU the plain versions. Returns dx."""
    part_g, part_gz = instance_norm_bwd_stats(x, g, mean, rstd, backward_segments(x, g), act,
                                              negative_slope)
    return instance_norm_bwd_apply(x, g, mean, rstd, part_g, part_gz, act, negative_slope)


def instance_norm_bwd_two_pass_sharded(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                                       rstd: torch.Tensor, group, act: str = "none",
                                       negative_slope: float = 0.2) -> torch.Tensor:
    """The backward of ``instance_norm_two_pass_sharded`` over the same
    group: bwd stats into a (2, N, S, C) buffer, one all-gather of it, the
    K-shard bwd apply. A CUDA g that is not channels_last_3d or not 16-byte
    aligned is copied first, as ``instance_norm_act_bwd_fused`` does, and
    counted. Returns dx."""
    g = _kernel_grad(g)
    n, c = x.shape[:2]
    segments = backward_segments(x, g, group_size(group))
    buf = torch.empty((2, n, segments, c), device=x.device, dtype=torch.float32)
    instance_norm_bwd_stats(x, g, mean, rstd, segments, act, negative_slope, out=buf)
    return instance_norm_bwd_apply_sharded(x, g, mean, rstd, all_gather_stacked(buf, group),
                                           act, negative_slope)


def _kernel_grad(g: torch.Tensor) -> torch.Tensor:
    # a CUDA gradient in the kernels' layout and alignment, a copy counted
    if g.is_cuda and (g.data_ptr() % 16
                      or not g.is_contiguous(memory_format=torch.channels_last_3d)):
        g = g.clone(memory_format=torch.channels_last_3d)
        GRAD_RELAYOUTS["count"] += 1
    return g


def instance_norm_act_bwd_fused(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                                rstd: torch.Tensor, act: str = "none",
                                negative_slope: float = 0.2) -> torch.Tensor:
    """The backward kernel path: one bwd slab launch where ``uses_slab``
    holds, else the two-pass backward kernels; each route's plain versions
    on the CPU. A CUDA g that is not channels_last_3d (autograd may hand one
    over, for example from a replication pad's backward) or not 16-byte
    aligned is copied into a fresh channels_last_3d tensor first, and the
    copy counted in ``GRAD_RELAYOUTS``."""
    g = _kernel_grad(g)
    route = instance_norm_bwd_slab if uses_slab(x.shape, x.dtype) else instance_norm_bwd_two_pass
    return route(x, g, mean, rstd, act, negative_slope)
