"""Stride-1, unpadded 7^3 convolution between a one-channel field and a
C-channel field: the CUDA kernels' wrappers and their plain PyTorch versions.

The resnet generator's stem (1 -> ngf) and head (ngf -> 1) 7^3 convs run
through these kernels in bfloat16 on CUDA, forward, input gradient and
weight gradient (``ops/conv.py`` routes them; the JAX package leaves them to
XLA, mra_gan_tpu/ops/conv.py:35). The kernels' design is described in
``csrc/conv7.cu``. One wrapper each:

- ``conv7_spread``  a (N, 1, D, H, W), w (C, 7, 7, 7) -> (N, C, D', H', W'):
  y[n, c, v] = bias[c] + sum_k a[n, v + k - pad] * w[c, k]
- ``conv7_gather``  x (N, C, D, H, W), w (C, 7, 7, 7) -> (N, 1, D', H', W'):
  y[n, v] = bias + sum_k sum_c x[n, c, v + k - pad] * w[c, k]
- ``conv7_wgrad_spread``  a (N, 1, D, H, W), g (N, C, D - 6, H - 6, W - 6)
  -> dw (C, 7, 7, 7): dw[c, k] = sum_n sum_v g[n, c, v] * a[n, v + k], the
  stem's weight gradient
- ``conv7_wgrad_gather``  x (N, C, D, H, W), g (N, 1, D - 6, H - 6, W - 6)
  -> dw (C, 7, 7, 7): dw[c, k] = sum_n sum_v x[n, c, v + k] * g[n, v], the
  head's weight gradient
- ``conv7_wgrad_reduce``  the second pass of both weight gradients: the
  first pass's partial sums (WGRAD_PARTS a block: (partials, 32 * groups,
  49, 8) float32) -> (C, 7, 7, 7), summed in order, flipped for the head,
  rounded once

with D' = D + 2 pad - 6 (H', W' alike) and input voxels outside the box read
as zero. pad 0 is a forward conv; pad 6 with w flipped on its three axes is
the input gradient of the other role's forward.

A wrapper given a CPU tensor runs its plain version (float32 ``F.conv3d``
or ``torch.nn.grad.conv3d_weight``, rounded once to the input's dtype, as
the kernel rounds); given a CUDA tensor it launches its kernel or raises (a
dtype other than bfloat16, a wrong shape or layout, a failed build, a
refused launch). Each launch adds one to ``LAUNCHES[<kernel name>]``: a
weight gradient counts its first pass under its own name and its second
under ``conv7_wgrad_reduce``. ``GRAD_RELAYOUTS["count"]`` counts the stem
gradients ``ops/conv.py`` copied into channels_last_3d.

The spread and the gather run a persistent grid over tiles of the output
box; the host side of that is pure functions here, so the CPU tests reach
it: ``spread_plan`` and ``gather_plan`` (the tiling and the grid, from the
blocks the card holds), ``tile_extent`` and ``block_tiles`` (which outputs,
and for the spread which channel group, a tile holds, and which tiles a
block walks), ``segments`` (a row cut into balanced segments),
``takes_tma`` (whether a C-channel field goes through a tensor map: every
stride a multiple of 16 bytes) and ``one_channel_granules`` (whether the
one-channel field is read in 4-byte granules). Both take any C: a spread
tile holds every channel where C <= 64 and one group of 32 above (its
chunk of channels), and a gather tile sums every channel.
``python -m mra_gan_tpu_torch.conv7_sweep`` times the gather's tilings on
the card against ``gather_plan``'s pick. The weight gradients' first pass
runs a fixed grid too: ``wgrad_plan`` (its tiles, a grid a channel group),
``wgrad_walk`` (the tiles a block of a group walks) and ``wgrad_smem``
(what a tile and its halo take of shared memory).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

TAPS = (7, 7, 7)
LAUNCHES = {"conv7_spread": 0, "conv7_gather": 0, "conv7_wgrad_spread": 0,
            "conv7_wgrad_gather": 0, "conv7_wgrad_reduce": 0}
# the stem's output gradients that ops/conv.py had to copy into
# channels_last_3d before its input- and weight-gradient kernels
GRAD_RELAYOUTS = {"count": 0}
# a weight gradient's partial sums: per channel, (kz, ky) rows x kx (the 8th
# column is the wgmma tile's dead kx = 7 row), in groups of 32 channels
WGRAD_ROWS, WGRAD_COLS, GROUP = 49, 8, 32


# csrc/conv7.cu's tiles. The spread: an output tile of (z, y, x) voxels of
# every channel where C <= SPREAD_HELD (the weights it holds at once), else
# of one group of 32, stored a group at a time by a TMA box over the NDHWC
# output (C, W, H, D, N).
SPREAD_TILE = (4, 4, 16)
SPREAD_HELD = 2 * GROUP
SPREAD_STORE_BOX = (GROUP, SPREAD_TILE[2], SPREAD_TILE[1], SPREAD_TILE[0], 1)
# The gather: a row segment of at most 74 outputs and its 6-voxel halo in
# the 80 input slots of one TMA box over the NDHWC input (C, W, H, D * N);
# a tile holds one of the depths in output planes and the rows of the box
# cut into one of the splits
GATHER_SLOTS = 80
GATHER_MAX_SEGMENT = GATHER_SLOTS - 6
GATHER_LOAD_BOX = (GROUP, GATHER_SLOTS, 1, 1)
GATHER_DEPTHS = (16, 8, 4)  # multiples of the four consumer warpgroups
GATHER_ROW_SPLITS = (1, 2, 3, 4)
# an input-row load against an item of 14 wgmma in the gather's cost model,
# fitted to conv7_sweep's timings of every depth and split on an H100 80GB
# HBM3 (PERF.md)
GATHER_LOAD_COST = 0.6
# The weight gradients' first pass: tiles of WGRAD_TILE_DEPTH planes x
# WGRAD_TILE_ROWS rows x a row segment (even, at most WGRAD_MAX_SEGMENT
# voxels) of the C-channel field's box, a group of 32 channels each, in a
# ring of WGRAD_STAGES stages beside the one-channel halo as pair words; each
# block writes WGRAD_PARTS partial sums (one per consumer warpgroup).
WGRAD_TILE_DEPTH, WGRAD_TILE_ROWS = 8, 2
WGRAD_MAX_SEGMENT = 72
WGRAD_PARTS = 2
WGRAD_STAGES = 2
SMEM_LIMIT = 232448  # a block's shared memory on sm_90


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    GRAD_RELAYOUTS["count"] = 0


def out_shape(spatial, pad: int) -> tuple:
    """The output box of an input box: each axis grown by 2 pad - 6."""
    return tuple(s + 2 * pad - 6 for s in spatial)


# ---------------------------------------------------------------------------
# the persistent grids' geometry (host side, pure)


@dataclass(frozen=True)
class Plan:
    """A persistent grid over an (n, D, H, W) output box of ``chunks``
    chunks of channels: tiles of ``tile`` = (z, y, x) outputs (the last
    along each axis cut by the box), ``counts`` = (nz, ny, nx) of them a
    sample, numbered x fastest, then y, z, the sample and the chunk; block b
    walks tiles b, b + grid, ... in order."""
    n: int
    box: Tuple[int, int, int]
    tile: Tuple[int, int, int]
    counts: Tuple[int, int, int]
    grid: int
    chunks: int = 1

    @property
    def tiles(self) -> int:
        return self.chunks * self.n * math.prod(self.counts)


def segments(width: int, longest: int) -> Tuple[int, int]:
    """The fewest balanced segments of at most ``longest`` covering
    ``width``: (count, length), the last one cut by the width."""
    count = -(-width // longest)
    return count, -(-width // count)


def _plan(n: int, box, tile, resident: int, chunks: int = 1) -> Plan:
    counts = tuple(-(-b // t) for b, t in zip(box, tile))
    tiles = chunks * n * math.prod(counts)
    return Plan(n, tuple(box), tuple(tile), counts, max(1, min(tiles, resident)), chunks)


def spread_plan(n: int, out_box, resident: int, c: int = GROUP) -> Plan:
    """The spread's grid for c channels: SPREAD_TILE tiles of each chunk of
    channels (one chunk where C <= SPREAD_HELD, else a group of 32 each; a
    block loads a chunk's weights where its walk enters it), as many blocks
    as the card holds (``resident``) or as there are tiles."""
    chunks = 1 if c <= SPREAD_HELD else -(-c // GROUP)
    return _plan(n, out_box, SPREAD_TILE, resident, chunks)


def _overlap(lo: int, hi: int, size: int) -> int:
    return max(0, min(hi, size) - max(lo, 0))


@functools.lru_cache(maxsize=None)
def gather_plan(n: int, out_box: Tuple[int, int, int], resident: int, pad: int = 0,
                load_cost: float = GATHER_LOAD_COST) -> Plan:
    """The gather's grid. A tile multiplies each of its live input rows
    (those inside the box, of its Rt + 6) once for each of its Zt output
    planes and loads it once for each of its Zt + 6 input planes inside the
    box (one outside is zeros, written in shared memory); more tiles than
    resident blocks run in waves. The depth (GATHER_DEPTHS) and row split
    (GATHER_ROW_SPLITS) whose busiest tile, times the waves, costs least in
    multiplies + load_cost x loads win, the deeper tile on a tie. Cached:
    the search runs once a shape, not on every launch."""
    d, h, w = out_box
    in_d, in_h = d + 6 - 2 * pad, h + 6 - 2 * pad
    _, xt = segments(w, GATHER_MAX_SEGMENT)
    best = None
    for zt in GATHER_DEPTHS:
        for split in GATHER_ROW_SPLITS:
            plan = _plan(n, out_box, (min(zt, d), -(-h // split), xt), resident)
            tz, ty, _ = plan.tile
            busiest = 0.0
            for z0 in range(0, d, tz):
                zn = min(tz, d - z0)
                planes = _overlap(z0 - pad, z0 + zn + 6 - pad, in_d)
                for y0 in range(0, h, ty):
                    rows = _overlap(y0 - pad, y0 + min(ty, h - y0) + 6 - pad, in_h)
                    busiest = max(busiest, rows * (zn + load_cost * planes))
            key = (-(-plan.tiles // plan.grid) * busiest, -tz)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def _cdiv16(v: int) -> int:
    return -(-v // 16) * 16


def wgrad_smem(segment: int) -> int:
    """Shared memory a weight-gradient block needs for row segments of
    ``segment`` voxels (csrc/conv7.cu sizes it once, for WGRAD_MAX_SEGMENT):
    1 KB of alignment, per stage the field tile (planes of whole k-steps of
    16 voxels, 64 bytes a voxel) and the halo's pair words (4 bytes, the
    tile's planes and rows each grown by 6, the segment by 8), the k-step
    table (a word a voxel pair) and the ring's mbarriers."""
    slots = _cdiv16(WGRAD_TILE_ROWS * segment)
    field = WGRAD_TILE_DEPTH * slots * 2 * GROUP
    halo = (WGRAD_TILE_DEPTH + 6) * (WGRAD_TILE_ROWS + 6) * (segment + 8) * 4
    return 1024 + WGRAD_STAGES * (field + halo) + slots // 2 * 4 + 2 * WGRAD_STAGES * 8


@functools.lru_cache(maxsize=None)
def wgrad_plan(n: int, box: Tuple[int, int, int], resident: int, c: int = GROUP) -> Plan:
    """A weight gradient's first pass over the C-channel field's (n, D, H,
    W) box: tiles of WGRAD_TILE_DEPTH planes x WGRAD_TILE_ROWS rows x the
    row cut into the fewest balanced segments of at most WGRAD_MAX_SEGMENT
    voxels (rounded up to even: a voxel pair never straddles two rows);
    ``chunks`` the groups of 32 channels, a grid of ``grid`` blocks for each
    (as many as the card holds for all of them, or as there are tiles of
    one). Cached: fixed by the box, C and the card, so every sum keeps its
    order from run to run."""
    _, xt = segments(box[2], WGRAD_MAX_SEGMENT)
    tile = (WGRAD_TILE_DEPTH, WGRAD_TILE_ROWS, xt + xt % 2)
    groups = -(-c // GROUP)
    counts = tuple(-(-b // t) for b, t in zip(box, tile))
    per_group = n * math.prod(counts)
    return Plan(n, tuple(box), tile, counts, max(1, min(per_group, resident // groups)), groups)


def wgrad_walk(plan: Plan, block: int, group: int) -> Iterator[int]:
    """The tiles (numbered as ``tile_extent`` reads them) that block
    ``block`` of channel group ``group`` walks, in order."""
    per_group = plan.tiles // plan.chunks
    return iter(range(group * per_group + block, (group + 1) * per_group, plan.grid))


def tile_extent(plan: Plan, t: int):
    """Tile t's chunk of channels, its sample and its output ranges [lo,
    hi) on z, y and x."""
    nz, ny, nx = plan.counts
    xi, t = t % nx, t // nx
    yi, t = t % ny, t // ny
    zi, t = t % nz, t // nz
    chunk, n = divmod(t, plan.n)
    ranges = tuple((i * s, min((i + 1) * s, b))
                   for i, s, b in zip((zi, yi, xi), plan.tile, plan.box))
    return (chunk, n) + ranges


def block_tiles(plan: Plan, block: int) -> Iterator[int]:
    """The tiles block ``block`` walks, in order."""
    return iter(range(block, plan.tiles, plan.grid))


def takes_tma(t: torch.Tensor) -> bool:
    """Whether a C-channel NDHWC field (an (N, C, D, H, W) tensor contiguous
    in channels_last_3d) goes through a tensor map: TMA needs its base and
    every stride past the channels' (W, H, D, N) to be multiples of 16
    bytes, which holds where C % 8 == 0."""
    if t.dim() != 5 or not t.is_contiguous(memory_format=torch.channels_last_3d):
        return False
    size = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(1) == 1
            and all(t.stride(i) * size % 16 == 0 for i in (0, 2, 3, 4)))


def one_channel_granules(width: int, ptr: int) -> bool:
    """Whether the spread and the weight gradients read their one-channel
    (N, D, H, W) field in 4-byte granules: every row starts on 4 bytes (W
    even, the base so) and a tile's halo starts on an even x, so a granule
    lies inside the box or outside it whole. Otherwise their threads load it
    voxel by voxel."""
    return width % 2 == 0 and ptr % 4 == 0


# ---------------------------------------------------------------------------
# plain versions


def conv7_spread_plain(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                       pad: int = 0) -> torch.Tensor:
    """float32 F.conv3d of the one-channel field, rounded once to a's dtype."""
    b = None if bias is None else bias.float()
    y = F.conv3d(a.float(), w.float().reshape(-1, 1, *TAPS), b, 1, pad)
    return y.to(a.dtype)


def conv7_gather_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                       pad: int = 0) -> torch.Tensor:
    """float32 F.conv3d onto one channel, rounded once to x's dtype."""
    b = None if bias is None else bias.float()
    y = F.conv3d(x.float(), w.float().reshape(1, -1, *TAPS), b, 1, pad)
    return y.to(x.dtype)


def conv7_wgrad_spread_plain(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """float32 conv3d_weight of the stem, (C, 7, 7, 7), rounded once to a's dtype."""
    c = g.shape[1]
    dw = torch.nn.grad.conv3d_weight(a.float(), (c, 1, *TAPS), g.float())
    return dw[:, 0].to(a.dtype)


def conv7_wgrad_gather_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """float32 conv3d_weight of the head, (C, 7, 7, 7), rounded once to x's dtype."""
    c = x.shape[1]
    dw = torch.nn.grad.conv3d_weight(x.float(), (1, c, *TAPS), g.float())
    return dw[0].to(x.dtype)


def conv7_wgrad_reduce_plain(partial: torch.Tensor, c: int, flip: bool) -> torch.Tensor:
    """The partials summed in float32, cut to (C, 7, 7, 7),
    flipped on the three axes for the head, rounded once to bfloat16."""
    dw = partial.float().sum(0)[:c, :, :7].reshape(c, *TAPS)
    return (dw.flip(1, 2, 3) if flip else dw).bfloat16()


# ---------------------------------------------------------------------------
# CUDA wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import build_library

    lib = ctypes.CDLL(str(build_library("conv7")))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mra_conv7_spread.argtypes = [p, p, p, p] + [i32] * 12 + [p]
    lib.mra_conv7_gather.argtypes = [p, p, p, p] + [i32] * 14 + [p]
    lib.mra_conv7_resident.argtypes = [i32, i32]
    for fn in (lib.mra_conv7_spread, lib.mra_conv7_gather, lib.mra_conv7_resident):
        fn.restype = ctypes.c_int
    lib.mra_conv7_wgrad.argtypes = [i32, p, p, p] + [i32] * 12 + [p]
    lib.mra_conv7_wgrad_reduce.argtypes = [p, p, i32, i32, i32, p]
    for fn in (lib.mra_conv7_wgrad, lib.mra_conv7_wgrad_reduce):
        fn.restype = ctypes.c_int
    lib.mra_conv7_error_string.argtypes = [ctypes.c_int]
    lib.mra_conv7_error_string.restype = ctypes.c_char_p
    return lib


def _check_device(t: torch.Tensor, what: str) -> None:
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{what}: tensor on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _check(t: torch.Tensor, dev: torch.device, what: str, name: str) -> None:
    if t.device != dev:
        raise ValueError(f"{what}: {name} on {t.device}, the input on {dev}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes bfloat16")


def _check_args(field: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], pad: int,
                c: int, bias_len: int, what: str) -> None:
    dev = field.device
    _check_device(field, what)
    _check(field, dev, what, "the input")
    _check(w, dev, what, "the weight")
    if tuple(w.shape) != (c, *TAPS) or not w.is_contiguous():
        raise ValueError(f"{what}: weight must be a contiguous ({c}, 7, 7, 7) tensor, got "
                         f"{tuple(w.shape)}")
    if bias is not None:
        _check(bias, dev, what, "the bias")
        if tuple(bias.shape) != (bias_len,) or not bias.is_contiguous():
            raise ValueError(f"{what}: bias must be a contiguous ({bias_len},) tensor")
    if pad not in (0, 6):
        raise ValueError(f"{what}: pad must be 0 (forward) or 6 (input gradient), got {pad}")
    if min(out_shape(field.shape[2:], pad)) < 1:
        raise ValueError(f"{what}: input box {tuple(field.shape[2:])} is smaller than 7^3")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().mra_conv7_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# the current stream's handle without a torch.cuda.Stream object, which costs
# more than a launch: the wrappers run hundreds of times a decoded volume
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _resident(kind: int, c: int, device: int) -> int:
    """Blocks of the spread (kind 0), the gather (1) or a weight gradient's
    first pass (2) the card holds at once for c channels, asked once."""
    blocks = _lib().mra_conv7_resident(kind, c)
    if blocks <= 0:
        _raise_on(-blocks, "conv7_resident")
    return blocks


def conv7_spread(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 pad: int = 0) -> torch.Tensor:
    """(N, 1, D, H, W) -> (N, C, D', H', W'), channels_last_3d on CUDA. On
    CUDA every tensor is bfloat16: a contiguous, w (C, 7, 7, 7) contiguous,
    bias (C,) or None."""
    if a.device.type == "cpu":
        return conv7_spread_plain(a, w, bias, pad)
    what = "conv7_spread"
    if a.dim() != 5 or a.shape[1] != 1 or not a.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (N, 1, D, H, W) input, got "
                         f"{tuple(a.shape)}")
    c = w.shape[0]
    _check_args(a, w, bias, pad, c, c, what)
    n, _, d, h, wd = a.shape
    box = out_shape((d, h, wd), pad)
    y = torch.empty((n, c, *box), device=a.device, dtype=a.dtype,
                    memory_format=torch.channels_last_3d)
    plan = spread_plan(n, box, _resident(0, c, a.device.index), c)
    err = _lib().mra_conv7_spread(a.data_ptr(), w.data_ptr(), _ptr(bias), y.data_ptr(), n, d, h,
                                  wd, c, pad, int(takes_tma(y)),
                                  int(one_channel_granules(wd, a.data_ptr())), plan.grid,
                                  *plan.counts, _stream(a))
    _raise_on(err, what)
    LAUNCHES["conv7_spread"] += 1
    return y


def conv7_gather(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 pad: int = 0) -> torch.Tensor:
    """(N, C, D, H, W) -> (N, 1, D', H', W'). On CUDA every tensor is
    bfloat16: x contiguous in channels_last_3d, w (C, 7, 7, 7) contiguous,
    bias (1,) or None."""
    if x.device.type == "cpu":
        return conv7_gather_plain(x, w, bias, pad)
    what = "conv7_gather"
    if x.dim() != 5 or not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"{what}: expected an (N, C, D, H, W) input contiguous in "
                         f"channels_last_3d, got {tuple(x.shape)}")
    n, c, d, h, wd = x.shape
    _check_args(x, w, bias, pad, c, 1, what)
    box = out_shape((d, h, wd), pad)
    return gather_launch(x, w, bias, pad, gather_plan(n, box, gather_resident(x), pad))


def gather_resident(x: torch.Tensor) -> int:
    """Blocks of the gather the card holds at once for x's channels."""
    return _resident(1, x.shape[1], x.device.index)


def gather_launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], pad: int,
                  plan: Plan) -> torch.Tensor:
    """conv7_gather's launch on a given plan, its tensors checked by the
    caller (conv7_sweep times other plans through it)."""
    n, c, d, h, wd = x.shape
    y = torch.empty((n, 1, *plan.box), device=x.device, dtype=x.dtype)
    err = _lib().mra_conv7_gather(x.data_ptr(), w.data_ptr(), _ptr(bias), y.data_ptr(), n, d, h,
                                  wd, c, pad, int(takes_tma(x)), plan.grid, *plan.tile,
                                  *plan.counts, _stream(x))
    _raise_on(err, "conv7_gather")
    LAUNCHES["conv7_gather"] += 1
    return y


def check_wgrad_tensors(field: torch.Tensor, one: torch.Tensor, grow: int, what: str) -> None:
    """What a weight-gradient kernel takes: field (N, C, D, H, W) contiguous
    in channels_last_3d and one (N, 1, D + grow, H + grow, W + grow)
    contiguous, both bfloat16 on field's device; raises otherwise."""
    _check(field, field.device, what, "the C-channel field")
    _check(one, field.device, what, "the one-channel field")
    if field.dim() != 5 or not field.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"{what}: expected an (N, C, D, H, W) field contiguous in "
                         f"channels_last_3d, got {tuple(field.shape)}")
    n, _, *box = field.shape
    want = (n, 1, *(s + grow for s in box))
    if tuple(one.shape) != want or not one.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {want} one-channel field, got "
                         f"{tuple(one.shape)}")
    if min(box + list(want[2:])) < 1:
        raise ValueError(f"{what}: input box smaller than 7^3")


def conv7_wgrad_partials(what: str, field: torch.Tensor, one: torch.Tensor) -> torch.Tensor:
    """The first pass of a weight gradient (``what``: "conv7_wgrad_spread"
    with field = g and one = a, or "conv7_wgrad_gather" with field = x and
    one = g): the partial sums (WGRAD_PARTS * blocks, 32 * groups, 49, 8)
    float32 of ``wgrad_plan``'s grid, fixed by the box, C and the card."""
    head = int(what == "conv7_wgrad_gather")
    _check_device(field, what)
    check_wgrad_tensors(field, one, -6 if head else 6, what)
    n, c, d, h, wd = field.shape
    plan = wgrad_plan(n, (d, h, wd), _resident(2, c, field.device.index), c)
    partial = torch.empty((WGRAD_PARTS * plan.grid, plan.chunks * GROUP, WGRAD_ROWS, WGRAD_COLS),
                          device=field.device, dtype=torch.float32)
    err = _lib().mra_conv7_wgrad(head, field.data_ptr(), one.data_ptr(), partial.data_ptr(),
                                 plan.grid, n, d, h, wd, c, int(takes_tma(field)),
                                 int(one_channel_granules(one.shape[-1], one.data_ptr())),
                                 plan.tile[2], *plan.counts, _stream(field))
    _raise_on(err, what)
    LAUNCHES[what] += 1
    return partial


def conv7_wgrad_spread(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The stem's weight gradient (C, 7, 7, 7) from its input a (N, 1, D, H,
    W) and output gradient g (N, C, D - 6, H - 6, W - 6). On CUDA both are
    bfloat16: a contiguous, g contiguous in channels_last_3d."""
    if a.device.type == "cpu":
        return conv7_wgrad_spread_plain(a, g)
    return conv7_wgrad_reduce(conv7_wgrad_partials("conv7_wgrad_spread", g, a), g.shape[1], False)


def conv7_wgrad_gather(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The head's weight gradient (C, 7, 7, 7) from its input x (N, C, D, H,
    W) and output gradient g (N, 1, D - 6, H - 6, W - 6). On CUDA both are
    bfloat16: x contiguous in channels_last_3d, g contiguous."""
    if x.device.type == "cpu":
        return conv7_wgrad_gather_plain(x, g)
    return conv7_wgrad_reduce(conv7_wgrad_partials("conv7_wgrad_gather", x, g), x.shape[1], True)


def conv7_wgrad_reduce(partial: torch.Tensor, c: int, flip: bool) -> torch.Tensor:
    """(C, 7, 7, 7) bfloat16 from a weight gradient's partial sums
    (partials, 32 * groups, 49, 8) float32, contiguous."""
    if partial.device.type == "cpu":
        return conv7_wgrad_reduce_plain(partial, c, flip)
    what = "conv7_wgrad_reduce"
    _check_device(partial, what)
    if partial.dtype != torch.float32 or not partial.is_contiguous() or partial.dim() != 4 \
            or tuple(partial.shape[1:]) != (-(-c // GROUP) * GROUP, WGRAD_ROWS, WGRAD_COLS):
        raise ValueError(f"{what}: expected contiguous float32 partials (partials, "
                         f"{-(-c // GROUP) * GROUP}, {WGRAD_ROWS}, {WGRAD_COLS}), got "
                         f"{partial.dtype} {tuple(partial.shape)}")
    dw = torch.empty((c, *TAPS), device=partial.device, dtype=torch.bfloat16)
    err = _lib().mra_conv7_wgrad_reduce(partial.data_ptr(), dw.data_ptr(), partial.shape[0], c,
                                        int(flip), _stream(partial))
    _raise_on(err, what)
    LAUNCHES[what] += 1
    return dw
