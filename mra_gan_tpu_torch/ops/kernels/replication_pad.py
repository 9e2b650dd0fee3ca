"""Replication (edge) padding of (N, C, D, H, W) volumes: the CUDA kernels'
wrappers, their host-side tile plan and their plain PyTorch versions.

The resnet generator's 14 pads a forward (``ops/conv.py``
``replication_pad3d``) run through these kernels on CUDA, forward and
backward; the JAX package leaves them to XLA's edge pad
(mra_gan_tpu/ops/conv.py:131-150). Pads are per axis, low and high, in the
order (pd0, pd1, ph0, ph1, pw0, pw1) (D first; F.pad's order is the
reverse):

- ``replication_pad_fwd``  x (N, C, D, H, W) -> y (N, C, D + pd0 + pd1,
  H + ph0 + ph1, W + pw0 + pw1): y[o] = x[clamp(o - p_lo, 0, n - 1)] on
  each axis
- ``replication_pad_bwd``  g of y's shape -> dx of x's: each input voxel
  the sum of the output gradients that clamp to it (``fold_range`` per
  axis), folded W first, then H, then D, each fold left to right in
  float32 (float64 for a float64 g), rounded once to g's dtype

Both kernels move bytes and compute next to nothing, so what bounds them is
the card's memory rate: |x| + |y| bytes each way. ``launch_plan`` picks
one of four kernels from the shape (``csrc/replication_pad.cu`` has the
details):

- the forward, where a voxel's channels fill whole 16-byte units and the
  source is aligned (``vector_width`` > 1: the head, the trunk): a block an
  output row, a 16-byte unit a thread (``launch_geometry``);
- the forward elsewhere (C = 1 at the stem, C = 6, an unaligned source):
  each thread one 16-byte chunk of an output plane, cut on absolute 16-byte
  boundaries, each element read by its clamped index, so a narrow voxel
  still moves 16 bytes a store;
- the backward on the unit path: the ring. A tile is a piece of the input
  box, (n, d, rows h0..h1, columns w0..w1), whole rows or a piece of one
  row; the gradient rows that fold into it, at every depth, are staged in
  shared memory by the bulk-copy engine (``cp.async.bulk`` into a ring of
  stages under mbarriers), so the next tiles' loads are in flight while a
  tile is summed and no register holds a load; rows whose folds are one
  term are stored from the stage by the bulk-copy engine too.
  ``tile_plan`` (once a shape, cached) sizes the tiles by bytes, not rows:
  each (depth class, row class) pair, the first, the middle and the last
  planes and rows of the box, gets rows per tile or pieces per row such
  that a tile moves about ``tau`` bytes, so face and corner rows are split
  across tiles. The grid is persistent (``BLOCKS_PER_SM`` a multiprocessor)
  and block b walks tiles b, b + grid, ... (``block_tiles``);
- every other backward (a voxel narrower than a unit or an unaligned
  gradient, as at the stem; a voxel so wide that a corner's fold does not
  fit half the ring): a block an input row, each thread folding its voxel's
  terms straight from g.

A wrapper given a CPU tensor runs its plain version, whose arithmetic the
kernel repeats bit for bit (a meta tensor too, which gives the shapes
alone, as FlopCounterMode's pass over a train step needs); given a CUDA
tensor (bfloat16, float32 or float64) it launches its kernel or raises. A
CUDA tensor that is not contiguous in channels_last_3d is copied into that
layout first, and the copy counted in ``RELAYOUTS["count"]``. Each launch
adds one to ``LAUNCHES[<kernel name>]``, whichever of its kernels it runs.
The host side of a launch is pure functions here, so the CPU tests reach
it: ``vector_width``, ``launch_geometry``, ``tile_plan``, ``tile_at`` (the
ring kernel's decode of a tile index), ``tile_table`` and ``tile_costs``
(every tile at once), ``block_tiles``, ``fast_divisor`` and ``launch_plan``
(the route, the checks and the parameters of a launch)."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

LAUNCHES = {"replication_pad_fwd": 0, "replication_pad_bwd": 0}
# CUDA inputs or gradients the wrappers copied into channels_last_3d
RELAYOUTS = {"count": 0}
# csrc/replication_pad.cu's kVecBytes (a unit, a chunk), kMaxThreads (a row
# kernel's block at most), kChunkThreads and kRingThreads (those kernels'
# blocks) and kMaxStages (the ring's largest depth)
VEC_BYTES = 16
MAX_THREADS = 1024
CHUNK_THREADS = 128
RING_THREADS = 256
MAX_STAGES = 8
# the kernel a launch runs (csrc/replication_pad.cu's enum Route)
ROUTES = {"rows": 0, "chunks": 1, "ring": 2}
# the ring's plan: blocks a multiprocessor runs at once, the shared memory
# each may take for its ring (two blocks share an H100 SM's 228 KiB), the
# stage a tile is sized to fit (a quarter of the ring, so it is four deep;
# a tile that cannot be cut to fit makes a larger stage, and a shape whose
# stage exceeds half the ring takes the row kernel), the bytes a tile moves
# (at most TAU_MAX, at least TAU_MIN, else the total over TILES_PER_BLOCK
# tiles a block) and the card's multiprocessors where none is given
BLOCKS_PER_SM = 2
RING_BYTES = 110 * 1024
STAGE_MAX = RING_BYTES // 4
TAU_MAX = 64 * 1024
TAU_MIN = 2 * 1024
TILES_PER_BLOCK = 2
SMS = 132
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
    """Elements a 16-byte unit of a voxel holds where a voxel's C channels
    fill whole 16-byte units and the source is 16-byte aligned (the unit
    path: the row kernels and the ring move units), else one (the forward
    then gathers each element of a 16-byte chunk on its own; the backward
    folds an element a thread)."""
    if aligned and (c * itemsize) % VEC_BYTES == 0:
        return VEC_BYTES // itemsize
    return 1


def launch_geometry(rows: int, row_units: int) -> Tuple[int, int]:
    """(blocks, threads) of a row kernel: one block a row ((n, od, oh) of
    the output forward, (n, d, h) of the input backward), its threads the
    row's units rounded up to whole warps, at most MAX_THREADS (a longer row
    is walked in strides)."""
    return rows, min(MAX_THREADS, -(-row_units // 32) * 32)


def chunk_geometry(n: int, out: Sequence[int], c: int, itemsize: int) -> Tuple[int, int]:
    """(blocks, blocks a plane) of the chunk forward: each output plane
    (n, od) of Ho x Wo x C elements, starting anywhere within a 16-byte
    chunk, cut into chunks, CHUNK_THREADS of them a block."""
    epc = VEC_BYTES // itemsize
    chunks = -(-(out[1] * out[2] * c + epc - 1) // epc)
    per_plane = -(-chunks // CHUNK_THREADS)
    return n * out[0] * per_plane, per_plane


def fast_divisor(d: int) -> Tuple[int, int, int]:
    """(d, m, s) such that n // d == (umulhi(n, m) + n) >> s for every
    0 <= n < 2**31: the kernels' division by a per-shape constant, a
    multiply and a shift."""
    if d < 1:
        raise ValueError(f"divisor {d} < 1")
    s = (d - 1).bit_length()
    return d, ((1 << 32) * ((1 << s) - d)) // d + 1, s


def fast_div(n: int, div: Tuple[int, int, int]) -> int:
    """The kernels' quotient n // d by ``fast_divisor``'s constants."""
    return (((n * div[1]) >> 32) + n) >> div[2]


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def staged_bytes(length: int) -> int:
    """The most a bulk copy of ``length`` bytes stages: its source widened
    to whole 16-byte units at both ends, wherever it starts."""
    return _round16(length + 15)


def axis_classes(n: int):
    """(first index, count) of an axis's first, middle and last class: an
    axis of one voxel has only the first, one of two no middle."""
    return ((0, 1), (1, max(n - 2, 0)), (n - 1, 1 if n >= 2 else 0))


class TilePlan(NamedTuple):
    n: int
    c: int
    box: Tuple[int, int, int]
    out: Tuple[int, int, int]
    pads: Pads
    itemsize: int
    classes: Tuple[Tuple[int, int, int], ...]  # (rows a tile, pieces a row, piece width) x 9
    plane_tiles: Tuple[int, int, int]  # tiles of one plane of each depth class
    sample_tiles: int
    tiles: int
    grid: int
    tau: int  # the bytes a tile is sized to move
    stage: int  # bytes of one ring stage
    stages: int  # the ring's depth: 0 or 1 where a stage exceeds half the ring


def _fold_size(cls: int, n: int, lo: int, hi: int) -> int:
    first, count = axis_classes(n)[cls]
    if not count:
        return 0
    a, b = fold_range(first, n, lo, hi)
    return b - a + 1


def _piece_bytes(wp: int, nd: int, nh: int, c: int, es: int, pw: int) -> int:
    # a one-row tile of wp voxels: its nd x nh gradient rows, each at most
    # wp + pw voxels (a row cut in two or more pieces: one side's pad at
    # most), staged a row a copy
    return nd * nh * staged_bytes((wp + pw) * c * es)


def _rows_bytes(hr: int, nd: int, row_out: int) -> int:
    # hr gradient rows (hr whole rows of a middle row class, or the nh of an
    # edge row) at each of nd depths, a copy a depth
    return nd * staged_bytes(hr * row_out)


@functools.lru_cache(maxsize=1024)
def tile_plan(n: int, c: int, box: Tuple[int, int, int], pads: Pads, itemsize: int,
              sms: int = SMS) -> TilePlan:
    """The ring backward's tiles of a pad of an (n, c, *box) input. For
    each pair of a depth class and a row class (the first, middle and last
    planes and rows: their outputs' fold sizes nd and nh differ) a tile
    moves about ``tau`` bytes, a row costing its input row and the nd x nh
    output rows that clamp to it: a middle row class takes as many whole
    rows as fit ``tau``; a row that costs more than ``tau`` (a face or
    corner row, a wide row) is cut into pieces of equal width. Every tile's
    gradient rows at every depth of its fold fit STAGE_MAX, down to pieces
    one voxel wide; the stage is the largest tile's, and the ring as deep as
    RING_BYTES holds (``stages``)."""
    d_, h_, w_ = box
    do, ho, wo = out_shape(box, pads)
    row_in, row_out = w_ * c * itemsize, wo * c * itemsize
    total = n * (d_ * h_ * row_in + do * ho * row_out)
    tau = max(TAU_MIN, min(TAU_MAX, total // (sms * BLOCKS_PER_SM * TILES_PER_BLOCK)))
    pw = max(pads[4], pads[5])  # the pad voxels a piece of a row carries, at most
    classes, plane_tiles = [], []
    stage = 16
    for dc in range(3):
        nd = max(_fold_size(dc, d_, pads[0], pads[1]), 1)
        per_plane = 0
        for hc in range(3):
            nh = max(_fold_size(hc, h_, pads[2], pads[3]), 1)
            count = axis_classes(h_)[hc][1]
            cost = row_in + nd * nh * row_out
            if hc == 1:
                hr = max(1, min(count, tau // cost))
                while hr > 1 and _rows_bytes(hr, nd, row_out) > STAGE_MAX:
                    hr -= 1
            else:
                hr = 1
            if cost <= tau and _rows_bytes(hr if hc == 1 else nh, nd, row_out) <= STAGE_MAX:
                nw, wp = 1, w_
            else:
                hr, nw = 1, max(2, -(-cost // tau))
                while True:
                    wp = -(-w_ // nw)
                    if wp == 1 or _piece_bytes(wp, nd, nh, c, itemsize, pw) <= STAGE_MAX:
                        break
                    nw += 1
                nw = -(-w_ // wp)
            # a tile of whole rows (a row of one voxel too) stages its
            # gradient rows a copy a depth, a piece a copy a row
            stage = max(stage, _rows_bytes(hr if hc == 1 else nh, nd, row_out) if nw == 1
                        else _piece_bytes(wp, nd, nh, c, itemsize, pw))
            classes.append((hr, nw, wp))
            per_plane += -(-count // hr) * nw if count else 0
        plane_tiles.append(per_plane)
    sample = sum(plane_tiles[dc] * axis_classes(d_)[dc][1] for dc in range(3))
    tiles = n * sample
    grid = max(1, min(tiles, sms * BLOCKS_PER_SM))
    stages = min(MAX_STAGES, RING_BYTES // stage)
    return TilePlan(n, c, tuple(box), (do, ho, wo), tuple(pads), itemsize, tuple(classes),
                    tuple(plane_tiles), sample, tiles, grid, tau, stage, stages)


def _plane_tiles(plan: TilePlan, dc: int) -> np.ndarray:
    """The tiles of one plane of depth class dc, in the kernels' order, as
    rows (h0, h1, w0, w1)."""
    h_, w_ = plan.box[1:]
    out = []
    for hc, (first, count) in enumerate(axis_classes(h_)):
        hr, nw, wp = plan.classes[3 * dc + hc]
        for h0 in range(first, first + count, hr):
            for w0 in range(0, w_, wp):
                out.append((h0, min(h0 + hr, first + count) - 1, w0, min(w0 + wp, w_) - 1))
    return np.array(out, dtype=np.int64).reshape(-1, 4)


def tile_table(plan: TilePlan) -> np.ndarray:
    """Every tile of ``plan`` in order, as rows (n, d, h0, h1, w0, w1): what
    ``tile_at`` gives for t = 0, 1, ..., built a plane class at a time."""
    d_ = plan.box[0]
    per_sample = []
    for dc, (first, count) in enumerate(axis_classes(d_)):
        if not count:
            continue
        plane = _plane_tiles(plan, dc)
        d = np.repeat(np.arange(first, first + count), len(plane))
        per_sample.append(np.column_stack([d, np.tile(plane, (count, 1))]))
    sample = np.concatenate(per_sample)
    n = np.repeat(np.arange(plan.n), len(sample))
    return np.column_stack([n, np.tile(sample, (plan.n, 1))])


def _fold_np(i, n: int, lo: int, hi: int):
    return np.where(i == 0, 0, i + lo), np.where(i == n - 1, n - 1 + lo + hi, i + lo)


def tile_costs(plan: TilePlan, table=None) -> Tuple[np.ndarray, np.ndarray]:
    """(input bytes, output bytes) of every tile: its input piece, and every
    output that clamps to it."""
    t = tile_table(plan) if table is None else table
    (d_, h_, w_), p = plan.box, plan.pads
    od0, od1 = _fold_np(t[:, 1], d_, p[0], p[1])
    oh0, oh1 = _fold_np(t[:, 2], h_, p[2], p[3])[0], _fold_np(t[:, 3], h_, p[2], p[3])[1]
    ow0, ow1 = _fold_np(t[:, 4], w_, p[4], p[5])[0], _fold_np(t[:, 5], w_, p[4], p[5])[1]
    unit = plan.c * plan.itemsize
    return ((t[:, 3] - t[:, 2] + 1) * (t[:, 5] - t[:, 4] + 1) * unit,
            (od1 - od0 + 1) * (oh1 - oh0 + 1) * (ow1 - ow0 + 1) * unit)


def tile_at(plan: TilePlan, t: int) -> Tuple[int, int, int, int, int, int]:
    """Tile t of ``plan`` as (n, d, h0, h1, w0, w1), inclusive: the kernels'
    decode (``tile_at`` in csrc/replication_pad.cu) step for step."""
    d_, h_, w_ = plan.box
    n, r = divmod(t, plan.sample_tiles)
    dc = 0
    for dc, (first, count) in enumerate(axis_classes(d_)):
        span = count * plan.plane_tiles[dc]
        if r < span:
            break
        r -= span
    q, r = divmod(r, plan.plane_tiles[dc])
    d = axis_classes(d_)[dc][0] + q
    for hc, (first, count) in enumerate(axis_classes(h_)):
        hr, nw, wp = plan.classes[3 * dc + hc]
        span = -(-count // hr) * nw
        if r < span:
            break
        r -= span
    row, wi = divmod(r, nw)
    h0 = first + row * hr
    w0 = wi * wp
    return n, d, h0, min(h0 + hr, first + count) - 1, w0, min(w0 + wp, w_) - 1


def row_tiles(plan: TilePlan) -> Tuple[int, ...]:
    """Row tiles of each (depth class, row class): 0 for a class of no rows."""
    counts = [count for _, count in axis_classes(plan.box[1])]
    return tuple(-(-counts[i % 3] // hr) for i, (hr, _, _) in enumerate(plan.classes))


def block_tiles(plan: TilePlan, b: int) -> range:
    """The tiles block b walks: b, b + grid, b + 2 grid, ..., so that the
    whole grid works on neighbouring tiles at any time; the tiles, sized by
    bytes, balance the blocks."""
    return range(b, plan.tiles, plan.grid)


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
    lib.mra_pad_sms.argtypes = [ctypes.c_int]
    lib.mra_pad_sms.restype = ctypes.c_int
    lib.mra_pad_error_string.argtypes = [ctypes.c_int]
    lib.mra_pad_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    sms = _lib().mra_pad_sms(device)
    if sms <= 0:
        msg = _lib().mra_pad_error_string(-sms).decode()
        raise RuntimeError(f"replication_pad: no multiprocessor count for cuda:{device} ({msg})")
    return sms


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


# the parameters' order in the C int array: a header, then csrc/
# replication_pad.cu's struct Plan field by field
HEADER = ("dtype", "vec", "route", "threads", "grid")
PARAMS = HEADER + ("N", "C", "D", "H", "W", "Do", "Ho", "Wo", "pd", "ph", "pw", "plane_blocks",
                   "stage_bytes", "stages", "tiles", "sample_tiles", "row_d", "row_m", "row_s",
                   "vox_d", "vox_m", "vox_s", *(f"plane_tiles{i}" for i in range(3)),
                   *(f"hr{i}" for i in range(9)), *(f"nw{i}" for i in range(9)),
                   *(f"wp{i}" for i in range(9)), *(f"row_tiles{i}" for i in range(9)))


def _int32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


@functools.lru_cache(maxsize=1024)
def launch_plan(shape: Tuple[int, ...], pads: Pads, box: Tuple[int, int, int],
                dtype: torch.dtype, aligned: bool, backward: bool, device=None):
    """The output's shape and the launch's parameters of a forward on an
    input of ``shape``, or of a backward on an output gradient of ``shape``
    for the input box ``box`` (the input's (D, H, W) forward), the source
    16-byte ``aligned`` or not, on CUDA ``device`` (None: an H100's SMS
    multiprocessors): (shape, the parameters in PARAMS' order, the
    parameters as a C int array, its address, the ring's tile plan or
    None). The destination's row divides by the elements of its rows (units
    on the unit path), the voxel by C (its units). Raises on what the
    kernels do not take; the checks and the plan run once a shape."""
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
    es = dtype.itemsize
    vec = vector_width(c, es, aligned)
    # the kernel, from the shape alone: forward, the row kernel on the unit
    # path and the chunk kernel elsewhere; backward, the ring on the unit
    # path where its stage fits half the ring, the row kernel elsewhere
    plan = None
    if backward and vec > 1:
        plan = tile_plan(n, c, tuple(box), tuple(pads), es,
                         SMS if device is None else _sm_count(device))
    if backward:
        route = "ring" if plan is not None and plan.stages >= 2 else "rows"
        plan = plan if route == "ring" else None
    else:
        route = "rows" if vec > 1 else "chunks"
    d, h, w = box if backward else padded  # the destination's box
    plane_blocks = 0
    if route == "rows":
        grid, threads = launch_geometry(n * d * h, w * c // vec)
    elif route == "chunks":
        if h * w * c >= 1 << 31:
            raise ValueError(f"{what}: an output plane of {h * w * c} elements, more than an "
                             f"int indexes")
        grid, plane_blocks = chunk_geometry(n, padded, c, es)
        threads = CHUNK_THREADS
    else:
        grid, threads = plan.grid, RING_THREADS
    if grid >= 1 << 31 or (plan is not None and plan.tiles >= 1 << 31):
        raise ValueError(f"{what}: {grid} blocks, more than a launch takes")
    per = VEC_BYTES // es if vec > 1 else 1  # elements a divided unit holds
    row_div, vox_div = fast_divisor(w * c // per), fast_divisor(c // per)
    if plan is None:  # the ring's fields and tables unused
        ring, tables = (0,) * 4, (0,) * (len(PARAMS) - PARAMS.index("plane_tiles0"))
    else:
        hr, nw, wp = zip(*plan.classes)
        ring = (plan.stage, plan.stages, plan.tiles, plan.sample_tiles)
        tables = (*plan.plane_tiles, *hr, *nw, *wp, *row_tiles(plan))
    params = (_DTYPE_CODES[dtype], vec, ROUTES[route], threads, grid, n, c, *box, *padded,
              pads[0], pads[2], pads[4], plane_blocks, *ring, *map(_int32, row_div),
              *map(_int32, vox_div), *tables)
    arr = (ctypes.c_int * len(params))(*params)
    return (n, c, *(box if backward else padded)), params, arr, ctypes.addressof(arr), plan


def _launch(fn, src: torch.Tensor, pads: Pads, box, backward: bool, what: str) -> torch.Tensor:
    shape, _, _, params, _ = launch_plan(src.shape, pads, box, src.dtype,
                                         src.data_ptr() % VEC_BYTES == 0, backward,
                                         src.device.index)
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
