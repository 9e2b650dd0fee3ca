"""Stride-2 4^3 convolution from a one-channel field to C channels, zero pad
0 or 1 on each axis: the CUDA kernels' wrappers and their plain PyTorch
versions.

The PatchGAN's first conv, ``Conv3d(1, ndf, 4, stride=2, padding=1)``, and
the U-Net's outermost down conv (depth pad 0 on a depth shard) run through
these kernels in bfloat16 on CUDA, forward, input gradient and weight
gradient (``ops/conv.py`` routes them; the JAX package computes them with
XLA over space-to-depth cells, mra_gan_tpu/ops/s2d.py:618). The kernels'
design is described in ``csrc/conv4s2.cu``. Pads are per axis, (pd, ph, pw),
each low and high; the output box is (s + 2 p - 4) // 2 + 1 per axis. One
wrapper each:

- ``conv4s2_spread``  x (N, 1, D, H, W), w (C, 4, 4, 4), bias (C,) or None
  -> y (N, C, Do, Ho, Wo): y[n, c, o] = bias[c] + sum_t w[c, t] x[n, 2o + t - p]
- ``conv4s2_gather``  g (N, C, Do, Ho, Wo), w -> dx (N, 1, D, H, W) for the
  input box (D, H, W): the input gradient of ``conv4s2_spread``
- ``conv4s2_wgrad``  x, g -> (dw (C, 4, 4, 4), db (C,)): the weight and bias
  gradients, a first pass of partial sums over a fixed grid
  (``conv4s2_wgrad_partials``: (blocks, 65, 32 * chunks) float32) and
  ``conv4s2_wgrad_reduce``, which sums them in a fixed order and rounds once

Input voxels outside the box read as zero. A wrapper given a CPU tensor
runs its plain version (float32 ``F.conv3d``, ``torch.nn.grad.conv3d_input``
or ``conv3d_weight`` of the same inputs, rounded once to the input's dtype,
as the kernel rounds; the reduce's plain version repeats the kernel's order
of sums, so the two agree bit for bit); given a CUDA tensor it launches its
kernel or raises (a dtype other than bfloat16, a wrong shape or layout, a
failed build, a refused launch). Each launch adds one to
``LAUNCHES[<kernel name>]``: the weight gradient counts its first pass under
``conv4s2_wgrad`` and its second under ``conv4s2_wgrad_reduce``.
``RELAYOUTS["count"]`` counts the output gradients ``ops/conv.py`` copied
into channels_last_3d before the input- and weight-gradient kernels.

The forward and the weight gradient each have two kernels, one path a
launch: the TMA path (``conv4s2_spread_tma_kernel``,
``conv4s2_wgrad_tma_kernel``: persistent blocks fed through an mbarrier ring
of TMA loads, the forward's tiles stored by TMA) wherever a tensor map can
describe every tensor, and the staged kernels elsewhere. ``takes_tma``
decides from the shape and the alignment alone: x's rows a multiple of 16
bytes (W % 8 == 0), C % 8 == 0, every source 16-byte aligned. No flag and no
fallback: a CUDA call launches its plan's kernel or raises.

The host side of a launch is pure functions here, so the CPU tests reach it:
``tile_of`` (a tile of outputs, or for the gather of cells, and the tiles a
sample along each axis), ``takes_tma`` (the path), ``window_x0`` and
``tile_pitch`` (the TMA path's staged rows), ``wgrad_grid`` (the first pass's fixed grid),
``smem_bytes`` (what a block stages) and ``launch_params`` (the checks, the
path and the parameters of a launch, once a shape)."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

TAPS = (4, 4, 4)
LAUNCHES = {"conv4s2_spread": 0, "conv4s2_gather": 0, "conv4s2_wgrad": 0,
            "conv4s2_wgrad_reduce": 0}
# the output gradients that ops/conv.py had to copy into channels_last_3d
# before the input- and weight-gradient kernels
RELAYOUTS = {"count": 0}

# csrc/conv4s2.cu's constants: channels a chunk, rows of a weight-gradient
# partial (the 64 taps and the bias), bf16 a staged voxel, a staged spread
# row and a staged weight-gradient plane, the widest spread or weight-gradient
# tile, the most cells a gather tile holds and along W, the reduce's warps
GROUP = 32
ROWS = 65
VOX = 40
SPREAD_ROW = 96
PLANE = 72
MAX_TILE_W = 32
MAX_CELLS = 320
GATHER_MAX_W = 40
REDUCE_WARPS = 8
WARPS = 4
SMEM_LIMIT = 232448  # a block's shared memory on sm_90
# each kind's tile: (planes, rows) of outputs (the gather: of cells), and a
# row cut into the fewest balanced segments of at most the kind's width;
# the best of 1-4 planes x 1-8 rows in a sweep on an H100 at N = 8 and 16
TILES = {"spread": ((4, 4), MAX_TILE_W), "gather": ((2, 4), GATHER_MAX_W),
         "wgrad": ((2, 4), MAX_TILE_W)}
# the weight gradient's first pass on the staged path: at most this many
# blocks (4 an H100 SM) walk the tiles; a function of the shape alone, so
# every sum keeps its order
WGRAD_BLOCKS = 528
# the TMA path (csrc/conv4s2.cu's constants): consumer warps of the forward
# and of the weight gradient (one producer warp besides), the m-tiles a
# forward warp holds at most, bytes a voxel of a 32-channel chunk in a TMA
# tile, the forward's input windows and the weight gradient's (window, g
# tile) pairs in flight a block, a TMA buffer's alignment; at most
# TMA_BLOCKS persistent blocks (1 an H100 SM) walk the tiles, a function of
# the shape alone
SPREAD_WARPS = 8
WGRAD_WARPS = 8
SPREAD_MPW = 4
SLOT = 64
SPREAD_STAGES = 2
WGRAD_STAGES = 3
ALIGN = 1024
TMA_BLOCKS = 132

Pads = Tuple[int, int, int]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    RELAYOUTS["count"] = 0


def out_shape(spatial: Sequence[int], pads: Sequence[int]) -> Tuple[int, int, int]:
    """The output box of an input box: (s + 2 p - 4) // 2 + 1 per axis."""
    return tuple((s + 2 * p - 4) // 2 + 1 for s, p in zip(spatial, pads))


def cells(spatial: Sequence[int], pads: Sequence[int]) -> Tuple[int, int, int]:
    """The gather's cells along each axis: voxel i with i + p = 2 q + r lies
    in cell q, so q runs over 0 .. (s - 1 + p) // 2."""
    return tuple((s - 1 + p) // 2 + 1 for s, p in zip(spatial, pads))


def segments(width: int, longest: int) -> Tuple[int, int]:
    """The fewest balanced segments of at most ``longest`` covering
    ``width``: (count, length), the last one cut by the width."""
    count = -(-width // longest)
    return count, -(-width // count)


def tile_of(kind: str, span: Sequence[int]):
    """The tile of ``kind`` ("spread", "gather", "wgrad") over a box
    ``span`` (outputs, or the gather's cells): ((TD, TH, TW), (nd, nh, nw)
    tiles a sample)."""
    (td, th), longest = TILES[kind]
    tile = (min(td, span[0]), min(th, span[1]), segments(span[2], longest)[1])
    return tile, tuple(-(-s // t) for s, t in zip(span, tile))


def takes_tma(kind: str, c: int, box: Sequence[int], aligned: bool) -> bool:
    """The TMA path: the forward and the weight gradient where a tensor map
    describes every tensor: x (N, 1, D, H, W) with rows of a multiple of 16
    bytes (W % 8 == 0), y or g with C % 8 == 0, every source 16-byte aligned
    (``aligned``). The gather stays staged."""
    return kind in ("spread", "wgrad") and box[2] % 8 == 0 and c % 8 == 0 and aligned


def window_pitch(width: int) -> int:
    """The TMA path's staged input row: ``width`` voxels rounded up to 16
    bytes (the box's rows), then on by 8 until its words are 9-23 mod 32, so
    that the two rows a warp's A loads touch fall in distinct banks."""
    pitch = -(-width // 8) * 8
    while not 9 <= pitch // 2 % 32 <= 23:
        pitch += 8
    return pitch


def window_x0(w0: int) -> int:
    """The x index where a TMA window row starts for a window whose first
    voxel is ``w0`` (2 ow0 - pw): a box's innermost coordinate stays a
    non-negative multiple of 8 voxels, so the window starts w0 -
    window_x0(w0), in [-1, 7], voxels into the row (-1: the low zero pad)."""
    return 0 if w0 < 0 else w0 & ~7


def tile_pitch(kind: str, tile: Sequence[int]) -> int:
    """The TMA path's window row for ``kind``'s tile: from the row's start
    the forward reads up to 7 + 2 TW + 2 voxels (the window's offset, its
    outputs' taps, the second word of a pair that straddles two), the
    weight gradient up to 7 + 2 TWr + 4 (TWr = TW rounded up to 16, its g
    rows; taps a pair 2 voxels apart)."""
    if kind == "spread":
        return window_pitch(2 * tile[2] + 10)
    return window_pitch(2 * 16 * -(-tile[2] // 16) + 12)


def wgrad_grid(n: int, out_box: Sequence[int], tma: bool) -> int:
    """The weight gradient's first pass: its blocks (each walks tiles b, b +
    grid, ...), fixed by the shape and the path."""
    _, counts = tile_of("wgrad", out_box)
    return min(n * math.prod(counts), TMA_BLOCKS if tma else WGRAD_BLOCKS)


def _align(v: int) -> int:
    return -(-v // ALIGN) * ALIGN


def smem_bytes(kind: str, tile: Sequence[int], tma: bool = False) -> int:
    """Shared memory a block of ``kind`` ("spread", "gather", "wgrad")
    takes for ``tile`` on its path (csrc/conv4s2.cu sizes it the same
    way): on the TMA path the ring, the output tiles and the barriers, and
    the slack that aligns them."""
    td, th, tw = tile
    if tma:
        window = _align((2 * td + 2) * (2 * th + 2) * tile_pitch(kind, tile) * 2)
        if kind == "spread":
            return ALIGN + 2 * _align(td * th * tw * SLOT) + SPREAD_STAGES * window \
                + 2 * SPREAD_STAGES * 8
        ring = WGRAD_STAGES * (window + _align(td * th * 16 * -(-tw // 16) * SLOT))
        # and a guard before the ring, so that a window's x[-1] reads stay in bounds
        return 2 * ALIGN + max(ring, WGRAD_WARPS * ROWS * GROUP * 4) + 2 * WGRAD_STAGES * 8
    if kind == "spread":
        return ((2 * td + 2) * (2 * th + 2) * SPREAD_ROW + WARPS * 16 * VOX) * 2
    if kind == "gather":
        return (td + 1) * (th + 1) * (tw + 1) * VOX * 2
    staged = ((2 * td + 2) * (2 * th + 2) * 4 * PLANE + td * th * 16 * -(-tw // 16) * VOX) * 2
    return max(staged, WARPS * ROWS * GROUP * 4)


# ---------------------------------------------------------------------------
# plain versions


def conv4s2_spread_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                         pads: Pads = (1, 1, 1)) -> torch.Tensor:
    """float32 F.conv3d of the one-channel field, rounded once to x's dtype."""
    b = None if bias is None else bias.float()
    return F.conv3d(x.float(), w.float().reshape(-1, 1, *TAPS), b, 2, tuple(pads)).to(x.dtype)


def conv4s2_gather_plain(g: torch.Tensor, w: torch.Tensor, pads: Pads,
                         box: Sequence[int]) -> torch.Tensor:
    """float32 torch.nn.grad.conv3d_input onto the one-channel box ``box``,
    rounded once to g's dtype."""
    dx = torch.nn.grad.conv3d_input((g.shape[0], 1, *box), w.float().reshape(-1, 1, *TAPS),
                                    g.float(), 2, tuple(pads))
    return dx.to(g.dtype)


def conv4s2_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                        pads: Pads) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 torch.nn.grad.conv3d_weight (C, 4, 4, 4) and the bias
    gradient (g's float32 sum, (C,)), each rounded once to x's dtype."""
    c = g.shape[1]
    dw = torch.nn.grad.conv3d_weight(x.float(), (c, 1, *TAPS), g.float(), 2, tuple(pads))
    return dw[:, 0].to(x.dtype), g.float().sum((0, 2, 3, 4)).to(x.dtype)


def conv4s2_wgrad_reduce_plain(partial: torch.Tensor,
                               c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partials (P, 65, Cp) summed as the kernel sums them: partials
    w, w + REDUCE_WARPS, ... in order from 0 for each w, then those
    REDUCE_WARPS sums in order, in float32; cut to C channels, rounded
    once to bfloat16: (dw (C, 4, 4, 4), db (C,))."""
    p = partial.float()
    total = None
    for w in range(REDUCE_WARPS):
        s = torch.zeros_like(p[0])
        for k in range(w, p.shape[0], REDUCE_WARPS):
            s = s + p[k]
        total = s if total is None else total + s
    out = total[:, :c].t().bfloat16()
    return out[:, :64].reshape(c, *TAPS).contiguous(), out[:, 64].contiguous()


# ---------------------------------------------------------------------------
# CUDA wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import build_library

    lib = ctypes.CDLL(str(build_library("conv4s2")))
    p = ctypes.c_void_p
    lib.mra_conv4s2_spread.argtypes = [p] * 6
    lib.mra_conv4s2_gather.argtypes = [p] * 5
    lib.mra_conv4s2_wgrad.argtypes = [p] * 5
    lib.mra_conv4s2_wgrad_reduce.argtypes = [p] * 5
    for fn in (lib.mra_conv4s2_spread, lib.mra_conv4s2_gather, lib.mra_conv4s2_wgrad,
               lib.mra_conv4s2_wgrad_reduce):
        fn.restype = ctypes.c_int
    lib.mra_conv4s2_error_string.argtypes = [ctypes.c_int]
    lib.mra_conv4s2_error_string.restype = ctypes.c_char_p
    return lib


# the current stream's handle without a torch.cuda.Stream object, and the
# current device without torch.cuda.current_device's checks, each of which
# costs more than a launch on a host-paced step
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_CURRENT_DEVICE = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)


def _stream(t: torch.Tensor) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_device(t: torch.Tensor, what: str) -> None:
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {dev}")
    current = _CURRENT_DEVICE()
    if dev.index != current:
        raise ValueError(f"{what}: tensor on {dev} but the current device is cuda:{current}")


def check_tensor(t: torch.Tensor, device: torch.device, what: str, name: str, shape,
                 channels_last: bool = False) -> None:
    """``t`` a bfloat16 tensor of ``shape`` on ``device``, contiguous (in
    channels_last_3d where ``channels_last``); raises otherwise."""
    if t.device != device:
        raise ValueError(f"{what}: {name} on {t.device}, the input on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes bfloat16")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    if not t.is_contiguous(memory_format=fmt):
        raise ValueError(f"{what}: {name} must be contiguous"
                         + (" in channels_last_3d" if channels_last else ""))


# a launch's parameters, csrc/conv4s2.cu's int array
PARAMS = ("n", "c", "d", "h", "w", "pd", "ph", "pw", "td", "th", "tw", "vec", "grid", "tma",
          "pitch")


@functools.lru_cache(maxsize=1024)
def launch_params(kind: str, n: int, c: int, box: Tuple[int, int, int], pads: Pads,
                  vec: bool, aligned: bool):
    """The parameters of a launch of ``kind`` ("spread", "gather", "wgrad")
    for N = n, C = c, the one-channel box ``box`` and ``pads``, where
    ``vec`` says the staged kernel may move y or g in 16-byte channel
    vectors and ``aligned`` that every source is 16-byte aligned: (params
    laid out as PARAMS, a C int array of them, its address). The path
    (``takes_tma``), the grid (the TMA kernels' and the staged weight
    gradient's fixed grid, else the tiles) and the window's pitch (0 on the
    staged path) are a function of these alone. Raises on what the kernels
    do not take; the checks and the tiling run once a shape."""
    what = f"conv4s2_{kind}"
    if len(pads) != 3 or any(p not in (0, 1) for p in pads):
        raise ValueError(f"{what}: pads must be 0 or 1 on each axis, got {pads}")
    out = out_shape(box, pads)
    if min(out) < 1 or n < 1 or c < 1:
        raise ValueError(f"{what}: input box {box} with pads {pads} gives no output")
    tile, counts = tile_of(kind, cells(box, pads) if kind == "gather" else out)
    tiles = n * math.prod(counts)
    tma = takes_tma(kind, c, box, aligned)
    if kind == "wgrad":
        grid = wgrad_grid(n, out, tma)
    else:
        grid = min(tiles, TMA_BLOCKS) if tma else tiles
    pitch = tile_pitch(kind, tile) if tma else 0
    params = (n, c, *box, *pads, *tile, int(vec), grid, int(tma), pitch)
    arr = (ctypes.c_int * len(params))(*params)
    return params, arr, ctypes.addressof(arr)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().mra_conv4s2_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _vec(c: int, *tensors: torch.Tensor) -> bool:
    """16-byte channel vectors: C a multiple of 8 and the C-channel tensors
    16-byte aligned."""
    return c % 8 == 0 and _aligned(*tensors)


def conv4s2_spread(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   pads: Pads = (1, 1, 1)) -> torch.Tensor:
    """(N, 1, D, H, W) -> (N, C, Do, Ho, Wo), channels_last_3d on CUDA. On
    CUDA every tensor is bfloat16: x contiguous, w (C, 4, 4, 4) contiguous,
    bias (C,) or None. ``pads`` a tuple."""
    if x.device.type == "cpu":
        return conv4s2_spread_plain(x, w, bias, pads)
    what = "conv4s2_spread"
    _check_device(x, what)
    n, _, *box = x.shape
    c = w.shape[0]
    check_tensor(x, x.device, what, "the input", (n, 1, *box))
    check_tensor(w, x.device, what, "the weight", (c, *TAPS))
    if bias is not None:
        check_tensor(bias, x.device, what, "the bias", (c,))
    _, _, addr = launch_params("spread", n, c, tuple(box), tuple(pads), c % 8 == 0,
                               _aligned(x))
    y = torch.empty((n, c, *out_shape(box, pads)), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last_3d)
    err = _lib().mra_conv4s2_spread(x.data_ptr(), w.data_ptr(),
                                    None if bias is None else bias.data_ptr(), y.data_ptr(),
                                    addr, _stream(x))
    _raise_on(err, what)
    LAUNCHES[what] += 1
    return y


def conv4s2_gather(g: torch.Tensor, w: torch.Tensor, pads: Pads,
                   box: Sequence[int]) -> torch.Tensor:
    """(N, C, Do, Ho, Wo) -> (N, 1, D, H, W) for the input box ``box``. On
    CUDA every tensor is bfloat16: g contiguous in channels_last_3d, w (C,
    4, 4, 4) contiguous. ``pads`` and ``box`` tuples."""
    if g.device.type == "cpu":
        return conv4s2_gather_plain(g, w, pads, box)
    what = "conv4s2_gather"
    _check_device(g, what)
    n, c = g.shape[:2]
    check_tensor(g, g.device, what, "the output gradient", (n, c, *out_shape(box, pads)), True)
    check_tensor(w, g.device, what, "the weight", (c, *TAPS))
    _, _, addr = launch_params("gather", n, c, tuple(box), tuple(pads), _vec(c, g), False)
    dx = torch.empty((n, 1, *box), device=g.device, dtype=g.dtype)
    err = _lib().mra_conv4s2_gather(g.data_ptr(), w.data_ptr(), dx.data_ptr(), addr, _stream(g))
    _raise_on(err, what)
    LAUNCHES[what] += 1
    return dx


def conv4s2_wgrad_partials(x: torch.Tensor, g: torch.Tensor, pads: Pads) -> torch.Tensor:
    """The weight gradient's first pass: (blocks, 65, 32 * chunks) float32
    partial sums of ``wgrad_grid``'s blocks (rows: the 64 taps, then the
    bias), fixed by the shape and the path. x (N, 1, D, H, W) contiguous and
    g (N, C, Do, Ho, Wo) contiguous in channels_last_3d, both bfloat16 on
    CUDA."""
    what = "conv4s2_wgrad"
    _check_device(x, what)
    n, c = g.shape[:2]
    box = tuple(x.shape[2:])
    check_tensor(x, x.device, what, "the input", (n, 1, *box))
    check_tensor(g, x.device, what, "the output gradient", (n, c, *out_shape(box, pads)), True)
    params, _, addr = launch_params("wgrad", n, c, box, tuple(pads), _vec(c, g),
                                    _aligned(x, g))
    partial = torch.empty((params[12], ROWS, -(-c // GROUP) * GROUP), device=x.device,
                          dtype=torch.float32)
    err = _lib().mra_conv4s2_wgrad(x.data_ptr(), g.data_ptr(), partial.data_ptr(), addr,
                                   _stream(x))
    _raise_on(err, what)
    LAUNCHES[what] += 1
    return partial


@functools.lru_cache(maxsize=256)
def _reduce_params(p: int, c: int, cp: int):
    arr = (ctypes.c_int * 3)(p, c, cp)
    return arr, ctypes.addressof(arr)


def conv4s2_wgrad_reduce(partial: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw (C, 4, 4, 4), db (C,)) bfloat16 from the first pass's partial
    sums (P, 65, Cp) float32, contiguous."""
    if partial.device.type == "cpu":
        return conv4s2_wgrad_reduce_plain(partial, c)
    what = "conv4s2_wgrad_reduce"
    _check_device(partial, what)
    cp = -(-c // GROUP) * GROUP
    if partial.dtype != torch.float32 or not partial.is_contiguous() or partial.dim() != 3 \
            or tuple(partial.shape[1:]) != (ROWS, cp):
        raise ValueError(f"{what}: expected contiguous float32 partials (P, {ROWS}, {cp}), got "
                         f"{partial.dtype} {tuple(partial.shape)}")
    dw = torch.empty((c, *TAPS), device=partial.device, dtype=torch.bfloat16)
    db = torch.empty((c,), device=partial.device, dtype=torch.bfloat16)
    _, addr = _reduce_params(partial.shape[0], c, cp)
    err = _lib().mra_conv4s2_wgrad_reduce(partial.data_ptr(), dw.data_ptr(), db.data_ptr(), addr,
                                          _stream(partial))
    _raise_on(err, what)
    LAUNCHES[what] += 1
    return dw, db


def conv4s2_wgrad(x: torch.Tensor, g: torch.Tensor,
                  pads: Pads) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw (C, 4, 4, 4), db (C,)) from the input x (N, 1, D, H, W) and the
    output gradient g (N, C, Do, Ho, Wo). On CUDA both are bfloat16: x
    contiguous, g contiguous in channels_last_3d."""
    if x.device.type == "cpu":
        return conv4s2_wgrad_plain(x, g, pads)
    return conv4s2_wgrad_reduce(conv4s2_wgrad_partials(x, g, pads), g.shape[1])
