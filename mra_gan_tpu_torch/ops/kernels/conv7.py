"""Stride-1, unpadded 7^3 convolution between a one-channel field and a
C-channel field: the CUDA kernels' wrappers and their plain PyTorch versions.

The resnet generator's stem (1 -> ngf) and head (ngf -> 1) 7^3 convs run
through these two kernels in bfloat16 on CUDA, forward and input gradient
(``ops/conv.py`` routes them; the JAX package leaves them to XLA,
mra_gan_tpu/ops/conv.py:35). The kernels' design is described in
``csrc/conv7.cu``. Two kernels, one wrapper each:

- ``conv7_spread``  a (N, 1, D, H, W), w (C, 7, 7, 7) -> (N, C, D', H', W'):
  y[n, c, v] = bias[c] + sum_k a[n, v + k - pad] * w[c, k]
- ``conv7_gather``  x (N, C, D, H, W), w (C, 7, 7, 7) -> (N, 1, D', H', W'):
  y[n, v] = bias + sum_k sum_c x[n, c, v + k - pad] * w[c, k]

with D' = D + 2 pad - 6 (H', W' alike) and input voxels outside the box read
as zero. pad 0 is a forward conv; pad 6 with w flipped on its three axes is
the input gradient of the other role's forward.

A wrapper given a CPU tensor runs its plain version (float32 ``F.conv3d``,
rounded once to the input's dtype, as the kernel rounds); given a CUDA
tensor it launches its kernel or raises (a dtype other than bfloat16, a
wrong shape or layout, a failed build, a refused launch). Each launch adds
one to ``LAUNCHES[<wrapper name>]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

TAPS = (7, 7, 7)
LAUNCHES = {"conv7_spread": 0, "conv7_gather": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def out_shape(spatial, pad: int) -> tuple:
    """The output box of an input box: each axis grown by 2 pad - 6."""
    return tuple(s + 2 * pad - 6 for s in spatial)


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


# ---------------------------------------------------------------------------
# CUDA wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import build_library

    lib = ctypes.CDLL(str(build_library("conv7")))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.mra_conv7_spread, lib.mra_conv7_gather):
        fn.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, i32, i32, p]
        fn.restype = ctypes.c_int
    lib.mra_conv7_error_string.argtypes = [ctypes.c_int]
    lib.mra_conv7_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, dev: torch.device, what: str, name: str) -> None:
    if t.device != dev:
        raise ValueError(f"{what}: {name} on {t.device}, the input on {dev}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes bfloat16")


def _check_args(field: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], pad: int,
                c: int, bias_len: int, what: str) -> None:
    dev = field.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{what}: tensor on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    y = torch.empty((n, c, *out_shape((d, h, wd), pad)), device=a.device, dtype=a.dtype,
                    memory_format=torch.channels_last_3d)
    vec = int(c % 8 == 0 and y.data_ptr() % 16 == 0)
    err = _lib().mra_conv7_spread(a.data_ptr(), w.data_ptr(), _ptr(bias), y.data_ptr(), n, d, h,
                                  wd, c, pad, vec, _stream(a))
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
    y = torch.empty((n, 1, *out_shape((d, h, wd), pad)), device=x.device, dtype=x.dtype)
    vec = int(c % 8 == 0 and x.data_ptr() % 16 == 0)
    err = _lib().mra_conv7_gather(x.data_ptr(), w.data_ptr(), _ptr(bias), y.data_ptr(), n, d, h,
                                  wd, c, pad, vec, _stream(x))
    _raise_on(err, what)
    LAUNCHES["conv7_gather"] += 1
    return y
