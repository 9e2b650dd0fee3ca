"""Full-volume sliding-window inference (counterpart of
mra_gan_tpu/infer/sliding_window.py:26,37,48).

One general path on the device replaces the JAX package's three (overlap-add,
depth-streamed, scan), which are TPU and transfer-tunnel designs; the
arithmetic is theirs: the clamped patch grid over the volume zero-padded up
to the patch size, every patch weighted by the blend window, an f32 sum of
outputs and of windows, and a division by max(window sum, 1e-8). The
reference's "+0.01 after dividing" bias is not reproduced, as in the JAX
package."""
from __future__ import annotations

import functools
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.networks import BatchNorm3d


def compute_grid_starts(size: int, patch: int, stride: int) -> list:
    """Start offsets covering [0, size) with the last window clamped flush to
    the edge (the reference's boundary handling, test.py:111-145)."""
    if size <= patch:
        return [0]
    starts = list(range(0, size - patch + 1, stride))
    if starts[-1] != size - patch:
        starts.append(size - patch)
    return starts


def gaussian_window(patch_size: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    wins = []
    for p in patch_size:
        sigma = max(p * sigma_scale, 1.0)
        x = np.arange(p, dtype=np.float64) - (p - 1) / 2.0
        wins.append(np.exp(-0.5 * (x / sigma) ** 2))
    w = wins[0][:, None, None] * wins[1][None, :, None] * wins[2][None, None, :]
    w = np.maximum(w / w.max(), 1e-4)
    return w.astype(np.float32)


def patch_grid(shape: Sequence[int], patch: Sequence[int], strides: Sequence[int]) -> list:
    """Every (x, y, z) patch start of the clamped grid over ``shape`` padded
    up to the patch size, in the JAX package's order."""
    padded = [max(s, p) for s, p in zip(shape, patch)]
    axes = [compute_grid_starts(padded[a], patch[a], strides[a]) for a in range(3)]
    return [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]


def per_call(generate_fn, batch: int) -> int:
    """The patches one call of ``generate_fn`` takes: ``batch``, or 1 for a
    generator that holds a ``BatchNorm3d`` (``--norm batch``), whose output
    for one patch depends on the others in its batch."""
    net = getattr(generate_fn, "net", None)
    if net is not None and any(isinstance(m, BatchNorm3d) for m in net.modules()):
        return 1
    return int(batch)


@torch.inference_mode()
def sliding_window_inference(volume: np.ndarray, generate_fn, patch_size=(64, 64, 64),
                             stride_inplane: int = 32, stride_layer: int = 32,
                             blend: str = "gaussian", batch: int = 4,
                             transfer_dtype: torch.dtype = torch.float32,
                             input_transfer_dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """volume: (X, Y, Z) float32 in the generator's input range, mapped to the
    generator's (D, H, W); stride_inplane covers X and Y, stride_layer Z, like
    the reference. generate_fn: a models.cycle_gan.GenerateFn, (B, 1, px, py,
    pz) -> same shape. The volume goes to the device once and the result
    comes back once, float32 (X, Y, Z) on the host. The last batch may be
    short. ``batch`` is the patches a generator call takes; a generator that
    holds a batch norm (``--norm batch``), whose statistics are its batch's,
    takes one a call, the reference's batch of 1. So every patch is
    normalized alone, and ``batch`` changes the amortization only.

    The two dtypes set only the precision on the wire (JAX
    sliding_window.py:56-86); the blending is float32 on the device.
    ``input_transfer_dtype`` is the upload's, by default the generator's
    compute dtype, which is exact: the generator's first op casts to it
    anyway. ``transfer_dtype`` is the download's: float32 is exact, float16
    rounds the [-1, 1] result to about 5e-4."""
    if blend not in ("gaussian", "uniform"):
        raise ValueError(f"unknown blend {blend!r}")
    patch = tuple(int(p) for p in patch_size)
    strides = (int(stride_inplane), int(stride_inplane), int(stride_layer))
    dev = torch.device(generate_fn.device)
    vshape = volume.shape
    padded = tuple(max(v, p) for v, p in zip(vshape, patch))
    in_dtype = generate_fn.dtype if input_transfer_dtype is None else input_transfer_dtype
    host_out, faulted = None, None
    if dev.type == "cuda":
        # a thread touches the result's fresh host pages while the device
        # works; left to the download, their faults would follow the last kernel
        host_out = torch.empty(vshape, dtype=transfer_dtype)
        faulted = threading.Thread(target=_touch, args=(host_out,))
        faulted.start()
    vol = _upload(volume, in_dtype, dev)
    vol = F.pad(vol, [x for v, p in reversed(list(zip(vshape, padded))) for x in (0, p - v)])

    win, wsum = _blend_weights(padded, patch, strides, blend, dev)
    acc = torch.zeros(padded, dtype=torch.float32, device=dev)
    starts = patch_grid(vshape, patch, strides)
    batch = per_call(generate_fn, batch)
    for i in range(0, len(starts), batch):
        chunk = starts[i:i + batch]
        x = torch.stack([vol[a:a + patch[0], b:b + patch[1], c:c + patch[2]]
                         for a, b, c in chunk])[:, None]
        out = generate_fn(x)[:, 0].float() * win
        for (a, b, c), o in zip(chunk, out):
            acc[a:a + patch[0], b:b + patch[1], c:c + patch[2]].add_(o)
    out = acc / wsum
    out = out[:vshape[0], :vshape[1], :vshape[2]].to(transfer_dtype)
    if host_out is None:
        return out.cpu().numpy().astype(np.float32, copy=False)
    faulted.join()
    host_out.copy_(out)
    return host_out.numpy().astype(np.float32, copy=False)


@functools.lru_cache(maxsize=4)
def _blend_weights(padded: tuple, patch: tuple, strides: tuple, blend: str,
                   dev: torch.device):
    """(window, max(window sum, 1e-8)) on ``dev`` for a volume padded to
    ``padded``: the sum over the patch grid, added patch by patch in the
    grid's order, depends only on the geometry, so it is made once a shape."""
    win_np = gaussian_window(patch) if blend == "gaussian" else np.ones(patch, np.float32)
    with torch.inference_mode():
        win = torch.from_numpy(win_np).to(dev)
        wsum = torch.zeros(padded, dtype=torch.float32, device=dev)
        for a, b, c in patch_grid(padded, patch, strides):
            wsum[a:a + patch[0], b:b + patch[1], c:c + patch[2]] += win
        return win, wsum.clamp_min(1e-8)


def _touch(t: torch.Tensor) -> None:
    with torch.inference_mode():
        t.zero_()


_staging = threading.local()


def _upload(volume: np.ndarray, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """The volume on ``dev`` as ``dtype``. To a card it is cast into a pinned
    buffer kept for the calling thread (pages already resident) and copied
    from there; the buffer is rewritten only once its last copy has ended."""
    host = torch.from_numpy(np.ascontiguousarray(volume, np.float32))
    if dev.type != "cuda":
        return host.to(dtype).to(dev)
    key = (tuple(host.shape), dtype, dev)
    held = getattr(_staging, "held", None)
    if held is None or held[0] != key:
        held = (key, torch.empty(host.shape, dtype=dtype, pin_memory=True), torch.cuda.Event())
        _staging.held = held
    _, stage, copied = held
    copied.synchronize()
    stage.copy_(host)
    vol = stage.to(dev, non_blocking=True)
    copied.record(torch.cuda.current_stream(dev))
    return vol
