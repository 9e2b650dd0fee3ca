"""Whole-volume and parallel decodes, the depth-sharded train step and the
halo-exchange conv (counterpart of mra_gan_tpu/parallel/spatial.py).

- ``single_pass_apply`` (JAX :164): one forward over a whole volume on one
  device.
- ``sharded_generator_apply`` (JAX :215): the same forward with the volume
  depth-sharded over the ranks of a mesh axis: halo convs and whole-volume
  norm statistics (core/spatial_ctx.py), for a volume too large for one
  card's activations.
- ``sharded_sliding_window`` (JAX :33): the sliding-window decode with the
  patches dealt round-robin over the ranks, each rank blending into its own
  accumulators, one all-reduce of the two at the end.
- ``shard_spatial_state`` and ``make_spatial_train_step`` (JAX :261, :299):
  the CycleGAN step with every volume depth-sharded, alone or on a 2-D data
  x space grid.
- ``halo_conv3d`` (JAX :388): a 'same' conv over a depth-sharded volume.

Every rank runs the same calls in the same order; the volumes and batches
are the global ones on every rank, and each rank takes its part (a training
batch on the 2-D grid may instead hold only the rank's rows, as the driver's
rank view loads them; ``take`` then cuts the depth shard alone).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mesh import DATA_AXIS, SPACE_AXIS, Mesh
from ..core.spatial_ctx import spatial_sharding
from ..infer.sliding_window import gaussian_window, patch_grid, per_call
from ..models.networks import ResnetGenerator3D, granularity, spatial_granularity
from ..ops.conv import conv3d
from ..ops.kernels.replication_pad import replication_pad_fwd
from .collectives import all_gather_stacked, all_reduce_, neighbour_exchange
from .sharding import data_rows, shard_state

# JAX _DECODE_ADVICE (spatial.py:138-140)
DECODE_ADVICE = ("decode it with the sliding-window decoder (default "
                 "test.py mode — streams fixed-size patches) or shard the "
                 "whole volume across a mesh with --spatial_shard")


@torch.inference_mode()
def single_pass_apply(generate_fn, volume: np.ndarray) -> np.ndarray:
    """Edge-pad each dim of the (X, Y, Z) volume to the generator's stride
    granularity, run one forward over the whole volume (no patches, no
    seams, instance-norm statistics over the full volume) and crop back.
    generate_fn: a models.cycle_gan.GenerateFn. Returns float32 (X, Y, Z).

    A volume whose forward does not fit the device memory raises
    RuntimeError with the advice to decode it with the sliding window, after
    the allocator's cache is emptied, so that the caller (the directory
    decode) can go on with other volumes (JAX spatial.py:179-195 refuses it
    from the compiler's estimate before the run)."""
    shp = volume.shape
    pads = [(-s) % g for s, g in zip(shp, spatial_granularity(generate_fn.net))]
    host = torch.from_numpy(np.ascontiguousarray(volume, np.float32)).to(generate_fn.dtype)
    try:
        x = host.to(generate_fn.device)[None, None]
        if any(pads):
            x = replication_pad_fwd(x, (0, pads[0], 0, pads[1], 0, pads[2]))
        out = generate_fn(x)[0, 0, :shp[0], :shp[1], :shp[2]]
        return out.float().cpu().numpy()
    except torch.cuda.OutOfMemoryError:
        pass  # answered below, outside the handler: its traceback holds the forward's tensors
    x = out = None  # drop the forward's tensors before the cache is emptied
    torch.cuda.empty_cache()
    raise RuntimeError(f"single-pass decode of the {tuple(shp)} volume does not fit the "
                       f"device memory; {DECODE_ADVICE}")


def spatial_depth_rule(net) -> Tuple[Tuple[int, int, int], int]:
    """(per-axis granularity, minimum shard depth) a depth-sharded forward
    of ``net`` (a generator, or a CycleGANConfig naming one) needs: the
    shard depth D/n must divide by g[0] and be >= the minimum (4 for resnet,
    whose 7^3 stem reaches 3 rows across a shard boundary; g[0] otherwise).
    The one rule of the CLIs, ``sharded_generator_apply`` and
    ``make_spatial_train_step`` (JAX spatial.py:200)."""
    if isinstance(net, torch.nn.Module):
        g, resnet = spatial_granularity(net), isinstance(net, ResnetGenerator3D)
    else:  # a config: the rule without building the network
        g = granularity(net.net_g, net.dynet_sizes, net.dynet_spacings)
        resnet = net.net_g.startswith("resnet")
    return tuple(g), (4 if resnet else g[0])


def _rank_slice(size: int, parts: int, index: int) -> slice:
    step = size // parts
    return slice(index * step, (index + 1) * step)


@torch.inference_mode()
def sharded_generator_apply(mesh: Mesh, generate_fn, volume: np.ndarray,
                            axis_name: str = DATA_AXIS) -> np.ndarray:
    """One forward over the (D, H, W) volume, depth-sharded over the ranks
    of ``axis_name``: rank r runs depth rows [r D/n, (r + 1) D/n) with halo
    convs and whole-volume norm statistics, and the output shards are
    all-gathered, so every rank returns the whole float32 (D, H, W) result,
    the unsharded forward's up to the order of the statistics' sums. The
    shard depth must divide by the net's depth granularity and be >= its
    minimum (``spatial_depth_rule``), H and W by the in-plane granularity;
    the JAX package asserts, the port raises ValueError. generate_fn: a
    models.cycle_gan.GenerateFn on this rank's device."""
    axis = mesh.axis(axis_name)
    n, d = axis.size, volume.shape[0]
    g, min_shard = spatial_depth_rule(generate_fn.net)
    if d % n or (d // n) % g[0] or d // n < min_shard:
        raise ValueError(f"depth {d} over {n} devices needs shard depth divisible by {g[0]} "
                         f"and >= {min_shard}")
    if volume.shape[1] % g[1] or volume.shape[2] % g[2]:
        raise ValueError(f"in-plane dims {volume.shape[1:]} must be divisible by {g[1:]} "
                         f"(pad with edge values first)")
    shard = np.ascontiguousarray(volume[_rank_slice(d, n, axis.index)], np.float32)
    x = torch.from_numpy(shard).to(generate_fn.dtype)[None, None]
    with spatial_sharding(axis):
        y = generate_fn(x)[0, 0].float()
    return torch.cat(all_gather_stacked(y, axis.group).unbind(0)).cpu().numpy()


@torch.inference_mode()
def sharded_sliding_window(mesh: Mesh, volume: np.ndarray, generate_fn,
                           patch_size: Sequence[int] = (64, 64, 64), stride_inplane: int = 32,
                           stride_layer: int = 32, blend: str = "gaussian",
                           batch: int = 1) -> np.ndarray:
    """The sliding-window decode (infer/sliding_window.py) over the ranks of
    the mesh's data axis. The grid of patch starts, padded with copies of
    the last start to a whole number of ``batch`` x ranks, is dealt
    round-robin: step t's chunk of ``batch`` entries r goes to rank r. Each
    rank blends its patches into its own float32 accumulators (a padding
    entry weighs 0, so it is not run at all), one all-reduce adds the
    accumulators, and every rank returns acc / max(wsum, 1e-8), float32
    (X, Y, Z). As in the one-device window, a generator that holds a batch
    norm takes one patch a call, so the output does not depend on
    ``batch``: under --norm batch it is JAX's at one patch per device, its
    CLI's default."""
    if blend not in ("gaussian", "uniform"):
        raise ValueError(f"unknown blend {blend!r}")
    axis = mesh.axis(DATA_AXIS)
    n_dev = axis.size
    patch = tuple(int(p) for p in patch_size)
    strides = (int(stride_inplane), int(stride_inplane), int(stride_layer))
    dev = generate_fn.device
    vshape = volume.shape
    padded = [max(v, p) for v, p in zip(vshape, patch)]
    host = torch.from_numpy(np.ascontiguousarray(volume, np.float32)).to(generate_fn.dtype)
    vol = F.pad(host.to(dev), [x for v, p in reversed(list(zip(vshape, padded)))
                               for x in (0, p - v)])
    starts = patch_grid(vshape, patch, strides)
    batch = per_call(generate_fn, batch)
    per_step = batch * n_dev
    n_steps = -(-len(starts) // per_step)
    mine = [starts[t * per_step + axis.index * batch + i]
            for t in range(n_steps) for i in range(batch)
            if t * per_step + axis.index * batch + i < len(starts)]
    win_np = gaussian_window(patch) if blend == "gaussian" else np.ones(patch, np.float32)
    win = torch.from_numpy(win_np).to(dev)
    acc = torch.zeros(padded, dtype=torch.float32, device=dev)
    wsum = torch.zeros(padded, dtype=torch.float32, device=dev)
    for i in range(0, len(mine), batch):
        chunk = mine[i:i + batch]
        x = torch.stack([vol[a:a + patch[0], b:b + patch[1], c:c + patch[2]]
                         for a, b, c in chunk])[:, None]
        out = generate_fn(x)[:, 0].float() * win
        for (a, b, c), o in zip(chunk, out):
            acc[a:a + patch[0], b:b + patch[1], c:c + patch[2]] += o
            wsum[a:a + patch[0], b:b + patch[1], c:c + patch[2]] += win
    both = torch.stack([acc, wsum])
    all_reduce_(both, axis.group)
    out = both[0] / both[1].clamp_min(1e-8)
    return out[:vshape[0], :vshape[1], :vshape[2]].cpu().numpy()


def shard_spatial_state(state, mesh: Mesh, axis_name: str = SPACE_AXIS):
    """Ready a state made by ``create_state`` (every rank the same config,
    seed and patch) for ``make_spatial_train_step``: rank 0's state is
    broadcast (``sharding.shard_state``), and each pool keeps this rank's
    depth shard of its images (JAX :261; the port's pools have one
    layout). Checkpoints gather the pools back (checkpoint/manager.py), so
    a sharded run saves in the one-device format. In place; returns it."""
    axis = mesh.axis(axis_name)
    shard_state(state, mesh)
    for pool in (state.pool_fake_a, state.pool_fake_b):
        rows = _rank_slice(pool.images.shape[2], axis.size, axis.index)
        pool.images = pool.images[:, :, rows].clone()
    state.pool_shard = axis
    return state


def make_spatial_train_step(cfg, mesh: Mesh, axis_name: str = SPACE_AXIS,
                            data_axis: Optional[str] = None):
    """The CycleGAN step with every volume depth-sharded over ``axis_name``
    (JAX :299), and with ``data_axis`` the batch split over that axis too
    (the 2-D data x space grid). Returns (step, take): ``take(x)`` checks a
    global (B, C, D, H, W) batch and returns this rank's rows and depth
    shard of it, and ``take(x, local=True)`` the depth shard of a batch that
    already holds only this rank's rows (a rank view's, data/dataset.py),
    checked as the global batch it is part of; ``step(state, real_a,
    real_b, lr, pool_draws=None)`` takes
    those parts and a state readied by ``shard_spatial_state``, and returns
    (state, the global metrics). JAX's three ValueErrors: a shard depth that
    the generator's granularity or minimum does not allow, an in-plane size
    it does not divide, a batch the data axis does not divide. Dropout is
    refused: equal masks per shard would repeat along depth."""
    from ..models.cycle_gan import make_train_step

    if not cfg.no_dropout:
        raise ValueError("spatial train step requires no_dropout")
    sp = mesh.axis(axis_name)
    dp = mesh.axis(data_axis) if data_axis else None
    n, nd = sp.size, (dp.size if dp else 1)
    g, min_shard = spatial_depth_rule(cfg)
    base = make_train_step(cfg)

    def check(shape):
        d = shape[2]
        if d % n or (d // n) % g[0] or d // n < min_shard:
            raise ValueError(f"spatial step over {n} devices needs patch depth with shard "
                             f"depth (D/{n}) divisible by {g[0]} and >= {min_shard}, got D={d}")
        if shape[3] % g[1] or shape[4] % g[2]:
            raise ValueError(f"patch in-plane dims {tuple(shape[3:5])} must be divisible by "
                             f"{g[1:]} for {cfg.net_g}")
        if shape[0] % nd:
            raise ValueError(f"batch {shape[0]} not divisible by the data-axis size {nd}")

    def take(x: Union[torch.Tensor, np.ndarray], local: bool = False):
        check((x.shape[0] * nd, *x.shape[1:]) if local else x.shape)
        rows = data_rows(x.shape[0], dp) if dp and not local else slice(None)
        return x[rows][:, :, _rank_slice(x.shape[2], n, sp.index)]

    def step(state, real_a, real_b, lr, pool_draws=None):
        check((real_a.shape[0] * nd, real_a.shape[1], real_a.shape[2] * n,
               *real_a.shape[3:]))
        with spatial_sharding(sp, dp, rows=real_a.shape[0]):
            return base(state, real_a, real_b, lr, pool_draws)

    return step, take


def halo_conv3d(mesh: Mesh, x_shard: torch.Tensor, weight: torch.Tensor,
                axis_name: str = DATA_AXIS) -> torch.Tensor:
    """'Same' zero-padded stride-1 conv of a depth-sharded (N, Cin, D/n, H,
    W) volume with weight (Cout, Cin, kd, kh, kw) (JAX :388): each rank
    takes (kd - 1) // 2 halo rows from each neighbour (zeros at the ends)
    and convolves its extended shard; no rank holds the whole volume."""
    axis = mesh.axis(axis_name)
    kd, kh, kw = weight.shape[2:]
    ext = neighbour_exchange(x_shard, (kd - 1) // 2, (kd - 1) // 2, "zero", axis.group)
    return conv3d(ext, weight, None, 1, (0, (kh - 1) // 2, (kw - 1) // 2))
