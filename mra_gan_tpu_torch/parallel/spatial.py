"""Whole-volume forward on one device (counterpart of
mra_gan_tpu/parallel/spatial.py:164 ``single_pass_apply``). The sharded
variants come with the parallelism work (ROADMAP Queue A, parallelism)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.networks import spatial_granularity

# JAX _DECODE_ADVICE (spatial.py:138-140); the port has no --spatial_shard yet
DECODE_ADVICE = ("decode it with the sliding-window decoder (the default decode "
                 "mode, which streams fixed-size patches); sharding the whole volume "
                 "across devices (--spatial_shard) is not ported yet")


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
        x = F.pad(x, [v for p in reversed(pads) for v in (0, p)], mode="replicate")
        out = generate_fn(x)[0, 0, :shp[0], :shp[1], :shp[2]]
        return out.float().cpu().numpy()
    except torch.cuda.OutOfMemoryError:
        pass  # answered below, outside the handler: its traceback holds the forward's tensors
    x = out = None  # drop the forward's tensors before the cache is emptied
    torch.cuda.empty_cache()
    raise RuntimeError(f"single-pass decode of the {tuple(shp)} volume does not fit the "
                       f"device memory; {DECODE_ADVICE}")
