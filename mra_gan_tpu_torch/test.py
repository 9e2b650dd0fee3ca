"""Decode CLI: ``python -m mra_gan_tpu_torch.test`` (counterpart of the JAX
package's ``test.py``:37-260).

read NIfTI -> 0-255 rescale -> optional resample -> pad to the patch size
(and an odd Z edge-padded to even, as the reference does) -> [-1, 1] ->
sliding-window decode on the GPU (or one whole-volume forward under
--single_pass) -> [0, 255] -> crop, resample back -> write the NIfTI in the
original physical space.

The generator comes from ``<checkpoints_dir>/<name>/<which_epoch>_net_G_A.pth``
(``_B`` under --model_suffix _B): the reference's file naming, which the
port's ``CheckpointManager.save`` writes beside every checkpoint, and
``convert_checkpoint.py --to_torch`` (either package's) from a checkpoint.
With --image a directory, every .nii/.nii.gz in it is decoded into the
--result directory with one loaded generator, its host IO overlapped with
the decode as the JAX CLI does (test.py:206-260): one IO thread reads the
next volume while the current one decodes, the other writes the results
behind it, at most four pending. A volume that cannot be read, decoded or
written is reported and skipped, and the rest still decode.

--wire sets the precision on the host-device wire of the sliding-window
decode (JAX test.py:135-155): 'exact' uploads in the compute dtype and
downloads float32, 'f32' is float32 both ways, 'f16' uploads in the compute
dtype and downloads float16.

Over several ranks (``torchrun --nproc_per_node R -m mra_gan_tpu_torch.test
... --spatial_shard``, NCCL, one card each; or ranks whose process group the
caller joined first, as the tests and ``chip_smoke.py`` do over gloo),
--spatial_shard edge-pads the volume to (g[0] R, g[1], g[2]) and runs one
forward depth-sharded over the ranks (``sharded_generator_apply``), and
--data_parallel deals the sliding window's patches over them
(``sharded_sliding_window``); every rank decodes and only rank 0 writes.
With one rank both fall through to the one-device decode, as the JAX CLI's
``len(jax.devices()) > 1`` guard does (JAX test.py:109-133).
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .checkpoint.io import has_dropout_layout, read_reference_pth
from .checkpoint.manager import is_writer
from .core.device import resolve_device
from .core.dtypes import compute_dtype
from .core.mesh import Mesh, distributed_world, init_distributed, make_mesh
from .data import nifti
from .data.transforms import (
    from_tanh_range,
    pad_to_size,
    resample_to_reference,
    resample_to_spacing,
    rescale_0_255,
    to_tanh_range,
)
from .infer.sliding_window import sliding_window_inference
from .models.cycle_gan import CycleGANConfig, GenerateFn, make_generate_fn
from .models.networks import check_patch, spatial_granularity
from .options.test_options import parse
from .parallel.spatial import (
    sharded_generator_apply,
    sharded_sliding_window,
    single_pass_apply,
)


def checkpoint_path(opt: argparse.Namespace) -> Path:
    return (Path(opt.checkpoints_dir) / opt.name
            / f"{opt.which_epoch}_net_G{opt.model_suffix}.pth")


def load_generator(opt: argparse.Namespace) -> GenerateFn:
    """The requested generator on ``opt.device``, weights strict-loaded from
    its reference ``.pth``. Dropout is identity at inference, so the
    checkpoint's keys (a residual block's second conv at ``conv_block.6``
    with dropout, ``.5`` without) decide which layout is built."""
    device = resolve_device(opt.device)
    state = read_reference_pth(checkpoint_path(opt))
    use_dropout = has_dropout_layout(state)
    cfg = CycleGANConfig(input_nc=opt.input_nc, output_nc=opt.output_nc, ngf=opt.ngf,
                         net_g=opt.netG, norm=opt.norm, no_dropout=not use_dropout,
                         init_type=opt.init_type, init_gain=opt.init_gain,
                         dtype=compute_dtype(opt.precision),
                         dynet_sizes=tuple(opt.dynet_sizes),
                         dynet_spacings=tuple(opt.dynet_spacings))
    which = {"_A": "g_a", "_B": "g_b"}[opt.model_suffix]
    gen = make_generate_fn(cfg, which, device)
    gen.net.load_state_dict(state, strict=True)
    return gen


# results written behind the decode at most, in directory mode and in the
# serving daemon (each holds a whole float volume)
MAX_PENDING_WRITES = 4
# --wire: (download dtype, upload dtype or None for the compute dtype)
WIRE = {"exact": (torch.float32, None), "f32": (torch.float32, torch.float32),
        "f16": (torch.float16, None)}


def inference(opt: argparse.Namespace, gen: Optional[GenerateFn] = None, img=None,
              save_pool=None, save_futures=None, save: bool = True,
              mesh: Optional[Mesh] = None) -> nifti.NiftiImage:
    """Decode ``opt.image`` (or ``img``, a NiftiImage already read) with
    ``gen`` (loaded from ``opt`` when None) and return the result. With
    ``save``, write it to ``opt.result``: in this thread, or, given
    ``save_pool`` (an executor), as a task whose (path, future) pair is
    appended to ``save_futures`` for the caller to collect. Given a ``mesh``
    of several ranks, --spatial_shard and --data_parallel decode over it;
    every rank returns the result and only rank 0 saves it."""
    if gen is None:
        gen = load_generator(opt)
    patch = tuple(int(p) for p in opt.patch_size)
    if img is None:
        img = nifti.load(opt.image)
    original = img
    work = nifti.NiftiImage(data=rescale_0_255(img.data), affine=img.affine)
    if opt.resample:
        work = resample_to_spacing(work, opt.new_resolution, "bspline")
    pre_pad_shape = work.data.shape
    pad_where = "end" if opt.pad_mode == "reference" else "symmetric"
    fronts = [0, 0, 0]
    if pad_where == "symmetric":
        fronts = [max(0, patch[a] - pre_pad_shape[a]) // 2 for a in range(3)]
    vol = pad_to_size(work.data, patch, where=pad_where)
    # the reference edge-pads an odd Z to even before building the patch grid
    # and crops the extra slice after decoding (reference test.py:96-103)
    if pad_where == "end" and vol.shape[2] % 2 == 1:
        vol = np.pad(vol, ((0, 0), (0, 0), (0, 1)), mode="edge")
    vol = to_tanh_range(vol)

    t0 = time.perf_counter()
    if opt.single_pass:
        out = single_pass_apply(gen, vol)
        mode = "single-pass"
    elif opt.spatial_shard and mesh is not None:
        # one whole-volume forward, depth-sharded over the ranks (JAX
        # test.py:113-128): edge-pad to (g[0] * ranks, g[1], g[2])
        shp, g = vol.shape, spatial_granularity(gen.net)
        mult = (g[0] * mesh.data, g[1], g[2])
        volp = np.pad(vol, [(0, -n % m) for n, m in zip(shp, mult)], mode="edge")
        out = sharded_generator_apply(mesh, gen, volp)[:shp[0], :shp[1], :shp[2]]
        mode = "sharded single-pass"
    elif opt.data_parallel and mesh is not None:
        out = sharded_sliding_window(mesh, vol, gen, patch_size=patch,
                                     stride_inplane=opt.stride_inplane,
                                     stride_layer=opt.stride_layer, blend=opt.blend,
                                     batch=opt.decode_batch)
        mode = "sharded sliding-window"
    else:
        down, up = WIRE[opt.wire]
        out = sliding_window_inference(vol, gen, patch_size=patch,
                                       stride_inplane=opt.stride_inplane,
                                       stride_layer=opt.stride_layer, blend=opt.blend,
                                       batch=opt.decode_batch, transfer_dtype=down,
                                       input_transfer_dtype=up)
        mode = "sliding-window"
    print(f"{mode} decode: {time.perf_counter() - t0:.2f}s "
          f"({vol.shape} vol, {patch} patches, {gen.device})")
    out = from_tanh_range(out)

    out = out[fronts[0]: fronts[0] + pre_pad_shape[0],
              fronts[1]: fronts[1] + pre_pad_shape[1],
              fronts[2]: fronts[2] + pre_pad_shape[2]]
    result = nifti.NiftiImage(data=np.asarray(out, np.float32), affine=work.affine)
    if opt.resample:
        result = resample_to_reference(result, original, "bspline")
    save = save and is_writer()
    if save and save_pool is not None:
        save_futures.append((opt.result, save_pool.submit(nifti.save, result, opt.result)))
    elif save:
        nifti.save(result, opt.result)
        print(f"wrote {opt.result}")
    return result


def refuse_unported(opt: argparse.Namespace) -> None:
    """The JAX package's ValueError for a U-Net patch smaller than the
    net's depth allows."""
    check_patch(opt.netG, opt.patch_size)


def decode_mesh(opt: argparse.Namespace) -> Optional[Mesh]:
    """The ranks' mesh (all on the data axis) when --spatial_shard or
    --data_parallel is given and the process group has several ranks,
    joining torchrun's group if the caller has joined none; else None, and
    the decode is the one-device one."""
    if not (opt.spatial_shard or opt.data_parallel) or distributed_world() <= 1:
        return None
    init_distributed(opt.device)
    return make_mesh()


def decode_directory(opt: argparse.Namespace, gen: GenerateFn,
                     mesh: Optional[Mesh] = None) -> List[str]:
    """Decode every .nii/.nii.gz of the directory ``opt.image`` into the
    directory ``opt.result`` under its own name; returns the names skipped.
    Two IO threads overlap the host's work with the decode: one reads the
    next volume while this one decodes, the other writes results behind it.
    More than MAX_PENDING_WRITES writes in flight block the loop until the
    oldest lands, since each holds a whole float volume."""
    img_path, out_dir = Path(opt.image), Path(opt.result)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in img_path.iterdir() if p.name.endswith((".nii", ".nii.gz")))
    if not files:
        raise SystemExit(f"no .nii/.nii.gz files in {img_path}")
    failed = []
    save_futures = []

    def finish_save(res_path, fut):
        try:
            fut.result()
            print(f"wrote {res_path}")
        except Exception as e:
            print(f"FAILED WRITE {res_path}: {type(e).__name__}: {e}")
            failed.append(Path(res_path).name)

    def drain_saves(block: bool):
        remaining = []
        for res_path, fut in save_futures:
            if not block and not fut.done():
                remaining.append((res_path, fut))
                continue
            finish_save(res_path, fut)
        while not block and len(remaining) > MAX_PENDING_WRITES:
            finish_save(*remaining.pop(0))
        save_futures[:] = remaining

    with ThreadPoolExecutor(max_workers=2) as io_pool:
        next_img, next_idx = io_pool.submit(nifti.load, str(files[0])), 0
        for i, p in enumerate(files):
            sub = argparse.Namespace(**vars(opt))
            sub.image, sub.result = str(p), str(out_dir / p.name)
            try:
                img = next_img.result() if next_idx == i else nifti.load(str(p))
                if i + 1 < len(files):
                    next_img, next_idx = io_pool.submit(nifti.load, str(files[i + 1])), i + 1
                inference(sub, gen, img=img, save_pool=io_pool, save_futures=save_futures,
                          mesh=mesh)
            except Exception as e:
                # one volume that cannot be read or decoded (a truncated file,
                # an unsupported datatype, a CUDA OOM): report it and go on
                # with the rest, as the JAX CLI does (test.py:252-258)
                print(f"SKIPPED {p.name}: {type(e).__name__}: {e}")
                failed.append(p.name)
            drain_saves(block=False)
        drain_saves(block=True)
    if failed:
        print(f"{len(failed)}/{len(files)} volumes skipped: " + ", ".join(failed))
    return failed


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Returns the names of the volumes skipped in directory mode; run as a
    script, the exit code is 1 if there were any."""
    opt = parse(argv)
    refuse_unported(opt)
    mesh = decode_mesh(opt)
    gen = load_generator(opt)
    if not Path(opt.image).is_dir():
        inference(opt, gen, mesh=mesh)
        return []
    return decode_directory(opt, gen, mesh)


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
