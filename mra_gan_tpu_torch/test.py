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
--result directory with one loaded generator; a volume that fails is
reported and skipped, and the rest still decode.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .checkpoint.io import read_reference_pth
from .core.device import resolve_device
from .core.dtypes import compute_dtype
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
from .options.test_options import parse
from .parallel.spatial import single_pass_apply


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
    use_dropout = any(k.endswith(".conv_block.6.weight") for k in state)
    cfg = CycleGANConfig(input_nc=opt.input_nc, output_nc=opt.output_nc, ngf=opt.ngf,
                         net_g=opt.netG, norm=opt.norm, no_dropout=not use_dropout,
                         init_type=opt.init_type, init_gain=opt.init_gain,
                         dtype=compute_dtype(opt.precision))
    which = {"_A": "g_a", "_B": "g_b"}[opt.model_suffix]
    gen = make_generate_fn(cfg, which, device)
    gen.net.load_state_dict(state, strict=True)
    return gen


def inference(opt: argparse.Namespace, gen: GenerateFn, save: bool = True) -> nifti.NiftiImage:
    """Decode the volume ``opt.image`` and, with ``save``, write it to
    ``opt.result``."""
    patch = tuple(int(p) for p in opt.patch_size)
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
    else:
        out = sliding_window_inference(vol, gen, patch_size=patch,
                                       stride_inplane=opt.stride_inplane,
                                       stride_layer=opt.stride_layer, blend=opt.blend,
                                       batch=opt.decode_batch)
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
    if save:
        nifti.save(result, opt.result)
        print(f"wrote {opt.result}")
    return result


def refuse_unported(opt: argparse.Namespace) -> None:
    """NotImplementedError, naming its ROADMAP item, for a flag that selects
    a path the port does not have yet (an unported --netG or --norm raises
    where the generator is built)."""
    for flag in ("spatial_shard", "data_parallel", "spatial_parallel"):
        if getattr(opt, flag):
            raise NotImplementedError(f"--{flag} is not ported yet; see ROADMAP Queue A, "
                                      f"parallelism")
    if opt.wire != "exact":
        raise NotImplementedError(f"--wire {opt.wire} is not ported yet; see ROADMAP "
                                  f"Queue A, options and drivers")


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Returns the names of the volumes skipped in directory mode; run as a
    script, the exit code is 1 if there were any."""
    opt = parse(argv)
    refuse_unported(opt)
    gen = load_generator(opt)
    img_path = Path(opt.image)
    if not img_path.is_dir():
        inference(opt, gen)
        return []
    out_dir = Path(opt.result)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in img_path.iterdir() if p.name.endswith((".nii", ".nii.gz")))
    if not files:
        raise SystemExit(f"no .nii/.nii.gz files in {img_path}")
    failed = []
    for p in files:
        sub = argparse.Namespace(**vars(opt))
        sub.image, sub.result = str(p), str(out_dir / p.name)
        try:
            inference(sub, gen)
        except Exception as e:
            # one volume that cannot be read, decoded or written (a truncated
            # file, an unsupported datatype, a CUDA OOM): report it and go on
            # with the rest, as the JAX CLI does (test.py:252-258)
            print(f"SKIPPED {p.name}: {type(e).__name__}: {e}")
            failed.append(p.name)
    if failed:
        print(f"{len(failed)}/{len(files)} volumes skipped: " + ", ".join(failed))
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
