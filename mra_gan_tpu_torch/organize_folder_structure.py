"""Dataset organization CLI: ``python -m mra_gan_tpu_torch.organize_folder_structure``
(counterpart of the root organize_folder_structure.py:21-75, the reference's
offline data preparation, reference organize_folder_structure.py:143-253):
list the raw image and label NIfTIs, register each label to the reference
(the first label) and then each image to its registered label
(data/registration.py: the pyramid levels on the device, the features and
the resampling on the host), force a common spacing, and write
``<out>/train|test/images|labels/<j>.nii``.

    python -m mra_gan_tpu_torch.organize_folder_structure --images <dir> \\
        --labels <dir> [--out ./Data_folder] [--split 2] \\
        [--resolution X Y Z] [--no-register] [--iters 100] [--device cpu]

The flags and defaults are the JAX CLI's, plus ``--device`` (CUDA unless
given; without a card it raises unless given ``--device cpu``).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .core.device import resolve_device
from .data import nifti
from .data.dataset import list_nifti
from .data.registration import apply_transform, register_affine
from .data.transforms import resample_to_spacing


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images", type=str, required=True, help="directory of raw image volumes")
    p.add_argument("--labels", type=str, required=True, help="directory of raw label volumes")
    p.add_argument("--out", type=str, default="./Data_folder", help="output root")
    p.add_argument("--split", type=int, default=2, help="number of volumes held out for test")
    p.add_argument("--resolution", type=float, nargs=3, default=None,
                   help="force this voxel spacing on outputs")
    p.add_argument("--register", action="store_true", default=True,
                   help="affine-register label->reference and image->label")
    p.add_argument("--no-register", dest="register", action="store_false")
    p.add_argument("--iters", type=int, default=100, help="registration iters per pyramid level")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the registration levels: cuda or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Write the split dataset; returns one record per pair: split, index j,
    shape, and under --register the two parameter vectors (``label``: label
    -> reference, ``image``: image -> registered label) and the seconds of
    the host features, the device levels and the host resampling."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    images = list_nifti(args.images)
    labels = list_nifti(args.labels)
    if len(images) != len(labels):
        raise SystemExit(f"count mismatch: {len(images)} images vs {len(labels)} labels")
    n = len(images)
    n_train = n - args.split
    print(f"{n} pairs -> {n_train} train / {args.split} test")

    reference = nifti.load(labels[0])

    out = Path(args.out)
    records = []
    for split, lo, hi in (("train", 0, n_train), ("test", n_train, n)):
        for sub in ("images", "labels"):
            (out / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(lo, hi):
            img = nifti.load(images[i])
            lbl = nifti.load(labels[i])
            rec = {"split": split, "j": i - lo}
            if args.register:
                # label -> reference frame, then image -> registered label
                # (reference organize_folder_structure.py:199-200)
                times = {}
                p1 = register_affine(reference.data.astype(np.float32),
                                     lbl.data.astype(np.float32),
                                     iters_per_level=args.iters, device=device, times=times)
                t0 = time.perf_counter()
                lbl_data = apply_transform(lbl.data.astype(np.float32), p1,
                                           reference.data.shape[:3], device=device)
                resample_s = time.perf_counter() - t0
                lbl = nifti.NiftiImage(data=lbl_data, affine=reference.affine.copy())
                p2 = register_affine(lbl.data, img.data.astype(np.float32),
                                     iters_per_level=args.iters, device=device, times=times)
                t0 = time.perf_counter()
                img_data = apply_transform(img.data.astype(np.float32), p2,
                                           lbl.data.shape[:3], device=device)
                resample_s += time.perf_counter() - t0
                img = nifti.NiftiImage(data=img_data, affine=reference.affine.copy())
                rec.update(label=p1, image=p2, resample_s=resample_s, **times)
            if args.resolution:
                img = resample_to_spacing(img, args.resolution)
                lbl = resample_to_spacing(lbl, args.resolution)
            j = i - lo
            nifti.save(img, out / split / "images" / f"{j}.nii")
            nifti.save(lbl, out / split / "labels" / f"{j}.nii")
            print(f"[{split}] wrote pair {j} (shape {img.data.shape})")
            records.append({**rec, "shape": tuple(img.data.shape)})
    return records


if __name__ == "__main__":
    main()
