"""Evaluation CLI: ``python -m mra_gan_tpu_torch.evaluate`` (counterpart of
the JAX package's ``evaluate.py``). SSIM, PSNR, MAE and Pearson r between a
synthesized volume and its target, computed on ``--device``:

    python -m mra_gan_tpu_torch.evaluate --pred fake_B.nii --target real_B.nii [--mask-fg]
    python -m mra_gan_tpu_torch.evaluate --pred fakes_dir/ --target reals_dir/

With directories, pairs are matched by file name (modulo .nii/.nii.gz), one
JSON line is printed per pair and a last one for the ``mean``; files without
a counterpart are named on stderr and left out of the mean. A prediction on
another grid than its target is resampled onto the target's first.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .core.device import resolve_device
from .data import nifti
from .data.transforms import resample_to_reference
from .utils.metrics import volume_metrics


def _evaluate_pair(pred_path, targ_path, mask_fg: bool, device: torch.device) -> dict:
    pred = nifti.load(pred_path)
    targ = nifti.load(targ_path)
    if pred.data.shape != targ.data.shape:
        pred = resample_to_reference(pred, targ)
    a = torch.from_numpy(np.ascontiguousarray(pred.data, np.float32)).to(device)
    b = torch.from_numpy(np.ascontiguousarray(targ.data, np.float32)).to(device)
    out = volume_metrics(a, b, mask=(b > 0) if mask_fg else None, use_mask=mask_fg)
    return {k: float(v) for k, v in out.items()}


def _stem(name: str) -> str:
    return name[:-7] if name.endswith(".nii.gz") else name[:-4]


def _index(d: Path) -> dict:
    out = {}
    for f in sorted(d.iterdir()):
        if not f.name.endswith((".nii", ".nii.gz")):
            continue
        stem = _stem(f.name)
        if stem in out:
            raise SystemExit(f"ambiguous pair in {d}: {out[stem].name} and {f.name} share "
                             f"the basename {stem!r}")
        out[stem] = f
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mra_gan_tpu_torch.evaluate",
                                description="SSIM / PSNR / MAE / Pearson r between volumes.")
    p.add_argument("--pred", required=True,
                   help="synthesized volume (.nii), or a directory of them")
    p.add_argument("--target", required=True,
                   help="reference volume (.nii), or a directory (pairs matched by filename)")
    p.add_argument("--mask-fg", action="store_true",
                   help="restrict intensity metrics to target>0 foreground")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="compute on the GPU (default) or, explicitly, on the CPU")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Prints the JSON lines and returns the single pair's metrics, or the
    directory's mean."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pred_path, targ_path = Path(args.pred), Path(args.target)
    if not pred_path.is_dir():
        out = _evaluate_pair(pred_path, targ_path, args.mask_fg, device)
        print(json.dumps(out))
        return out
    preds, targs = _index(pred_path), _index(targ_path)
    stems = sorted(preds.keys() & targs.keys())
    for side, only in (("prediction", sorted(preds.keys() - targs.keys())),
                       ("target", sorted(targs.keys() - preds.keys()))):
        if only:
            print(f"WARNING: {len(only)} {side} file(s) without a counterpart, excluded "
                  f"from the mean: {', '.join(only[:10])}{' ...' if len(only) > 10 else ''}",
                  file=sys.stderr)
    if not stems:
        raise SystemExit(f"no matching .nii pairs between {pred_path} and {targ_path}")
    rows = []
    for s in stems:
        row = _evaluate_pair(preds[s], targs[s], args.mask_fg, device)
        print(json.dumps({"file": preds[s].name, **row}))
        rows.append(row)
    out = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    print(json.dumps({"file": "mean", **out}))
    return out


if __name__ == "__main__":
    main()
