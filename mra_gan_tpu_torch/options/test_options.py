"""Flags of the decode CLI (counterpart of mra_gan_tpu/options/test_options.py
plus the base options the decode reads, base_options.py).

Same flag names and defaults as the JAX package's ``TestOptions``, plus
``--device``. Flags of paths that are not ported yet are accepted where the
JAX CLI has them and refused by the CLI when set (see ROADMAP Queue A).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mra_gan_tpu_torch.test",
        description="Full-volume CycleGAN decode of NIfTI volumes on one GPU.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--image", type=str, default="./Data_folder/test/images/0.nii",
                   help="input volume (.nii/.nii.gz), or a DIRECTORY of volumes "
                        "to decode in batch")
    p.add_argument("--result", type=str, default="./result.nii",
                   help="path of the .nii result (a directory when --image is one)")
    p.add_argument("--checkpoints_dir", type=str, default="./checkpoints",
                   help="models are read from <checkpoints_dir>/<name>/")
    p.add_argument("--name", type=str, default="experiment_name",
                   help="experiment name (models directory)")
    p.add_argument("--which_epoch", type=str, default="latest",
                   help="which checkpoint epoch to load: "
                        "<which_epoch>_net_G_{A|B}.pth")
    p.add_argument("--model_suffix", type=str, default="_A", choices=["_A", "_B"],
                   help="_A decodes with G_A (A->B), _B with G_B (B->A)")
    p.add_argument("--input_nc", type=int, default=1, help="# of input image channels")
    p.add_argument("--output_nc", type=int, default=1, help="# of output image channels")
    p.add_argument("--ngf", type=int, default=32, help="# of gen filters in first conv layer")
    p.add_argument("--netG", type=str, default="resnet_6blocks",
                   help="generator: resnet_6blocks | resnet_9blocks")
    p.add_argument("--norm", type=str, default="instance", help="instance")
    p.add_argument("--no_dropout", action="store_true",
                   help="no dropout for the generator (the checkpoint's keys "
                        "decide the layout; dropout is off at inference)")
    p.add_argument("--init_type", type=str, default="normal",
                   help="normal | xavier | kaiming | orthogonal")
    p.add_argument("--init_gain", type=float, default=0.02,
                   help="scaling factor for normal, xavier and orthogonal")
    p.add_argument("--patch_size", type=int, nargs=3, default=[64, 64, 64],
                   help="sliding-window patch size (X Y Z)")
    p.add_argument("--stride_inplane", type=int, default=32,
                   help="sliding-window stride in the XY plane")
    p.add_argument("--stride_layer", type=int, default=32,
                   help="sliding-window stride along Z")
    p.add_argument("--blend", type=str, default="gaussian", choices=["gaussian", "uniform"],
                   help="patch overlap blending window")
    p.add_argument("--decode_batch", type=int, default=8,
                   help="patches decoded per generator call")
    p.add_argument("--single_pass", action="store_true",
                   help="decode the WHOLE volume in one generator forward "
                        "(no patching, no seams; needs the activations to fit)")
    p.add_argument("--pad_mode", type=str, default="reference",
                   choices=["reference", "symmetric"],
                   help="sub-patch volume padding: 'reference' zero-extends at the "
                        "high side; 'symmetric' centres the content")
    p.add_argument("--resample", action="store_true",
                   help="resample to --new_resolution before decoding")
    p.add_argument("--new_resolution", type=float, nargs=3, default=[1.0, 1.0, 1.0],
                   help="new spacing for --resample")
    p.add_argument("--precision", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"], help="compute precision policy")
    p.add_argument("--wire", type=str, default="exact", choices=["exact", "f32", "f16"],
                   help="host<->device precision: 'exact' uploads in the compute "
                        "dtype and downloads float32 (only 'exact' is ported)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default) or, explicitly, on the CPU")
    return p


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)
