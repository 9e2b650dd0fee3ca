"""Flags of the decode CLI (counterpart of mra_gan_tpu/options/test_options.py
and base_options.py:27-107, with the 'test' model's --model_suffix).

Every flag of the JAX package's decode parser, with its default, plus
``--device``. ``--suffix`` renames the run directory as the JAX parse does
(base_options.py:145-146). Flags that a one-GPU decode has no use for
(training data, loader, discriminator and seed flags, ``--gpu_ids``) are
accepted and ignored, as the JAX decode ignores them. ``--spatial_shard``
and ``--data_parallel`` split the decode over the ranks of a process group
(torchrun's, or one the caller joined); ``--spatial_parallel`` and
``--space_devices`` are training flags the decode accepts and ignores, as
the JAX decode does.
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
                   help="generator: resnet_9blocks | resnet_6blocks | unet_custom | "
                        "unet_128 | unet_256 | Dynet")
    p.add_argument("--norm", type=str, default="instance", help="instance | batch | none")
    p.add_argument("--dynet_sizes", type=int, nargs=3, default=[128, 128, 64],
                   help="Dynet auto-schedule input sizes (as the run was trained with)")
    p.add_argument("--dynet_spacings", type=float, nargs=3, default=[1.5, 1.5, 1.5],
                   help="Dynet auto-schedule voxel spacings")
    p.add_argument("--no_dropout", action="store_true", default=True,
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
                   help="patches decoded per generator call in the sliding-window "
                        "decodes (one device and --data_parallel); a --norm batch "
                        "generator decodes one a call, the reference's batch of 1, "
                        "so only the amortization changes")
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
                   help="host<->device precision of the sliding-window decode: "
                        "'exact' uploads in the compute dtype and downloads float32; "
                        "'f32' is float32 both ways; 'f16' uploads in the compute "
                        "dtype and downloads float16 (~5e-4 on [-1, 1])")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default) or, explicitly, on the CPU")
    p.add_argument("--suffix", default="", type=str,
                   help="name suffix template: e.g. {model}_{netG}")
    p.add_argument("--model", type=str, default="test", help="cycle_gan | test")
    p.add_argument("--phase", type=str, default="test")
    p.add_argument("--spatial_shard", action="store_true",
                   help="decode the WHOLE volume in one pass with the volume "
                        "depth-sharded across the ranks (halo-exchange convs) "
                        "instead of sliding-window patching")
    p.add_argument("--data_parallel", action="store_true",
                   help="deal the sliding window's patches over the ranks")
    p.add_argument("--spatial_parallel", action="store_true",
                   help="a training flag; ignored by the decode")
    p.add_argument("--space_devices", type=int, default=0,
                   help="a training flag; ignored by the decode")
    # the JAX decode's parser holds these as well; a decode does not read them
    ignored = p.add_argument_group("accepted and ignored (training, data loading, "
                                   "devices, other networks)")
    for flag, kw in (
            ("--data_path", dict(type=str, default="./Data_folder/train/")),
            ("--val_path", dict(type=str, default="./Data_folder/test/")),
            ("--batch_size", dict(type=int, default=1)),
            ("--min_pixel", dict(type=float, default=0.1)),
            ("--drop_ratio", dict(type=float, default=0.0)),
            ("--ndf", dict(type=int, default=32)),
            ("--netD", dict(type=str, default="n_layers")),
            ("--n_layers_D", dict(type=int, default=3)),
            ("--gpu_ids", dict(default="0")),
            ("--which_direction", dict(type=str, default="AtoB")),
            ("--workers", dict(type=int, default=1)),
            ("--verbose", dict(action="store_true")),
            ("--pipeline", dict(type=str, default="monai", choices=["monai", "legacy"])),
            ("--cache_dir", dict(type=str, default="")),
            ("--num_samples", dict(type=int, default=2)),
            ("--seed", dict(type=int, default=0))):
        ignored.add_argument(flag, **kw)
    return p


def parse(argv: Optional[Sequence[str]] = None,
          parser: Optional[argparse.ArgumentParser] = None) -> argparse.Namespace:
    """Parse with ``parser`` (``build_parser()`` by default) and apply
    ``--suffix``."""
    opt = (parser or build_parser()).parse_args(argv)
    if opt.suffix:
        opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))
    return opt
