"""The flags every driver of the port shares (counterpart of
mra_gan_tpu/options/base_options.py:27-151): the same flags with the same
defaults, plus ``--device``.

The parse has two phases, as the JAX package's: the base flags first, then
the selected model's ``modify_commandline_options`` adds its own flags and
overrides defaults (models.get_option_setter). ``--suffix`` renames the run,
``--cache_dir`` defaults to ``<checkpoints_dir>/<name>/cache``, and
``print_options`` prints every flag and writes it to
``<checkpoints_dir>/<name>/opt.txt`` in the JAX package's format.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path


class BaseOptions:
    def __init__(self):
        self.initialized = False
        self.is_train = None

    def initialize(self, parser: argparse.ArgumentParser):
        parser.add_argument("--data_path", type=str, default="./Data_folder/train/",
                            help="Train images path (expects images/ and labels/ subdirs)")
        parser.add_argument("--val_path", type=str, default="./Data_folder/test/",
                            help="Validation images path")
        parser.add_argument("--batch_size", type=int, default=1, help="input batch size")
        parser.add_argument("--patch_size", type=int, nargs=3, default=[64, 64, 64],
                            help="Size of the patches extracted from the image")
        parser.add_argument("--dynet_sizes", type=int, nargs=3, default=[128, 128, 64],
                            help="Dynet auto-schedule input sizes (the reference "
                                 "hard-codes [128,128,64] independent of patch size)")
        parser.add_argument("--dynet_spacings", type=float, nargs=3, default=[1.5, 1.5, 1.5],
                            help="Dynet auto-schedule voxel spacings")
        parser.add_argument("--input_nc", type=int, default=1, help="# of input image channels")
        parser.add_argument("--output_nc", type=int, default=1,
                            help="# of output image channels")
        parser.add_argument("--resample", action="store_true",
                            help="rescale the images to a new resolution (legacy pipeline)")
        parser.add_argument("--new_resolution", type=float, nargs=3, default=[1.0, 1.0, 1.0],
                            help="New resolution for --resample")
        parser.add_argument("--min_pixel", type=float, default=0.1,
                            help="Percentage of minimum non-zero pixels in the cropped label")
        parser.add_argument("--drop_ratio", type=float, default=0.0,
                            help="Probability to keep an empty-label crop (0 drops all empties)")
        parser.add_argument("--ngf", type=int, default=32,
                            help="# of gen filters in first conv layer")
        parser.add_argument("--ndf", type=int, default=32,
                            help="# of discrim filters in first conv layer")
        parser.add_argument("--netD", type=str, default="n_layers",
                            help="discriminator: basic | n_layers | pixel")
        parser.add_argument("--n_layers_D", type=int, default=3,
                            help="only used if netD==n_layers")
        parser.add_argument("--netG", type=str, default="resnet_6blocks",
                            help="generator: resnet_9blocks | resnet_6blocks | unet_custom | "
                                 "unet_128 | unet_256 | Dynet")
        parser.add_argument("--gpu_ids", default="0",
                            help="accepted for reference-CLI compatibility; ignored "
                                 "(--device picks the device)")
        parser.add_argument("--name", type=str, default="experiment_name",
                            help="experiment name (samples/models directory)")
        parser.add_argument("--model", type=str, default="cycle_gan",
                            help="which model to use: cycle_gan | test")
        parser.add_argument("--which_direction", type=str, default="AtoB", help="AtoB or BtoA")
        parser.add_argument("--checkpoints_dir", type=str, default="./checkpoints",
                            help="models are saved here")
        parser.add_argument("--workers", default=1, type=int,
                            help="data loading workers (0=inline)")
        parser.add_argument("--norm", type=str, default="instance",
                            help="instance | batch | none")
        parser.add_argument("--no_dropout", action="store_true",
                            help="no dropout for the generator")
        parser.add_argument("--init_type", type=str, default="normal",
                            help="normal | xavier | kaiming | orthogonal")
        parser.add_argument("--init_gain", type=float, default=0.02,
                            help="scaling factor for normal, xavier and orthogonal")
        parser.add_argument("--verbose", action="store_true",
                            help="print more debugging information")
        parser.add_argument("--suffix", default="", type=str,
                            help="name suffix template: e.g. {model}_{netG}")
        parser.add_argument("--precision", type=str, default="bfloat16",
                            choices=["bfloat16", "float32"], help="compute precision policy")
        parser.add_argument("--pipeline", type=str, default="monai", choices=["monai", "legacy"],
                            help="preprocessing pipeline flavor")
        parser.add_argument("--cache_dir", type=str, default="",
                            help="disk cache for deterministic preprocessing "
                                 "(default <checkpoints_dir>/<name>/cache)")
        parser.add_argument("--num_samples", type=int, default=2,
                            help="random patches per volume per epoch")
        parser.add_argument("--data_parallel", action="store_true",
                            help="shard the batch over all ranks")
        parser.add_argument("--spatial_parallel", action="store_true",
                            help="depth-shard every patch over the ranks "
                                 "(train patches too large for one card's "
                                 "memory; patch depth must be divisible by "
                                 "4*spatial ranks). Combine with "
                                 "--data_parallel for a 2-D dp x sp grid")
        parser.add_argument("--space_devices", type=int, default=0,
                            help="ranks on the spatial axis (0 = all "
                                 "when --spatial_parallel alone; required "
                                 "with --data_parallel + --spatial_parallel)")
        parser.add_argument("--seed", type=int, default=0, help="global PRNG seed")
        parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                            help="run on the GPU (default) or, explicitly, on the CPU")
        self.initialized = True
        return parser

    def gather_options(self, argv=None):
        parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser = self.initialize(parser)
        opt, _ = parser.parse_known_args(argv)
        from ..models import get_option_setter

        setter = get_option_setter(opt.model)
        if setter is not None:
            parser = setter(parser, self.is_train) or parser
        self.parser = parser
        return parser.parse_args(argv)

    def print_options(self, opt):
        lines = ["----------------- Options ---------------"]
        for k, v in sorted(vars(opt).items()):
            comment = ""
            default = self.parser.get_default(k)
            if v != default:
                comment = f"\t[default: {default}]"
            lines.append(f"{k:>25}: {str(v):<30}{comment}")
        lines.append("----------------- End -------------------")
        message = "\n".join(lines)
        print(message)
        expr_dir = Path(opt.checkpoints_dir) / opt.name
        expr_dir.mkdir(parents=True, exist_ok=True)
        (expr_dir / "opt.txt").write_text(message + "\n")

    def parse(self, argv=None):
        opt = self.gather_options(argv)
        opt.isTrain = self.is_train
        if opt.suffix:
            opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))
        if not opt.cache_dir:
            opt.cache_dir = os.path.join(opt.checkpoints_dir, opt.name, "cache")
        self.print_options(opt)
        self.opt = opt
        return opt
