"""Checkpoint converter: ``python -m mra_gan_tpu_torch.convert_checkpoint``
(counterpart of the root ``convert_checkpoint.py``, with the same flags and
``--device``), for every network of the zoo.

Import (``--from_torch``): reads the reference's per-network files
``{epoch}_net_{G_A,G_B,D_A,D_B}.pth`` from --torch_dir into a fresh port
state (Adam moments start at zero, as the reference's own resume starts
them) and writes ``ckpt_{epoch}.pt``, with its four reference files, under
<checkpoints_dir>/<name>/. Discriminator files are optional: a directory
with only generators converts, and the discriminators keep their fresh
weights. The network flags must match how the files were made;
``--use_dropout`` for files whose residual blocks have the dropout layout
(second conv at ``conv_block.6``), ``--dynet_sizes``/``--dynet_spacings``
for a Dynet. A Dynet file's duplicate ``skip_layers`` keys are checked
against their twins and dropped.

Export (``--to_torch``): reads ``ckpt_{epoch}.pt`` and writes the four
reference files, with the norms' running-stat buffers the reference's
strict load requires (and a Dynet's ``skip_layers`` aliases), into
--torch_dir. The checkpoint's own configuration decides the networks and
their key layout; the network flags are read on import only.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from .checkpoint.io import has_dropout_layout, read_reference_pth, save_reference_pth
from .checkpoint.manager import NET_FILES, CheckpointManager, config_from_dict
from .core.device import resolve_device
from .models.cycle_gan import CycleGANConfig, create_state
from .models.networks import RESNET_BLOCKS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mra_gan_tpu_torch.convert_checkpoint",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    d = p.add_mutually_exclusive_group(required=True)
    d.add_argument("--from_torch", action="store_true",
                   help="reference .pth files -> port checkpoint")
    d.add_argument("--to_torch", action="store_true",
                   help="port checkpoint -> reference .pth files")
    p.add_argument("--torch_dir", required=True,
                   help="directory holding/receiving {epoch}_net_*.pth")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--name", default="experiment_name")
    p.add_argument("--which_epoch", default="latest")
    # network flags (must match how the torch model was defined)
    p.add_argument("--netG", default="resnet_6blocks")
    p.add_argument("--netD", default="n_layers")
    p.add_argument("--n_layers_D", type=int, default=3)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--ndf", type=int, default=32)
    p.add_argument("--input_nc", type=int, default=1)
    p.add_argument("--output_nc", type=int, default=1)
    p.add_argument("--norm", default="instance")
    p.add_argument("--use_dropout", action="store_true",
                   help="the torch nets were built with dropout (shifts the "
                        "resnet block key indices)")
    p.add_argument("--patch_size", type=int, nargs=3, default=[64, 64, 64])
    p.add_argument("--dynet_sizes", type=int, nargs=3, default=[128, 128, 64],
                   help="Dynet auto-schedule sizes (the reference hard-codes "
                        "[128,128,64] independent of patch size)")
    p.add_argument("--dynet_spacings", type=float, nargs=3, default=[1.5, 1.5, 1.5])
    p.add_argument("--pool_size", type=int, default=50,
                   help="replay-buffer size of the training run that will "
                        "resume from the imported checkpoint")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="build the networks on the GPU (default) or, explicitly, the CPU")
    return p


def import_reference(opt: argparse.Namespace) -> None:
    cfg = CycleGANConfig(input_nc=opt.input_nc, output_nc=opt.output_nc, ngf=opt.ngf,
                         ndf=opt.ndf, net_g=opt.netG, net_d=opt.netD,
                         n_layers_d=opt.n_layers_D, norm=opt.norm,
                         no_dropout=not opt.use_dropout, pool_size=opt.pool_size,
                         dynet_sizes=tuple(opt.dynet_sizes),
                         dynet_spacings=tuple(opt.dynet_spacings))
    state = create_state(cfg, 0, tuple(opt.patch_size), resolve_device(opt.device))
    imported = []
    for suffix, name in NET_FILES:
        pth = Path(opt.torch_dir) / f"{opt.which_epoch}_net_{suffix}.pth"
        if not pth.exists():
            if name.startswith("g"):
                raise SystemExit(f"missing generator checkpoint {pth}")
            print(f"note: {pth.name} absent; {suffix} keeps its fresh weights")
            continue
        sd = read_reference_pth(pth)
        dropout = has_dropout_layout(sd)
        if name.startswith("g") and opt.netG in RESNET_BLOCKS and dropout != opt.use_dropout:
            raise SystemExit(f"{pth.name} {'has' if dropout else 'lacks'} the dropout key "
                             f"layout (conv_block.6); run with{'' if dropout else 'out'} "
                             f"--use_dropout")
        state.nets[name].load_state_dict(sd, strict=True)
        imported.append(suffix)
    ckpt = CheckpointManager(opt.checkpoints_dir, opt.name)
    ckpt.save(opt.which_epoch, state, also_latest=False)
    print(f"imported {imported} -> {ckpt.path(opt.which_epoch)}")


def export_reference(opt: argparse.Namespace) -> None:
    raw = CheckpointManager(opt.checkpoints_dir, opt.name).restore_raw(opt.which_epoch)
    cfg = config_from_dict(raw["config"])
    device = resolve_device(opt.device)
    torch_dir = Path(opt.torch_dir)
    torch_dir.mkdir(parents=True, exist_ok=True)
    for suffix, name in NET_FILES:
        g = name.startswith("g")
        net = cfg.build_generator(name) if g else cfg.build_discriminator(name)
        net = net.to(device)
        net.load_state_dict(raw["nets"][name], strict=True)
        pth = torch_dir / f"{opt.which_epoch}_net_{suffix}.pth"
        save_reference_pth(net, pth, cfg.net_g if g else cfg.net_d, not cfg.no_dropout)
        print(f"wrote {pth}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    opt = build_parser().parse_args(argv)
    if opt.from_torch:
        import_reference(opt)
    else:
        export_reference(opt)


if __name__ == "__main__":
    main()
