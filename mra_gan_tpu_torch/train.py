"""Training CLI: ``python -m mra_gan_tpu_torch.train`` (counterpart of the
JAX package's ``train.py``:25-283), the reference's ``python train.py``
workflow on one GPU:

    python -m mra_gan_tpu_torch.train --data_path <root with images/ and labels/> \\
        --checkpoints_dir ./checkpoints --name myrun [--no_lsgan] [--device cpu]

Every flag of the JAX driver with its default, plus ``--device``. Per epoch:
the loader's patch pairs (data/dataset.py) go to the device through pinned
memory, one ``make_train_step`` step each, at the epoch's lr from
``LRScheduler``. The losses are read back to the host only at
``--print_freq`` (the loss line of ``loss_log.txt``) and once at the end of
the epoch (the plateau policy's metric: the mean total loss over those
samples). ``ckpt_{epoch}.pt`` and ``latest``, with their reference ``.pth``
files, are written every ``--save_epoch_freq`` epochs, ``latest`` every
``--save_latest_freq`` iterations and at the end. ``--continue_train``
restores ``--which_epoch``, as does ``--epoch_count N`` > 1 when
``ckpt_N.pt`` exists.

``--augment`` runs the reference's random augmentation policy on the
device batch after its copy and before the step (data/augment.py; 13 choices
under ``--augment_extended``), its draws keyed by (seed, epoch, step), so a
run resumed at an epoch boundary is bit-equal to the straight one;
``--dump_patches`` writes the patches before it. ``--remat`` recomputes the
generators' activations in the backward (models/cycle_gan.py). Before the
first step, unless given ``--no_mem_check``, two trial steps measure the
step's device memory against ``--hbm_limit_gib`` or the card and refuse a
step that does not fit (core/memory.py).

``--data_parallel`` splits each batch over the ranks, ``--spatial_parallel``
depth-shards each patch over ``--space_devices`` ranks (all of them by
default), and both together make a 2-D data x space grid, with the JAX
driver's SystemExits (train.py:89-155). The ranks are torchrun's (``torchrun
--nproc_per_node R -m mra_gan_tpu_torch.train --data_parallel ...``, NCCL,
one card each) or those of a group the caller joined before calling
``main``; with one rank the flags fall through to the one-device step, as
the JAX driver's device-count guards do. The batches are a one-device
run's and each rank takes its part, so a run is the one-device run. Under
``--data_parallel`` (alone or on the grid) each rank's loader is a rank view
(data/dataset.py ``PatchLoader(rows=...)``): it reads, preprocesses and
gathers only the volumes and samples behind its rows of each global batch,
copies only those rows to its card and augments only them (the draws stay
the global batch's), then takes its depth shard on the grid; the rows are
bit-equal to the global batch's, so the group does the JAX driver's host
work once between its ranks. ``--spatial_parallel`` alone keeps the global
view: every space rank needs each whole volume, and augmentation mixes
depth, so a depth shard cannot be augmented alone. ``--dump_patches``
writes the global stream's first pairs (rank 0 samples them itself). Rank 0
alone logs and writes. Spatial-only over fewer ranks than the world leaves
the rest idle, as the JAX driver leaves devices idle.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .checkpoint.manager import is_writer
from .core.device import resolve_device
from .core.dtypes import compute_dtype
from .core.memory import preflight
from .core.mesh import DATA_AXIS, SPACE_AXIS, distributed_world, init_distributed, make_mesh
from .data import nifti
from .data.augment import augment_batch, step_generators
from .data.dataset import PatchLoader, UnpairedVolumeDataset
from .models.cycle_gan import CycleGANConfig, create_state, make_train_step
from .models.networks import check_patch
from .options.train_options import TrainOptions
from .parallel.sharding import data_rows, make_sharded_train_step, shard_state
from .parallel.spatial import make_spatial_train_step, shard_spatial_state, spatial_depth_rule
from .training.schedules import LRScheduler
from .utils import StepTimer, Visualizer, print_networks


def config_from_opt(opt: argparse.Namespace) -> CycleGANConfig:
    return CycleGANConfig(
        input_nc=opt.input_nc, output_nc=opt.output_nc, ngf=opt.ngf, ndf=opt.ndf,
        net_g=opt.netG, net_d=opt.netD, n_layers_d=opt.n_layers_D, norm=opt.norm,
        no_dropout=opt.no_dropout, init_type=opt.init_type, init_gain=opt.init_gain,
        gan_mode="vanilla" if opt.no_lsgan else "lsgan",
        lambda_a=opt.lambda_A, lambda_b=opt.lambda_B, lambda_identity=opt.lambda_identity,
        lambda_co_a=opt.lambda_co_A, lambda_co_b=opt.lambda_co_B,
        pool_size=opt.pool_size, beta1=opt.beta1, dtype=compute_dtype(opt.precision),
        dynet_sizes=tuple(int(v) for v in opt.dynet_sizes),
        dynet_spacings=tuple(float(v) for v in opt.dynet_spacings), remat=opt.remat)


def check_parallel(opt: argparse.Namespace, cfg: CycleGANConfig, patch, world: int):
    """The JAX driver's SystemExits for the parallel flags (train.py:89-145)
    and its warning for --spatial_parallel on one device. Returns (data
    ranks, space ranks) of the grid to build, or None for the one-device
    step."""
    if opt.data_parallel and not opt.spatial_parallel and world > 1 \
            and opt.batch_size % world != 0:
        raise SystemExit(
            f"--data_parallel requires batch_size ({opt.batch_size}) divisible "
            f"by the device count ({world}); pick e.g. "
            f"--batch_size {-(-opt.batch_size // world) * world}")
    if opt.spatial_parallel and world <= 1:
        print("WARNING: --spatial_parallel ignored — only one device is "
              "visible; running the single-chip step")
    if opt.spatial_parallel and world > 1:
        both, ns = opt.data_parallel, opt.space_devices
        if ns > world:
            raise SystemExit(f"--space_devices {ns} exceeds the device count ({world})")
        if both:
            if ns <= 0 or world % ns:
                raise SystemExit("--data_parallel + --spatial_parallel needs "
                                 f"--space_devices dividing the device count ({world})")
            nd = world // ns
        else:
            ns, nd = ns or world, 1  # spatial-only: the first ns ranks, the rest idle
        g, min_shard = spatial_depth_rule(cfg)
        d0 = int(patch[0])
        if d0 % ns or (d0 // ns) % g[0] or d0 // ns < min_shard:
            raise SystemExit(
                f"--spatial_parallel over {ns} devices requires a per-device "
                f"patch depth (D/{ns} of D={d0}) divisible by {g[0]} and >= "
                f"{min_shard} for net_g={cfg.net_g}")
        if int(patch[1]) % g[1] or int(patch[2]) % g[2]:
            raise SystemExit(
                f"--spatial_parallel requires in-plane patch dims "
                f"{tuple(patch[1:])} divisible by {g[1:]} for net_g={cfg.net_g}")
        if both and opt.batch_size % nd:
            raise SystemExit(f"batch_size ({opt.batch_size}) must be divisible by the "
                             f"data-axis size ({nd})")
        return nd, ns
    if opt.data_parallel and world > 1:
        return world, 1
    return None


def rank_rows(opt: argparse.Namespace, mesh) -> Optional[slice]:
    """This rank's rows of each global batch, loaded and augmented by the
    rank alone (its rank view), under --data_parallel; None (the global
    view) for --spatial_parallel alone."""
    return data_rows(opt.batch_size, mesh.axis(DATA_AXIS)) if opt.data_parallel else None


def to_step_layout(batch: np.ndarray, device: torch.device, take=None) -> torch.Tensor:
    """A loader batch, (B, X, Y, Z, C) numpy, as the step's (B, C, X, Y, Z)
    on ``device`` (a parallel step's ``take`` picks this rank's part first);
    to CUDA from pinned memory, without waiting for the copy."""
    t = torch.from_numpy(batch).permute(0, 4, 1, 2, 3)
    if take is not None:
        t = take(t)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _dump_patches(dump_dir: Path, first: int, image_b: np.ndarray,
                  label_b: np.ndarray) -> None:
    """Write the pairs as patch_{first + k:04d}_{A,B}.nii.gz."""
    for k in range(image_b.shape[0]):
        for tag, arr in (("A", image_b), ("B", label_b)):
            nifti.save(nifti.NiftiImage(data=np.asarray(arr[k, ..., 0], np.float32),
                                        affine=np.eye(4)),
                       dump_dir / f"patch_{first + k:04d}_{tag}.nii.gz")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns {"state": the final CycleGANState, "epochs": one record
    per epoch (epoch, lr, steps, wall_s, and the StepTimer's data_s and
    comp_s)}."""
    opt = TrainOptions().parse(argv)
    device = resolve_device(opt.device)
    cfg = config_from_opt(opt)
    patch = tuple(int(p) for p in opt.patch_size)
    check_patch(cfg.net_g, patch)
    grid = check_parallel(opt, cfg, patch, distributed_world())
    if grid is not None:
        device = init_distributed(device)
    dataset = UnpairedVolumeDataset(
        opt.data_path, patch_size=patch, pipeline=opt.pipeline, num_samples=opt.num_samples,
        shuffle_labels=(opt.pipeline == "legacy"), which_direction=opt.which_direction,
        resample=opt.resample, new_resolution=opt.new_resolution, drop_ratio=opt.drop_ratio,
        min_pixel=opt.min_pixel, cache_dir=opt.cache_dir, seed=opt.seed)

    state = create_state(cfg, opt.seed, patch, device)
    print_networks(state.nets, verbose=opt.verbose)
    take, rows = None, None
    if grid is None:
        step = make_train_step(cfg)
    else:
        nd, ns = grid
        mesh = make_mesh(nd, ns)
        if not mesh.axes:
            print(f"rank {torch.distributed.get_rank()} idle: --space_devices {ns} of "
                  f"{distributed_world()} ranks")
            return {"state": None, "epochs": []}
        if opt.spatial_parallel:
            state = shard_spatial_state(state, mesh, SPACE_AXIS)
            step, take = make_spatial_train_step(cfg, mesh, SPACE_AXIS,
                                                 DATA_AXIS if opt.data_parallel else None)
        else:
            state = shard_state(state, mesh)
            step, take = make_sharded_train_step(cfg, mesh)
        rows = rank_rows(opt, mesh)
    loader = PatchLoader(dataset, batch_size=opt.batch_size, shuffle=True, workers=opt.workers,
                         rows=None if rows is None else (rows.start, rows.stop))
    print(f"volumes: {len(dataset)}  steps/epoch: {loader.steps_per_epoch()}")
    if not opt.no_mem_check:
        lim = opt.hbm_limit_gib
        parallel = {} if take is None else {
            "take": take, "axes": [mesh.axis(a) for a in (SPACE_AXIS, DATA_AXIS)]}
        preflight(step, state, opt.batch_size, opt.lr,
                  limit_bytes=int(lim * 2 ** 30) if lim else None, **parallel)

    ckpt = CheckpointManager(opt.checkpoints_dir, opt.name)
    if opt.continue_train and ckpt.has(opt.which_epoch):
        state = ckpt.restore(opt.which_epoch, state)
        print(f"resumed from checkpoint '{opt.which_epoch}' (step {state.step})")
    elif opt.epoch_count > 1 and ckpt.has(opt.epoch_count):
        state = ckpt.restore(opt.epoch_count, state)
        print(f"resumed from checkpoint '{opt.epoch_count}'")

    sched = LRScheduler(opt.lr_policy, opt.lr, niter=opt.niter, niter_decay=opt.niter_decay,
                        epoch_count=opt.epoch_count, lr_decay_iters=opt.lr_decay_iters)
    visualizer = Visualizer(opt) if is_writer() else None
    total_steps = 0
    last_metric = None
    metrics = None
    dumps_left, dump_idx = opt.dump_patches, 0
    dump_dir = Path(opt.checkpoints_dir) / opt.name / "patch_dumps"
    if not is_writer():
        dumps_left = 0
    if dumps_left:
        dump_dir.mkdir(parents=True, exist_ok=True)
    # legacy patches live in [-1, 1]; monai images are z-scored, so each
    # member's own range is taken (JAX train.py:242-244)
    value_range = (-1.0, 1.0) if opt.pipeline == "legacy" else None
    # a parallel step's part of a batch: its rows and depth shard of a global
    # batch, or the depth shard alone of a rank view's rows
    part = None if take is None else (lambda x: take(x, local=rows is not None))
    # a rank view augments its rows with the global batch's draws
    aug_rows = {} if rows is None else {"batch": opt.batch_size, "rows": rows}
    records = []
    for epoch in range(opt.epoch_count, opt.niter + opt.niter_decay + 1):
        if dumps_left > 0 and loader.steps_per_epoch():
            # the stream's first pairs, before augmentation: whatever rows
            # this rank loads, the global view's (JAX train.py:187-232)
            image_d, label_d = loader.first_pairs(epoch, dumps_left)
            _dump_patches(dump_dir, dump_idx, image_d, label_d)
            dump_idx += image_d.shape[0]
            dumps_left -= image_d.shape[0]
        profiler = None
        if opt.profile_dir and epoch == opt.epoch_count:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        epoch_start = time.time()
        lr = sched.lr_for_epoch(epoch, metric=last_metric)
        timer = StepTimer()
        epoch_iter = 0
        # the plateau metric: the mean total loss over the print-time samples
        # and one sample at the end of the epoch, so that it never depends on
        # print_freq and costs no read-back per step
        msum, msteps = 0.0, 0
        sampled_step = -1
        for i, (image_b, label_b) in enumerate(loader.epoch(epoch)):
            timer.data_ready()
            # AtoB: image -> real_A, label -> real_B. Augmentation draws per
            # sample of the global batch and mixes depth, so it runs on whole
            # rows before the step's part is taken.
            early = None if opt.augment else part
            real_a = to_step_layout(image_b, device, early)
            real_b = to_step_layout(label_b, device, early)
            if opt.augment:
                real_a, real_b = augment_batch(
                    real_a, real_b, step_generators(opt.seed, epoch, i, device),
                    value_range=value_range, extended=opt.augment_extended, **aug_rows)
                if part is not None:
                    real_a, real_b = part(real_a), part(real_b)
            state, metrics = step(state, real_a, real_b, lr)
            total_steps += opt.batch_size
            epoch_iter += opt.batch_size
            if total_steps % opt.print_freq == 0:
                metrics_host = {k: float(v) for k, v in metrics.items()}
                msum += sum(metrics_host.values())
                msteps += 1
                sampled_step = total_steps
                timer.step_done()
                if visualizer is not None:
                    visualizer.print_current_losses(epoch, epoch_iter, metrics_host,
                                                    timer.t_comp / opt.batch_size, timer.t_data)
            if total_steps % opt.save_latest_freq == 0:
                print(f"saving the latest model (epoch {epoch}, total_steps {total_steps})")
                ckpt.save("latest", state, also_latest=False)
        if profiler is not None:
            if device.type == "cuda":
                torch.cuda.synchronize()
            profiler.stop()
            Path(opt.profile_dir).mkdir(parents=True, exist_ok=True)
            trace = Path(opt.profile_dir) / f"train_epoch{epoch}.trace.json"
            profiler.export_chrome_trace(str(trace))
            print(f"profiler trace written to {trace}")
        if epoch_iter:
            if sampled_step != total_steps:  # the last step not yet sampled
                msum += sum(float(v) for v in metrics.values())
                msteps += 1
            last_metric = msum / msteps
        records.append({"epoch": epoch, "lr": lr, "steps": epoch_iter // opt.batch_size,
                        "wall_s": time.time() - epoch_start, "data_s": timer.data_s,
                        "comp_s": timer.comp_s})
        if epoch % opt.save_epoch_freq == 0:
            print(f"saving the model at the end of epoch {epoch}, iters {total_steps}")
            ckpt.save(epoch, state, also_latest=True)
        print(f"End of epoch {epoch} / {opt.niter + opt.niter_decay} \t "
              f"Time Taken: {int(time.time() - epoch_start)} sec \t lr: {lr:.7f}")
    ckpt.save("latest", state, also_latest=False)
    return {"state": state, "epochs": records}


if __name__ == "__main__":
    main()
