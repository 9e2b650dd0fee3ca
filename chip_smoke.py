#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mra_gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --conv7   # phase 1 and the conv7 parts of phases 2-3 alone
    python3 chip_smoke.py --conv4s2   # phase 1 and the conv4s2 parts of phases 2-3 alone
    python3 chip_smoke.py --pads   # phase 1 and the pad part of phase 2 alone
    python3 chip_smoke.py --bench   # phase 1, phase 5's timed decodes, phase 7 at batch 8, phase 15

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the nvcc build of every kernel source under
   mra_gan_tpu_torch/ops/kernels/csrc/ (one nvcc per source, in parallel);
2. every CUDA kernel against its plain PyTorch version on the card, in
   bfloat16 and float32, on each shape's route (K.uses_slab: the slab
   kernel, forward or backward, else stats then apply, forward or
   backward): the forward kernels at every instance-norm shape of the
   decode path (batch 8, the short last batch of 3, and the whole-volume
   single pass), forward and backward at every norm shape of the train
   step at batch 1 and 8 (the generator at 2B and B, the PatchGAN at B and
   2B), plus small shapes for leaky_relu, tanh and C = 6 and the largest
   slab instance at C = 128; each timed beside its plain version, the
   library yardsticks (F.instance_norm + activation and its autograd
   backward, torch.var_mean for the statistics) and the memory bound, at
   each slab shape beside the two-pass kernels, and at each two-pass
   backward shape in bfloat16 at several segment targets (BWD_TARGETS);
   and the two conv7 kernels (the resnet's 7^3 stem and head) in each of
   their roles (CONV7_ROLES: spread for the stem forward and the head's
   input gradient, gather for the head forward and the stem's input
   gradient) at every batch size the decode and the train step at batch 1
   and 8 give them, and both at both pads on an odd unequal box, at C = 4
   (no tensor map), C = 40 (a partial second channel group), C = 96 and
   C = 128 (three and four groups) and at phase 14's shard boxes
   (CONV7_EXTRA, CONV7_SHARD_BOXES), against float32 F.conv3d on the card
   with TF32 off (phase_conv7_kernels states the bar), each twice and
   bit-equal; and the two weight-gradient
   kernels (conv7_wgrad_spread for the stem, conv7_wgrad_gather for the
   head, each a first pass of partial sums and the conv7_wgrad_reduce pass)
   at N = 16, 8, 2, 1, at phase 14's shard boxes (CONV7_SHARD_BOXES) and at
   CONV7_EXTRA's odd box and C = 4, 40, 96 and 128 against float32
   conv3d_weight at the same bar, each twice and bit-equal, and the reduce
   alone on each case's partials; and the two replication-pad kernels
   (replication_pad_fwd, replication_pad_bwd) at every pad shape of the
   decode (batch 8, the last batch of 3, the single pass) and of the train
   step at batch 1 and 8 (the generators at 2B and B), at a depth shard of
   phase 14's spatial step (depth pad 0), on an odd unequal box with an
   axis of 1 voxel at C = 6 and at C = 128 (pad_cases; C = 1, 6, 32, 128),
   in bf16 and float32, and at PAD_EXTRA's float64 boxes (the head's pad of
   phase 8's float64 step among them), sources whose base pointer is not
   16-byte aligned and wide voxels (C = 128 in float32, C = 64 and 128 in
   float64), each bit-equal to its plain version and twice
   bit-equal, then at the decode's and the step's batch sizes (3, 8, 16)
   timed beside the plain version, F.pad(mode="replicate") and its autograd
   backward (the path before the kernels) and the byte bound, and those
   times summed over a batch-8 step's and a decoded volume's launches beside
   the bound's sums; and the four conv4s2
   kernels (the PatchGAN's first conv and the U-Net's outermost down conv:
   conv4s2_spread forward, conv4s2_gather input gradient, conv4s2_wgrad
   weight and bias gradient with its conv4s2_wgrad_reduce) at every case of
   C4S2_CASES (the step's N = 16, 8, 2, 1 on 64^3, an odd box, C = 4, 5 and
   40, the U-Net's depth shard at pads (0, 1, 1) and an odd box there,
   unet_128's 128^3) and C4S2_PATH_CASES (the TMA path at C = 40, 64 and 8,
   the staged path with x or g 2 bytes off alignment) against their plain
   versions at the conv7 bar, each twice and bit-equal, each row naming
   the path its plan took (the forward and the weight gradient must run
   both), the reduce bit-equal to its plain version;
3. cuDNN conv3d / conv_transpose3d at the generator's shapes, NCDHW against
   channels_last_3d; and each conv7 role, the weight gradients included, at
   the cells' batch sizes (16, 8) timed beside cuDNN's heuristic pick in
   bf16 (the path before the kernels), cuDNN with
   torch.backends.cudnn.benchmark on, the plain float32 version and the
   bound (FLOPs at the bf16 peak or bytes at the memory rate, whichever is
   larger, named); the reduce pass alone beside torch.sum of its partials;
   and each conv4s2 kernel at N = 16 and 8 on 64^3 beside cuDNN's bf16
   call for the same direction (heuristic, and with cudnn.benchmark on; it
   must beat the heuristic call), its plain version and its bound, and on
   the TMA path the staged kernel on the same inputs between two readings
   of the TMA kernel; the forward and the weight gradient also at
   C4S2_PATH_TIMED (the batch-1 step's N = 2 and 1, the U-Net's depth shard,
   unet_128), each path beside the other, the plan's no slower than the
   other's by more than 3% + 0.001 ms (after phase 7 a profile names the
   kernels of cuDNN's calls, the path before);
4. the resnet_6blocks generator at ngf=32, batch 8, 64^3, weights from a
   seeded numpy tree in the JAX layout through state_dict_from_jax: kernel
   norms against plain norms in bfloat16 and (TF32 off) float32, and the
   exact launches of each forward kernel per forward that uses_slab gives
   (13 slab, 4 stats, 4 apply), none of a backward one (nor in phases 5-6),
   one launch of each conv7 kernel per bf16 forward (none in float32) and 14
   of the pad forward in both (no backward, no relayout), no conv4s2 launch
   (nor in phases 5-6: the decode runs no discriminator);
5. the sliding-window decode of a 128x256x256 volume (147 patches in 19
   batches, Gaussian blend; 19 x those launches, 266 pad forwards;
   DECODE_REPEATS timed decodes, the median kept; its traced decode runs
   after phase 7's timed steps, as nothing is traced in a benchmark
   process before its timed block), then the single-pass
   whole-volume forward of the same volume (17 stats, 17 apply, no slab;
   one launch of each conv7 kernel; 14 pad forwards);
6. the decode CLI (python -m mra_gan_tpu_torch.test) in directory mode on
   three synthetic NIfTIs with a .pth checkpoint written from the same tree
   (the norm, conv7 and pad launches of its batches);
7. the CycleGAN train step (create_state + make_train_step) at the
   reference default (bench.py:193-198: two resnet_6blocks generators, two
   3-layer PatchGANs, ngf = ndf = 32, LSGAN, pool 50, Adam 2e-4 / 0.5, bf16
   over f32 parameters, 64^3 patches) at batch 8, then 1: s/step (the
   median of TRAIN_TIMED_STEPS steps, timed as the benchmark times them,
   batch 8 before any step of this process was traced), pairs/s,
   peak memory, the exact launches per step (forward: 4 x 13 + 12 slab, 16
   stats, 16 apply; backward: 64 bwd slab, 16 bwd stats, 16 bwd apply;
   conv7: 8 spread, 6 gather, 4 wgrad spread, 4 wgrad gather, 8 wgrad
   reduce; pads: 56 forward, 54 backward, the stems of the two leaf applies
   having none; conv4s2: 4 spread, 2 gather, 2 wgrad, 2 reduce, the
   generator update asking no discriminator weight gradient), the stem
   gradients the conv7 backward had to relayout, the pads' relayouts, the
   norms' gradient relayouts (none: the pads' backward hands them
   channels_last_3d), finite losses, and one profiled step by kernel class;
   a step whose host ops are profiled with their shapes must call no aten
   convolution with the PatchGAN's first conv's (C, 1, 4, 4, 4) weight;
8. step 0 at batch 1 through the kernels and through the plain norms, in
   float32 (TF32 off) and bf16, each against a float64 step
   (phase_train_parity states the bars);
9. checkpoint and exact resume at phase 7's configuration, batch 1: 2
   steps, CheckpointManager.save, 2 more; restore into a state made from
   another seed and the same 2 steps, against the straight run bit for bit,
   once with cuDNN's deterministic algorithms and once with
   torch.use_deterministic_algorithms as well, both required (every kernel
   of the step sums in a fixed order), the norm, pad and conv4s2 kernels run
   twice at the batch-1 shapes and equal (phase_checkpoint states what each must
   show); save and restore seconds and the files' bytes; the
   saved latest_net_G_A.pth decoded through python -m mra_gan_tpu_torch.test;
10. the serving daemon (python -m mra_gan_tpu_torch.serve --once, in process)
   on 4 synthetic 128x256x256 .nii.gz volumes and one truncated file: 4
   served, the truncated one in failed.log, each output bit-equal to an
   in-process decode, exactly 4 x phase 5's forward launches per volume and
   no backward; served s/volume, one volume's read and write seconds; then
   the directory decode CLI (read ahead, writes behind) on the same volumes
   against the serial sum read + decode + write; then python -m
   mra_gan_tpu_torch.evaluate (in process) on the served volumes against
   their inputs on the card and on the CPU: every pair's SSIM, PSNR, MAE and
   Pearson r within EVAL_RTOL relative of each other, seconds per pair;
11. the port's native data path (data/native.py: data/csrc/nifti_io.cc built
   with g++ into build/native/; g++ --version, seconds, the error if any;
   it fails the phase where g++ and zlib.h are there), then the training
   driver (python -m mra_gan_tpu_torch.train, in process) at
   the reference default with --no_lsgan (LSGAN, phase 7's step) over 4
   synthetic 128x256x256 image/label pairs: batch 1 for 2 epochs (cold,
   then warm cache) and batch 8 with 4 workers, the losses read back every
   step, and one batch-1 epoch reading them back once; finite loss lines,
   the checkpoint files, exactly (steps + 2) x phase 7's launches per step
   (the two more: the driver's memory preflight, two trial steps); per
   epoch the steady s/step, its data-wait share and pairs/s beside phase 7's;
   under torch.use_deterministic_algorithms(True), 1 epoch then
   --continue_train --epoch_count 2 bit-equal to 2 straight epochs (step lr
   policy, 2 samples a volume); and the PatchLoader's own pairs/s, cold and
   warm, at workers 1 and 4, with the native reader and gather and with them
   patched off in process, in turns, every run's batches bit-equal; and the
   loader's global view against its rank views at R = 2 and 4
   (PatchLoader(rows=...), what each rank of a --data_parallel group
   loads), in turns, cold and warm: per rank, host seconds an epoch and
   pairs/s of its rows, the rows bit-equal to the global view's;
12. the rest of the zoo at full width (ngf = ndf = 32, bf16 over f32
   parameters, 64^3 patches, LSGAN, the Dynet at the options' default
   --dynet_sizes 128 128 64): the norm kernels against their plain
   versions, forward and backward on their route, at every norm shape of
   the zoo's train steps at batch 1 and 8 that phase 2 does not hold (the
   U-Net's, the DynUNet's, the pixel discriminator's; bf16, and float32 at
   N = 1); the 128x256x256 sliding-window decode and the single pass with
   unet_custom and with the Dynet (s/volume, exact launches, the single
   pass against plain norms); the same sliding window with resnet_6blocks
   under --norm batch, float32 and bf16, at --decode_batch 8 against 1 (147
   calls of one patch each way, no norm kernel launch; float32 within 1e-5,
   bf16 within the single pass's bars); one forward of unet_128 at 128^3 and of
   unet_256 at 256^3, batch 1; the train step at batch 1 and 8 of
   unet_custom + PatchGAN, Dynet + PatchGAN, resnet_6blocks + pixel
   discriminator and resnet_6blocks + PatchGAN under --norm batch (plain
   PyTorch norms: no kernel launch), each one warm-up step and two timed
   (s/step, pairs/s, peak memory, exact launches, the conv4s2 ones from the
   U-Net's outermost down conv and the PatchGAN's first conv, gradient
   relayouts, finite losses; the U-Net decodes and forwards one conv4s2
   forward a generator forward); and the Dynet state saved by CheckpointManager, its
   latest_net_G_A.pth with MONAI's skip_layers aliases decoded by the CLI
   bit-equal to an in-process decode. Cuts: two steps per configuration
   instead of an epoch; unet_128 and unet_256 need 2^7 and 2^8 voxels per
   axis, so they run one forward each at that size and no train step.
13. augmentation, registration and the memory levers: each of the 13
   augmentation branches at batch 8 x 64^3 on the card against the port's
   CPU result for the same parameters (AUG_ATOL), its device ms, and the
   whole policy per batch; the training driver with --augment
   --augment_extended at batch 1 and 8 on phase 11's data (s/step and
   data-wait share beside phase 11's, exact launches); the memory
   preflight's estimate (two trial steps) at batch 1 and 8 against phase 7's
   measured peak, --hbm_limit_gib 1 ending the driver in SystemExit with
   the advice and a real step afterwards; the dataset CLI (python -m
   mra_gan_tpu_torch.organize_folder_structure, in process) on 2 synthetic
   128x256x256 pairs with a known affine, recovered under 1 voxel, seconds
   per pair split into the host's features and resampling and the device's
   levels; --remat against the plain step at batch 8 x 64^3 and 2 x 128^3
   (s/step, peak memory, exact launches: every generator norm forward once
   more a step; the losses within the train-step bar and whether bit-equal
   under deterministic algorithms); and a child process capped below a
   128x256x256 single pass, which must refuse it with the advice, go on,
   and see the directory decode skip it and exit 1. Cuts: one epoch per
   driver run; two timed remat steps.
14. data and spatial parallelism on 2 and then 4 ranks that share this one
   card over gloo (NCCL does not let two ranks share a card; every
   collective of a CUDA tensor is staged through the host), spawned with a
   FileStore: the K-shard norm kernels (K = 2 and 4) at every generator
   norm shape of the spatial steps' shards, forward and backward, bf16 and
   float32, against their plain versions on the same gathered partials and
   against the plain norm of the whole volume, K = 1 bit-equal to phase 2's
   apply, the K-shard applies timed beside the K = 1 ones; the decode CLI
   with --spatial_shard (shard depth 64) and --data_parallel on 2 ranks
   against the one-device single pass and sliding window through the same
   CLI (float32 within the generator bar; bf16 under 0.1% of voxels more
   than one ulp off, and no farther from the float32 one-device decode than
   the bf16 one-device decode is, x1.25 of the mean error; exact
   launches: 17 stats + 17 K-shard applies per rank, and phase 5's launches
   split over the ranks); the data-parallel step at 8 = 2 x 4, the spatial
   step at 1 x 64^3 and 2 x 128^3 and the 2 x 2 data x space step at 2 x
   64^3, 3 bf16 steps each against the one-device step (1e-2 at step 0) and
   at every step no farther from the one-device float32 trajectory than the
   one-device bf16 step is (x PAR_BF16_WITNESS), and 3 float32 steps under
   deterministic algorithms at the JAX package's bars, parameters bit-equal
   across ranks, per-rank peak memory, exact
   launches per rank and step; the training driver with
   --data_parallel --augment for one epoch on phase 11's data, its
   checkpoint restored bit-equal into a one-device state, its s/step,
   data-wait share, each rank's loader host seconds and augmentation ms;
   the driver's rank view against its global view (every rank loading and
   augmenting the whole batch, then taking its part) and the one-device
   driver, under deterministic algorithms: step inputs and parameters
   bit-equal to the global view's, inputs bit-equal to the one-device
   driver's rows, step-0 losses within PAR_BF16_RTOL; and repair A of the
   memory preflight: 4 ranks, rank 1 capped at PAR_OOM_CAP_GIB so that its
   trial step runs out of memory while its peers wait in the step's
   collectives, every rank ending with the preflight's SystemExit, and how
   long after rank 1 they ended. Times carry the label "ranks share one
   card over gloo": no NCCL or scaling figure.
15. the benchmark, ``python -m mra_gan_tpu_torch.bench --cell <name>
   --seed 1``, each cell of BENCHMARK.json in a subprocess of its own (the
   cell's timed block the first work of its process, as phases 5 and 7
   time theirs before any traced run): each line
   parses, is correct (against bench_reference.py's float32 plain
   reference) with no failure, and sits within BENCH_RTOL of this run:
   the decode's median s/volume of phase 5's, the train step's median
   s/step of phase 7's batch-8 step's and its device time a step (its
   profiled kernels) of phase 7's profiled batch-8 step's; each
   kernel's launches per step or volume of
   a cell, as its wrapper counted them, join the kernels line
   ("launches_cells"). (``python -m mra_gan_tpu_torch.bench --controls``
   shows that each cell's limits reject its faults.)

The line before the last is the card's name and power limit; before it, one
JSON line {"kernels": [...]} with each kernel's launches on its main path
(the decode for the forward kernels, the batch-8 train step for the
backward ones), its largest error against the plain version, and its times
at the main path's largest norm that it runs (bfloat16); the two apply
kernels add their K-shard launches in phase 14's spatial step, their
largest K-shard error and their K-shard times beside K = 1; the five conv7
kernels' launches are the batch-8 step's (the forward ones run there in
both roles), their times those of the step's 2B = 16 forward or weight
gradient role (both passes for a weight gradient; the reduce alone at the
stem's), each role's times beside them; the two pad kernels' launches are
the batch-8 step's, their times those of the head's pad at the step's
2B = 16, the decode's batch-8 head pad, every role's timed row and the
sums a step and a volume beside them; the four conv4s2 kernels' launches are the batch-8 step's, their
times those of the step's largest call (the forward and the weight
gradient at 16, the input gradient at 8), the other batch size beside. ``--json-out PATH`` also writes every shape's numbers. The last line
is {"ok": true, "device": {...}}. Without CUDA the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from mra_gan_tpu_torch.utils.profiling import (gpu_line, peak_rates, plain_norms,
                                                profile_run)

SEED = 0
DEVICE = "cuda"
PATCH = (64, 64, 64)
VOLUME = (128, 256, 256)  # bench.py:80
STRIDE = 32
DECODE_BATCH = 8
# phase 5's timed decodes: the median phase 15 holds the benchmark to is over
# the benchmark's window (BENCHMARK.json decode-sw-128x256x256 timed). Run
# eagerly the host set a decode's pace (the card idle 50-70% of it since the
# pads' kernels) and the host's load moved it from one decode to the next;
# the generator's forward is now replayed from CUDA graphs
DECODE_REPEATS = 40
# then as many eager decodes (no CUDA graphs), bit-equal to the replays
DECODE_EAGER = 5
EXPECTED_GRID = (147, 19)  # patches, batches
CLI_SHAPES = [(96, 128, 77), (128, 128, 64), (100, 90, 45)]  # odd, even, sub-patch Z
NGF = 32
NDF = 32
TRAIN_BATCHES = (1, 8)  # bench.py:186-251
TRAIN_LR = 2e-4
NORMS_PER_STEP = 80  # 4 generator applies x 17 norms + 4 discriminator applies x 3
TRAIN_WARMUP = 5  # the benchmark's train cell's warm-up (BENCHMARK.json train-b8-p64)
TRAIN_TIMED_STEPS = (5, 40)  # at batch 1 and 8: at batch 8 the train cell's window
CKPT_STEPS = 2  # phase 9: steps before the save, and again after it
CKPT_DECODE_SHAPE = (80, 72, 40)
PAIRED_ACTS = ("leaky_relu", "tanh")
BENCH_RTOL = 0.15  # phase 15: the benchmark's readings against phases 5 and 7
BF16_ULP = 2.0 ** -8
# f32 operations per element, for the operations bound
APPLY_OPS = {"none": 2, "relu": 3, "leaky_relu": 4, "tanh": 10}
STATS_OPS = 4  # Welford at a shared reciprocal: sub, fma, sub, fma
SLAB_OPS = 3  # the sum (add), then the centred square (sub, fma); the apply's beside it
MERGE_OPS = 12  # Chan merge per partial (the apply's prologue)
ACT_GRAD_OPS = {"none": 0, "relu": 1, "leaky_relu": 1, "tanh": 10}
BWD_STATS_OPS = 6  # z (sub, mul), g' (mul), two sums, g'z (mul) + act'
BWD_APPLY_OPS = 7  # z (sub, mul), g' (mul), sub, fma, mul + act'
# block targets at which the two-pass backward is also timed, with
# K.num_segments alone (no merge bound, K.backward_segments)
BWD_TARGETS = (132 * 2, 132 * 3, 132 * 4, 132 * 8)
# the 7^3 convs of the resnet stem and head on the conv7 kernels: (role,
# kernel, pad, the input's edge, the batch sizes the paths give it): the
# decode's 8 and last 3, the step's 2B = 16 (leaf applies) and B = 8 (cycle
# applies), 2 and 1 at batch 1; the stem's input gradient on the cycle
# applies only (the leaf applies' inputs are real images)
CONV7_ROLES = (
    ("stem forward", "conv7_spread", 0, 70, (16, 8, 3, 2, 1)),
    ("head input grad", "conv7_spread", 6, 64, (16, 8, 2, 1)),
    ("head forward", "conv7_gather", 0, 70, (16, 8, 3, 2, 1)),
    ("stem input grad", "conv7_gather", 6, 64, (8, 1)),
)
CONV7_TIMED = (16, 8)  # phase 3 times each role at the cells' batch sizes
# phase 2's further cases for both kernels at both pads and for both weight
# gradients: (what, N, C, input box): an odd unequal box (2 W is no multiple
# of 16, W odd: the one-channel field goes voxel by voxel), C = 4 (no
# tensor map: the threads' loader and stores), C = 40 (a partial second
# channel group), C = 96 and 128 (three and four groups: the spread's walk
# changes weights between groups, the gather runs each row once a group, a
# weight gradient runs a grid a group) and phase 14's shard boxes
CONV7_EXTRA = (("odd box", 2, NGF, (75, 69, 71)), ("C=4", 2, 4, (40, 38, 42)),
               ("C=40", 2, 40, (40, 38, 42)), ("C=96", 2, 96, (40, 38, 42)),
               ("C=128", 2, 128, (40, 38, 42)))
# the weight gradients of the stem and head: (role, kernel, the batch sizes
# the step gives it: 2B = 16 and B = 8 at batch 8, 2 and 1 at batch 1); each
# at the 70^3 input box, and at phase 14's spatial steps' shard boxes
# (CONV7_SHARD_BOXES: (N, input box) of the 2-way 1 x 64^3 and 2 x 128^3
# steps' leaf applies and the 4-way 1 x 64^3 step's cycle applies)
CONV7_WGRAD_ROLES = (
    ("stem weight grad", "conv7_wgrad_spread", (16, 8, 2, 1)),
    ("head weight grad", "conv7_wgrad_gather", (16, 8, 2, 1)),
)
CONV7_SHARD_BOXES = ((2, (38, 70, 70)), (4, (70, 134, 134)), (1, (22, 70, 70)))
# conv7 launches: per generator forward (stem and head), and per train step
# (4 generator applies, each a stem and a head forward, a head input
# gradient and both weight gradients, each of two passes; the 2 cycle
# applies a stem input gradient)
CONV7_PER_FORWARD = {"conv7_spread": 1, "conv7_gather": 1}
CONV7_PER_STEP = {"conv7_spread": 8, "conv7_gather": 6, "conv7_wgrad_spread": 4,
                  "conv7_wgrad_gather": 4, "conv7_wgrad_reduce": 8}
# replication-pad launches: per generator forward (the stem's and the head's
# 3-voxel pads, two 1-voxel pads in each of the 6 residual blocks), and per
# train step (4 generator applies; each pad's backward but the stems' of the
# 2 leaf applies, whose inputs are real images)
PAD_PER_FORWARD = {"replication_pad_fwd": 14}
PAD_PER_STEP = {"replication_pad_fwd": 56, "replication_pad_bwd": 54}
# the same by (kernel, role, N): a forward runs 1 stem, 12 trunk and 1 head
# pad; a batch-8 step applies each generator once at 2B = 16 and once at
# B = 8 (models/cycle_gan.py:355-361), every pad but the stems at 2B (real
# images) running its backward; a decoded 128x256x256 volume is 18 batches
# of 8 patches and one of 3 (phase 2 weights its timed rows by these)
PAD_ROLES = {"stem": 1, "trunk": 12, "head": 1}
PAD_STEP_LAUNCHES = {
    **{("replication_pad_fwd", role, n): 2 * k for n in (16, 8) for role, k in PAD_ROLES.items()},
    **{("replication_pad_bwd", role, n): 2 * k for n in (16, 8) for role, k in PAD_ROLES.items()
       if (role, n) != ("stem", 16)}}
PAD_VOLUME_LAUNCHES = {("replication_pad_fwd", role, n): calls * k
                       for role, k in PAD_ROLES.items() for n, calls in ((8, 18), (3, 1))}
# the pad shapes phase 2 times: the decode's last batch of 3 and its batch 8,
# the step's B = 8 and 2B = 16
PAD_TIMED = (EXPECTED_GRID[0] % DECODE_BATCH, DECODE_BATCH, 2 * max(TRAIN_BATCHES))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def dispatch_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """CUDA-event time per call of back-to-back calls: where the host's
    dispatch is slower than the device, this is the host's time."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time per call. The calls are queued behind a GPU sleep that
    outlasts their enqueue, so the card runs them back to back and the
    host's dispatch cost is hidden; CUDA events bracket the calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_ms = 4.0 * (time.perf_counter() - t0) * 1e3 * iters + 5.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_cycles_per_ms() * sleep_ms))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if enqueue_ms > sleep_ms:
        print(f"[timing] enqueue {enqueue_ms:.2f} ms outlasted the {sleep_ms:.2f} ms sleep; "
              f"the time below includes host gaps", flush=True)
    return start.elapsed_time(end) / iters


def lib_act(act: str):
    """The library yardstick's activation, torch's own."""
    import torch
    import torch.nn.functional as F

    return {"none": lambda y: y, "relu": F.relu,
            "leaky_relu": lambda y: F.leaky_relu(y, 0.2), "tanh": torch.tanh}[act]


def bf16_ulps(got, ref) -> float:
    """Largest |got - ref| in bfloat16 ulps of max(|ref|, 1): the outputs
    are unit-variance, so values below 1 are held to the ulp at 1."""
    import torch

    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1.0))) - 7)
    return float(((got.float() - ref).abs() / ulp).max())


def random_jax_tree(ngf: int, n_blocks: int, seed: int) -> dict:
    """A resnet generator's parameters as the JAX package lays them out
    (kernels DHWIO), drawn with numpy at O(1) activation scale: kernel std
    1/sqrt(fan_in), bias std 0.1."""
    import numpy as np

    rng = np.random.RandomState(seed)

    def conv(k, cin, cout):
        kern = rng.randn(k, k, k, cin, cout) / math.sqrt(k ** 3 * cin)
        return {"kernel": kern.astype(np.float32),
                "bias": (0.1 * rng.randn(cout)).astype(np.float32)}

    tree = {"Conv3D_0": conv(7, 1, ngf), "Conv3D_1": conv(3, ngf, 2 * ngf),
            "Conv3D_2": conv(3, 2 * ngf, 4 * ngf)}
    for i in range(n_blocks):
        tree[f"ResnetBlock3D_{i}"] = {"Conv3D_0": conv(3, 4 * ngf, 4 * ngf),
                                      "Conv3D_1": conv(3, 4 * ngf, 4 * ngf)}
    tree["ConvTranspose3D_0"] = conv(3, 4 * ngf, 2 * ngf)
    tree["ConvTranspose3D_1"] = conv(3, 2 * ngf, ngf)
    tree["Conv3D_3"] = conv(7, ngf, 1)
    return {"params": tree}


def norm_shapes():
    """(label, (N, C, D, H, W), act) of every forward instance norm of the
    decode path: batch 8, the short last batch of 3 (147 = 18 * 8 + 3), and
    the single pass over the whole volume."""
    out = []
    for label, n, sp in (("b8", DECODE_BATCH, PATCH), ("b3", 3, PATCH), ("single", 1, VOLUME)):
        for c, div, act in ((NGF, 1, "relu"), (2 * NGF, 2, "relu"),
                            (4 * NGF, 4, "relu"), (4 * NGF, 4, "none")):
            out.append((label, (n, c) + tuple(s // div for s in sp), act))
    return out


def train_norm_shapes():
    """(label, (N, C, D, H, W), act) of every instance norm of the train step
    at batch 1 and 8, each run forward and backward: the generator at 2B
    (the leaf applies) and B (the chains), the PatchGAN at B (in the G loss)
    and 2B (the D loss)."""
    out = []
    for b in TRAIN_BATCHES:
        for n in (2 * b, b):
            for c, div, act in ((NGF, 1, "relu"), (2 * NGF, 2, "relu"),
                                (4 * NGF, 4, "relu"), (4 * NGF, 4, "none")):
                out.append((f"G b{b}", (n, c) + tuple(s // div for s in PATCH), act))
            for c, side in ((2 * NDF, 16), (4 * NDF, 8), (8 * NDF, 7)):
                out.append((f"D b{b}", (n, c, side, side, side), "leaky_relu"))
    return list(dict.fromkeys(out))  # the D shapes at N = 2 and 8 come twice


def _volume(gen, shape, dtype, scale=3.0, shift=1.0):
    import torch

    x = (torch.randn(shape, generator=gen, device=DEVICE) * scale + shift).to(dtype)
    return x.contiguous(memory_format=torch.channels_last_3d)


def forward_case(K, label, shape, act, dtype, bw, flops, results, gen) -> None:
    """The forward kernels of the shape's route (K.uses_slab: the slab kernel,
    or stats then apply) against their plain versions at one shape, and the
    whole forward against instance_norm_act_plain; then timed beside the
    plain versions, the library yardsticks and the bounds. At a slab shape
    the two-pass kernels are timed too, for comparison in the same run."""
    import torch
    import torch.nn.functional as F

    x = _volume(gen, shape, dtype)
    n, c = shape[:2]
    v = math.prod(shape[2:])
    es = x.element_size()
    bf16 = dtype == torch.bfloat16
    slab = K.uses_slab(shape, dtype)
    seg = K.forward_segments(x)
    stat_bytes = 2 * n * c * 4
    part_bytes = 2 * n * seg * c * 4
    big = x.numel() * es >= 100e6
    iters = 10 if big else 30
    # the same float32 arithmetic rounded once: 1 bf16 ulp, or 1e-5 in f32
    one_rounding = (lambda y, ref: bf16_ulps(y, ref) <= 1.0) if bf16 else (
        lambda y, ref: float((y.float() - ref.float()).abs().max()) <= 1e-5)

    def stats_close(m, r, fm, fr):
        return (torch.allclose(m, fm, rtol=1e-5, atol=1e-6)
                and torch.allclose(r, fr, rtol=1e-5, atol=1e-6))

    t, p, lib, bounds, errs, extra = {}, {}, {}, {}, {}, {}
    if slab:
        y, m, r = K.instance_norm_slab(x, act, 0.2)
        yp, mp, rp = K.slab_plain(x, act, 0.2)
        errs["instance_norm_slab"] = float((y.float() - yp.float()).abs().max())
        check(one_rounding(y, yp) and stats_close(m, r, mp, rp),
              f"slab {label} {shape} {dtype}: {errs['instance_norm_slab']}")
        t["instance_norm_slab"] = device_ms(lambda: K.instance_norm_slab(x, act, 0.2), iters)
        p["instance_norm_slab"] = device_ms(lambda: K.slab_plain(x, act, 0.2), iters)
        bounds["instance_norm_slab"] = max((2 * x.numel() * es + stat_bytes) / bw,
                                           (SLAB_OPS + APPLY_OPS[act]) * x.numel() / flops)
    else:
        pm, pq = K.instance_norm_stats(x, seg)
        rm, rq = K.stats_plain(x, seg)
        cnt = max(b - a for a, b in zip(K.segment_bounds(v, seg), K.segment_bounds(v, seg)[1:]))
        # partial sums in two summation orders, float32
        errs["instance_norm_stats"] = max(float((pm - rm).abs().max()),
                                          float((pq - rq).abs().max()) / cnt)
        check(torch.allclose(pm, rm, rtol=1e-4, atol=1e-5)
              and torch.allclose(pq, rq, rtol=1e-4, atol=1e-3),
              f"stats {label} {shape} {dtype}: {errs['instance_norm_stats']}")
        y, m, r = K.instance_norm_apply(x, pm, pq, act, 0.2)
        fm, fr = K.finalize_plain(pm, pq, v)
        ya = K.apply_plain(x, m, r, act, 0.2)
        errs["instance_norm_apply"] = max(float((y.float() - ya.float()).abs().max()),
                                          float((m - fm).abs().max()), float((r - fr).abs().max()))
        check(one_rounding(y, ya) and stats_close(m, r, fm, fr),
              f"apply {label} {shape} {dtype}: {errs['instance_norm_apply']}")
        t["instance_norm_stats"] = device_ms(lambda: K.instance_norm_stats(x, seg), iters)
        t["instance_norm_apply"] = device_ms(
            lambda: K.instance_norm_apply(x, pm, pq, act, 0.2), iters)
        p["instance_norm_stats"] = device_ms(lambda: K.stats_plain(x, seg), 3, 1)
        p["instance_norm_apply"] = device_ms(
            lambda: K.apply_plain(x, *K.finalize_plain(pm, pq, v), act), iters)
        # the stats kernel's yardstick: per-(n, c) mean and variance
        lib["instance_norm_stats"] = device_ms(
            lambda: torch.var_mean(x, dim=(2, 3, 4), correction=0), iters)
        bounds["instance_norm_stats"] = max((x.numel() * es + part_bytes) / bw,
                                            STATS_OPS * x.numel() / flops)
        bounds["instance_norm_apply"] = max(
            (2 * x.numel() * es + part_bytes + stat_bytes) / bw,
            (APPLY_OPS[act] * x.numel() + MERGE_OPS * n * seg * c) / flops)

    yk = K.instance_norm_act_fused(x, act, 0.2)
    yp = K.instance_norm_act_plain(x, act, 0.2)
    check(yk.is_contiguous(memory_format=torch.channels_last_3d) and yk.dtype == dtype,
          "fused output layout and dtype")
    err_norm = float((yk.float() - yp.float()).abs().max())
    ulps = bf16_ulps(yk, yp) if bf16 else None
    check(ulps <= 2.0 if bf16 else err_norm <= 1e-5,
          f"instance_norm_act {label} {shape} {dtype}: {err_norm} ({ulps} ulps)")
    errs["instance_norm_act"] = err_norm
    t["instance_norm_act"] = device_ms(lambda: K.instance_norm_act_fused(x, act, 0.2), iters)
    p["instance_norm_act"] = device_ms(lambda: K.instance_norm_act_plain(x, act), iters)
    extra["instance_norm_act"] = {
        "route": "slab" if slab else "two_pass",
        "dispatch_ms": dispatch_ms(lambda: K.instance_norm_act_fused(x, act, 0.2), iters)}
    if slab:
        extra["instance_norm_act"]["two_pass_ms"] = device_ms(
            lambda: K.instance_norm_two_pass(x, act, 0.2), iters)
    else:
        # what PyTorch's own streaming kernels reach on the same bytes: the
        # stats kernel's read-only pass against a sum, the apply's read and
        # write against a copy
        out = torch.empty_like(x)
        extra["instance_norm_act"]["sum_ms"] = device_ms(lambda: x.sum(), iters)
        extra["instance_norm_act"]["copy_ms"] = device_ms(lambda: out.copy_(x), iters)
        del out
    lib["instance_norm_act"] = device_ms(lambda: lib_act(act)(F.instance_norm(x)), iters)
    lib["instance_norm_slab"] = lib["instance_norm_act"] if slab else None
    ops = SLAB_OPS if slab else STATS_OPS
    bounds["instance_norm_act"] = max(2 * x.numel() * es / bw,
                                      (ops + APPLY_OPS[act]) * x.numel() / flops)
    dname = "bf16" if bf16 else "f32"
    for k in t:
        results[k]["shapes"].append({
            "path": label, "shape": list(shape), "dtype": dname, "act": act,
            "segments": None if slab else seg, "ms": t[k], "plain_ms": p[k],
            "library_ms": lib.get(k), **extra.get(k, {}),
            "bound_ms": bounds[k] * 1e3, "max_abs_err": errs[k]})
    parts = ", ".join(f"{k.replace('instance_norm_', '')} {t[k]:.4f}"
                      for k in t if k != "instance_norm_act")
    more = f" two_pass {extra['instance_norm_act']['two_pass_ms']:.4f}" if slab else ""
    print(f"[kernels] {label:8s} {str(shape):28s} {dname} {act:10s} "
          f"{'slab' if slab else f'S={seg}':7s} norm {t['instance_norm_act']:.4f} ms ({parts}){more} "
          f"dispatch {extra['instance_norm_act']['dispatch_ms']:.4f} "
          f"plain {p['instance_norm_act']:.4f} lib {lib['instance_norm_act']:.4f} "
          f"bound {bounds['instance_norm_act'] * 1e3:.4f} ms  err {err_norm:.3g}"
          + (f" ({ulps:.2f} ulp)" if bf16 else ""), flush=True)


def backward_case(K, label, shape, act, dtype, bw, flops, results, gen) -> None:
    """The backward kernels of the shape's route (K.uses_slab: the bwd slab
    kernel, or bwd stats then bwd apply) against their plain versions at one
    shape, the whole kernel backward against the plain step-by-step backward
    (instance_norm_act_bwd_plain, JAX _in_vjp_bwd) and against float32, then
    timed beside the plain versions, the library yardstick (autograd of
    F.instance_norm + activation) and the bounds. At a slab shape the
    two-pass backward is timed on the same input too; at a two-pass shape in
    bfloat16, the two-pass kernels at each of BWD_TARGETS."""
    import torch
    import torch.nn.functional as F

    x = _volume(gen, shape, dtype)
    g = _volume(gen, shape, dtype, 1.0, 0.0)
    n, c = shape[:2]
    v = math.prod(shape[2:])
    es = x.element_size()
    bf16 = dtype == torch.bfloat16
    slab = K.uses_slab(shape, dtype)
    _, mean, rstd = K.instance_norm_act_fwd(x, act, 0.2)
    seg = K.backward_segments(x, g)
    big = x.numel() * es >= 100e6
    iters = 10 if big else 30
    part_bytes = 2 * n * seg * c * 4
    stat_bytes = 2 * n * c * 4
    ops = ACT_GRAD_OPS[act]

    def dx_close(name, dx, ref):
        # the same float32 arithmetic rounded once: 1 bf16 ulp of the
        # largest |dx|, or 1e-5 of it in f32
        dmax = float(ref.float().abs().max())
        err = float((dx.float() - ref.float()).abs().max())
        check(dx.dtype == dtype and dx.is_contiguous(memory_format=torch.channels_last_3d)
              and err <= (BF16_ULP if bf16 else 1e-5) * dmax,
              f"{name} {label} {shape} {dtype}: {err:.3g}, max|dx| {dmax:.3g}")
        return err

    t, p, bounds, errs = {}, {}, {}, {}
    if slab:
        dx = K.instance_norm_bwd_slab(x, g, mean, rstd, act, 0.2)
        errs["instance_norm_bwd_slab"] = dx_close(
            "bwd_slab", dx, K.bwd_slab_plain(x, g, mean, rstd, act, 0.2))
        t["instance_norm_bwd_slab"] = device_ms(
            lambda: K.instance_norm_bwd_slab(x, g, mean, rstd, act, 0.2), iters)
        p["instance_norm_bwd_slab"] = device_ms(
            lambda: K.bwd_slab_plain(x, g, mean, rstd, act, 0.2), iters)
        bounds["instance_norm_bwd_slab"] = max(
            (3 * x.numel() * es + stat_bytes) / bw,
            (BWD_STATS_OPS + BWD_APPLY_OPS + 2 * ops) * x.numel() / flops)
    else:
        pg, pgz = K.instance_norm_bwd_stats(x, g, mean, rstd, seg, act, 0.2)
        rg, rgz = K.bwd_stats_plain(x, g, mean, rstd, seg, act, 0.2)
        # float32 sums of one segment's terms in two orders, against the largest partial
        scale = max(float(rg.abs().max()), float(rgz.abs().max()), 1e-30)
        errs["instance_norm_bwd_stats"] = max(float((pg - rg).abs().max()),
                                              float((pgz - rgz).abs().max()))
        check(errs["instance_norm_bwd_stats"] <= 1e-5 * scale,
              f"bwd_stats {label} {shape} {dtype}: {errs['instance_norm_bwd_stats']:.3g} "
              f"against partials up to {scale:.3g}")
        dx = K.instance_norm_bwd_apply(x, g, mean, rstd, pg, pgz, act, 0.2)
        gm, gzm = K.bwd_finalize_plain(pg, pgz, v)
        errs["instance_norm_bwd_apply"] = dx_close(
            "bwd_apply", dx, K.bwd_apply_plain(x, g, mean, rstd, gm, gzm, act, 0.2))
        t["instance_norm_bwd_stats"] = device_ms(
            lambda: K.instance_norm_bwd_stats(x, g, mean, rstd, seg, act, 0.2), iters)
        t["instance_norm_bwd_apply"] = device_ms(
            lambda: K.instance_norm_bwd_apply(x, g, mean, rstd, pg, pgz, act, 0.2), iters)
        p["instance_norm_bwd_stats"] = device_ms(
            lambda: K.bwd_stats_plain(x, g, mean, rstd, seg, act, 0.2), 3, 1)
        p["instance_norm_bwd_apply"] = device_ms(
            lambda: K.bwd_apply_plain(x, g, mean, rstd, *K.bwd_finalize_plain(pg, pgz, v),
                                      act, 0.2), iters)
        bounds["instance_norm_bwd_stats"] = max(
            (2 * x.numel() * es + stat_bytes + part_bytes) / bw,
            (BWD_STATS_OPS + ops) * x.numel() / flops)
        bounds["instance_norm_bwd_apply"] = max(
            (3 * x.numel() * es + stat_bytes + part_bytes) / bw,
            ((BWD_APPLY_OPS + ops) * x.numel() + 2 * n * seg * c) / flops)

    dk = K.instance_norm_act_bwd_fused(x, g, mean, rstd, act, 0.2).float()
    dp = K.instance_norm_act_bwd_plain(x, g, mean, rstd, act, 0.2).float()
    d32 = K.instance_norm_act_bwd_plain(x.float(), g.float(), mean, rstd, act, 0.2)
    dmax = float(d32.abs().max())
    diff = (dk - dp).abs() / dmax
    err_k, err_p = float((dk - d32).abs().mean()), float((dp - d32).abs().mean())
    if bf16:
        # The plain version rounds z, g' and every step of dx to bf16, the
        # kernel only dx: a relu mask flips where x lies between the float32
        # mean and its bf16 rounding. Held to: mean |diff| <= 1 bf16 ulp of
        # max |dx|, and the kernel no farther from float32 than the plain
        # version is (mean |error|, x1.25).
        check(float(diff.mean()) <= BF16_ULP and err_k <= 1.25 * err_p,
              f"bwd {label} {shape} bf16: mean {float(diff.mean()):.3g} max "
              f"{float(diff.max()):.3g} of max|dx|; vs f32 kernel {err_k:.3g} plain {err_p:.3g}")
    else:
        check(float(diff.max()) <= 1e-5, f"bwd {label} {shape} f32: {float(diff.max()):.3g}")
    errs["instance_norm_act_bwd"] = float((dk - dp).abs().max())

    t["instance_norm_act_bwd"] = device_ms(
        lambda: K.instance_norm_act_bwd_fused(x, g, mean, rstd, act, 0.2), iters)
    p["instance_norm_act_bwd"] = device_ms(
        lambda: K.instance_norm_act_bwd_plain(x, g, mean, rstd, act, 0.2), iters)
    extra = {"route": "slab" if slab else "two_pass",
             "dispatch_ms": dispatch_ms(
                 lambda: K.instance_norm_act_bwd_fused(x, g, mean, rstd, act, 0.2), iters),
             "vs_plain_mean": float(diff.mean()), "vs_plain_max": float(diff.max()),
             "vs_f32_kernel": err_k, "vs_f32_plain": err_p}
    if slab:
        extra["two_pass_ms"] = device_ms(
            lambda: K.instance_norm_bwd_two_pass(x, g, mean, rstd, act, 0.2), iters)
    elif bf16:
        # the two-pass backward at other segment counts than K.backward_segments
        vec = K.pair_width(x, g)
        extra["targets_ms"] = {}
        for target in BWD_TARGETS:
            s = K.num_segments(n, v, c, vec, target)

            def two_pass(s=s):
                sums = K.instance_norm_bwd_stats(x, g, mean, rstd, s, act, 0.2)
                K.instance_norm_bwd_apply(x, g, mean, rstd, *sums, act, 0.2)

            extra["targets_ms"][target] = {"segments": s, "ms": device_ms(two_pass, iters)}
    xl = x.detach().requires_grad_()
    yl = lib_act(act)(F.instance_norm(xl))
    lib = device_ms(lambda: torch.autograd.grad(yl, xl, g, retain_graph=True), iters)
    del yl, xl
    bounds["instance_norm_act_bwd"] = max(
        3 * x.numel() * es / bw, (BWD_STATS_OPS + BWD_APPLY_OPS + 2 * ops) * x.numel() / flops)
    dname = "bf16" if bf16 else "f32"
    for k in t:
        whole = k in ("instance_norm_act_bwd", "instance_norm_bwd_slab")
        results[k]["shapes"].append({
            "path": label, "shape": list(shape), "dtype": dname, "act": act,
            "segments": None if slab else seg, "ms": t[k], "plain_ms": p[k],
            "library_ms": lib if whole else None,
            **(extra if k == "instance_norm_act_bwd" else {}),
            "bound_ms": bounds[k] * 1e3, "max_abs_err": errs[k]})
    parts = ", ".join(f"{k.replace('instance_norm_bwd_', '')} {t[k]:.4f}"
                      for k in t if k != "instance_norm_act_bwd")
    more = f" two_pass {extra['two_pass_ms']:.4f}" if slab else ""
    more += "".join(f" [{tg}: S={r['segments']} {r['ms']:.4f}]"
                    for tg, r in extra.get("targets_ms", {}).items())
    print(f"[bwd]     {label:6s} {str(shape):28s} {dname} {act:10s} "
          f"{'slab' if slab else f'S={seg}':7s} bwd {t['instance_norm_act_bwd']:.4f} ms "
          f"({parts}){more} dispatch {extra['dispatch_ms']:.4f} "
          f"plain {p['instance_norm_act_bwd']:.4f} lib {lib:.4f} "
          f"bound {bounds['instance_norm_act_bwd'] * 1e3:.4f} ms  vs plain mean "
          f"{float(diff.mean()):.3g} max {float(diff.max()):.3g}", flush=True)


def phase_kernels(K, bw: float, flops: float, results: dict) -> None:
    import torch

    cases = [(lbl, s, a, dt) for lbl, s, a in norm_shapes()
             for dt in (torch.bfloat16, torch.float32)
             if not (lbl == "b3" and dt == torch.float32)]
    cases += [("small", (2, NGF, 16, 16, 16), a, dt) for a in PAIRED_ACTS
              for dt in (torch.bfloat16, torch.float32)]
    # C = 6 is no multiple of a 16-byte vector: the one-element-per-thread kernels
    cases += [("odd_c", (2, 6, 16, 16, 16), "relu", dt) for dt in (torch.bfloat16, torch.float32)]
    # the largest instance the slab kernel takes at C = 128: 16 x 16 x 28 voxels
    edge = (2, 4 * NGF, 16, 16, 28)
    for dt in (torch.bfloat16, torch.float32):
        check(K.uses_slab(edge, dt) and math.prod(edge[2:]) == K.SLAB_BYTES // K.SLAB_CHUNK
              and not K.uses_slab(edge[:2] + (math.prod(edge[2:]) + 1, 1, 1), dt),
              f"{edge} {dt} is the largest slab instance at C = {edge[1]}")
        cases.append(("boundary", edge, "relu", dt))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for case in cases:
        forward_case(K, *case, bw, flops, results, gen)
        if case[0] in ("small", "odd_c", "boundary"):
            backward_case(K, *case, bw, flops, results, gen)
    torch.cuda.empty_cache()


def phase_train_kernels(K, bw: float, flops: float, results: dict) -> None:
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    for label, shape, act in train_norm_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            forward_case(K, label, shape, act, dtype, bw, flops, results, gen)
            backward_case(K, label, shape, act, dtype, bw, flops, results, gen)
        torch.cuda.empty_cache()


def with_wholes(launches: dict) -> dict:
    """Launch counts with the two whole-norm entries of the report added:
    one forward per slab or apply launch, one backward per bwd slab or bwd
    apply launch."""
    return {**launches,
            "instance_norm_act": launches["instance_norm_slab"] + launches["instance_norm_apply"],
            "instance_norm_act_bwd": (launches["instance_norm_bwd_slab"]
                                      + launches["instance_norm_bwd_apply"])}


def generator_norms(n: int, spatial) -> list:
    """(N, C, D, H, W) of the 17 norms of one resnet_6blocks forward on
    ``spatial`` input: the stem and up2 at full size, down1 and up1 at half,
    down2 and the 12 trunk norms at a quarter."""
    out = []
    for c, div, count in ((NGF, 1, 2), (2 * NGF, 2, 2), (4 * NGF, 4, 13)):
        out += [(n, c) + tuple(s // div for s in spatial)] * count
    return out


def patchgan_norms(n: int) -> list:
    """(N, C, D, H, W) of the 3 norms of one 3-layer PatchGAN on 64^3."""
    return [(n, 2 * NDF, 16, 16, 16), (n, 4 * NDF, 8, 8, 8), (n, 8 * NDF, 7, 7, 7)]


def forward_launches(K, shapes, dtype) -> dict:
    """Each forward kernel's launches for norms of these shapes: one slab
    launch where K.uses_slab holds, one stats and one apply elsewhere."""
    slab = sum(K.uses_slab(s, dtype) for s in shapes)
    return {"instance_norm_slab": slab, "instance_norm_stats": len(shapes) - slab,
            "instance_norm_apply": len(shapes) - slab}


def backward_launches(K, shapes, dtype) -> dict:
    """Each backward kernel's launches for norms of these shapes: one bwd
    slab launch where K.uses_slab holds, one bwd stats and one bwd apply
    elsewhere."""
    slab = sum(K.uses_slab(s, dtype) for s in shapes)
    return {"instance_norm_bwd_slab": slab, "instance_norm_bwd_stats": len(shapes) - slab,
            "instance_norm_bwd_apply": len(shapes) - slab}


def times(counts: dict, k: int) -> dict:
    return {name: n * k for name, n in counts.items()}


def launched(K, want: dict) -> bool:
    """Every norm kernel, forward and backward, launched as often as
    ``want`` says (0 where it names none) since the counters were zeroed."""
    return all(K.LAUNCHES[k] == want.get(k, 0) for k in K.FORWARD + K.BACKWARD)


def conv7_launched(want: dict) -> bool:
    """Each conv7 kernel launched as often as ``want`` says (0 where it
    names none) since its counters were zeroed."""
    from mra_gan_tpu_torch.ops.kernels import conv7 as C7

    return all(C7.LAUNCHES[k] == want.get(k, 0) for k in C7.LAUNCHES)


def conv7_case(kernel: str, pad: int, box, n: int, gen, c: int = NGF):
    """One role's bf16 inputs on the card at O(1) output scale: the field
    (one channel, or c in channels_last_3d) of input box ``box`` (an edge:
    a cube), the (c, 7, 7, 7) taps and the bias (forward roles only: an
    input gradient has none)."""
    import torch

    spread = kernel == "conv7_spread"
    box = (box,) * 3 if isinstance(box, int) else tuple(box)
    field = torch.randn((n, 1 if spread else c) + box, generator=gen, device=DEVICE).bfloat16()
    if not spread:
        field = field.contiguous(memory_format=torch.channels_last_3d)
    fan_in = 343 * (1 if spread else c)
    w = (torch.randn((c, 7, 7, 7), generator=gen, device=DEVICE) / math.sqrt(fan_in)).bfloat16()
    b = None
    if pad == 0:
        b = (0.1 * torch.randn((c if spread else 1,), generator=gen, device=DEVICE)).bfloat16()
    return field, w, b


def conv7_cases():
    """Phase 2's cases: (role, kernel, pad, N, C, input box), every role at
    every batch size of CONV7_ROLES, then CONV7_EXTRA and the shard boxes
    for both kernels at both pads."""
    for role, kernel, pad, edge, batches in CONV7_ROLES:
        for n in batches:
            yield role, kernel, pad, n, NGF, (edge,) * 3
    for kernel in ("conv7_spread", "conv7_gather"):
        for pad in (0, 6):
            for what, n, c, box in CONV7_EXTRA:
                yield f"{what} pad {pad}", kernel, pad, n, c, box
            for n, box in CONV7_SHARD_BOXES:
                yield f"shard box pad {pad}", kernel, pad, n, NGF, box


def phase_conv7_kernels(results: dict) -> None:
    """Phase 2's conv7 part: each case of conv7_cases against float32
    F.conv3d of the same bf16 inputs with TF32 off, each run twice and
    bit-equal. Bar, elementwise: |kernel - ref| <= 2^-8 |ref| + 2^-12
    max|ref|: half an ulp of each element (the kernel rounds once) plus 1/16
    of an ulp at the output's scale for the order of the float32 sums."""
    import torch

    from mra_gan_tpu_torch.ops.kernels import conv7 as C7

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for role, kernel, pad, n, c, box in conv7_cases():
            field, w, b = conv7_case(kernel, pad, box, n, gen, c)
            fn = getattr(C7, kernel)
            y, again = fn(field, w, b, pad), fn(field, w, b, pad)
            torch.cuda.synchronize()
            # the plain version on float32 input: float32 F.conv3d, not rounded
            ref = getattr(C7, f"{kernel}_plain")(field.float(), w, b, pad)
            out = (n, c if kernel == "conv7_spread" else 1) + tuple(s + 2 * pad - 6 for s in box)
            check(tuple(y.shape) == out and y.dtype == torch.bfloat16,
                  f"{kernel} {role} n={n}: shape {tuple(y.shape)}, want {out}")
            check(torch.equal(y, again), f"{kernel} {role} n={n} {box}: two runs differ")
            err = (y.float() - ref).abs()
            scale = float(ref.abs().max())
            worst = float((err - 2 ** -8 * ref.abs()).max()) / scale
            results[kernel]["shapes"].append({
                "role": role, "n": n, "shape": list(field.shape), "pad": pad,
                "max_abs_err": float(err.max()), "out_scale": scale,
                "over_half_ulp_rel": worst})
            print(f"[conv7] {role:16s} {kernel} n={n:2d} {str(tuple(field.shape)):24s} "
                  f"max err {float(err.max()):.3g} at scale {scale:.3g}; beyond half an "
                  f"ulp {worst:.3g} of the scale (bar 2^-12); bit-equal twice", flush=True)
            check(worst <= 2 ** -12, f"{kernel} {role} n={n} {box}: {worst} > 2^-12")
            del field, w, b, y, again, ref, err
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def conv7_wgrad_case(kernel: str, n: int, box, gen, c: int = NGF):
    """A weight gradient's bf16 inputs on the card for the input box
    ``box``, laid out as the step gives them: (field, one) = (g in
    channels_last_3d, a) for the stem, (x in channels_last_3d, g) for the
    head; the C-channel one (c channels) at O(1)."""
    import torch

    out = tuple(s - 6 for s in box)
    c_box, one_box = (out, box) if kernel == "conv7_wgrad_spread" else (box, out)
    field = torch.randn((n, c, *c_box), generator=gen, device=DEVICE).bfloat16()
    one = torch.randn((n, 1, *one_box), generator=gen, device=DEVICE).bfloat16()
    return field.contiguous(memory_format=torch.channels_last_3d), one


def conv7_wgrad_call(C7, kernel: str, field, one):
    """The wrapper, its plain version's arguments in the wrapper's order."""
    if kernel == "conv7_wgrad_spread":
        return (lambda: C7.conv7_wgrad_spread(one, field)), (one, field)
    return (lambda: C7.conv7_wgrad_gather(field, one)), (field, one)


def conv7_wgrad_cases():
    """Phase 2's weight-gradient cases: (role, kernel, N, C, input box),
    each role at every batch size of CONV7_WGRAD_ROLES (the 70^3 input
    box), at CONV7_SHARD_BOXES and at CONV7_EXTRA (the odd box: the
    one-channel field voxel by voxel; C = 4: no tensor map; C = 40: a
    partial second group; C = 96 and 128: a grid a group)."""
    for role, kernel, batches in CONV7_WGRAD_ROLES:
        for n in batches:
            yield role, kernel, n, NGF, (70, 70, 70)
        for n, box in CONV7_SHARD_BOXES:
            yield f"{role}, shard box", kernel, n, NGF, box
        for what, n, c, box in CONV7_EXTRA:
            yield f"{role}, {what}", kernel, n, c, box


def phase_conv7_wgrad_kernels(results: dict) -> None:
    """Phase 2's weight-gradient part: both kernels (first pass and reduce,
    through their wrappers) at every case of conv7_wgrad_cases against
    float32 torch.nn.grad.conv3d_weight of the same bf16 inputs on the card
    with TF32 off, phase_conv7_kernels' bar; and the reduce alone on each
    case's partials against its plain version (the partials summed in
    float32 by torch). Each case twice: bit-equal."""
    import torch

    from mra_gan_tpu_torch.ops.kernels import conv7 as C7

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for role, kernel, n, c, box in conv7_wgrad_cases():
            field, one = conv7_wgrad_case(kernel, n, box, gen, c)
            fn, args = conv7_wgrad_call(C7, kernel, field, one)
            dw, again = fn(), fn()
            torch.cuda.synchronize()
            ref = getattr(C7, f"{kernel}_plain")(*(t.float() for t in args))
            check(tuple(dw.shape) == (c, 7, 7, 7) and dw.dtype == torch.bfloat16,
                  f"{kernel} n={n} {box}: {tuple(dw.shape)} {dw.dtype}")
            check(torch.equal(dw, again), f"{kernel} n={n} c={c} {box}: two runs differ")
            err = (dw.float() - ref).abs()
            scale = float(ref.abs().max())
            worst = float((err - 2 ** -8 * ref.abs()).max()) / scale
            row = {"role": role, "n": n, "c": c, "shape": list(field.shape), "box": list(box),
                   "max_abs_err": float(err.max()), "out_scale": scale,
                   "over_half_ulp_rel": worst}
            results[kernel]["shapes"].append(row)
            # the reduce alone, on this case's partials
            head = kernel == "conv7_wgrad_gather"
            part = C7.conv7_wgrad_partials(kernel, field, one)
            red = C7.conv7_wgrad_reduce(part, c, head)
            red_ref = C7.conv7_wgrad_reduce_plain(part, c, head)
            sums = part.sum(0)[:c, :, :7].reshape(c, 7, 7, 7)
            sums = sums.flip(1, 2, 3) if head else sums
            r_err = (red.float() - sums).abs()
            r_worst = float((r_err - 2 ** -8 * sums.abs()).max()) / float(sums.abs().max())
            results["conv7_wgrad_reduce"]["shapes"].append({
                "role": role, "n": n, "c": c, "box": list(box), "partials": part.shape[0],
                "max_abs_err": float((red.float() - red_ref.float()).abs().max()),
                "over_half_ulp_rel": r_worst})
            print(f"[conv7] {role:16s} {kernel} n={n:2d} c={c} box {box}: max err "
                  f"{float(err.max()):.3g} at scale {scale:.3g}; beyond half an ulp "
                  f"{worst:.3g} of the scale (bar 2^-12); bit-equal twice; reduce over "
                  f"{part.shape[0]} partials beyond half an ulp {r_worst:.3g}", flush=True)
            check(worst <= 2 ** -12, f"{kernel} n={n} c={c} {box}: {worst} > 2^-12")
            check(r_worst <= 2 ** -12, f"conv7_wgrad_reduce n={n} c={c} {box}: {r_worst} > 2^-12")
            del field, one, dw, again, ref, err, part
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def phase_conv7_times(bw: float, tc: float, results: dict) -> list:
    """Phase 3's conv7 part: each role at the cells' batch sizes, the kernel
    beside cuDNN's heuristic pick (today's path before the kernels: F.conv3d,
    or torch.nn.grad.conv3d_input for an input gradient, in bf16), cuDNN with
    torch.backends.cudnn.benchmark on (set and restored here), the plain
    version (float32 F.conv3d, TF32 off) and the bound: FLOPs at the bf16
    tensor-core peak or each input byte read and each output byte written
    once at the memory rate, whichever is larger."""
    import torch
    import torch.nn.functional as F

    from mra_gan_tpu_torch.ops.kernels import conv7 as C7

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    rows = []
    tf32, bench = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark
    try:
        for role, kernel, pad, edge, _ in CONV7_ROLES:
            for n in CONV7_TIMED:
                field, w, b = conv7_case(kernel, pad, edge, n, gen)
                spread = kernel == "conv7_spread"
                fn = getattr(C7, kernel)
                plain = getattr(C7, f"{kernel}_plain")
                if pad == 0:  # a forward: the conv itself
                    w5 = w[:, None] if spread else w[None]
                    lib = lambda: F.conv3d(field, w5, b)  # noqa: E731
                else:  # an input gradient: of the conv whose output this field is
                    w5 = w[None] if spread else w[:, None]
                    in_shape = (n, w5.shape[1]) + (edge + 6,) * 3
                    lib = lambda: torch.nn.grad.conv3d_input(in_shape, w5, field)  # noqa: E731
                row = {"role": role, "kernel": kernel, "n": n, "shape": list(field.shape),
                       "pad": pad}
                row["ms"] = device_ms(lambda: fn(field, w, b, pad), 10, 2)
                torch.backends.cudnn.benchmark = False
                row["cudnn_ms"] = device_ms(lib, 5, 1)
                torch.backends.cudnn.benchmark = True
                row["cudnn_benchmark_ms"] = device_ms(lib, 5, 2)
                torch.backends.cudnn.benchmark = bench
                torch.backends.cudnn.allow_tf32 = False
                row["plain_ms"] = device_ms(lambda: plain(field, w, b, pad), 3, 1)
                torch.backends.cudnn.allow_tf32 = tf32
                out_vox = (edge + 2 * pad - 6) ** 3
                # per output voxel of a forward, per gradient voxel of an input gradient
                flop = 2 * 343 * NGF * n * (out_vox if pad == 0 else edge ** 3)
                nbytes = 2 * (field.numel() + w.numel() + (0 if b is None else b.numel())
                              + n * out_vox * (NGF if spread else 1))
                row.update(flop=flop, bytes=nbytes,
                           bound_ms=max(flop / tc, nbytes / bw) * 1e3,
                           bound_by="operations" if flop / tc >= nbytes / bw else "bytes",
                           tflops=flop / row["ms"] / 1e9,
                           cudnn_tflops=flop / row["cudnn_ms"] / 1e9)
                rows.append(row)
                results[kernel].setdefault("times", []).append(row)
                print(f"[conv7] {role:16s} n={n:2d} kernel {row['ms']:.4f} ms "
                      f"({row['tflops']:.1f} TFLOP/s); cuDNN heuristic "
                      f"{row['cudnn_ms']:.4f} ({row['cudnn_tflops']:.2f} TFLOP/s), searched "
                      f"{row['cudnn_benchmark_ms']:.4f}; plain f32 {row['plain_ms']:.4f}; "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
                del field, w, b
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = tf32, bench
    return rows


def phase_conv7_wgrad_times(bw: float, flops: float, tc: float, results: dict) -> list:
    """Phase 3's weight-gradient part: each kernel at the cells' batch sizes
    (the whole wrapper, both passes; the reduce pass alone), beside cuDNN's
    heuristic pick (torch.nn.grad.conv3d_weight in bf16 on the layouts the
    step gives it: the path before the kernels), cuDNN with
    torch.backends.cudnn.benchmark on, the plain version (float32, TF32 off)
    and the bound: FLOPs at the bf16 tensor-core peak or each input byte read
    and the weights written once at the memory rate, whichever is larger.
    The reduce's own bound: its partials read once; its library yardstick
    torch.sum over the blocks."""
    import torch

    from mra_gan_tpu_torch.ops.kernels import conv7 as C7

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    rows = []
    tf32, bench = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark
    try:
        for role, kernel, _ in CONV7_WGRAD_ROLES:
            for n in CONV7_TIMED:
                field, one = conv7_wgrad_case(kernel, n, (70, 70, 70), gen)
                fn, args = conv7_wgrad_call(C7, kernel, field, one)
                plain = getattr(C7, f"{kernel}_plain")
                head = kernel == "conv7_wgrad_gather"
                wshape = (1, NGF, 7, 7, 7) if head else (NGF, 1, 7, 7, 7)
                x, g = (field, one) if head else (one, field)
                lib = lambda: torch.nn.grad.conv3d_weight(x, wshape, g)  # noqa: E731
                part = C7.conv7_wgrad_partials(kernel, field, one)
                row = {"role": role, "kernel": kernel, "n": n, "shape": list(field.shape)}
                row["ms"] = device_ms(fn, 10, 2)
                row["reduce_ms"] = device_ms(lambda: C7.conv7_wgrad_reduce(part, NGF, head), 10, 2)
                row["reduce_library_ms"] = device_ms(lambda: part.sum(0), 10, 2)
                row["reduce_plain_ms"] = device_ms(
                    lambda: C7.conv7_wgrad_reduce_plain(part, NGF, head), 10, 2)
                torch.backends.cudnn.benchmark = False
                row["cudnn_ms"] = device_ms(lib, 3, 1)
                torch.backends.cudnn.benchmark = True
                row["cudnn_benchmark_ms"] = device_ms(lib, 3, 2)
                torch.backends.cudnn.benchmark = bench
                torch.backends.cudnn.allow_tf32 = False
                row["plain_ms"] = device_ms(lambda: plain(*args), 3, 1)
                torch.backends.cudnn.allow_tf32 = tf32
                flop = 2 * 343 * NGF * n * 64 ** 3
                nbytes = 2 * (field.numel() + one.numel() + NGF * 343)
                r_bytes = 4 * part.numel() + 2 * NGF * 343
                row.update(flop=flop, bytes=nbytes, partials=part.shape[0],
                           bound_ms=max(flop / tc, nbytes / bw) * 1e3,
                           bound_by="operations" if flop / tc >= nbytes / bw else "bytes",
                           tflops=flop / row["ms"] / 1e9,
                           cudnn_tflops=flop / row["cudnn_ms"] / 1e9,
                           reduce_bound_ms=max(part.numel() / flops, r_bytes / bw) * 1e3)
                rows.append(row)
                results[kernel].setdefault("times", []).append(row)
                print(f"[conv7] {role:16s} n={n:2d} kernel {row['ms']:.4f} ms "
                      f"({row['tflops']:.1f} TFLOP/s; its reduce {row['reduce_ms']:.4f} over "
                      f"{row['partials']} partials, torch.sum {row['reduce_library_ms']:.4f}); "
                      f"cuDNN heuristic {row['cudnn_ms']:.4f} ({row['cudnn_tflops']:.2f} "
                      f"TFLOP/s), searched {row['cudnn_benchmark_ms']:.4f}; plain f32 "
                      f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']})", flush=True)
                del field, one, part
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = tf32, bench
    return rows


# ---------------------------------------------------------------------------
# the stride-2 4^3 one-channel convs (the PatchGAN's first conv, the U-Net's
# outermost down conv) on the conv4s2 kernels

C4S2_KERNELS = ("conv4s2_spread", "conv4s2_gather", "conv4s2_wgrad", "conv4s2_wgrad_reduce")
# phase 2's cases: (label, N, C, input box, pads): the batch-8 step's
# discriminator update (2B = 16) and generator update (B = 8), the batch-1
# step's (2, 1), an odd unequal box, C = 4 and 5 (no 16-byte vectors), C = 40
# (a partial second chunk), the U-Net's 2-way depth shard at 64^3 (34 planes
# after the zero halo, depth pad 0), an odd box at those pads, and unet_128's
# 128^3 input
C4S2_CASES = (("step D", 16, NDF, PATCH, (1, 1, 1)), ("step G", 8, NDF, PATCH, (1, 1, 1)),
              ("b1 D", 2, NDF, PATCH, (1, 1, 1)), ("b1 G", 1, NDF, PATCH, (1, 1, 1)),
              ("odd box", 2, NDF, (21, 18, 23), (1, 1, 1)), ("C=4", 2, 4, (20, 22, 18), (1, 1, 1)),
              ("C=5", 2, 5, (19, 20, 22), (1, 1, 1)), ("C=40", 2, 40, (20, 22, 18), (1, 1, 1)),
              ("U-Net shard", 1, NGF, (34, 64, 64), (0, 1, 1)),
              ("odd box p011", 2, NDF, (21, 18, 23), (0, 1, 1)),
              ("unet_128", 1, NGF, (128, 128, 128), (1, 1, 1)))
# phase 2's cases for each path of the forward and the weight gradient:
# (label, N, C, input box, pads, the source moved off 16-byte alignment):
# the TMA path with a partial second chunk (C = 40), two chunks at depth pad
# 0 (C = 64), a chunk of 8 channels at rows of 9 outputs (TW < 16), and the
# staged path at a TMA shape where x or g starts 2 bytes past an aligned
# address (g unaligned: the forward stays on TMA, the weight gradient and
# the gather move g an element at a time)
C4S2_PATH_CASES = (("C=40 W%8", 2, 40, (20, 22, 24), (1, 1, 1), None),
                   ("C=64 p011", 2, 64, (18, 20, 16), (0, 1, 1), None),
                   ("C=8 TW=9", 3, 8, (9, 11, 16), (1, 1, 1), None),
                   ("x unaligned", 2, NDF, (20, 22, 24), (1, 1, 1), "x"),
                   ("g unaligned", 2, NDF, (20, 22, 24), (1, 1, 1), "g"))
# launches per train step at the reference default: the discriminators'
# first conv in 2 applies of the generator update (input gradients through
# the fakes, no weight gradient) and 2 stacked applies of the discriminator
# update (weight and bias gradients, no input gradient)
C4S2_PER_STEP = {"conv4s2_spread": 4, "conv4s2_gather": 2, "conv4s2_wgrad": 2,
                 "conv4s2_wgrad_reduce": 2}
C4S2_TIMED = (16, 8)  # phase 3 times each kernel at the step's batch sizes
# and each path of the forward and the weight gradient at the other shapes
# the port runs: (label, N, C, input box, pads)
C4S2_PATH_TIMED = (("step b1 D", 2, NDF, PATCH, (1, 1, 1)),
                   ("step b1 G", 1, NDF, PATCH, (1, 1, 1)),
                   ("U-Net shard", 1, NGF, (34, 64, 64), (0, 1, 1)),
                   ("unet_128", 1, NGF, (128, 128, 128), (1, 1, 1)))
# the plan's path may read slower than the other path by at most this
# (relative, absolute ms)
C4S2_PATH_SLACK = (0.03, 0.001)


def c4s2_launched(want: dict) -> bool:
    """Each conv4s2 kernel launched as often as ``want`` says (0 where it
    names none) since its counters were zeroed."""
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    return all(C4.LAUNCHES[k] == want.get(k, 0) for k in C4.LAUNCHES)


def c4s2_per_step(net_g: str, net_d: str, norm: str, dtype) -> dict:
    """conv4s2 launches per train step: a U-Net generator's outermost down
    conv in its 4 applies (input gradients in the 2 cycle applies, whose
    inputs are fakes), a PatchGAN's first conv in 2 generator-update applies
    and 2 discriminator-update applies, or 4 where the norm keeps real and
    fake apart (batch norm); none in float32 (cuDNN)."""
    import torch

    if dtype != torch.bfloat16:
        return {}
    spread = gather = wgrad = 0
    if net_g.startswith("unet"):
        spread, gather, wgrad = 4, 2, 4
    if net_d in ("n_layers", "basic"):
        d_update = 2 if norm in ("instance", "none") else 4
        spread, gather, wgrad = spread + 2 + d_update, gather + 2, wgrad + d_update
    want = {"conv4s2_spread": spread, "conv4s2_gather": gather, "conv4s2_wgrad": wgrad,
            "conv4s2_wgrad_reduce": wgrad}
    return {k: v for k, v in want.items() if v}


def _unaligned(t, channels_last: bool = False):
    """A copy of ``t`` whose storage starts 2 bytes past a 16-byte
    boundary, contiguous (in channels_last_3d where asked)."""
    import torch

    flat = torch.empty(t.numel() + 8, device=t.device, dtype=t.dtype)[1:1 + t.numel()]
    if channels_last:
        n, c, *box = t.shape
        out = flat.view(n, *box, c).permute(0, 4, 1, 2, 3)
    else:
        out = flat.view(t.shape)
    out.copy_(t)
    return out


def c4s2_inputs(n: int, c: int, box, pads, gen, unaligned=None):
    """bf16 inputs on the card as the step gives them: x (N, 1, box) in
    [-1, 1], the taps (C, 4, 4, 4) at 1/8 (O(1) outputs), a bias, and an
    output gradient (N, C, out box) in channels_last_3d; ``unaligned`` ("x"
    or "g") moves that source 2 bytes off 16-byte alignment."""
    import torch

    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    x = (torch.rand((n, 1, *box), generator=gen, device=DEVICE) * 2 - 1).bfloat16()
    w = (torch.randn((c, 4, 4, 4), generator=gen, device=DEVICE) / 8).bfloat16()
    b = (0.1 * torch.randn((c,), generator=gen, device=DEVICE)).bfloat16()
    g = torch.randn((n, c, *C4.out_shape(box, pads)), generator=gen, device=DEVICE).bfloat16()
    g = g.contiguous(memory_format=torch.channels_last_3d)
    if unaligned == "x":
        x = _unaligned(x)
    elif unaligned == "g":
        g = _unaligned(g, True)
    check(unaligned is None or (x if unaligned == "x" else g).data_ptr() % 16 == 2,
          f"c4s2_inputs: {unaligned} unaligned")
    return x, w, b, g


def c4s2_path(kernel: str, x, g) -> str:
    """The path the wrapper's plan takes for these inputs: "tma" or
    "staged" (the gather always staged)."""
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    kind = kernel.split("_", 1)[1]
    srcs = (x,) if kind == "spread" else (x, g)
    aligned = all(t.data_ptr() % 16 == 0 for t in srcs)
    return "tma" if C4.takes_tma(kind, g.shape[1], x.shape[2:], aligned) else "staged"


def _over_half_ulp(got, ref) -> float:
    """How far ``got`` lies beyond half an ulp of each element of ``ref``,
    as a share of ref's scale (the conv7 bar holds it to 2^-12)."""
    err = (got.float() - ref).abs()
    return float((err - 2 ** -8 * ref.abs()).max()) / float(ref.abs().max())


def phase_conv4s2_kernels(results: dict) -> None:
    """Phase 2's conv4s2 part: at every case of C4S2_CASES and
    C4S2_PATH_CASES each kernel (forward, input gradient, weight and bias
    gradient through its reduce) twice, bit-equal, against its plain version
    on the card (float32 F.conv3d, conv3d_input, conv3d_weight and the sum
    of g, of the same bf16 inputs, TF32 off) at phase_conv7_kernels' bar:
    |kernel - ref| <= 2^-8 |ref| + 2^-12 max|ref|; and the reduce alone on
    each case's partials against its plain version, which sums in the
    kernel's order: bit for bit. Each row names the path its plan took; the
    forward and the weight gradient must each have run both paths."""
    import torch

    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        paths = {"conv4s2_spread": set(), "conv4s2_wgrad": set()}
        for label, n, c, box, pads, unaligned in ([(*case, None) for case in C4S2_CASES]
                                                  + list(C4S2_PATH_CASES)):
            x, w, b, g = c4s2_inputs(n, c, box, pads, gen, unaligned)
            runs = {
                "conv4s2_spread": (lambda: (C4.conv4s2_spread(x, w, b, pads),),
                                   lambda: (C4.conv4s2_spread_plain(x.float(), w, b, pads),)),
                "conv4s2_gather": (lambda: (C4.conv4s2_gather(g, w, pads, box),),
                                   lambda: (C4.conv4s2_gather_plain(g.float(), w, pads, box),)),
                "conv4s2_wgrad": (lambda: C4.conv4s2_wgrad(x, g, pads),
                                  lambda: C4.conv4s2_wgrad_plain(x.float(), g.float(), pads)),
            }
            line = []
            for kernel, (fn, plain) in runs.items():
                got, again = fn(), fn()
                torch.cuda.synchronize()
                ref = plain()
                for t, a, r in zip(got, again, ref):
                    check(t.shape == r.shape and t.dtype == torch.bfloat16,
                          f"{kernel} {label}: {tuple(t.shape)} {t.dtype}, want {tuple(r.shape)}")
                    check(torch.equal(t, a), f"{kernel} {label}: two runs differ")
                worst = max(_over_half_ulp(t, r) for t, r in zip(got, ref))
                err = max(float((t.float() - r).abs().max()) for t, r in zip(got, ref))
                path = c4s2_path(kernel, x, g)
                paths.setdefault(kernel, set()).add(path)
                results[kernel]["shapes"].append({"case": label, "n": n, "c": c, "box": list(box),
                                                  "pads": list(pads), "path": path,
                                                  "unaligned": unaligned, "max_abs_err": err,
                                                  "over_half_ulp_rel": worst})
                check(worst <= 2 ** -12, f"{kernel} {label}: {worst} > 2^-12")
                line.append(f"{kernel} ({path}) err {err:.3g} ({worst:.2g} past half an ulp)")
            part = C4.conv4s2_wgrad_partials(x, g, pads)
            red, red2 = C4.conv4s2_wgrad_reduce(part, c), C4.conv4s2_wgrad_reduce(part, c)
            want = C4.conv4s2_wgrad_reduce_plain(part, c)
            err = max(float((t.float() - r.float()).abs().max()) for t, r in zip(red, want))
            results["conv4s2_wgrad_reduce"]["shapes"].append({
                "case": label, "n": n, "c": c, "partials": part.shape[0], "max_abs_err": err})
            check(all(torch.equal(t, a) for t, a in zip(red, red2)),
                  f"conv4s2_wgrad_reduce {label}: two runs differ")
            check(all(torch.equal(t, r) for t, r in zip(red, want)),
                  f"conv4s2_wgrad_reduce {label}: {err} from its plain version")
            print(f"[conv4s2] {label:13s} n={n:2d} c={c:2d} {box} pads {pads}: "
                  + "; ".join(line) + f"; reduce over {part.shape[0]} partials bit-equal to "
                  f"plain; each twice bit-equal", flush=True)
            del x, w, b, g, part
            torch.cuda.empty_cache()
        for kernel in ("conv4s2_spread", "conv4s2_wgrad"):
            check(paths[kernel] == {"tma", "staged"},
                  f"{kernel}: both paths run in phase 2, saw {sorted(paths[kernel])}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def cudnn_kernels(fn) -> list:
    """The device kernels one call of ``fn`` runs, under torch.profiler:
    [(name, ms)], longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, (getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) / 1e3)
            for e in prof.key_averages() if str(e.device_type) == "DeviceType.CUDA"]
    return sorted(rows, key=lambda r: -r[1])


def c4s2_paths_ms(kernel: str, x, w, b, g, pads) -> dict:
    """``kernel`` ("conv4s2_spread", "conv4s2_wgrad" through its reduce)
    on its plan's path, "ms", and where that path is TMA, the staged kernel
    on the same inputs, "staged_ms" (through the wrapper, given a copy of x
    2 bytes off alignment, which the plan sends to the staged kernel), then
    the TMA path again, "ms_again"."""
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    def run(src):
        if kernel == "conv4s2_spread":
            return lambda: C4.conv4s2_spread(src, w, b, pads)
        return lambda: C4.conv4s2_wgrad(src, g, pads)

    path = c4s2_path(kernel, x, g)
    row = {"path": path, "ms": device_ms(run(x), 20, 3)}
    if path == "tma":
        xu = _unaligned(x)
        check(c4s2_path(kernel, xu, g) == "staged",
              f"{kernel}: an unaligned x takes the staged path")
        row["staged_ms"] = device_ms(run(xu), 20, 3)
        row["ms_again"] = device_ms(run(x), 20, 3)
    return row


def phase_conv4s2_times(bw: float, flops: float, tc: float, results: dict) -> list:
    """Phase 3's conv4s2 part: each kernel at the step's batch sizes (16,
    the discriminator update's stacked applies, and 8, the generator
    update's) beside cuDNN's bf16 call for the same direction and shape in
    channels_last_3d (the path before the kernels: F.conv3d, conv3d_input,
    convolution_backward for the weight and bias), heuristic and with
    torch.backends.cudnn.benchmark on, the plain version (float32, TF32 off)
    and the bound: each input read and each output written once at the
    memory rate, or the FLOPs at the bf16 tensor-core peak, whichever is
    larger; the reduce alone beside its bound (its partials read once, or
    their adds at the float32 rate). Each kernel must beat cuDNN's heuristic
    call. Each row names the path the wrapper's plan took; where the path
    is TMA, the staged kernel is timed on the same inputs between two
    readings of the TMA path (c4s2_paths_ms). Then the forward and the
    weight gradient at C4S2_PATH_TIMED, both paths and the bound, the
    plan's path no slower than the other by more than C4S2_PATH_SLACK.
    (c4s2_cudnn_split, after phase 7, names the kernels of those calls.)"""
    import torch
    import torch.nn.functional as F

    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    pads = (1, 1, 1)
    rows = []
    tf32, bench = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark
    cl = torch.channels_last_3d
    try:
        for n in C4S2_TIMED:
            x, w, b, g = c4s2_inputs(n, NDF, PATCH, pads, gen)
            w5 = w[:, None].contiguous(memory_format=cl)
            out = C4.out_shape(PATCH, pads)
            vox_in, vox_out = n * math.prod(PATCH), n * math.prod(out)
            flop = 2 * 64 * NDF * vox_out
            part = C4.conv4s2_wgrad_partials(x, g, pads)
            cases = (
                ("conv4s2_spread", "forward", lambda: C4.conv4s2_spread(x, w, b, pads),
                 lambda: C4.conv4s2_spread_plain(x.float(), w, b, pads),
                 lambda: F.conv3d(x, w5, b, 2, pads), 2 * (vox_in + NDF * vox_out + w.numel())),
                ("conv4s2_gather", "input grad", lambda: C4.conv4s2_gather(g, w, pads, PATCH),
                 lambda: C4.conv4s2_gather_plain(g.float(), w, pads, PATCH),
                 lambda: torch.nn.grad.conv3d_input(x.shape, w5, g, 2, pads),
                 2 * (NDF * vox_out + vox_in + w.numel())),
                ("conv4s2_wgrad", "weight grad", lambda: C4.conv4s2_wgrad(x, g, pads),
                 lambda: C4.conv4s2_wgrad_plain(x.float(), g.float(), pads),
                 lambda: torch.ops.aten.convolution_backward(
                     g, x, w5, [NDF], [2] * 3, list(pads), [1] * 3, False, [0] * 3, 1,
                     [False, True, True]),
                 2 * (vox_in + NDF * vox_out + 65 * NDF)))
            for kernel, role, fn, plain, lib, nbytes in cases:
                torch.backends.cudnn.benchmark = False
                row = {"kernel": kernel, "role": role, "n": n}
                if kernel == "conv4s2_gather":
                    row.update(path="staged", ms=device_ms(fn, 20, 3))
                else:
                    row.update(c4s2_paths_ms(kernel, x, w, b, g, pads))
                path = row["path"]
                row["cudnn_ms"] = device_ms(lib, 5, 1)
                torch.backends.cudnn.benchmark = True
                row["cudnn_benchmark_ms"] = device_ms(lib, 5, 2)
                torch.backends.cudnn.benchmark = bench
                torch.backends.cudnn.allow_tf32 = False
                row["plain_ms"] = device_ms(plain, 3, 1)
                torch.backends.cudnn.allow_tf32 = tf32
                row.update(flop=flop, bytes=nbytes, bound_ms=max(flop / tc, nbytes / bw) * 1e3,
                           bound_by="operations" if flop / tc >= nbytes / bw else "bytes")
                rows.append(row)
                results[kernel].setdefault("times", []).append(row)
                staged = (f" (staged kernel {row['staged_ms']:.4f}, then {path} again "
                          f"{row['ms_again']:.4f})" if path == "tma" else "")
                print(f"[conv4s2] {role:11s} n={n:2d} kernel ({path}) {row['ms']:.4f} ms{staged}; "
                      f"cuDNN heuristic {row['cudnn_ms']:.4f}, searched "
                      f"{row['cudnn_benchmark_ms']:.4f}; plain f32 {row['plain_ms']:.4f}; bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
                check(row["ms"] < row["cudnn_ms"],
                      f"{kernel} n={n}: {row['ms']:.4f} ms, not under cuDNN's {row['cudnn_ms']:.4f}")
                if path == "tma":
                    rel, add = C4S2_PATH_SLACK
                    check(row["ms"] <= row["staged_ms"] * (1 + rel) + add,
                          f"{kernel} n={n}: tma {row['ms']:.4f} ms against staged "
                          f"{row['staged_ms']:.4f}")
            r_bytes = 4 * part.numel() + 2 * 65 * NDF
            row = {"kernel": "conv4s2_wgrad_reduce", "role": "weight grad", "n": n,
                   "partials": part.shape[0],
                   "ms": device_ms(lambda: C4.conv4s2_wgrad_reduce(part, NDF), 20, 3),
                   "plain_ms": device_ms(lambda: C4.conv4s2_wgrad_reduce_plain(part, NDF), 3, 1),
                   "sum_only_ms": device_ms(lambda: part.sum(0), 20, 3),
                   "bytes": r_bytes, "bound_ms": max(part.numel() / flops, r_bytes / bw) * 1e3,
                   "bound_by": "bytes" if r_bytes / bw >= part.numel() / flops else "operations"}
            rows.append(row)
            results["conv4s2_wgrad_reduce"].setdefault("times", []).append(row)
            print(f"[conv4s2] reduce      n={n:2d} over {row['partials']} partials {row['ms']:.4f} "
                  f"ms; plain {row['plain_ms']:.4f}; torch.sum alone {row['sum_only_ms']:.4f}; "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            del x, w, b, g, w5, part
            torch.cuda.empty_cache()
        for label, n, c, box, pads in C4S2_PATH_TIMED:
            x, w, b, g = c4s2_inputs(n, c, box, pads, gen)
            vox_in, vox_out = n * math.prod(box), n * math.prod(C4.out_shape(box, pads))
            flop = 2 * 64 * c * vox_out
            for kernel, nbytes in (("conv4s2_spread", 2 * (vox_in + c * vox_out + 64 * c)),
                                   ("conv4s2_wgrad", 2 * (vox_in + c * vox_out + 65 * c))):
                row = {"kernel": kernel, "case": label, "n": n, "c": c, "box": list(box),
                       "pads": list(pads), **c4s2_paths_ms(kernel, x, w, b, g, pads),
                       "flop": flop, "bytes": nbytes,
                       "bound_ms": max(flop / tc, nbytes / bw) * 1e3,
                       "bound_by": "operations" if flop / tc >= nbytes / bw else "bytes"}
                rows.append(row)
                results[kernel].setdefault("path_times", []).append(row)
                other = (f"; staged {row['staged_ms']:.4f}, tma again {row['ms_again']:.4f}"
                         if row["path"] == "tma" else "")
                print(f"[conv4s2] {kernel} {label} n={n} ({row['path']}) {row['ms']:.4f} ms"
                      f"{other}; bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
                if row["path"] == "tma":
                    rel, add = C4S2_PATH_SLACK
                    check(row["ms"] <= row["staged_ms"] * (1 + rel) + add,
                          f"{kernel} {label}: tma {row['ms']:.4f} ms against staged "
                          f"{row['staged_ms']:.4f}")
            del x, w, b, g
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = tf32, bench
    return rows


def c4s2_kernels_reproducible() -> list:
    """The conv4s2 kernels run twice on the same input at the batch-1
    step's shapes (the forward and the weight gradient at 2, the discriminator
    update's; the forward and the input gradient at 1, the generator
    update's): the shapes whose two results differ in any bit."""
    import torch

    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    pads = (1, 1, 1)
    b1 = min(TRAIN_BATCHES)
    differ = []
    for n, kernels in ((2 * b1, ("spread", "wgrad")), (b1, ("spread", "gather"))):
        x, w, b, g = c4s2_inputs(n, NDF, PATCH, pads, gen)
        fns = {"spread": lambda: (C4.conv4s2_spread(x, w, b, pads),),
               "gather": lambda: (C4.conv4s2_gather(g, w, pads, PATCH),),
               "wgrad": lambda: C4.conv4s2_wgrad(x, g, pads)}
        for k in kernels:
            if not all(torch.equal(a, c) for a, c in zip(fns[k](), fns[k]())):
                differ.append(f"conv4s2_{k} n={n}")
    return differ


def c4s2_line(results: dict, train: dict, decode: dict) -> list:
    """The conv4s2 kernels' entries of the kernels line. Main path: the
    batch-8 train step (phase 7's timed steps), which runs all four; the
    times at the step's largest call of each (the forward and the weight
    gradient at 2B = 16, the input gradient at B = 8), the other batch size
    beside them. Launches per cell: phase 7's batch-8 step and phase 5's
    decode (none: the decode runs no discriminator)."""
    b8 = f"b{max(TRAIN_BATCHES)}"
    steps = train[b8]["steps"]
    out = []
    for kernel in C4S2_KERNELS:
        r = results[kernel]
        n_main = max(TRAIN_BATCHES) if kernel == "conv4s2_gather" else 2 * max(TRAIN_BATCHES)
        head = next(t for t in r["times"] if t["n"] == n_main)
        launches = train[b8]["c4s2_launches"][kernel]
        check(launches > 0, f"{kernel} launched on its main path")
        reduce = kernel == "conv4s2_wgrad_reduce"
        entry = {
            "name": kernel, "route": "cuda",
            "source": "mra_gan_tpu_torch/ops/kernels/csrc/conv4s2.cu",
            "replaces": "mra_gan_tpu/ops/s2d.py:618",
            "launches": launches, "max_abs_err": max(s["max_abs_err"] for s in r["shapes"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None if reduce else head["cudnn_ms"],
            "at": {"n": n_main, "shape": [n_main, 1, *PATCH], "dtype": "bf16",
                   "path": head.get("path")},
            "launches_train_per_step": {f"b{b}": train[f"b{b}"]["c4s2_launches"][kernel]
                                        / train[f"b{b}"]["steps"] for b in TRAIN_BATCHES},
            "launches_decode": decode["c4s2_launches"][kernel],
            "launches_cells": {"train-b8-p64": launches / steps,
                               "decode-sw-128x256x256": decode["c4s2_launches"][kernel]},
            "times": [{k: v for k, v in t.items() if k != "cudnn_kernels"} for t in r["times"]],
            "note": "no Pallas kernel: XLA's conv over space-to-depth cells on the TPU "
                    "(conv3d_s2d_stride2); library_ms: cuDNN's heuristic pick in bf16, the path "
                    "before this kernel; max_abs_err against its plain version"}
        if kernel == "conv4s2_wgrad":
            entry["note"] += "; ms: both passes (the partial sums and conv4s2_wgrad_reduce)"
        if reduce:
            entry.update(sum_only_ms=head["sum_only_ms"],
                         note="the weight gradient's second pass: the partial sums of a fixed "
                              "grid in a fixed order, one rounding, bit-equal to its plain "
                              "version; library_ms: none, no one PyTorch call sums in that order "
                              "and rounds; sum_only_ms: torch.sum of the partials alone")
        out.append(entry)
    return out


def c4s2_cudnn_split(results: dict) -> list:
    """The path before the conv4s2 kernels split by direction: the device
    kernels of cuDNN's heuristic bf16 call for each direction at the step's
    shapes (the forward at 16 and 8, the input gradient at 8, the weight and
    bias gradient at 16), under torch.profiler, and beside them the kernels
    of the PatchGAN's head conv (8 ndf -> 1 channel, 4^3, stride 1), which
    stays on cuDNN. Run after phase 7's timed steps, as no timed block of
    this process runs after a trace."""
    import torch
    import torch.nn.functional as F

    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    pads, cl = (1, 1, 1), torch.channels_last_3d
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    rows = []
    try:
        for n, role in ((16, "forward"), (8, "forward"), (8, "input grad"), (16, "weight grad")):
            x, w, b, g = c4s2_inputs(n, NDF, PATCH, pads, gen)
            w5 = w[:, None].contiguous(memory_format=cl)
            lib = {"forward": lambda: F.conv3d(x, w5, b, 2, pads),
                   "input grad": lambda: torch.nn.grad.conv3d_input(x.shape, w5, g, 2, pads),
                   "weight grad": lambda: torch.ops.aten.convolution_backward(
                       g, x, w5, [NDF], [2] * 3, list(pads), [1] * 3, False, [0] * 3, 1,
                       [False, True, True])}[role]
            split = cudnn_kernels(lib)
            rows.append({"conv": "first", "role": role, "n": n, "kernels": split})
            print(f"[conv4s2] cuDNN's {role} at n={n}: "
                  + "; ".join(f"{k[:90]} {v:.4f} ms" for k, v in split), flush=True)
            del x, w, b, g, w5
        # the PatchGAN's head conv, Conv3d(8 ndf, 1, 4, stride 1, pad 1) on
        # the 7^3 map (no conv4s2 route), at the step's 16: its cuDNN kernels
        # beside the first conv's
        x = torch.randn((16, 8 * NDF, 7, 7, 7), generator=gen, device=DEVICE).bfloat16()
        x = x.contiguous(memory_format=cl).requires_grad_()
        w = (torch.randn((1, 8 * NDF, 4, 4, 4), generator=gen, device=DEVICE) / 128).bfloat16()
        w = w.contiguous(memory_format=cl).requires_grad_()
        y = F.conv3d(x, w, None, 1, 1)
        g = torch.randn(y.shape, generator=gen, device=DEVICE).bfloat16()
        for role, lib in (("forward", lambda: F.conv3d(x, w, None, 1, 1)),
                          ("input and weight grad",
                           lambda: torch.autograd.grad(y, (x, w), g, retain_graph=True))):
            split = cudnn_kernels(lib)
            rows.append({"conv": "head", "role": role, "n": 16, "kernels": split})
            print(f"[conv4s2] the PatchGAN head's cuDNN {role} at n=16: "
                  + "; ".join(f"{k[:90]} {v:.4f} ms" for k, v in split), flush=True)
        del x, w, y, g
    finally:
        torch.backends.cudnn.benchmark = bench
    results["conv4s2_spread"]["cudnn_split"] = rows
    return rows


def patchgan_conv_calls() -> list:
    """The step's discriminator (3-layer PatchGAN at NDF, bf16, seeded
    weights) as its two updates run it: at 2B = 16 with weight gradients
    (the discriminator update) and at B = 8 with an input gradient and no
    weight gradient (the generator update), under torch.profiler with
    shapes: each convolution op that reaches cuDNN, by its shapes, with its
    calls and device ms. It names which conv each cuDNN kernel of the
    step's profile serves."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mra_gan_tpu_torch.models.networks import define_d

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    net = define_d(1, NDF, "n_layers", 3).to(DEVICE, memory_format=torch.channels_last_3d)
    rows = []
    for n, update in ((2 * max(TRAIN_BATCHES), "discriminator"), (max(TRAIN_BATCHES), "generator")):
        x = torch.rand((n, 1, *PATCH), generator=gen, device=DEVICE).bfloat16()
        x.requires_grad_(update == "generator")
        params = [p for p in net.parameters()]

        def run():
            from mra_gan_tpu_torch.ops.conv import param_casts

            with param_casts(net, torch.bfloat16):
                y = net(x)
            want = [x] if update == "generator" else params
            torch.autograd.grad(y.float().square().mean(), want, allow_unused=True)

        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            run()
            torch.cuda.synchronize()
        for e in prof.key_averages(group_by_input_shape=True):
            if e.key not in ("aten::cudnn_convolution", "aten::convolution_backward"):
                continue
            ms = e.device_time_total / 1e3
            rows.append({"update": update, "n": n, "op": e.key, "shapes": str(e.input_shapes[:3]),
                         "calls": e.count, "device_ms": ms})
            print(f"[patchgan] {update} update n={n}: {e.key} {e.input_shapes[:3]} x{e.count}: "
                  f"{ms:.4f} ms on the device", flush=True)
    del net
    return rows


def generator_pads(n: int, spatial) -> list:
    """(role, (N, C, D, H, W), pad) of the three pad shapes of one
    resnet_6blocks forward on ``spatial`` input: the stem's and the head's
    3-voxel pads at full size, the residual blocks' 1-voxel pads (12 of
    them) at a quarter."""
    full = tuple(spatial)
    return [("stem", (n, 1) + full, 3), ("trunk", (n, 4 * NGF) + tuple(s // 4 for s in full), 1),
            ("head", (n, NGF) + full, 3)]


def pad_cases():
    """Phase 2's pad cases: (label, role, (N, C, D, H, W), pads), pads per
    axis low and high (D, H, W): every pad shape of the decode (batch 8,
    the short last batch of 3, the single pass) and of the train step at
    batch 1 and 8 (the generators at 2B and B); the three at a depth shard
    of phase 14's 2-way 1 x 64^3 spatial step after its halo exchange (depth
    pad 0); an odd unequal box with an axis of 1 voxel at C = 6 (no 16-byte
    unit: one element a thread) and unequal pads, and one at C = 128."""
    cases = {}
    paths = [("decode b8", DECODE_BATCH, PATCH), ("decode b3", 3, PATCH), ("single", 1, VOLUME)]
    paths += [(f"train b{b}", n, PATCH) for b in TRAIN_BATCHES for n in (2 * b, b)]
    for label, n, spatial in paths:
        for role, shape, pad in generator_pads(n, spatial):
            cases.setdefault((shape, (pad,) * 6), (label, role))
    for role, shape, pad in generator_pads(1, (PATCH[0] // 2,) + PATCH[1:]):
        shard = shape[:2] + (shape[2] + 2 * pad,) + shape[3:]
        cases.setdefault((shard, (0, 0) + (pad,) * 4), ("shard", role))
    cases.setdefault(((2, 6, 1, 17, 23), (3, 2, 1, 3, 0, 2)), ("odd box", "C=6"))
    cases.setdefault(((3, 4 * NGF, 5, 1, 9), (1, 0, 2, 1, 1, 1)), ("odd box", "C=128"))
    return [(label, role, shape, pads) for (shape, pads), (label, role) in cases.items()]


def pad_launched(want: dict) -> bool:
    """Each replication-pad kernel launched as often as ``want`` says (0
    where it names none) since its counters were zeroed."""
    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

    return all(RP.LAUNCHES[k] == want.get(k, 0) for k in RP.LAUNCHES)


def pad_inputs(shape, pads, dtype, gen, offset: int = 0):
    """x of ``shape`` and a gradient g of its padded shape, both O(1) in
    channels_last_3d on the card; ``offset`` elements past a 16-byte
    boundary (a source the kernels may not read in 16-byte units)."""
    import torch

    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

    def laid_out(size):
        t = torch.randn(size, generator=gen, device=DEVICE).to(dtype)
        n, c, d, h, w = size
        buf = torch.empty(t.numel() + offset, device=DEVICE, dtype=dtype)
        view = buf[offset:].view(n, d, h, w, c).permute(0, 4, 1, 2, 3)
        view.copy_(t)
        return view

    return laid_out(shape), laid_out(shape[:2] + RP.out_shape(shape[2:], pads))


# phase 2's further pad cases: (label, role, shape, pads, dtype, offset) a
# float64 odd box (the unit path at C = 6, the chunk forward at C = 1), the
# head's pad of phase 8's float64 step, sources whose base pointer is not
# 16-byte aligned (C = 1 and C = 32 in bf16: the chunk forward and the row
# backward) and wide voxels (the head's pad at --ngf 128 in float32 and at
# C = 64 in float64: the ring at three stages; C = 128 in float64: the row
# backward)
PAD_EXTRA = [("odd box", "C=6", (2, 6, 1, 17, 23), (3, 2, 1, 3, 0, 2), "float64", 0),
             ("float64", "head", (2, NGF, 64, 64, 64), (3,) * 6, "float64", 0),
             ("odd box", "C=1", (2, 1, 5, 1, 9), (1, 2, 3, 3, 0, 1), "float64", 0),
             ("unaligned", "stem", (2, 1, 64, 64, 64), (3,) * 6, "bfloat16", 1),
             ("unaligned", "C=32", (1, 32, 9, 10, 11), (3,) * 6, "bfloat16", 3),
             ("unaligned", "stem f32", (1, 1, 17, 9, 23), (2, 1, 0, 3, 3, 1), "float32", 1),
             ("wide voxel", "C=128", (2, 128, 9, 10, 11), (3,) * 6, "float32", 0),
             ("wide voxel", "C=64", (2, 64, 9, 10, 11), (3,) * 6, "float64", 0),
             ("wide voxel", "C=128", (1, 128, 6, 7, 9), (3,) * 6, "float64", 0)]


def pad_route(src, pads, box, backward: bool) -> str:
    """The kernel a pad wrapper launches on ``src`` (replication_pad's
    ROUTES: a block a row, the chunk forward or the ring backward)."""
    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

    params = RP.launch_plan(tuple(src.shape), pads, tuple(box), src.dtype,
                            src.data_ptr() % RP.VEC_BYTES == 0, backward, src.device.index)[1]
    return next(k for k, v in RP.ROUTES.items() if v == params[RP.HEADER.index("route")])


def pad_weighted(rows, launches: dict) -> dict:
    """The pads' ms, bound and F.pad ms summed over a step's or a volume's
    launches ({(kernel, role, N): count}), per kernel."""
    out = {}
    for (kernel, role, n), count in launches.items():
        row = next(r for r in rows if (r["kernel"], r["role"], r["n"]) == (kernel, role, n))
        acc = out.setdefault(kernel, {"launches": 0, "ms": 0.0, "bound_ms": 0.0,
                                      "library_ms": 0.0})
        acc["launches"] += count
        for key in ("ms", "bound_ms", "library_ms"):
            acc[key] += count * row[key]
    return out


def phase_pad_kernels(bw: float, results: dict) -> list:
    """Phase 2's pad part: both replication-pad kernels at every case of
    pad_cases, bf16 and float32, and at PAD_EXTRA's cases, against their
    plain versions on the same input: bit for bit (the forward a copy; the
    backward the same float32 folds in the same order, rounded once), each
    run twice and bit-equal. Then each kernel at the decode's and the step's
    batch sizes (PAD_TIMED), bf16, timed beside its plain version,
    F.pad(mode="replicate") and its autograd backward (the library call, the
    path before the kernels) and the bound: its input read and its output
    written once at the memory rate; and their sums over a batch-8 step's and
    a decoded volume's launches (PAD_STEP_LAUNCHES, PAD_VOLUME_LAUNCHES)."""
    import torch
    import torch.nn.functional as F

    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

    for kernel, per_step in PAD_PER_STEP.items():  # the launch tables against the counters
        check(sum(v for k, v in PAD_STEP_LAUNCHES.items() if k[0] == kernel) == per_step,
              f"{kernel}: PAD_STEP_LAUNCHES against PAD_PER_STEP")
    check(sum(PAD_VOLUME_LAUNCHES.values())
          == EXPECTED_GRID[1] * PAD_PER_FORWARD["replication_pad_fwd"], "PAD_VOLUME_LAUNCHES")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    cases = [(label, role, shape, pads, dtype, 0) for label, role, shape, pads in pad_cases()
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(label, role, shape, pads, getattr(torch, dtype), offset)
              for label, role, shape, pads, dtype, offset in PAD_EXTRA]
    for label, role, shape, pads, dtype, offset in cases:
        x, g = pad_inputs(shape, pads, dtype, gen, offset)
        check(offset == 0 or (x.data_ptr() % 16 and g.data_ptr() % 16),
              f"pad {label} {role}: the source is 16-byte aligned")
        y, y2 = RP.replication_pad_fwd(x, pads), RP.replication_pad_fwd(x, pads)
        dx, dx2 = (RP.replication_pad_bwd(g, pads, shape[2:]),
                   RP.replication_pad_bwd(g, pads, shape[2:]))
        torch.cuda.synchronize()
        want_y = RP.replication_pad_fwd_plain(x, pads)
        want_dx = RP.replication_pad_bwd_plain(g, pads, shape[2:])
        dt = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64"}[dtype]
        routes = (pad_route(x, pads, shape[2:], False), pad_route(g, pads, shape[2:], True))
        for name, got, again, want, route in (("replication_pad_fwd", y, y2, want_y, routes[0]),
                                              ("replication_pad_bwd", dx, dx2, want_dx,
                                               routes[1])):
            err = float((got.double() - want.double()).abs().max())
            results[name]["shapes"].append({"path": label, "role": role, "shape": list(shape),
                                            "pads": list(pads), "dtype": dt, "offset": offset,
                                            "route": route, "max_abs_err": err})
            check(got.shape == want.shape and got.dtype == dtype
                  and got.is_contiguous(memory_format=torch.channels_last_3d),
                  f"{name} {label} {role} {shape} {pads} {dt}: {tuple(got.shape)} {got.dtype}")
            check(torch.equal(got, again), f"{name} {label} {role} {shape} {dt}: two runs differ")
            check(torch.equal(got, want), f"{name} {label} {role} {shape} {pads} {dt}: "
                  f"{err} from the plain version")
        print(f"[pad] {label:10s} {role:8s} {dt:4s} {str(shape):26s} pads {pads}"
              f"{f' offset {offset}' if offset else ''}: forward ({routes[0]}) and backward "
              f"({routes[1]}) bit-equal to plain, twice", flush=True)
        del x, g, y, y2, dx, dx2, want_y, want_dx
        torch.cuda.empty_cache()

    rows = []
    for n in PAD_TIMED:
        for role, shape, pad in generator_pads(n, PATCH):
            pads = (pad,) * 6
            x, g = pad_inputs(shape, pads, torch.bfloat16, gen)
            xr = x.detach().requires_grad_()
            lib_y = F.pad(xr, pads, mode="replicate")
            nbytes = 2 * (x.numel() + g.numel())
            for name, fn, plain, lib in (
                    ("replication_pad_fwd", lambda: RP.replication_pad_fwd(x, pads),
                     lambda: RP.replication_pad_fwd_plain(x, pads),
                     lambda: F.pad(x, pads, mode="replicate")),
                    ("replication_pad_bwd", lambda: RP.replication_pad_bwd(g, pads, shape[2:]),
                     lambda: RP.replication_pad_bwd_plain(g, pads, shape[2:]),
                     lambda: torch.autograd.grad(lib_y, xr, g, retain_graph=True))):
                row = {"kernel": name, "role": role, "n": n, "shape": list(shape), "pad": pad,
                       "ms": device_ms(fn, 10, 2), "plain_ms": device_ms(plain, 3, 1),
                       "library_ms": device_ms(lib, 5, 1), "bytes": nbytes,
                       "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
                       "launches_step": PAD_STEP_LAUNCHES.get((name, role, n), 0),
                       "launches_volume": PAD_VOLUME_LAUNCHES.get((name, role, n), 0),
                       "route": pad_route(g if "bwd" in name else x, pads, shape[2:],
                                          "bwd" in name)}
                rows.append(row)
                results[name]["times"].append(row)
                print(f"[pad] {name} {role:5s} n={n:2d} {str(shape):24s} {row['route']:6s} "
                      f"kernel {row['ms']:.4f} "
                      f"ms; plain {row['plain_ms']:.4f}; F.pad{' backward' if 'bwd' in name else ''}"
                      f" {row['library_ms']:.4f}; bound {row['bound_ms']:.4f} ms (bytes)",
                      flush=True)
            del x, g, xr, lib_y
        torch.cuda.empty_cache()
    for what, launches in (("step", PAD_STEP_LAUNCHES), ("volume", PAD_VOLUME_LAUNCHES)):
        for kernel, acc in pad_weighted(rows, launches).items():
            results[kernel][f"per_{what}"] = acc
            print(f"[pad] {kernel} a {'batch-8 train step' if what == 'step' else 'decoded volume'}"
                  f": {acc['launches']} launches, {acc['ms']:.4f} ms against a bound of "
                  f"{acc['bound_ms']:.4f} ms (F.pad {acc['library_ms']:.4f})", flush=True)
    return rows


def pad_kernels_reproducible() -> list:
    """Both pad kernels run twice on the same input at every pad shape of
    the batch-1 train step in bf16: the shapes whose two results differ in
    any bit (the backward sums in a fixed order, so none should)."""
    import torch

    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    b = min(TRAIN_BATCHES)
    differ = []
    for n in (2 * b, b):
        for role, shape, pad in generator_pads(n, PATCH):
            pads = (pad,) * 6
            x, g = pad_inputs(shape, pads, torch.bfloat16, gen)
            first = (RP.replication_pad_fwd(x, pads), RP.replication_pad_bwd(g, pads, shape[2:]))
            second = (RP.replication_pad_fwd(x, pads), RP.replication_pad_bwd(g, pads, shape[2:]))
            if not all(torch.equal(a, c) for a, c in zip(first, second)):
                differ.append(f"{role} {shape} pad {pad}")
    return differ


def phase_conv_formats() -> list:
    import torch
    import torch.nn.functional as F

    b, g = DECODE_BATCH, NGF
    convs = [  # (name, transposed, input shape, weight shape, stride, padding)
        ("stem c7", False, (b, 1, 70, 70, 70), (g, 1, 7, 7, 7), 1, 0),
        ("down1 c3s2", False, (b, g, 64, 64, 64), (2 * g, g, 3, 3, 3), 2, 1),
        ("down2 c3s2", False, (b, 2 * g, 32, 32, 32), (4 * g, 2 * g, 3, 3, 3), 2, 1),
        ("trunk c3", False, (b, 4 * g, 18, 18, 18), (4 * g, 4 * g, 3, 3, 3), 1, 0),
        ("up1 ct3s2", True, (b, 4 * g, 16, 16, 16), (4 * g, 2 * g, 3, 3, 3), 2, 1),
        ("up2 ct3s2", True, (b, 2 * g, 32, 32, 32), (2 * g, g, 3, 3, 3), 2, 1),
        ("head c7", False, (b, g, 70, 70, 70), (1, g, 7, 7, 7), 1, 0),
    ]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    for name, tr, xs, ws, stride, pad in convs:
        x = torch.randn(xs, generator=gen, device=DEVICE, dtype=torch.bfloat16)
        w = torch.randn(ws, generator=gen, device=DEVICE, dtype=torch.bfloat16) * 0.05
        row = {"conv": name, "input": list(xs)}
        for fmt, mf in (("ncdhw", torch.contiguous_format),
                        ("channels_last_3d", torch.channels_last_3d)):
            xf, wf = x.contiguous(memory_format=mf), w.contiguous(memory_format=mf)
            if tr:
                fn = lambda: F.conv_transpose3d(xf, wf, None, stride, pad, 1)  # noqa: E731
            else:
                fn = lambda: F.conv3d(xf, wf, None, stride, pad)  # noqa: E731
            row[f"{fmt}_ms"] = device_ms(fn, 5, 2)
        rows.append(row)
        print(f"[conv] {name:11s} {str(xs):26s} NCDHW {row['ncdhw_ms']:.3f} ms  "
              f"channels_last_3d {row['channels_last_3d_ms']:.3f} ms", flush=True)
    return rows


def phase_generator(K, tree) -> None:
    import numpy as np
    import torch

    from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4
    from mra_gan_tpu_torch.ops.kernels import conv7 as C7
    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

    x = torch.from_numpy(np.random.RandomState(SEED).uniform(
        -1, 1, (DECODE_BATCH, 1) + PATCH).astype(np.float32))
    sd = state_dict_from_jax(tree, "resnet_6blocks")
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = make_generate_fn(CycleGANConfig(ngf=NGF, dtype=dtype), "g_a", DEVICE)
        gen.net.load_state_dict(sd)
        gen(x)  # cuDNN and kernel warm-up
        K.reset_launches()
        C7.reset_launches()
        RP.reset_launches()
        C4.reset_launches()
        t0 = time.perf_counter()
        y = gen(x)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        want = forward_launches(K, generator_norms(DECODE_BATCH, PATCH), dtype)
        check(launched(K, want), f"launches per forward {K.LAUNCHES}, want {want}, "
              f"no backward")
        want7 = CONV7_PER_FORWARD if dtype == torch.bfloat16 else {}  # float32: cuDNN
        check(conv7_launched(want7), f"conv7 launches per forward {C7.LAUNCHES}, want {want7}")
        check(c4s2_launched({}), f"conv4s2 launches in a generator forward {C4.LAUNCHES}")
        # the pads take the kernels in float32 too; no backward, no relayout
        check(pad_launched(PAD_PER_FORWARD) and RP.RELAYOUTS["count"] == 0,
              f"pad launches per forward {RP.LAUNCHES}, want {PAD_PER_FORWARD}; "
              f"relayouts {RP.RELAYOUTS}")
        with plain_norms():
            yp = gen(x)
        check(y.shape == (DECODE_BATCH, 1) + PATCH and bool(torch.isfinite(y).all()),
              "generator output finite, of the input's shape")
        outs[dtype] = (y.float(), yp.float())
        print(f"[generator] {dtype} forward {secs * 1e3:.1f} ms; kernel vs plain norms: "
              f"max {float((y.float() - yp.float()).abs().max()):.3g}, "
              f"mean {float((y.float() - yp.float()).abs().mean()):.3g}", flush=True)
    yk32, yp32 = outs[torch.float32]
    torch.testing.assert_close(yk32, yp32, rtol=1e-3, atol=1e-4)
    yk16, yp16 = outs[torch.bfloat16]
    # bf16: the kernels round once where the plain version rounds three
    # times, so the two differ by about as much as bf16 differs from f32.
    # Held to: mean |diff| <= 0.02 on the [-1, 1] output, and the kernel
    # path no farther from f32 than the plain path is (x1.25).
    d = (yk16 - yp16).abs()
    e_k, e_p = float((yk16 - yk32).abs().mean()), float((yp16 - yp32).abs().mean())
    print(f"[generator] bf16 mean |diff| to f32: kernel {e_k:.4g}, plain {e_p:.4g}", flush=True)
    check(float(d.mean()) <= 0.02 and float(d.max()) <= 0.5 and e_k <= 1.25 * e_p,
          "bf16 generator: kernel norms within tolerance of plain norms")


def phase_decode(K, tree, results: dict, single_pass: bool = True) -> dict:
    """Phase 5: the sliding-window decode (DECODE_REPEATS timed volumes, the
    median kept for phase 15), then, where ``single_pass``, the single-pass
    whole-volume forward."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
    from mra_gan_tpu_torch.infer.sliding_window import patch_grid, sliding_window_inference
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4
    from mra_gan_tpu_torch.ops.kernels import conv7 as C7
    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP
    from mra_gan_tpu_torch.parallel.spatial import single_pass_apply

    gen = make_generate_fn(CycleGANConfig(ngf=NGF, dtype=torch.bfloat16), "g_a", DEVICE)
    gen.net.load_state_dict(state_dict_from_jax(tree, "resnet_6blocks"))
    vol = np.random.RandomState(SEED).rand(*VOLUME).astype(np.float32) * 2 - 1
    n_patches = len(patch_grid(VOLUME, PATCH, (STRIDE,) * 3))
    n_batches = -(-n_patches // DECODE_BATCH)
    check((n_patches, n_batches) == EXPECTED_GRID, f"grid {n_patches} patches {n_batches} batches")

    def decode():
        return sliding_window_inference(vol, gen, PATCH, STRIDE, STRIDE, "gaussian", DECODE_BATCH)

    decode()  # warm-up: the batch-3 shapes
    torch.cuda.synchronize()
    K.reset_launches()
    C7.reset_launches()
    RP.reset_launches()
    C4.reset_launches()
    t0 = time.perf_counter()
    out = decode()
    secs = [time.perf_counter() - t0]
    launches = dict(K.LAUNCHES)
    conv7_launches = dict(C7.LAUNCHES)
    pad_launches = dict(RP.LAUNCHES)
    c4s2_launches = dict(C4.LAUNCHES)
    check(c4s2_launched({}), f"conv4s2 launches in a decode (no discriminator): {c4s2_launches}")
    per_forward = forward_launches(K, generator_norms(DECODE_BATCH, PATCH), torch.bfloat16)
    check(launched(K, times(per_forward, n_batches)),
          f"{n_batches} x {per_forward} launches per decode, no backward: {launches}")
    check(conv7_launched(times(CONV7_PER_FORWARD, n_batches)),
          f"{n_batches} x {CONV7_PER_FORWARD} conv7 launches per decode: {conv7_launches}")
    check(pad_launched(times(PAD_PER_FORWARD, n_batches)) and RP.RELAYOUTS["count"] == 0,
          f"{n_batches} x {PAD_PER_FORWARD} pad launches per decode, no backward, no "
          f"relayout: {pad_launches}, {RP.RELAYOUTS}")
    check(out.shape == VOLUME and out.dtype == np.float32 and bool(np.isfinite(out).all()),
          "decode output finite float32 of the volume's shape")
    # every volume is kept until the window ends, as the benchmark keeps its
    # outputs: a dropped one would be freed (its 33.5 MB unmapped) on the
    # host's clock before the timer reads, which the benchmark's never is
    kept = [out]
    for _ in range(DECODE_REPEATS - 1):
        t0 = time.perf_counter()
        kept.append(decode())
        secs.append(time.perf_counter() - t0)
    del kept
    # the generator's forward is replayed from one CUDA graph a batch shape
    # (8 and the short last 3); the same decode run eagerly gives the same bits
    recorded = sorted(k[0][0] for k in gen._graphs["graphs"])
    check(recorded == sorted({DECODE_BATCH, n_patches % DECODE_BATCH or DECODE_BATCH}),
          f"decode: one graph a batch shape, {recorded}")
    eager, eager_s = [], []
    for _ in range(DECODE_EAGER):
        t0 = time.perf_counter()
        eager.append(sliding_window_inference(vol, gen, PATCH, STRIDE, STRIDE, "gaussian",
                                              DECODE_BATCH, graphs=False))
        eager_s.append(time.perf_counter() - t0)
    check(all(np.array_equal(e, out) for e in eager),
          "decode: the graphs' replays bit-equal to the eager decode")
    del eager
    with plain_norms():
        ref = sliding_window_inference(vol, gen, PATCH, STRIDE, STRIDE, "gaussian",
                                       DECODE_BATCH, graphs=False)
    diff = np.abs(out - ref)
    print(f"[decode] {VOLUME} volume, {n_patches} patches in {n_batches} batches: "
          f"{secs} s; launches {launches}, conv7 {conv7_launches}, pads {pad_launches}; "
          f"graphs at batch {recorded}; eager (graphs=False) {eager_s} s, bit-equal; "
          f"vs plain norms "
          f"max {diff.max():.3g} "
          f"mean {diff.mean():.3g}", flush=True)
    check(float(diff.mean()) <= 0.02 and float(diff.max()) <= 0.5,
          "decode: kernel norms within tolerance of plain norms")
    out = {"decode_s": secs, "decode_eager_s": eager_s, "trace_decode": decode,
           "conv7_launches": conv7_launches, "pad_launches": pad_launches,
           "c4s2_launches": c4s2_launches}
    if not single_pass:
        for k, r in results.items():
            r["launches_decode"] = with_wholes(launches)[k]
        return {**out, "decode_launches": with_wholes(launches)}

    single_pass_apply(gen, vol)  # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    C7.reset_launches()
    RP.reset_launches()
    t0 = time.perf_counter()
    sp = single_pass_apply(gen, vol)
    sp_secs = [time.perf_counter() - t0]
    sp_launches = dict(K.LAUNCHES)
    sp_pad_launches = dict(RP.LAUNCHES)
    want = forward_launches(K, generator_norms(1, VOLUME), torch.bfloat16)
    check(launched(K, want), f"single pass launches {sp_launches}, want {want}, no backward")
    check(conv7_launched(CONV7_PER_FORWARD), f"single pass conv7 launches {C7.LAUNCHES}")
    # the volume needs no pad to the generator's granularity: the 14 pads alone
    check(pad_launched(PAD_PER_FORWARD), f"single pass pad launches {sp_pad_launches}")
    check(sp.shape == VOLUME and bool(np.isfinite(sp).all()), "single-pass output finite")
    t0 = time.perf_counter()
    single_pass_apply(gen, vol)
    sp_secs.append(time.perf_counter() - t0)
    with plain_norms():
        sp_ref = single_pass_apply(gen, vol)
    sp_diff = np.abs(sp - sp_ref)
    print(f"[single_pass] {sp_secs} s; launches {sp_launches}; vs plain norms "
          f"max {sp_diff.max():.3g} mean {sp_diff.mean():.3g}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(float(sp_diff.mean()) <= 0.02 and float(sp_diff.max()) <= 0.5,
          "single pass: kernel norms within tolerance of plain norms")
    launches, sp_launches = with_wholes(launches), with_wholes(sp_launches)
    for k, r in results.items():
        r["launches_decode"] = launches[k]
        r["launches_single_pass"] = sp_launches[k]
    return {**out, "single_pass_s": sp_secs, "decode_launches": launches,
            "single_pass_launches": sp_launches, "single_pass_pad_launches": sp_pad_launches}


def untraced(decode):
    """``decode`` after one call outside any trace: a CUDA graph the decode
    must record again (a setting of its route changed since phase 5) is
    recorded there, not under the profiler, whose trace reads replays."""
    decode()
    return decode


def phase_cli(K, tree, workdir: Path) -> None:
    import numpy as np
    import torch

    from mra_gan_tpu_torch import test as cli
    from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
    from mra_gan_tpu_torch.data import nifti
    from mra_gan_tpu_torch.infer.sliding_window import patch_grid
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4
    from mra_gan_tpu_torch.ops.kernels import conv7 as C7
    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

    ck = workdir / "ck" / "smoke"
    ck.mkdir(parents=True)
    torch.save(state_dict_from_jax(tree, "resnet_6blocks"), ck / "latest_net_G_A.pth")
    rng = np.random.RandomState(SEED)
    shapes = CLI_SHAPES
    (workdir / "in").mkdir()
    batches = 0
    for i, shp in enumerate(shapes):
        aff = np.diag([0.8, 0.8, 1.5, 1.0])
        aff[:3, 3] = [-40.0, 12.5, 3.0 * i]
        data = (rng.rand(*shp) * 300).astype(np.float32)
        nifti.save(nifti.NiftiImage(data=data, affine=aff), workdir / "in" / f"v{i}.nii.gz")
        padded = [max(s, p) for s, p in zip(shp, PATCH)]
        padded[2] += padded[2] % 2  # odd Z is edge-padded to even
        batches += -(-len(patch_grid(padded, PATCH, (STRIDE,) * 3)) // DECODE_BATCH)
    K.reset_launches()
    C7.reset_launches()
    RP.reset_launches()
    C4.reset_launches()
    t0 = time.perf_counter()
    failed = cli.main(["--image", str(workdir / "in"), "--result", str(workdir / "out"),
                       "--checkpoints_dir", str(workdir / "ck"), "--name", "smoke",
                       "--ngf", str(NGF), "--patch_size", *map(str, PATCH),
                       "--stride_inplane", str(STRIDE), "--stride_layer", str(STRIDE),
                       "--decode_batch", str(DECODE_BATCH), "--device", DEVICE])
    secs = time.perf_counter() - t0
    check(failed == [], f"CLI skipped {failed}")
    per_forward = forward_launches(K, generator_norms(DECODE_BATCH, PATCH), torch.bfloat16)
    check(launched(K, times(per_forward, batches)),
          f"CLI launches {K.LAUNCHES}, want {batches} x {per_forward}, no backward")
    check(conv7_launched(times(CONV7_PER_FORWARD, batches)),
          f"CLI conv7 launches {C7.LAUNCHES}, want {batches} x {CONV7_PER_FORWARD}")
    check(pad_launched(times(PAD_PER_FORWARD, batches)),
          f"CLI pad launches {RP.LAUNCHES}, want {batches} x {PAD_PER_FORWARD}")
    check(c4s2_launched({}), f"CLI conv4s2 launches {C4.LAUNCHES}, want none")
    for i, shp in enumerate(shapes):
        src = nifti.load(workdir / "in" / f"v{i}.nii.gz")
        got = nifti.load(workdir / "out" / f"v{i}.nii.gz")
        check(got.data.shape == shp and bool(np.isfinite(got.data).all())
              and np.allclose(got.affine, src.affine, atol=1e-5),
              f"CLI output v{i}: shape, finite, affine")
    print(f"[cli] {len(shapes)} volumes in {secs:.2f} s (gzip IO included); "
          f"launches {dict(K.LAUNCHES)}", flush=True)


def train_config(dtype):
    """The reference default of bench.py:193-198: two resnet_6blocks
    generators and two 3-layer PatchGANs at ngf = ndf = 32, affine-free
    instance norm, LSGAN, ImagePool 50, Adam at beta1 0.5."""
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig

    return CycleGANConfig(ngf=NGF, ndf=NDF, net_g="resnet_6blocks", net_d="n_layers",
                          n_layers_d=3, gan_mode="lsgan", pool_size=50, beta1=0.5, dtype=dtype)


def train_inputs(batch: int, seed: int):
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.uniform(-1, 1, (batch, 1) + PATCH).astype(np.float32))
                 .to(DEVICE) for _ in range(2))


def timed_steps(step, state, real_a, real_b, n: int):
    """n train steps back to back, timed as the benchmark's train cell times
    them (mra_gan_tpu_torch/bench.py train_cell): the seconds between CUDA
    events recorded after each step. Returns them and the last step's
    metrics."""
    import torch

    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    for _ in range(n):
        _, metrics = step(state, real_a, real_b, TRAIN_LR)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])], metrics


def first_conv_library_calls(fn) -> list:
    """The convolution ops that one call of ``fn`` sends to aten (cuDNN on
    the card) with a (C, 1, 4, 4, 4) weight, the conv4s2 route's shape,
    under a profile of the host's ops that records their shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    names = ("aten::convolution", "aten::convolution_backward", "aten::cudnn_convolution")
    return sorted({f"{e.name} {e.input_shapes[:3]}" for e in prof.events() if e.name in names
                   and any(len(t) == 5 and list(t[1:]) == [1, 4, 4, 4] for t in e.input_shapes)})


def phase_train(K, results: dict, batches=TRAIN_BATCHES) -> dict:
    """create_state + make_train_step at the reference default in bf16, at
    each of ``batches``, the largest first: warm-up steps, then timed steps
    with the launch counters zeroed just before them (s/step their median,
    as the benchmark reads it), then one profiled step."""
    import statistics

    import torch

    from mra_gan_tpu_torch.models.cycle_gan import create_state, make_train_step
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4
    from mra_gan_tpu_torch.ops.kernels import conv7 as C7
    from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

    cfg = train_config(torch.bfloat16)
    out = {}
    # batch 8 first: phase 15 holds the benchmark to its reading, which
    # comes, as the benchmark's, before any traced step of the process
    for batch, timed in reversed([(b, t) for b, t in zip(TRAIN_BATCHES, TRAIN_TIMED_STEPS)
                                  if b in batches]):
        state = create_state(cfg, SEED, PATCH, DEVICE)
        step = make_train_step(cfg)
        real_a, real_b = train_inputs(batch, SEED + batch)
        for _ in range(TRAIN_WARMUP):
            step(state, real_a, real_b, TRAIN_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        C7.reset_launches()
        RP.reset_launches()
        C4.reset_launches()
        t0 = time.perf_counter()
        per_step, metrics = timed_steps(step, state, real_a, real_b, timed)
        wall = (time.perf_counter() - t0) / timed
        secs = statistics.median(per_step)
        launches = dict(K.LAUNCHES)
        conv7_launches = dict(C7.LAUNCHES)
        pad_launches = dict(RP.LAUNCHES)
        conv7_relayouts = C7.GRAD_RELAYOUTS["count"] / timed
        pad_relayouts = RP.RELAYOUTS["count"] / timed
        c4s2_launches = dict(C4.LAUNCHES)
        c4s2_relayouts = C4.RELAYOUTS["count"] / timed
        check(c4s2_launched(times(C4S2_PER_STEP, timed)),
              f"train b{batch}: {C4S2_PER_STEP} conv4s2 launches per step: {c4s2_launches} "
              f"over {timed} steps")
        check(conv7_launched(times(CONV7_PER_STEP, timed)),
              f"train b{batch}: {CONV7_PER_STEP} conv7 launches per step: {conv7_launches} "
              f"over {timed} steps")
        check(pad_launched(times(PAD_PER_STEP, timed)),
              f"train b{batch}: {PAD_PER_STEP} pad launches per step: {pad_launches} over "
              f"{timed} steps")
        relayouts = K.GRAD_RELAYOUTS["count"] / timed
        # the pads' backward hands the norms channels_last_3d gradients
        check(relayouts == 0, f"train b{batch}: {relayouts:g} norm gradient relayouts per step")
        norms = 4 * generator_norms(batch, PATCH) + 4 * patchgan_norms(batch)
        check(len(norms) == NORMS_PER_STEP, f"{len(norms)} norms per step")
        per_step = {**forward_launches(K, norms, cfg.dtype),
                    **backward_launches(K, norms, cfg.dtype)}
        check(launched(K, times(per_step, timed)),
              f"train b{batch}: {per_step} launches per step: {launches} over {timed} steps")
        losses = {k: float(v) for k, v in metrics.items()}
        check(len(losses) == 10 and all(math.isfinite(v) for v in losses.values()),
              f"train b{batch}: finite losses {losses}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[train] b{batch}: {secs:.4f} s/step (median; mean wall {wall:.4f}), "
              f"{batch / secs:.3f} pairs/s over {timed} steps; peak memory {peak:.2f} GiB; launches {launches}, conv7 "
              f"{conv7_launches}, pads {pad_launches}; gradient relayouts {relayouts:g} per "
              f"step (norms), {conv7_relayouts:g} (the stem's conv7 backward), "
              f"{pad_relayouts:g} (the pads), {c4s2_relayouts:g} (the conv4s2 backward); "
              f"conv4s2 {c4s2_launches}; losses {losses}", flush=True)
        prof = profile_run(lambda: step(state, real_a, real_b, TRAIN_LR), f"train b{batch}")
        at_first_conv = first_conv_library_calls(lambda: step(state, real_a, real_b, TRAIN_LR))
        check(not at_first_conv, f"train b{batch}: the step still calls cuDNN with the "
              f"PatchGAN's first conv's weight: {at_first_conv}")
        out[f"b{batch}"] = {"s_per_step": secs, "pairs_per_s": batch / secs, "steps": timed,
                            "peak_gib": peak, "launches": launches,
                            "grad_relayouts_per_step": relayouts, "losses": losses,
                            "profile": prof, "conv7_launches": conv7_launches,
                            "conv7_grad_relayouts_per_step": conv7_relayouts,
                            "pad_launches": pad_launches,
                            "pad_relayouts_per_step": pad_relayouts,
                            "c4s2_launches": c4s2_launches,
                            "c4s2_relayouts_per_step": c4s2_relayouts}
        for k, n in with_wholes(launches).items():
            results[k].setdefault("launches_train_per_step", {})[f"b{batch}"] = n / timed
            if batch == max(TRAIN_BATCHES):
                results[k]["launches_train"] = n
        del state, step
        torch.cuda.empty_cache()
    return out


def _step0(cfg, plain: bool, real_a, real_b):
    """Step 0 from the seeded state: (the ten losses, {param: raw gradient})."""
    import torch

    from mra_gan_tpu_torch.models.cycle_gan import create_state, make_train_step

    state = create_state(cfg, SEED, PATCH, DEVICE)
    with plain_norms() if plain else contextlib.nullcontext():
        _, metrics = make_train_step(cfg)(state, real_a.to(cfg.dtype), real_b.to(cfg.dtype),
                                          TRAIN_LR)
    grads = {f"{name}.{k}": (None if p.grad is None else p.grad.double().clone())
             for name, net in state.nets.items() for k, p in net.named_parameters()}
    losses = {k: float(v) for k, v in metrics.items()}
    del state
    torch.cuda.empty_cache()
    return losses, grads


def _errors_vs(ref, run) -> dict:
    """Per network: the relative L2 distance of ``run``'s raw gradients to
    ``ref``'s, and the largest elementwise one against the network's largest
    gradient; and the largest relative loss error."""
    import torch

    (lr, gr), (lx, gx) = ref, run
    out = {"loss": max(abs(lx[k] - lr[k]) / abs(lr[k]) for k in lr)}
    for key, g in gr.items():
        check((g is None) == (gx[key] is None), f"parity: {key} gradient presence")
    nets = {}
    for key, g in gr.items():
        if g is not None:
            nets.setdefault(key.split(".")[0], []).append((g.flatten(), gx[key].flatten()))
    for net, pairs in nets.items():
        ref_v = torch.cat([r for r, _ in pairs])
        got_v = torch.cat([x for _, x in pairs])
        d = got_v - ref_v
        out[net] = {"l2": float(d.norm() / ref_v.norm()),
                    "max": float(d.abs().max() / ref_v.abs().max())}
    return out


def phase_train_parity() -> dict:
    """Step 0 at batch 1 from the same seeded state through the norm kernels
    and through the plain norms (plain_norms), in float32 (TF32 off) and in
    bf16, each held against a float64 step through the plain norms, with
    cuDNN's deterministic algorithms so that the bars hold from run to run.

    Float32 is not exact here: at 64^3 a weight gradient of the stem or an
    up-conv is a sum over 10^5-10^6 voxels that cancels to a small value, and
    float32 rounding leaves both paths some 1e-3 of the network's largest
    gradient from float64 (2.5e-3 to 4.6e-3 on an H100). So the bars are
    relative to the
    plain path: float32 losses of the two paths at rtol 1e-4; for each
    network the kernel path's relative L2 distance to float64 at most 1.5x
    the plain path's + 1e-4; bf16 (the kernels round once where the plain
    norms round at every step) the same distance at most 1.25x the plain
    path's, and the largest relative loss error at most 1.25x the plain
    path's + 2^-8."""
    import torch

    real_a, real_b = train_inputs(1, SEED + 100)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = _step0(train_config(torch.float64), True, real_a, real_b)
        runs = {(dt, plain): _step0(train_config(dt), plain, real_a, real_b)
                for dt in (torch.float32, torch.bfloat16) for plain in (False, True)}
    finally:
        torch.backends.cudnn.deterministic = saved
    report = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ek, ep = _errors_vs(ref, runs[(dt, False)]), _errors_vs(ref, runs[(dt, True)])
        report[name] = {"kernel_vs_f64": ek, "plain_vs_f64": ep}
        print(f"[parity] {name} step 0 against float64: kernel path {ek}; plain path {ep}",
              flush=True)
        nets = [k for k in ek if k != "loss"]
        if dt == torch.float32:
            lk, lp = runs[(dt, False)][0], runs[(dt, True)][0]
            rel = max(abs(lk[k] - lp[k]) / abs(lp[k]) for k in lk)
            report[name]["loss_kernel_vs_plain"] = rel
            check(rel <= 1e-4, f"f32 parity: losses kernel vs plain at rtol 1e-4 ({rel:.3g})")
            check(all(ek[n]["l2"] <= 1.5 * ep[n]["l2"] + 1e-4 for n in nets),
                  "f32 parity: kernel-path gradients as close to float64 as plain-path ones")
        else:
            check(ek["loss"] <= 1.25 * ep["loss"] + BF16_ULP,
                  "bf16 parity: kernel-path losses as close to float64 as plain-path ones")
            check(all(ek[n]["l2"] <= 1.25 * ep[n]["l2"] for n in nets),
                  "bf16 parity: kernel-path gradients as close to float64 as plain-path ones")
    return report


def norm_kernels_reproducible(K) -> list:
    """Each norm kernel route, forward and backward, run twice on the same
    input at every norm shape of the batch-1 train step in bf16: the names
    of the shapes whose two results differ in any bit (the kernels merge
    their partials in a fixed order, so none should)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    differ = []
    for label, shape, act in train_norm_shapes():
        if not label.endswith(f"b{min(TRAIN_BATCHES)}"):
            continue
        x = _volume(gen, shape, torch.bfloat16)
        g = _volume(gen, shape, torch.bfloat16, 1.0, 0.0)
        runs = []
        for _ in range(2):
            y, mean, rstd = K.instance_norm_act_fwd(x, act, 0.2)
            runs.append((y, mean, rstd, K.instance_norm_act_bwd_fused(x, g, mean, rstd, act, 0.2)))
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            differ.append(f"{label} {shape} {act}")
    return differ


def library_calls_reproducible() -> dict:
    """Two runs each, on one input, of the library calls of the batch-1
    train step that are not this repo's kernels: cuDNN's conv forward, input
    gradient and weight gradient at its conv shapes, in bf16 and
    channels_last_3d. Returns {call: largest |difference|} (0.0 where the
    two runs agree bit for bit), under whatever determinism settings are on."""
    import torch

    from mra_gan_tpu_torch.ops.conv import conv3d, conv_transpose3d

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    b = min(TRAIN_BATCHES)

    def vol(shape):
        return _volume(gen, shape, torch.bfloat16, 1.0, 0.0)

    def spread(fn) -> float:
        first, second = fn(), fn()
        return max(float((x - y).detach().abs().max()) for x, y in zip(first, second))

    out = {}
    for name, tr, xs, ws, stride, padding in (  # the 7^3 convs are conv7 kernels, all ways
            ("down1 c3s2", False, (2 * b, NGF, 64, 64, 64), (2 * NGF, NGF, 3, 3, 3), 2, 1),
            ("trunk c3", False, (2 * b, 4 * NGF, 18, 18, 18), (4 * NGF, 4 * NGF, 3, 3, 3), 1, 0),
            ("up2 ct3s2", True, (2 * b, 2 * NGF, 32, 32, 32), (2 * NGF, NGF, 3, 3, 3), 2, 1),
            ("D c4s2", False, (2 * b, NDF, 32, 32, 32), (2 * NDF, NDF, 4, 4, 4), 2, 1)):
        x = vol(xs).requires_grad_()
        w = vol(ws).float().mul_(0.05).requires_grad_()
        conv = conv_transpose3d if tr else conv3d
        extra = (1,) if tr else ()
        y = conv(x, w, None, stride, padding, *extra)
        g = vol(tuple(y.shape))
        out[f"cudnn {name} forward"] = spread(lambda: (conv(x, w, None, stride, padding, *extra),))
        out[f"cudnn {name} dgrad, wgrad"] = spread(
            lambda: torch.autograd.grad(y, (x, w), g, retain_graph=True))
    return out


def _max_diff(a, b) -> float:
    """Largest |a - b| over two state_to_dict trees (0.0 when bit-equal)."""
    import torch

    if isinstance(a, dict):
        return max((_max_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        return max((_max_diff(x, y) for x, y in zip(a, b)), default=0.0)
    if torch.is_tensor(a):
        if torch.equal(a, b):
            return 0.0
        if not a.is_floating_point():
            return math.inf
        return float((a.double() - b.double()).abs().max())
    return 0.0 if a == b else math.inf


@contextlib.contextmanager
def reproducible(all_algorithms: bool):
    """cuDNN's deterministic algorithms, and with ``all_algorithms`` also
    torch.use_deterministic_algorithms(True), which switches PyTorch's own
    nondeterministic CUDA kernels to deterministic ones; the settings are put
    back afterwards."""
    import torch

    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    if all_algorithms:
        torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def resume_run(K, workdir: Path, step, cfg, inputs, per_steps) -> dict:
    """CKPT_STEPS steps, save, CKPT_STEPS more (the straight run); restore
    into a state made from another seed and the same CKPT_STEPS steps (the
    resumed run). Checks the round trip bit for bit, the moments' layout
    after the restore and each run's exact norm launches; returns the times,
    the files' bytes and how far the resumed run lies from the straight one."""
    import torch

    from mra_gan_tpu_torch.checkpoint import CheckpointManager
    from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
    from mra_gan_tpu_torch.models.cycle_gan import create_state

    def run(state, batches, what):
        K.reset_launches()
        metrics = [step(state, a, b, TRAIN_LR)[1] for a, b in batches]
        torch.cuda.synchronize()
        check(launched(K, per_steps), f"checkpoint {what}: launches {dict(K.LAUNCHES)}, want "
              f"{per_steps} over {CKPT_STEPS} steps")
        return [{k: v.float().cpu() for k, v in m.items()} for m in metrics]

    state = create_state(cfg, SEED, PATCH, DEVICE)
    run(state, inputs[:CKPT_STEPS], "first steps")
    mgr = CheckpointManager(workdir, "smoke")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(CKPT_STEPS, state)
    save_s = time.perf_counter() - t0
    at_save = state_to_dict(state)
    sizes = {p.name: p.stat().st_size for p in sorted(mgr.root.iterdir())}
    straight = run(state, inputs[CKPT_STEPS:], "straight run")
    straight_state = state_to_dict(state)
    del state

    fresh = create_state(cfg, SEED + 1, PATCH, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.restore(CKPT_STEPS, fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    round_trip = _max_diff(state_to_dict(fresh), at_save)
    check(round_trip == 0.0, f"checkpoint round trip: the restored state differs from the "
          f"saved one by {round_trip}")
    layouts = [v.is_contiguous(memory_format=torch.channels_last_3d)
               for opt in (fresh.opt_g, fresh.opt_d) for s in opt.state.values()
               for v in s.values() if torch.is_tensor(v) and v.dim() == 5]
    check(len(layouts) > 0 and all(layouts), f"5-D Adam moments channels_last_3d after the "
          f"restore: {sum(layouts)} of {len(layouts)}")
    resumed = run(fresh, inputs[CKPT_STEPS:], "resumed run")
    resumed_state = state_to_dict(fresh)
    del fresh
    torch.cuda.empty_cache()
    metrics_diff = _max_diff(straight, resumed)
    state_diff = _max_diff(straight_state, resumed_state)
    return {"save_s": save_s, "restore_s": restore_s, "bytes": sizes,
            "g_a": at_save["nets"]["g_a"], "bit_equal": metrics_diff == 0.0 and state_diff == 0.0,
            "metrics_max_diff": metrics_diff, "state_max_diff": state_diff}


def phase_checkpoint(K, workdir: Path) -> dict:
    """Checkpoint and exact resume at the train step's reference default
    (train_config, bf16, batch 1): resume_run twice, first with cuDNN's
    deterministic algorithms alone, then with torch.use_deterministic_algorithms
    on as well (``reproducible``), each held to its round trip, layouts and
    launches. Both must be bit-equal in every parameter, Adam state, pool,
    generator state and metric: every kernel of the step sums in a fixed
    order, the replication pads' backward included, so cuDNN's setting
    alone is enough. Beside them, under cuDNN's setting alone, the norm
    kernels run twice at every batch-1 norm shape
    (norm_kernels_reproducible) and the pad kernels at every batch-1 pad
    shape (pad_kernels_reproducible) and must agree; the library calls of
    the step that are not this repo's kernels run twice
    (library_calls_reproducible), reported. Then latest_net_G_A.pth decodes
    a small volume through ``python -m mra_gan_tpu_torch.test`` in a
    process of its own."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch import test as cli
    from mra_gan_tpu_torch.data import nifti
    from mra_gan_tpu_torch.models.cycle_gan import make_train_step

    cfg = train_config(torch.bfloat16)
    batch = min(TRAIN_BATCHES)
    inputs = [train_inputs(batch, SEED + 300 + k) for k in range(2 * CKPT_STEPS)]
    norms = 4 * generator_norms(batch, PATCH) + 4 * patchgan_norms(batch)
    per_steps = times({**forward_launches(K, norms, cfg.dtype),
                       **backward_launches(K, norms, cfg.dtype)}, CKPT_STEPS)
    step = make_train_step(cfg)
    runs = {}
    for mode, every in (("cudnn_deterministic", False), ("deterministic_algorithms", True)):
        with reproducible(every):
            runs[mode] = resume_run(K, workdir / mode, step, cfg, inputs, per_steps)
        r = runs[mode]
        print(f"[checkpoint] {mode}: save (epoch + latest, {len(r['bytes'])} files, "
              f"{sum(r['bytes'].values()) / 1e6:.1f} MB) {r['save_s']:.3f} s; restore "
              f"{r['restore_s']:.3f} s; resumed vs straight after {CKPT_STEPS} steps: "
              f"{'bit-equal' if r['bit_equal'] else 'NOT bit-equal'} (metrics max |diff| "
              f"{r['metrics_max_diff']:.3g}, state {r['state_max_diff']:.3g})", flush=True)
    with reproducible(False):
        kernels_differ = norm_kernels_reproducible(K)
        pads_differ = pad_kernels_reproducible()
        c4s2_differ = c4s2_kernels_reproducible()
        calls = library_calls_reproducible()
    print(f"[checkpoint] norm kernels run twice differ at {kernels_differ or 'no shape'}; pad "
          f"kernels at {pads_differ or 'no shape'}; conv4s2 kernels at "
          f"{c4s2_differ or 'no shape'}; library calls run twice, largest |diff|: "
          f"{calls}", flush=True)
    check(not kernels_differ, f"norm kernels not bit-reproducible at {kernels_differ}")
    check(not pads_differ, f"pad kernels not bit-reproducible at {pads_differ}")
    check(not c4s2_differ, f"conv4s2 kernels not bit-reproducible at {c4s2_differ}")
    check(runs["deterministic_algorithms"]["bit_equal"],
          "resumed run bit-equal to the straight one with deterministic algorithms")
    check(runs["cudnn_deterministic"]["bit_equal"],
          "resumed run bit-equal to the straight one with cuDNN's deterministic algorithms "
          "alone")
    sizes = runs["cudnn_deterministic"]["bytes"]
    print(f"[checkpoint] ckpt_{CKPT_STEPS}.pt {sizes[f'ckpt_{CKPT_STEPS}.pt'] / 1e6:.1f} MB, "
          f"{CKPT_STEPS}_net_*.pth "
          f"{sum(v for k, v in sizes.items() if k.startswith(f'{CKPT_STEPS}_net_')) / 1e6:.1f} MB",
          flush=True)

    # the decode CLI on the run's latest generator, as a user would call it
    ck = workdir / "cudnn_deterministic"
    rng = np.random.RandomState(SEED)
    data = (rng.rand(*CKPT_DECODE_SHAPE) * 300).astype(np.float32)
    nifti.save(nifti.NiftiImage(data=data, affine=np.diag([0.8, 0.8, 1.5, 1.0])),
               workdir / "ckpt_in.nii.gz")
    args = ["--image", str(workdir / "ckpt_in.nii.gz"), "--result", str(workdir / "ckpt_out.nii"),
            "--checkpoints_dir", str(ck), "--name", "smoke", "--ngf", str(NGF),
            "--which_epoch", "latest", "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mra_gan_tpu_torch.test", *args],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=300)
    decode_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"decode CLI on latest_net_G_A.pth: rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    out = nifti.load(workdir / "ckpt_out.nii")
    check(out.data.shape == CKPT_DECODE_SHAPE and bool(np.isfinite(out.data).all()),
          "decoded volume finite, of the input's shape")
    saved_g_a = runs["cudnn_deterministic"]["g_a"]
    gen = cli.load_generator(cli.parse(args))
    check(all(torch.equal(v.cpu(), saved_g_a[k]) for k, v in gen.net.state_dict().items()),
          "latest_net_G_A.pth holds the saved g_a")
    print(f"[checkpoint] latest_net_G_A.pth decoded {CKPT_DECODE_SHAPE} through the CLI in "
          f"{decode_s:.2f} s (a process of its own)", flush=True)
    for r in runs.values():
        del r["g_a"]
    return {"runs": runs, "steps": CKPT_STEPS, "launches_per_run": per_steps,
            "library_calls_twice_max_diff": calls, "pad_kernels_differ": pads_differ,
            "c4s2_kernels_differ": c4s2_differ,
            "decode_cli_s": decode_s}


SERVE_VOLUMES = 4
DRIVER_PAIRS = 4  # image/label pairs of the VOLUME shape
DRIVER_SAMPLES = 8  # --num_samples: 32 pairs an epoch
DRIVER_SKIP = 2  # first steps of each epoch left out of the steady state
RESUME_SAMPLES = 2  # --num_samples of the resume check (8 steps an epoch)


def _write_volumes(paths_and_data) -> float:
    """Write (path, NiftiImage) pairs with one thread each (gzip releases
    the GIL); returns the seconds taken."""
    from concurrent.futures import ThreadPoolExecutor

    from mra_gan_tpu_torch.data import nifti

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(1, len(paths_and_data))) as ex:
        for f in [ex.submit(nifti.save, img, path) for path, img in paths_and_data]:
            f.result()
    return time.perf_counter() - t0


def _decode_args(ck: Path, *extra) -> list:
    return ["--checkpoints_dir", str(ck), "--name", "smoke", "--ngf", str(NGF),
            "--patch_size", *map(str, PATCH), "--stride_inplane", str(STRIDE),
            "--stride_layer", str(STRIDE), "--decode_batch", str(DECODE_BATCH),
            "--device", DEVICE, *extra]


def phase_serve(K, tree, decode: dict, workdir: Path) -> dict:
    """The serving daemon (python -m mra_gan_tpu_torch.serve, in process,
    --once) over SERVE_VOLUMES synthetic VOLUME .nii.gz files and one
    truncated file, with a .pth of phase 4's tree: every good volume served,
    the truncated one in failed.log, each output bit-equal to an in-process
    inference of its file, and exactly SERVE_VOLUMES x phase 5's forward
    launches per volume, no backward. Then the directory decode CLI on the
    same volumes, against the serial sum of read, decode and write."""
    import argparse

    import numpy as np
    import torch

    from mra_gan_tpu_torch import serve
    from mra_gan_tpu_torch import test as cli
    from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
    from mra_gan_tpu_torch.data import nifti
    from mra_gan_tpu_torch.infer.sliding_window import patch_grid

    ck = workdir / "ck" / "smoke"
    ck.mkdir(parents=True)
    torch.save(state_dict_from_jax(tree, "resnet_6blocks"), ck / "latest_net_G_A.pth")
    watch, only, out, out_dir = (workdir / d for d in ("watch", "volumes", "served", "dir_out"))
    watch.mkdir()
    only.mkdir()
    rng = np.random.default_rng(SEED)
    aff = np.diag([0.8, 0.8, 1.5, 1.0])
    names = [f"v{i}.nii.gz" for i in range(SERVE_VOLUMES)]
    write_s = _write_volumes([
        (watch / n, nifti.NiftiImage(data=rng.random(VOLUME, np.float32) * 300, affine=aff))
        for n in names])
    whole = (watch / names[0]).read_bytes()
    (watch / "truncated.nii.gz").write_bytes(whole[: len(whole) // 3])
    for n in names:
        (only / n).hardlink_to(watch / n)
    print(f"[serve] wrote {SERVE_VOLUMES} {VOLUME} .nii.gz volumes in {write_s:.2f} s "
          f"({len(whole) / 1e6:.1f} MB each)", flush=True)

    n_batches = -(-len(patch_grid(VOLUME, PATCH, (STRIDE,) * 3)) // DECODE_BATCH)
    per_volume = times(forward_launches(K, generator_norms(DECODE_BATCH, PATCH),
                                        torch.bfloat16), n_batches)
    check(with_wholes({**per_volume, **dict.fromkeys(K.BACKWARD, 0)})
          == decode["decode_launches"], "phase 5's launches per volume")
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    served, failures = serve.main(["--watch", str(watch), "--result", str(out),
                                   *_decode_args(workdir / "ck"), "--once",
                                   "--poll_secs", "0.05"])
    serve_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check((served, failures) == (SERVE_VOLUMES, 1), f"served {served}, failures {failures}")
    check("truncated.nii.gz" in (out / "failed.log").read_text(), "truncated file in failed.log")
    check(launched(K, times(per_volume, SERVE_VOLUMES)),
          f"daemon launches {launches}, want {SERVE_VOLUMES} x {per_volume}, no backward")

    opt = serve.parse(["--watch", str(watch), "--result", str(out),
                       *_decode_args(workdir / "ck")])
    gen = cli.load_generator(opt)
    for n in names:
        sub = argparse.Namespace(**vars(opt))
        sub.image = str(watch / n)
        want = cli.inference(sub, gen, save=False)
        got = nifti.load(out / n)
        check(np.array_equal(got.data, want.data) and np.array_equal(got.affine, want.affine),
              f"served {n} bit-equal to an in-process inference")
    t0 = time.perf_counter()
    img = nifti.load(watch / names[0])
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nifti.save(img, workdir / "write_probe.nii.gz")
    one_write_s = time.perf_counter() - t0
    decode_s = float(np.median(decode["decode_s"]))
    serial_s = SERVE_VOLUMES * (read_s + decode_s + one_write_s)

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    failed = cli.main(["--image", str(only), "--result", str(out_dir),
                       *_decode_args(workdir / "ck")])
    dir_s = time.perf_counter() - t0
    check(failed == [], f"directory CLI skipped {failed}")
    check(launched(K, times(per_volume, SERVE_VOLUMES)),
          f"directory CLI launches {dict(K.LAUNCHES)}, want {SERVE_VOLUMES} x {per_volume}")
    for n in names:
        check(np.array_equal(nifti.load(out_dir / n).data, nifti.load(out / n).data),
              f"directory CLI {n} bit-equal to the daemon's")
    print(f"[serve] daemon: {SERVE_VOLUMES} volumes in {serve_s:.3f} s wall, "
          f"{serve_s / SERVE_VOLUMES:.3f} s/volume (IO included); one volume's read "
          f"{read_s:.3f} s, write {one_write_s:.3f} s; phase 5 decode {decode_s:.4f} s; "
          f"launches {launches}", flush=True)
    print(f"[serve] directory CLI: {SERVE_VOLUMES} volumes in {dir_s:.3f} s "
          f"({dir_s / SERVE_VOLUMES:.3f} s/volume) against the serial sum read + decode + "
          f"write {serial_s:.3f} s ({serial_s / SERVE_VOLUMES:.3f} s/volume)", flush=True)
    return {"volumes": SERVE_VOLUMES, "serve_s": serve_s,
            "serve_s_per_volume": serve_s / SERVE_VOLUMES, "read_s": read_s,
            "write_s": one_write_s, "decode_s": decode_s, "dir_cli_s": dir_s,
            "serial_sum_s": serial_s, "launches": launches,
            "gzip_bytes_per_volume": len(whole)}


EVAL_RTOL = 1e-5  # evaluate's metrics on the card against the CPU, relative


def phase_evaluate(workdir: Path) -> dict:
    """Phase 10, evaluate: python -m mra_gan_tpu_torch.evaluate (in process)
    on phase 10's served volumes against their inputs, on the card and then
    on the CPU: every pair's SSIM, PSNR, MAE and Pearson r, and their mean,
    the same within EVAL_RTOL relative; seconds per pair on each."""
    import contextlib as ctx
    import io

    from mra_gan_tpu_torch import evaluate

    rows, secs = {}, {}
    for dev in ("cuda", "cpu"):
        out = io.StringIO()
        t0 = time.perf_counter()
        with ctx.redirect_stdout(out):
            evaluate.main(["--pred", str(workdir / "served"), "--target",
                           str(workdir / "volumes"), "--device", dev])
        secs[dev] = time.perf_counter() - t0
        rows[dev] = [json.loads(line) for line in out.getvalue().splitlines()]
    check([r["file"] for r in rows["cuda"]] == [r["file"] for r in rows["cpu"]]
          and len(rows["cpu"]) == SERVE_VOLUMES + 1, f"evaluate's pairs: {rows}")
    worst = {}
    for gpu, cpu in zip(rows["cuda"], rows["cpu"]):
        for k in ("ssim", "psnr", "mae", "pearson_r"):
            rel = abs(gpu[k] - cpu[k]) / abs(cpu[k])
            worst[k] = max(worst.get(k, 0.0), rel)
            check(rel <= EVAL_RTOL, f"evaluate {gpu['file']} {k}: card {gpu[k]!r}, "
                  f"CPU {cpu[k]!r} (relative {rel:.3g} > {EVAL_RTOL})")
    per_pair = {dev: t / SERVE_VOLUMES for dev, t in secs.items()}
    print(f"[evaluate] {SERVE_VOLUMES} served {VOLUME} volumes against their inputs: "
          f"{per_pair['cuda']:.3f} s/pair on the card, {per_pair['cpu']:.3f} on the CPU "
          f"(NIfTI reads included); mean {rows['cuda'][-1]}; the largest relative "
          f"difference card/CPU {worst}", flush=True)
    return {"s_per_pair": per_pair, "mean": rows["cuda"][-1], "mean_cpu": rows["cpu"][-1],
            "max_rel_diff": worst}


def _driver_data(root: Path) -> None:
    """DRIVER_PAIRS image/label pairs of the VOLUME shape: an ellipsoid of
    random intensities in a zero background (the foreground crop's box), the
    label a scaled copy of its image inside it, on a flipped affine (the RAS
    reorientation)."""
    import numpy as np

    from mra_gan_tpu_torch.data import nifti

    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in VOLUME]
    inside = ((axes[0][:, None, None] / 0.9) ** 2 + (axes[1][None, :, None] / 0.8) ** 2
              + (axes[2][None, None, :] / 0.85) ** 2) <= 1.0
    aff = np.diag([-0.8, 0.8, 1.5, 1.0])
    rng = np.random.default_rng(SEED + 11)
    pairs = []
    for i in range(DRIVER_PAIRS):
        img = np.where(inside, rng.random(VOLUME, np.float32) * 80 + 10, np.float32(0))
        pairs += [(root / "images" / f"{i}.nii.gz", nifti.NiftiImage(data=img, affine=aff)),
                  (root / "labels" / f"{i}.nii.gz",
                   nifti.NiftiImage(data=np.where(inside, img * 0.7 + 5, np.float32(0)),
                                    affine=aff))]
    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True)
    secs = _write_volumes(pairs)
    print(f"[driver] wrote {DRIVER_PAIRS} {VOLUME} image/label pairs in {secs:.2f} s",
          flush=True)


def _loss_lines_finite(log: Path) -> int:
    """The count of loss lines in ``log``; fails on a value that is not finite."""
    n = 0
    for line in log.read_text().splitlines():
        if not line.startswith("(epoch:"):
            continue
        vals = line.split(") ", 1)[1].split()
        nums = [float(v) for v in vals[1::2]]
        check(len(nums) == 10 and all(math.isfinite(v) for v in nums),
              f"loss line finite: {line}")
        n += 1
    return n


def _epoch_rates(records: list, batch: int) -> list:
    """Per epoch: the steady state's s/step (the StepTimer's data wait plus
    the step up to its read-back, the first DRIVER_SKIP steps left out), the
    data wait's share of it, and pairs/s. Where the losses were not read
    back every step, the timer cannot split a step, and s/step is the
    epoch's wall time over its steps (data share None)."""
    out = []
    for r in records:
        if len(r["comp_s"]) != len(r["data_s"]):
            s_step = r["wall_s"] / r["steps"]
            out.append({"epoch": r["epoch"], "steps": r["steps"], "wall_s": r["wall_s"],
                        "s_per_step": s_step, "data_share": None,
                        "pairs_per_s": batch / s_step, "first_step_s": r["data_s"][0]})
            continue
        skip = min(DRIVER_SKIP, len(r["data_s"]) - 1)
        data, comp = r["data_s"][skip:], r["comp_s"][skip:]
        total = sum(data) + sum(comp)
        s_step = total / len(data)
        out.append({"epoch": r["epoch"], "steps": r["steps"], "wall_s": r["wall_s"],
                    "s_per_step": s_step, "data_share": sum(data) / total,
                    "pairs_per_s": batch / s_step, "first_step_s": r["data_s"][0] + r["comp_s"][0]})
    return out


def phase_driver(K, train: dict, results: dict, workdir: Path) -> dict:
    """The training driver (python -m mra_gan_tpu_torch.train, in process)
    at the reference default over DRIVER_PAIRS synthetic VOLUME pairs: run 1
    at batch 1 (LSGAN, 2 epochs, cold then warm cache), run 2 at batch 8 and
    4 workers, both reading the losses back every step (--print_freq 1),
    and a batch-1 epoch reading them back once; each held to finite loss
    lines, its checkpoint files and exactly (steps + 2) x phase 7's launches per
    step. Then, under
    torch.use_deterministic_algorithms(True), 1 epoch followed by
    --continue_train --epoch_count 2 against 2 straight epochs, bit for bit.
    First the native data path's build (native_build_report); last, the
    PatchLoader's own pairs/s with and without it (phase_loader)."""
    import torch

    from mra_gan_tpu_torch import train as driver
    from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
    from mra_gan_tpu_torch.core.memory import TRIAL_STEPS

    native_build = native_build_report()
    data = workdir / "data"
    _driver_data(data)
    cfg_dtype = torch.bfloat16
    common = ["--data_path", str(data), "--ngf", str(NGF), "--ndf", str(NDF),
              "--patch_size", *map(str, PATCH), "--no_lsgan", "--device", DEVICE,
              "--seed", str(SEED)]
    warm = ["--cache_dir", str(workdir / "ck" / "b1" / "cache")]
    pairs = DRIVER_PAIRS * DRIVER_SAMPLES
    runs = {}
    for tag, batch, print_freq, extra in (
            ("b1", 1, 1, ["--workers", "2", "--niter", "1", "--niter_decay", "1",
                          "--save_epoch_freq", "1"]),
            ("b8", 8, 1, ["--workers", "4", "--niter", "2", "--niter_decay", "0", *warm]),
            # batch 1 with the losses read back once an epoch, not every step
            ("b1_quiet", 1, pairs, ["--workers", "2", "--niter", "1", "--niter_decay", "0",
                                    *warm])):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        out = driver.main([*common, "--batch_size", str(batch), "--checkpoints_dir",
                           str(workdir / "ck"), "--name", tag, "--num_samples",
                           str(DRIVER_SAMPLES), *extra, "--print_freq", str(print_freq)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        steps = sum(r["steps"] for r in out["epochs"])
        check(steps == len(out["epochs"]) * pairs // batch, f"driver {tag}: {steps} steps")
        norms = 4 * generator_norms(batch, PATCH) + 4 * patchgan_norms(batch)
        per_step = {**forward_launches(K, norms, cfg_dtype),
                    **backward_launches(K, norms, cfg_dtype)}
        # two steps more: the memory preflight's trial steps before the first
        trial = TRIAL_STEPS
        check(launched(K, times(per_step, steps + trial)),
              f"driver {tag}: launches {launches}, want {steps} + {trial} x {per_step}")
        run = workdir / "ck" / tag
        n_lines = _loss_lines_finite(run / "loss_log.txt")
        want_lines = sum(k * batch % print_freq == 0 for k in range(1, steps + 1))
        check(n_lines == want_lines, f"driver {tag}: {n_lines} loss lines for {steps} steps")
        epochs = [str(r["epoch"]) for r in out["epochs"]]
        saved = (epochs if tag == "b1" else []) + ["latest"]
        check(all((run / f"ckpt_{e}.pt").exists() and (run / f"{e}_net_G_A.pth").exists()
                  for e in saved) and (run / "opt.txt").exists(),
              f"driver {tag}: checkpoint files {saved}")
        rates = _epoch_rates(out["epochs"], batch)
        phase7 = train[f"b{batch}"]["s_per_step"]
        for r in rates:
            how = (f"steady {r['s_per_step']:.4f} s/step ({r['pairs_per_s']:.2f} pairs/s), "
                   f"data wait {r['data_share']:.1%}, first step {r['first_step_s']:.3f} s"
                   if r["data_share"] is not None else
                   f"{r['s_per_step']:.4f} s/step over the epoch ({r['pairs_per_s']:.2f} "
                   f"pairs/s), one read-back")
            print(f"[driver] {tag} epoch {r['epoch']}: {r['steps']} steps in {r['wall_s']:.2f} "
                  f"s; {how}; phase 7 {phase7:.4f} s/step ({batch / phase7:.2f} pairs/s)",
                  flush=True)
        runs[tag] = {"batch": batch, "steps": steps, "wall_s": wall, "launches": launches,
                     "epochs": rates, "phase7_s_per_step": phase7}
        for k, n in with_wholes(launches).items():
            results[k].setdefault("launches_driver_per_step", {})[tag] = n / (steps + trial)
        del out
        torch.cuda.empty_cache()

    # exact resume through the driver: the step policy keeps the lr of an
    # epoch independent of --niter, so 1 epoch then a second resumed equals
    # 2 straight epochs
    resume = ["--batch_size", "1", "--num_samples", str(RESUME_SAMPLES), "--workers", "2",
              "--lr_policy", "step", "--lr_decay_iters", "1", "--niter_decay", "0",
              "--print_freq", "1", *warm]
    with reproducible(True):
        t0 = time.perf_counter()
        straight = driver.main([*common, *resume, "--checkpoints_dir", str(workdir / "ck"),
                                "--name", "straight", "--niter", "2"])
        driver.main([*common, *resume, "--checkpoints_dir", str(workdir / "ck"),
                     "--name", "resumed", "--niter", "1"])
        resumed = driver.main([*common, *resume, "--checkpoints_dir", str(workdir / "ck"),
                               "--name", "resumed", "--niter", "2", "--continue_train",
                               "--epoch_count", "2"])
        resume_s = time.perf_counter() - t0
    diff = _max_diff(state_to_dict(straight["state"]), state_to_dict(resumed["state"]))
    print(f"[driver] 1 epoch + --continue_train --epoch_count 2 against 2 straight epochs "
          f"({straight['state'].step} steps, deterministic algorithms): "
          f"{'bit-equal' if diff == 0.0 else f'NOT bit-equal (max |diff| {diff:.3g})'} "
          f"in {resume_s:.1f} s", flush=True)
    check(diff == 0.0 and resumed["state"].step == straight["state"].step,
          "driver resume bit-equal to the straight run")
    del straight, resumed
    torch.cuda.empty_cache()

    loader = phase_loader(data, workdir, native_build["ok"])
    return {"native_build": native_build, "runs": runs, "resume_bit_equal": diff == 0.0,
            "resume_s": resume_s, **loader}


def native_build_report() -> dict:
    """Phase 11's first step: the port's native data path (data/native.py)
    built from data/csrc/nifti_io.cc with g++ into build/native/. It fails
    the phase where g++ and zlib.h are there and the build fails; without
    them the loader keeps the pure-Python reader and numpy, and this says so."""
    from mra_gan_tpu_torch.data import native

    gxx = shutil.which("g++")
    version = zlib = None
    if gxx:
        version = subprocess.run([gxx, "--version"], capture_output=True,
                                 text=True).stdout.splitlines()[0]
        zlib = subprocess.run([gxx, "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                              capture_output=True, text=True).returncode == 0
    status = native.build_status()
    report = {"gxx": version, "zlib_h": zlib, **status}
    if status["ok"]:
        print(f"[native] {version}; built {Path(status['path']).name} in "
              f"{status['seconds']:.2f} s", flush=True)
    else:
        print(f"[native] NOT BUILT (g++: {version}, zlib.h: {zlib}): {status['error']}",
              flush=True)
    check(status["ok"] or not (gxx and zlib), "native data path builds where g++ and zlib.h are")
    return report


@contextlib.contextmanager
def native_off():
    """The loader without the native data path, patched off in process: the
    pure-Python reader and the numpy gather."""
    from mra_gan_tpu_torch.data import native

    saved = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = saved


def phase_loader(data: Path, workdir: Path, have_native: bool) -> dict:
    """The PatchLoader's own pairs/s on phase 11's data, cold (a new
    preprocessing cache) then warm (its memory maps), at workers 1 and 4,
    with the native data path and with it patched off, in turns (off,
    native, native, off); the batches of each run bit-equal to the first's."""
    import hashlib

    from mra_gan_tpu_torch.data.dataset import (PatchLoader, UnpairedVolumeDataset,
                                                flush_cache_writes)

    order = ("off", "native", "native", "off") if have_native else ("off", "off")
    rates, digests, k = {}, {}, 0
    for workers in (1, 4):
        for how in order:
            k += 1
            ds = UnpairedVolumeDataset(data, patch_size=PATCH, num_samples=DRIVER_SAMPLES,
                                       cache_dir=str(workdir / f"loader_cache_{k}"), seed=SEED)
            pl = PatchLoader(ds, batch_size=1, shuffle=True, workers=workers)
            row = {}
            with native_off() if how == "off" else contextlib.nullcontext():
                for temp, epoch in (("cold", 1), ("warm", 2)):
                    t0 = time.perf_counter()
                    batches = list(pl.epoch(epoch))
                    row[temp] = len(batches) / (time.perf_counter() - t0)
                    flush_cache_writes()
                    h = hashlib.sha256()
                    for a, b in batches:
                        h.update(a.tobytes())
                        h.update(b.tobytes())
                    digest = digests.setdefault(temp, h.hexdigest())
                    check(h.hexdigest() == digest, f"loader batches {how} w{workers} {temp} "
                          "bit-equal to the first run's")
            rates.setdefault(f"w{workers}", {}).setdefault(how, []).append(row)
            print(f"[loader] {workers} worker(s), {how}, {len(batches)} pairs an epoch: cold "
                  f"{row['cold']:.2f} pairs/s, warm {row['warm']:.2f} pairs/s", flush=True)
    print(f"[loader] batches bit-equal with the native data path and without "
          f"({len(order) * 2} runs, cold and warm)" if have_native else
          "[loader] the native data path is absent; the pure-Python reader and numpy only",
          flush=True)
    return {"loader_pairs_per_s": rates, "rank_views": loader_rank_views(data, workdir)}


VIEW_BATCH, VIEW_SAMPLES = 8, 2  # the driver's default --num_samples: 4 pairs, one step


def loader_rank_views(data: Path, workdir: Path) -> dict:
    """Phase 11's data through the loader's global view (what every rank of
    a data-parallel group ran before the rank view) and its rank views at R
    = 2 and 4 (PatchLoader(rows=...)), in turns (global, R = 2, R = 4, then
    back): the R ranks of a view one after another in this process, sharing
    one new cache, all cold (epoch 1) and then all warm (epoch 2). Per rank:
    its loader's host seconds an epoch and pairs/s of its rows; the rank
    views' rows, stacked, bit-equal to the global view's batches."""
    import numpy as np

    from mra_gan_tpu_torch.data.dataset import (PatchLoader, UnpairedVolumeDataset,
                                                flush_cache_writes)

    out, ref, k = {}, {}, 0
    for ranks in (1, 2, 4, 4, 2, 1):
        k += 1
        ds = UnpairedVolumeDataset(data, patch_size=PATCH, num_samples=VIEW_SAMPLES,
                                   cache_dir=str(workdir / f"view_cache_{k}"), seed=SEED)
        per = VIEW_BATCH // ranks
        loaders = [PatchLoader(ds, batch_size=VIEW_BATCH, workers=1,
                               rows=None if ranks == 1 else (r * per, (r + 1) * per))
                   for r in range(ranks)]
        row = {}
        for temp, epoch in (("cold", 1), ("warm", 2)):
            secs, batches = [], []
            for pl in loaders:
                t0 = time.perf_counter()
                batches.append(list(pl.epoch(epoch)))
                secs.append(time.perf_counter() - t0)
            flush_cache_writes()
            stacked = [tuple(np.concatenate([b[s][m] for b in batches]) for m in (0, 1))
                       for s in range(len(batches[0]))]
            want = ref.setdefault(temp, stacked)
            check(len(stacked) == len(want) > 0 and all(
                np.array_equal(a, wa) and np.array_equal(b, wb)
                for (a, b), (wa, wb) in zip(stacked, want)),
                f"loader rank views R={ranks} {temp}: rows bit-equal to the global view's")
            pairs = len(batches[0]) * per
            row[temp] = {"s": secs, "pairs_per_s": [pairs / t for t in secs]}
        label = "global" if ranks == 1 else f"R={ranks}"
        out.setdefault(label, []).append(row)
        print(f"[loader] {'global view (every rank, before)' if ranks == 1 else f'rank view {label}'}"
              f", batch {VIEW_BATCH}, {VIEW_SAMPLES} samples a volume, 1 worker: per rank "
              + "; ".join(f"{t} {max(row[t]['s']):.3f} s an epoch (mean {np.mean(row[t]['s']):.3f}), "
                          f"{min(row[t]['pairs_per_s']):.2f} pairs/s of its rows"
                          for t in ("cold", "warm")), flush=True)
    print("[loader] rank views at R = 2 and 4 bit-equal to the global view, cold and warm",
          flush=True)
    return out


# Phase 12: the rest of the zoo. (label, netG, netD, norm) of each train-step
# configuration; the Dynet at the options' default schedule.
ZOO_CONFIGS = (("unet_custom", "unet_custom", "n_layers", "instance"),
               ("Dynet", "Dynet", "n_layers", "instance"),
               ("pixel", "resnet_6blocks", "pixel", "instance"),
               ("batch", "resnet_6blocks", "n_layers", "batch"))
ZOO_DYNET_SIZES = (128, 128, 64)
ZOO_WARMUP, ZOO_STEPS = 1, 2
ZOO_DECODE_NETS = ("unet_custom", "Dynet")
DEEP_UNETS = (("unet_128", 128), ("unet_256", 256))  # each at its smallest input


def unet_norms(n: int, spatial, num_downs: int = 5) -> list:
    """(N, C, D, H, W) of the 2 num_downs - 3 norms of one U-Net forward:
    level i (0 the outermost) has inner width ngf min(2^i, 8); each middle
    level's down norm (its inner width at spatial / 2^(i+1)) and every
    level's but the outermost up norm (the level above's inner width at
    spatial / 2^i). Their activation is none."""
    inner = [NGF * min(2 ** i, 8) for i in range(num_downs)]
    out = []
    for i in range(1, num_downs):
        if i < num_downs - 1:
            out.append((n, inner[i]) + tuple(s // 2 ** (i + 1) for s in spatial))
        out.append((n, inner[i - 1]) + tuple(s // 2 ** i for s in spatial))
    return out


def dynet_norms(n: int, spatial, sizes=ZOO_DYNET_SIZES) -> list:
    """(N, C, D, H, W) of the affine instance norms of one DynUNet forward
    at ``sizes``' schedule: three in the input block (its 1-channel input
    takes the shortcut conv), three in each downsample and the bottleneck
    (their strides do), two in each upsample's block. Activation none (the
    affine and leaky_relu follow in PyTorch)."""
    from mra_gan_tpu_torch.models.networks import dynunet_schedule

    strides = dynunet_schedule(sizes)[1]
    filters = [min(32 * 2 ** i, 320) for i in range(len(strides))]
    dims, level = list(spatial), []
    for s in strides:
        dims = [d // v for d, v in zip(dims, s)]
        level.append(tuple(dims))
    out = []
    for i in range(len(strides)):
        out += [(n, filters[i]) + level[i]] * 3
    for i in range(len(strides) - 2, -1, -1):
        out += [(n, filters[i]) + level[i]] * 2
    return out


def pixel_norms(n: int) -> list:
    """The pixel discriminator's one norm, at full resolution on 64^3
    (leaky_relu)."""
    return [(n, 2 * NDF) + PATCH]


def zoo_generator_norms(net_g: str, n: int, spatial) -> list:
    if net_g == "unet_custom":
        return unet_norms(n, spatial)
    if net_g == "Dynet":
        return dynet_norms(n, spatial)
    return generator_norms(n, spatial)


def zoo_norm_shapes():
    """(label, (N, C, D, H, W), act) of every norm shape the zoo's train steps
    reach at batch 1 and 8 (the generators at 2B and B, the discriminators
    at B and 2B) that phase 2 does not already hold: the U-Net's and the
    DynUNet's norms (activation none) and the pixel discriminator's
    (leaky_relu)."""
    seen = {s for _, s, _ in train_norm_shapes()}
    out = []
    for b in TRAIN_BATCHES:
        for n in (2 * b, b):
            for label, shapes, act in (("unet", unet_norms(n, PATCH), "none"),
                                       ("dynet", dynet_norms(n, PATCH), "none"),
                                       ("pixel", pixel_norms(n), "leaky_relu")):
                for s in shapes:
                    if s not in seen:
                        seen.add(s)
                        out.append((f"zoo {label} b{b}", s, act))
    return out


def zoo_config(net_g: str, net_d: str, norm: str, dtype):
    """phase 7's reference default with the zoo's networks: ngf = ndf = 32,
    LSGAN, pool 50, Adam 2e-4 / 0.5, the Dynet at the options' default."""
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig

    return CycleGANConfig(ngf=NGF, ndf=NDF, net_g=net_g, net_d=net_d, n_layers_d=3, norm=norm,
                          gan_mode="lsgan", pool_size=50, beta1=0.5, dtype=dtype,
                          dynet_sizes=ZOO_DYNET_SIZES)


def zoo_step_norms(cfg, batch: int) -> list:
    """The norm shapes of one fused train step's applies (route counting
    needs no N): four generator applies, two discriminator applies in the G
    loss and two in the D loss; none under batch norm, whose norms are
    plain PyTorch."""
    if cfg.norm == "batch":
        return []
    d = pixel_norms(batch) if cfg.net_d == "pixel" else patchgan_norms(batch)
    return 4 * zoo_generator_norms(cfg.net_g, batch, PATCH) + 4 * d


def zoo_decode(K, net_g: str, vol) -> dict:
    """The sliding-window decode and the single pass of the VOLUME with
    ``net_g`` (bf16, seeded weights): seconds per volume after a warm-up,
    exact launches, finite outputs; the single pass against plain norms."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch.infer.sliding_window import sliding_window_inference
    from mra_gan_tpu_torch.models.cycle_gan import make_generate_fn
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4
    from mra_gan_tpu_torch.parallel.spatial import single_pass_apply

    cfg = zoo_config(net_g, "n_layers", "instance", torch.bfloat16)
    # the U-Net's outermost down conv: one conv4s2 forward a generator forward
    c4s2_forward = {"conv4s2_spread": 1} if net_g.startswith("unet") else {}
    gen = make_generate_fn(cfg, "g_a", DEVICE, seed=SEED)
    n_batches = EXPECTED_GRID[1]

    def decode():
        return sliding_window_inference(vol, gen, PATCH, STRIDE, STRIDE, "gaussian", DECODE_BATCH)

    decode()
    torch.cuda.synchronize()
    K.reset_launches()
    C4.reset_launches()
    t0 = time.perf_counter()
    out = decode()
    secs = [time.perf_counter() - t0]
    per_forward = forward_launches(K, zoo_generator_norms(net_g, DECODE_BATCH, PATCH),
                                   cfg.dtype)
    launches = dict(K.LAUNCHES)
    check(c4s2_launched(times(c4s2_forward, n_batches)),
          f"zoo decode {net_g}: {n_batches} x {c4s2_forward} conv4s2 launches: {C4.LAUNCHES}")
    check(launched(K, times(per_forward, n_batches)),
          f"zoo decode {net_g}: {n_batches} x {per_forward}, no backward: {launches}")
    check(out.shape == VOLUME and bool(np.isfinite(out).all()), f"zoo decode {net_g} finite")
    t0 = time.perf_counter()
    decode()
    secs.append(time.perf_counter() - t0)

    single_pass_apply(gen, vol)
    torch.cuda.synchronize()
    K.reset_launches()
    C4.reset_launches()
    t0 = time.perf_counter()
    sp = single_pass_apply(gen, vol)
    sp_secs = [time.perf_counter() - t0]
    check(c4s2_launched(c4s2_forward), f"zoo single pass {net_g}: {c4s2_forward} conv4s2 "
          f"launches: {C4.LAUNCHES}")
    sp_want = forward_launches(K, zoo_generator_norms(net_g, 1, VOLUME), cfg.dtype)
    sp_launches = dict(K.LAUNCHES)
    check(launched(K, sp_want), f"zoo single pass {net_g}: {sp_want}, no backward: "
          f"{sp_launches}")
    t0 = time.perf_counter()
    single_pass_apply(gen, vol)
    sp_secs.append(time.perf_counter() - t0)
    with plain_norms():
        sp_ref = single_pass_apply(gen, vol)
    diff = np.abs(sp - sp_ref)
    check(sp.shape == VOLUME and bool(np.isfinite(sp).all()) and float(diff.mean()) <= 0.02
          and float(diff.max()) <= 0.5, f"zoo single pass {net_g}: finite, kernel norms "
          f"within tolerance of plain norms (max {diff.max():.3g}, mean {diff.mean():.3g})")
    print(f"[zoo decode] {net_g}: sliding window {secs} s/volume, launches {launches}; "
          f"single pass {sp_secs} s, launches {sp_launches}, vs plain norms max "
          f"{diff.max():.3g} mean {diff.mean():.3g}", flush=True)
    del gen
    torch.cuda.empty_cache()
    return {"decode_s": secs, "single_pass_s": sp_secs, "per_forward": per_forward,
            "decode_launches": launches, "single_pass_launches": sp_launches,
            "single_pass_vs_plain_max": float(diff.max())}


def zoo_batch_norm_decode(K, vol) -> dict:
    """The VOLUME's sliding-window decode with resnet_6blocks under --norm
    batch (seeded weights), in float32 (TF32 off) and bf16, at --decode_batch
    DECODE_BATCH against 1. A generator that holds a batch norm takes one
    patch a call (infer/sliding_window.py per_call), so both run the grid's
    147 patches one a call, with no norm kernel launch (batch norm is plain
    PyTorch), and are held to each other within the phase's bars: float32
    1e-5, bf16 the single pass's against plain norms. Beside it, one batch-8
    forward against its patches one at a time: the batch statistics that the
    rule keeps out of the decode."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch.infer.sliding_window import sliding_window_inference
    from mra_gan_tpu_torch.models.cycle_gan import make_generate_fn

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = make_generate_fn(zoo_config("resnet_6blocks", "n_layers", "batch", dtype), "g_a",
                               DEVICE, seed=SEED)
        calls = []

        class Counted:
            net, device, dtype = gen.net, gen.device, gen.dtype

            def __call__(self, x):
                calls.append(int(x.shape[0]))
                return gen(x)

        decodes, secs = {}, {}
        for batch in (DECODE_BATCH, 1, DECODE_BATCH, 1):  # the second pair timed
            calls.clear()
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            decodes[batch] = sliding_window_inference(vol, Counted(), PATCH, STRIDE, STRIDE,
                                                      "gaussian", batch)
            secs[batch] = time.perf_counter() - t0
            check(calls == [1] * EXPECTED_GRID[0] and not any(K.LAUNCHES.values()),
                  f"batch-norm decode at batch {batch}: {len(calls)} calls of "
                  f"{set(calls)}, launches {dict(K.LAUNCHES)}")
        a, b = decodes[DECODE_BATCH], decodes[1]
        diff = np.abs(a - b)
        tag = "f32" if dtype == torch.float32 else "bf16"
        ok = (float(diff.max()) <= 1e-5 if tag == "f32"
              else float(diff.mean()) <= 0.02 and float(diff.max()) <= 0.5)
        check(a.shape == VOLUME and bool(np.isfinite(a).all()) and ok,
              f"batch-norm decode {tag}: --decode_batch {DECODE_BATCH} against 1, max "
              f"{diff.max():.3g} mean {diff.mean():.3g}")
        x = torch.from_numpy(vol[:64, :128, :256].copy()).reshape(DECODE_BATCH, 1, *PATCH)
        whole = gen(x).float()
        apart = torch.cat([gen(x[i:i + 1]) for i in range(DECODE_BATCH)]).float()
        batch_stats = float((whole - apart).abs().max())
        out[tag] = {"s_per_volume": {f"b{k}": v for k, v in secs.items()},
                    "max_abs_b8_vs_b1": float(diff.max()), "bit_equal": bool((diff == 0).all()),
                    "calls": EXPECTED_GRID[0], "batch_forward_vs_apart": batch_stats}
        print(f"[zoo decode] resnet_6blocks --norm batch {tag}: --decode_batch {DECODE_BATCH} "
              f"{secs[DECODE_BATCH]:.3f} s/volume, 1 {secs[1]:.3f} s, {EXPECTED_GRID[0]} calls "
              f"of one patch each; against each other "
              f"{'bit-equal' if out[tag]['bit_equal'] else f'max {diff.max():.3g}'}; a batch-"
              f"{DECODE_BATCH} forward against its patches apart: max {batch_stats:.3g}",
              flush=True)
        del gen
        torch.cuda.empty_cache()
    return out


def zoo_deep_unet(K, net_g: str, side: int) -> dict:
    """One forward of ``net_g`` at batch 1 on its smallest input, side^3:
    exact launches, finite, against plain norms."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch.models.cycle_gan import make_generate_fn
    from mra_gan_tpu_torch.models.networks import UNET_DOWNS
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    gen = make_generate_fn(zoo_config(net_g, "n_layers", "instance", torch.bfloat16), "g_a",
                           DEVICE, seed=SEED)
    x = torch.from_numpy(np.random.RandomState(SEED).uniform(
        -1, 1, (1, 1, side, side, side)).astype(np.float32))
    gen(x)
    torch.cuda.synchronize()
    K.reset_launches()
    C4.reset_launches()
    t0 = time.perf_counter()
    y = gen(x)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = forward_launches(K, unet_norms(1, (side,) * 3, UNET_DOWNS[net_g]), torch.bfloat16)
    launches = dict(K.LAUNCHES)
    check(launched(K, want), f"{net_g} forward: {want}, no backward: {launches}")
    check(c4s2_launched({"conv4s2_spread": 1}), f"{net_g} forward: one conv4s2 forward, "
          f"{C4.LAUNCHES}")
    with plain_norms():
        yp = gen(x)
    d = (y.float() - yp.float()).abs()
    check(y.shape == x.shape and bool(torch.isfinite(y).all()) and float(d.mean()) <= 0.02
          and float(d.max()) <= 0.5, f"{net_g}: finite, kernel norms within tolerance of "
          f"plain norms (max {float(d.max()):.3g})")
    print(f"[zoo deep] {net_g} at {side}^3: forward {secs * 1e3:.1f} ms, launches {launches}; "
          f"vs plain norms max {float(d.max()):.3g} mean {float(d.mean()):.3g}", flush=True)
    del gen, x, y, yp
    torch.cuda.empty_cache()
    return {"forward_s": secs, "launches": launches, "vs_plain_max": float(d.max())}


def zoo_train(K, label: str, cfg, batch: int) -> tuple:
    """create_state + make_train_step at ``cfg`` and ``batch``: ZOO_WARMUP
    steps, then ZOO_STEPS timed with the counters zeroed just before; exact
    launches, finite losses. Returns (the record, the state)."""
    import torch

    from mra_gan_tpu_torch.models.cycle_gan import create_state, make_train_step
    from mra_gan_tpu_torch.ops.kernels import conv4s2 as C4

    state = create_state(cfg, SEED, PATCH, DEVICE)
    step = make_train_step(cfg)
    real_a, real_b = train_inputs(batch, SEED + 400 + batch)
    for _ in range(ZOO_WARMUP):
        step(state, real_a, real_b, TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    C4.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ZOO_STEPS):
        _, metrics = step(state, real_a, real_b, TRAIN_LR)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / ZOO_STEPS
    launches = dict(K.LAUNCHES)
    c4s2_want = c4s2_per_step(cfg.net_g, cfg.net_d, cfg.norm, cfg.dtype)
    check(c4s2_launched(times(c4s2_want, ZOO_STEPS)),
          f"zoo train {label} b{batch}: {c4s2_want} conv4s2 launches per step: "
          f"{dict(C4.LAUNCHES)} over {ZOO_STEPS} steps")
    norms = zoo_step_norms(cfg, batch)
    per_step = {**forward_launches(K, norms, cfg.dtype), **backward_launches(K, norms, cfg.dtype)}
    check(launched(K, times(per_step, ZOO_STEPS)),
          f"zoo train {label} b{batch}: {per_step} per step: {launches} over {ZOO_STEPS} steps")
    losses = {k: float(v) for k, v in metrics.items()}
    check(len(losses) == 10 and all(math.isfinite(v) for v in losses.values()),
          f"zoo train {label} b{batch}: finite losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    relayouts = K.GRAD_RELAYOUTS["count"] / ZOO_STEPS
    print(f"[zoo train] {label} b{batch}: {secs:.4f} s/step, {batch / secs:.3f} pairs/s; peak "
          f"{peak:.2f} GiB; {len(norms)} norms per step, launches per step "
          f"{ {k: v / ZOO_STEPS for k, v in launches.items() if v} }, conv4s2 {c4s2_want}; "
          f"gradient relayouts {relayouts:g} per step; losses {losses}", flush=True)
    return ({"s_per_step": secs, "pairs_per_s": batch / secs, "steps": ZOO_STEPS,
             "peak_gib": peak, "norms_per_step": len(norms), "launches_per_step": per_step,
             "c4s2_launches_per_step": c4s2_want, "grad_relayouts_per_step": relayouts,
             "losses": losses}, state)


def zoo_checkpoint(K, state, workdir: Path) -> dict:
    """The Dynet train state saved by CheckpointManager: its reference
    ``latest_net_G_A.pth`` carries MONAI's skip_layers aliases, and
    ``python -m mra_gan_tpu_torch.test`` (in process) decodes a small volume
    with it, bit-equal to an in-process decode with the state's g_a."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch import test as cli
    from mra_gan_tpu_torch.checkpoint import CheckpointManager
    from mra_gan_tpu_torch.data import nifti
    from mra_gan_tpu_torch.models.cycle_gan import GenerateFn

    mgr = CheckpointManager(workdir / "ck", "zoo")
    mgr.save("latest", state, also_latest=False)
    sd = torch.load(mgr.root / "latest_net_G_A.pth", weights_only=True)
    aliases = sum(k.startswith("skip_layers.") for k in sd)
    check(aliases == len(state.g_a.state_dict()) - 2,
          f"Dynet .pth: {aliases} skip_layers aliases, want every block's")
    data = (np.random.RandomState(SEED).rand(*CKPT_DECODE_SHAPE) * 300).astype(np.float32)
    nifti.save(nifti.NiftiImage(data=data, affine=np.diag([0.8, 0.8, 1.5, 1.0])),
               workdir / "zoo_in.nii.gz")
    args = ["--image", str(workdir / "zoo_in.nii.gz"), "--result", str(workdir / "zoo_out.nii"),
            "--checkpoints_dir", str(workdir / "ck"), "--name", "zoo", "--netG", "Dynet",
            "--dynet_sizes", *map(str, ZOO_DYNET_SIZES), "--ngf", str(NGF), "--precision",
            str(state.cfg.dtype).removeprefix("torch."),
            "--device", DEVICE]
    K.reset_launches()
    t0 = time.perf_counter()
    check(cli.main(args) == [], "decode CLI on the Dynet's latest_net_G_A.pth")
    decode_s = time.perf_counter() - t0
    check(K.LAUNCHES["instance_norm_slab"] + K.LAUNCHES["instance_norm_apply"] > 0
          and not any(K.LAUNCHES[k] for k in K.BACKWARD), "the CLI decode ran the forward kernels")
    got = nifti.load(workdir / "zoo_out.nii")
    g_a = state.g_a.eval()
    want = cli.inference(cli.parse(args), GenerateFn(g_a, state.cfg.dtype, state.device),
                         save=False)
    g_a.train()
    check(got.data.shape == CKPT_DECODE_SHAPE and bool(np.isfinite(got.data).all())
          and np.array_equal(got.data, want.data),
          "the CLI's decode of the .pth bit-equal to the in-process decode of the state's g_a")
    print(f"[zoo checkpoint] Dynet latest_net_G_A.pth with {aliases} skip_layers aliases "
          f"({(mgr.root / 'latest_net_G_A.pth').stat().st_size / 1e6:.1f} MB) decoded "
          f"{CKPT_DECODE_SHAPE} through the CLI in {decode_s:.2f} s, bit-equal to the "
          f"in-process decode", flush=True)
    return {"aliases": aliases, "decode_cli_s": decode_s}


def phase_zoo(K, bw: float, flops: float, results: dict, workdir: Path) -> dict:
    """Phase 12: the rest of the zoo at full width (see the module
    docstring)."""
    import numpy as np
    import torch

    t_start = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    for label, shape, act in zoo_norm_shapes():
        dtypes = (torch.bfloat16, torch.float32) if shape[0] == 1 else (torch.bfloat16,)
        for dtype in dtypes:
            forward_case(K, label, shape, act, dtype, bw, flops, results, gen)
            backward_case(K, label, shape, act, dtype, bw, flops, results, gen)
        torch.cuda.empty_cache()
    t_kernels = time.perf_counter() - t_start

    vol = np.random.RandomState(SEED).rand(*VOLUME).astype(np.float32) * 2 - 1
    decode = {net_g: zoo_decode(K, net_g, vol) for net_g in ZOO_DECODE_NETS}
    decode["resnet_6blocks batch norm"] = zoo_batch_norm_decode(K, vol)
    deep = {net_g: zoo_deep_unet(K, net_g, side) for net_g, side in DEEP_UNETS}

    train, dynet_state = {}, None
    for label, net_g, net_d, norm in ZOO_CONFIGS:
        cfg = zoo_config(net_g, net_d, norm, torch.bfloat16)
        for batch in TRAIN_BATCHES:
            rec, state = zoo_train(K, label, cfg, batch)
            train[f"{label} b{batch}"] = rec
            if label == "Dynet" and batch == min(TRAIN_BATCHES):
                dynet_state = state
            del state
            torch.cuda.empty_cache()
    ckpt = zoo_checkpoint(K, dynet_state, workdir)
    del dynet_state
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_start
    print(f"[zoo] phase 12 in {secs:.1f} s (kernel cases {t_kernels:.1f} s)", flush=True)
    return {"decode": decode, "deep_unets": deep, "train": train, "checkpoint": ckpt,
            "seconds": secs, "kernel_cases_s": t_kernels}


# ---------------------------------------------------------------------------
# Phase 13: on-device augmentation, registration with the dataset CLI, and the
# memory levers (--remat, the preflight, the single-pass refusal).

AUG_BATCH = 8
# the port on the card against the port on the CPU, same parameters, on
# [-1, 1] noise (the worst case for resampling): the intensity branches
# differ by float32 reductions (min, max, mean) and pow in another order; the
# resampling ones by coordinates computed with FMAs (~1e-5 voxel at 64^3)
# times the data's slope (up to 2 a voxel)
AUG_ATOL = {"intensity": 1e-5, "resampling": 1e-3}
AUG_RESAMPLING = ("rotate", "bspline", "rotate_z", "rotate_x", "rotate_y")
AUG_POLICY_BATCHES = 20
AUG_DRIVER_RUNS = (("b1", 1, 2), ("b8", 8, 4))  # tag, batch, workers
REG_TRUE_DEG = 3.0  # the known affine: a rotation in the first two axes ...
REG_TRUE_SHIFT = (2.0, -1.5, 1.0)  # ... and a shift, in voxels
REMAT_CASES = (("b8 64^3", 8, (64, 64, 64)), ("b2 128^3", 2, (128, 128, 128)))
REMAT_STEPS = 2
PREFLIGHT_RTOL = 0.10  # the preflight's estimate against phase 7's steady peak
SINGLE_PASS_LIMIT_GIB = 0.75  # the child's allocator cap: a 128x256x256 single pass needs more


def phase_augment() -> dict:
    """Each of the 13 branches at batch 8 x 64^3 on the card against the
    port's CPU result for the same parameters (both value-range modes), its
    device ms, and the whole policy (draws and apply) per batch."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch.data import augment as aug

    rs = np.random.RandomState(SEED + 13)
    img, lbl = (torch.from_numpy(rs.uniform(-1, 1, (AUG_BATCH, 1) + PATCH).astype(np.float32))
                for _ in range(2))
    img_d, lbl_d = img.to(DEVICE), lbl.to(DEVICE)
    gen = torch.Generator().manual_seed(SEED)
    dev_gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {}
    for choice, name in enumerate(aug.BRANCHES):
        draws = [(choice, aug.draw_params(choice, PATCH, gen, dev_gen)) for _ in range(AUG_BATCH)]
        on_card = torch.device(DEVICE).type
        check(all(not torch.is_tensor(v) or v.device.type == on_card
                  for _, p in draws for v in p.values()),
              f"augment {name}: tensors drawn on the card")
        host = [(c, {k: v.cpu() if torch.is_tensor(v) else v for k, v in p.items()})
                for c, p in draws]
        kind = "resampling" if name in AUG_RESAMPLING else "intensity"
        err = 0.0
        for value_range in ((-1.0, 1.0), None):
            got = aug.apply_batch(img_d, lbl_d, draws, value_range)
            want = aug.apply_batch(img, lbl, host, value_range)
            check(all(g.device.type == on_card for g in got), f"augment {name}: ran on the card")
            err = max([err] + [float((g.cpu() - w).abs().max()) for g, w in zip(got, want)])
        check(err <= AUG_ATOL[kind], f"augment {name}: max |card - cpu| {err:.3g} "
              f"> {AUG_ATOL[kind]}")
        ms = device_ms(lambda: aug.apply_batch(img_d, lbl_d, draws, (-1.0, 1.0)), iters=5)
        rows[name] = {"max_abs_err": err, "atol": AUG_ATOL[kind], "device_ms": ms}
        print(f"[augment] {choice:2d} {name:10s} batch {AUG_BATCH} x 64^3: {ms:.3f} device ms, "
              f"max |card - cpu| {err:.2e} (atol {AUG_ATOL[kind]:g})", flush=True)

    def policy(i):
        return aug.augment_batch(img_d, lbl_d, aug.step_generators(SEED, 1, i, DEVICE),
                                 (-1.0, 1.0), extended=True)

    policy(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(AUG_POLICY_BATCHES):
        out = policy(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / AUG_POLICY_BATCHES
    check(all(bool(torch.isfinite(o).all()) for o in out), "augment policy: finite")
    dev = device_ms(lambda: policy(1), iters=AUG_POLICY_BATCHES)
    print(f"[augment] the 13-choice policy, draws and apply, batch {AUG_BATCH} x 64^3: "
          f"{wall_ms:.2f} ms a batch on the host's clock, {dev:.3f} device ms", flush=True)
    return {"branches": rows, "policy_wall_ms": wall_ms, "policy_device_ms": dev}


def patchgan_norms_at(n: int, spatial) -> list:
    """patchgan_norms on any cube: k4/s2 convs halve it three times, the
    stride-1 k4 conv takes one voxel off."""
    s = spatial[0]
    return [(n, 2 * NDF) + (s // 4,) * 3, (n, 4 * NDF) + (s // 8,) * 3,
            (n, 8 * NDF) + (s // 8 - 1,) * 3]


def step_launches(K, cfg, batch: int, spatial) -> dict:
    """Each norm kernel's launches per train step of ``cfg`` (resnet_6blocks
    and the 3-layer PatchGAN): under remat the four generator applies run
    their norms forward once more in the backward."""
    gen = 4 * generator_norms(batch, spatial)
    norms = gen + 4 * patchgan_norms_at(batch, spatial)
    return {**forward_launches(K, norms + (gen if cfg.remat else []), cfg.dtype),
            **backward_launches(K, norms, cfg.dtype)}


def phase_augment_driver(K, train: dict, train_driver: dict, workdir: Path) -> dict:
    """In phase 11's directory, on its data and warm cache: the driver with
    --augment --augment_extended at batch 1 and 8 (one epoch each: s/step,
    data-wait share, exactly (steps + 2) x phase 7's launches per step, the
    two being the memory preflight's trial steps); then the preflight's
    estimate at batch 1 and 8 against phase 7's measured peak, the driver
    with --hbm_limit_gib 1 ending in SystemExit with the advice, and a real
    step in this process afterwards."""
    import torch

    from mra_gan_tpu_torch import train as driver
    from mra_gan_tpu_torch.core.memory import TRIAL_STEPS, preflight
    from mra_gan_tpu_torch.models.cycle_gan import create_state, make_train_step

    common = ["--data_path", str(workdir / "data"), "--ngf", str(NGF), "--ndf", str(NDF),
              "--patch_size", *map(str, PATCH), "--no_lsgan", "--device", DEVICE,
              "--seed", str(SEED), "--num_samples", str(DRIVER_SAMPLES), "--niter", "1",
              "--niter_decay", "0", "--checkpoints_dir", str(workdir / "ck_aug"),
              "--cache_dir", str(workdir / "ck" / "b1" / "cache")]
    cfg = train_config(torch.bfloat16)
    runs = {}
    for tag, batch, workers in AUG_DRIVER_RUNS:
        torch.cuda.synchronize()
        K.reset_launches()
        out = driver.main([*common, "--name", tag, "--batch_size", str(batch), "--workers",
                           str(workers), "--print_freq", "1", "--augment", "--augment_extended"])
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        steps = sum(r["steps"] for r in out["epochs"])
        check(steps == DRIVER_PAIRS * DRIVER_SAMPLES // batch, f"augment driver {tag}: {steps}")
        want = times(step_launches(K, cfg, batch, PATCH), steps + TRIAL_STEPS)
        check(launched(K, want), f"augment driver {tag}: launches {launches}, want {want}")
        _loss_lines_finite(workdir / "ck_aug" / tag / "loss_log.txt")
        rate = _epoch_rates(out["epochs"], batch)[0]
        plain = train_driver["runs"][tag]["epochs"][-1]
        runs[tag] = {"batch": batch, "steps": steps, "launches": launches, "epoch": rate,
                     "phase11_epoch": plain, "phase7_s_per_step": train[tag]["s_per_step"]}
        print(f"[augment] driver {tag} --augment --augment_extended: {rate['s_per_step']:.4f} "
              f"s/step, data wait {rate['data_share']:.1%}; phase 11 without it "
              f"{plain['s_per_step']:.4f} s/step, data wait {plain['data_share']:.1%}; "
              f"phase 7 {train[tag]['s_per_step']:.4f}", flush=True)
        del out
        torch.cuda.empty_cache()

    estimates = {}
    for batch in TRAIN_BATCHES:
        state = create_state(cfg, SEED, PATCH, DEVICE)
        step = make_train_step(cfg)
        est = preflight(step, state, batch, TRAIN_LR)
        check(est is not None and state.step == 0 and not state.opt_g.state,
              f"preflight b{batch}: an estimate, the state put back")
        measured = train[f"b{batch}"]["peak_gib"]
        check(abs(est["peak"] / 2 ** 30 - measured) <= PREFLIGHT_RTOL * measured,
              f"preflight b{batch}: {est['peak'] / 2 ** 30:.3f} GiB against phase 7's "
              f"{measured:.3f}")
        estimates[f"b{batch}"] = {"peak_gib": est["peak"] / 2 ** 30,
                                  "state_gib": est["state"] / 2 ** 30,
                                  "phase7_peak_gib": measured}
        print(f"[preflight] b{batch}: trial steps' peak {est['peak'] / 2 ** 30:.3f} GiB "
              f"(state {est['state'] / 2 ** 30:.3f}); phase 7 measured {measured:.3f} GiB",
              flush=True)
        del state, step
        torch.cuda.empty_cache()
    try:
        driver.main([*common, "--name", "refused", "--batch_size", "1", "--workers", "1",
                     "--hbm_limit_gib", "1"])
        refusal = None
    except SystemExit as e:
        refusal = str(e)
    check(refusal is not None and "--remat" in refusal and "--spatial_parallel" in refusal,
          f"preflight --hbm_limit_gib 1: SystemExit with the advice, got {refusal!r}")
    check(not (workdir / "ck_aug" / "refused" / "ckpt_latest.pt").exists(),
          "preflight refusal before any step")
    state = create_state(cfg, SEED, PATCH, DEVICE)
    _, metrics = make_train_step(cfg)(state, *train_inputs(1, SEED), TRAIN_LR)
    losses = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in losses.values()), f"a step after the refusal {losses}")
    print(f"[preflight] --hbm_limit_gib 1: {refusal}; a step afterwards in this process: "
          f"finite losses", flush=True)
    del state
    torch.cuda.empty_cache()
    return {"driver": runs, "preflight": estimates, "refusal": refusal}


def _blob_volume(small, seed: int):
    """A smooth structured volume (tests/test_registration.py's blobs on
    filtered noise) on a quarter-size grid, upsampled 4x trilinearly on the
    card to VOLUME."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from scipy import ndimage as ndi

    rs = np.random.RandomState(seed)
    vol = ndi.gaussian_filter(rs.rand(*small).astype(np.float32), 3.0)
    ii, jj, kk = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in small], indexing="ij")
    for _ in range(8):
        c = rs.uniform(0.25, 0.75, 3) * np.asarray(small)
        r2 = (ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2
        vol += rs.uniform(0.5, 1.5) * np.exp(-r2 / rs.uniform(8, 30))
    up = F.interpolate(torch.from_numpy(vol)[None, None].to(DEVICE), size=VOLUME,
                       mode="trilinear", align_corners=False)
    return up[0, 0].cpu().numpy()


def _mean_displacement(p_est, p_true, shape) -> float:
    """Mean |T_est(x) - T_true(x)| in voxels over the central half of the
    grid (tests/test_registration.py's measure)."""
    import numpy as np

    c = np.array([(s - 1) / 2.0 for s in shape], np.float32)
    axes = [np.arange(s // 4, 3 * s // 4, dtype=np.float32) for s in shape]
    pts = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")])
    d = ((p_est[:9] - p_true[:9]).reshape(3, 3) @ (pts - c[:, None])
         + (p_est[9:12] - p_true[9:12])[:, None])
    return float(np.mean(np.linalg.norm(d, axis=0)))


def phase_registration(workdir: Path) -> dict:
    """The dataset CLI (python -m mra_gan_tpu_torch.organize_folder_structure,
    in process, --split 1) on 2 synthetic VOLUME pairs: label 1 is label 0
    under a known affine, image 1 lies in label 1's frame, so both of pair
    1's registrations must recover it under 1 voxel; seconds per pair split
    into the host's features and resampling and the device's levels. Each
    image is its label scaled, as phase 11's are, so that the image's
    registration (to its registered label, whose error it inherits) is as
    well posed as the label's."""
    import numpy as np

    from mra_gan_tpu_torch import organize_folder_structure as cli
    from mra_gan_tpu_torch.data import nifti
    from mra_gan_tpu_torch.data.registration import apply_transform

    t0 = time.perf_counter()
    base = _blob_volume(tuple(v // 4 for v in VOLUME), SEED + 7)
    a = math.radians(REG_TRUE_DEG)
    p_true = np.zeros(12, np.float32)
    p_true[:9] = (np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0],
                            [0, 0, 1]]) - np.eye(3)).ravel()
    p_true[9:12] = REG_TRUE_SHIFT
    label0 = apply_transform(base, p_true, VOLUME, device=DEVICE)
    raw = workdir / "raw"
    for sub in ("images", "labels"):
        (raw / sub).mkdir(parents=True)
    for i, lbl in enumerate((label0, base)):
        nifti.save(nifti.NiftiImage(data=lbl * 0.7 + 5.0, affine=np.eye(4)),
                   raw / "images" / f"{i}.nii")
        nifti.save(nifti.NiftiImage(data=lbl, affine=np.eye(4)), raw / "labels" / f"{i}.nii")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    records = cli.main(["--images", str(raw / "images"), "--labels", str(raw / "labels"),
                        "--split", "1", "--out", str(workdir / "out")])
    cli_s = time.perf_counter() - t0
    check(len(records) == 2 and (workdir / "out" / "test" / "images" / "0.nii").exists(),
          "registration CLI wrote both pairs")
    errors = {w: _mean_displacement(records[1][w], p_true, VOLUME) for w in ("label", "image")}
    check(all(e < 1.0 for e in errors.values()), f"registration recovery {errors} voxels")
    pairs = [{k: r[k] for k in ("features_s", "levels_s", "resample_s")} for r in records]
    print(f"[registration] CLI on 2 pairs of {VOLUME}: {cli_s:.1f} s (setup {setup_s:.1f} s); "
          f"recovered the known affine to {errors['label']:.3f} (label) and "
          f"{errors['image']:.3f} (image) voxels; per pair host features / device levels / "
          f"host resampling s: " + "; ".join(
              f"{p['features_s']:.2f} / {p['levels_s']:.2f} / {p['resample_s']:.2f}"
              for p in pairs), flush=True)
    return {"cli_s": cli_s, "setup_s": setup_s, "error_voxels": errors, "pairs": pairs}


def phase_remat(K) -> dict:
    """The reference default with and without --remat at each REMAT_CASES
    batch and patch: one warm-up and REMAT_STEPS timed steps (s/step, peak
    memory, exact launches per step), then, from fresh states under
    torch.use_deterministic_algorithms(True), REMAT_STEPS steps of each,
    compared: within the train-step bar (losses at rtol 1e-4 * 10^k) and
    whether bit-equal."""
    import dataclasses

    import numpy as np
    import torch

    from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
    from mra_gan_tpu_torch.models.cycle_gan import create_state, make_train_step

    base = train_config(torch.bfloat16)
    out = {}
    for label, batch, patch in REMAT_CASES:
        rs = np.random.RandomState(SEED + batch)
        inputs = [torch.from_numpy(rs.uniform(-1, 1, (batch, 1) + patch).astype(np.float32))
                  .to(DEVICE) for _ in range(2)]
        row, finals = {}, {}
        for remat in (False, True):
            cfg = dataclasses.replace(base, remat=remat)
            state = create_state(cfg, SEED, patch, DEVICE)
            step = make_train_step(cfg)
            step(state, *inputs, TRAIN_LR)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launches()
            t0 = time.perf_counter()
            for _ in range(REMAT_STEPS):
                step(state, *inputs, TRAIN_LR)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / REMAT_STEPS
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            launches = dict(K.LAUNCHES)
            per_step = step_launches(K, cfg, batch, patch)
            check(launched(K, times(per_step, REMAT_STEPS)),
                  f"remat={remat} {label}: launches {launches}, want {per_step} per step")
            del state
            torch.cuda.empty_cache()
            with reproducible(True):
                state = create_state(cfg, SEED, patch, DEVICE)
                losses = [{k: float(v) for k, v in step(state, *inputs, TRAIN_LR)[1].items()}
                          for _ in range(REMAT_STEPS)]
                finals[remat] = (losses, state_to_dict(state))
            del state
            torch.cuda.empty_cache()
            tag = "remat" if remat else "plain"
            row[tag] = {"s_per_step": secs, "peak_gib": peak, "launches_per_step": per_step}
            print(f"[remat] {label} {tag}: {secs:.4f} s/step, peak {peak:.2f} GiB, launches "
                  f"per step {per_step}", flush=True)
        check(row["remat"]["peak_gib"] < row["plain"]["peak_gib"],
              f"remat {label}: peak {row['remat']['peak_gib']:.2f} GiB, plain "
              f"{row['plain']['peak_gib']:.2f}")
        (l0, s0), (l1, s1) = finals[False], finals[True]
        for k, (a, b) in enumerate(zip(l0, l1)):
            for name in a:
                check(abs(a[name] - b[name]) <= 1e-4 * 10 ** k * abs(a[name]) + 1e-6,
                      f"remat {label} step {k} {name}: {b[name]} against {a[name]}")
        s0["config"].pop("remat")
        s1["config"].pop("remat")
        diff = _max_diff(s0, s1)
        row["bit_equal_deterministic"] = diff == 0.0
        row["max_state_diff"] = diff
        print(f"[remat] {label}: {REMAT_STEPS} steps with --remat against without, under "
              f"deterministic algorithms: {'bit-equal' if diff == 0.0 else f'max |diff| {diff:.3g}'}"
              f"; peak {row['plain']['peak_gib']:.2f} -> {row['remat']['peak_gib']:.2f} GiB, "
              f"{row['plain']['s_per_step']:.4f} -> {row['remat']['s_per_step']:.4f} s/step",
              flush=True)
        out[label] = row
    return out


def phase_single_pass(workdir: Path) -> dict:
    """A child process whose allocator is capped at SINGLE_PASS_LIMIT_GIB
    (torch.cuda.set_per_process_memory_fraction) so that the 128x256x256
    single pass cannot fit: it must raise RuntimeError with the advice, the
    process must go on (a 64^3 single pass), and the directory decode
    (--single_pass, run as its __main__) must skip that volume, write the
    other and exit 1."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch.checkpoint.io import save_reference_pth
    from mra_gan_tpu_torch.data import nifti
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn

    gen = make_generate_fn(CycleGANConfig(ngf=NGF, dtype=torch.bfloat16), "g_a", DEVICE, SEED)
    (workdir / "ck" / "run").mkdir(parents=True)
    save_reference_pth(gen.net, workdir / "ck" / "run" / "latest_net_G_A.pth")
    (workdir / "in").mkdir()
    rs = np.random.RandomState(SEED + 14)
    for name, shape in (("big.nii", VOLUME), ("small.nii", PATCH)):
        nifti.save(nifti.NiftiImage(data=(rs.rand(*shape) * 80).astype(np.float32),
                                    affine=np.eye(4)), workdir / "in" / name)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--single-pass-child", str(workdir)], capture_output=True,
                          text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"single-pass child exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(res["refused"] is not None and "sliding-window" in res["refused"]
          and str(VOLUME) in res["refused"], f"single pass refused with the advice: {res}")
    check(res["small_finite"], "the child's 64^3 single pass after the refusal")
    check(res["decode_exit"] == 1 and res["written"] == ["small.nii"]
          and "SKIPPED big.nii: RuntimeError" in res["decode_out"],
          f"directory decode skipped the big volume and exited 1: {res}")
    print(f"[single-pass] under a {SINGLE_PASS_LIMIT_GIB} GiB cap: {res['refused']}; the "
          f"process went on (64^3 single pass finite), the directory decode skipped "
          f"big.nii, wrote small.nii, exit {res['decode_exit']} ({secs:.1f} s)", flush=True)
    return {**res, "seconds": secs}


def single_pass_child(workdir: Path) -> int:
    """The child of phase_single_pass; prints one JSON line."""
    import io
    import runpy

    import numpy as np
    import torch

    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn
    from mra_gan_tpu_torch.parallel.spatial import single_pass_apply

    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(SINGLE_PASS_LIMIT_GIB * 2 ** 30 / total)
    gen = make_generate_fn(CycleGANConfig(ngf=NGF, dtype=torch.bfloat16), "g_a", DEVICE, SEED)
    vol = np.random.RandomState(SEED).rand(*VOLUME).astype(np.float32) * 2 - 1
    try:
        single_pass_apply(gen, vol)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    small = single_pass_apply(gen, vol[:PATCH[0], :PATCH[1], :PATCH[2]])
    sys.argv = ["mra_gan_tpu_torch.test", "--image", str(workdir / "in"), "--result",
                str(workdir / "out"), "--checkpoints_dir", str(workdir / "ck"), "--name", "run",
                "--single_pass", "--device", DEVICE, "--ngf", str(NGF), "--patch_size",
                *map(str, PATCH)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module("mra_gan_tpu_torch.test", run_name="__main__")
            code = 0
        except SystemExit as e:
            code = e.code
    written = sorted(p.name for p in (workdir / "out").iterdir())
    print(json.dumps({"refused": refused, "small_finite": bool(np.isfinite(small).all()),
                      "decode_exit": code, "written": written, "decode_out": buf.getvalue(),
                      "cap_gib": SINGLE_PASS_LIMIT_GIB}))
    return 0


# ---------------------------------------------------------------------------
# phase 14: data and spatial parallelism, ranks sharing the one card over gloo

PAR_LABEL = "ranks share one card over gloo"
PAR_STEPS = 3
PAR_TIMEOUT_S = 900
# label -> (kind, global batch, patch, (data, space)); the grid case runs on 4 ranks
PAR_CASES = {"dp b8 64^3": ("dp", 8, PATCH, (2, 1)),
             "sp b1 64^3": ("sp", 1, PATCH, (1, 2)),
             "sp b2 128^3": ("sp", 2, (128,) * 3, (1, 2))}
PAR_GRID = {"grid b2 64^3": ("sp", 2, PATCH, (2, 2))}
PAR_K4_SPATIAL = (1, PATCH)  # the K = 4 kernel shapes: a 4-way spatial step at batch 1, 64^3
PAR_VIEW_BATCH = 4  # the rank-view driver runs: one volume a rank a step at 2 samples a volume
PAR_OOM_CAP_GIB = 1.0  # repair A: the state fits, a trial step at 2 rows of 64^3 does not
PAR_OOM_TIMEOUT_S = 240
# The loss trajectories are held at the JAX package's bars
# (tests/test_parallel.py:130) in float32 with TF32 off and deterministic
# algorithms (``reproducible``), where the parallel and one-device steps
# differ by their sums' order only, the same in every run: Adam's first
# update, lr * g / |g|, turns run-to-run noise in a small gradient into a
# whole step, and without them the step-1 difference of the 2 x 2 grid read
# 1.3e-3 to 1.8e-3 over four runs, against the bar's 2e-3. The bf16 runs (the
# timed ones) round otherwise (cuDNN's algorithms at another local batch;
# the one-device 16^3 trunk's slab norm against the shards' stats -> apply),
# and Adam amplifies that (on an H100, five runs: up to 0.22% at step 0,
# 1.85% at step 1, 4.5% at step 2; PERF.md), so two bf16 runs cannot be held
# to each other past step 0. bf16 is held at 1e-2 at step 0 (2.5 bf16 ulps of
# relative error) against the one-device bf16 step, and at every step by the
# decode's rule: its losses no farther from the one-device float32
# trajectory than the one-device bf16 step's are, times PAR_BF16_WITNESS
# (the mean relative distance over the step's losses, plus PAR_BF16_FLOOR,
# a quarter of bf16's relative rounding, under which a distance is one
# cast's noise). On an H100, three runs of the four cases' three steps: the
# ratio read 0.50-1.83 where the parallel distance passed the floor (2.91
# once below it), and no step needed more than 1.29 with the floor; so 3.
PAR_RTOL = (1e-3, 2e-3, 2e-2)
# label -> float32 steps, one a bf16 step: the witness needs each
PAR_F32 = {"dp b8 64^3": 3, "sp b1 64^3": 3, "grid b2 64^3": 3, "sp b2 128^3": 3}
PAR_BF16_RTOL = (1e-2,)
PAR_BF16_WITNESS = 3.0
PAR_BF16_FLOOR = 1e-3
# A bf16 parallel decode is held to under 0.1% of voxels more than one bf16
# ulp off the bf16 one-device decode, and to be no farther from the float32
# one-device decode than the bf16 one-device decode is (mean |diff|, x1.25,
# phase 2's rule for the backward).
PAR_BF16_DECODE_SHARE = 1e-3
PAR_BF16_DECODE = 1.25


def par_shard_shapes(batch: int, spatial, shards: int) -> list:
    """(local (N, C, D/K, H, W), act) of every distinct generator norm of a
    spatial step's shard: the leaf applies at 2B and the chains at B."""
    local = (spatial[0] // shards,) + tuple(spatial[1:])
    out = []
    for n in (2 * batch, batch):
        for c, div, act in ((NGF, 1, "relu"), (2 * NGF, 2, "relu"),
                            (4 * NGF, 4, "relu"), (4 * NGF, 4, "none")):
            out.append(((n, c) + tuple(s // div for s in local), act))
    return list(dict.fromkeys(out))


def par_norm_kernels(K, group, rank: int, shards: int, cases) -> dict:
    """Each rank's side of the K-shard norm kernels at the local shapes
    ``cases``, bf16 and float32: its depth shard of a seeded volume (the
    same volume on every rank) through stats -> gather -> K-shard apply and
    bwd stats -> gather -> K-shard bwd apply, held against the plain
    versions on the same gathered partials (one rounding, as phase 2) and
    against the plain unsharded norm of the whole volume (phase 2's
    whole-norm bars); the K = 1 entry of the sharded apply bit-equal to
    phase 2's apply. Rank 0 then times, alone, the K-shard applies beside the
    K = 1 applies at the same local shape (bf16)."""
    import torch
    import torch.distributed as dist

    from mra_gan_tpu_torch.parallel.collectives import all_gather_stacked

    errs = {"apply": 0.0, "bwd_apply": 0.0, "whole": 0.0, "whole_bwd": 0.0}
    rows, timed = [], []
    for i, (local, act) in enumerate(cases):
        full = local[:2] + (local[2] * shards,) + local[3:]
        d = local[2]
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1000 + i)
            xf = _volume(gen, full, dtype)
            gf = _volume(gen, full, dtype, 1.0, 0.0)
            x = xf[:, :, rank * d:(rank + 1) * d].contiguous(memory_format=torch.channels_last_3d)
            g = gf[:, :, rank * d:(rank + 1) * d].contiguous(memory_format=torch.channels_last_3d)
            seg = K.forward_segments(x, shards)
            buf = torch.empty((2, local[0], seg, local[1]), device=DEVICE)
            K.instance_norm_stats(x, seg, out=buf)
            parts = all_gather_stacked(buf, group)
            y, m, r = K.instance_norm_apply_sharded(x, parts, act, 0.2)
            fm, fr = K.finalize_plain(parts[:, 0], parts[:, 1], math.prod(local[2:]))
            ya = K.apply_plain(x, fm, fr, act, 0.2)
            e = float((y.float() - ya.float()).abs().max())
            check((bf16_ulps(y, ya) <= 1.0 if bf16 else e <= 1e-5)
                  and torch.allclose(m, fm, rtol=1e-5, atol=1e-6)
                  and torch.allclose(r, fr, rtol=1e-5, atol=1e-6),
                  f"K={shards} apply {local} {dtype} {act}: {e}")
            errs["apply"] = max(errs["apply"], e)
            yp, mp, rp = K.instance_norm_act_plain_fwd(xf, act, 0.2)
            ypl = yp[:, :, rank * d:(rank + 1) * d]
            e = float((y.float() - ypl.float()).abs().max())
            # phase 2's whole-norm bars; in bf16 the plain norm centres in bf16, so
            # its variance, and rstd, are not the kernels' float32 ones
            check(bf16_ulps(y, ypl) <= 2.0 if bf16 else (
                e <= 1e-5 and torch.allclose(m, mp, rtol=1e-5, atol=1e-6)
                and torch.allclose(r, rp, rtol=1e-5, atol=1e-6)),
                  f"K={shards} sharded norm {local} {dtype} {act} against the whole volume: {e}")
            if not bf16:
                errs["whole"] = max(errs["whole"], e)
            if i == 0:  # the K = 1 entry of the sharded apply is phase 2's apply
                own = torch.stack(K.instance_norm_stats(x, seg))
                y1 = K.instance_norm_apply(x, own[0].contiguous(), own[1].contiguous(), act)[0]
                check(torch.equal(y1, K.instance_norm_apply_sharded(x, own[None], act)[0]),
                      f"K=1 sharded apply bit-equal to the apply {local} {dtype}")
            # backward
            bseg = K.backward_segments(x, g, shards)
            bbuf = torch.empty((2, local[0], bseg, local[1]), device=DEVICE)
            K.instance_norm_bwd_stats(x, g, m, r, bseg, act, 0.2, out=bbuf)
            bparts = all_gather_stacked(bbuf, group)
            dx = K.instance_norm_bwd_apply_sharded(x, g, m, r, bparts, act, 0.2)
            gm, gzm = K.bwd_finalize_plain(bparts[:, 0], bparts[:, 1], math.prod(local[2:]))
            dref = K.bwd_apply_plain(x, g, m, r, gm, gzm, act, 0.2)
            dmax = float(dref.float().abs().max())
            e = float((dx.float() - dref.float()).abs().max())
            check(e <= (BF16_ULP if bf16 else 1e-5) * dmax,
                  f"K={shards} bwd apply {local} {dtype} {act}: {e:.3g} of {dmax:.3g}")
            errs["bwd_apply"] = max(errs["bwd_apply"], e)
            # the whole volume's plain backward at the sharded forward's statistics
            # (the whole volume's, the same on every rank), so that a relu mask
            # at z ~ 0 is the same on both sides, as phase 2 holds them
            dfull = K.instance_norm_act_bwd_plain(xf, gf, m, r, act, 0.2)
            dpl = dfull[:, :, rank * d:(rank + 1) * d].float()
            d32 = K.instance_norm_act_bwd_plain(xf.float(), gf.float(), m, r, act, 0.2)[
                :, :, rank * d:(rank + 1) * d]
            dmax = float(d32.abs().max())
            diff = (dx.float() - dpl).abs() / dmax
            if bf16:  # phase 2's bar: mean within 1 ulp, no farther from f32 than plain
                ok = (float(diff.mean()) <= BF16_ULP and float((dx.float() - d32).abs().mean())
                      <= 1.25 * float((dpl - d32).abs().mean()))
            else:
                ok = float(diff.max()) <= 1e-5
            check(ok, f"K={shards} sharded bwd {local} {dtype} {act} against the whole volume: "
                      f"{float(diff.max()):.3g} of max|dx|")
            if not bf16:
                errs["whole_bwd"] = max(errs["whole_bwd"], float(diff.max()) * dmax)
            if bf16:
                # the K-shard applies also at the one-volume count of the local
                # shape (the rule before the whole volume's count divided by K),
                # so that both rules are timed in one run
                seg1, bseg1 = K.forward_segments(x), K.backward_segments(x, g)
                own = torch.stack(K.instance_norm_stats(x, seg1))
                bown = torch.stack(K.instance_norm_bwd_stats(x, g, m, r, bseg1, act, 0.2))
                parts1 = all_gather_stacked(own.contiguous(), group)
                bparts1 = all_gather_stacked(bown.contiguous(), group)
            dist.barrier(group)
            if bf16 and rank == 0:
                es = x.element_size()
                part = parts.numel() * 4
                row = {"shape": list(local), "shards": shards, "act": act, "segments": seg,
                       "bwd_segments": bseg, "k1_segments": seg1, "k1_bwd_segments": bseg1,
                       "apply_ms": device_ms(lambda: K.instance_norm_apply_sharded(
                           x, parts, act, 0.2), 30),
                       "apply_local_s_ms": device_ms(lambda: K.instance_norm_apply_sharded(
                           x, parts1, act, 0.2), 30),
                       "apply_k1_ms": device_ms(lambda: K.instance_norm_apply_sharded(
                           x, own[None], act, 0.2), 30),
                       "bwd_apply_ms": device_ms(lambda: K.instance_norm_bwd_apply_sharded(
                           x, g, m, r, bparts, act, 0.2), 30),
                       "bwd_apply_local_s_ms": device_ms(
                           lambda: K.instance_norm_bwd_apply_sharded(x, g, m, r, bparts1, act,
                                                                     0.2), 30),
                       "bwd_apply_k1_ms": device_ms(lambda: K.instance_norm_bwd_apply_sharded(
                           x, g, m, r, bown[None], act, 0.2), 30),
                       "apply_plain_ms": device_ms(lambda: K.apply_plain(
                           x, *K.finalize_plain(parts[:, 0], parts[:, 1], math.prod(local[2:])),
                           act, 0.2), 10),
                       "bwd_apply_plain_ms": device_ms(lambda: K.bwd_apply_plain(
                           x, g, m, r, *K.bwd_finalize_plain(bparts[:, 0], bparts[:, 1],
                                                             math.prod(local[2:])), act, 0.2), 10)}
                bw, flops, _ = peak_rates(torch.cuda.get_device_name(0))
                stat = 2 * local[0] * local[1] * 4
                row["apply_bound_ms"] = 1e3 * max(
                    (2 * x.numel() * es + part + stat) / bw,
                    (APPLY_OPS[act] * x.numel() + MERGE_OPS * parts[:, 0].numel()) / flops)
                row["bwd_apply_bound_ms"] = 1e3 * max(
                    (3 * x.numel() * es + bparts.numel() * 4 + stat) / bw,
                    ((BWD_APPLY_OPS + ACT_GRAD_OPS[act]) * x.numel() + 2 * bparts[:, 0].numel())
                    / flops)
                timed.append(row)
            dist.barrier(group)
            rows.append((local, str(dtype), act))
    return {"errors": errs, "checked": len(rows), "timed": timed}


def _par_hash(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for name, net in state.nets.items():
        for key, v in net.state_dict().items():
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def par_global_batch(batch: int, patch, seed: int, steps: int = PAR_STEPS):
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    return [tuple(torch.from_numpy(rs.uniform(-1, 1, (batch, 1) + tuple(patch))
                                   .astype(np.float32)) for _ in range(2))
            for _ in range(steps)]


def par_step_case(K, label: str, case, dtype, steps: int = PAR_STEPS) -> dict:
    """One rank's side of a parallel step case in ``dtype``: ``steps`` steps
    from the seeded state on this rank's part of the seeded global batches,
    with the launch counters zeroed just before them: metrics, launches,
    s/step, this rank's peak memory and a hash of its parameters."""
    import torch

    from mra_gan_tpu_torch.core.mesh import DATA_AXIS, SPACE_AXIS, make_mesh
    from mra_gan_tpu_torch.models.cycle_gan import create_state
    from mra_gan_tpu_torch.parallel.sharding import make_sharded_train_step, shard_state
    from mra_gan_tpu_torch.parallel.spatial import make_spatial_train_step, shard_spatial_state

    kind, batch, patch, (data, space) = case
    cfg = train_config(dtype)
    mesh = make_mesh(data, space)
    state = create_state(cfg, SEED, patch, DEVICE)
    if kind == "dp":
        state = shard_state(state, mesh)
        step, take = make_sharded_train_step(cfg, mesh)
    else:
        state = shard_spatial_state(state, mesh)
        step, take = make_spatial_train_step(cfg, mesh, SPACE_AXIS,
                                             DATA_AXIS if data > 1 else None)
    inputs = [(take(a).to(DEVICE), take(b).to(DEVICE))
              for a, b in par_global_batch(batch, patch, SEED + 14, steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    metrics, secs = [], []
    for a, b in inputs:
        t0 = time.perf_counter()
        _, m = step(state, a, b, TRAIN_LR)
        metrics.append({k: float(v) for k, v in m.items()})  # read back: the step has ended
        secs.append(time.perf_counter() - t0)
    launches = {**K.LAUNCHES, **{f"sharded {k}": v for k, v in K.SHARDED_LAUNCHES.items()}}
    out = {"metrics": metrics, "step_s": secs, "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "hash": _par_hash(state),
           "local_batch": int(inputs[0][0].shape[0]), "local_patch": list(inputs[0][0].shape[2:])}
    del state, step, inputs
    torch.cuda.empty_cache()
    return out


def _row_hashes(x) -> list:
    import hashlib

    host = x.detach().float().cpu().contiguous().numpy()
    return [hashlib.sha256(row.tobytes()).hexdigest() for row in host]


def driver_run(K, argv, record: bool = False, global_view: bool = False) -> dict:
    """One in-process run of the training driver with the launch counters
    zeroed before it: wall seconds, epoch records, launches, the final
    parameters' hash and step; its loader's host seconds (sample_patches,
    summed over the loader's threads) and volumes sampled; the augmentation's
    device ms per step (CUDA events, read after the run). With ``record``,
    each step's input rows' hashes and its losses (not the memory
    preflight's trial steps); with ``global_view``, the driver's ``rank_rows``
    patched to None: every rank loads and augments the global batch and
    takes its part, as before the rank view."""
    import threading

    import torch

    from mra_gan_tpu_torch import train as driver
    from mra_gan_tpu_torch.data.dataset import UnpairedVolumeDataset

    lock = threading.Lock()
    probe = {"loader_s": 0.0, "volumes": 0}
    events, inputs, metrics, trial = [], [], [], []
    saved = {"sample_patches": UnpairedVolumeDataset.sample_patches,
             "augment_batch": driver.augment_batch, "rank_rows": driver.rank_rows,
             "make_train_step": driver.make_train_step,
             "make_sharded_train_step": driver.make_sharded_train_step,
             "preflight": driver.preflight}

    def preflight(*args, **kw):
        trial.append(True)
        try:
            return saved["preflight"](*args, **kw)
        finally:
            trial.pop()

    def sample_patches(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return saved["sample_patches"](self, *args, **kw)
        finally:
            with lock:
                probe["loader_s"] += time.perf_counter() - t0
                probe["volumes"] += 1

    def augment_batch(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        got = saved["augment_batch"](*args, **kw)
        ev[1].record()
        events.append(ev)
        return got

    def recording(factory):
        def make(*args, **kw):
            made = factory(*args, **kw)
            step = made[0] if isinstance(made, tuple) else made

            def step_and_record(state, real_a, real_b, lr, pool_draws=None):
                if trial:
                    return step(state, real_a, real_b, lr, pool_draws)
                inputs.append((_row_hashes(real_a), _row_hashes(real_b)))
                state, m = step(state, real_a, real_b, lr, pool_draws)
                metrics.append({k: float(v) for k, v in m.items()})
                return state, m

            return (step_and_record, *made[1:]) if isinstance(made, tuple) else step_and_record

        return make

    UnpairedVolumeDataset.sample_patches = sample_patches
    driver.augment_batch = augment_batch
    driver.preflight = preflight
    if global_view:
        driver.rank_rows = lambda opt, mesh: None
    if record:
        driver.make_train_step = recording(saved["make_train_step"])
        driver.make_sharded_train_step = recording(saved["make_sharded_train_step"])
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        res = driver.main(list(argv))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        UnpairedVolumeDataset.sample_patches = saved.pop("sample_patches")
        for name, f in saved.items():
            setattr(driver, name, f)
    return {"s": secs, "epochs": res["epochs"], "launches": dict(K.LAUNCHES),
            "hash": _par_hash(res["state"]), "step": res["state"].step, **probe,
            "aug_ms": [a.elapsed_time(b) for a, b in events], "inputs": inputs,
            "metrics": metrics}


def oom_rank_run(rank: int, spec: dict) -> dict:
    """Repair A of the memory preflight on this rank: ``spec['oom_rank']``
    capped to ``spec['cap_gib']`` of the card
    (torch.cuda.set_per_process_memory_fraction), so that its trial step
    runs out of memory while its peers wait in the step's collectives; the
    driver's SystemExit text, and the wall clock at the preflight's start
    and at the exit."""
    import torch

    from mra_gan_tpu_torch import train as driver

    if rank == spec["oom_rank"]:
        total = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
        torch.cuda.set_per_process_memory_fraction(spec["cap_gib"] * 2 ** 30 / total)
    real, start = driver.preflight, []

    def preflight(*args, **kw):
        start.append(time.time())
        return real(*args, **kw)

    driver.preflight = preflight
    try:
        driver.main(list(spec["argv"]))
        message = None
    except SystemExit as e:
        message = str(e)
    finally:
        driver.preflight = real
    return {"exit": message, "start": start[0] if start else None, "end": time.time()}


def parallel_rank(rank: int, world: int, store: str, plan: dict) -> None:
    """The body of one rank of phase 14: join the gloo group on the card,
    run the plan's parts in order (the same on every rank), write what it
    measured to the plan's directory."""
    import pickle

    import torch
    import torch.distributed as dist

    from mra_gan_tpu_torch.core.mesh import init_distributed, make_mesh
    from mra_gan_tpu_torch.ops.kernels import instance_norm as K
    from mra_gan_tpu_torch.parallel import collectives

    init_distributed(DEVICE, "gloo", store, rank, world, timeout_s=PAR_TIMEOUT_S)
    out = {}
    try:
        world_group = make_mesh().group("data")
        if plan.get("norm_cases"):
            out["kernels"] = par_norm_kernels(K, world_group, rank, world, plan["norm_cases"])
        for tag, argv in plan.get("decodes", {}).items():
            from mra_gan_tpu_torch import test as cli

            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            failed = cli.main(argv)
            torch.cuda.synchronize()
            out[tag] = {"failed": failed, "s": time.perf_counter() - t0,
                        "launches": {**K.LAUNCHES, **{f"sharded {k}": v for k, v
                                                      in K.SHARDED_LAUNCHES.items()}}}
        for label, case in plan.get("steps", {}).items():
            out[label] = par_step_case(K, label, case, torch.bfloat16)
        for label, case in plan.get("steps_f32", {}).items():
            with reproducible(True):
                out[f"{label} f32"] = par_step_case(K, label, case, torch.float32,
                                                    PAR_F32[label])
        for run in plan.get("drivers", ()):
            with reproducible(True) if run.get("deterministic") else contextlib.nullcontext():
                out[f"driver {run['tag']}"] = driver_run(K, run["argv"], run.get("record", False),
                                                         run.get("global_view", False))
        if plan.get("oom"):
            out["oom"] = oom_rank_run(rank, plan["oom"])
        out["host_staged"] = dict(collectives.HOST_STAGED)
        with open(Path(plan["dir"]) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, plan: dict, workdir: Path, timeout_s: float = PAR_TIMEOUT_S) -> list:
    """Spawn ``world`` ranks of ``parallel_rank`` on the card, with a new
    store in ``workdir``, and return what each wrote there; a rank that
    fails or a run past ``timeout_s`` fails the phase, and every rank is
    ended."""
    import pickle

    import torch.multiprocessing as mp

    workdir.mkdir(parents=True, exist_ok=True)
    plan = {**plan, "dir": str(workdir)}
    ctx = mp.start_processes(parallel_rank, args=(world, str(workdir / f"store{world}"), plan),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
            check(time.perf_counter() < deadline, f"{world} ranks within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def par_one_device(K, case, dtype, steps: int = PAR_STEPS) -> dict:
    """The one-device step on the same seeded state and global batches."""
    import torch

    from mra_gan_tpu_torch.models.cycle_gan import create_state, make_train_step

    _, batch, patch, _ = case
    cfg = train_config(dtype)
    state = create_state(cfg, SEED, patch, DEVICE)
    step = make_train_step(cfg)
    metrics = [{k: float(v) for k, v in step(state, a.to(DEVICE), b.to(DEVICE), TRAIN_LR)[1]
                .items()} for a, b in par_global_batch(batch, patch, SEED + 14, steps)]
    del state, step
    torch.cuda.empty_cache()
    return {"metrics": metrics}


def par_step_launches(K, kind: str, local_batch: int, local_patch, patch) -> dict:
    """A rank's launches per step: the data-parallel step keeps phase 7's
    routes at its local batch; the spatial step runs its 68 generator norms
    as stats + K-shard apply and bwd stats + K-shard bwd apply, and its 12
    discriminator norms on gathered volumes on their own routes."""
    import torch

    dtype = torch.bfloat16
    if kind == "dp":
        return {**forward_launches(K, 4 * generator_norms(local_batch, patch)
                                   + 4 * patchgan_norms_at(local_batch, patch), dtype),
                **backward_launches(K, 4 * generator_norms(local_batch, patch)
                                    + 4 * patchgan_norms_at(local_batch, patch), dtype),
                "sharded instance_norm_apply": 0, "sharded instance_norm_bwd_apply": 0}
    gen = 4 * 17
    fd = forward_launches(K, 4 * patchgan_norms_at(local_batch, patch), dtype)
    bd = backward_launches(K, 4 * patchgan_norms_at(local_batch, patch), dtype)
    return {"instance_norm_slab": fd["instance_norm_slab"],
            "instance_norm_stats": gen + fd["instance_norm_stats"],
            "instance_norm_apply": gen + fd["instance_norm_apply"],
            "instance_norm_bwd_slab": bd["instance_norm_bwd_slab"],
            "instance_norm_bwd_stats": gen + bd["instance_norm_bwd_stats"],
            "instance_norm_bwd_apply": gen + bd["instance_norm_bwd_apply"],
            "sharded instance_norm_apply": gen, "sharded instance_norm_bwd_apply": gen}


def _rel_distance(metrics: dict, ref: dict) -> float:
    """The mean relative distance of a step's losses from ``ref``'s."""
    return sum(abs(metrics[n] - w) / abs(w) for n, w in ref.items()) / len(ref)


def _tanh_units(v):
    import numpy as np

    return np.asarray(v, np.float64) / 127.5 - 1.0


def phase_parallel(K, tree, results: dict, decode: dict, phase13: dict, driver_dir: Path,
                   workdir: Path) -> dict:
    """Phase 14: the parallel paths at full width on ranks that share this
    one card over gloo (NCCL does not let two ranks share a card), so every
    collective of a CUDA tensor is staged through the host; the times show
    that the paths run, not how they scale."""
    import numpy as np
    import torch

    from mra_gan_tpu_torch import test as cli
    from mra_gan_tpu_torch.checkpoint import CheckpointManager
    from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
    from mra_gan_tpu_torch.data import nifti
    from mra_gan_tpu_torch.models.cycle_gan import create_state

    t_start = time.perf_counter()
    fails = []

    def expect(cond: bool, what: str) -> None:
        # every comparison is printed before the phase fails on any of them
        if not cond:
            fails.append(what)
            print(f"[parallel] FAILED: {what}", flush=True)

    # the decode CLI's inputs: phase 4's generator, one seeded VOLUME
    ck = workdir / "ck" / "smoke"
    ck.mkdir(parents=True)
    torch.save(state_dict_from_jax(tree, "resnet_6blocks"), ck / "latest_net_G_A.pth")
    vol = (np.random.RandomState(SEED + 14).rand(*VOLUME) * 300).astype(np.float32)
    nifti.save(nifti.NiftiImage(data=vol, affine=np.diag([0.8, 0.8, 1.5, 1.0])),
               workdir / "in.nii")

    def argv(out, *extra):
        return ["--image", str(workdir / "in.nii"), "--result", str(workdir / out),
                "--checkpoints_dir", str(workdir / "ck"), "--name", "smoke",
                "--ngf", str(NGF), "--patch_size", *map(str, PATCH), "--stride_inplane",
                str(STRIDE), "--stride_layer", str(STRIDE), "--decode_batch",
                str(DECODE_BATCH), "--device", DEVICE, *extra]

    decodes = {}
    for prec in ("bfloat16", "float32"):
        decodes[f"shard {prec}"] = argv(f"shard_{prec}.nii", "--spatial_shard",
                                        "--precision", prec)
        decodes[f"dp {prec}"] = argv(f"dp_{prec}.nii", "--data_parallel", "--precision", prec)
    # the one-device references: phase 5's single pass and sliding window, through the CLI
    ref_s = {}
    for prec in ("bfloat16", "float32"):
        for tag, extra in (("single", ["--single_pass"]), ("window", [])):
            t0 = time.perf_counter()
            check(cli.main(argv(f"{tag}_{prec}.nii", "--precision", prec, *extra)) == [],
                  f"one-device {tag} decode")
            ref_s[f"{tag} {prec}"] = time.perf_counter() - t0
    cases = {**PAR_CASES, **PAR_GRID}
    one = {label: par_one_device(K, case, torch.bfloat16) for label, case in cases.items()}
    with reproducible(True):
        one.update({f"{label} f32": par_one_device(K, cases[label], torch.float32, steps)
                    for label, steps in PAR_F32.items()})
    common = ["--data_path", str(driver_dir / "data"), "--ngf", str(NGF), "--ndf", str(NDF),
              "--patch_size", *map(str, PATCH), "--no_lsgan", "--device", DEVICE,
              "--seed", str(SEED), "--niter", "1", "--niter_decay", "0", "--augment",
              "--checkpoints_dir", str(workdir / "ck")]
    driver_argv = [*common, "--batch_size", "8", "--num_samples", str(DRIVER_SAMPLES),
                   "--workers", "2", "--print_freq", "8", "--name", "dp_driver",
                   "--cache_dir", str(driver_dir / "ck" / "b1" / "cache"), "--data_parallel"]
    # the rank view against the global view and the one-device driver, under
    # deterministic algorithms, each on a new cache: one volume a rank a step
    views = {tag: [*common, "--batch_size", str(PAR_VIEW_BATCH), "--num_samples",
                   str(VIEW_SAMPLES), "--workers", "1", "--print_freq", str(PAR_VIEW_BATCH),
                   "--name", tag, "--cache_dir", str(workdir / f"cache_{tag}"),
                   *(["--data_parallel"] if tag != "one_view" else [])]
             for tag in ("dp_rank", "dp_global", "one_view")}
    with reproducible(True):
        one_view = driver_run(K, views["one_view"], record=True)
    oom_argv = [*common, "--batch_size", "8", "--num_samples", str(DRIVER_SAMPLES),
                "--workers", "1", "--name", "oom", "--cache_dir",
                str(driver_dir / "ck" / "b1" / "cache"), "--data_parallel"]
    norm_k2 = list(dict.fromkeys(c for _, b, p, (_, sp) in PAR_CASES.values() if sp == 2
                                 for c in par_shard_shapes(b, p, 2)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    two = run_ranks(2, {"norm_cases": norm_k2, "decodes": decodes, "steps": PAR_CASES,
                        "steps_f32": {k: v for k, v in PAR_CASES.items() if k in PAR_F32},
                        "drivers": [{"tag": "dp_driver", "argv": driver_argv},
                                    {"tag": "dp_rank", "argv": views["dp_rank"], "record": True,
                                     "deterministic": True},
                                    {"tag": "dp_global", "argv": views["dp_global"],
                                     "record": True, "deterministic": True,
                                     "global_view": True}]}, workdir)
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = run_ranks(4, {"norm_cases": par_shard_shapes(*PAR_K4_SPATIAL, 4),
                         "steps": PAR_GRID,
                         "steps_f32": {k: v for k, v in PAR_GRID.items() if k in PAR_F32}},
                     workdir)
    four_s = time.perf_counter() - t0
    # repair A: rank 1 of 4 runs out of memory inside its trial step
    t0 = time.perf_counter()
    oom = [r["oom"] for r in run_ranks(
        4, {"oom": {"argv": oom_argv, "oom_rank": 1, "cap_gib": PAR_OOM_CAP_GIB}},
        workdir / "oom", timeout_s=PAR_OOM_TIMEOUT_S)]
    oom_s = time.perf_counter() - t0

    out = {"label": PAR_LABEL,
           "spawn_s": {"2 ranks": two_s, "4 ranks": four_s, "4 ranks, repair A": oom_s}}
    # the K-shard norm kernels
    for world, ranks in ((2, two), (4, four)):
        errs = {k: max(r["kernels"]["errors"][k] for r in ranks) for k in ranks[0]["kernels"]["errors"]}
        timed = ranks[0]["kernels"]["timed"]
        out[f"kernels K={world}"] = {"errors": errs, "timed": timed,
                                     "checked": ranks[0]["kernels"]["checked"]}
        print(f"[parallel] K={world} norm kernels: {ranks[0]['kernels']['checked']} shape x "
              f"dtype cases, max error apply {errs['apply']:.3g} bwd apply "
              f"{errs['bwd_apply']:.3g}; float32 against the whole volume {errs['whole']:.3g} / "
              f"{errs['whole_bwd']:.3g}", flush=True)
        for row in timed:
            print(f"[parallel]   {row['shape']} {row['act']}: apply K={world} S={row['segments']} "
                  f"{row['apply_ms']:.4f} ms (at S={row['k1_segments']} "
                  f"{row['apply_local_s_ms']:.4f}; K=1 at S={row['k1_segments']} "
                  f"{row['apply_k1_ms']:.4f}, plain {row['apply_plain_ms']:.4f}, bound "
                  f"{row['apply_bound_ms']:.4f}); bwd apply K={world} S={row['bwd_segments']} "
                  f"{row['bwd_apply_ms']:.4f} ms (at S={row['k1_bwd_segments']} "
                  f"{row['bwd_apply_local_s_ms']:.4f}; K=1 at S={row['k1_bwd_segments']} "
                  f"{row['bwd_apply_k1_ms']:.4f}, plain {row['bwd_apply_plain_ms']:.4f}, bound "
                  f"{row['bwd_apply_bound_ms']:.4f})", flush=True)
        for name, key in (("instance_norm_apply", "apply"), ("instance_norm_bwd_apply",
                                                                "bwd_apply")):
            results[name].setdefault("sharded", []).extend(
                {"shards": world, "shape": row["shape"], "act": row["act"],
                 "ms": row[f"{key}_ms"], "local_s_ms": row[f"{key}_local_s_ms"],
                 "k1_ms": row[f"{key}_k1_ms"],
                 "plain_ms": row[f"{key}_plain_ms"], "bound_ms": row[f"{key}_bound_ms"],
                 "library_ms": None} for row in timed)
            results[name]["max_abs_err_sharded"] = max(
                results[name].get("max_abs_err_sharded", 0.0), errs[key])

    # the decodes through the CLI
    per_forward = forward_launches(K, generator_norms(DECODE_BATCH, PATCH), torch.bfloat16)
    n_batches = EXPECTED_GRID[1]
    for prec in ("bfloat16", "float32"):
        shard = [r[f"shard {prec}"] for r in two]
        dp = [r[f"dp {prec}"] for r in two]
        expect(all(r["failed"] == [] for r in shard + dp), f"parallel decodes {prec} ran")
        for r in shard:
            l = r["launches"]
            expect(l["instance_norm_stats"] == 17 and l["instance_norm_apply"] == 17
                  and l["sharded instance_norm_apply"] == 17 and l["instance_norm_slab"] == 0
                  and not any(l[k] for k in K.BACKWARD),
                  f"--spatial_shard {prec}: 17 stats + 17 sharded apply per rank: {l}")
        total = {k: sum(r["launches"][k] for r in dp) for k in K.FORWARD + K.BACKWARD}
        expect(total == {**{k: 0 for k in K.BACKWARD}, **times(per_forward, n_batches)},
              f"--data_parallel {prec}: phase 5's launches split over the ranks: {total}")
        for tag, ref_tag in (("shard", "single"), ("dp", "window")):
            got = _tanh_units(nifti.load(workdir / f"{tag}_{prec}.nii").data)
            ref = _tanh_units(nifti.load(workdir / f"{ref_tag}_{prec}.nii").data)
            expect(got.shape == ref.shape and bool(np.isfinite(got).all()),
                  f"{tag} {prec} decode shape, finite")
            diff = np.abs(got - ref)
            row = {"s": max(r["s"] for r in (shard if tag == "shard" else dp)),
                   "one_device_s": ref_s[f"{ref_tag} {prec}"], "max_abs": float(diff.max())}
            if prec == "float32":
                ok = bool((diff <= 1e-4 + 1e-3 * np.abs(ref)).all())
                what = f"max |diff| {diff.max():.3g} (generator bar rtol 1e-3 atol 1e-4)"
            else:
                # one bf16 ulp of a unit-range output, as bf16_ulps counts them:
                # the ulp at max(|ref|, 1) = 2^-7; beside it, against the ulp at
                # each voxel's own value (floored at 2^-7)
                share = float((diff > 2.0 ** -7).mean())
                own = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -7))) - 7)
                f32 = _tanh_units(nifti.load(workdir / f"{ref_tag}_float32.nii").data)
                err, err_one = float(np.abs(got - f32).mean()), float(np.abs(ref - f32).mean())
                row.update(share_over_1ulp=share, share_over_own_ulp=float((diff > own).mean()),
                           mean_abs=float(diff.mean()), mean_err_f32=err,
                           one_device_mean_err_f32=err_one)
                ok = share < PAR_BF16_DECODE_SHARE and err <= PAR_BF16_DECODE * err_one + 1e-6
                what = (f"{share:.4%} of voxels more than one bf16 ulp (2^-7) off the bf16 "
                        f"one-device decode, {row['share_over_own_ulp']:.2%} more than their "
                        f"own value's ulp (max {diff.max():.3g}, mean {diff.mean():.3g}); mean "
                        f"|error| against the float32 one-device decode {err:.3g}, the bf16 "
                        f"one-device decode's {err_one:.3g}")
            row["ok"], row["what"] = ok, what
            out[f"decode {tag} {prec}"] = row
            print(f"[parallel] decode --{'spatial_shard' if tag == 'shard' else 'data_parallel'} "
                  f"{prec}, 2 {PAR_LABEL}: {row['s']:.2f} s/volume (one device "
                  f"{row['one_device_s']:.2f} s); {what}", flush=True)
    for key, row in out.items():
        if key.startswith("decode "):
            expect(row.pop("ok"), f"{key} against the one-device decode: {row['what']}")

    # the steps
    plain_128 = phase13["remat"]["b2 128^3"]["plain"]["peak_gib"]
    for ranks, cases in ((two, PAR_CASES), (four, PAR_GRID)):
        for label, case in cases.items():
            rows = [r[label] for r in ranks]
            expect(len({r["hash"] for r in rows}) == 1,
                   f"{label}: parameters bit-equal across the {len(rows)} ranks")
            worst = {}
            for tag, bars in (("", PAR_BF16_RTOL), (" f32", PAR_RTOL)):
                if f"{label}{tag}" not in one:
                    continue
                want = one[f"{label}{tag}"]["metrics"]
                runs = [r[f"{label}{tag}"] for r in ranks]
                expect(len({r["hash"] for r in runs}) == 1,
                       f"{label}{tag}: parameters bit-equal across the ranks")
                rel = [max(abs(r["metrics"][k][n] - w) / abs(w) for r in runs
                           for n, w in want[k].items()) for k in range(len(want))]
                worst[tag.strip() or "bf16"] = rel
                for k, bar in enumerate(bars[:len(want)]):
                    for name, w in want[k].items():
                        for r in runs:
                            v = r["metrics"][k][name]
                            expect(abs(v - w) <= bar * abs(w) + 1e-4,
                                   f"{label}{tag} step {k} {name}: {v} against one device {w}")
            # the witness: bf16 against the float32 trajectory, beside the one-device bf16
            ref32, one16 = one[f"{label} f32"]["metrics"], one[label]["metrics"]
            witness = []
            for k in range(len(ref32)):
                d_one = _rel_distance(one16[k], ref32[k])
                d_par = max(_rel_distance(r["metrics"][k], ref32[k]) for r in rows)
                witness.append({"parallel": d_par, "one_device": d_one,
                                "ratio": d_par / d_one if d_one else math.inf})
                expect(d_par <= PAR_BF16_WITNESS * d_one + PAR_BF16_FLOOR,
                       f"{label} bf16 step {k}: mean relative distance from the float32 "
                       f"trajectory {d_par:.3g}, the one-device bf16 step's {d_one:.3g} "
                       f"(x{PAR_BF16_WITNESS} + {PAR_BF16_FLOOR})")
            per_step = par_step_launches(K, case[0], rows[0]["local_batch"],
                                         rows[0]["local_patch"], case[2])
            for r in rows:
                expect(r["launches"] == times(per_step, PAR_STEPS),
                      f"{label}: launches {r['launches']}, want {PAR_STEPS} x {per_step}")
            s_step = sum(max(r["step_s"][k] for r in rows) for k in range(1, PAR_STEPS)) / (
                PAR_STEPS - 1)
            peaks = [r["peak_gib"] for r in rows]
            out[label] = {"s_per_step": s_step, "peak_gib": peaks, "launches_per_step": per_step,
                          "losses": rows[0]["metrics"][-1], "ranks": len(rows),
                          "max_rel_loss_diff_per_step": worst, "bf16_witness": witness}
            beside = f" (one device, phase 13: {plain_128:.2f} GiB)" if "128" in label else ""
            print(f"[parallel] step {label}, {len(rows)} {PAR_LABEL}: {s_step:.4f} s/step "
                  f"(steps 2-{PAR_STEPS}); per-rank peak {[round(p, 2) for p in peaks]} GiB"
                  f"{beside}; launches per rank and step {per_step}; largest relative loss "
                  f"difference from one device per step {worst}; bf16 from the float32 "
                  f"trajectory per step (parallel, one device, ratio) "
                  f"{[tuple(round(w[x], 5) for x in w) for w in witness]}; parameters "
                  f"bit-equal", flush=True)
            if label == "sp b1 64^3":  # the measured run's count, equal to the expected one
                for name in ("instance_norm_apply", "instance_norm_bwd_apply"):
                    results[name]["launches_sharded"] = rows[0]["launches"][f"sharded {name}"]

    # the driver: rank 0 wrote the checkpoint; it restores into a one-device state
    drv = [r["driver dp_driver"] for r in two]
    expect(len({d["hash"] for d in drv}) == 1 and all(d["step"] == drv[0]["step"] for d in drv),
          "driver --data_parallel: ranks end bit-equal")
    state = CheckpointManager(workdir / "ck", "dp_driver").restore(
        "latest", create_state(train_config(torch.bfloat16), SEED + 1, PATCH, DEVICE))
    expect(_par_hash(state) == drv[0]["hash"],
          "driver --data_parallel: the checkpoint restores into a one-device state bit-equal")
    n_lines = _loss_lines_finite(workdir / "ck" / "dp_driver" / "loss_log.txt")
    steps = sum(e["steps"] for e in drv[0]["epochs"])
    from mra_gan_tpu_torch.core.memory import TRIAL_STEPS

    want = times(par_step_launches(K, "dp", 4, PATCH, PATCH), steps + TRIAL_STEPS)
    for d in drv:  # the preflight's two trial steps, then the epoch, on every rank
        expect({k: d["launches"][k] for k in K.FORWARD + K.BACKWARD}
              == {k: want[k] for k in K.FORWARD + K.BACKWARD},
              f"driver --data_parallel launches {d['launches']}, want {want}")
    expect(n_lines == steps and steps == DRIVER_PAIRS * DRIVER_SAMPLES // 8,
          f"driver --data_parallel: {n_lines} loss lines for {steps} steps")
    rates = _epoch_rates(drv[0]["epochs"], 8)
    out["driver"] = {"s": max(d["s"] for d in drv), "steps": steps, "epochs": rates,
                     "loader_s": [d["loader_s"] for d in drv],
                     "volumes": [d["volumes"] for d in drv],
                     "aug_ms_per_step": [sum(d["aug_ms"]) / len(d["aug_ms"]) for d in drv]}
    print(f"[parallel] driver --data_parallel --augment, batch 8 = 2 x 4, on 2 {PAR_LABEL}: "
          f"{rates[0]['s_per_step']:.4f} s/step (steps {DRIVER_SKIP + 1}-{steps}), data wait "
          f"{rates[0]['data_share']:.1%}; per rank: loader host "
          f"{[round(v, 3) for v in out['driver']['loader_s']]} s for "
          f"{out['driver']['volumes']} volumes, augmentation "
          f"{[round(v, 3) for v in out['driver']['aug_ms_per_step']]} ms a step (its 4 rows)",
          flush=True)

    # the rank view against the global view (bit-equal, deterministic
    # algorithms) and against the one-device driver (the same inputs)
    views = {tag: [r[f"driver {tag}"] for r in two] for tag in ("dp_rank", "dp_global")}
    rows = PAR_VIEW_BATCH // 2
    for rank, (mine, glob) in enumerate(zip(views["dp_rank"], views["dp_global"])):
        expect(mine["inputs"] == glob["inputs"] and len(mine["inputs"]) > 0,
               f"rank {rank}: the rank view's step inputs bit-equal to the global view's")
        want = [tuple(h[rank * rows:(rank + 1) * rows] for h in step)
                for step in one_view["inputs"]]
        expect(mine["inputs"] == want,
               f"rank {rank}: the rank view's step inputs bit-equal to the one-device driver's rows")
        expect(mine["hash"] == glob["hash"],
               f"rank {rank}: the rank view's parameters bit-equal to the global view's")
        for name, w in one_view["metrics"][0].items():
            v = mine["metrics"][0][name]
            expect(abs(v - w) <= PAR_BF16_RTOL[0] * abs(w) + 1e-4,
                   f"rank view step 0 {name}: {v} against the one-device driver's {w}")
    mine_state = CheckpointManager(workdir / "ck", "dp_rank").restore(
        "latest", create_state(train_config(torch.bfloat16), SEED + 1, PATCH, DEVICE))
    one_state = CheckpointManager(workdir / "ck", "one_view").restore(
        "latest", create_state(train_config(torch.bfloat16), SEED + 1, PATCH, DEVICE))
    diffs = [(a - b).abs() for n in mine_state.nets for a, b in
             zip(mine_state.nets[n].state_dict().values(), one_state.nets[n].state_dict().values())]
    param_diff = {"max": max(float(d.max()) for d in diffs),
                  "mean": sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs)}
    out["views"] = {tag: {"loader_s": [r["loader_s"] for r in runs],
                          "volumes": [r["volumes"] for r in runs],
                          "aug_ms_per_step": [sum(r["aug_ms"]) / len(r["aug_ms"]) for r in runs],
                          "s": max(r["s"] for r in runs)} for tag, runs in views.items()}
    out["views"]["one_view"] = {"loader_s": one_view["loader_s"], "volumes": one_view["volumes"],
                                "aug_ms_per_step": sum(one_view["aug_ms"]) / len(one_view["aug_ms"]),
                                "s": one_view["s"]}
    out["views"]["param_diff_vs_one_device"] = param_diff
    # the steps differ by their sums' order only: the Adam walk bound of the
    # CPU tests (tests/torch_port_util.py steps_match_jax)
    n_steps = len(one_view["metrics"])
    expect(param_diff["max"] <= 2 * n_steps * TRAIN_LR
           and param_diff["mean"] <= 0.15 * n_steps * TRAIN_LR,
           f"rank view's checkpoint within the Adam walk of the one-device driver's: {param_diff}")
    for tag in ("dp_global", "dp_rank", "one_view"):
        v = out["views"][tag]
        print(f"[parallel] driver {tag} (batch {PAR_VIEW_BATCH}, {VIEW_SAMPLES} samples a volume, "
              f"--augment, deterministic algorithms): loader host {v['loader_s']} s for "
              f"{v['volumes']} volumes, augmentation {v['aug_ms_per_step']} ms a step, "
              f"{v['s']:.2f} s", flush=True)
    print(f"[parallel] rank view: step inputs and parameters bit-equal to the global view's, "
          f"inputs bit-equal to the one-device driver's rows; its checkpoint against the "
          f"one-device driver's (bf16, {len(one_view['metrics'])} steps): max |diff| "
          f"{param_diff['max']:.3g}, mean {param_diff['mean']:.3g}", flush=True)
    del state, mine_state, one_state, diffs

    # repair A: every rank ends with the preflight's SystemExit
    for rank, r in enumerate(oom):
        expect(r["exit"] is not None and "out of device memory in the trial steps" in r["exit"]
               and "--spatial_parallel" in r["exit"],
               f"repair A: rank {rank} ends with the preflight's SystemExit: {r['exit']!r}")
    ends = [r["end"] - oom[1]["end"] for r in oom]
    out["repair_a"] = {"spawn_s": oom_s, "preflight_to_exit_s": [r["end"] - r["start"] for r in oom],
                       "after_oom_rank_s": ends}
    expect(max(ends) < PAR_OOM_TIMEOUT_S / 4,
           f"repair A: the mesh ended {max(ends):.3f} s after the rank out of memory")
    print(f"[parallel] repair A, 4 {PAR_LABEL}, rank 1 capped at {PAR_OOM_CAP_GIB} GiB: every "
          f"rank ended with the preflight's SystemExit; preflight to exit per rank "
          f"{[round(v, 3) for v in out['repair_a']['preflight_to_exit_s']]} s; after rank 1's "
          f"exit {[round(v, 3) for v in ends]} s; spawn {oom_s:.1f} s (the group's timeout "
          f"{PAR_TIMEOUT_S} s)", flush=True)
    torch.cuda.empty_cache()
    staged = {k: max(r["host_staged"][k] for r in two + four) for k in two[0]["host_staged"]}
    out["host_staged"] = staged
    out["seconds"] = time.perf_counter() - t_start
    print(f"[parallel] driver --data_parallel on 2 {PAR_LABEL}: {steps} steps in "
          f"{out['driver']['s']:.2f} s (preflight and loader included); checkpoint restored "
          f"bit-equal into a one-device state", flush=True)
    print(f"[parallel] collectives staged through the host (gloo, CUDA tensors; calls, the "
          f"most on a rank): {staged}", flush=True)
    print(f"[phase 14] in {out['seconds']:.1f} s ({PAR_LABEL}; no NCCL figure)", flush=True)
    check(not fails, f"phase 14: {len(fails)} comparisons failed: {fails}")
    return out




def phase_bench(K, train: dict, decode: dict, results: dict) -> dict:
    """Phase 15: the benchmark's cells at seed 1, each in a subprocess of its
    own (its timed block before any traced run of its process), each held
    within BENCH_RTOL of this run's own reading: the train step's median
    s/step against phase 7's batch-8 median, and its device time a step
    (the sum of its profiled kernel classes, ``layers``) against phase 7's
    profiled batch-8 step; the decode's median s/volume against phase 5's
    median. Phases 5 and 7 time the benchmark's window the benchmark's way."""
    import statistics

    import torch

    torch.cuda.empty_cache()  # the subprocess needs the card's memory
    b8 = f"b{max(TRAIN_BATCHES)}"
    # cell: (time key, this run's reading, this run's device ms or None)
    refs = {"train-b8-p64": ("s_per_step", train[b8]["s_per_step"],
                             train[b8]["profile"]["busy_ms"]),
            "decode-sw-128x256x256": ("s_per_volume", statistics.median(decode["decode_s"]),
                                      None)}
    t0 = time.perf_counter()
    lines = {}
    for cell in refs:
        proc = subprocess.run([sys.executable, "-m", "mra_gan_tpu_torch.bench", "--seed", "1",
                               "--cell", cell], cwd=Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"bench {cell} exited {proc.returncode}: {proc.stderr[-2000:]}")
        lines.update((r["cell"], r) for r in (json.loads(x) for x in proc.stdout.splitlines()
                                              if x.startswith("{")))
    secs = time.perf_counter() - t0
    out = {"seconds": secs}
    fails = []  # every reading printed before the first failed check ends the run
    for cell, (key, ref, ref_busy) in refs.items():
        line = lines[cell]
        if not (line["correct"] is True and line["failures"] == 0):
            fails.append(f"bench {cell}: correct, no failure ({line['correct']}, "
                         f"{line['failures']}, {line['checks']})")
        median = line["times"][key]["median"]
        print(f"[bench] {cell}: median {median:.4f} s ({key}), phase {ref:.4f} s, "
              f"{median / ref - 1:+.1%}; metrics {line['metrics']}; checks {line['checks']}; "
              f"layers {line['layers']}", flush=True)
        if abs(median / ref - 1) > BENCH_RTOL:
            fails.append(f"bench {cell}: median {median:.4f} s within {BENCH_RTOL:.0%} of "
                         f"{ref:.4f} s")
        if ref_busy is not None:
            busy = sum(v for k, v in line["layers"].items() if k.endswith("_ms"))
            print(f"[bench] {cell}: device {busy:.2f} ms, phase {ref_busy:.2f} ms, "
                  f"{busy / ref_busy - 1:+.1%}", flush=True)
            if abs(busy / ref_busy - 1) > BENCH_RTOL:
                fails.append(f"bench {cell}: device {busy:.2f} ms within {BENCH_RTOL:.0%} of "
                             f"{ref_busy:.2f} ms")
        launches = next(v for k, v in line["work"].items() if k.startswith("norm_launches"))
        for k, n in with_wholes({**dict.fromkeys(K.FORWARD + K.BACKWARD, 0),
                                 **launches}).items():
            results[k].setdefault("launches_cells", {})[cell] = n
        out[cell] = {"median_s": median, "phase_s": ref, "metrics": line["metrics"],
                     "times": line["times"], "layers": line["layers"],
                     "checks": line["checks"], "gpu": line["device"]["gpu"]}
    check(not fails, "; ".join(fails))
    print(f"[phase 15] both cells in {secs:.1f} s", flush=True)
    return out


def conv7_line(results: dict, train: dict, decode: dict) -> list:
    """The conv7 kernels' entries of the kernels line. Main path: the
    batch-8 train step (phase 7's timed steps), which runs every conv7
    kernel (the forward ones in both roles); the times at its largest role
    (2B = 16: the forward, or the weight gradient), every role's times
    beside them; the reduce pass's at the stem's weight gradient. Launches
    per cell: phase 7's batch-8 step and phase 5's decode, the cells'
    configurations (the benchmark's line counts only the norm kernels)."""
    b8 = f"b{max(TRAIN_BATCHES)}"
    steps = train[b8]["steps"]
    keys = ("role", "n", "ms", "cudnn_ms", "cudnn_benchmark_ms", "plain_ms", "bound_ms",
            "bound_by", "tflops")
    out = []
    for kernel, role in (("conv7_spread", "stem forward"), ("conv7_gather", "head forward"),
                         ("conv7_wgrad_spread", "stem weight grad"),
                         ("conv7_wgrad_gather", "head weight grad"),
                         ("conv7_wgrad_reduce", "stem weight grad")):
        r = results[kernel]
        reduce = kernel == "conv7_wgrad_reduce"
        times = results["conv7_wgrad_spread"]["times"] if reduce else r["times"]
        head = next(t for t in times if t["role"] == role and t["n"] == 2 * max(TRAIN_BATCHES))
        launches = train[b8]["conv7_launches"][kernel]
        forward = kernel in ("conv7_spread", "conv7_gather")
        check(launches > 0 and (decode["conv7_launches"][kernel] > 0 or not forward),
              f"{kernel} launched on its main path")
        entry = {
            "name": kernel, "route": "cuda",
            "source": "mra_gan_tpu_torch/ops/kernels/csrc/conv7.cu",
            "replaces": "mra_gan_tpu/ops/conv.py:35",
            "launches": launches, "max_abs_err": max(s["max_abs_err"] for s in r["shapes"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["cudnn_ms"],
            "at": {"role": role, "shape": head["shape"], "dtype": "bf16"},
            "launches_train_per_step": {f"b{b}": train[f"b{b}"]["conv7_launches"][kernel]
                                        / train[f"b{b}"]["steps"] for b in TRAIN_BATCHES},
            "launches_decode": decode["conv7_launches"][kernel],
            "launches_cells": {"train-b8-p64": launches / steps,
                               "decode-sw-128x256x256": decode["conv7_launches"][kernel]},
            "roles": [{k: t[k] for k in keys} for t in r["times"]] if not reduce else [],
            "note": "XLA's conv on the TPU (no Pallas kernel); library_ms: cuDNN's heuristic "
                    "pick in bf16, the path before this kernel"}
        if kernel.startswith("conv7_wgrad_") and not reduce:
            entry["note"] += ("; ms: both passes (the partial sums and conv7_wgrad_reduce), "
                              "the reduce alone in reduce_ms")
            entry["reduce_ms"] = head["reduce_ms"]
        if reduce:
            entry.update(
                ms=head["reduce_ms"], plain_ms=head["reduce_plain_ms"],
                bound_ms=head["reduce_bound_ms"],
                bound_by="bytes", library_ms=None, sum_only_ms=head["reduce_library_ms"],
                roles=[{"role": t["role"], "n": t["n"], "partials": t["partials"],
                        "ms": t["reduce_ms"], "sum_only_ms": t["reduce_library_ms"],
                        "bound_ms": t["reduce_bound_ms"]}
                       for k in ("conv7_wgrad_spread", "conv7_wgrad_gather")
                       for t in results[k]["times"]],
                note="the second pass of both weight gradients: the partial sums of a fixed "
                     "grid in block order, the head's taps flipped, one rounding; max_abs_err "
                     "against its plain version (torch's float32 sum of the same partials); "
                     "library_ms: none, no one PyTorch call sums the partials, drops the "
                     "spare column, flips the head's taps and rounds; sum_only_ms: torch.sum "
                     "of the partials over the blocks alone")
        out.append(entry)
    return out


def pad_line(results: dict, train: dict, decode: dict) -> list:
    """The replication-pad kernels' entries of the kernels line. Main path:
    the batch-8 train step (phase 7's timed steps), which runs both; the
    times at the head's pad at its 2B = 16 (the largest pad of the step),
    the decode's batch-8 head pad, every role's timed row (stem, trunk,
    head at each PAD_TIMED batch, with its launches a step and a volume)
    and their launch-weighted sums a step and a volume beside them.
    Launches per cell: phase 7's batch-8 step and phase 5's decode."""
    b8 = f"b{max(TRAIN_BATCHES)}"
    steps = train[b8]["steps"]
    keys = ("role", "n", "shape", "route", "ms", "plain_ms", "library_ms", "bound_ms",
            "launches_step", "launches_volume")
    out = []
    for kernel in ("replication_pad_fwd", "replication_pad_bwd"):
        r = results[kernel]
        head = next(t for t in r["times"] if t["role"] == "head" and t["n"] == max(PAD_TIMED))
        dec = next(t for t in r["times"] if t["role"] == "head" and t["n"] == DECODE_BATCH)
        launches = train[b8]["pad_launches"][kernel]
        check(launches > 0, f"{kernel} launched on its main path")
        out.append({
            "name": kernel, "route": "cuda",
            "source": "mra_gan_tpu_torch/ops/kernels/csrc/replication_pad.cu",
            "replaces": "F.pad replicate", "launches": launches,
            "max_abs_err": max(t["max_abs_err"] for t in r["shapes"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "bytes", "library_ms": head["library_ms"],
            "at": {"role": "head", "shape": head["shape"], "pad": head["pad"], "dtype": "bf16"},
            "decode_at": {k: dec[k] for k in keys},
            "launches_train_per_step": {f"b{b}": train[f"b{b}"]["pad_launches"][kernel]
                                        / train[f"b{b}"]["steps"] for b in TRAIN_BATCHES},
            "launches_decode": decode["pad_launches"][kernel],
            "launches_single_pass": decode["single_pass_pad_launches"][kernel],
            "launches_cells": {"train-b8-p64": launches / steps,
                               "decode-sw-128x256x256": decode["pad_launches"][kernel]},
            "roles": [{k: t[k] for k in keys} for t in r["times"]],
            "per_step": r["per_step"], "per_volume": r.get("per_volume"),
            "note": "no Pallas kernel: XLA's edge pad on the TPU (mra_gan_tpu/ops/conv.py:131); "
                    "library_ms: F.pad(mode='replicate')" + (" and its autograd backward"
                                                             if "bwd" in kernel else "")
                    + ", the path before this kernel; max_abs_err against its plain version"})
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--json-out", default="",
                    help="also write the full report, every shape's numbers included, here")
    ap.add_argument("--conv7", action="store_true",
                    help="phase 1, then only the conv7 parts of phases 2 and 3 (every kernel "
                         "against its plain version, the times); prints their rows and no "
                         "result line")
    ap.add_argument("--conv4s2", action="store_true",
                    help="phase 1, then only the conv4s2 parts of phases 2 and 3 (every kernel "
                         "against its plain version, the times); prints their rows and no "
                         "result line")
    ap.add_argument("--pads", action="store_true",
                    help="phase 1, then only the pad part of phase 2 (both kernels against "
                         "their plain versions, the times); prints their rows and no result "
                         "line")
    ap.add_argument("--bench", action="store_true",
                    help="phase 1, then only phase 5's timed decodes, phase 7's batch-8 timed "
                         "and profiled steps and phase 15 (the benchmark's cells against "
                         "them); prints their lines and no result line")
    ap.add_argument("--single-pass-child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.single_pass_child:
        return single_pass_child(Path(args.single_pass_child))
    t_start = time.perf_counter()
    from mra_gan_tpu_torch.ops.kernels import build
    from mra_gan_tpu_torch.ops.kernels import instance_norm as K

    card = gpu_line()
    name = torch.cuda.get_device_name(0)
    print(f"[gpu] {card}", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name} count {torch.cuda.device_count()}",
          flush=True)
    bw, flops, tc = peak_rates(name)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs.values():
        log = Path(str(lib) + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    print(f"[ptxas] {line.strip()}")

    src = "mra_gan_tpu_torch/ops/kernels/csrc/instance_norm.cu"
    pallas = "mra_gan_tpu/ops/pallas/instance_norm.py"
    results = {
        "instance_norm_slab": {"replaces": f"{pallas}:86", "note": "_sum_kernel (:86) and "
                               f"_apply_kernel (:100) in one launch where K.uses_slab holds; "
                               "library_ms: F.instance_norm + activation"},
        "instance_norm_stats": {"replaces": f"{pallas}:86", "note": "library_ms: "
                                "torch.var_mean, per-(n, c) mean and variance"},
        "instance_norm_apply": {"replaces": f"{pallas}:100", "note": "with the merge of the "
                                "stats kernel's partials in its prologue"},
        "instance_norm_act": {"replaces": f"{pallas}:108", "note": "the whole forward (_fwd): "
                              "one slab launch or stats + apply; launches = forward norms"},
        "instance_norm_bwd_slab": {"replaces": f"{pallas}:137", "note": "_bwd_sum_kernel "
                                   "(:137) and _bwd_apply_kernel (:155) in one launch where "
                                   "K.uses_slab holds; library_ms: autograd backward of "
                                   "F.instance_norm + activation"},
        "instance_norm_bwd_stats": {"replaces": f"{pallas}:137"},
        "instance_norm_bwd_apply": {"replaces": f"{pallas}:155", "note": "with the merge of the "
                                    "bwd stats kernel's partial sums in its prologue"},
        "instance_norm_act_bwd": {"replaces": f"{pallas}:167", "note": "the whole backward "
                                  "(_bwd): one bwd slab launch or bwd stats + bwd apply; "
                                  "launches = backward norms"},
    }
    for k, r in results.items():
        r.update(name=k, route="cuda", source=src, bound_by="bytes", shapes=[])
    conv7_results = {k: {"shapes": []} for k in ("conv7_spread", "conv7_gather",
                                                  "conv7_wgrad_spread", "conv7_wgrad_gather",
                                                  "conv7_wgrad_reduce")}
    pad_results = {k: {"shapes": [], "times": []}
                   for k in ("replication_pad_fwd", "replication_pad_bwd")}
    c4s2_results = {k: {"shapes": [], "times": []} for k in C4S2_KERNELS}

    if args.conv7:
        phase_conv7_kernels(conv7_results)
        phase_conv7_wgrad_kernels(conv7_results)
        conv7_rows = phase_conv7_times(bw, tc, conv7_results)
        conv7_rows += phase_conv7_wgrad_times(bw, flops, tc, conv7_results)
        if args.json_out:
            Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json_out).write_text(json.dumps(
                {"gpu": card, "conv7": conv7_rows, "shapes": conv7_results}, indent=1))
        print(json.dumps({"conv7": conv7_rows}))
        print(gpu_line())
        return 0
    if args.pads:
        pad_rows = phase_pad_kernels(bw, pad_results)
        if args.json_out:
            Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json_out).write_text(json.dumps(
                {"gpu": card, "pads": pad_rows, "shapes": pad_results}, indent=1))
        print(json.dumps({"pads": pad_rows}))
        print(gpu_line())
        return 0
    if args.conv4s2:
        phase_conv4s2_kernels(c4s2_results)
        c4s2_rows = phase_conv4s2_times(bw, flops, tc, c4s2_results)
        if args.json_out:
            Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json_out).write_text(json.dumps(
                {"gpu": card, "conv4s2": c4s2_rows, "shapes": c4s2_results}, indent=1))
        print(json.dumps({"conv4s2": c4s2_rows}))
        print(gpu_line())
        return 0
    if args.bench:
        tree = random_jax_tree(NGF, 6, SEED)
        decode = phase_decode(K, tree, results, single_pass=False)
        train = phase_train(K, results, batches=(max(TRAIN_BATCHES),))
        decode["decode_profile"] = profile_run(untraced(decode.pop("trace_decode")), "decode")
        bench = phase_bench(K, train, decode, results)
        summary = {"decode_s": decode["decode_s"], "decode_profile": decode["decode_profile"],
                   "train": train, "bench": bench}
        if args.json_out:
            Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json_out).write_text(json.dumps({"gpu": card, **summary}, indent=1))
        print(json.dumps({"bench": {k: {"median_s": v["median_s"], "phase_s": v["phase_s"]}
                                    for k, v in bench.items() if k != "seconds"}}))
        print(gpu_line())
        return 0
    phase_kernels(K, bw, flops, results)
    phase_train_kernels(K, bw, flops, results)
    phase_conv7_kernels(conv7_results)
    phase_conv7_wgrad_kernels(conv7_results)
    pad_rows = phase_pad_kernels(bw, pad_results)
    phase_conv4s2_kernels(c4s2_results)
    conv_rows = phase_conv_formats()
    conv7_rows = phase_conv7_times(bw, tc, conv7_results)
    conv7_rows += phase_conv7_wgrad_times(bw, flops, tc, conv7_results)
    c4s2_rows = phase_conv4s2_times(bw, flops, tc, c4s2_results)
    tree = random_jax_tree(NGF, 6, SEED)
    phase_generator(K, tree)
    decode = phase_decode(K, tree, results)
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_cli(K, tree, Path(tmp))
    train = phase_train(K, results)
    decode["decode_profile"] = profile_run(untraced(decode.pop("trace_decode")), "decode")
    c4s2_split = c4s2_cudnn_split(c4s2_results)
    c4s2_split.append({"patchgan_conv_calls": patchgan_conv_calls()})
    parity = phase_train_parity()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        ckpt = phase_checkpoint(K, Path(tmp))
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        serving = phase_serve(K, tree, decode, Path(tmp))
        serving["evaluate"] = phase_evaluate(Path(tmp))
    # phase 11's data and warm cache, read again by phases 13 and 14
    driver_dir = Path(tempfile.mkdtemp(dir=build_dir))
    train_driver = phase_driver(K, train, results, driver_dir)
    t13 = time.perf_counter()
    phase13 = {"augment_driver": phase_augment_driver(K, train, train_driver, driver_dir)}
    t13 = time.perf_counter() - t13
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        zoo = phase_zoo(K, bw, flops, results, Path(tmp))
    t0 = time.perf_counter()
    phase13["augment"] = phase_augment()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase13["registration"] = phase_registration(Path(tmp))
    phase13["remat"] = phase_remat(K)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase13["single_pass"] = phase_single_pass(Path(tmp))
    phase13["seconds"] = t13 + time.perf_counter() - t0
    print(f"[phase 13] in {phase13['seconds']:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        parallel = phase_parallel(K, tree, results, decode, phase13, driver_dir, Path(tmp))
    shutil.rmtree(driver_dir)
    bench = phase_bench(K, train, decode, results)

    kernels = []
    for k, r in results.items():
        backward = "bwd" in k
        # forward kernels: the decode's batch-8 stem shape (the decode is
        # their first main path); backward kernels: the batch-8 train step's
        # largest norm; the slab kernels at the trunk's 128 channels, their largest
        path, n = ("G b8", 2 * max(TRAIN_BATCHES)) if backward else ("b8", DECODE_BATCH)
        width = 4 * NGF if k in ("instance_norm_slab", "instance_norm_bwd_slab") else NGF
        head = next(s for s in r["shapes"] if s["path"] == path and s["shape"][:2] == [n, width]
                    and s["dtype"] == "bf16")
        train_head = next(s for s in r["shapes"] if s["path"] == "G b8"
                          and s["shape"][:2] == [2 * max(TRAIN_BATCHES), width]
                          and s["dtype"] == "bf16")
        launches = r["launches_train"] if backward else r["launches_decode"]
        check(launches > 0, f"{k} launched on its main path")
        kernels.append({
            "name": k, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches, "max_abs_err": max(s["max_abs_err"] for s in r["shapes"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": head["library_ms"],
            "at": {"path": path, "shape": head["shape"], "dtype": "bf16", "act": head["act"]},
            "launches_decode": r["launches_decode"],
            "launches_single_pass": r["launches_single_pass"],
            "launches_train": r["launches_train"],
            "launches_train_per_step": r["launches_train_per_step"],
            "launches_driver_per_step": r["launches_driver_per_step"],
            "launches_cells": r["launches_cells"],
            "train_at": {"shape": train_head["shape"], "ms": train_head["ms"],
                         "plain_ms": train_head["plain_ms"],
                         "bound_ms": train_head["bound_ms"],
                         "library_ms": train_head["library_ms"]},
            **({k: r[k] for k in ("launches_sharded", "max_abs_err_sharded", "sharded")
                if k in r}),
            **({"note": r["note"]} if "note" in r else {})})
    kernels += conv7_line(conv7_results, train, decode)
    kernels += pad_line(pad_results, train, decode)
    kernels += c4s2_line(c4s2_results, train, decode)
    summary = {"decode": decode, "train": train, "train_parity": parity, "checkpoint": ckpt,
               "serve": serving, "train_driver": train_driver, "zoo": zoo, "phase13": phase13,
               "parallel": parallel, "bench": bench,
               "conv_formats": conv_rows, "conv7": conv7_rows, "pads": pad_rows,
               "conv4s2": c4s2_rows, "conv4s2_cudnn_split": c4s2_split,
               "seconds": time.perf_counter() - t_start}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            {"gpu": card, **summary, "kernels": kernels,
             "shapes": {k: r["shapes"] for k, r in {**results, **pad_results,
                                                    **c4s2_results}.items()}},
            indent=1))
    for prof in [decode["decode_profile"]] + [t["profile"] for t in train.values()]:
        prof.pop("top", None)  # printed above; kept in --json-out
        prof.pop("gaps", None)
    print(json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
