#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mra_gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

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
3. cuDNN conv3d / conv_transpose3d at the generator's shapes, NCDHW against
   channels_last_3d;
4. the resnet_6blocks generator at ngf=32, batch 8, 64^3, weights from a
   seeded numpy tree in the JAX layout through state_dict_from_jax: kernel
   norms against plain norms in bfloat16 and (TF32 off) float32, and the
   exact launches of each forward kernel per forward that uses_slab gives
   (13 slab, 4 stats, 4 apply), none of a backward one (nor in phases 5-6);
5. the sliding-window decode of a 128x256x256 volume (147 patches in 19
   batches, Gaussian blend; 19 x those launches), then the single-pass
   whole-volume forward of the same volume (17 stats, 17 apply, no slab);
6. the decode CLI (python -m mra_gan_tpu_torch.test) in directory mode on
   three synthetic NIfTIs with a .pth checkpoint written from the same tree;
7. the CycleGAN train step (create_state + make_train_step) at the
   reference default (bench.py:193-198: two resnet_6blocks generators, two
   3-layer PatchGANs, ngf = ndf = 32, LSGAN, pool 50, Adam 2e-4 / 0.5, bf16
   over f32 parameters, 64^3 patches) at batch 1 and 8: s/step, pairs/s,
   peak memory, the exact launches per step (forward: 4 x 13 + 12 slab, 16
   stats, 16 apply; backward: 64 bwd slab, 16 bwd stats, 16 bwd apply),
   the gradient relayouts, finite losses, and one profiled step by kernel
   class;
8. step 0 at batch 1 through the kernels and through the plain norms, in
   float32 (TF32 off) and bf16, each against a float64 step
   (phase_train_parity states the bars).

The line before the last is the card's name and power limit; before it, one
JSON line {"kernels": [...]} with each kernel's launches on its main path
(the decode for the forward kernels, the batch-8 train step for the
backward ones), its largest error against the plain version, and its times
at the main path's largest norm that it runs (bfloat16). ``--json-out PATH`` also writes
every shape's numbers. The last line is {"ok": true, "device": {...}}.
Without CUDA the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
DEVICE = "cuda"
PATCH = (64, 64, 64)
VOLUME = (128, 256, 256)  # bench.py:80
STRIDE = 32
DECODE_BATCH = 8
EXPECTED_GRID = (147, 19)  # patches, batches
CLI_SHAPES = [(96, 128, 77), (128, 128, 64), (100, 90, 45)]  # odd, even, sub-patch Z
NGF = 32
NDF = 32
TRAIN_BATCHES = (1, 8)  # bench.py:186-251
TRAIN_LR = 2e-4
NORMS_PER_STEP = 80  # 4 generator applies x 17 norms + 4 discriminator applies x 3
TRAIN_WARMUP = 2
TRAIN_TIMED_STEPS = (5, 3)  # at batch 1 and 8
PAIRED_ACTS = ("leaky_relu", "tanh")
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def peak_rates(name: str):
    """(memory bytes/s, f32 FLOP/s outside the tensor cores) of the named
    card, from NVIDIA's data sheets."""
    n = name.upper()
    if "H100" in n and "PCIE" in n:
        return 2.0e12, 51e12
    if "H100" in n and "NVL" in n:
        return 3.9e12, 60e12
    if "H200" in n:
        return 4.8e12, 67e12
    if "H100" in n:
        return 3.35e12, 67e12
    raise RuntimeError(f"no peak rates recorded for {name!r}")


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


@contextlib.contextmanager
def plain_norms():
    """Run the generator's norms through the plain PyTorch version instead
    of the kernels, for comparison on the card."""
    from mra_gan_tpu_torch.models import networks
    from mra_gan_tpu_torch.ops.kernels import instance_norm as K

    saved = networks.instance_norm_act
    networks.instance_norm_act = (
        lambda x, eps=K.EPS, act="none", negative_slope=0.2:
        K.instance_norm_act_plain(x, act, negative_slope, eps))
    try:
        yield
    finally:
        networks.instance_norm_act = saved


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

    x = torch.from_numpy(np.random.RandomState(SEED).uniform(
        -1, 1, (DECODE_BATCH, 1) + PATCH).astype(np.float32))
    sd = state_dict_from_jax(tree, "resnet_6blocks")
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = make_generate_fn(CycleGANConfig(ngf=NGF, dtype=dtype), "g_a", DEVICE)
        gen.net.load_state_dict(sd)
        gen(x)  # cuDNN and kernel warm-up
        K.reset_launches()
        t0 = time.perf_counter()
        y = gen(x)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        want = forward_launches(K, generator_norms(DECODE_BATCH, PATCH), dtype)
        check(launched(K, want), f"launches per forward {K.LAUNCHES}, want {want}, "
              f"no backward")
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


# kernel classes of a profile, first match wins (the optimizer's
# multi_tensor_apply_kernel and the backward norm kernels contain the names
# of forward norm kernels)
PROFILE_CLASSES = (
    ("norm_bwd", ("bwd_slab_kernel", "bwd_stats_kernel", "bwd_apply_kernel")),
    ("optimizer", ("multi_tensor_apply",)),
    ("norm", ("slab_kernel", "stats_kernel", "apply_kernel")),
    ("copy", ("memcpy", "memset", "copy_kernel")),
    ("pad", ("replication_pad",)),
    ("conv", ("conv", "xmma", "cudnn", "gemm", "implicit", "fprop", "dgrad", "wgrad",
              "cutlass", "winograd", "nhwc", "nchw")),
)


def kernel_class(name: str) -> str:
    name = name.lower()
    return next((cls for cls, keys in PROFILE_CLASSES if any(k in name for k in keys)),
                "other")


def profile_run(fn, what: str) -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel class
    and the device's idle share of the wall time (profiling on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    classes = dict.fromkeys([c for c, _ in PROFILE_CLASSES] + ["other"], 0.0)
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) != "DeviceType.CUDA":
            continue
        us = getattr(e, "self_device_time_total", None)
        ms = (us if us is not None else e.self_cuda_time_total) / 1e3
        cls = kernel_class(e.key)
        classes[cls] += ms
        rows.append((ms, e.count, cls, e.key[:100]))
    busy = sum(classes.values())
    if busy == 0:
        print(f"[profile] {what}: the profiler recorded no device time", flush=True)
        return {"wall_ms": wall_ms}
    for ms, count, cls, key in sorted(rows, reverse=True)[:15]:
        print(f"[profile] {what}: {ms:9.3f} ms {count:6d}x {cls:9s} {key}")
    print(f"[profile] {what} wall {wall_ms:.1f} ms (profiling on), device busy {busy:.1f} ms, "
          f"idle {1 - busy / wall_ms:.1%}; " + ", ".join(
              f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in classes.items()), flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "by_class_ms": classes, "top": [list(r) for r in sorted(rows, reverse=True)[:15]]}


def phase_decode(K, tree, results: dict) -> dict:
    import numpy as np
    import torch

    from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
    from mra_gan_tpu_torch.infer.sliding_window import patch_grid, sliding_window_inference
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn
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
    t0 = time.perf_counter()
    out = decode()
    secs = [time.perf_counter() - t0]
    launches = dict(K.LAUNCHES)
    per_forward = forward_launches(K, generator_norms(DECODE_BATCH, PATCH), torch.bfloat16)
    check(launched(K, times(per_forward, n_batches)),
          f"{n_batches} x {per_forward} launches per decode, no backward: {launches}")
    check(out.shape == VOLUME and out.dtype == np.float32 and bool(np.isfinite(out).all()),
          "decode output finite float32 of the volume's shape")
    for _ in range(2):
        t0 = time.perf_counter()
        decode()
        secs.append(time.perf_counter() - t0)
    profile = profile_run(decode, "decode")
    with plain_norms():
        ref = decode()
    diff = np.abs(out - ref)
    print(f"[decode] {VOLUME} volume, {n_patches} patches in {n_batches} batches: "
          f"{secs} s; launches {launches}; vs plain norms max {diff.max():.3g} "
          f"mean {diff.mean():.3g}", flush=True)
    check(float(diff.mean()) <= 0.02 and float(diff.max()) <= 0.5,
          "decode: kernel norms within tolerance of plain norms")

    single_pass_apply(gen, vol)  # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    sp = single_pass_apply(gen, vol)
    sp_secs = [time.perf_counter() - t0]
    sp_launches = dict(K.LAUNCHES)
    want = forward_launches(K, generator_norms(1, VOLUME), torch.bfloat16)
    check(launched(K, want), f"single pass launches {sp_launches}, want {want}, no backward")
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
    return {"decode_s": secs, "single_pass_s": sp_secs, "decode_launches": launches,
            "single_pass_launches": sp_launches, "decode_profile": profile}


def phase_cli(K, tree, workdir: Path) -> None:
    import numpy as np
    import torch

    from mra_gan_tpu_torch import test as cli
    from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
    from mra_gan_tpu_torch.data import nifti
    from mra_gan_tpu_torch.infer.sliding_window import patch_grid

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


def phase_train(K, results: dict) -> dict:
    """create_state + make_train_step at the reference default in bf16, at
    batch 1 and 8: warm-up steps, then timed steps with the launch counters
    zeroed just before them, then one profiled step."""
    import torch

    from mra_gan_tpu_torch.models.cycle_gan import create_state, make_train_step

    cfg = train_config(torch.bfloat16)
    out = {}
    for batch, timed in zip(TRAIN_BATCHES, TRAIN_TIMED_STEPS):
        state = create_state(cfg, SEED, PATCH, DEVICE)
        step = make_train_step(cfg)
        real_a, real_b = train_inputs(batch, SEED + batch)
        for _ in range(TRAIN_WARMUP):
            step(state, real_a, real_b, TRAIN_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        for _ in range(timed):
            _, metrics = step(state, real_a, real_b, TRAIN_LR)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / timed
        launches = dict(K.LAUNCHES)
        relayouts = K.GRAD_RELAYOUTS["count"] / timed
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
        print(f"[train] b{batch}: {secs:.4f} s/step, {batch / secs:.3f} pairs/s over {timed} "
              f"steps; peak memory {peak:.2f} GiB; launches {launches}; gradient relayouts "
              f"{relayouts:g} per step; losses {losses}", flush=True)
        prof = profile_run(lambda: step(state, real_a, real_b, TRAIN_LR), f"train b{batch}")
        out[f"b{batch}"] = {"s_per_step": secs, "pairs_per_s": batch / secs, "steps": timed,
                            "peak_gib": peak, "launches": launches,
                            "grad_relayouts_per_step": relayouts, "losses": losses,
                            "profile": prof}
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


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--json-out", default="",
                    help="also write the full report, every shape's numbers included, here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from mra_gan_tpu_torch.ops.kernels import build
    from mra_gan_tpu_torch.ops.kernels import instance_norm as K

    card = gpu_line()
    name = torch.cuda.get_device_name(0)
    print(f"[gpu] {card}", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name} count {torch.cuda.device_count()}",
          flush=True)
    bw, flops = peak_rates(name)
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

    phase_kernels(K, bw, flops, results)
    phase_train_kernels(K, bw, flops, results)
    conv_rows = phase_conv_formats()
    tree = random_jax_tree(NGF, 6, SEED)
    phase_generator(K, tree)
    decode = phase_decode(K, tree, results)
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_cli(K, tree, Path(tmp))
    train = phase_train(K, results)
    parity = phase_train_parity()

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
            "train_at": {"shape": train_head["shape"], "ms": train_head["ms"],
                         "plain_ms": train_head["plain_ms"],
                         "bound_ms": train_head["bound_ms"],
                         "library_ms": train_head["library_ms"]},
            **({"note": r["note"]} if "note" in r else {})})
    summary = {"decode": decode, "train": train, "train_parity": parity,
               "conv_formats": conv_rows, "seconds": time.perf_counter() - t_start}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            {"gpu": card, **summary, "kernels": kernels,
             "shapes": {k: r["shapes"] for k, r in results.items()}}, indent=1))
    for prof in [decode["decode_profile"]] + [t["profile"] for t in train.values()]:
        prof.pop("top", None)  # printed above; kept in --json-out
    print(json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
