#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mra_gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the nvcc build of every kernel source under
   mra_gan_tpu_torch/ops/kernels/csrc/ (one nvcc per source, in parallel);
2. every CUDA kernel against its plain PyTorch version on the card, at every
   instance-norm shape of the decode path (batch 8, the short last batch of
   3, and the whole-volume single pass) in bfloat16 and float32, plus a small
   shape each for leaky_relu and tanh; timed beside the plain version, the
   library yardstick (F.instance_norm + activation) and the memory bound;
3. cuDNN conv3d / conv_transpose3d at the generator's shapes, NCDHW against
   channels_last_3d;
4. the resnet_6blocks generator at ngf=32, batch 8, 64^3, weights from a
   seeded numpy tree in the JAX layout through state_dict_from_jax: kernel
   norms against plain norms in bfloat16 and (TF32 off) float32, and 17
   launches of each kernel per forward;
5. the sliding-window decode of a 128x256x256 volume (147 patches in 19
   batches, Gaussian blend; 19 x 17 launches of each kernel), then the
   single-pass whole-volume forward of the same volume;
6. the decode CLI (python -m mra_gan_tpu_torch.test) in directory mode on
   three synthetic NIfTIs with a .pth checkpoint written from the same tree.

The line before the last is the card's name and power limit; before it, one
JSON line {"kernels": [...]} with each kernel's launches on the decode, its
largest error against the plain version, and its times at the batch-8 stem
shape (bfloat16). ``--json-out PATH`` also writes every shape's numbers. The
last line is {"ok": true, "device": {...}}. Without CUDA the script exits
non-zero and prints no result.
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
PAIRED_ACTS = ("leaky_relu", "tanh")
# f32 operations per element, for the operations bound
APPLY_OPS = {"none": 2, "relu": 3, "leaky_relu": 4, "tanh": 10}
STATS_OPS = 7  # Welford: sub, mul, add, sub, mul, add, + the count's reciprocal
FINALIZE_OPS = 12  # Chan merge per partial


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


def phase_kernels(K, bw: float, flops: float, results: dict) -> None:
    import torch
    import torch.nn.functional as F

    lib_act = {"none": lambda y: y, "relu": F.relu,
               "leaky_relu": lambda y: F.leaky_relu(y, 0.2), "tanh": torch.tanh}
    cases = [(lbl, s, a, dt) for lbl, s, a in norm_shapes()
             for dt in (torch.bfloat16, torch.float32)
             if not (lbl == "b3" and dt == torch.float32)]
    cases += [("small", (2, NGF, 16, 16, 16), a, dt) for a in PAIRED_ACTS
              for dt in (torch.bfloat16, torch.float32)]
    # C = 6 is no multiple of a 16-byte vector: the one-element-per-thread kernels
    cases += [("odd_c", (2, 6, 16, 16, 16), "relu", dt) for dt in (torch.bfloat16, torch.float32)]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for label, shape, act, dtype in cases:
        x = (torch.randn(shape, generator=gen, device=DEVICE) * 3 + 1).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last_3d)
        n, c = shape[:2]
        v = math.prod(shape[2:])
        es = x.element_size()
        bf16 = dtype == torch.bfloat16
        seg = K.num_segments(n, v, c, K.vector_width(x))

        pm, pq = K.instance_norm_stats(x, seg)
        rm, rq = K.stats_plain(x, seg)
        cnt = max(b - a for a, b in zip(K.segment_bounds(v, seg), K.segment_bounds(v, seg)[1:]))
        # partial sums in two summation orders, float32
        err_stats = max(float((pm - rm).abs().max()), float((pq - rq).abs().max()) / cnt)
        check(torch.allclose(pm, rm, rtol=1e-4, atol=1e-5)
              and torch.allclose(pq, rq, rtol=1e-4, atol=1e-3),
              f"stats {label} {shape} {dtype}: {err_stats}")
        mean, rstd = K.instance_norm_finalize(pm, pq, v)
        fm, fr = K.finalize_plain(pm, pq, v)
        err_fin = max(float((mean - fm).abs().max()), float((rstd - fr).abs().max()))
        check(torch.allclose(mean, fm, rtol=1e-5, atol=1e-6)
              and torch.allclose(rstd, fr, rtol=1e-5, atol=1e-6),
              f"finalize {label} {shape} {dtype}: {err_fin}")
        y = K.instance_norm_apply(x, mean, rstd, act, 0.2)
        ya = K.apply_plain(x, mean, rstd, act, 0.2)
        err_apply = float((y.float() - ya.float()).abs().max())
        # the same float32 arithmetic rounded once: 1 bf16 ulp, or 1e-5 in f32
        check(bf16_ulps(y, ya) <= 1.0 if bf16 else err_apply <= 1e-5,
              f"apply {label} {shape} {dtype}: {err_apply}")
        yk = K.instance_norm_act_fused(x, act, 0.2)
        yp = K.instance_norm_act_plain(x, act, 0.2)
        check(yk.is_contiguous(memory_format=torch.channels_last_3d) and yk.dtype == dtype,
              "fused output layout and dtype")
        err_norm = float((yk.float() - yp.float()).abs().max())
        ulps = bf16_ulps(yk, yp) if bf16 else None
        check(ulps <= 2.0 if bf16 else err_norm <= 1e-5,
              f"instance_norm_act {label} {shape} {dtype}: {err_norm} ({ulps} ulps)")

        big = x.numel() * es >= 100e6
        iters = 10 if big else 30
        t = {
            "instance_norm_stats": device_ms(lambda: K.instance_norm_stats(x, seg), iters),
            "instance_norm_finalize": device_ms(
                lambda: K.instance_norm_finalize(pm, pq, v), iters),
            "instance_norm_apply": device_ms(
                lambda: K.instance_norm_apply(x, mean, rstd, act, 0.2), iters),
            "instance_norm_act": device_ms(lambda: K.instance_norm_act_fused(x, act, 0.2), iters),
        }
        fused_dispatch = dispatch_ms(lambda: K.instance_norm_act_fused(x, act, 0.2), iters)
        p = {
            "instance_norm_stats": device_ms(lambda: K.stats_plain(x, seg), 3, 1),
            "instance_norm_finalize": device_ms(lambda: K.finalize_plain(pm, pq, v), iters),
            "instance_norm_apply": device_ms(lambda: K.apply_plain(x, mean, rstd, act), iters),
            "instance_norm_act": device_ms(lambda: K.instance_norm_act_plain(x, act), iters),
        }
        lib = device_ms(lambda: lib_act[act](F.instance_norm(x)), iters)
        part_bytes = 2 * n * seg * c * 4
        stat_bytes = 2 * n * c * 4
        bounds = {
            "instance_norm_stats": max((x.numel() * es + part_bytes) / bw,
                                       STATS_OPS * x.numel() / flops),
            "instance_norm_finalize": max((part_bytes + stat_bytes) / bw,
                                          FINALIZE_OPS * n * seg * c / flops),
            "instance_norm_apply": max((2 * x.numel() * es + stat_bytes) / bw,
                                       APPLY_OPS[act] * x.numel() / flops),
            "instance_norm_act": max(2 * x.numel() * es / bw,
                                     (STATS_OPS + APPLY_OPS[act]) * x.numel() / flops),
        }
        errs = {"instance_norm_stats": err_stats, "instance_norm_finalize": err_fin,
                "instance_norm_apply": err_apply, "instance_norm_act": err_norm}
        dname = "bf16" if bf16 else "f32"
        for k in t:
            results[k]["shapes"].append({
                "path": label, "shape": list(shape), "dtype": dname, "act": act,
                "segments": seg, "ms": t[k], "plain_ms": p[k],
                "library_ms": lib if k == "instance_norm_act" else None,
                **({"dispatch_ms": fused_dispatch} if k == "instance_norm_act" else {}),
                "bound_ms": bounds[k] * 1e3, "max_abs_err": errs[k]})
        print(f"[kernels] {label:6s} {str(shape):28s} {dname} {act:10s} S={seg:5d} "
              f"norm {t['instance_norm_act']:.4f} ms (stats {t['instance_norm_stats']:.4f}, "
              f"fin {t['instance_norm_finalize']:.4f}, apply {t['instance_norm_apply']:.4f}) "
              f"dispatch {fused_dispatch:.4f} plain {p['instance_norm_act']:.4f} lib {lib:.4f} "
              f"bound {bounds['instance_norm_act'] * 1e3:.4f} ms  err {err_norm:.3g}"
              + (f" ({ulps:.2f} ulp)" if bf16 else ""), flush=True)
        del x, pm, pq, rm, rq, y, ya, yk, yp
    torch.cuda.empty_cache()


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
        check(all(v == 17 for v in K.LAUNCHES.values()), f"17 launches per forward: {K.LAUNCHES}")
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


def profile_decode(decode) -> dict:
    """One decode under torch.profiler: device time by kernel class and the
    device's idle share of the wall time (profiling on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    classes = {"norm": 0.0, "conv": 0.0, "copy": 0.0, "other": 0.0}
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) != "DeviceType.CUDA":
            continue
        us = getattr(e, "self_device_time_total", None)
        ms = (us if us is not None else e.self_cuda_time_total) / 1e3
        name = e.key.lower()
        if any(k in name for k in ("stats_kernel", "finalize_kernel", "apply_kernel")):
            cls = "norm"
        elif "memcpy" in name or "memset" in name:
            cls = "copy"
        elif any(k in name for k in ("conv", "xmma", "cudnn", "gemm", "implicit", "fprop",
                                     "dgrad", "wgrad", "cutlass", "winograd", "nhwc", "nchw")):
            cls = "conv"
        else:
            cls = "other"
        classes[cls] += ms
        rows.append((ms, e.count, cls, e.key[:100]))
    busy = sum(classes.values())
    if busy == 0:
        print("[profile] the profiler recorded no device time", flush=True)
        return {"wall_ms": wall_ms}
    for ms, count, cls, key in sorted(rows, reverse=True)[:15]:
        print(f"[profile] {ms:9.3f} ms {count:6d}x {cls:5s} {key}")
    print(f"[profile] decode wall {wall_ms:.1f} ms (profiling on), device busy {busy:.1f} ms, "
          f"idle {1 - busy / wall_ms:.1%}; " + ", ".join(
              f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in classes.items()), flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "by_class_ms": classes}


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
    check(all(v == n_batches * 17 for v in launches.values()),
          f"{n_batches} x 17 launches per decode: {launches}")
    check(out.shape == VOLUME and out.dtype == np.float32 and bool(np.isfinite(out).all()),
          "decode output finite float32 of the volume's shape")
    for _ in range(2):
        t0 = time.perf_counter()
        decode()
        secs.append(time.perf_counter() - t0)
    profile = profile_decode(decode)
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
    check(all(v == 17 for v in sp_launches.values()), f"single pass launches {sp_launches}")
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
    for k, v in launches.items():
        results[k]["launches"] = v
        results[k]["launches_single_pass"] = sp_launches[k]
    results["instance_norm_act"]["launches"] = launches["instance_norm_apply"]
    results["instance_norm_act"]["launches_single_pass"] = sp_launches["instance_norm_apply"]
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
    check(all(v == 17 * batches for v in K.LAUNCHES.values()),
          f"CLI launches {K.LAUNCHES}, want 17 x {batches}")
    for i, shp in enumerate(shapes):
        src = nifti.load(workdir / "in" / f"v{i}.nii.gz")
        got = nifti.load(workdir / "out" / f"v{i}.nii.gz")
        check(got.data.shape == shp and bool(np.isfinite(got.data).all())
              and np.allclose(got.affine, src.affine, atol=1e-5),
              f"CLI output v{i}: shape, finite, affine")
    print(f"[cli] {len(shapes)} volumes in {secs:.2f} s (gzip IO included); "
          f"launches {dict(K.LAUNCHES)}", flush=True)


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
        "instance_norm_stats": {"replaces": f"{pallas}:86", "bound_by": "bytes"},
        "instance_norm_finalize": {"replaces": f"{pallas}:86", "bound_by": "bytes"},
        "instance_norm_apply": {"replaces": f"{pallas}:100", "bound_by": "bytes"},
        "instance_norm_act": {"replaces": f"{pallas}:108", "bound_by": "bytes",
                              "note": "the three launches together (_fwd); launches = "
                                      "forward norms"},
    }
    for k, r in results.items():
        r.update(name=k, route="cuda", source=src, shapes=[])

    phase_kernels(K, bw, flops, results)
    conv_rows = phase_conv_formats()
    tree = random_jax_tree(NGF, 6, SEED)
    phase_generator(K, tree)
    decode = phase_decode(K, tree, results)
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_cli(K, tree, Path(tmp))

    kernels = []
    for k, r in results.items():
        head = next(s for s in r["shapes"]
                    if s["path"] == "b8" and s["dtype"] == "bf16" and s["shape"][1] == NGF)
        check(r.get("launches", 0) > 0, f"{k} launched on the decode")
        kernels.append({
            "name": k, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": r["launches"], "max_abs_err": max(s["max_abs_err"] for s in r["shapes"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": head["library_ms"],
            "at": {"shape": head["shape"], "dtype": "bf16", "act": head["act"]},
            "launches_single_pass": r["launches_single_pass"],
            **({"note": r["note"]} if "note" in r else {})})
    summary = {"decode": decode, "conv_formats": conv_rows,
               "seconds": time.perf_counter() - t_start}
    print(json.dumps(summary))
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            {"gpu": card, **summary, "kernels": kernels,
             "shapes": {k: r["shapes"] for k, r in results.items()}}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
