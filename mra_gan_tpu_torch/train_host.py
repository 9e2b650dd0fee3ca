"""Times the benchmark's train cell in one process before and after a traced
step, and where the host's time of a step goes.

    python -m mra_gan_tpu_torch.train_host [--seed 1] [--stages ...] [--wrappers]
        [--op-table N [--out PATH]]

The train step is paced by the card only while the host enqueues a step
faster than the card runs it. This script builds the cell's state at the
cell's batch and at batch 1, and reads, at each stage of one process:

- ``s_per_step``: the cell's window (``timed`` steps after ``warmup``),
  each step timed by CUDA events as ``bench.py`` times it, the median kept,
  and the block's mean wall seconds a step;
- ``enqueue_ms``: the host's milliseconds inside one batch-1 step call, the
  median of ``timed`` calls, each followed by a synchronize.

``--stages`` lists what the process does in order: ``time`` (a reading),
``trace`` (one step traced by ``profile_run``, as the benchmark and
``chip_smoke.py`` trace a step after timing one) and ``gc``
(``gc.collect()``); the default reads fresh, after a traced step, again,
and after a collection. Each reading prints one JSON object. With
``--op-table N``, torch.profiler's host table of N batch-1 steps follows
(also written to ``--out``). With ``--wrappers``, the host's microseconds
a call of each kernel wrapper and of the library calls beside them, at
the resnet's batch-1 residual shape, come first. The first line gives the
card's name and power limit and the host's cores. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

import torch

from . import bench as B
from .models.cycle_gan import create_state, make_train_step
from .utils.profiling import gpu_line, profile_run

CELL = "train-b8-p64"


def window(step, state, real_a, real_b, lr: float, steps: int) -> dict:
    """The cell's timed block: median s/step by CUDA events, mean wall."""
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, real_a, real_b, lr)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    per = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    return {"median": statistics.median(per), "mean_wall": wall}


def enqueue_ms(step, state, real_a, real_b, lr: float, steps: int) -> float:
    """Median host milliseconds inside a step call, the card idle at each call."""
    secs = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, real_a, real_b, lr)
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(secs) * 1e3


def host_us(fn, calls: int = 300) -> float:
    """Host microseconds a call of ``fn``, the median of three runs of
    ``calls`` calls after a warm-up (small shapes, so that the host sets
    the pace)."""
    for _ in range(20):
        fn()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def wrapper_costs(net) -> dict:
    """Host microseconds a call: the norm, pad, conv7 and conv4s2 wrappers
    (the last at one 32^3 sample, on the path the step's 64^3 takes),
    the autograd routes, the casts of ``net``'s parameters one by one and
    grouped, and library calls beside them."""
    import torch.nn.functional as F

    from .ops import conv
    from .ops import norm as N
    from .ops.kernels import conv4s2 as C4
    from .ops.kernels import instance_norm as K
    from .ops.kernels import replication_pad as RP

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cl = torch.channels_last_3d
    x = torch.randn(1, 128, 16, 16, 16, device=dev, dtype=bf16).contiguous(memory_format=cl)
    g = torch.randn_like(x)
    y, mean, rstd = K.instance_norm_slab(x, "relu")
    xr = x.detach().requires_grad_()
    xp = torch.randn(1, 128, 18, 18, 18, device=dev, dtype=bf16).contiguous(memory_format=cl)
    w3 = torch.randn(128, 128, 3, 3, 3, device=dev)
    w3b = w3.to(bf16)
    x7 = torch.randn(1, 1, 16, 16, 16, device=dev, dtype=bf16).contiguous(memory_format=cl)
    w7 = torch.randn(32, 1, 7, 7, 7, device=dev, requires_grad=True)
    x7r = x7.detach().requires_grad_()
    params = [p for p in net.parameters()]
    x4 = torch.randn(1, 1, 32, 32, 32, device=dev, dtype=bf16)
    w4 = torch.randn(32, 4, 4, 4, device=dev, dtype=bf16)
    b4 = torch.randn(32, device=dev, dtype=bf16)
    g4 = torch.randn(1, 32, 16, 16, 16, device=dev, dtype=bf16).contiguous(memory_format=cl)

    def norm_fwd_bwd():
        torch.autograd.grad(N.instance_norm_act(xr, act="relu"), xr, g)

    def pad_fwd_bwd():
        torch.autograd.grad(conv.replication_pad3d(xr, 1), xr, torch.ones_like(xp))

    def c7(route):
        def run():
            torch.autograd.grad(route(x7r, w7.to(bf16), None), (x7r, w7),
                                torch.ones(1, 32, 10, 10, 10, device=dev, dtype=bf16))
        return run

    def cast_each():
        return [p.to(bf16) for p in params]

    def cast_grouped():
        return conv.CastParams.apply(bf16, *params)

    return {
        "torch.empty": host_us(lambda: torch.empty((1, 128), device=dev)),
        "current_device": host_us(torch.cuda.current_device),
        "check_volume": host_us(lambda: K._check_volume(x, "x")),
        "norm slab fwd": host_us(lambda: K.instance_norm_slab(x, "relu")),
        "norm act fwd": host_us(lambda: K.instance_norm_act_fwd(x, "relu")),
        "norm bwd slab": host_us(lambda: K.instance_norm_bwd_slab(x, g, mean, rstd, "relu")),
        "norm Function fwd+bwd": host_us(norm_fwd_bwd),
        "pad fwd": host_us(lambda: RP.replication_pad_fwd(x, (1,) * 6)),
        "pad Function fwd+bwd": host_us(pad_fwd_bwd),
        "F.conv3d 3^3 fwd": host_us(lambda: F.conv3d(xp, w3b)),
        "c4s2 spread": host_us(lambda: C4.conv4s2_spread(x4, w4, b4, (1, 1, 1))),
        "c4s2 gather": host_us(lambda: C4.conv4s2_gather(g4, w4, (1, 1, 1), (32, 32, 32))),
        "c4s2 wgrad + reduce": host_us(lambda: C4.conv4s2_wgrad(x4, g4, (1, 1, 1))),
        "c7 custom op fwd+bwd": host_us(c7(conv.c7_convolution)),
        "c7 Function fwd+bwd": host_us(c7(conv.C7Convolution.apply)),
        "weight cast": host_us(lambda: w3.to(bf16)),
        f"{len(params)} casts one by one": host_us(cast_each, 50),
        f"{len(params)} casts grouped": host_us(cast_grouped, 50),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--op-table", type=int, default=0, metavar="N",
                    help="print torch.profiler's host table of N batch-1 steps")
    ap.add_argument("--stages", default="time,trace,time,time,gc,time",
                    help="comma list: time (a reading), trace (profile one step), gc")
    ap.add_argument("--wrappers", action="store_true",
                    help="first time the kernel wrappers' host side a call")
    ap.add_argument("--out", default=None, help="also write the host table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_host needs a CUDA card", file=sys.stderr)
        return 1
    spec = B.load_spec()
    cell = B.cells_of(spec)[CELL]
    cfg = B.config_of(spec, cell)
    p = cell["params"]
    dev = torch.device("cuda")
    patch, lr, steps, warmup = tuple(p["patch"]), p["lr"], p["timed"], p["warmup"]
    runs = {}
    for batch in (p["batch"], 1):
        real_a, real_b = (x.to(dev) for x in B.train_inputs(args.seed, batch, patch))
        state = create_state(cfg, args.seed, patch, dev)
        step = make_train_step(cfg)
        for _ in range(warmup):
            step(state, real_a, real_b, lr)
        runs[batch] = (step, state, real_a, real_b)
    torch.cuda.synchronize()
    print(json.dumps({"cell": CELL, "gpu": gpu_line(), "cores": len(os.sched_getaffinity(0)),
                      "torch": torch.__version__}), flush=True)
    big, one = runs[p["batch"]], runs[1]
    if args.wrappers:
        print(json.dumps({"host_us_per_call": wrapper_costs(one[1].g_a)}), flush=True)

    def stage(name: str) -> None:
        line = {"stage": name,
                "s_per_step": window(*big, lr, steps),
                "enqueue_ms": enqueue_ms(*one, lr, steps)}
        print(json.dumps(line), flush=True)

    done = []
    for action in args.stages.split(","):
        if action == "time":
            stage(" then ".join(done) or "fresh")
        elif action == "trace":
            profile_run(lambda: big[0](*big[1:], lr), "train_host")
        elif action == "gc":
            gc.collect()
        else:
            raise SystemExit(f"unknown stage {action!r}")
        done.append(action)
    if args.op_table:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
            for _ in range(args.op_table):
                one[0](*one[1:], lr)
            torch.cuda.synchronize()
        table = tprof.key_averages().table(sort_by="self_cpu_time_total", row_limit=70,
                                           max_name_column_width=70)
        if args.out:
            with open(args.out, "w") as f:
                f.write(table)
        print(table, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
