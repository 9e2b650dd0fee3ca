"""Times the benchmark's decode cell while other processes keep the host's
cores busy.

    python -m mra_gan_tpu_torch.decode_load [--loads 0 6 8 12] [--volumes 20] [--seed 1]

The decode is paced by the card only while the host enqueues a patch batch
faster than the card runs it, and its upload and download take host time
besides; a host shared with other work slows both. For each count in
``--loads`` the script starts that many processes that spin on the CPU,
decodes the cell's volume ``--volumes`` times back to back (each output
dropped, then each kept, as ``bench.py`` keeps them), stops the processes,
and prints one JSON object: the median, the 75th percentile, the least and
the most seconds per volume of each run. The first line gives the host's
cores, the card's name and power limit, and a hash of one decoded volume
(equal hashes mean equal bits). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Sequence

import torch

from . import bench as B
from .models.cycle_gan import make_generate_fn
from .utils.profiling import gpu_line

CELL = "decode-sw-128x256x256"


def spinners(n: int) -> list:
    """``n`` processes that spin on the CPU until they are killed."""
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(n)]


def seconds(decode: Callable[[], object], volumes: int, keep: bool) -> dict:
    """Wall seconds per call of ``decode``: median, 75th percentile, least, most."""
    kept, secs = [], []
    for _ in range(volumes):
        t0 = time.perf_counter()
        out = decode()
        secs.append(time.perf_counter() - t0)
        if keep:
            kept.append(out)
    s = sorted(secs)
    return {"median": statistics.median(s), "p75": s[int(0.75 * len(s))], "min": s[0],
            "max": s[-1]}


def under_load(decode: Callable[[], object], loads: Sequence[int], volumes: int):
    """One result per count of spinning processes; the processes of each
    count are stopped before the next starts, also where a decode raises."""
    for load in loads:
        procs = spinners(load)
        try:
            time.sleep(0.5)
            yield {"load": load, "dropped": seconds(decode, volumes, False),
                   "kept": seconds(decode, volumes, True)}
        finally:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loads", type=int, nargs="+", default=[0, 6, 8, 12])
    ap.add_argument("--volumes", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_load needs a CUDA card", file=sys.stderr)
        return 1
    spec = B.load_spec()
    cell = B.cells_of(spec)[CELL]
    dev = torch.device("cuda")
    gen = make_generate_fn(B.config_of(spec, cell), "g_a", dev, seed=args.seed)
    run = B._decoder(cell, B.decode_volume(args.seed, cell["params"]["volume"]))
    for _ in range(cell["params"]["warmup"]):
        run(gen)
    digest = hashlib.sha1(run(gen).tobytes()).hexdigest()
    print(json.dumps({"cell": CELL, "cores": len(os.sched_getaffinity(0)), "gpu": gpu_line(),
                      "sha1": digest}), flush=True)
    for line in under_load(lambda: run(gen), args.loads, args.volumes):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
