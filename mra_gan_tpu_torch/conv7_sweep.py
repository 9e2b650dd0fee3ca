"""Times conv7_gather at every tiling its plan can choose, on the card.

    python -m mra_gan_tpu_torch.conv7_sweep [--json-out FILE]

For each of the gather's shapes on the port's paths (the head forward at
the step's N = 16 and 8 and the decode's last batch of 3, the stem's input
gradient at N = 16 and 8, the single pass's head forward at N = 1) it times
each depth of ``conv7.GATHER_DEPTHS`` at each row split of
``conv7.GATHER_ROW_SPLITS`` and checks that every tiling gives the same bits.
It then prints, for several weights of an input-row load in
``conv7.gather_plan``'s cost model (``GATHER_LOAD_COST`` among them), the
tiling the model picks and its time against the fastest: the data to refit
the weight, or to replace the model by a simpler rule. One JSON object a
line; the last is the summary. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from mra_gan_tpu_torch.ops.kernels import conv7 as C7

NGF = 32
# (role, N, pad, the input's edge or box)
CASES = (
    ("head forward", 16, 0, (70, 70, 70)),
    ("head forward", 8, 0, (70, 70, 70)),
    ("head forward", 3, 0, (70, 70, 70)),
    ("stem input grad", 16, 6, (64, 64, 64)),
    ("stem input grad", 8, 6, (64, 64, 64)),
    ("single pass head forward", 1, 0, (134, 262, 262)),
)
LOAD_COSTS = (0.0, 0.3, C7.GATHER_LOAD_COST, 1.0, 2.0)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of back-to-back calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sweep_case(role: str, n: int, pad: int, box, gen) -> dict:
    x = torch.randn((n, NGF, *box), generator=gen, device="cuda").bfloat16()
    x = x.contiguous(memory_format=torch.channels_last_3d)
    w = (torch.randn((NGF, 7, 7, 7), generator=gen, device="cuda") / 64).bfloat16()
    b = (0.1 * torch.randn((1,), generator=gen, device="cuda")).bfloat16()
    out_box = C7.out_shape(box, pad)
    resident = C7.gather_resident(x)
    xt = C7.segments(out_box[2], C7.GATHER_MAX_SEGMENT)[1]
    times, ref, same = {}, None, True
    for zt in C7.GATHER_DEPTHS:
        for split in C7.GATHER_ROW_SPLITS:
            tile = (min(zt, out_box[0]), -(-out_box[1] // split), xt)
            if tile in times:
                continue
            plan = C7._plan(n, out_box, tile, resident)
            y = C7.gather_launch(x, w, b, pad, plan)
            ref = y if ref is None else ref
            same = same and torch.equal(y, ref)
            times[tile] = device_ms(lambda: C7.gather_launch(x, w, b, pad, plan))
    best = min(times, key=times.get)
    picks = {}
    for cost in LOAD_COSTS:
        tile = C7.gather_plan(n, out_box, resident, pad, cost).tile
        picks[str(cost)] = {"tile": list(tile), "ms": times[tile],
                            "over_best": times[tile] / times[best] - 1}
    return {"role": role, "n": n, "pad": pad, "box": list(box), "resident": resident,
            "same_bits": same, "best": {"tile": list(best), "ms": times[best]},
            "picks": picks,
            "times": [{"tile": list(t), "ms": ms} for t, ms in sorted(times.items())]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default="", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv7_sweep needs a CUDA card", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(7)
    lines = []
    for role, n, pad, box in CASES:
        row = sweep_case(role, n, pad, box, gen)
        lines.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    summary = {"gpu": gpu, "same_bits": all(r["same_bits"] for r in lines), "load_costs": {}}
    for cost in LOAD_COSTS:
        picked = sum(r["picks"][str(cost)]["ms"] for r in lines)
        summary["load_costs"][str(cost)] = {
            "sum_ms": picked, "sum_best_ms": sum(r["best"]["ms"] for r in lines),
            "worst_over_best": max(r["picks"][str(cost)]["over_best"] for r in lines)}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0 if summary["same_bits"] else 1


if __name__ == "__main__":
    sys.exit(main())
