"""Serving daemon: ``python -m mra_gan_tpu_torch.serve`` (counterpart of the
JAX package's ``serve.py``:46-282). One process keeps one generator loaded
and decodes volumes as they arrive in a watched directory:

    python -m mra_gan_tpu_torch.serve --watch in_dir --result out_dir \\
        --checkpoints_dir ./checkpoints --name myrun --model_suffix _A

Each ``.nii``/``.nii.gz`` that appears in ``--watch`` is decoded into
``--result`` under the same name, by the decode CLI's ``inference``. The
rules are the JAX daemon's:

- a file is picked up only once its (size, mtime) is the same in two scans
  in a row, so a half-copied upload never reaches the decoder; a file whose
  content changes after it was served is served again once it settles
  ("done" is kept per signature, not per name), and so is a file deleted
  and then restored;
- results are written under a hidden temporary name in the result
  directory and renamed into place, so a reader never sees a partial file;
- the next file's read overlaps this one's decode, and writes go behind it
  on a second thread, at most four pending;
- a file that cannot be read is logged to ``<result>/failed.log`` and never
  retried at that signature; a decode that fails is retried at the next
  poll, up to MAX_DECODE_ATTEMPTS times;
- ``--once`` drains what is present and exits; otherwise the loop runs until
  ``--stop_file`` appears (checked between volumes too) or SIGINT.

The flags are the decode CLI's (``mra_gan_tpu_torch.options.test_options``),
``--device`` included, plus ``--watch``, ``--poll_secs``, ``--once`` and
``--stop_file``.
"""
from __future__ import annotations

import argparse
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence, Tuple

from . import test as test_cli
from .data import nifti
from .options import test_options

# A decode that raises is retried this many times per (name, signature)
# before the signature is retired; a file that cannot be read is retired at
# once, since reading the same bytes again cannot succeed.
MAX_DECODE_ATTEMPTS = 3


def build_serve_parser() -> argparse.ArgumentParser:
    """ServeOptions: the decode CLI's flags and the daemon's own."""
    p = test_options.build_parser()
    p.prog = "python -m mra_gan_tpu_torch.serve"
    p.description = "Serve full-volume CycleGAN decodes over a watched directory."
    p.add_argument("--watch", type=str, required=True,
                   help="directory to watch for input volumes")
    p.add_argument("--poll_secs", type=float, default=2.0, help="directory scan interval")
    p.add_argument("--once", action="store_true",
                   help="drain the volumes currently present, then exit")
    p.add_argument("--stop_file", type=str, default="",
                   help="path whose appearance stops the daemon cleanly (checked every "
                        "poll and between volumes)")
    return p


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return test_options.parse(argv, build_serve_parser())


_tmp_counter = itertools.count()


def _atomic_save(result: nifti.NiftiImage, path: Path) -> None:
    """Write ``result`` under a hidden temporary name beside ``path`` (with
    the real suffix, which picks gzip) and rename it over ``path``. The
    counter makes the name unique per call, so two writes to one target in
    flight at once never share a temporary file."""
    tmp = path.parent / f".tmp-{os.getpid()}-{next(_tmp_counter)}-{path.name}"
    try:
        nifti.save(result, tmp)
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def _scan(watch: Path) -> dict:
    """{name: (size, mtime)} of the .nii/.nii.gz files in ``watch``; hidden
    names (editors' swap files, temporary writes) are skipped."""
    out = {}
    for p in watch.iterdir():
        if p.name.startswith("."):
            continue
        if p.name.endswith((".nii", ".nii.gz")) and p.is_file():
            try:
                st = p.stat()
            except OSError:  # deleted between the listing and the stat
                continue
            out[p.name] = (st.st_size, st.st_mtime)
    return out


def _ready(cur: dict, prev: dict, done: dict) -> list:
    """Names to serve this poll: the signature is the same as in the last
    scan, and is not the one already served."""
    return sorted(n for n, sig in cur.items() if prev.get(n) == sig and done.get(n) != sig)


def _drained(cur: dict, done: dict) -> bool:
    """--once exit test: everything present has been served at its current
    signature (files still settling keep the loop polling)."""
    return all(done.get(n) == sig for n, sig in cur.items())


def _log_failure(failed_log: Path, name: str, stage: str, e: Exception) -> None:
    with open(failed_log, "a") as f:
        f.write(f"{name}\t{stage}\t{e}\n")


def main(argv: Optional[Sequence[str]] = None) -> Tuple[int, int]:
    """Serve until stopped; returns (volumes served, failures)."""
    opt = parse(argv)
    test_cli.refuse_unported(opt)
    watch = Path(opt.watch)
    out_dir = Path(opt.result)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not watch.is_dir():
        raise SystemExit(f"--watch {watch} is not a directory")
    if watch.resolve() == out_dir.resolve():
        # the daemon's own outputs would match the scan and be decoded again
        raise SystemExit("--watch and --result must be different directories")
    stop_file = Path(opt.stop_file) if opt.stop_file else None
    failed_log = out_dir / "failed.log"

    gen = test_cli.load_generator(opt)
    done: dict = {}  # name -> signature served
    prev: dict = {}
    attempts: dict = {}  # (name, signature) -> decode failures
    served = failures = 0
    print(f"serving {watch} -> {out_dir} "
          f"({'drain once' if opt.once else f'poll every {opt.poll_secs}s'})", flush=True)
    with ThreadPoolExecutor(max_workers=2) as io_pool:
        save_futures = []  # (result path, start time, future)

        def finish_save(entry) -> None:
            nonlocal served, failures
            res_path, t_start, fut = entry
            name = Path(res_path).name
            try:
                fut.result()
                served += 1
                print(f"served {name} ({time.perf_counter() - t_start:.2f}s)", flush=True)
            except Exception as e:
                failures += 1
                print(f"FAILED WRITE {name}: {e}", flush=True)
                _log_failure(failed_log, name, "write", e)

        def drain_saves(block: bool) -> None:
            remaining = []
            for entry in save_futures:
                if not block and not entry[2].done():
                    remaining.append(entry)
                    continue
                finish_save(entry)
            # each pending write holds a whole float volume: block on the
            # oldest rather than let the queue outrun the writer
            while not block and len(remaining) > test_cli.MAX_PENDING_WRITES:
                finish_save(remaining.pop(0))
            save_futures[:] = remaining

        def settle_saves_for(res_path: str) -> None:
            # one write per target at a time, so that an older signature's
            # write can never land after, and over, a newer one's
            keep = []
            for entry in save_futures:
                if entry[0] == res_path:
                    finish_save(entry)
                else:
                    keep.append(entry)
            save_futures[:] = keep

        stopping = False
        try:
            while not stopping:
                cur = _scan(watch)
                # forget vanished names, so that a file deleted and restored
                # (even with the same size and mtime) is served again
                done = {n: sig for n, sig in done.items() if n in cur}
                attempts = {k: v for k, v in attempts.items() if k[0] in cur}
                ready = _ready(cur, prev, done)
                prev = cur
                read_fut = None  # the prefetched read of the current name
                for i, name in enumerate(ready):
                    if stop_file is not None and stop_file.exists():
                        print("stop file found, exiting", flush=True)
                        stopping = True
                        break
                    sig = cur[name]
                    done[name] = sig
                    sub = argparse.Namespace(**vars(opt))
                    sub.image = str(watch / name)
                    sub.result = str(out_dir / name)
                    t_start = time.perf_counter()
                    nxt = (io_pool.submit(nifti.load, str(watch / ready[i + 1]))
                           if i + 1 < len(ready) else None)
                    try:
                        img = read_fut.result() if read_fut is not None else nifti.load(sub.image)
                    except Exception as e:
                        failures += 1
                        print(f"FAILED {name}: {e}", flush=True)
                        _log_failure(failed_log, name, "decode", e)
                        read_fut = nxt
                        continue
                    try:
                        result = test_cli.inference(sub, gen, img=img, save=False)
                        settle_saves_for(sub.result)
                        save_futures.append((sub.result, t_start, io_pool.submit(
                            _atomic_save, result, Path(sub.result))))
                        attempts.pop((name, sig), None)
                    except Exception as e:
                        failures += 1
                        n_try = attempts.get((name, sig), 0) + 1
                        attempts[(name, sig)] = n_try
                        retry = n_try < MAX_DECODE_ATTEMPTS
                        if retry:
                            del done[name]
                        print(f"FAILED {name} (attempt {n_try}"
                              f"{', will retry' if retry else ', giving up'}): {e}", flush=True)
                        _log_failure(failed_log, name, "decode", e)
                    read_fut = nxt
                    drain_saves(block=False)
                if stopping:
                    break
                if opt.once and _drained(cur, done):
                    break
                if stop_file is not None and stop_file.exists():
                    print("stop file found, exiting", flush=True)
                    break
                if not ready:
                    drain_saves(block=False)  # report finished or failed writes
                    time.sleep(opt.poll_secs)
        except KeyboardInterrupt:
            print("interrupted, draining pending writes", flush=True)
        drain_saves(block=True)
    print(f"served {served} volume(s), {failures} failure(s)", flush=True)
    return served, failures


if __name__ == "__main__":
    main()
