"""Training dataset and loader (the port's copy of
mra_gan_tpu/data/dataset.py:46-406).

- **monai pipeline**: NIfTI pairs from ``<root>/images`` and
  ``<root>/labels`` -> orient to RAS -> z-score the image (labels raw) ->
  crop both to the image's foreground box -> pos/neg-weighted random patch
  starts (pos=20, neg=0); the deterministic prefix is cached on disk as raw
  ``.npy`` pairs and read back memory-mapped.
- **legacy pipeline**: 0-255 rescale -> optional spacing resample -> pad to
  the patch -> rejection-sampled random crop -> [-1, 1]; unpaired sampling
  draws a random label volume (``shuffle_labels``).

Every draw comes from a Philox generator keyed by (seed, epoch, volume), so
the batch stream is the JAX package's for the same seed. NIfTI volumes are
read by the native C++ reader and patches gathered by its threaded gather
(data/native.py, built at first use), as the JAX loader does; where the
library cannot be built, by the pure-Python reader (data/nifti.py) and
numpy, the JAX package's own fallbacks. Both give the same batches, bit for
bit (the reader's scl_slope/scl_inter rounds as numpy does). The loader
yields numpy (B, X, Y, Z, 1) float32 batches; the training driver lays them
out for the step. One departure from the JAX loader: a volume that fails to
load ends the epoch with its error, where the JAX loader's prefetch thread
drops the error and ends the epoch short.
"""
from __future__ import annotations

import hashlib
import os
import sys
import threading
import queue as queue_mod
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import native, nifti
from .transforms import (
    crop_foreground,
    pad_to_size,
    rand_crop_starts_by_pos_neg,
    random_crop_start,
    rescale_0_255,
    resample_to_spacing,
    to_ras,
    to_tanh_range,
    zscore_normalize,
)


class _AsyncCacheWriter:
    """Cache .npy persistence off the sampling path (the writes are pure
    side effects, and a cold epoch would otherwise wait on them). One
    daemon thread drains a BOUNDED queue
    (backpressure caps the extra volumes held in memory); a pending map
    lets same-process warm reads see in-flight arrays before they land on
    disk; atexit flush makes a clean exit durable. A write that dies
    mid-process just means a cache miss next run — the tmp+rename publish
    stays atomic."""

    def __init__(self, depth: int = 4):
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._pending: dict = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def submit(self, final_path: Path, arr: np.ndarray) -> None:
        with self._lock:
            if self._thread is None:
                import atexit

                atexit.register(self.flush)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, daemon=True)
                self._thread.start()
            self._pending[final_path] = arr
        self._q.put((final_path, arr))

    def get_pending(self, final_path: Path) -> Optional[np.ndarray]:
        with self._lock:
            return self._pending.get(final_path)

    def flush(self) -> None:
        """Block until every submitted write has been published. If the
        drain thread died (it shouldn't — _run catches everything), restart
        one rather than returning with writes still queued: a silent early
        return here would make warm-cache consumers measure a cold cache."""
        with self._lock:
            if (self._q.unfinished_tasks
                    and (self._thread is None or not self._thread.is_alive())):
                self._thread = threading.Thread(target=self._run, daemon=True)
                self._thread.start()
        self._q.join()

    def _run(self) -> None:
        while True:
            path, arr = self._q.get()
            tmp = path.with_name(
                path.name + f".tmp{os.getpid()}.{threading.get_ident()}")
            try:
                with open(tmp, "wb") as f:  # np.save(path) would append .npy
                    np.save(f, arr)
                os.replace(tmp, path)
            except Exception as e:  # disk full etc. — sampling must survive,
                # and the drain thread must not die with items still queued
                try:
                    tmp.unlink(missing_ok=True)  # don't accumulate orphans
                except OSError:
                    pass
                print(f"WARNING: cache write failed for {path}: {e}",
                      file=sys.stderr)
            finally:
                with self._lock:
                    if self._pending.get(path) is arr:
                        del self._pending[path]
                self._q.task_done()


_CACHE_WRITER = _AsyncCacheWriter()


def flush_cache_writes() -> None:
    """Wait for all in-flight preprocessing-cache writes to reach disk."""
    _CACHE_WRITER.flush()


def list_nifti(directory) -> List[Path]:
    """Sorted .nii/.nii.gz listing (reference lstFiles,
    utils/NiftiDataset.py:32)."""
    d = Path(directory)
    files = [p for p in d.iterdir()
             if p.name.endswith(".nii") or p.name.endswith(".nii.gz")]

    def key(p: Path):
        stem = p.name.split(".")[0]
        return (0, int(stem)) if stem.isdigit() else (1, stem)

    return sorted(files, key=key)


class UnpairedVolumeDataset:
    """Pairs of (image, label) volumes with optional unpaired label shuffling.

    pipeline='monai'  -> z-score image, raw label, fg-crop, pos/neg crop.
    pipeline='legacy' -> 0-255 both, optional resample, rejection crop, [-1,1].
    """

    def __init__(
        self,
        data_path,
        patch_size: Sequence[int] = (64, 64, 64),
        pipeline: str = "monai",
        num_samples: int = 2,
        shuffle_labels: bool = False,
        which_direction: str = "AtoB",
        resample: bool = False,
        new_resolution: Sequence[float] = (1, 1, 1),
        drop_ratio: float = 0.0,
        min_pixel: float = 0.1,
        cache_dir: Optional[str] = None,
        seed: int = 0,
    ):
        self.image_paths = list_nifti(Path(data_path) / "images")
        self.label_paths = list_nifti(Path(data_path) / "labels")
        if len(self.image_paths) != len(self.label_paths):
            raise ValueError(
                f"images/labels count mismatch: {len(self.image_paths)} vs "
                f"{len(self.label_paths)} under {data_path}")
        if not self.image_paths:
            raise ValueError(f"no NIfTI volumes under {data_path}/images")
        self.patch_size = [int(p) for p in patch_size]
        self.pipeline = pipeline
        self.num_samples = num_samples
        self.shuffle_labels = shuffle_labels
        self.which_direction = which_direction
        self.resample = resample
        self.new_resolution = new_resolution
        self.drop_ratio = drop_ratio
        # reference min_pixel is a percentage of the patch volume
        # (reference train.py:60): int(min_pixel * patch_voxels / 100)
        self.min_pixel = int(
            float(min_pixel) * np.prod(self.patch_size) / 100.0)
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.image_paths)

    # -- deterministic preprocessing (cached) --

    def _cache_key(self, img_path: Path, lbl_path: Path) -> Path:
        h = hashlib.sha1()
        for p in (img_path, lbl_path):
            st = os.stat(p)
            h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
        h.update(f"{self.pipeline}:{self.resample}:{self.new_resolution}".encode())
        return self.cache_dir / h.hexdigest()

    @staticmethod
    def _load(path) -> nifti.NiftiImage:
        """The native C++ reader, else the pure-Python one (JAX
        dataset.py:196-205)."""
        fast = native.load_nifti(path) if native.available() else None
        if fast is not None:
            data, affine = fast
            return nifti.NiftiImage(data=data, affine=affine)
        return nifti.load(path)

    def _preprocess(self, idx: int, lbl_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic per-volume preprocessing.

        RETURN CONTRACT: the arrays may be READ-ONLY (warm-cache hits are
        ``np.load(..., mmap_mode='r')`` views; cold paths return writable
        arrays). Consumers must not mutate in place — copy first (all
        current patch samplers do, via np.pad/fancy indexing, which copy).
        """
        img_path = self.image_paths[idx]
        lbl_path = self.label_paths[lbl_idx]
        if self.cache_dir:
            # raw .npy pair + mmap read: np.load of an .npz goes through
            # zipfile's Python-level reads, which hold the GIL and serialize
            # the worker threads; a memory map costs nothing up front and the
            # patch gather faults the pages in with the GIL released.
            ck = self._cache_key(img_path, lbl_path)
            ip = ck.with_suffix(".image.npy")
            lp = ck.with_suffix(".label.npy")

            # Per-file: pending first (async-written entries not yet on
            # disk hold the same content — the cache key hashes
            # path+size+mtime), then disk. Pending-before-disk and
            # per-file (not both-or-neither) close the window where the
            # writer has published one half of the pair and still queues
            # the other: publish happens before the pending-map delete, so
            # a pending miss guarantees the disk check sees the file.
            def _cached(p):
                arr = _CACHE_WRITER.get_pending(p)
                if arr is not None:
                    return arr
                return np.load(p, mmap_mode="r") if p.exists() else None

            ci, cl = _cached(ip), _cached(lp)
            if ci is not None and cl is not None:
                return ci, cl
        img = self._load(img_path)
        lbl = self._load(lbl_path)
        if self.pipeline == "monai":
            img = to_ras(img)
            lbl = to_ras(lbl)
            image = zscore_normalize(img.data)
            label = lbl.data.astype(np.float32)
            image, label, _ = crop_foreground(image, label)
        else:
            if self.resample:
                img = resample_to_spacing(img, self.new_resolution, "linear")
                lbl = resample_to_spacing(lbl, self.new_resolution, "linear")
            image = rescale_0_255(img.data)
            label = rescale_0_255(lbl.data)
        image = np.ascontiguousarray(image, np.float32)
        label = np.ascontiguousarray(label, np.float32)
        if self.cache_dir:
            # async atomic publish (writer thread does tmp + rename):
            # concurrent writers may race on the same pair — last rename
            # wins with identical content — and a reader never sees a torn
            # file. The arrays are never mutated after this point (sampling
            # only reads), so sharing them with the writer is safe.
            ck = self._cache_key(img_path, lbl_path)
            for arr, suffix in ((image, ".image.npy"), (label, ".label.npy")):
                _CACHE_WRITER.submit(ck.with_suffix(suffix), arr)
        return image, label

    # -- per-epoch sampling --

    @staticmethod
    def _gather(volume: np.ndarray, starts: np.ndarray, patch) -> np.ndarray:
        """(n, p0, p1, p2) patches of ``volume`` at ``starts``: the native
        threaded gather, else numpy (JAX dataset.py:274-285)."""
        vol = np.ascontiguousarray(volume, np.float32)
        if native.available():
            return native.extract_patches(vol, starts, tuple(patch))
        return np.stack([
            vol[s[0]:s[0] + patch[0], s[1]:s[1] + patch[1], s[2]:s[2] + patch[2]]
            for s in starts])

    def sample_patches(self, idx: int, epoch: int = 0,
                       keep: Optional[Sequence[int]] = None) -> List[Tuple[np.ndarray, np.ndarray]]:
        """num_samples (image_patch, label_patch) pairs for one volume,
        deterministic in (seed, epoch, idx). Outputs are (D,H,W,1) float32;
        legacy pipeline maps to [-1,1], monai leaves z-scored image / raw
        label (the reference's normalization split, SURVEY §2.2 #10).
        ``keep`` (ascending sample indices) gathers only those samples: every
        crop start is still drawn in order, so each kept pair is bit-equal to
        the same sample of the whole list."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[epoch, idx, 0, 0]))
        lbl_idx = int(rng.integers(len(self.label_paths))) if self.shuffle_labels else idx
        image, label = self._preprocess(idx, lbl_idx)
        if self.which_direction == "BtoA":
            image, label = label, image
        patch = self.patch_size
        if self.pipeline == "monai":
            image, label, starts = rand_crop_starts_by_pos_neg(
                image, label, patch, rng, num_samples=self.num_samples,
                pos=20.0, neg=0.0, image_threshold=-1.0)
        else:
            # legacy chain pads like the reference's Padding transform:
            # zero-extension at the high side (see transforms.pad_to_size)
            image = pad_to_size(image, patch, where="end")
            label = pad_to_size(label, patch, where="end")
            starts = np.stack([
                random_crop_start(image, label, patch, rng,
                                  self.drop_ratio, self.min_pixel)
                for _ in range(self.num_samples)])
        if keep is not None:
            starts = starts[np.asarray(keep, np.int64)]
        imgs = self._gather(image, starts, patch)
        lbls = self._gather(label, starts, patch)
        if self.pipeline != "monai":
            imgs = to_tanh_range(imgs)
            lbls = to_tanh_range(lbls)
        return [(imgs[i][..., None], lbls[i][..., None])
                for i in range(len(starts))]


class PatchLoader:
    """Epoch iterator yielding (image_batch, label_batch) numpy arrays of
    shape (B, D, H, W, 1) — the DataLoader(num_workers) equivalent
    (reference train.py:52).

    ``workers > 1`` preprocesses that many volumes concurrently in a thread
    pool (the heavy per-volume work — NIfTI decode, z-score, fg-crop — is
    numpy and releases the GIL), yielding in deterministic order; a
    separate prefetch thread overlaps batching with device compute. The
    batch stream is identical for any ``workers`` value.

    ``rows`` (lo, hi) makes a rank's view for data parallelism: each batch
    is rows lo:hi of the global batch, (hi - lo, D, H, W, 1), bit-equal to
    slicing the global view's. Stream position p = step * B + row is sample
    p % num_samples of volume order[p // num_samples], so the view samples
    only the volumes behind its rows (a volume whose samples straddle two
    ranks' rows is sampled by both) and gathers only its samples of each;
    it needs every volume to give exactly num_samples pairs, and raises
    where one does not."""

    def __init__(self, dataset: UnpairedVolumeDataset, batch_size: int = 1,
                 shuffle: bool = True, prefetch: int = 4, workers: int = 1,
                 rows: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = max(1, prefetch)
        self.workers = max(0, workers)
        if rows is not None and not 0 <= rows[0] < rows[1] <= batch_size:
            raise ValueError(f"rows {rows} are not a range of a batch of {batch_size}")
        self.rows = None if rows is None else (int(rows[0]), int(rows[1]))

    def _volume_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.Generator(np.random.Philox(
                key=self.ds.seed, counter=[epoch, 0, 0, 1])).shuffle(order)
        return order

    def _plan(self, epoch: int, positions) -> List[Tuple[int, Optional[List[int]]]]:
        """(volume index, the samples to gather or None for all of them) of
        ascending stream ``positions``, in stream order."""
        order, ns = self._volume_order(epoch), self.ds.num_samples
        plan: List[Tuple[int, List[int]]] = []
        for p in positions:
            j, k = divmod(int(p), ns)
            if plan and plan[-1][0] == j:
                plan[-1][1].append(k)
            else:
                plan.append((j, [k]))
        return [(int(order[j]), None if len(ks) == ns else ks) for j, ks in plan]

    def _sample(self, idx: int, epoch: int, keep: Optional[List[int]]):
        # the global view asks for whole volumes only, so any dataset with
        # the JAX loader's sample_patches(idx, epoch) still serves it
        if keep is None:
            return self.ds.sample_patches(idx, epoch)
        return self.ds.sample_patches(idx, epoch, keep)

    def _patch_stream(self, epoch: int, plan, exact: bool):
        def checked(idx, keep, pairs):
            want = self.ds.num_samples if keep is None else len(keep)
            if exact and len(pairs) != want:
                raise ValueError(f"volume {idx} gave {len(pairs)} samples, not {want}: a "
                                 f"rank's rows need num_samples ({self.ds.num_samples}) from "
                                 "every volume")
            return pairs

        if self.workers <= 1:
            for idx, keep in plan:
                yield from checked(idx, keep, self._sample(idx, epoch, keep))
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.workers) as ex:
            inflight: deque = deque()
            it = iter(plan)
            window = self.workers + self.prefetch
            for idx, keep in it:
                inflight.append((idx, keep, ex.submit(self._sample, idx, epoch, keep)))
                if len(inflight) >= window:
                    break
            while inflight:
                idx, keep, fut = inflight.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    nidx, nkeep = nxt
                    inflight.append((nidx, nkeep, ex.submit(self._sample, nidx, epoch, nkeep)))
                yield from checked(idx, keep, fut.result())

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.rows is None:
            plan = self._plan(epoch, range(len(self.ds) * self.ds.num_samples))
            size = self.batch_size
        else:
            lo, hi = self.rows
            plan = self._plan(epoch, (s * self.batch_size + r
                                      for s in range(self.steps_per_epoch())
                                      for r in range(lo, hi)))
            size = hi - lo
        return self._batches(self._patch_stream(epoch, plan, self.rows is not None), size)

    def first_pairs(self, epoch: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """The global view's first ``n`` pairs of ``epoch`` (at most the
        epoch's steps times B) as (n, D, H, W, 1) arrays, sampling only the
        volumes behind them."""
        n = min(n, self.steps_per_epoch() * self.batch_size)
        pairs = list(self._patch_stream(epoch, self._plan(epoch, range(n)), True))
        return np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])

    def _batches(self, stream, size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        def batches():
            imgs, lbls = [], []
            for ip, lp in stream:
                imgs.append(ip)
                lbls.append(lp)
                if len(imgs) == size:
                    yield np.stack(imgs), np.stack(lbls)
                    imgs, lbls = [], []

        if self.workers == 0:
            yield from batches()
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure = []

        def producer():
            try:
                for b in batches():
                    q.put(b)
            except Exception as e:  # raised again in the consumer below
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if failure:
            # a volume that fails to load ends the epoch with its error, never
            # silently short (the JAX loader's producer thread drops it)
            raise failure[0]

    def steps_per_epoch(self) -> int:
        return (len(self.ds) * self.ds.num_samples) // self.batch_size
