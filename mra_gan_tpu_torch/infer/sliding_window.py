"""Full-volume sliding-window inference (counterpart of
mra_gan_tpu/infer/sliding_window.py:26,37,48).

One general path on the device replaces the JAX package's three (overlap-add,
depth-streamed, scan), which are TPU and transfer-tunnel designs; the
arithmetic is theirs: the clamped patch grid over the volume zero-padded up
to the patch size, every patch weighted by the blend window, an f32 sum of
outputs and of windows, and a division by max(window sum, 1e-8). The
reference's "+0.01 after dividing" bias is not reproduced, as in the JAX
package."""
from __future__ import annotations

import functools
import itertools
import threading
from concurrent import futures
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.spatial_ctx import spatial_shard_info
from ..models import networks
from ..models.cycle_gan import GenerateFn
from ..models.networks import BatchNorm3d


def compute_grid_starts(size: int, patch: int, stride: int) -> list:
    """Start offsets covering [0, size) with the last window clamped flush to
    the edge (the reference's boundary handling, test.py:111-145)."""
    if size <= patch:
        return [0]
    starts = list(range(0, size - patch + 1, stride))
    if starts[-1] != size - patch:
        starts.append(size - patch)
    return starts


def gaussian_window(patch_size: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    wins = []
    for p in patch_size:
        sigma = max(p * sigma_scale, 1.0)
        x = np.arange(p, dtype=np.float64) - (p - 1) / 2.0
        wins.append(np.exp(-0.5 * (x / sigma) ** 2))
    w = wins[0][:, None, None] * wins[1][None, :, None] * wins[2][None, None, :]
    w = np.maximum(w / w.max(), 1e-4)
    return w.astype(np.float32)


def patch_grid(shape: Sequence[int], patch: Sequence[int], strides: Sequence[int]) -> list:
    """Every (x, y, z) patch start of the clamped grid over ``shape`` padded
    up to the patch size, in the JAX package's order."""
    padded = [max(s, p) for s, p in zip(shape, patch)]
    axes = [compute_grid_starts(padded[a], patch[a], strides[a]) for a in range(3)]
    return [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]


def per_call(generate_fn, batch: int) -> int:
    """The patches one call of ``generate_fn`` takes: ``batch``, or 1 for a
    generator that holds a ``BatchNorm3d`` (``--norm batch``), whose output
    for one patch depends on the others in its batch."""
    net = getattr(generate_fn, "net", None)
    if net is not None and any(isinstance(m, BatchNorm3d) for m in net.modules()):
        return 1
    return int(batch)


@torch.inference_mode()
def sliding_window_inference(volume: np.ndarray, generate_fn, patch_size=(64, 64, 64),
                             stride_inplane: int = 32, stride_layer: int = 32,
                             blend: str = "gaussian", batch: int = 4,
                             transfer_dtype: torch.dtype = torch.float32,
                             input_transfer_dtype: Optional[torch.dtype] = None,
                             graphs: bool = True) -> np.ndarray:
    """volume: (X, Y, Z) float32 in the generator's input range, mapped to the
    generator's (D, H, W); stride_inplane covers X and Y, stride_layer Z, like
    the reference. generate_fn: a models.cycle_gan.GenerateFn, (B, 1, px, py,
    pz) -> same shape. The volume goes to the device once and the result
    comes back once, float32 (X, Y, Z) on the host. The last batch may be
    short. ``batch`` is the patches a generator call takes; a generator that
    holds a batch norm (``--norm batch``), whose statistics are its batch's,
    takes one a call, the reference's batch of 1. So every patch is
    normalized alone, and ``batch`` changes the amortization only.

    The two dtypes set only the precision on the wire (JAX
    sliding_window.py:56-86); the blending is float32 on the device.
    ``input_transfer_dtype`` is the upload's, by default the generator's
    compute dtype, which is exact: the generator's first op casts to it
    anyway. ``transfer_dtype`` is the download's: float32 is exact, float16
    rounds the [-1, 1] result to about 5e-4.

    Both transfers go in slabs along X (``transfer_marks``): a batch waits
    only for the planes its patches read, and the planes no later patch
    reaches are divided and sent back while the device works on the rest.

    On a card a ``GenerateFn``'s forward is replayed from CUDA graphs
    (``_Graphed``), the same kernels on the same inputs, so the same bits;
    ``graphs=False`` runs every batch eagerly."""
    if blend not in ("gaussian", "uniform"):
        raise ValueError(f"unknown blend {blend!r}")
    patch = tuple(int(p) for p in patch_size)
    strides = (int(stride_inplane), int(stride_inplane), int(stride_layer))
    dev = torch.device(generate_fn.device)
    vshape = volume.shape
    padded = tuple(max(v, p) for v, p in zip(vshape, patch))
    in_dtype = generate_fn.dtype if input_transfer_dtype is None else input_transfer_dtype
    starts = patch_grid(vshape, patch, strides)
    batch = per_call(generate_fn, batch)
    batches = [starts[i:i + batch] for i in range(0, len(starts), batch)]
    win, wsum = _blend_weights(padded, patch, strides, blend, dev)
    io = _Transfers(volume, padded, in_dtype, transfer_dtype, dev)
    graphed = _Graphed.take(generate_fn) if graphs and _graphs_apply(generate_fn, dev) else None
    run = graphed or generate_fn
    try:
        acc = torch.zeros(padded, dtype=torch.float32, device=dev)
        for chunk, (need, final) in zip(batches, transfer_marks(batches, patch[0], vshape[0])):
            vol = io.upload_to(need)
            x = torch.stack([vol[a:a + patch[0], b:b + patch[1], c:c + patch[2]]
                             for a, b, c in chunk])[:, None]
            out = run(x)[:, 0].float() * win
            for (a, b, c), o in zip(chunk, out):
                acc[a:a + patch[0], b:b + patch[1], c:c + patch[2]].add_(o)
            io.download_to(final, acc, wsum)
    finally:
        io.finish()
        if graphed is not None:
            graphed.release()
    return io.host_out.numpy().astype(np.float32, copy=False)


def transfer_marks(batches: Sequence[Sequence[tuple]], patch_x: int, size_x: int) -> list:
    """For each batch of patch starts, in order: (need, final). ``need`` is
    the X planes of the volume that must be on the device before the batch
    runs (every plane its patches read, and all those of earlier batches);
    ``final`` is the planes whose sums are whole once it has run (those
    below every later patch's start). Both rise to ``size_x``, ``final``
    reaching it at the last batch."""
    later = size_x
    finals = []
    for chunk in reversed(batches):
        finals.append(min(later, size_x))
        later = min([later] + [a for a, _, _ in chunk])
    marks, need = [], 0
    for chunk, final in zip(batches, reversed(finals)):
        need = max([need] + [min(a + patch_x, size_x) for a, _, _ in chunk])
        marks.append((need, final))
    return marks


def _graphs_apply(generate_fn, dev: torch.device) -> bool:
    """Whether the decode replays ``generate_fn`` from CUDA graphs: a
    ``GenerateFn`` on a card, outside a depth shard's context (whose halo
    exchanges go through the host), a dispatch mode (FlopCounterMode sees
    ops, not a replay) and another capture."""
    return (dev.type == "cuda" and isinstance(generate_fn, GenerateFn)
            and spatial_shard_info() is None and not _DISPATCH_MODES()
            and not torch.cuda.is_current_stream_capturing())


# the number of dispatch modes on the stack (FlopCounterMode, FakeTensorMode)
_DISPATCH_MODES = getattr(torch._C, "_len_torch_dispatch_stack", lambda: 1)


def _route(net: torch.nn.Module) -> tuple:
    """What a generator's forward runs besides its input's shape: each
    parameter's and buffer's storage and version, the norm the networks call
    (the plain version under ``utils.profiling.plain_norms``) and the
    determinism settings."""
    return (tuple((t.data_ptr(), t._version) for t in itertools.chain(net.parameters(),
                                                                      net.buffers())),
            networks.instance_norm_act, torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32)


def _counters() -> tuple:
    """The kernel wrappers' counters, dicts of ints changed in place."""
    from ..ops.kernels import conv4s2, conv7, instance_norm, replication_pad
    return (instance_norm.LAUNCHES, instance_norm.SHARDED_LAUNCHES,
            instance_norm.GRAD_RELAYOUTS, conv7.LAUNCHES, conv7.GRAD_RELAYOUTS,
            replication_pad.LAUNCHES, replication_pad.RELAYOUTS, conv4s2.LAUNCHES,
            conv4s2.RELAYOUTS)


def _capture(fn, x: torch.Tensor, pool):
    """(graph, output, pool): ``fn(x)`` recorded into a CUDA graph whose
    memory comes from ``pool`` (a new pool where None). Only this thread's
    calls are checked while it records: the decode's transfer worker goes on."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        y = fn(x)
    return graph, y, graph.pool()


class _Graphed:
    """A ``GenerateFn``'s forward replayed from CUDA graphs, one a patch
    batch shape, kept on the ``GenerateFn`` from one decode to the next.

    The enqueue of a patch batch is the generator's ~70 launches, each
    through Python, aten and a wrapper; on a busy host it takes longer than
    the card's work. A replay enqueues the same kernels on the same inputs
    in one call. The first batch of a shape runs eagerly (it builds the
    kernels, the weights' casts and cuDNN's plans); the second records the
    graph and replays it, as does every later one. The graphs of a
    ``GenerateFn`` share one memory pool: a replay's output is read before
    the next replay is enqueued on the same stream. Each replay adds to the
    wrappers' counters the launches its recording counted, which are taken
    back (recording launches nothing), so the counters go on counting each
    kernel run on the card once. The graphs are kept while ``_route`` stays
    as it was; a new parameter value, the plain norms or another
    determinism setting drops them all. One decode at a time holds a
    ``GenerateFn``'s graphs (``take``, ``release``): their buffers are
    shared, and a decode has ended on the card when it returns."""

    def __init__(self, generate_fn: GenerateFn, lock: threading.Lock):
        self.fn, self.lock = generate_fn, lock
        route = _route(generate_fn.net)
        held = getattr(generate_fn, "_graphs", None)
        if held is None or held["route"] != route:
            held = {"route": route, "pool": None, "seen": set(), "graphs": {}}
            generate_fn._graphs = held
        self.held = held

    @classmethod
    def take(cls, generate_fn: GenerateFn) -> Optional["_Graphed"]:
        """The graphs of ``generate_fn`` for one decode, or None while
        another decode holds them (that one then runs eagerly)."""
        lock = generate_fn.__dict__.setdefault("_graphs_lock", threading.Lock())
        if not lock.acquire(blocking=False):
            return None
        try:
            return cls(generate_fn, lock)
        except BaseException:
            lock.release()
            raise

    def release(self) -> None:
        self.lock.release()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        key = (tuple(x.shape), x.stride(), x.dtype)
        graphs, seen = self.held["graphs"], self.held["seen"]
        if key not in graphs:
            if key not in seen:
                seen.add(key)
                return self.fn(x)
            graphs[key] = self._record(x)
        graph, x_in, y, counts, _ = graphs[key]
        x_in.copy_(x)
        graph.replay()
        for counter, add in zip(_counters(), counts):
            for k, n in add.items():
                counter[k] += n
        return y

    def _record(self, x: torch.Tensor) -> tuple:
        counters = _counters()
        before = [dict(c) for c in counters]
        x_in = torch.empty_like(x)
        try:
            graph, y, self.held["pool"] = _capture(self.fn, x_in, self.held["pool"])
            counts = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
                      for c, b in zip(counters, before)]
        finally:
            for c, b in zip(counters, before):
                c.update(b)
        # the weights' casts the graph reads (ops/conv.py ``_cast``) stay alive
        casts = [getattr(p, "_mra_cast", None) for p in self.fn.net.parameters()]
        return graph, x_in, y, counts, casts


class _Transfers:
    """The volume's slabs up to the device and the result's back. On a card
    the upload is cast on the host into a pinned buffer and copied on a
    stream of its own, which the compute stream waits for; each finished
    slab of the sum is divided in place, copied into a pinned buffer on
    the copy stream, and moved into the result's host pages by a worker
    thread, which first touches those fresh pages. On the CPU each slab is
    cast or divided in place. The pinned buffers are kept for the calling
    thread: the upload's is rewritten only once its last copy has ended,
    the download's once the last call's worker jobs have, which ``finish``
    waits for."""

    def __init__(self, volume: np.ndarray, padded: tuple, in_dtype: torch.dtype,
                 out_dtype: torch.dtype, dev: torch.device):
        self.host = torch.from_numpy(np.ascontiguousarray(volume, np.float32))
        self.shape, self.out_dtype = tuple(self.host.shape), out_dtype
        make = torch.empty if self.shape == padded else torch.zeros
        self.vol = make(padded, dtype=in_dtype, device=dev)
        self.host_out = torch.empty(self.shape, dtype=out_dtype)
        self.uploaded = self.downloaded = 0
        self.cuda = dev.type == "cuda"
        self.jobs = []
        if self.cuda:
            self.compute = torch.cuda.current_stream(dev)
            self.copy = _copy_stream(dev)
            self.stage = _pinned("up", self.shape, in_dtype)
            self.out_stage = _pinned("down", self.shape, out_dtype)[0]
            self.copy.wait_stream(self.compute)  # the blocks it writes are free

    def upload_to(self, need: int) -> torch.Tensor:
        x0, x1 = self.uploaded, need
        if x1 > x0:
            y, z = self.shape[1:]
            if not self.cuda:
                self.vol[x0:x1, :y, :z].copy_(self.host[x0:x1])
            else:
                stage, ended = self.stage
                if x0 == 0:
                    ended.synchronize()
                stage[x0:x1].copy_(self.host[x0:x1])
                with torch.cuda.stream(self.copy):
                    self.vol[x0:x1, :y, :z].copy_(stage[x0:x1], non_blocking=True)
                    ended.record(self.copy)
                self.compute.wait_stream(self.copy)
                if x0 == 0:
                    self.jobs.append(_worker().submit(_touch, self.host_out))
            self.uploaded = x1
        return self.vol

    def download_to(self, final: int, acc: torch.Tensor, wsum: torch.Tensor) -> None:
        x0, x1 = self.downloaded, final
        if x1 <= x0:
            return
        y, z = self.shape[1:]
        # no later patch adds to these planes, so they are divided in place
        part = acc[x0:x1].div_(wsum[x0:x1])[:, :y, :z].to(self.out_dtype)
        if not self.cuda:
            self.host_out[x0:x1].copy_(part)
        else:
            stage = self.out_stage
            self.copy.wait_stream(self.compute)
            part.record_stream(self.copy)  # a cast's block waits for the copy
            with torch.cuda.stream(self.copy):
                stage[x0:x1].copy_(part, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.copy)
            self.jobs.append(_worker().submit(_drain, done, self.host_out[x0:x1], stage[x0:x1]))
        self.downloaded = x1

    def finish(self) -> None:
        # every job ends, even where the decode raised; then the first error
        futures.wait(self.jobs)
        for job in self.jobs:
            job.result()


def _touch(t: torch.Tensor) -> None:
    with torch.inference_mode():
        t.zero_()


def _drain(done: torch.cuda.Event, dst: torch.Tensor, src: torch.Tensor) -> None:
    done.synchronize()
    with torch.inference_mode():
        dst.copy_(src)


@functools.lru_cache(maxsize=None)
def _worker() -> futures.ThreadPoolExecutor:
    return futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="decode-transfers")


@functools.lru_cache(maxsize=None)
def _copy_stream(dev: torch.device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(dev)


_staging = threading.local()


def _pinned(role: str, shape: tuple, dtype: torch.dtype):
    """(a pinned host buffer, the event its last copy records) for the
    calling thread, remade only where the shape or dtype changes."""
    held = getattr(_staging, role, None)
    if held is None or held[0] != (shape, dtype):
        held = ((shape, dtype), torch.empty(shape, dtype=dtype, pin_memory=True),
                torch.cuda.Event())
        setattr(_staging, role, held)
    return held[1:]


@functools.lru_cache(maxsize=4)
def _blend_weights(padded: tuple, patch: tuple, strides: tuple, blend: str,
                   dev: torch.device):
    """(window, max(window sum, 1e-8)) on ``dev`` for a volume padded to
    ``padded``: the sum over the patch grid, added patch by patch in the
    grid's order, depends only on the geometry, so it is made once a shape."""
    win_np = gaussian_window(patch) if blend == "gaussian" else np.ones(patch, np.float32)
    with torch.inference_mode():
        win = torch.from_numpy(win_np).to(dev)
        wsum = torch.zeros(padded, dtype=torch.float32, device=dev)
        for a, b, c in patch_grid(padded, patch, strides):
            wsum[a:a + patch[0], b:b + patch[1], c:c + patch[2]] += win
        return win, wsum.clamp_min(1e-8)
