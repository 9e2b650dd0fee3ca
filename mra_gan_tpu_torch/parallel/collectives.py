"""The port's collectives over ``torch.distributed`` process groups: the
counterparts of ``lax.psum``/``pmean`` (``all_reduce_``), ``lax.all_gather``
(``all_gather``, differentiable, and ``all_gather_stacked``) and
``lax.ppermute`` between depth neighbours (``neighbour_exchange``,
differentiable), as the JAX package uses them inside ``shard_map``
(mra_gan_tpu/ops/conv.py:96-128, parallel/spatial.py:388,
models/cycle_gan.py:280-287, 425-460).

Every function takes the group explicitly (None is the default world group)
and works on contiguous tensors in the standard layout; a channels_last_3d
input is copied into one first and the result is laid out as the input was.

The backend picks the transport. Under ``nccl`` the tensors stay on their
card (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``batch_isend_irecv``). Under ``gloo`` a CUDA tensor is staged through a
host copy inside the helper: that is how ranks that share one card (which
NCCL refuses) run the CUDA paths, and a group on the CPU needs no staging.
The choice is made from the group's backend, never by catching an error,
and each staged call is counted in ``HOST_STAGED`` by operation.

Every collective waits on its work through ``_wait``. Inside
``watch_for_abort(key)`` that wait looks at the process group's store while
the work is pending, so a rank that leaves the mesh mid-step (the
memory preflight's out-of-memory error, core/memory.py) can end its peers
wherever they wait: it publishes ``key`` (``publish_abort``) and the peers'
waits raise ``MeshAborted``. Destroying or aborting a gloo group does not
close its connections while the process still holds it, so the peers must
learn of it themselves. Under nccl a wait that finds the key first aborts
the communicators (ncclCommAbort), ending the pending NCCL kernel that the
stream would otherwise wait on forever. Outside a watch every wait is the
plain blocking one.

Gradients follow one rule (see models/cycle_gan.py): each rank
differentiates its own loss, every collective's backward is its true
adjoint, and the train step averages the parameter gradients over the
ranks. So ``all_gather``'s backward is a reduce-scatter (the sum of every
rank's cotangent for this rank's block), and ``neighbour_exchange``'s
returns each received halo's gradient to the rank it came from, where it
is added.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# operation -> calls whose CUDA tensors went through a host copy (gloo)
HOST_STAGED: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
                               "send_recv": 0, "broadcast": 0}
# a watched wait looks at the store this often (and, under nccl, at its work
# every WORK_POLL_S)
STORE_POLL_S = 0.01
WORK_POLL_S = 2e-4


class MeshAborted(RuntimeError):
    """A rank of the mesh published the watched key: it will not finish the
    collective this rank waits on."""


class AbortWatch:
    """The store key that ``watch_for_abort`` polls; ``tripped`` says
    whether a wait of this process found it."""

    def __init__(self, key: str):
        self.key = key
        self.store = dist.distributed_c10d._get_default_store()
        self.nccl = dist.get_backend() == "nccl"
        self.tripped = False

    def published(self) -> bool:
        return self.store.check([self.key])

    def trip(self):
        self.tripped = True
        if self.nccl:  # end the NCCL kernels this rank's stream waits on
            dist.distributed_c10d._abort_process_group()
        raise MeshAborted(f"a rank of the mesh published {self.key!r}")

    def wait(self, work) -> None:
        """``work.wait()``, looking at the store while it is pending. A gloo
        wait blocks the thread that calls it (and completes a send or a
        receive, whose ``is_completed`` stays false until then), so it runs
        on a thread of its own; an nccl work is polled, so that the host
        never runs ahead of a pending NCCL kernel."""
        if self.nccl:
            next_look = 0.0
            while not work.is_completed():
                if time.monotonic() >= next_look:
                    if self.published():
                        self.trip()
                    next_look = time.monotonic() + STORE_POLL_S
                time.sleep(WORK_POLL_S)
            work.wait()
            return
        failure = []

        def blocking():
            try:
                work.wait()
            except RuntimeError as e:  # raised again below, in the caller
                failure.append(e)

        waiter = threading.Thread(target=blocking, daemon=True)
        waiter.start()
        waiter.join(STORE_POLL_S)
        while waiter.is_alive():
            if self.published():
                self.trip()  # the thread stays blocked until the leaver's connections close
            waiter.join(STORE_POLL_S)
        if failure:
            if self.published():
                self.trip()
            raise failure[0]


# the active watch: process-wide, since autograd's backward waits on its own
# thread for a CUDA tensor
_WATCH: Optional[AbortWatch] = None


@contextlib.contextmanager
def watch_for_abort(key: str) -> Iterator[AbortWatch]:
    """Inside, every collective of this process looks at the process group's
    store for ``key`` while it waits, and raises ``MeshAborted`` once the key
    is there (also where the collective failed because a rank left). Not
    reentrant."""
    global _WATCH
    if _WATCH is not None:
        raise RuntimeError("watch_for_abort is already active")
    _WATCH = AbortWatch(key)
    try:
        yield _WATCH
    finally:
        _WATCH = None


def publish_abort(key: str) -> None:
    """Tell every watching rank of the group that this one left: set ``key``
    in the process group's store."""
    dist.distributed_c10d._get_default_store().set(key, str(dist.get_rank()))


def _wait(work) -> None:
    watch = _WATCH
    if watch is None:
        work.wait()
    else:
        watch.wait(work)


# torch >= 2.10 names the tensor forms *_single; earlier releases have only
# the *_tensor names, with the same signatures
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    return dist.get_rank(group)


def host_staged(t: torch.Tensor, group=None) -> bool:
    """True where a collective on ``t`` goes through a host copy: a CUDA
    tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def memory_format_of(x: torch.Tensor) -> torch.memory_format:
    """channels_last_3d for a CUDA volume laid out so (the generator's
    layout on the card), else the standard one."""
    if x.is_cuda and x.dim() == 5 and not x.is_contiguous() \
            and x.is_contiguous(memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    return torch.contiguous_format


def all_reduce_(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor (``op`` 'sum' or 'max');
    returns it. Every rank ends with the same bits."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if not t.is_contiguous():
        raise ValueError("all_reduce_ needs a contiguous tensor")
    if host_staged(t, group):
        HOST_STAGED["all_reduce"] += 1
        host = t.cpu()
        _wait(dist.all_reduce(host, red, group=group, async_op=True))
        return t.copy_(host)
    _wait(dist.all_reduce(t, red, group=group, async_op=True))
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast from global rank ``src``; returns ``t``. A CPU
    tensor (a generator's state) crosses an nccl group through the current
    card."""
    if not t.is_contiguous():
        plain = t.contiguous()
        broadcast_(plain, src, group)
        return t.copy_(plain)
    if host_staged(t, group):
        HOST_STAGED["broadcast"] += 1
        host = t.cpu()
        _wait(dist.broadcast(host, src, group=group, async_op=True))
        return t.copy_(host)
    if not t.is_cuda and dist.get_backend(group) == "nccl":
        on_card = t.to(torch.device("cuda", torch.cuda.current_device()))
        _wait(dist.broadcast(on_card, src, group=group, async_op=True))
        return t.copy_(on_card)
    _wait(dist.broadcast(t, src, group=group, async_op=True))
    return t


def all_gather_stacked(t: torch.Tensor, group=None) -> torch.Tensor:
    """(K, *t.shape): every rank's t (at least 1-D), rank-major, the same on
    every rank. No gradient."""
    k = group_size(group)
    src = _plain(t)
    flat = (k * src.shape[0], *src.shape[1:])
    if host_staged(src, group):
        HOST_STAGED["all_gather"] += 1
        host = torch.empty((k, *src.shape), dtype=src.dtype)
        _wait(_ALL_GATHER(host.view(flat), src.cpu(), group=group, async_op=True))
        return host.to(src.device)
    out = torch.empty((k, *src.shape), dtype=src.dtype, device=src.device)
    _wait(_ALL_GATHER(out.view(flat), src, group=group, async_op=True))
    return out


def _reduce_scatter(stacked: torch.Tensor, group=None) -> torch.Tensor:
    # (K, *s) -> (*s): the sum over the K ranks' stacks of this rank's block
    out_shape = stacked.shape[1:]
    src = _plain(stacked)
    flat_in = src.view(-1, *out_shape[1:])
    if host_staged(src, group):
        HOST_STAGED["reduce_scatter"] += 1
        host = torch.empty(out_shape, dtype=src.dtype)
        _wait(_REDUCE_SCATTER(host, flat_in.cpu(), group=group, async_op=True))
        return host.to(src.device)
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    _wait(_REDUCE_SCATTER(out, flat_in, group=group, async_op=True))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.k = group, dim, group_size(group)
        ctx.fmt = memory_format_of(x)
        stacked = all_gather_stacked(x, group)
        return torch.cat(stacked.unbind(0), dim=dim).contiguous(memory_format=ctx.fmt)

    @staticmethod
    def backward(ctx, g):
        blocks = torch.stack(g.chunk(ctx.k, dim=ctx.dim))
        return (_reduce_scatter(blocks, ctx.group).contiguous(memory_format=ctx.fmt),
                None, None)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order (JAX
    ``lax.all_gather(..., tiled=True)``), the same on every rank. Its
    backward is the reduce-scatter: the gradient of x is the sum over the
    ranks of their output gradients' block for this rank."""
    return _AllGather.apply(x, group, dim)


def _exchange(sends: Sequence[Tuple[int, torch.Tensor]],
              recvs: Sequence[Tuple[int, torch.Size]], like: torch.Tensor,
              group=None) -> List[torch.Tensor]:
    """Point-to-point: send each (group rank, tensor) and receive each
    (group rank, shape) as one batch; returns the received tensors on
    ``like``'s device and dtype."""
    staged = host_staged(like, group)
    if staged:
        HOST_STAGED["send_recv"] += 1
    dev = torch.device("cpu") if staged else like.device
    out = [torch.empty(shape, dtype=like.dtype, device=dev) for _, shape in recvs]
    ops = [dist.P2POp(dist.isend, _plain(t).to(dev), dist.get_global_rank(group, peer)
                      if group is not None else peer, group)
           for peer, t in sends]
    ops += [dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer)
                       if group is not None else peer, group)
            for (peer, _), buf in zip(recvs, out)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            _wait(work)
    return [t.to(like.device) for t in out]


def _boundary(x: torch.Tensor, rows: int, edge_row: slice, boundary: str) -> torch.Tensor:
    if boundary == "edge":
        return x[:, :, edge_row].expand(-1, -1, rows, -1, -1)
    return x.new_zeros((*x.shape[:2], rows, *x.shape[3:]))


class _NeighbourExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, boundary, group):
        k, r, d = group_size(group), group_rank(group), x.shape[2]
        if lo > d or hi > d:
            raise ValueError(f"a halo of {lo}/{hi} rows needs a shard depth >= {max(lo, hi)}, "
                             f"got {d}")
        ctx.lo, ctx.hi, ctx.boundary, ctx.group = lo, hi, boundary, group
        ctx.shape, ctx.fmt = x.shape, memory_format_of(x)
        sends, recvs = [], []
        if lo and r + 1 < k:  # my last lo rows are the upper halo of rank r + 1
            sends.append((r + 1, x[:, :, d - lo:]))
        if hi and r > 0:      # my first hi rows are the lower halo of rank r - 1
            sends.append((r - 1, x[:, :, :hi]))
        shape = lambda rows: torch.Size((*x.shape[:2], rows, *x.shape[3:]))  # noqa: E731
        if lo and r > 0:
            recvs.append((r - 1, shape(lo)))
        if hi and r + 1 < k:
            recvs.append((r + 1, shape(hi)))
        got = iter(_exchange(sends, recvs, x, group))
        upper = (next(got) if r > 0 else _boundary(x, lo, slice(0, 1), boundary)) if lo else None
        lower = (next(got) if r + 1 < k else _boundary(x, hi, slice(d - 1, d), boundary)) \
            if hi else None
        out = torch.empty((*x.shape[:2], lo + d + hi, *x.shape[3:]), dtype=x.dtype,
                          device=x.device, memory_format=ctx.fmt)
        if lo:
            out[:, :, :lo] = upper
        out[:, :, lo:lo + d] = x
        if hi:
            out[:, :, lo + d:] = lower
        return out

    @staticmethod
    def backward(ctx, g):
        lo, hi, group, shape = ctx.lo, ctx.hi, ctx.group, ctx.shape
        k, r, d = group_size(group), group_rank(group), shape[2]
        dx = torch.empty(shape, dtype=g.dtype, device=g.device, memory_format=ctx.fmt)
        dx.copy_(g[:, :, lo:lo + d])
        g_up, g_low = g[:, :, :lo], g[:, :, lo + d:]
        sends, recvs = [], []
        if lo and r > 0:      # the upper halo came from rank r - 1's last rows
            sends.append((r - 1, g_up))
        if hi and r + 1 < k:  # the lower halo came from rank r + 1's first rows
            sends.append((r + 1, g_low))
        if lo and r + 1 < k:
            recvs.append((r + 1, torch.Size((*shape[:2], lo, *shape[3:]))))
        if hi and r > 0:
            recvs.append((r - 1, torch.Size((*shape[:2], hi, *shape[3:]))))
        got = iter(_exchange(sends, recvs, g, group))
        if lo and r + 1 < k:
            dx[:, :, d - lo:] += next(got)
        if hi and r > 0:
            dx[:, :, :hi] += next(got)
        if ctx.boundary == "edge":  # the broadcast edge row's gradient sums into it
            if lo and r == 0:
                dx[:, :, :1] += g_up.sum(2, keepdim=True)
            if hi and r + 1 == k:
                dx[:, :, d - 1:] += g_low.sum(2, keepdim=True)
        return dx, None, None, None, None


def neighbour_exchange(x: torch.Tensor, lo: int, hi: int, boundary: str = "edge",
                       group=None) -> torch.Tensor:
    """Extend the depth axis (dim 2) of rank r's shard (N, C, D/K, H, W) by
    ``lo`` rows above and ``hi`` below: rank r - 1's last ``lo`` rows and
    rank r + 1's first ``hi``, received from them, and at the volume's two
    ends the edge row repeated (``boundary='edge'``) or zeros ('zero'), as
    padding the whole volume would give (JAX ``extend_sharded_d``). Needs
    lo, hi <= D/K. Its backward sends each halo's gradient back to the rank
    it came from, which adds it to its rows, and sums an edge halo's
    gradient into the edge row."""
    if boundary not in ("edge", "zero"):
        raise ValueError(f"unknown boundary {boundary!r}")
    return _NeighbourExchange.apply(x, int(lo), int(hi), boundary, group)
