"""The shard context (counterpart of mra_gan_tpu/core/spatial_ctx.py:27-96).

Inside ``spatial_sharding(group)`` every rank of ``group`` holds an equal
depth shard of each volume, rank r rows [r D/K, (r + 1) D/K), and the pad,
conv, norm and loss code becomes shard-aware: depth padding is a halo
exchange with the neighbours (ops/conv.py ``extend_sharded_d``), instance
norms merge the statistics of all K shards (ops/norm.py), and loss
reductions cover every shard. ``data_group`` (or ``data_sharding(group)``
alone) says the batch is split over another group as well: losses then
reduce over it too, and the train step reduces gradients and gathers its
pool over it; convs and norms are per sample and do not consult it.

The JAX package reads its context while tracing. The port reads it when a
module runs, so two things follow: autograd's backward runs after the
``with`` block has closed, so every function whose backward communicates
keeps the group it saw in its forward; and a recompute under
``torch.utils.checkpoint`` runs in the backward too, so the train step's
remat puts the context back for it (models/cycle_gan.py ``_checkpointed``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardAxis:
    """One mesh axis as a rank sees it: the process group (None: the
    default world group), its size and this rank's index in it; on the
    batch axis of a step, ``rows``, the batch rows each rank holds (the
    data-parallel dropout draws the global mask from it)."""

    group: object
    size: int
    index: int
    rows: int = 0

    @classmethod
    def of(cls, group=None, rows: int = 0) -> "ShardAxis":
        return cls(group, dist.get_world_size(group), dist.get_rank(group), rows)


_SPACE: contextvars.ContextVar = contextvars.ContextVar("mra_torch_spatial_shard",
                                                        default=None)
_DATA: contextvars.ContextVar = contextvars.ContextVar("mra_torch_data_shard", default=None)


def spatial_shard_info() -> Optional[ShardAxis]:
    """The depth-shard axis inside ``spatial_sharding``, else None."""
    return _SPACE.get()


def data_shard_info() -> Optional[ShardAxis]:
    """The batch axis inside ``data_sharding`` or a 2-D ``spatial_sharding``,
    else None."""
    return _DATA.get()


def shard_axes() -> List[ShardAxis]:
    """The axes the current context shards over (space, then data): what
    losses and gradients reduce over."""
    return [a for a in (_SPACE.get(), _DATA.get()) if a is not None]


def _axis(group, rows: int = 0) -> ShardAxis:
    if isinstance(group, ShardAxis):
        return dataclasses.replace(group, rows=rows) if rows else group
    return ShardAxis.of(group, rows)


@contextlib.contextmanager
def spatial_sharding(group=None, data_group=None, rows: int = 0):
    """Depth-shard context over ``group`` (a process group, None for the
    world, or a ShardAxis); with ``data_group`` the batch is split over it
    too (the 2-D data x space grid), ``rows`` rows a rank."""
    tok = _SPACE.set(_axis(group))
    tok2 = _DATA.set(_axis(data_group, rows) if data_group is not None else None)
    try:
        yield
    finally:
        _SPACE.reset(tok)
        _DATA.reset(tok2)


@contextlib.contextmanager
def data_sharding(group=None, rows: int = 0):
    """Batch-only context (the data-parallel step, ``rows`` rows a rank):
    losses reduce over ``group``, the step reduces gradients and gathers
    its pool over it; convs and norms stay per sample."""
    tok = _DATA.set(_axis(group, rows))
    try:
        yield
    finally:
        _DATA.reset(tok)


@contextlib.contextmanager
def spatial_unsharded():
    """Clear the depth-shard context for code that runs on gathered
    full-depth volumes inside a sharded step (the discriminators)."""
    tok = _SPACE.set(None)
    try:
        yield
    finally:
        _SPACE.reset(tok)
