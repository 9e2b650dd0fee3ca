"""Process groups for the port's parallel paths (counterpart of
mra_gan_tpu/core/mesh.py:22-51).

One process per rank. ``init_distributed`` joins the group that ``torchrun``
describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or a
``FileStore`` that the caller names (the tests, ``chip_smoke.py``).
``make_mesh(data, space)`` lays the world out as the JAX mesh does, a
(data, space) grid in row-major order, rank = d * space + s, and creates its
subgroups: one space group for each data index and one data group for each
space index. Every rank creates every subgroup in the same order, as
``dist.new_group`` requires.

The backend is ``nccl`` for CUDA ranks, each on its own card, and ``gloo``
for CPU ranks. Ranks may share one card only under ``gloo``, which NCCL
does not allow; the caller chooses that by naming the backend, and nothing
falls back to it.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from .spatial_ctx import ShardAxis

DATA_AXIS = "data"
SPACE_AXIS = "space"


def distributed_world() -> int:
    """The world size of the joined group, or of the one torchrun describes
    before it is joined; 1 without either."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device: Optional[Union[str, torch.device]] = None,
                     backend: Optional[str] = None, store_path: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the default process group and return this rank's device.

    Without ``store_path`` the group is torchrun's (``env://``); with it, a
    FileStore at that path with the given ``rank`` and ``world_size``.
    ``device`` 'cuda' (the default) takes card LOCAL_RANK under nccl, and
    the current card under gloo (ranks sharing it); 'cpu' takes gloo. An
    already joined group is kept."""
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if dev.type == "cpu" and backend == "nccl":
        raise ValueError("the nccl backend needs CUDA ranks; use gloo on the CPU")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (--device cpu) "
                               "to run the ranks on the CPU explicitly")
        if backend == "nccl" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is None:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        if rank is None or world_size is None:
            raise ValueError("a FileStore group needs rank and world_size")
        store = dist.FileStore(str(store_path), int(world_size))
        dist.init_process_group(backend, store=store, rank=int(rank),
                                world_size=int(world_size), timeout=timeout)
    return dev


@dataclasses.dataclass
class Mesh:
    """The (data, space) grid of ranks as this rank sees it: its axes (group,
    size, index) by name."""

    data: int
    space: int
    axes: Dict[str, ShardAxis]

    def axis(self, name: str) -> ShardAxis:
        return self.axes[name]

    def group(self, name: str):
        return self.axes[name].group


def make_mesh(data: Optional[int] = None, space: int = 1) -> Mesh:
    """The first data * space ranks as a (data, space) grid (default: every
    rank on the data axis), with its subgroups; a rank past the grid gets a
    Mesh without axes (the JAX driver's idle devices). Collective: every
    rank must call it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined process group (init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // space
    if data < 1 or data * space > world:
        raise ValueError(f"mesh {data}x{space} needs more than the {world} devices")
    mine = {}
    for d in range(data):  # one space group per data index
        ranks = [d * space + s for s in range(space)]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine[SPACE_AXIS] = ShardAxis(g, space, ranks.index(rank))
    for s in range(space):  # one data group per space index
        ranks = [d * space + s for d in range(data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine[DATA_AXIS] = ShardAxis(g, data, ranks.index(rank))
    return Mesh(data, space, mine)
