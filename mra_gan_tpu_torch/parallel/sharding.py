"""The data-parallel CycleGAN step (counterpart of
mra_gan_tpu/parallel/sharding.py:38-113).

The batch is split over the ranks of the mesh's data axis, every rank
holding the whole state. Each rank runs the one-device step on its rows
inside ``data_sharding``: losses reduce over the axis, the gradients are
averaged over it in one flat bucket per optimizer, and the pools see the
global batch's fakes (models/cycle_gan.py). With dropout, the masks are the
global batch's, drawn from the state's generator, each rank keeping its
rows (models/networks.py ``Dropout``): the step is the one-device step, as
JAX's GSPMD fallback gives each device its slice of one global mask.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core.mesh import DATA_AXIS, SPACE_AXIS, Mesh
from ..core.spatial_ctx import data_sharding
from .collectives import broadcast_


def shard_state(state, mesh: Mesh):
    """Make every rank's state that of the mesh's first rank, bit for bit:
    the four networks' tensors, both optimizers' state tensors, both pools
    and their counts, both generators' states and the step are broadcast
    down the data axis, then along the space axis (collective over the
    mesh). In place; returns the state."""
    import torch.distributed as dist

    tensors = [t for net in state.nets.values() for t in net.state_dict().values()]
    tensors += [v for opt in (state.opt_g, state.opt_d) for st in opt.state.values()
                for v in st.values() if torch.is_tensor(v)]
    tensors += [state.pool_fake_a.images, state.pool_fake_b.images]
    gens = (state.generator, state.dropout_generator)
    gen_states = [gen.get_state() for gen in gens]
    scalars = [state.step, state.pool_fake_a.count, state.pool_fake_b.count]
    for name in (DATA_AXIS, SPACE_AXIS):
        axis = mesh.axis(name)
        if axis.size == 1:
            continue
        src = dist.get_global_rank(axis.group, 0)
        with torch.no_grad():
            for t in tensors + gen_states:
                broadcast_(t, src, axis.group)
        dist.broadcast_object_list(scalars, src, group=axis.group)
    for gen, gs in zip(gens, gen_states):
        gen.set_state(gs)
    state.step, state.pool_fake_a.count, state.pool_fake_b.count = scalars
    return state


def data_rows(batch: int, axis) -> slice:
    """This rank's rows of a global batch of ``batch`` along the data axis
    ``axis`` (a ShardAxis): the index-th of ``axis.size`` equal parts
    (ValueError where the axis does not divide the batch)."""
    if batch % axis.size:
        raise ValueError(f"batch {batch} not divisible by the data-axis size {axis.size}")
    rows = batch // axis.size
    return slice(axis.index * rows, (axis.index + 1) * rows)


def make_sharded_train_step(cfg, mesh: Mesh):
    """The data-parallel step over the mesh's data axis (JAX :43). Returns
    (step, take): ``take(x)`` returns this rank's rows of a global batch
    (``data_rows``), and ``take(x, local=True)`` a batch that already holds
    only them (a rank view's, data/dataset.py) as it is; ``step(state,
    real_a, real_b, lr, pool_draws=None)`` takes those rows and a state
    readied by ``shard_state``, and returns (state, the global metrics)."""
    from ..models.cycle_gan import make_train_step

    axis = mesh.axis(DATA_AXIS)
    base = make_train_step(cfg)

    def take(x: Union[torch.Tensor, np.ndarray], local: bool = False):
        return x if local else x[data_rows(x.shape[0], axis)]

    def step(state, real_a, real_b, lr, pool_draws=None):
        with data_sharding(axis, rows=real_a.shape[0]):
            return base(state, real_a, real_b, lr, pool_draws)

    return step, take
