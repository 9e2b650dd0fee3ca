"""The port's depth-sharded train step (mra_gan_tpu_torch/parallel/spatial.py
``make_spatial_train_step``) on gloo ranks of the CPU against the JAX
package's on as many fake devices (tests/test_parallel.py
``test_spatial_train_step_matches_single_device``'s configuration: resnet,
16^3, batch 1, pool 2, 4 ranks, shard depth 4): the 3-step loss trajectory
at JAX's bars, the step-0 gradients against the port's one-device step, the
parameters bit-equal across ranks, and JAX's ValueError for a depth the
shards cannot take (``test_spatial_train_step_rejects_bad_depth``). The
spatial step refuses dropout, and under --remat recomputes in the shard
context."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig
from mra_gan_tpu_torch.parallel.spatial import make_spatial_train_step
from torch_port_parallel_ranks import rank_remat_backward, spawn_ranks
from torch_port_util import parallel_steps_match_jax


def test_spatial_step_matches_jax_and_the_one_device_step(tmp_path):
    results = parallel_steps_match_jax(
        dict(ngf=4, ndf=4, n_layers_d=1, pool_size=2, net_g="resnet_6blocks"), (16, 16, 16),
        batch=1, data=1, space=4, tmp_path=tmp_path,
        bad_batches=[np.zeros((1, 12, 16, 16, 1), np.float32),
                     np.zeros((1, 16, 16, 18, 1), np.float32)])
    depth, inplane = results[0]["errors"]
    assert "divisible by 4 and >= 4, got D=12" in depth
    assert "in-plane dims (16, 18) must be divisible" in inplane


def test_spatial_step_refuses_dropout():
    with pytest.raises(ValueError, match="no_dropout"):
        make_spatial_train_step(CycleGANConfig(ngf=4, no_dropout=False, dtype=torch.float32),
                                None)


def test_remat_recomputes_in_the_shard_context(tmp_path):
    """--remat recomputes each generator segment in the backward, which may
    run after the shard context has closed (on CUDA, autograd's own thread
    runs it); the recompute runs in a copy of the forward's context, so it
    exchanges its halos and merges its norms over the shards again. A
    generator's forward on 2 ranks, its backward outside the context: the
    gradients through the remat segments are bit-equal to the plain ones
    (without the restored context the recompute would pad locally and
    normalize each shard alone)."""
    gen = CycleGANConfig(ngf=4, dtype=torch.float32).build_generator(
        generator=torch.Generator().manual_seed(2))
    x = np.random.RandomState(5).uniform(-1, 1, (1, 1, 16, 16, 16)).astype(np.float32)
    for (plain_dx, plain_g), (remat_dx, remat_g) in spawn_ranks(
            rank_remat_backward, 2, tmp_path, gen.state_dict(), x):
        assert torch.equal(remat_dx, plain_dx)
        assert set(remat_g) == set(plain_g)
        for key, v in plain_g.items():
            assert torch.equal(remat_g[key], v), key
