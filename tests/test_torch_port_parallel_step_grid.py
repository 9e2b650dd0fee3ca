"""The port's 2-D data x space step (``make_spatial_train_step`` with a data
axis) on 4 gloo ranks of the CPU, a 2 x 2 grid, against the JAX package's on
4 fake devices (tests/test_parallel.py
``test_dp_x_sp_train_step_matches_single_device``'s configuration: resnet,
16^3, batch 2, pool 3; shard depth 8): the 3-step loss trajectory at JAX's
bars (the pool all-gathered over the data axis keeps the reference's exact
sequential pool), the step-0 gradients against the port's one-device step,
the parameters bit-equal across ranks, and JAX's ValueError for a batch the
data axis does not divide."""
from __future__ import annotations

import numpy as np

from torch_port_util import parallel_steps_match_jax


def test_data_x_space_step_matches_jax_and_the_one_device_step(tmp_path):
    results = parallel_steps_match_jax(
        dict(ngf=4, ndf=4, n_layers_d=1, pool_size=3, net_g="resnet_6blocks"), (16, 16, 16),
        batch=2, data=2, space=2, tmp_path=tmp_path,
        bad_batches=[np.zeros((1, 16, 16, 16, 1), np.float32)])
    assert "batch 1 not divisible by the data-axis size 2" in results[0]["errors"][0]
