"""The port's depth-sharded train step with the DynUNet generator on 4 gloo
ranks of the CPU against the JAX package's on 4 fake devices
(tests/test_parallel.py:251): the (32, 32, 16) schedule at 32 x 32 x 16
(shard depth 8; a (2, 2, 1) stride level, kernel == stride upsamplers, a
bottleneck one row deep). The loss trajectory at JAX's bars over 2 steps as
JAX's test takes them, the step-0 gradients against the port's one-device
step, the parameters bit-equal across ranks, and JAX's ValueError for a
depth that breaks the schedule's shard granularity."""
from __future__ import annotations

import numpy as np

from torch_port_util import parallel_steps_match_jax


def test_dynet_spatial_step_matches_jax(tmp_path):
    results = parallel_steps_match_jax(
        dict(ngf=4, ndf=4, n_layers_d=1, pool_size=2, net_g="Dynet", dynet_sizes=(32, 32, 16),
             dynet_spacings=(1.5, 1.5, 1.5)), (32, 32, 16), batch=1, data=1, space=4,
        tmp_path=tmp_path, steps=2, bad_batches=[np.zeros((1, 20, 32, 16, 1), np.float32)])
    assert "divisible by 8 and >= 8, got D=20" in results[0]["errors"][0]
