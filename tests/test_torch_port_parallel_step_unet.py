"""The port's depth-sharded train step with the U-Net generator on 2 gloo
ranks of the CPU against the JAX package's on 2 fake devices
(tests/test_parallel.py:212): unet_custom at 64 x 32 x 32 (shard depth 32,
its granularity; JAX's test takes 128 deep over 4 devices), ngf = ndf = 2.
The loss trajectory at JAX's bars over 2 steps as JAX's test takes them,
the step-0 gradients against the port's one-device step, the parameters
bit-equal across ranks."""
from __future__ import annotations

from torch_port_util import parallel_steps_match_jax


def test_unet_spatial_step_matches_jax(tmp_path):
    parallel_steps_match_jax(dict(ngf=2, ndf=2, net_g="unet_custom", n_layers_d=1, pool_size=0),
                             (64, 32, 32), batch=1, data=1, space=2, tmp_path=tmp_path,
                             steps=2)
