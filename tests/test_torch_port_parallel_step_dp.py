"""The port's data-parallel step (mra_gan_tpu_torch/parallel/sharding.py)
on 2 gloo ranks of the CPU against the JAX package's
``make_sharded_train_step`` on 2 fake devices (tests/test_parallel.py
``test_dp_train_step_matches_single_device``'s configuration, batch 4 of
12^3): the 3-step loss trajectory at JAX's bars, the step-0 gradients
against the port's one-device step, the parameters bit-equal across ranks.
With dropout, the port's step on 2 ranks is its one-device step: the masks
are the global batch's, drawn from the state's generator."""
from __future__ import annotations

import numpy as np
import torch

from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state
from torch_port_parallel_ranks import rank_steps, start_ranks
from torch_port_util import _grad_close, one_device_steps, parallel_steps_match_jax


def test_dp_step_matches_jax_and_the_one_device_step(tmp_path):
    results = parallel_steps_match_jax(dict(ngf=4, ndf=4, n_layers_d=1, pool_size=3),
                                       (12, 12, 12), batch=4, data=2, space=1,
                                       tmp_path=tmp_path, bad_batches=[np.zeros((3, 12, 12, 12, 1),
                                                                                np.float32)])
    assert "not divisible by the data-axis size 2" in results[0]["errors"][0]


def test_dp_step_with_dropout_is_the_one_device_step(tmp_path):
    common = dict(ngf=4, ndf=4, n_layers_d=1, pool_size=2, no_dropout=False)
    patch = (12, 12, 12)
    cfg = CycleGANConfig(**common, dtype=torch.float32)
    nets = {n: net.state_dict() for n, net in create_state(cfg, 1, patch, "cpu").nets.items()}
    rs = np.random.RandomState(3)
    batches = [tuple(rs.uniform(-1, 1, (4, 1, *patch)).astype(np.float32) for _ in range(2))
               for _ in range(3)]
    wait = start_ranks(rank_steps, 2, tmp_path, common, patch, nets, batches, None, 2, 1, 2e-4)
    want_m, want_g, want_g64 = one_device_steps(cfg, nets, patch, batches, None)
    results = wait()
    for k in range(3):
        for name, w in want_m[k].items():
            for r in results:
                np.testing.assert_allclose(r["metrics"][k][name], w, rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {k}: {name}")
    _grad_close(results[0]["grads"], want_g, want_g64, "step-0 gradients with dropout")
    for name, sd in results[0]["params"].items():
        for key, v in sd.items():
            assert torch.equal(results[1]["params"][name][key], v), f"{name} {key}"
