"""The port's CycleGAN train step (mra_gan_tpu_torch/models/cycle_gan.py)
against the JAX package's jitted ``make_train_step``, on the CPU in float32.

Both start from the JAX ``create_state`` weights (carried into the port by
``checkpoint.io.load_jax_nets``), with pool_size = 0 so that no random draw
is involved, and take three steps on the same numpy batches. Tolerances:

- losses at rtol 1e-4 * 10^k at step k. Step 0 is the exact comparison
  (measured <= 1.2e-6). After it the two frameworks' parameters differ:
  Adam with beta1 = 0.5 moves every element by about +-lr whatever its
  gradient's size, so an element whose gradient sits at the float32 noise
  floor (|g| ~ 1e-7 of the net's scale; one such sign flip in g_a at step 0
  with seed 0) steps the other way in the two frameworks, and each such
  step flips more small gradients at the next. Measured over 4 seeds and
  both modes: step 1 <= 1.6e-4, step 2 between 1.3e-6 (no flip) and
  4.7e-3. A wrong gradient fails step 0 outright, and the elementwise
  gradients are held in test_torch_port_train_grads.py;
- parameters after K = 3 steps: Adam moves each element by about +-lr per
  step whatever the gradient's size, so an element whose gradient sits at
  the float32 noise floor walks in a direction that depends on summation
  order. Held to max |diff| <= 2 K lr (opposite walks) and mean |diff| <=
  0.15 K lr (sparse noise, not a bias); the biases that both frameworks
  freeze (norm-dead) must not move at all.

The raw gradients are held elementwise in test_torch_port_train_grads.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.models.cycle_gan import make_train_step as jax_make_train_step
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step

from torch_port_util import (
    STEP_LR,
    STEP_PATCH,
    dead_bias_keys,
    jax_state_dicts,
    paired_train_states,
    to_ncdhw,
)

STEPS = 3


def _compare_params(state, jstate, n_steps: int) -> None:
    want = jax_state_dicts(jstate.g_params, jstate.d_params)
    for name, net in state.nets.items():
        got = net.state_dict()
        dead = dead_bias_keys(net)
        assert set(got) == set(want[name])
        for key, w in want[name].items():
            diff = (got[key] - w).abs()
            where = f"after {n_steps} steps: {name} {key}"
            if key in dead:
                assert float(diff.max()) == 0.0, f"{where}: a norm-dead bias moved"
                continue
            assert float(diff.max()) <= 2 * n_steps * STEP_LR * 1.05, (
                f"{where}: max |diff| {float(diff.max()):.2e} exceeds the Adam walk bound")
            assert float(diff.mean()) <= 0.15 * n_steps * STEP_LR, (
                f"{where}: mean |diff| {float(diff.mean()):.2e}, a systematic divergence")


@pytest.mark.parametrize("gan_mode", ["lsgan", "vanilla"])
def test_three_steps_match_jax(gan_mode):
    jcfg, jstate, cfg, state = paired_train_states(gan_mode)
    jstep = jax.jit(jax_make_train_step(jcfg), donate_argnums=0)
    step = make_train_step(cfg)
    rs = np.random.RandomState(42)
    for k in range(STEPS):
        a = rs.uniform(-1.0, 1.0, (1, *STEP_PATCH, 1)).astype(np.float32)
        b = rs.uniform(-1.0, 1.0, (1, *STEP_PATCH, 1)).astype(np.float32)
        jstate, want = jstep(jstate, jnp.asarray(a), jnp.asarray(b),
                             jax.random.PRNGKey(k), STEP_LR)
        want = jax.device_get(want)
        same, got = step(state, to_ncdhw(a), to_ncdhw(b), STEP_LR)
        assert same is state and state.step == k + 1
        assert set(got) == set(want)
        for name, w in want.items():
            assert got[name].dtype.is_floating_point and got[name].dim() == 0
            np.testing.assert_allclose(float(got[name]), float(w), rtol=1e-4 * 10 ** k,
                                       atol=1e-6, err_msg=f"step {k}: {name} ({gan_mode})")
    _compare_params(state, jstate, STEPS)


def test_step_with_a_pool_on_the_cpu():
    """pool_size 3 at batch 2: the pools fill over two steps, the metrics are
    ten finite float32 scalars, and the norm-dead biases keep no gradient."""
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=2, pool_size=3, gan_mode="lsgan")
    state = create_state(cfg, 3, STEP_PATCH, device="cpu")
    step = make_train_step(cfg)
    rs = np.random.RandomState(5)
    for k in range(3):
        a, b = (torch.from_numpy(rs.uniform(-1, 1, (2, 1, *STEP_PATCH)).astype(np.float32))
                for _ in range(2))
        _, metrics = step(state, a, b, STEP_LR)
        assert state.pool_fake_a.count == state.pool_fake_b.count == min(2 * (k + 1), 3)
        assert len(metrics) == 10 and all(bool(torch.isfinite(v)) for v in metrics.values())
    for net in state.nets.values():
        dead = dead_bias_keys(net)
        assert all((p.grad is None) == (k in dead) for k, p in net.named_parameters())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_state(CycleGANConfig(ngf=4, ndf=4))
