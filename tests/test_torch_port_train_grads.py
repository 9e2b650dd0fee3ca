"""The raw, pre-Adam gradients of the port's train step against ``jax.grad``
of the same G and D losses assembled from the JAX package's public pieces
(its networks in the cell layout its step uses, ``gan_loss`` and
``l1_loss``), as tests/test_torch_parity_step.py assembles them. On the
CPU in float32, pool_size = 0, from the same initial weights.

After one step every port parameter's ``.grad`` holds the gradient the step
applied. Held elementwise to 1e-4 of the network's largest gradient: the
two frameworks take sums in other orders (measured agreement ~1e-6 of the
scale). A norm-dead bias has no gradient in the port (None) and exactly 0
in JAX, which stop_gradients it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mra_gan_tpu.ops.losses import gan_loss, l1_loss
from mra_gan_tpu.ops.s2d import space_to_depth
from mra_gan_tpu_torch.models.cycle_gan import make_train_step

from torch_port_util import (
    STEP_LR,
    STEP_PATCH,
    dead_bias_keys,
    jax_state_dicts,
    paired_train_states,
    to_ncdhw,
)


def _jax_grads(jcfg, jstate, a, b):
    g_a, g_b, d_a, d_b = (n.clone(cells_io=True) for n in jcfg.build_nets())
    ra, rb = space_to_depth(jnp.asarray(a), 4), space_to_depth(jnp.asarray(b), 4)
    mode, lam, idt = jcfg.gan_mode, jcfg.lambda_a, jcfg.lambda_a * jcfg.lambda_identity
    d_params = jstate.d_params

    def g_loss(gp):
        fake_b = g_a.apply(gp["g_a"], ra, train=True)
        fake_a = g_b.apply(gp["g_b"], rb, train=True)
        loss = (gan_loss(d_a.apply(d_params["d_a"], fake_b, train=True), True, mode)
                + gan_loss(d_b.apply(d_params["d_b"], fake_a, train=True), True, mode)
                + l1_loss(g_b.apply(gp["g_b"], fake_b, train=True), ra) * lam
                + l1_loss(g_a.apply(gp["g_a"], fake_a, train=True), rb) * lam
                + l1_loss(g_a.apply(gp["g_a"], rb, train=True), rb) * idt
                + l1_loss(g_b.apply(gp["g_b"], ra, train=True), ra) * idt)
        sg = jax.lax.stop_gradient
        return loss, (sg(fake_a), sg(fake_b))

    (_, (fake_a, fake_b)), grads = jax.jit(
        jax.value_and_grad(g_loss, has_aux=True))(jstate.g_params)

    def d_loss(dp):
        return sum(0.5 * (gan_loss(d.apply(dp[k], real, train=True), True, mode)
                          + gan_loss(d.apply(dp[k], fake, train=True), False, mode))
                   for k, d, real, fake in (("d_a", d_a, rb, fake_b), ("d_b", d_b, ra, fake_a)))

    return grads, jax.jit(jax.grad(d_loss))(d_params)


@pytest.mark.parametrize("gan_mode", ["lsgan", "vanilla"])
def test_raw_gradients_match_jax(gan_mode):
    jcfg, jstate, cfg, state = paired_train_states(gan_mode, seed=1)
    rs = np.random.RandomState(7)
    a = rs.uniform(-1.0, 1.0, (1, *STEP_PATCH, 1)).astype(np.float32)
    b = rs.uniform(-1.0, 1.0, (1, *STEP_PATCH, 1)).astype(np.float32)
    want = jax_state_dicts(*_jax_grads(jcfg, jstate, a, b))
    make_train_step(cfg)(state, to_ncdhw(a), to_ncdhw(b), STEP_LR)
    for name, net in state.nets.items():
        dead = dead_bias_keys(net)
        got = dict(net.named_parameters())
        assert set(got) == set(want[name])
        scale = max(float(w.abs().max()) for w in want[name].values())
        assert scale > 0
        for key, w in want[name].items():
            g = got[key].grad
            if key in dead:
                assert g is None and float(w.abs().max()) == 0.0, f"{name} {key}"
                continue
            assert g is not None, f"{name} {key} got no gradient"
            diff = float((g - w).abs().max())
            assert diff <= 1e-4 * scale, (
                f"{name} {key} ({gan_mode}): grad max diff {diff:.3e} against the "
                f"net's gradient scale {scale:.3e}")
