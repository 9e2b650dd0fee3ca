"""The gradient of the port's instance norm (the ``InstanceNormAct`` autograd
Function of mra_gan_tpu_torch/ops/norm.py, and the plain versions of its
three backward CUDA kernels) against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: ``jax.vjp`` of the XLA
``instance_norm_act`` (its analytic custom VJP) and of the Pallas
``instance_norm_act_tpu`` in interpret mode. Tolerances, relative to
max |dx|: 1e-5 in float32 (the same formula summed in other orders); in
bfloat16 both sides round each step of ``_in_vjp_bwd`` to bfloat16 (measured
bit-identical here), held to one bfloat16 ulp in case XLA fuses steps and
rounds fewer times."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.ops.norm import instance_norm_act as jax_instance_norm_act
from mra_gan_tpu.ops.pallas.instance_norm import instance_norm_act_tpu
from mra_gan_tpu_torch.ops import norm as port
from mra_gan_tpu_torch.ops.kernels import instance_norm as kern

from torch_port_util import to_ncdhw, to_ndhwc

CASES = [
    ((2, 8, 8, 8, 32), "relu"),
    ((1, 16, 8, 8, 64), "leaky_relu"),
    ((1, 8, 8, 8, 16), "none"),
    ((1, 8, 8, 8, 32), "tanh"),
]  # the forward cases of tests/test_torch_port_norm.py
BF16_ULP = 2.0 ** -8


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return ((rs.randn(*shape) * 3 + 1).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def _jax_vjp(fn, x, g, dtype=jnp.float32):
    y, vjp = jax.vjp(fn, jnp.asarray(x, dtype))
    (dx,) = vjp(jnp.asarray(g, dtype))
    return np.asarray(y.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


def _port_grad(x, g, act, dtype=torch.float32):
    xt = to_ncdhw(x).to(dtype).requires_grad_()
    y = port.instance_norm_act(xt, act=act)
    y.backward(to_ncdhw(g).to(dtype))
    assert xt.grad.dtype == dtype
    return to_ndhwc(y), to_ndhwc(xt.grad)


def _kernel_math_grad(x, g, act):
    """The three backward kernels' plain versions (bwd stats, finalize,
    apply) from the forward kernels' statistics."""
    xt, gt = to_ncdhw(x), to_ncdhw(g)
    _, mean, rstd = kern.instance_norm_act_fwd(xt, act)
    return to_ndhwc(kern.instance_norm_act_bwd_fused(xt, gt, mean, rstd, act))


@pytest.mark.parametrize("shape,act", CASES)
def test_gradient_matches_jax_xla_and_pallas(shape, act):
    x, g = _inputs(shape, 0)
    y_ref, dx_ref = _jax_vjp(lambda t: jax_instance_norm_act(t, act=act), x, g)
    _, dx_pallas = _jax_vjp(lambda t: instance_norm_act_tpu(t, act, 0.2), x, g)
    y, dx = _port_grad(x, g, act)
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
    scale = np.abs(dx_ref).max()
    for name, got in (("function", dx), ("kernel_math", _kernel_math_grad(x, g, act))):
        for ref_name, ref in (("xla", dx_ref), ("pallas", dx_pallas)):
            err = np.abs(got - ref).max() / scale
            assert err <= 1e-5, f"{name} vs {ref_name} ({act}): {err:.2e} of max|dx|"


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none", "tanh"])
def test_bfloat16_gradient_matches_jax(act):
    """Within one bfloat16 ulp of max |dx| (measured: identical)."""
    x, g = _inputs((2, 8, 8, 8, 32), 1)
    _, dx_ref = _jax_vjp(lambda t: jax_instance_norm_act(t, act=act), x, g, jnp.bfloat16)
    _, dx = _port_grad(x, g, act, torch.bfloat16)
    diff = np.abs(dx - dx_ref) / np.abs(dx_ref).max()
    assert diff.max() <= BF16_ULP, f"{act}: {diff.max() / BF16_ULP:.2f} ulps"


def test_relu_passes_the_gradient_where_z_is_zero():
    """x in {-1, 0, 1} per channel with mean exactly 0: z = 0 at a third of
    the voxels. JAX's act' is (z >= 0), so the gradient passes there; the
    port must agree (autograd of torch.relu would block it)."""
    rs = np.random.RandomState(2)
    values = np.repeat(np.float32([-1.0, 0.0, 1.0]), 72)  # 216 = 6^3 voxels
    x = np.stack([rs.permutation(values) for _ in range(8)], -1).reshape(1, 6, 6, 6, 8)
    g = rs.randn(*x.shape).astype(np.float32)
    _, dx_ref = _jax_vjp(lambda t: jax_instance_norm_act(t, act="relu"), x, g)
    _, mean, rstd = kern.instance_norm_act_plain_fwd(to_ncdhw(x), "relu")
    z = (to_ncdhw(x) - mean[:, :, None, None, None]) * rstd[:, :, None, None, None]
    assert int((z == 0).sum()) > 0
    _, dx = _port_grad(x, g, "relu")
    np.testing.assert_allclose(dx, dx_ref, atol=1e-5 * np.abs(dx_ref).max())
    np.testing.assert_allclose(_kernel_math_grad(x, g, "relu"), dx_ref,
                               atol=1e-5 * np.abs(dx_ref).max())
    xt = to_ncdhw(x).requires_grad_()
    torch.relu(kern.instance_norm_act_plain(xt, "none")).backward(to_ncdhw(g))
    assert not np.allclose(to_ndhwc(xt.grad), dx_ref, atol=1e-3)


def test_backward_segment_sums_merge_to_full_sums():
    """Per-segment sums of g' and g'z, merged, give the whole-volume means
    for any segment count, empty segments included."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 8, 3, 5, 7).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 8, 3, 5, 7).astype(np.float32))
    voxels = 3 * 5 * 7
    _, mean, rstd = kern.instance_norm_act_plain_fwd(x, "leaky_relu")
    z = (x - mean[:, :, None, None, None]) * rstd[:, :, None, None, None]
    gp = g * torch.where(z >= 0, 1.0, 0.2)
    want = (gp.mean((2, 3, 4)), (gp * z).mean((2, 3, 4)))
    for segments in (1, 2, 7, voxels, voxels + 9):
        pg, pgz = kern.instance_norm_bwd_stats(x, g, mean, rstd, segments, "leaky_relu")
        assert pg.shape == pgz.shape == (2, segments, 8)
        got = kern.instance_norm_bwd_finalize(pg, pgz, voxels)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_cpu_training_launches_no_kernel():
    kern.reset_launches()
    x = torch.randn(1, 8, 4, 4, 4, requires_grad=True)
    port.instance_norm_act(x, act="relu").sum().backward()
    _, mean, rstd = kern.instance_norm_act_fwd(x.detach(), "relu")
    kern.instance_norm_act_bwd_fused(x.detach(), torch.ones_like(x), mean, rstd, "relu")
    with torch.inference_mode():
        port.instance_norm_act(torch.randn(1, 8, 4, 4, 4), act="tanh")
    assert all(v == 0 for v in kern.LAUNCHES.values()) and kern.GRAD_RELAYOUTS["count"] == 0


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    z = torch.zeros(1, 8, 2, 2, 2)
    with pytest.raises(ValueError, match="unknown activation"):
        kern.instance_norm_bwd_apply(z, z, torch.zeros(1, 8), torch.ones(1, 8),
                                     torch.zeros(1, 8), torch.zeros(1, 8), act="gelu")
    meta = torch.zeros(1, 8, 2, 2, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kern.instance_norm_bwd_stats(meta, meta, torch.zeros(1, 8), torch.ones(1, 8), 1)
