"""The forward instance norm's two kernel routes (mra_gan_tpu_torch/ops/kernels/
instance_norm.py) against the JAX package's norms, on the CPU.

``uses_slab`` picks the route from the shape and dtype: the slab kernel (one
launch, an instance held in shared memory) or the two-pass kernels (segment
stats, then the apply with its Chan merge of the partials). On CPU tensors
each wrapper runs its plain version, the arithmetic the CUDA kernel
implements; these tests hold both against JAX's XLA ``instance_norm_act``
and the Pallas ``instance_norm_act_tpu`` in interpret mode, and against each
other."""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mra_gan_tpu.ops.norm import instance_norm_act as jax_instance_norm_act
from mra_gan_tpu.ops.pallas.instance_norm import instance_norm_act_tpu
from mra_gan_tpu_torch.ops.kernels import instance_norm as kern

from torch_port_util import SLAB, TWO_PASS, to_ncdhw, to_ndhwc

ACTS = ("relu", "leaky_relu", "tanh", "none")
SHAPE = (2, 6, 5, 7, 32)  # NDHWC: V = 210 voxels, C = 32


def _bf16_ulps(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest |got - ref| in bf16 ulps of max(|ref|, 1)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1.0))) - 7)
    return float(np.max(np.abs(got - ref) / ulp))


def _x(seed: int, shape=SHAPE) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * 3 + 1).astype(np.float32)


def _jax(x: np.ndarray, act: str, dtype=jnp.float32):
    return (np.asarray(jax_instance_norm_act(jnp.asarray(x, dtype), act=act)
                       .astype(jnp.float32)),
            np.asarray(instance_norm_act_tpu(jnp.asarray(x, dtype), act, 0.2)
                       .astype(jnp.float32)))


@pytest.mark.parametrize("act", ACTS)
def test_slab_matches_jax_f32(act):
    x = _x(0)
    y, mean, rstd = kern.instance_norm_slab(to_ncdhw(x), act)
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (2, 32)
    for ref in _jax(x, act):
        np.testing.assert_allclose(to_ndhwc(y), ref, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_slab_within_two_bf16_ulps_of_jax(act):
    x = _x(1)
    y, _, _ = kern.instance_norm_slab(to_ncdhw(x).to(torch.bfloat16), act)
    assert y.dtype == torch.bfloat16
    xla, pallas = _jax(x, act, jnp.bfloat16)
    assert _bf16_ulps(to_ndhwc(y), xla) <= 2.0
    assert _bf16_ulps(to_ndhwc(y), pallas) <= 2.0


@pytest.mark.parametrize("extra", [None, 0, 9])
@pytest.mark.parametrize("act", ("relu", "tanh"))
def test_merged_apply_matches_jax_and_finalize(act, extra):
    """stats -> apply for 1, 7, V and V + 9 segments (empty ones included):
    y equals JAX, and mean, rstd are finalize_plain's of the same partials."""
    x = _x(2)
    xt = to_ncdhw(x)
    voxels = math.prod(SHAPE[1:4])
    xla, pallas = _jax(x, act)
    for segments in ((1, 7) if extra is None else (voxels + extra,)):
        pm, pq = kern.instance_norm_stats(xt, segments)
        y, mean, rstd = kern.instance_norm_apply(xt, pm, pq, act)
        fm, fr = kern.finalize_plain(pm, pq, voxels)
        torch.testing.assert_close(mean, fm, rtol=0, atol=0)
        torch.testing.assert_close(rstd, fr, rtol=0, atol=0)
        for ref in (xla, pallas):
            np.testing.assert_allclose(to_ndhwc(y), ref, atol=1e-5, err_msg=str(segments))


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_uses_slab_on_the_path_shapes(dtype):
    for shape in SLAB:
        assert kern.uses_slab(shape, dtype), shape
    for shape in TWO_PASS:
        assert not kern.uses_slab(shape, dtype), shape


@pytest.mark.parametrize("shape,act", [((2, 16, 6, 5, 7), "relu"), ((1, 32, 4, 4, 4), "none"),
                                       ((2, 8, 3, 5, 2), "leaky_relu"), ((1, 8, 7, 1, 3), "tanh")])
def test_the_two_routes_agree(shape, act):
    xt = torch.from_numpy(_x(3, shape))
    slab = kern.instance_norm_slab(xt, act)
    two = kern.instance_norm_two_pass(xt, act)
    for a, b in zip(slab, two):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    route = slab if kern.uses_slab(xt.shape, xt.dtype) else two
    for a, b in zip(kern.instance_norm_act_fwd(xt, act), route):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_tensors_launch_no_kernel():
    kern.reset_launches()
    for shape in ((2, 32, 4, 4, 4), (2, 6, 4, 4, 4)):
        xt = torch.from_numpy(_x(4, shape))
        kern.instance_norm_act_fwd(xt, "relu")
        kern.instance_norm_slab(xt, "relu")
        kern.instance_norm_two_pass(xt, "relu")
    assert all(v == 0 for v in kern.LAUNCHES.values())
    assert set(kern.FORWARD) == {"instance_norm_slab", "instance_norm_stats",
                                 "instance_norm_apply"}
