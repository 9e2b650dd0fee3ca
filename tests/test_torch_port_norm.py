"""The port's instance norm (mra_gan_tpu_torch/ops/norm.py and the plain
versions of its CUDA kernels) against the JAX package's norms, on the CPU.

The JAX side runs as its own tests run it: the XLA ``instance_norm_act`` and
``instance_norm``, and the Pallas ``instance_norm_act_tpu`` in interpret mode.
Two port paths are held against them: ``instance_norm_act`` (the plain
version the CPU takes) and ``instance_norm_act_fused`` on CPU tensors, which
runs the plain versions of the three kernels (segment stats, Chan merge,
apply): the arithmetic the CUDA kernels implement."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mra_gan_tpu.ops.norm import instance_norm as jax_instance_norm
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
]  # tests/test_pallas_norm.py:12-17


def _bf16_ulps(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest |got - ref| in bf16 ulps of max(|ref|, 1): unit-variance
    outputs, so values below 1 are held to the ulp at 1."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1.0))) - 7)
    return float(np.max(np.abs(got - ref) / ulp))


def _port_paths(xt, act):
    return {"plain": port.instance_norm_act(xt, act=act),
            "kernel_math": kern.instance_norm_act_fused(xt, act)}


@pytest.mark.parametrize("shape,act", CASES)
def test_matches_jax_xla_and_pallas(shape, act):
    x = (np.random.RandomState(0).randn(*shape) * 3 + 1).astype(np.float32)
    ref = np.asarray(jax_instance_norm_act(jnp.asarray(x), act=act))
    pallas = np.asarray(instance_norm_act_tpu(jnp.asarray(x), act, 0.2))
    for name, got in _port_paths(to_ncdhw(x), act).items():
        np.testing.assert_allclose(to_ndhwc(got), ref, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(to_ndhwc(got), pallas, atol=1e-5, err_msg=name)


def test_instance_norm_matches_jax():
    x = (np.random.RandomState(1).randn(2, 6, 5, 7, 12) * 2 - 0.5).astype(np.float32)
    ref = np.asarray(jax_instance_norm(jnp.asarray(x)))
    np.testing.assert_allclose(to_ndhwc(port.instance_norm(to_ncdhw(x))), ref, atol=1e-5)


def test_bfloat16_within_two_ulps_of_jax():
    x = (np.random.RandomState(2).randn(2, 8, 8, 8, 32) * 3 + 1).astype(np.float32)
    ref = np.asarray(jax_instance_norm_act(jnp.asarray(x, jnp.bfloat16), act="relu")
                     .astype(jnp.float32))
    for name, got in _port_paths(to_ncdhw(x).to(torch.bfloat16), "relu").items():
        assert got.dtype == torch.bfloat16, name
        assert _bf16_ulps(to_ndhwc(got), ref) <= 2.0, name


def test_large_mean_small_std_stays_centred():
    """|mean| / std = 1e4. Inputs are 100 + k/1024 with small integers k on
    64 voxels, so every sum the centred form takes is exact in float32 in any
    order, and the port must equal JAX to 1e-5. The Pallas kernel's
    E[x^2] - E[x]^2 loses the variance entirely here."""
    rng = np.random.RandomState(3)
    x = (100.0 + rng.randint(-12, 13, size=(1, 4, 4, 4, 16)) / 1024.0).astype(np.float32)
    ref = np.asarray(jax_instance_norm_act(jnp.asarray(x), act="none"))
    assert np.abs(ref).max() > 1.0  # normalised, not collapsed
    for name, got in _port_paths(to_ncdhw(x), "none").items():
        np.testing.assert_allclose(to_ndhwc(got), ref, atol=1e-5, err_msg=name)
    pallas = np.asarray(instance_norm_act_tpu(jnp.asarray(x), "none", 0.2))
    assert not np.allclose(pallas, ref, atol=1e-2)


def test_large_mean_random_inputs_within_mean_rounding():
    """x * 0.01 + 100 with random x: the two frameworks round the float32
    mean differently by about one ulp of 100 (7.6e-6), which the 1/std = 100
    scale turns into ~1e-3 in z. Held to 16 such ulps times 1/std, where the
    uncentred form is off by O(1)."""
    x = (np.random.RandomState(4).randn(1, 8, 8, 8, 16) * 0.01 + 100).astype(np.float32)
    ref = np.asarray(jax_instance_norm_act(jnp.asarray(x), act="none"))
    tol = 16 * np.spacing(np.float32(100)) / 0.01
    for name, got in _port_paths(to_ncdhw(x), "none").items():
        np.testing.assert_allclose(to_ndhwc(got), ref, atol=tol, err_msg=name)


def test_segment_stats_merge_to_full_stats():
    """Per-segment (mean, M2) partials, merged with Chan's formula, give the
    whole-volume mean and rstd for any segment count, empty segments
    included (more segments than voxels)."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 8, 3, 5, 7).astype(np.float32))
    voxels = 3 * 5 * 7
    mean = x.mean((2, 3, 4))
    rstd = torch.rsqrt(x.var((2, 3, 4), unbiased=False) + kern.EPS)
    for segments in (1, 2, 7, voxels, voxels + 9):
        pm, pq = kern.instance_norm_stats(x, segments)
        assert pm.shape == pq.shape == (2, segments, 8)
        m, r = kern.instance_norm_finalize(pm, pq, voxels)
        torch.testing.assert_close(m, mean, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(r, rstd, atol=1e-6, rtol=1e-5)


def test_num_segments_fills_the_card():
    # batch-8 trunk: 1024 (n, c) rows of 4096 voxels; batch-1 stem: 32 rows of 262k
    assert 8 * kern.num_segments(8, 16 ** 3, 128, 8) >= 132 * 2
    assert kern.num_segments(1, 64 ** 3, 32, 8) >= 132 * 4
    assert kern.num_segments(1, 8, 32, 8) == 1


def test_cpu_tensor_launches_no_kernel():
    kern.reset_launches()
    x = torch.randn(1, 8, 4, 4, 4)
    port.instance_norm_act(x, act="relu")
    kern.instance_norm_act_fused(x, "relu")
    assert all(v == 0 for v in kern.LAUNCHES.values())


def test_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="unknown activation"):
        kern.instance_norm_apply(torch.zeros(1, 8, 2, 2, 2), torch.zeros(1, 8),
                                 torch.ones(1, 8), act="gelu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kern.instance_norm_stats(torch.zeros(1, 8, 2, 2, 2, device="meta"), 1)
