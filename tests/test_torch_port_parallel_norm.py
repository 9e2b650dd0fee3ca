"""The port's depth-sharded building blocks on 2 and 4 gloo ranks of the CPU
(tests/torch_port_parallel_ranks.py), against the JAX package's under
``shard_map`` on the conftest's fake CPU devices: the halo exchange
(``neighbour_exchange`` against ``extend_sharded_d``, both boundaries, and its
float64 backward against the gradient of padding the whole volume),
``halo_conv3d`` (tests/test_parallel.py ``test_halo_conv_matches_dense``'s
case), and the sharded instance norm, forward and backward for every
activation, at the norm bar (atol 1e-5, float32), also against the port's
unsharded norm of the whole volume. The plain K-shard merge is held bit for
bit against the merge of the whole volume's partials."""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mra_gan_tpu.core.mesh import make_mesh
from mra_gan_tpu.core.spatial_ctx import spatial_sharding
from mra_gan_tpu.ops.conv import extend_sharded_d
from mra_gan_tpu.ops.norm import instance_norm_act as jax_norm
from mra_gan_tpu.parallel.spatial import halo_conv3d as jax_halo_conv3d
from mra_gan_tpu_torch.ops.kernels import instance_norm as kn
from mra_gan_tpu_torch.ops.norm import instance_norm_act
from torch_port_parallel_ranks import rank_halos, rank_norms, start_ranks

ACTS = ("none", "relu", "leaky_relu", "tanh")
LO, HI = 2, 1


def _ndhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def _ncdhw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(x, -1, 1))


def _sharded(fn, k: int, n_in: int, n_out: int):
    mesh = make_mesh(jax.devices()[:k])
    spec = P(None, "data")
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                             out_specs=spec if n_out == 1 else (spec,) * n_out,
                             check_vma=False))


@pytest.mark.parametrize("k", [2, 4])
def test_halo_exchange_and_halo_conv_match_jax(tmp_path, k):
    rs = np.random.RandomState(k)
    x = rs.randn(2, 3, 16, 5, 6)
    e = 16 // k + LO + HI
    cot = rs.randn(2, 3, k * e, 5, 6)
    # test_halo_conv_matches_dense's case: (1, 32, 8, 8, 4) NDHWC, 3^3 to 6
    xc = rs.randn(1, 4, 32, 8, 8).astype(np.float32)
    wc = (rs.randn(6, 4, 3, 3, 3) * 0.2).astype(np.float32)
    wait = {b: start_ranks(rank_halos, k, tmp_path, x, cot, LO, HI, b, xc, wc)
            for b in ("edge", "zero")}

    for boundary, results in ((b, w()) for b, w in wait.items()):
        # forward against JAX's extend_sharded_d (float32: JAX runs without x64)
        with spatial_sharding("data", k):
            f = _sharded(lambda xs: extend_sharded_d(xs, LO, HI, boundary), k, 1, 1)
            want = _ncdhw(np.asarray(f(jnp.asarray(_ndhwc(x), jnp.float32))))
        got = np.concatenate([r["ext"] for r in results], 2)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=boundary)
        # float64 backward against padding the whole volume
        xt = torch.from_numpy(x).requires_grad_(True)
        padded = F.pad(xt, (0, 0, 0, 0, LO, HI),
                       mode="replicate" if boundary == "edge" else "constant")
        d = 16 // k
        torch.cat([padded[:, :, r * d:r * d + e] for r in range(k)], 2).backward(
            torch.from_numpy(cot))
        grad = np.concatenate([r["grad"] for r in results], 2)
        np.testing.assert_allclose(grad, xt.grad.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=boundary)

    # halo_conv3d against JAX's on 8 devices and against the dense conv
    conv = np.concatenate([r["conv"] for r in results], 2)
    mesh8 = make_mesh(jax.devices()[:8])
    from jax.sharding import NamedSharding

    xs = jax.device_put(jnp.asarray(_ndhwc(xc)), NamedSharding(mesh8, P(None, "data")))
    want = _ncdhw(np.asarray(jax_halo_conv3d(mesh8, xs, jnp.asarray(
        np.transpose(wc, (2, 3, 4, 1, 0))))))
    np.testing.assert_allclose(conv, want, rtol=2e-4, atol=2e-4)
    dense = F.conv3d(torch.from_numpy(xc), torch.from_numpy(wc), padding=1).numpy()
    np.testing.assert_allclose(conv, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_norm_matches_jax_and_the_whole_volume(tmp_path, k):
    rs = np.random.RandomState(10 + k)
    x = (rs.randn(2, 8, 16, 6, 6) * 2 + 0.5).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    wait = start_ranks(rank_norms, k, tmp_path, x, g, ACTS)
    want = {}
    for act in ACTS:
        with spatial_sharding("data", k):
            def body(xs, gs, act=act):
                y, vjp = jax.vjp(lambda t: jax_norm(t, 1e-5, act, 0.2), xs)
                return y, vjp(gs)[0]

            y, dx = _sharded(body, k, 2, 2)(jnp.asarray(_ndhwc(x)), jnp.asarray(_ndhwc(g)))
        want[act] = (_ncdhw(np.asarray(y)), _ncdhw(np.asarray(dx)))
    results = wait()
    for act in ACTS:
        y = np.concatenate([r[act][0] for r in results], 2)
        dx = np.concatenate([r[act][1] for r in results], 2)
        np.testing.assert_allclose(y, want[act][0], rtol=0, atol=1e-5, err_msg=act)
        np.testing.assert_allclose(dx, want[act][1], rtol=0, atol=1e-5, err_msg=act)
        xt = torch.from_numpy(x).requires_grad_(True)
        whole = instance_norm_act(xt, act=act)
        whole.backward(torch.from_numpy(g))
        np.testing.assert_allclose(y, whole.detach().numpy(), rtol=0, atol=1e-5, err_msg=act)
        np.testing.assert_allclose(dx, xt.grad.numpy(), rtol=0, atol=1e-5, err_msg=act)


@pytest.mark.parametrize("k", [2, 4])
def test_plain_shard_merge_is_the_whole_volumes_merge(k):
    """K shards' (N, S, C) partials, stacked rank-major, merge bit for bit as
    the whole volume's partials over K * S segments (the segments line up
    with the shards); the backward's sums within float32 rounding."""
    rs = np.random.RandomState(20 + k)
    x = torch.from_numpy(rs.randn(2, 8, 16, 6, 6).astype(np.float32) * 3 + 1)
    g = torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
    d, segments = 16 // k, 3
    voxels = d * 36
    parts = [kn.stats_plain(x[:, :, r * d:(r + 1) * d], segments) for r in range(k)]
    stacked = torch.stack([torch.stack(p) for p in parts])  # (K, 2, N, S, C)
    merged = kn.finalize_plain(stacked[:, 0], stacked[:, 1], voxels)
    whole = kn.finalize_plain(*kn.stats_plain(x, k * segments), k * voxels)
    for a, b in zip(merged, whole):
        assert torch.equal(a, b)
    mean, rstd = merged
    bparts = [kn.bwd_stats_plain(x[:, :, r * d:(r + 1) * d], g[:, :, r * d:(r + 1) * d], mean,
                                 rstd, segments, "relu") for r in range(k)]
    bstacked = torch.stack([torch.stack(p) for p in bparts])
    got = kn.bwd_finalize_plain(bstacked[:, 0], bstacked[:, 1], voxels)
    want = kn.bwd_finalize_plain(*kn.bwd_stats_plain(x, g, mean, rstd, k * segments, "relu"),
                                 k * voxels)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_segments_follow_the_shape_and_bound_the_merge(shards):
    """Every rank's shard has the same shape, so every rank picks the same
    S, whatever its tensors' alignment. The forward takes the whole
    volume's count divided by K; the backward the one-volume count of the
    shard, cut so that the K * S partials an apply block merges stay under
    half its x and g reads."""
    for shape, dtype in (((1, 32, 64, 256, 256), torch.bfloat16),
                         ((2, 32, 32, 64, 64), torch.bfloat16),
                         ((1, 32, 16, 64, 64), torch.bfloat16),
                         ((4, 32, 64, 128, 128), torch.bfloat16),
                         ((1, 4, 8, 16, 16), torch.float32), ((2, 3, 4, 6, 6), torch.float32)):
        x = torch.zeros(shape, dtype=dtype)
        whole = torch.zeros((shape[0], shape[1], shape[2] * shards, *shape[3:]), dtype=dtype)
        odd = torch.zeros(math.prod(shape) + 1, dtype=dtype)[1:].view(shape)  # unaligned
        fwd, bwd = kn.forward_segments(x, shards), kn.backward_segments(x, x, shards)
        assert fwd == kn.forward_segments(odd, shards) == max(
            1, kn.forward_segments(whole) // shards), shape
        assert bwd == kn.backward_segments(odd, odd, shards) <= kn.backward_segments(x, x), shape
        voxels = math.prod(shape[2:])
        assert bwd == 1 or shards * bwd * 8 <= voxels // bwd * x.element_size(), shape


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_statistics_are_the_whole_volumes_where_k_divides_the_count(shards):
    """Where K divides the whole volume's forward count, the shards'
    segments are the whole volume's, and the merged plain statistics equal
    the unsharded ones bit for bit."""
    x = torch.from_numpy(np.random.RandomState(3).standard_normal((1, 8, 64, 32, 32))
                         .astype(np.float32))
    d = x.shape[2] // shards
    segments = kn.forward_segments(x[:, :, :d], shards)
    assert kn.forward_segments(x) == shards * segments
    parts = [kn.stats_plain(x[:, :, r * d:(r + 1) * d], segments) for r in range(shards)]
    got = kn.finalize_plain(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]), math.prod(x.shape[2:]) // shards)
    want = kn.finalize_plain(*kn.stats_plain(x, shards * segments), math.prod(x.shape[2:]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
