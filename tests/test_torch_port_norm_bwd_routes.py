"""The backward instance norm's two kernel routes (mra_gan_tpu_torch/ops/kernels/
instance_norm.py) against the JAX package's gradients, on the CPU.

``uses_slab`` picks the backward's route as it picks the forward's: the bwd
slab kernel (one launch, the instance's x held in shared memory) or the
two-pass kernels (segment sums of g' and g'z, then the bwd apply with the
merge of those sums in its prologue). On CPU tensors each wrapper runs its
plain version, the arithmetic the CUDA kernel implements; these tests hold
both against ``jax.vjp`` of JAX's XLA ``instance_norm_act`` and of the Pallas
``instance_norm_act_tpu`` in interpret mode, and against each other.

Tolerances, relative to max |dx|: 1e-5 in float32 (the same formula summed
in other orders). In bfloat16 the port's kernels read bfloat16, work in
float32 and round dx once, as the Pallas backward does: held to one bfloat16
ulp of max |dx| against the Pallas VJP in bfloat16 and against the XLA VJP
in float32 at the same bfloat16 inputs. The XLA VJP in bfloat16 rounds z,
g' and each step of dx to bfloat16, so a relu mask flips where z rounds to
0 (measured: up to 99 ulps at single voxels, 0.14 ulp on average): held to
one ulp on average."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.ops.norm import instance_norm_act as jax_instance_norm_act
from mra_gan_tpu.ops.pallas.instance_norm import instance_norm_act_tpu
from mra_gan_tpu_torch.ops.kernels import instance_norm as kern

from torch_port_util import SLAB, TWO_PASS, to_ncdhw, to_ndhwc

ACTS = ("relu", "leaky_relu", "tanh", "none")
SHAPE = (2, 6, 5, 7, 32)  # NDHWC: V = 210 voxels, C = 32
BF16_ULP = 2.0 ** -8


def _inputs(seed: int, shape=SHAPE):
    rs = np.random.RandomState(seed)
    return ((rs.randn(*shape) * 3 + 1).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def _jax_dx(x: np.ndarray, g: np.ndarray, act: str, dtype=jnp.float32):
    """dx of the XLA and of the Pallas (interpret mode) norm, float32 numpy."""
    out = []
    for fn in (lambda t: jax_instance_norm_act(t, act=act),
               lambda t: instance_norm_act_tpu(t, act, 0.2)):
        _, vjp = jax.vjp(fn, jnp.asarray(x, dtype))
        out.append(np.asarray(vjp(jnp.asarray(g, dtype))[0].astype(jnp.float32)))
    return out


def _port(x: np.ndarray, g: np.ndarray, act: str, dtype=torch.float32):
    """(x, g, mean, rstd) as the port's backward gets them: NCDHW tensors and
    the forward kernels' statistics."""
    xt, gt = to_ncdhw(x).to(dtype), to_ncdhw(g).to(dtype)
    _, mean, rstd = kern.instance_norm_act_fwd(xt, act)
    return xt, gt, mean, rstd


def _rel_err(got: torch.Tensor, ref: np.ndarray) -> float:
    return float(np.abs(to_ndhwc(got) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("act", ACTS)
def test_bwd_slab_matches_jax_f32(act):
    x, g = _inputs(0)
    xt, gt, mean, rstd = _port(x, g, act)
    dx = kern.instance_norm_bwd_slab(xt, gt, mean, rstd, act)
    assert dx.dtype == torch.float32 and dx.shape == xt.shape
    for name, ref in zip(("xla", "pallas"), _jax_dx(x, g, act)):
        assert _rel_err(dx, ref) <= 1e-5, name


@pytest.mark.parametrize("act", ACTS)
def test_bwd_slab_within_one_bf16_ulp_of_jax(act):
    x, g = _inputs(1)
    xt, gt, mean, rstd = _port(x, g, act, torch.bfloat16)
    dx = kern.instance_norm_bwd_slab(xt, gt, mean, rstd, act)
    assert dx.dtype == torch.bfloat16
    xla16, pallas16 = _jax_dx(x, g, act, jnp.bfloat16)
    xla_at_bf16, _ = _jax_dx(to_ndhwc(xt), to_ndhwc(gt), act)
    assert _rel_err(dx, pallas16) <= BF16_ULP
    assert _rel_err(dx, xla_at_bf16) <= BF16_ULP
    assert np.mean(np.abs(to_ndhwc(dx) - xla16)) / np.abs(xla16).max() <= BF16_ULP


@pytest.mark.parametrize("extra", [None, 0, 9])
@pytest.mark.parametrize("act", ("relu", "tanh"))
def test_bwd_merged_apply_matches_jax_and_finalize(act, extra):
    """bwd stats -> bwd apply for 1, 7, V and V + 9 segments (empty ones
    included): dx equals JAX's, and equals dx from bwd_finalize_plain's
    means of the same sums."""
    x, g = _inputs(2)
    xt, gt, mean, rstd = _port(x, g, act)
    voxels = math.prod(SHAPE[1:4])
    refs = _jax_dx(x, g, act)
    for segments in ((1, 7) if extra is None else (voxels + extra,)):
        pg, pgz = kern.instance_norm_bwd_stats(xt, gt, mean, rstd, segments, act)
        assert pg.shape == pgz.shape == (2, segments, 32)
        dx = kern.instance_norm_bwd_apply(xt, gt, mean, rstd, pg, pgz, act)
        gm, gzm = kern.bwd_finalize_plain(pg, pgz, voxels)
        torch.testing.assert_close(dx, kern.bwd_apply_plain(xt, gt, mean, rstd, gm, gzm, act),
                                   rtol=0, atol=0)
        for name, ref in zip(("xla", "pallas"), refs):
            assert _rel_err(dx, ref) <= 1e-5, (name, segments)


@pytest.mark.parametrize("shape,act", [((2, 16, 6, 5, 7), "relu"), ((1, 32, 4, 4, 4), "none"),
                                       ((2, 8, 3, 5, 2), "leaky_relu"), ((1, 8, 7, 1, 3), "tanh")])
def test_the_two_backward_routes_agree(shape, act):
    rs = np.random.RandomState(3)
    xt = torch.from_numpy((rs.randn(*shape) * 3 + 1).astype(np.float32))
    gt = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    _, mean, rstd = kern.instance_norm_act_fwd(xt, act)
    slab = kern.instance_norm_bwd_slab(xt, gt, mean, rstd, act)
    two = kern.instance_norm_bwd_two_pass(xt, gt, mean, rstd, act)
    torch.testing.assert_close(slab, two, rtol=0, atol=1e-5 * float(slab.abs().max()))
    route = slab if kern.uses_slab(xt.shape, xt.dtype) else two
    torch.testing.assert_close(kern.instance_norm_act_bwd_fused(xt, gt, mean, rstd, act), route,
                               rtol=0, atol=0)


def _backward_route(shape, dtype) -> str:
    """The name of the first kernel wrapper that instance_norm_act_bwd_fused
    calls for this shape: meta tensors reach the wrapper's device check, which
    refuses them and names itself, without any memory behind them."""
    x = torch.empty(shape, dtype=dtype, device="meta").contiguous(
        memory_format=torch.channels_last_3d)
    stats = torch.empty(shape[:2], device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU") as err:
        kern.instance_norm_act_bwd_fused(x, torch.empty_like(x), stats, stats, "relu")
    return str(err.value).split(":")[0]


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_backward_route_is_uses_slab_on_the_path_shapes(dtype):
    for shape in SLAB:
        assert kern.uses_slab(shape, dtype), shape
        assert _backward_route(shape, dtype) == "instance_norm_bwd_slab", shape
    for shape in TWO_PASS:
        assert not kern.uses_slab(shape, dtype), shape
        assert _backward_route(shape, dtype) == "instance_norm_bwd_stats", shape


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_backward_segments_bound_the_merge(dtype):
    """Each bwd apply block reads all S partial sums of its channels (8
    bytes a channel each): at most half of what it reads of x and g. The
    grid (one channel chunk at these widths) stays within one wave of
    _TARGET_BLOCKS blocks."""
    for shape in TWO_PASS:
        x = torch.empty(shape, dtype=dtype, device="meta")
        n, c = shape[:2]
        voxels = math.prod(shape[2:])
        segments = kern.backward_segments(x, x)
        assert 1 <= segments <= kern.num_segments(n, voxels, c, kern.pair_width(x, x))
        assert segments * c * 8 <= 0.5 * (voxels / segments) * c * 2 * x.element_size(), shape
        assert n * segments <= kern._TARGET_BLOCKS, shape
    # the whole-volume pass is not held back by it
    x = torch.empty(TWO_PASS[9], dtype=dtype, device="meta")
    assert kern.backward_segments(x, x) == kern._TARGET_BLOCKS


def test_cpu_tensors_launch_no_backward_kernel():
    kern.reset_launches()
    for shape in ((2, 32, 4, 4, 4), (2, 6, 4, 4, 4)):
        xt, gt = (torch.from_numpy(a) for a in _inputs(4, shape))
        _, mean, rstd = kern.instance_norm_act_fwd(xt, "relu")
        kern.instance_norm_act_bwd_fused(xt, gt, mean, rstd, "relu")
        kern.instance_norm_bwd_slab(xt, gt, mean, rstd, "relu")
        kern.instance_norm_bwd_two_pass(xt, gt, mean, rstd, "relu")
    assert all(v == 0 for v in kern.LAUNCHES.values()) and kern.GRAD_RELAYOUTS["count"] == 0
    assert kern.BACKWARD == ("instance_norm_bwd_slab", "instance_norm_bwd_stats",
                             "instance_norm_bwd_apply")


def test_bwd_slab_refuses_what_the_kernel_does_not_take():
    z = torch.zeros(1, 32, 2, 2, 2)
    with pytest.raises(ValueError, match="unknown activation"):
        kern.instance_norm_bwd_slab(z, z, torch.zeros(1, 32), torch.ones(1, 32), act="gelu")
    meta = torch.zeros(1, 32, 2, 2, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kern.instance_norm_bwd_slab(meta, meta, torch.zeros(1, 32), torch.ones(1, 32))
