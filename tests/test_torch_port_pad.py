"""The port's replication pad (mra_gan_tpu_torch/ops/conv.py
``replication_pad3d`` and ``ReplicationPad``; wrappers and plain versions in
ops/kernels/replication_pad.py) on the CPU, where every wrapper runs its
plain version: the forward an index gather with clamped indices, the
backward the kernel's fixed-order fold (W, then H, then D, in float32,
rounded once).

Held to the JAX package's edge pad (mra_gan_tpu/ops/conv.py:131-150,
jnp.pad(mode="edge")) and its VJP: the forward bit-equal (a copy), the
backward at rtol 1e-6 / atol 1e-6 (a sum of at most 64 terms of O(1) in
another order); to F.pad's float32 autograd backward within 1e-6 and two
float32 epsilons of the voxel's sum of |terms|; and the
resnet generator through the new route, forward and input gradient,
against the JAX generator at the network parity bar (rtol 1e-3, atol 1e-4).
The host-side geometry of a launch (``vector_width``, ``launch_geometry``,
``fold_range``) is tested as pure functions."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mra_gan_tpu.ops.conv import replication_pad3d as jax_replication_pad3d
from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
from mra_gan_tpu_torch.models.networks import ResnetGenerator3D
from mra_gan_tpu_torch.ops import conv
from mra_gan_tpu_torch.ops.kernels import replication_pad as RP

from torch_port_util import jax_generator, to_ncdhw, to_ndhwc

RTOL = ATOL = 1e-6
PORT = Path(__file__).resolve().parents[1] / "mra_gan_tpu_torch"
CU = PORT / "ops" / "kernels" / "csrc" / "replication_pad.cu"

# (N, C, D, H, W): C = 1, 4, 6, 32; boxes with an axis of 1 and of 2 voxels
SHAPES = [(2, 1, 5, 6, 7), (1, 4, 1, 5, 4), (2, 6, 3, 2, 5), (1, 32, 4, 4, 1),
          (1, 4, 2, 1, 2), (2, 6, 1, 1, 1)]
IDS = ["x".join(map(str, s)) for s in SHAPES]


def _ndhwc(shape, seed):
    """An NDHWC float32 volume of the NCDHW ``shape``, from a seeded RandomState."""
    n, c, d, h, w = shape
    return np.random.RandomState(seed).uniform(-1, 1, (n, d, h, w, c)).astype(np.float32)


def _jax_pad(x, g, fn):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _port_pad(x, g, fn):
    xt = to_ncdhw(x).requires_grad_()
    y = fn(xt)
    y.backward(to_ncdhw(g))
    return to_ndhwc(y), to_ndhwc(xt.grad)


@pytest.mark.parametrize("pad", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_pad_matches_jax_edge_pad(shape, pad):
    """replication_pad3d, forward and VJP, against the JAX package's."""
    x = _ndhwc(shape, 0)
    out = tuple(s + 2 * pad for s in shape[2:])
    g = _ndhwc(shape[:2] + out, 1)
    jy, jgx = _jax_pad(x, g, lambda a: jax_replication_pad3d(a, pad))
    y, gx = _port_pad(x, g, lambda t: conv.replication_pad3d(t, pad))
    assert y.shape == jy.shape == (shape[0], *out, shape[1])
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(gx, jgx, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pad", [1, 3])
@pytest.mark.parametrize("shape", SHAPES[:4], ids=IDS[:4])
def test_per_axis_pad_matches_jax_on_h_and_w(shape, pad):
    """The sharded branch's form, (0, 0, p, p, p, p): H and W padded, depth
    not, against the jnp.pad(mode="edge") JAX applies after its halo
    exchange (mra_gan_tpu/ops/conv.py:141-146)."""
    x = _ndhwc(shape, 2)
    n, c, d, h, w = shape
    g = _ndhwc((n, c, d, h + 2 * pad, w + 2 * pad), 3)
    edge = ((0, 0), (0, 0), (pad, pad), (pad, pad), (0, 0))
    jy, jgx = _jax_pad(x, g, lambda a: jnp.pad(a, edge, mode="edge"))
    y, gx = _port_pad(x, g, lambda t: conv.ReplicationPad.apply(t, (0, 0, pad, pad, pad, pad)))
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(gx, jgx, rtol=RTOL, atol=ATOL)


# unequal, one-sided and zero pads, each axis its own
PADS = [(1, 1, 1, 1, 1, 1), (3, 3, 3, 3, 3, 3), (0, 2, 1, 0, 2, 3), (2, 0, 0, 3, 1, 1),
        (0, 0, 0, 0, 0, 0)]


@pytest.mark.parametrize("pads", PADS, ids=["-".join(map(str, p)) for p in PADS])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_versions_match_f_pad(shape, pads):
    """The forward bit-equal to F.pad(mode="replicate"); the fixed-order
    backward within 1e-6 of F.pad's float32 autograd backward, relative to
    the voxel's sum of |terms| (F.pad's backward of |g|: two float32 orders
    of up to 343 terms, whose partial sums reach a few units at a corner),
    and so within two float32 epsilons of that sum, which an order that
    drifted would not keep; bit-equal across two runs."""
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, shape).astype(np.float32))
    xt = x.clone().requires_grad_()
    ref = F.pad(xt, (pads[4], pads[5], pads[2], pads[3], pads[0], pads[1]), mode="replicate")
    y = RP.replication_pad_fwd(x, pads)
    assert y.shape == ref.shape == (*shape[:2], *RP.out_shape(shape[2:], pads))
    assert torch.equal(y, ref.detach())
    g = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, y.shape).astype(np.float32))
    (want,) = torch.autograd.grad(ref, xt, g, retain_graph=True)
    (scale,) = torch.autograd.grad(ref, xt, g.abs())
    got, again = (RP.replication_pad_bwd(g, pads, shape[2:]) for _ in range(2))
    assert bool(((got - want).abs() <= ATOL * scale.clamp_min(1.0)).all())
    eps = torch.finfo(torch.float32).eps
    assert float(((got - want).abs() / (eps * scale.clamp_min(1.0))).max()) <= 2.0
    assert torch.equal(got, again)


def _fold_by_hand(g: np.ndarray, pads, spatial) -> np.ndarray:
    """The kernel's loop for one voxel at a time: for each od, for each oh,
    the W terms left to right, then the H partials, then the D partials,
    each fold starting from its first term, in float32."""
    n, c = g.shape[:2]
    out = np.zeros((n, c, *spatial), np.float32)
    ranges = [[RP.fold_range(i, s, pads[2 * a], pads[2 * a + 1]) for i in range(s)]
              for a, s in enumerate(spatial)]
    for d, (d0, d1) in enumerate(ranges[0]):
        for h, (h0, h1) in enumerate(ranges[1]):
            for w, (w0, w1) in enumerate(ranges[2]):
                acc_d = None
                for od in range(d0, d1 + 1):
                    acc_h = None
                    for oh in range(h0, h1 + 1):
                        acc_w = g[:, :, od, oh, w0].astype(np.float32)
                        for ow in range(w0 + 1, w1 + 1):
                            acc_w = acc_w + g[:, :, od, oh, ow].astype(np.float32)
                        acc_h = acc_w if acc_h is None else acc_h + acc_w
                    acc_d = acc_h if acc_d is None else acc_d + acc_h
                out[:, :, d, h, w] = acc_d
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pads", PADS[:4], ids=["-".join(map(str, p)) for p in PADS[:4]])
def test_plain_backward_is_the_kernels_association(pads, dtype):
    """The plain backward equals, bit for bit, the kernel's per-voxel loop
    (csrc/replication_pad.cu replication_pad_bwd_kernel) written out in
    numpy float32, rounded once to the gradient's dtype."""
    spatial = (3, 1, 4)
    rs = np.random.RandomState(6)
    g = torch.from_numpy(rs.uniform(-1, 1, (2, 3, *RP.out_shape(spatial, pads)))
                         .astype(np.float32)).to(dtype)
    want = torch.from_numpy(_fold_by_hand(g.float().numpy(), pads, spatial)).to(dtype)
    assert torch.equal(RP.replication_pad_bwd(g, pads, spatial), want)


def test_float64_backward_sums_in_float64():
    """A float64 gradient folds in float64 (phase 8's reference step on the
    card runs through the same kernels)."""
    g = torch.from_numpy(np.random.RandomState(7).randn(1, 2, 5, 5, 5))
    dx = RP.replication_pad_bwd(g, (1,) * 6, (3, 3, 3))
    assert dx.dtype == torch.float64
    torch.testing.assert_close(dx, torch.from_numpy(_fold_by_hand(g.numpy(), (1,) * 6,
                                                                  (3, 3, 3))).double(),
                               rtol=1e-6, atol=1e-6)
    x = torch.zeros(1, 2, 3, 3, 3, dtype=torch.float64, requires_grad=True)
    (want,) = torch.autograd.grad(F.pad(x, (1,) * 6, mode="replicate"), x, g)
    torch.testing.assert_close(dx, want, rtol=0, atol=1e-12)


def test_generator_through_the_pad_route_matches_jax(monkeypatch):
    """The resnet generator (ngf 4, 16^3), forward and input gradient,
    against the JAX generator and its VJP, every pad through the
    autograd Function: 14 forwards and 14 backwards (the input needs a
    gradient, so the stem's pad has a backward too)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = RP.replication_pad_fwd, RP.replication_pad_bwd

    def count(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(RP, "replication_pad_fwd", count("fwd", fwd))
    monkeypatch.setattr(RP, "replication_pad_bwd", count("bwd", bwd))
    jnet, params = jax_generator(seed=21)
    rs = np.random.RandomState(8)
    x = rs.uniform(-1, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    g = rs.uniform(-1, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jnet.apply(params, a, train=False), jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    net = ResnetGenerator3D(1, 1, 4, 6).eval()
    net.load_state_dict(state_dict_from_jax(params, "resnet_6blocks"))
    y, gx = _port_pad(x, g, net)
    assert calls == {"fwd": 14, "bwd": 14}
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(gx, np.asarray(jgx), rtol=1e-3, atol=1e-4)


def test_no_gradient_skips_the_function():
    """Where autograd records nothing (a decode, an input that needs no
    gradient) the forward wrapper runs alone, with the same bits."""
    x = torch.from_numpy(np.random.RandomState(9).uniform(-1, 1, (1, 4, 3, 4, 5))
                         .astype(np.float32))
    plain = conv.replication_pad3d(x, 2)
    assert plain.grad_fn is None
    with torch.inference_mode():
        assert torch.equal(conv.replication_pad3d(x, 2), plain)
    xt = x.clone().requires_grad_()
    y = conv.replication_pad3d(xt, 2)
    assert type(y.grad_fn).__name__ == "ReplicationPadBackward"
    assert torch.equal(y.detach(), plain)


def test_cpu_runs_the_plain_versions_and_counts_nothing():
    RP.reset_launches()
    x = torch.randn(1, 2, 3, 3, 3)
    y = RP.replication_pad_fwd(x, (1,) * 6)
    RP.replication_pad_bwd(torch.ones_like(y), (1,) * 6, (3, 3, 3))
    assert not any(RP.LAUNCHES.values()) and RP.RELAYOUTS["count"] == 0


def test_meta_tensors_give_the_shapes():
    """FlopCounterMode's pass over a train step runs on meta tensors: the
    shapes, forward and backward, and no launch."""
    RP.reset_launches()
    x = torch.empty(2, 4, 3, 5, 1, device="meta", requires_grad=True)
    y = conv.replication_pad3d(x, 3)
    assert y.device.type == "meta" and y.shape == (2, 4, 9, 11, 7)
    (gx,) = torch.autograd.grad(y, x, torch.empty_like(y))
    assert gx.shape == x.shape and not any(RP.LAUNCHES.values())


def test_launch_checks_refuse_other_devices():
    """No fallback: the checks before a launch raise on a tensor that is
    not on the card."""
    with pytest.raises(ValueError, match="CUDA or CPU"):
        RP._on_card(torch.empty(1, 4, 3, 3, 3, device="meta"), "pad")


@pytest.mark.parametrize("shape,pads,box,dtype,backward,error", [
    ((1, 4, 3, 3, 3), (1,) * 6, (3, 3, 3), torch.float16, False, TypeError),
    ((1, 4, 3, 3, 3), (1, 1, -1, 1, 1, 1), (3, 3, 3), torch.float32, False, ValueError),
    ((1, 4, 3, 3, 3), (1,) * 5, (3, 3, 3), torch.float32, False, ValueError),
    ((1, 4, 0, 3, 3), (1,) * 6, (0, 3, 3), torch.float32, False, ValueError),
    ((1, 4, 5, 5, 4), (1,) * 6, (3, 3, 3), torch.bfloat16, True, ValueError)])
def test_launch_plan_refuses_what_the_kernels_do_not_take(shape, pads, box, dtype, backward,
                                                          error):
    """float16, negative or missing pads, an empty box, a gradient whose
    box is not the padded one: refused before any launch."""
    with pytest.raises(error):
        RP.launch_plan(shape, pads, box, dtype, True, backward)


def test_launch_plan_parameters():
    """The head's pad at the step's 2B = 16 in bf16: 16-byte units, one
    block an output row (forward) or input row (backward), the C array
    holding the parameters in the kernel's order."""
    fwd = RP.launch_plan((16, 32, 64, 64, 64), (3,) * 6, (64, 64, 64), torch.bfloat16, True,
                         False)
    assert fwd[0] == (16, 32, 70, 70, 70)
    assert fwd[1] == (1, 16, 32, 64, 64, 64, 3, 3, 3, 3, 3, 3, 8, 288)
    assert list(fwd[2]) == list(fwd[1])
    bwd = RP.launch_plan((16, 32, 70, 70, 70), (3,) * 6, (64, 64, 64), torch.bfloat16, False,
                         True)
    assert bwd[0] == (16, 32, 64, 64, 64)
    assert bwd[1][-2:] == (1, 1024)  # unaligned: one element a thread, 2048 a row


# ---------------------------------------------------------------------------
# the host side of a launch


@pytest.mark.parametrize("n", [1, 2, 5, 16])
@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (3, 3), (0, 2), (3, 0)])
def test_fold_ranges_cover_every_output_once(n, lo, hi):
    """Along an axis, the input voxels' ranges cut the padded axis into
    consecutive pieces: every output read by exactly one input voxel, and
    each output's voxel its clamped index."""
    seen = []
    for i in range(n):
        first, last = RP.fold_range(i, n, lo, hi)
        assert first <= last
        for o in range(first, last + 1):
            assert min(max(o - lo, 0), n - 1) == i
        seen += range(first, last + 1)
    assert seen == list(range(n + lo + hi))


@pytest.mark.parametrize("c,itemsize,aligned,want", [
    (32, 2, True, 8), (128, 2, True, 8), (4, 4, True, 4), (32, 4, True, 4), (2, 8, True, 2),
    (1, 2, True, 1), (6, 2, True, 1), (6, 4, True, 1), (4, 2, True, 1), (32, 2, False, 1)])
def test_vector_width(c, itemsize, aligned, want):
    """16 bytes a thread where a voxel's channels fill whole 16-byte units
    and the tensors are aligned (C = 32 or 128 in bf16, C = 4 in float32);
    one element elsewhere (C = 1 at the stem, 6, C = 4 in bf16)."""
    assert RP.vector_width(c, itemsize, aligned) == want


@pytest.mark.parametrize("rows,units", [(16 * 70 * 70, 280), (16 * 18 * 18, 288),
                                        (134 * 262, 1048), (8 * 70 * 70, 70), (3, 1)])
def test_launch_geometry_covers_each_row(rows, units):
    """One block a row; whole warps; a row longer than the block walked in
    strides of the block."""
    blocks, threads = RP.launch_geometry(rows, units)
    assert blocks == rows
    assert threads % 32 == 0 and 32 <= threads <= RP.MAX_THREADS
    assert threads == RP.MAX_THREADS or threads - 32 < units <= threads
    covered = sorted(j for t in range(threads) for j in range(t, units, threads))
    assert covered == list(range(units))


def test_constants_match_the_kernel_source():
    src = CU.read_text()
    assert int(re.search(r"kVecBytes = (\d+);", src).group(1)) == RP.VEC_BYTES
    assert int(re.search(r"kMaxThreads = (\d+);", src).group(1)) == RP.MAX_THREADS
    codes = dict(re.findall(r"DT_(\w+) = (\d+)", src))
    assert {"F32": 0, "BF16": 1, "F64": 2} == {k: int(v) for k, v in codes.items()}
    assert RP._DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def test_kernel_source_has_no_atomics_and_the_port_no_replicate_f_pad():
    """The backward is a gather (no atomic add); the port's own code pads
    only through the kernels (bench_reference.py, the benchmark's
    independent float32 reference, keeps its own F.pad)."""
    code = "\n".join(line.split("//")[0] for line in CU.read_text().splitlines())
    assert "atomic" not in code and "atom." not in code
    users = [p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")
             if 'mode="replicate"' in p.read_text()]
    assert users == ["bench_reference.py"]


def test_kernel_names_fall_in_the_profiles_pad_class():
    """The benchmark's pad_ms reads the kernels by name."""
    from mra_gan_tpu_torch.utils.profiling import kernel_class

    names = re.findall(r"__global__ void __launch_bounds__\(kMaxThreads\)\n(\w+)", CU.read_text())
    assert names == ["replication_pad_fwd_kernel", "replication_pad_bwd_kernel"]
    for name in names:
        assert kernel_class(f"void (anonymous namespace)::{name}<__nv_bfloat16, 8>"
                            f"(__nv_bfloat16 const*, __nv_bfloat16*, Box)") == "pad"
