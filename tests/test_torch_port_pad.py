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


def _params(shape, pads, box, dtype, aligned, backward):
    return dict(zip(RP.PARAMS, RP.launch_plan(shape, pads, box, dtype, aligned, backward)[1]))


def test_launch_plan_parameters():
    """The head's pad at the step's 2B = 16 in bf16: forward the row kernel
    on the unit path (C = 32 fills four 16-byte units a voxel; a block an
    output row, the row's 280 units rounded up to whole warps), backward the
    ring with its tile plan, the destination's row and voxel divided in
    units; the C array holds the header and the kernel's struct Plan in
    order. An unaligned gradient takes the row kernel an element a thread;
    the stem's forward (C = 1) the chunk kernel, a plane's chunks in
    CHUNK_THREADS blocks."""
    fwd = RP.launch_plan((16, 32, 64, 64, 64), (3,) * 6, (64, 64, 64), torch.bfloat16, True,
                         False)
    assert fwd[0] == (16, 32, 70, 70, 70) and fwd[4] is None
    got = dict(zip(RP.PARAMS, fwd[1]))
    assert len(fwd[1]) == len(RP.PARAMS) and list(fwd[2]) == list(fwd[1])
    assert {k: got[k] for k in ("dtype", "vec", "route", "threads", "grid", "N", "C", "D", "Do",
                                "pd", "vox_d")} == {
        "dtype": 1, "vec": 8, "route": RP.ROUTES["rows"], "threads": 288, "grid": 16 * 70 * 70,
        "N": 16, "C": 32, "D": 64, "Do": 70, "pd": 3, "vox_d": 4}
    bwd = RP.launch_plan((16, 32, 70, 70, 70), (3,) * 6, (64, 64, 64), torch.bfloat16, True,
                         True)
    got, plan = dict(zip(RP.PARAMS, bwd[1])), bwd[4]
    assert bwd[0] == (16, 32, 64, 64, 64)
    assert {k: got[k] for k in ("route", "threads", "grid", "tiles", "stage_bytes", "stages",
                                "row_d", "vox_d")} == {
        "route": RP.ROUTES["ring"], "threads": RP.RING_THREADS, "grid": 2 * RP.SMS,
        "tiles": plan.tiles, "stage_bytes": plan.stage, "stages": plan.stages,
        "row_d": 64 * 4, "vox_d": 4}
    got = _params((16, 32, 70, 70, 70), (3,) * 6, (64, 64, 64), torch.bfloat16, False, True)
    assert {k: got[k] for k in ("vec", "route", "threads", "grid", "stages")} == {
        "vec": 1, "route": RP.ROUTES["rows"], "threads": 1024, "grid": 16 * 64 * 64, "stages": 0}
    got = _params((8, 1, 64, 64, 64), (3,) * 6, (64, 64, 64), torch.bfloat16, True, False)
    assert {k: got[k] for k in ("vec", "route", "threads", "plane_blocks", "grid", "row_d",
                                "vox_d")} == {
        "vec": 1, "route": RP.ROUTES["chunks"], "threads": RP.CHUNK_THREADS, "plane_blocks": 5,
        "grid": 8 * 70 * 5, "row_d": 70, "vox_d": 1}


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
    """A chunk is one voxel's 16-byte unit where a voxel's channels fill
    whole units and the source is aligned (C = 32 or 128 in bf16, C = 4 in
    float32); its elements gathered one by one elsewhere (C = 1 at the stem,
    6, C = 4 in bf16, an unaligned source)."""
    assert RP.vector_width(c, itemsize, aligned) == want


@pytest.mark.parametrize("shape,pads", [
    ((16, 32, 64, 64, 64), (3,) * 6), ((16, 128, 16, 16, 16), (1,) * 6),
    ((1, 32, 128, 256, 256), (3,) * 6), ((8, 1, 64, 64, 64), (3,) * 6),
    ((3, 1, 1, 1, 1), (0, 0, 0, 0, 0, 0))], ids=["head", "trunk", "single", "stem", "one"])
def test_launch_geometry_covers_each_row(shape, pads):
    """Every output row (n, od, oh) is written whole, once, in bf16: on the
    unit path by a block of its own whose threads cover the row's units (or
    walk them in strides of a full block), elsewhere by the chunk kernel,
    whose blocks cover each output plane's elements exactly once; at the
    head's and the trunk's step shapes, the single pass's 1048-unit rows,
    the stem and a box of one voxel."""
    got = _params(shape, pads, shape[2:], torch.bfloat16, True, False)
    n, c = shape[:2]
    out = RP.out_shape(shape[2:], pads)
    if got["route"] == RP.ROUTES["rows"]:
        units = out[2] * c // got["vec"]
        assert got["grid"] == n * out[0] * out[1]
        assert got["threads"] % 32 == 0
        assert got["threads"] >= units or got["threads"] == RP.MAX_THREADS
        assert got["threads"] - units < 32 or units > RP.MAX_THREADS
    else:
        assert got["route"] == RP.ROUTES["chunks"] and c * 2 % 16
        assert _chunks_cover_planes(got, 2)


def _chunks_cover_planes(got, itemsize):
    """The chunk kernel's blocks write each output plane's elements exactly
    once, whatever the plane's offset within a 16-byte chunk (every lead
    the planes of the launch take): chunk j of a plane is its elements
    j * EPC - lead .. + EPC - 1, those inside the plane."""
    epc = 16 // itemsize
    length = got["Ho"] * got["row_d"]
    assert got["row_d"] == got["Wo"] * got["C"] and got["vox_d"] == got["C"]
    assert got["grid"] == got["N"] * got["Do"] * got["plane_blocks"]
    planes = got["N"] * got["Do"]
    leads = {(p * length) % epc for p in range(min(planes, epc))}
    j = np.arange(got["plane_blocks"] * RP.CHUNK_THREADS)
    for lead in leads:
        e = (j[:, None] * epc - lead + np.arange(epc)[None, :]).ravel()
        e = e[(e >= 0) & (e < length)]
        if not (len(e) == length and (np.sort(e) == np.arange(length)).all()):
            return False
    return True


def test_constants_match_the_kernel_source():
    """The Python plan's constants and parameter order against the .cu: the
    unit, the blocks, the ring's depth, the dtype codes, the routes, the
    header, the tables' offsets, and struct Geo's fields in PARAMS' order."""
    src = CU.read_text()
    const = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)", src)}
    assert (const["kVecBytes"], const["kMaxThreads"], const["kChunkThreads"],
            const["kRingThreads"], const["kMaxStages"]) == (
        RP.VEC_BYTES, RP.MAX_THREADS, RP.CHUNK_THREADS, RP.RING_THREADS, RP.MAX_STAGES)
    assert const["kHeader"] == len(RP.HEADER)
    codes = dict(re.findall(r"DT_(\w+) = (\d+)", src))
    assert {"F32": 0, "BF16": 1, "F64": 2} == {k: int(v) for k, v in codes.items()}
    assert RP._DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
    routes = dict(re.findall(r"ROUTE_(\w+) = (\d+)", src))
    assert {k.lower(): int(v) for k, v in routes.items()} == RP.ROUTES
    table = RP.PARAMS[RP.PARAMS.index("plane_tiles0"):]
    for name, first in (("kPlaneTiles", "plane_tiles0"), ("kRows", "hr0"), ("kPieces", "nw0"),
                        ("kWidth", "wp0"), ("kRowTiles", "row_tiles0")):
        assert const[name] == table.index(first)
    assert const["kTable"] == len(table)
    geo = re.search(r"struct Geo \{(.*?)\};", src, re.S).group(1)
    fields = []
    for kind, names in re.findall(r"^\s*(int|FastDiv) ([\w, ]+);", geo, re.M):
        for name in names.split(","):
            name = name.strip()
            fields += [f"{name}_{x}" for x in "dms"] if kind == "FastDiv" else [name]
    assert tuple(fields) == RP.PARAMS[len(RP.HEADER):RP.PARAMS.index("plane_tiles0")]


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

    names = re.findall(r"__global__ void __launch_bounds__\(k\w+\)\n(\w+)", CU.read_text())
    assert names == ["replication_pad_fwd_kernel", "replication_pad_fwd_chunks_kernel",
                     "replication_pad_bwd_kernel", "replication_pad_bwd_ring_kernel"]
    for name in names:
        assert kernel_class(f"void (anonymous namespace)::{name}<__nv_bfloat16, 8>"
                            f"(__nv_bfloat16 const*, __nv_bfloat16*, Box)") == "pad"


# ---------------------------------------------------------------------------
# the launches at every pad shape chip_smoke.py's phase 2 runs: the
# generator's stem, trunk and head pads at the decode's batches (8, 3), the
# single pass (1 x 128 x 256 x 256), the train step's generator batches (16,
# 8, 2, 1), a depth shard of the spatial step (depth pad 0) and the two odd
# boxes; the ring backward's tile plan (replication_pad.tile_plan) at each


def _generator_pads(n, spatial):
    full = tuple(spatial)
    return [((n, 1) + full, (3,) * 6), ((n, 128) + tuple(s // 4 for s in full), (1,) * 6),
            ((n, 32) + full, (3,) * 6)]


PAD_CASES = sorted({case for n, spatial in ((8, (64,) * 3), (3, (64,) * 3), (1, (128, 256, 256)),
                                            (16, (64,) * 3), (2, (64,) * 3), (1, (64,) * 3))
                    for case in _generator_pads(n, spatial)}
                   | {((1, 1, 38, 64, 64), (0, 0, 3, 3, 3, 3)),
                      ((1, 128, 10, 16, 16), (0, 0, 1, 1, 1, 1)),
                      ((1, 32, 38, 64, 64), (0, 0, 3, 3, 3, 3)),
                      ((2, 6, 1, 17, 23), (3, 2, 1, 3, 0, 2)),
                      ((3, 128, 5, 1, 9), (1, 0, 2, 1, 1, 1))})
PAD_IDS = ["x".join(map(str, s)) + "-" + "".join(map(str, p)) for s, p in PAD_CASES]


def _plan(case, itemsize=2):
    shape, pads = case
    return RP.tile_plan(shape[0], shape[1], shape[2:], pads, itemsize)


def _folds(i, n, lo, hi):
    return RP.fold_range(i, n, lo, hi)


def _bwd_spans(plan):
    """The backward's input-gradient spans and the gradient pieces it stages
    for them, each (first element, elements)."""
    (d_, h_, w_), (do, ho, wo), p, c = plan.box, plan.out, plan.pads, plan.c
    dx, g = [], []
    for n, d, h0, h1, w0, w1 in RP.tile_table(plan).tolist():
        dx.append(((((n * d_ + d) * h_ + h0) * w_ + w0) * c, ((h1 - h0) * w_ + w1 - w0 + 1) * c))
        od0, od1 = _folds(d, d_, p[0], p[1])
        oh0, oh1 = _folds(h0, h_, p[2], p[3])[0], _folds(h1, h_, p[2], p[3])[1]
        ow0, ow1 = _folds(w0, w_, p[4], p[5])[0], _folds(w1, w_, p[4], p[5])[1]
        for od in range(od0, od1 + 1):
            for oh in range(oh0, oh1 + 1):
                g.append(((((n * do + od) * ho + oh) * wo + ow0) * c, (ow1 - ow0 + 1) * c))
    return np.array(dx, np.int64).reshape(-1, 2), np.array(g, np.int64).reshape(-1, 2)


def _tile_exactly(spans, total):
    """The spans cover [0, total) exactly once."""
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    ends = spans[:, 0] + spans[:, 1]
    return (spans[:, 1] > 0).all() and spans[0, 0] == 0 and (spans[1:, 0] == ends[:-1]).all() \
        and ends[-1] == total


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("case", PAD_CASES, ids=PAD_IDS)
def test_forward_covers_every_destination_chunk_once(case, itemsize, aligned):
    """The forward writes every output element once: on the unit path a
    block an output row whose threads cover its units, elsewhere (C = 1 or
    6, an unaligned source) the chunk kernel, whose 16-byte chunks cover
    each output plane exactly once (a chunk at a plane's end is written
    part by part, by both planes that share it)."""
    shape, pads = case
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    got = _params(shape, pads, shape[2:], dtype, aligned, False)
    unit = aligned and shape[1] * itemsize % 16 == 0
    assert got["route"] == RP.ROUTES["rows" if unit else "chunks"]
    if unit:
        units = got["Wo"] * got["C"] // got["vec"]
        assert got["grid"] == got["N"] * got["Do"] * got["Ho"]
        assert min(units, RP.MAX_THREADS) <= got["threads"] <= RP.MAX_THREADS
    else:
        assert _chunks_cover_planes(got, itemsize)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("case", PAD_CASES, ids=PAD_IDS)
def test_tile_plan_covers_every_input_row_once(case, itemsize):
    """The backward writes each input row once, and the gradient pieces its
    tiles stage cover the output gradient exactly once: each byte of g is
    read once."""
    plan = _plan(case, itemsize)
    n, c = case[0][:2]
    dx, g = _bwd_spans(plan)
    assert _tile_exactly(dx, n * int(np.prod(plan.box)) * c)
    assert _tile_exactly(g, n * int(np.prod(plan.out)) * c)


@pytest.mark.parametrize("case", PAD_CASES, ids=PAD_IDS)
def test_tile_plan_balances_bytes(case):
    """Block b walks tiles b, b + grid, ...: every tile is walked by one
    block, and the bytes a block moves are within the mean plus three of
    the largest tiles; where a block walks 20 tiles or more, within 10% of
    the mean (the tiles are sized by bytes)."""
    plan = _plan(case)
    i, o = RP.tile_costs(plan)
    costs = i + o
    assert sorted(t for b in range(plan.grid) for t in RP.block_tiles(plan, b)) == \
        list(range(plan.tiles))
    blocks = np.array([costs[list(RP.block_tiles(plan, b))].sum() for b in range(plan.grid)])
    mean = blocks.mean()
    assert blocks.max() <= mean + 3 * costs.max()
    if plan.tiles >= 20 * plan.grid:
        assert blocks.max() <= 1.1 * mean
    n, d, h0, h1, w0, w1 = RP.tile_at(plan, plan.tiles // 2)  # one tile's bytes by hand
    (d_, h_, w_), p, unit = plan.box, plan.pads, plan.c * plan.itemsize
    nd = np.subtract(*_folds(d, d_, p[0], p[1])[::-1]) + 1
    nh = _folds(h1, h_, p[2], p[3])[1] - _folds(h0, h_, p[2], p[3])[0] + 1
    nw = _folds(w1, w_, p[4], p[5])[1] - _folds(w0, w_, p[4], p[5])[0] + 1
    assert (i[plan.tiles // 2], o[plan.tiles // 2]) == (
        (h1 - h0 + 1) * (w1 - w0 + 1) * unit, nd * nh * nw * unit)


def _staged(plan):
    """The most bytes a tile of ``plan`` stages, as the ring kernel stages
    them wherever the gradient starts: its gradient rows at every depth of
    its fold, a copy a depth for whole rows, a copy a row (each in a 16-byte
    slot) for a piece."""
    (d_, h_, w_), (do, ho, wo), p, c, es = plan.box, plan.out, plan.pads, plan.c, plan.itemsize
    most = 0
    for n, d, h0, h1, w0, w1 in RP.tile_table(plan).tolist():
        nd = np.subtract(*_folds(d, d_, p[0], p[1])[::-1]) + 1
        oh0, oh1 = _folds(h0, h_, p[2], p[3])[0], _folds(h1, h_, p[2], p[3])[1]
        ow0, ow1 = _folds(w0, w_, p[4], p[5])[0], _folds(w1, w_, p[4], p[5])[1]
        piece = (ow1 - ow0 + 1) * c * es
        if w0 == 0 and w1 == w_ - 1:
            most = max(most, nd * RP.staged_bytes((oh1 - oh0) * wo * c * es + piece))
        else:
            most = max(most, nd * (oh1 - oh0 + 1) * ((piece + 30) // 16 * 16))
    return most


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("case", PAD_CASES, ids=PAD_IDS)
def test_tile_plan_stages_fit(case, itemsize):
    """Each tile's staged bytes fit the stage the plan asks for; on the
    unit path the backward takes the ring where the stage fits half of it
    (two stages or more, the ring in a block's share of the
    multiprocessor's shared memory), the row kernel elsewhere."""
    plan = _plan(case, itemsize)
    assert _staged(plan) <= plan.stage and plan.stage % 16 == 0
    assert plan.stages == min(RP.MAX_STAGES, RP.RING_BYTES // plan.stage)
    assert plan.stages * plan.stage <= RP.RING_BYTES
    assert RP.BLOCKS_PER_SM * (RP.RING_BYTES + 2048) <= 228 * 1024
    (n, c, *box), pads = case
    dtype = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}[itemsize]
    got = _params((n, c, *RP.out_shape(box, pads)), pads, tuple(box), dtype, True, True)
    ring = c * itemsize % 16 == 0 and plan.stages >= 2
    assert got["route"] == RP.ROUTES["ring" if ring else "rows"]
    if ring:
        assert (got["stage_bytes"], got["stages"], got["grid"]) == (plan.stage, plan.stages,
                                                                     plan.grid)


# wide voxels: the head's pad at --ngf 128 in float32 (512 bytes a voxel),
# float64 at C = 64 and 128, and wider
WIDE = [(110, 4), (128, 4), (218, 2), (64, 8), (55, 8), (128, 8), (256, 8), (1024, 4)]


@pytest.mark.parametrize("pad", [1, 3])
@pytest.mark.parametrize("c,itemsize", WIDE, ids=[f"C{c}x{i}" for c, i in WIDE])
def test_wide_voxels_still_launch(c, itemsize, pad):
    """Every voxel width still launches, both ways: the ring where a
    corner's fold (16 gradient rows of 4 voxels at pad 3) fits half of it
    (C = 128 in float32 and C = 64 in float64 among them, at three stages),
    the row kernel beyond (C = 128 in float64 at pad 3)."""
    dtype = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}[itemsize]
    box, pads = (9, 10, 11), (pad,) * 6
    out = RP.out_shape(box, pads)
    fwd = _params((2, c, *box), pads, box, dtype, True, False)
    bwd = _params((2, c, *out), pads, box, dtype, True, True)
    plan = RP.tile_plan(2, c, box, pads, itemsize)
    unit = c * itemsize % 16 == 0
    assert fwd["route"] == RP.ROUTES["rows" if unit else "chunks"]
    assert bwd["route"] == RP.ROUTES["ring" if unit and plan.stages >= 2 else "rows"]
    assert _staged(plan) <= plan.stage
    if pad == 3 and (c * itemsize) in (512,):
        assert bwd["route"] == RP.ROUTES["ring"] and bwd["stages"] == 3
    if pad == 3 and (c, itemsize) == (128, 8):
        assert bwd["route"] == RP.ROUTES["rows"] and bwd["grid"] == 2 * 9 * 10
        assert bwd["threads"] == 11 * c // bwd["vec"]  # a block an input row, a unit a thread


@pytest.mark.parametrize("case", PAD_CASES, ids=PAD_IDS)
def test_tile_at_is_the_tables_row(case):
    """The kernels' decode of a tile index (tile_at, step for step as
    csrc/replication_pad.cu's) gives the table's tile, at every tile or, for
    the larger plans, at 2000 spread through them; the tables' tiles per
    plane and per sample match the row tiles the kernel reads."""
    plan = _plan(case)
    table = RP.tile_table(plan)
    assert len(table) == plan.tiles == plan.n * plan.sample_tiles
    for t in np.unique(np.linspace(0, plan.tiles - 1, min(plan.tiles, 2000)).astype(int)):
        assert RP.tile_at(plan, int(t)) == tuple(table[t])
    rows = RP.row_tiles(plan)
    for dc in range(3):
        assert plan.plane_tiles[dc] == sum(rows[3 * dc + hc] * plan.classes[3 * dc + hc][1]
                                           for hc in range(3))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 7, 16, 70, 128, 140, 255, 256, 280, 1048, 2240,
                               4480, 8384, 65521, 1 << 20, (1 << 31) - 1])
def test_fast_divisor_is_exact(d):
    """The kernels' division by a per-shape constant, (umulhi(n, m) + n) >>
    s, is n // d for every n the kernels divide (0 <= n < 2^31): checked at
    the ends, around each multiple near them and at random."""
    div = RP.fast_divisor(d)
    assert div[0] == d and 0 < div[1] <= 1 << 32 and div[2] < 32
    rs = np.random.RandomState(d % 1000)
    ns = {0, 1, d - 1, d, d + 1, (1 << 31) - 1, (1 << 31) - 2}
    ns |= {q * d + r for q in (1, 2, 3, ((1 << 31) - 1) // d - 1) for r in (-1, 0, 1)}
    ns |= set(rs.randint(0, 1 << 31, 500).tolist())
    for n in ns:
        if 0 <= n < 1 << 31:
            assert RP.fast_div(n, div) == n // d, n


# ---------------------------------------------------------------------------
# the kernels' chunk-to-source mapping, modelled byte for byte from the
# launch's own parameters: the forward's row kernel (16-byte units) and chunk
# kernel (16-byte chunks of a plane, each element at its clamped index by the
# fast divisors, the ragged ends), the backward's row kernel (each voxel's
# fold straight from g) and ring (each tile staged as the bulk copies stage
# it: the source widened to whole 16-byte units, its skew kept; the
# bulk-stored inner rows, the per-unit folds)


def _raw(t: torch.Tensor) -> np.ndarray:
    """The bytes of an (N, C, D, H, W) tensor laid out NDHWC."""
    return t.permute(0, 2, 3, 4, 1).reshape(-1).view(torch.uint8).numpy().copy()


def _unraw(buf: np.ndarray, shape, dtype) -> torch.Tensor:
    n, c, d, h, w = shape
    t = torch.from_numpy(buf[:n * c * d * h * w * dtype.itemsize].copy()).view(dtype)
    return t.reshape(n, d, h, w, c).permute(0, 4, 1, 2, 3)


def _widen(b: np.ndarray, es: int):
    if es == 2:
        return np.frombuffer((b.view(np.uint16).astype(np.uint32) << 16).tobytes(), np.float32)[0]
    return np.frombuffer(b.tobytes(), np.float32 if es == 4 else np.float64)[0]


def _narrow(v, es: int) -> np.ndarray:
    if es == 2:
        return torch.tensor([float(v)]).to(torch.bfloat16).view(torch.uint8).numpy()
    return np.frombuffer((np.float32(v) if es == 4 else np.float64(v)).tobytes(), np.uint8)


def _stage_copy(buf: np.ndarray, src: int, length: int):
    """A bulk copy's bytes: the 16-byte units around [src, src + length),
    and where src lands in them."""
    a, b = src & ~15, (src + length + 15) & ~15
    return buf[a:b].copy(), src & 15


def _div(got, name):
    return got[f"{name}_d"], got[f"{name}_m"] & 0xFFFFFFFF, got[f"{name}_s"]


def _model_fwd(x: torch.Tensor, pads, off: int) -> torch.Tensor:
    n, c, d_, h_, w_ = x.shape
    es, epc = x.element_size(), 16 // x.element_size()
    got = _params(tuple(x.shape), pads, (d_, h_, w_), x.dtype, off * es % 16 == 0, False)
    do, ho, wo = got["Do"], got["Ho"], got["Wo"]
    pd, ph, pw = pads[0], pads[2], pads[4]
    xbuf = np.zeros(off * es + x.numel() * es + 64, np.uint8)
    xbuf[off * es:off * es + x.numel() * es] = _raw(x)
    y = np.zeros(n * c * do * ho * wo * es, np.uint8)
    clamp = lambda v, hi: min(max(v, 0), hi)

    def src(k, od, oh, ow, cc):  # the byte of x an output element reads
        return off * es + ((((k * d_ + clamp(od - pd, d_ - 1)) * h_ + clamp(oh - ph, h_ - 1))
                            * w_ + clamp(ow - pw, w_ - 1)) * c + cc) * es

    if got["route"] == RP.ROUTES["rows"]:  # a block an output row, a unit a thread
        units = got["vox_d"]
        assert units * 16 == c * es and off * es % 16 == 0
        for row in range(got["grid"]):
            oh, od, k = row % ho, (row // ho) % do, row // (ho * do)
            for j in range(wo * units):
                ow, u = divmod(j, units)
                a = src(k, od, oh, ow, 0) + 16 * u
                assert a % 16 == 0
                y[(row * wo * units + j) * 16:][:16] = xbuf[a:a + 16]
        return _unraw(y, (n, c, do, ho, wo), x.dtype)
    assert got["route"] == RP.ROUTES["chunks"]
    length, row_div, vox_div = ho * got["row_d"], _div(got, "row"), _div(got, "vox")
    for b in range(got["grid"]):  # a plane's blocks, a 16-byte chunk a thread
        plane, part = divmod(b, got["plane_blocks"])
        od, k = plane % do, plane // do
        first = plane * length
        lead = first & (epc - 1)
        for t in range(RP.CHUNK_THREADS):
            j = part * RP.CHUNK_THREADS + t
            e0 = j * epc - lead
            if e0 >= length:
                continue
            assert (first - lead + j * epc) * es % 16 == 0
            for i in range(epc):
                e = e0 + i
                if 0 <= e < length:
                    oh = RP.fast_div(e, row_div)
                    kk = e - oh * row_div[0]
                    ow = RP.fast_div(kk, vox_div)
                    a = src(k, od, oh, ow, kk - ow * c)
                    y[(first + e) * es:][:es] = xbuf[a:a + es]
    return _unraw(y, (n, c, do, ho, wo), x.dtype)


def _fold(read, spatial, pads, d, h, w, cc, es):
    """The D fold of the H folds of the W folds of voxel (d, h, w)'s terms,
    each from its first term, in float32 (float64 for float64): read(od,
    oh, ow, cc) gives a term's bytes."""
    acc = np.float64 if es == 8 else np.float32
    (d0, d1), (h0, h1), (w0, w1) = (_folds(i, s, pads[2 * a], pads[2 * a + 1])
                                    for a, (i, s) in enumerate(zip((d, h, w), spatial)))
    acc_d = None
    for od in range(d0, d1 + 1):
        acc_h = None
        for oh in range(h0, h1 + 1):
            acc_w = acc(_widen(read(od, oh, w0, cc), es))
            for ow in range(w0 + 1, w1 + 1):
                acc_w = acc(acc_w + acc(_widen(read(od, oh, ow, cc), es)))
            acc_h = acc_w if acc_h is None else acc(acc_h + acc_w)
        acc_d = acc_h if acc_d is None else acc(acc_d + acc_h)
    return _narrow(acc_d, es)


def _model_bwd(g: torch.Tensor, pads, box, off: int) -> torch.Tensor:
    n, c, do, ho, wo = g.shape
    d_, h_, w_ = box
    es = g.element_size()
    got = _params(tuple(g.shape), pads, tuple(box), g.dtype, off * es % 16 == 0, True)
    pd, ph, pw = pads[0], pads[2], pads[4]
    gbuf = np.zeros(off * es + g.numel() * es + 64, np.uint8)
    gbuf[off * es:off * es + g.numel() * es] = _raw(g)
    dx = np.zeros(n * c * d_ * h_ * w_ * es, np.uint8)
    if got["route"] == RP.ROUTES["rows"]:  # a block an input row, each fold from g
        for k in range(n):
            def read(od, oh, ow, cc):
                a = off * es + ((((k * do + od) * ho + oh) * wo + ow) * c + cc) * es
                return gbuf[a:a + es]
            for d in range(d_):
                for h in range(h_):
                    for w in range(w_):
                        for cc in range(c):
                            dx[((((k * d_ + d) * h_ + h) * w_ + w) * c + cc) * es:][:es] = \
                                _fold(read, box, pads, d, h, w, cc, es)
        return _unraw(dx, (n, c, *box), g.dtype)
    assert got["route"] == RP.ROUTES["ring"] and off * es % 16 == 0
    plan = RP.launch_plan(tuple(g.shape), pads, tuple(box), g.dtype, True, True)[4]
    assert (got["stage_bytes"], got["tiles"]) == (plan.stage, plan.tiles)
    for t in range(plan.tiles):
        k, d, h0, h1, w0, w1 = RP.tile_at(plan, t)
        od0, od1 = _folds(d, d_, pd, pads[1])
        nd = od1 - od0 + 1
        oh0, oh1 = _folds(h0, h_, ph, pads[3])[0], _folds(h1, h_, ph, pads[3])[1]
        ow0, ow1 = _folds(w0, w_, pw, pads[5])[0], _folds(w1, w_, pw, pads[5])[1]
        whole, rows = w0 == 0 and w1 == w_ - 1, oh1 - oh0 + 1
        row_bytes, piece = wo * c * es, (ow1 - ow0 + 1) * c * es
        slot = (piece + 30) & ~15
        od_slot = (((rows - 1) * row_bytes + piece + 30) & ~15) if whole else rows * slot
        assert nd * od_slot <= plan.stage
        src0 = off * es + ((((k * do + od0) * ho + oh0) * wo + ow0) * c) * es
        stage = np.zeros(plan.stage, np.uint8)
        bases = {}
        for i in range(nd):
            srci = src0 + i * ho * row_bytes
            if whole:
                data, skew = _stage_copy(gbuf, srci, (rows - 1) * row_bytes + piece)
                stage[i * od_slot:i * od_slot + len(data)] = data
                for r in range(rows):
                    bases[i, r] = i * od_slot + skew + r * row_bytes
            else:
                for r in range(rows):
                    data, skew = _stage_copy(gbuf, srci + r * row_bytes, piece)
                    stage[i * od_slot + r * slot:][:len(data)] = data
                    bases[i, r] = i * od_slot + r * slot + skew

        def read(od, oh, ow, cc):  # a staged term
            a = bases[od - od0, oh - oh0] + ((ow - ow0) * c + cc) * es
            return stage[a:a + es]

        dst = ((((k * d_ + d) * h_ + h0) * w_ + w0) * c) * es
        wa, wb = max(w0, 1), min(w1, w_ - 2)
        if nd == 1 and rows == h1 - h0 + 1 and wa <= wb:  # bulk-stored inner rows
            for r in range(rows):
                row = dst + r * w_ * c * es
                a = bases[0, r] + (wa + pw - ow0) * c * es
                dx[row + (wa - w0) * c * es:][:(wb - wa + 1) * c * es] = \
                    stage[a:a + (wb - wa + 1) * c * es]
                for w in [v for v in range(w0, w1 + 1) if not wa <= v <= wb]:
                    for cc in range(c):
                        dx[row + ((w - w0) * c + cc) * es:][:es] = \
                            _fold(read, box, pads, d, h0 + r, w, cc, es)
            continue
        for h in range(h0, h1 + 1):  # each unit summed whole, rounded once
            for w in range(w0, w1 + 1):
                for cc in range(c):
                    dx[dst + (((h - h0) * w_ + w - w0) * c + cc) * es:][:es] = \
                        _fold(read, box, pads, d, h, w, cc, es)
    return _unraw(dx, (n, c, *box), g.dtype)


MODEL_CASES = [((2, 1, 3, 5, 7), (2, 1, 1, 3, 3, 2)), ((2, 6, 1, 4, 5), (3, 2, 1, 3, 0, 2)),
               ((1, 32, 3, 4, 5), (1, 2, 0, 1, 2, 1)), ((1, 128, 2, 2, 3), (3,) * 6)]
MODEL_IDS = ["C1", "C6", "C32", "C128"]


@pytest.fixture(params=["tiles", "pieces"])
def plan_size(request, monkeypatch):
    """The ring's own tile sizes, or tiles so small every row is cut into
    pieces."""
    if request.param == "pieces":
        monkeypatch.setattr(RP, "TAU_MAX", 64)
        monkeypatch.setattr(RP, "TAU_MIN", 64)
    RP.tile_plan.cache_clear()
    RP.launch_plan.cache_clear()
    yield request.param
    RP.tile_plan.cache_clear()
    RP.launch_plan.cache_clear()


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", MODEL_CASES, ids=MODEL_IDS)
def test_kernel_model_forward_matches_plain(case, dtype, offset):
    """The forward's launch, modelled byte for byte from its parameters (the
    row kernel's units, the chunk kernel's chunks and fast divisors), gives
    replication_pad_fwd_plain's bits at C = 1, 6, 32 and 128, in bf16 and
    float32, from an aligned source and one an element past a 16-byte
    boundary."""
    shape, pads = case
    x = torch.from_numpy(np.random.RandomState(10).uniform(-1, 1, shape).astype(np.float32))
    x = x.to(dtype)
    assert torch.equal(_model_fwd(x, pads, offset), RP.replication_pad_fwd_plain(x, pads))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64],
                         ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("case", MODEL_CASES, ids=MODEL_IDS)
def test_kernel_model_backward_matches_plain(case, dtype, offset, plan_size):
    """The backward's launch, modelled byte for byte (the row kernel's
    folds from g; the ring's staging of each depth's gradient rows with
    their skews, its bulk-stored inner rows and per-unit folds), gives
    replication_pad_bwd_plain's bits, with the ring's own tiles and with
    every row cut into pieces."""
    shape, pads = case
    g_shape = shape[:2] + RP.out_shape(shape[2:], pads)
    g = torch.from_numpy(np.random.RandomState(11).uniform(-1, 1, g_shape)).to(dtype)
    assert torch.equal(_model_bwd(g, pads, shape[2:], offset),
                       RP.replication_pad_bwd_plain(g, pads, shape[2:]))
