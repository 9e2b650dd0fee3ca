"""The 7^3 single-channel convs of the port (mra_gan_tpu_torch/ops/conv.py:
``c7_convolution``, ``c7_convolution_input_grad``,
``c7_convolution_weight_grad``; kernels' wrappers and plain versions in
ops/kernels/conv7.py) on the CPU.

Two routes run here. The ops' own CPU route is F.conv3d and
torch.nn.grad.conv3d_input. The kernel route (what a bfloat16 CUDA tensor
takes: the spread and gather roles, the flipped weights, pad 6 for the
input gradient) runs with ``conv._on_kernels`` patched to accept CPU
tensors, so each wrapper runs its plain version (float32 F.conv3d rounded
once, as the kernels round). Both are held to F.conv3d's autograd and to
the JAX package's conv3d (mra_gan_tpu/ops/conv.py:35).

Bars: float32 at atol 1e-5 (the sums of up to 343 x 32 products at O(1)
scale in another order), and rtol 1e-5 besides against JAX, whose CPU conv
sums in its own order. bfloat16 against the float32 result of the same
bf16-rounded inputs: |got - ref| <= 2^-8 |ref| + 2^-12 max|ref|, that is
half an ulp of each element (one rounding of the output) plus 1/16 of an
ulp at the output's scale for the order of the float32 sums; the decode's
bar (mean 0.02, max 0.5 of a [-1, 1] output) is far looser."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from mra_gan_tpu.ops.conv import conv3d as jax_conv3d
from mra_gan_tpu_torch.models.networks import ResnetGenerator3D
from mra_gan_tpu_torch.ops import conv
from mra_gan_tpu_torch.ops.kernels import conv7
from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax

from torch_port_util import jax_forward, jax_generator, to_ncdhw, to_ndhwc

F32_ATOL = 1e-5
F32_RTOL = 1e-5  # against JAX: two float32 summation orders of up to 11k products

# (N, Cin, Cout, input box): both roles, N in {1, 3}, C in {4, 32}, 10^3-16^3 boxes
SHAPES = [(1, 1, 4, (10, 11, 12)), (3, 1, 32, (16, 13, 10)), (3, 4, 1, (12, 16, 11)),
          (1, 32, 1, (10, 10, 14)), (3, 1, 1, (11, 10, 16))]
IDS = [f"n{n}-{ci}to{co}" for n, ci, co, _ in SHAPES]


def _case(n, cin, cout, box, seed=0, bias=True):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (n, cin, *box)).astype(np.float32)
    w = (rs.randn(cout, cin, 7, 7, 7) / np.sqrt(cin * 343)).astype(np.float32)
    b = (0.1 * rs.randn(cout)).astype(np.float32) if bias else None
    out = tuple(s - 6 for s in box)
    g = rs.uniform(-1, 1, (n, cout, *out)).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return t(x), t(w), t(b), t(g)


def _grads(fn, x, w, b, g, dtype):
    """fn's output and the gradients of <fn(x, w, b), g> for x, w and b."""
    leaves = [t.detach().to(dtype).requires_grad_() for t in (x, w, b)]
    y = fn(*leaves)
    y.backward(g.to(dtype))
    return [y.detach()] + [t.grad for t in leaves]


@pytest.fixture
def kernel_route(monkeypatch):
    """Every tensor takes the kernel route: on the CPU, the wrappers' plain
    versions."""
    monkeypatch.setattr(conv, "_on_kernels", lambda t: True)


def _ref(x, w, b, g):
    return _grads(F.conv3d, x, w, b, g, torch.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ops_match_conv3d_float32(shape):
    x, w, b, g = _case(*shape)
    got = _grads(conv.c7_convolution, x, w, b, g, torch.float32)
    for a, r in zip(got, _ref(x, w, b, g)):
        torch.testing.assert_close(a, r, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_kernel_route_matches_conv3d_float32(shape, kernel_route):
    x, w, b, g = _case(*shape, seed=1)
    got = _grads(conv.c7_convolution, x, w, b, g, torch.float32)
    for a, r in zip(got, _ref(x, w, b, g)):
        torch.testing.assert_close(a, r, rtol=0, atol=F32_ATOL)


def _within_bf16_bar(got, ref) -> bool:
    err = (got.float() - ref).abs()
    return bool((err <= 2 ** -8 * ref.abs() + 2 ** -12 * ref.abs().max()).all())


@pytest.mark.parametrize("route", ["ops", "kernels"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_rounds_once(shape, route, monkeypatch):
    if route == "kernels":
        monkeypatch.setattr(conv, "_on_kernels", lambda t: True)
    x, w, b, g = (t.bfloat16() for t in _case(*shape, seed=2))
    got = _grads(conv.c7_convolution, x, w, b, g, torch.bfloat16)
    ref = _ref(*(t.float() for t in (x, w, b, g)))
    for name, a, r in zip(("y", "x", "weight", "bias"), got, ref):
        assert a.dtype == torch.bfloat16
        assert _within_bf16_bar(a, r), f"{route} {name}"


@pytest.mark.parametrize("route", ["ops", "kernels"])
def test_bias_gradient_alone(route, monkeypatch):
    """A frozen weight with a trainable bias: the bias gradient, and no other."""
    if route == "kernels":
        monkeypatch.setattr(conv, "_on_kernels", lambda t: True)
    x, w, b, g = _case(2, 4, 1, (12, 11, 10), seed=7)
    bt = b.clone().requires_grad_()
    conv.conv3d(x, w, bt).backward(g)
    ref = b.clone().requires_grad_()
    F.conv3d(x, w, ref).backward(g)
    torch.testing.assert_close(bt.grad, ref.grad, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=IDS[:4])
def test_kernel_route_matches_jax_conv3d(shape, kernel_route):
    """The forward and the input gradient against the JAX package's conv3d
    (NDHWC, DHWIO kernel) and its VJP, float32."""
    x, w, _, g = _case(*shape, seed=3, bias=False)
    jx, jw = jnp.asarray(to_ndhwc(x)), jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy())
    jy, vjp = jax.vjp(lambda a: jax_conv3d(a, jw), jx)
    (jgx,) = vjp(jnp.asarray(to_ndhwc(g)))
    xt = x.clone().requires_grad_()
    y = conv.conv3d(xt, w)
    y.backward(g)
    np.testing.assert_allclose(to_ndhwc(y), np.asarray(jy), rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(to_ndhwc(xt.grad), np.asarray(jgx), rtol=F32_RTOL,
                               atol=F32_ATOL)


@pytest.mark.parametrize("n_blocks", [6, 9])
def test_generator_through_the_kernel_route_matches_jax(n_blocks, kernel_route):
    """The whole generator, stem and head on the kernel route, against the
    JAX generator at the network parity bar (PARITY.md section 1)."""
    jnet, params = jax_generator(n_blocks=n_blocks, seed=10 + n_blocks)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    net = ResnetGenerator3D(1, 1, 4, n_blocks).eval()
    net.load_state_dict(state_dict_from_jax(params, f"resnet_{n_blocks}blocks"))
    conv7.reset_launches()
    with torch.inference_mode():
        got = to_ndhwc(net(to_ncdhw(x)))
    np.testing.assert_allclose(got, np.asarray(jax_forward(jnet, params)(x)),
                               rtol=1e-3, atol=1e-4)
    assert not any(conv7.LAUNCHES.values())  # no launch on the CPU


def test_generator_gradients_agree_between_routes(monkeypatch):
    """One generator's loss gradients, every parameter and the input, with
    the stem and head on the ops' CPU route and on the kernel route, float32."""
    torch.manual_seed(0)
    net = ResnetGenerator3D(1, 1, 4, 6)
    for p in net.parameters():
        p.data.normal_(0, 0.2)
    x = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, (2, 1, 16, 16, 16))
                         .astype(np.float32))

    def grads():
        net.zero_grad()
        xt = x.clone().requires_grad_()
        net(xt).square().mean().backward()
        # the norm-dead biases are detached: no gradient on either route
        return [xt.grad] + [p.grad.clone() for p in net.parameters() if p.grad is not None]

    ref = grads()
    monkeypatch.setattr(conv, "_on_kernels", lambda t: True)
    got = grads()
    assert len(got) == len(ref) == 20  # the input, 18 conv weights and the head's bias
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=F32_ATOL)


def test_wide_train_step_through_the_kernel_route(monkeypatch):
    """A train step at ngf = 96 (three channel groups in the stem's and the
    head's kernels) with the 7^3 convs on the kernel route, against the same
    step in float64 on the ops' route: per network, the raw gradients' float32
    error is at most twice that of the ops' route in float32 plus 1e-4 of the
    network's largest gradient. (At this width the step's float32 gradients
    of the stem weight are off by ~0.7% of that scale on either route: the
    network amplifies the rounding.)"""
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step

    rs = np.random.RandomState(8)
    a, b = (torch.from_numpy(rs.uniform(-1, 1, (1, 1, 16, 16, 16))) for _ in range(2))

    def step_grads(dtype):
        cfg = CycleGANConfig(ngf=96, ndf=4, net_g="resnet_6blocks", net_d="n_layers",
                             n_layers_d=2, norm="instance", gan_mode="lsgan", pool_size=0,
                             dtype=dtype)
        state = create_state(cfg, 3, (16, 16, 16), device="cpu")
        make_train_step(cfg)(state, a.to(dtype), b.to(dtype), 2e-4)
        return {name: {k: p.grad.double() for k, p in net.named_parameters() if p.grad is not None}
                for name, net in state.nets.items()}

    ref, ops = step_grads(torch.float64), step_grads(torch.float32)
    monkeypatch.setattr(conv, "_on_kernels", lambda t: True)
    conv7.reset_launches()
    got = step_grads(torch.float32)
    assert not any(conv7.LAUNCHES.values())  # no launch on the CPU
    assert got["g_a"]["model.1.weight"].shape == (96, 1, 7, 7, 7)
    for name, grads in ref.items():
        assert got[name].keys() == ops[name].keys() == grads.keys()
        scale = max(float(g.abs().max()) for g in grads.values())
        err = max(float((got[name][k] - g).abs().max()) for k, g in grads.items())
        ops_err = max(float((ops[name][k] - g).abs().max()) for k, g in grads.items())
        assert err <= 2 * ops_err + 1e-4 * scale, f"{name}: {err:.3e}, ops {ops_err:.3e}"


@pytest.mark.parametrize("cin, cout, k, stride, padding, routed", [
    (1, 32, 7, 1, 0, True), (32, 1, 7, 1, 0, True), (1, 1, 7, 1, 0, True),
    (1, 32, 7, (1, 1, 1), (0, 0, 0), True), (32, 32, 7, 1, 0, False), (1, 32, 7, 1, 3, False),
    (32, 1, 7, 1, (0, 3, 3), False), (1, 32, 7, 2, 0, False), (4, 8, 3, 1, 1, False),
    (1, 32, 3, 1, 0, False), (32, 1, 3, 1, 0, False)])
def test_routing_rule(cin, cout, k, stride, padding, routed):
    """conv3d sends exactly the 7^3, stride-1, unpadded, one-channel-side
    convs to the c7 op, and everything else to aten.convolution."""
    assert conv.single_channel_7((cout, cin, k, k, k), stride, padding) is routed
    x = torch.zeros(1, cin, 12, 12, 12)
    w = torch.zeros(cout, cin, k, k, k)
    with FlopCounterMode(display=False) as counter:
        conv.conv3d(x, w, torch.zeros(cout), stride, padding)
    ops = {str(op) for op in counter.get_flop_counts()["Global"]}
    assert ops == ({"mra_torch.c7_convolution"} if routed else {"aten.convolution"})


def _counts(fn, x, w, b, g):
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    with FlopCounterMode(display=False) as counter:
        fn(*leaves).backward(g)
    return counter.get_flop_counts()["Global"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flop_counts_equal_aten(shape):
    """Forward, input gradient and weight gradient: each op's count equals
    aten's for the same work, and the total is the same."""
    x, w, b, g = _case(*shape)
    ours = {str(k): v for k, v in _counts(conv.c7_convolution, x, w, b, g).items()}
    aten = {str(k): v for k, v in _counts(F.conv3d, x, w, b, g).items()}
    fwd = aten["aten.convolution"]
    assert ours["mra_torch.c7_convolution"] == fwd
    assert ours["mra_torch.c7_convolution_input_grad"] == fwd
    assert ours["mra_torch.c7_convolution_weight_grad"] == fwd
    assert aten["aten.convolution_backward"] == 2 * fwd
    assert sum(ours.values()) == sum(aten.values())


def test_flop_count_without_an_input_gradient():
    """An input that needs no gradient (a real image at the stem) costs the
    forward and the weight gradient only, as under aten."""
    x, w, b, g = _case(2, 1, 8, (12, 12, 12))
    wt = w.clone().requires_grad_()
    with FlopCounterMode(display=False) as counter:
        conv.conv3d(x, wt, b).backward(g)
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert set(counts) == {"mra_torch.c7_convolution", "mra_torch.c7_convolution_weight_grad"}
    assert counts["mra_torch.c7_convolution_weight_grad"] == counts["mra_torch.c7_convolution"]


def test_op_names_contain_convolution():
    """The benchmark counts the ops whose name contains 'convolution'."""
    for op in (torch.ops.mra_torch.c7_convolution, torch.ops.mra_torch.c7_convolution_input_grad,
               torch.ops.mra_torch.c7_convolution_weight_grad):
        assert "convolution" in str(op.default)


def test_meta_tensors_take_the_fake_route():
    """Shapes only (the benchmark's full-size FLOP count runs on meta)."""
    x = torch.empty(2, 32, 70, 70, 70, device="meta")
    w = torch.empty(1, 32, 7, 7, 7, device="meta")
    assert conv.conv3d(x, w).shape == (2, 1, 64, 64, 64)
    g = torch.empty(2, 1, 64, 64, 64, device="meta")
    assert conv.c7_convolution_input_grad(g, w).shape == (2, 32, 70, 70, 70)


@pytest.mark.parametrize("pad", [0, 6])
def test_plain_versions_round_once(pad):
    """The wrappers on the CPU: float32 F.conv3d rounded once, zero outside
    the box, the output box 2 pad - 6 larger; no launch counted."""
    rs = np.random.RandomState(6)
    a = torch.from_numpy(rs.uniform(-1, 1, (2, 1, 9, 10, 11)).astype(np.float32)).bfloat16()
    x = torch.from_numpy(rs.uniform(-1, 1, (2, 8, 9, 10, 11)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rs.randn(8, 7, 7, 7).astype(np.float32) / 50).bfloat16()
    conv7.reset_launches()
    y = conv7.conv7_spread(a, w, None, pad)
    z = conv7.conv7_gather(x, w, None, pad)
    box = conv7.out_shape((9, 10, 11), pad)
    assert y.shape == (2, 8, *box) and z.shape == (2, 1, *box)
    assert torch.equal(y, F.conv3d(a.float(), w.float()[:, None], None, 1, pad).bfloat16())
    assert torch.equal(z, F.conv3d(x.float(), w.float()[None], None, 1, pad).bfloat16())
    assert not any(conv7.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on CUDA raises."""
    w = torch.empty(4, 7, 7, 7, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv7.conv7_spread(torch.empty(1, 1, 9, 9, 9, device="meta", dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv7.conv7_gather(torch.empty(1, 4, 9, 9, 9, device="meta", dtype=torch.bfloat16)
                           .contiguous(memory_format=torch.channels_last_3d), w)


# ---------------------------------------------------------------------------
# the weight gradients (c7_convolution_weight_grad; conv7_wgrad_spread for
# the stem, conv7_wgrad_gather for the head, and their reduce pass)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_kernel_route_weight_and_bias_grads_match_conv3d(shape, kernel_route):
    """Both roles' weight gradient (and the live bias's) on the kernel
    route, with no input gradient asked for, against F.conv3d's autograd."""
    x, w, b, g = _case(*shape, seed=8)
    wt, bt = w.clone().requires_grad_(), b.clone().requires_grad_()
    conv.conv3d(x, wt, bt).backward(g)
    wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
    F.conv3d(x, wr, br).backward(g)
    torch.testing.assert_close(wt.grad, wr.grad, rtol=0, atol=F32_ATOL)
    torch.testing.assert_close(bt.grad, br.grad, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_kernel_route_weight_grad_matches_jax_vjp(shape, kernel_route):
    """The weight gradient against the VJP of the JAX package's conv3d
    (mra_gan_tpu/ops/conv.py:35) with respect to its DHWIO kernel, float32.
    The file's float32 bars are for O(1) results, which the forward gets by
    scaling the weights by 1/sqrt(fan-in); a weight gradient sums N x the
    output box's products, so the output gradient is scaled by
    1/sqrt(that count) here alike."""
    x, w, _, g = _case(*shape, seed=9, bias=False)
    g = g / np.sqrt(g.shape[0] * g[0, 0].numel())
    jx, jw = jnp.asarray(to_ndhwc(x)), jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy())
    _, vjp = jax.vjp(lambda k: jax_conv3d(jx, k), jw)
    (jgw,) = vjp(jnp.asarray(to_ndhwc(g)))
    wt = w.clone().requires_grad_()
    conv.conv3d(x, wt).backward(g)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 4, 1, 0).numpy(), np.asarray(jgw),
                               rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_weight_and_bias_grads_round_once(shape, kernel_route):
    """bfloat16 on the kernel route: the weight gradient is the wrappers'
    float32 conv3d_weight rounded once (bit for bit), the bias gradient the
    output gradient's float32 sum rounded once; both within the file's bar of
    the float32 gradients of the same bf16-rounded inputs."""
    x, w, b, g = (t.bfloat16() for t in _case(*shape, seed=10))
    wt, bt = w.clone().requires_grad_(), b.clone().requires_grad_()
    conv.conv3d(x, wt, bt).backward(g)
    wr, br = w.float().requires_grad_(), b.float().requires_grad_()
    F.conv3d(x.float(), wr, br).backward(g.float())
    once = torch.nn.grad.conv3d_weight(x.float(), w.shape, g.float()).bfloat16()
    assert wt.grad.dtype == bt.grad.dtype == torch.bfloat16
    assert torch.equal(wt.grad, once)
    assert torch.equal(bt.grad, g.float().sum((0, 2, 3, 4)).bfloat16())
    assert _within_bf16_bar(wt.grad, wr.grad) and _within_bf16_bar(bt.grad, br.grad)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ops_route_weight_grad_is_aten(shape):
    """Off the kernels (the CPU, float32 or float64 on CUDA) the weight
    gradient is aten's, bit for bit, as before the weight-gradient op."""
    x, w, _, g = _case(*shape, seed=11, bias=False)
    got = conv.c7_convolution_weight_grad(g, x, w)
    ref = torch.ops.aten.convolution_backward(g, x, w, None, [1] * 3, [0] * 3, [1] * 3, False,
                                              [0] * 3, 1, [False, True, False])[1]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_weight_grad_flop_count_equals_aten(shape):
    """The weight-gradient op's FLOP count is what aten counts for a weight
    gradient alone (torch.nn.grad.conv3d_weight's convolution_backward)."""
    x, w, _, g = _case(*shape, seed=12, bias=False)
    with FlopCounterMode(display=False) as ours:
        conv.c7_convolution_weight_grad(g, x, w)
    with FlopCounterMode(display=False) as aten:
        torch.nn.grad.conv3d_weight(x, w.shape, g)
    ours = {str(k): v for k, v in ours.get_flop_counts()["Global"].items()}
    aten = {str(k): v for k, v in aten.get_flop_counts()["Global"].items()}
    assert set(ours) == {"mra_torch.c7_convolution_weight_grad"}
    assert ours["mra_torch.c7_convolution_weight_grad"] == aten["aten.convolution_backward"] > 0


@pytest.mark.parametrize("cin, cout", [(1, 32), (32, 1)])
def test_weight_grad_fake_route_gives_the_weights_shape(cin, cout):
    """Meta tensors: the weight gradient has the weight's shape and dtype."""
    x = torch.empty(2, cin, 70, 70, 70, device="meta", dtype=torch.bfloat16)
    w = torch.empty(cout, cin, 7, 7, 7, device="meta", dtype=torch.bfloat16)
    g = torch.empty(2, cout, 64, 64, 64, device="meta", dtype=torch.bfloat16)
    gw = conv.c7_convolution_weight_grad(g, x, w)
    assert gw.shape == w.shape and gw.dtype == w.dtype and gw.device.type == "meta"


@pytest.mark.parametrize("kernel", ["conv7_wgrad_spread", "conv7_wgrad_gather"])
def test_wgrad_plain_versions_round_once(kernel):
    """The weight-gradient wrappers on the CPU: float32 conv3d_weight of the
    role, (C, 7, 7, 7), rounded once; no launch counted."""
    rs = np.random.RandomState(13)
    one = torch.from_numpy(rs.uniform(-1, 1, (2, 1, 9, 10, 11)).astype(np.float32)).bfloat16()
    field = torch.from_numpy(rs.uniform(-1, 1, (2, 8, 9, 10, 11)).astype(np.float32)).bfloat16()
    small = torch.from_numpy(rs.uniform(-1, 1, (2, 8, 3, 4, 5)).astype(np.float32)).bfloat16()
    conv7.reset_launches()
    if kernel == "conv7_wgrad_spread":  # a the input, g (C channels) the output gradient
        dw = conv7.conv7_wgrad_spread(one, small)
        ref = torch.nn.grad.conv3d_weight(one.float(), (8, 1, 7, 7, 7), small.float())[:, 0]
    else:  # x (C channels) the input, g the output gradient
        g = small[:, :1]
        dw = conv7.conv7_wgrad_gather(field, g)
        ref = torch.nn.grad.conv3d_weight(field.float(), (1, 8, 7, 7, 7), g.float())[0]
    assert dw.shape == (8, 7, 7, 7) and dw.dtype == torch.bfloat16
    assert torch.equal(dw, ref.bfloat16())
    assert not any(conv7.LAUNCHES.values())


@pytest.mark.parametrize("flip", [False, True])
def test_wgrad_reduce_plain_version(flip):
    """The reduce pass's plain version: the blocks' partials summed, the
    spare kx column and the channels past C dropped, the head's taps
    flipped on all three axes, one rounding."""
    rs = np.random.RandomState(14)
    partial = torch.from_numpy(rs.randn(3, conv7.GROUP, conv7.WGRAD_ROWS,
                                        conv7.WGRAD_COLS).astype(np.float32))
    c = 5
    dw = conv7.conv7_wgrad_reduce(partial, c, flip)
    want = partial.sum(0)[:c, :, :7].reshape(c, 7, 7, 7)
    if flip:
        want = torch.from_numpy(want.numpy()[:, ::-1, ::-1, ::-1].copy())
    assert dw.shape == (c, 7, 7, 7) and dw.dtype == torch.bfloat16
    assert torch.equal(dw, want.bfloat16())


def test_wgrad_wrappers_refuse_other_devices_and_dtypes():
    """No fallback: a tensor neither on the CPU nor on CUDA raises, and the
    kernels' argument check refuses another dtype, layout or box."""
    cl = torch.channels_last_3d
    one = torch.empty(1, 1, 9, 9, 9, device="meta", dtype=torch.bfloat16)
    field = torch.empty(1, 4, 3, 3, 3, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv7.conv7_wgrad_spread(one, field.contiguous(memory_format=cl))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv7.conv7_wgrad_gather(torch.empty(1, 4, 9, 9, 9, device="meta", dtype=torch.bfloat16)
                                 .contiguous(memory_format=cl), one[:, :, :3, :3, :3])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv7.conv7_wgrad_reduce(torch.empty(2, 32, 49, 8, device="meta"), 4, False)
    what = "conv7_wgrad_spread"
    g = torch.zeros(1, 4, 3, 3, 3, dtype=torch.bfloat16).contiguous(memory_format=cl)
    a = torch.zeros(1, 1, 9, 9, 9, dtype=torch.bfloat16)
    conv7.check_wgrad_tensors(g, a, 6, what)  # what the kernel takes
    with pytest.raises(TypeError, match="bfloat16"):
        conv7.check_wgrad_tensors(g.float(), a, 6, what)
    with pytest.raises(TypeError, match="bfloat16"):
        conv7.check_wgrad_tensors(g, a.half(), 6, what)
    with pytest.raises(ValueError, match="channels_last_3d"):
        conv7.check_wgrad_tensors(g.contiguous(), a, 6, what)
    with pytest.raises(ValueError, match="one-channel field"):
        conv7.check_wgrad_tensors(g, a[:, :, :8], 6, what)


# ---------------------------------------------------------------------------
# the spread's and the gather's persistent grids (host-side geometry)

# (N, input box) of phase 14's shard steps (chip_smoke CONV7_SHARD_BOXES)
SHARD_BOXES = ((2, (38, 70, 70)), (4, (70, 134, 134)), (1, (22, 70, 70)))
GRID_BOXES = [(64, 64, 64), (70, 70, 70)] + [b for _, b in SHARD_BOXES] + [(134, 262, 262),
                                                                         (75, 69, 71)]
# blocks the H100 holds at once (132 SMs; the spread three a SM, the gather
# one) and a small card whose blocks each walk many tiles
RESIDENT = {"spread": (396, 7), "gather": (132, 5)}


def _plan(kernel, n, out_box, resident, pad, c=32):
    if kernel == "spread":
        return conv7.spread_plan(n, out_box, resident, c)
    return conv7.gather_plan(n, out_box, resident, pad)


def _axis_partition(ranges, size):
    """The distinct ranges of an axis tile [0, size) exactly once."""
    ranges = sorted(set(ranges))
    assert ranges[0][0] == 0 and ranges[-1][1] == size
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("pad", [0, 6])
@pytest.mark.parametrize("box", GRID_BOXES, ids=["x".join(map(str, b)) for b in GRID_BOXES])
@pytest.mark.parametrize("kernel", ["spread", "gather"])
def test_grid_covers_every_output_once(kernel, box, pad):
    out_box = conv7.out_shape(box, pad)
    for n in (1, 3, 8, 16):
        for resident in RESIDENT[kernel]:
            plan = _plan(kernel, n, out_box, resident, pad)
            assert plan.grid <= resident and plan.grid <= plan.tiles
            walked = [t for b in range(plan.grid) for t in conv7.block_tiles(plan, b)]
            assert sorted(walked) == list(range(plan.tiles))  # each tile by one block, once
            extents = [conv7.tile_extent(plan, t) for t in walked]
            assert len(set(extents)) == len(extents)
            # the tiles are the product of the group, the sample and three
            # partitions of the box's axes
            for axis in range(3):
                _axis_partition([e[2 + axis] for e in extents], out_box[axis])
            zr, yr, xr = (sorted({e[2 + a] for e in extents}) for a in range(3))
            assert len(extents) == n * len(zr) * len(yr) * len(xr)
            assert {e[0] for e in extents} == {0}
            assert {e[1] for e in extents} == set(range(n))
    # and voxel by voxel where the box is small, for every chunk of channels
    if math.prod(out_box) <= 70 ** 3:
        c = 160 if kernel == "spread" else 32
        plan = _plan(kernel, 3, out_box, RESIDENT[kernel][1], pad, c)
        seen = np.zeros((plan.chunks, 3, *out_box), np.int32)
        for b in range(plan.grid):
            for t in conv7.block_tiles(plan, b):
                g, s, (z0, z1), (y0, y1), (x0, x1) = conv7.tile_extent(plan, t)
                seen[g, s, z0:z1, y0:y1, x0:x1] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("c", [1, 32, 40, 64, 65, 96, 128, 200])
def test_spread_grid_walks_each_channel_chunk_once(c):
    """A spread tile holds every channel up to 64, else one group of 32,
    the chunk the slowest index: every (chunk, voxel) once, and a block's
    walk enters each chunk at most once."""
    chunks = 1 if c <= 64 else -(-c // 32)
    for n, out_box in ((3, (10, 9, 33)), (1, (64, 64, 64))):
        for resident in (396, 7):
            plan = conv7.spread_plan(n, out_box, resident, c)
            assert plan.chunks == chunks and plan.tiles == chunks * n * math.prod(plan.counts)
            seen = {}
            for b in range(plan.grid):
                walk = [conv7.tile_extent(plan, t)[0] for t in conv7.block_tiles(plan, b)]
                assert walk == sorted(walk)  # the weights change only where the chunk does
                for t in conv7.block_tiles(plan, b):
                    e = conv7.tile_extent(plan, t)
                    seen[e] = seen.get(e, 0) + 1
            assert set(seen.values()) == {1}
            assert {e[0] for e in seen} == set(range(chunks))


def _kernel_constants():
    """The tiles' constants of csrc/conv7.cu, read from the source."""
    import re
    from pathlib import Path

    src = (Path(conv7.__file__).parent / "csrc" / "conv7.cu").read_text()
    found = {}
    for name in ("kSX", "kSY", "kSZ", "kGSlots", "kGMaxDepth", "kGroup", "kMaxGroups", "kWTZ",
                 "kWTY", "kWMaxSeg", "kWStages", "kWConsumers", "kWRows", "kWCols", "kMaxSmem"):
        m = re.search(rf"\b{name} = (\d+)", src)
        found[name] = int(m.group(1))
    found["kGMaxSegment"] = found["kGSlots"] - 6
    return found


def test_geometry_matches_the_kernels():
    k = _kernel_constants()
    assert conv7.SPREAD_TILE == (k["kSZ"], k["kSY"], k["kSX"])
    assert conv7.SPREAD_STORE_BOX == (k["kGroup"], k["kSX"], k["kSY"], k["kSZ"], 1)
    assert conv7.GATHER_SLOTS == k["kGSlots"]
    assert conv7.GATHER_MAX_SEGMENT == k["kGMaxSegment"]
    assert conv7.GATHER_LOAD_BOX == (k["kGroup"], k["kGSlots"], 1, 1)
    assert max(conv7.GATHER_DEPTHS) == k["kGMaxDepth"]
    assert conv7.GROUP == k["kGroup"]
    assert conv7.SPREAD_HELD == k["kGroup"] * k["kMaxGroups"]
    assert (conv7.WGRAD_TILE_DEPTH, conv7.WGRAD_TILE_ROWS) == (k["kWTZ"], k["kWTY"])
    assert conv7.WGRAD_MAX_SEGMENT == k["kWMaxSeg"]
    assert conv7.WGRAD_STAGES == k["kWStages"]
    assert conv7.WGRAD_PARTS == k["kWConsumers"]
    assert (conv7.WGRAD_ROWS, conv7.WGRAD_COLS) == (k["kWRows"], k["kWCols"])
    assert conv7.SMEM_LIMIT == k["kMaxSmem"]


@pytest.mark.parametrize("n", [1, 3, 8, 16])
@pytest.mark.parametrize("box", GRID_BOXES, ids=["x".join(map(str, b)) for b in GRID_BOXES])
def test_gather_tiles_fit_the_kernel(box, n):
    for pad in (0, 6):
        out_box = conv7.out_shape(box, pad)
        plan = conv7.gather_plan(n, out_box, 132, pad)
        tz, ty, tx = plan.tile
        assert tz in conv7.GATHER_DEPTHS or tz == out_box[0] < max(conv7.GATHER_DEPTHS)
        assert 1 <= tx <= conv7.GATHER_MAX_SEGMENT and tx + 6 <= conv7.GATHER_SLOTS
        assert ty >= -(-out_box[1] // max(conv7.GATHER_ROW_SPLITS))


@pytest.mark.parametrize("longest", [conv7.GATHER_MAX_SEGMENT, 16])
def test_segments_are_the_fewest_balanced(longest):
    for width in range(1, 700):
        count, length = conv7.segments(width, longest)
        assert length <= longest and count * length >= width > (count - 1) * length
        assert count == -(-width // longest)


@pytest.mark.parametrize("c", [1, 3, 4, 8, 12, 16, 24, 32, 40, 64])
@pytest.mark.parametrize("box", [(5, 6, 7), (7, 9, 11), (8, 8, 8)])
def test_takes_tma_only_where_every_stride_is_16_bytes(c, box):
    t = torch.zeros((2, c, *box), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    strides = [t.stride(i) * t.element_size() for i in (0, 2, 3, 4)]
    aligned = t.data_ptr() % 16 == 0
    assert conv7.takes_tma(t) == (aligned and all(s % 16 == 0 for s in strides))
    if aligned:
        assert conv7.takes_tma(t) == (c % 8 == 0)
    # not channels_last_3d, or off a 16-byte base: never
    assert not conv7.takes_tma(t.contiguous())
    flat = torch.zeros(t.numel() + 8, dtype=torch.bfloat16)
    off = flat[1:1 + t.numel()].view(2, *box, c).permute(0, 4, 1, 2, 3)
    assert off.is_contiguous(memory_format=torch.channels_last_3d)
    assert not conv7.takes_tma(off)


def test_one_channel_granules():
    assert conv7.one_channel_granules(70, 256) and conv7.one_channel_granules(262, 4)
    assert not conv7.one_channel_granules(71, 256)  # an odd row: voxel by voxel
    assert not conv7.one_channel_granules(70, 258)  # a base off 4 bytes



# ---------------------------------------------------------------------------
# the weight gradients' first pass (host-side geometry)

# the C-channel fields the weight gradients walk: the stem's output-gradient
# box (the input box less 6) and the head's input box
WGRAD_BOXES = sorted({conv7.out_shape(b, 0) for b in GRID_BOXES} | set(GRID_BOXES))
WGRAD_RESIDENT = (132, 7)  # the H100 (one block an SM), a small card


@pytest.mark.parametrize("box", WGRAD_BOXES, ids=["x".join(map(str, b)) for b in WGRAD_BOXES])
def test_wgrad_walk_covers_every_field_voxel_once(box):
    """Every block of every channel group walks its tiles in increasing
    order, and the walks together hold each (group, sample, tile) once; the
    tiles are the product of the sample and three partitions of the box."""
    for n in (1, 3, 8, 16):
        for resident in WGRAD_RESIDENT:
            plan = conv7.wgrad_plan(n, box, resident)
            assert plan.chunks == 1 and 1 <= plan.grid <= min(resident, plan.tiles)
            walks = [list(conv7.wgrad_walk(plan, b, 0)) for b in range(plan.grid)]
            assert all(w == sorted(w) and w for w in walks)
            walked = [t for w in walks for t in w]
            assert sorted(walked) == list(range(plan.tiles))
            extents = [conv7.tile_extent(plan, t) for t in walked]
            for axis in range(3):
                _axis_partition([e[2 + axis] for e in extents], box[axis])
            zr, yr, xr = (sorted({e[2 + a] for e in extents}) for a in range(3))
            assert len(extents) == n * len(zr) * len(yr) * len(xr)
            assert {e[1] for e in extents} == set(range(n))
    if math.prod(box) <= 70 ** 3:
        plan = conv7.wgrad_plan(3, box, WGRAD_RESIDENT[1])
        seen = np.zeros((3, *box), np.int32)
        for b in range(plan.grid):
            for t in conv7.wgrad_walk(plan, b, 0):
                _, s, (z0, z1), (y0, y1), (x0, x1) = conv7.tile_extent(plan, t)
                seen[s, z0:z1, y0:y1, x0:x1] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("c", [1, 4, 32, 40, 64, 96, 128])
def test_wgrad_walks_each_channel_group_once(c):
    """A group of 32 channels a grid (blockIdx.y): each group's tiles once,
    by grids that together fit the card (at least a block a group)."""
    groups = -(-c // conv7.GROUP)
    for n, box in ((3, (10, 9, 33)), (1, (64, 64, 64)), (16, (70, 70, 70))):
        for resident in WGRAD_RESIDENT:
            plan = conv7.wgrad_plan(n, box, resident, c)
            per_group = n * math.prod(plan.counts)
            assert plan.chunks == groups and plan.tiles == groups * per_group
            assert plan.grid == max(1, min(per_group, resident // groups))
            seen = {}
            for g in range(groups):
                for b in range(plan.grid):
                    for t in conv7.wgrad_walk(plan, b, g):
                        e = conv7.tile_extent(plan, t)
                        assert e[0] == g
                        seen[e] = seen.get(e, 0) + 1
            assert len(seen) == plan.tiles and set(seen.values()) == {1}


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("box", WGRAD_BOXES, ids=["x".join(map(str, b)) for b in WGRAD_BOXES])
def test_wgrad_tiles_fit_the_kernel(box, n):
    """A tile's row segment is even (no voxel pair straddles two rows), at
    most WGRAD_MAX_SEGMENT, the fewest balanced ones; the tile and its halo,
    two stages of them, fit the block's shared memory, and the next even
    segment would not."""
    plan = conv7.wgrad_plan(n, box, 132)
    tz, ty, xt = plan.tile
    assert (tz, ty) == (conv7.WGRAD_TILE_DEPTH, conv7.WGRAD_TILE_ROWS)
    assert xt % 2 == 0 and 2 <= xt <= conv7.WGRAD_MAX_SEGMENT
    count = -(-box[2] // conv7.WGRAD_MAX_SEGMENT)
    assert plan.counts[2] == count and (count - 1) * xt < box[2] <= count * xt
    assert conv7.wgrad_smem(xt) <= conv7.wgrad_smem(conv7.WGRAD_MAX_SEGMENT) <= conv7.SMEM_LIMIT
    assert conv7.wgrad_smem(conv7.WGRAD_MAX_SEGMENT + 2) > conv7.SMEM_LIMIT
