"""The stride-2 4^3 one-channel convs of the port (mra_gan_tpu_torch/ops/conv.py:
``c4s2_convolution``, ``c4s2_convolution_input_grad``,
``c4s2_convolution_weight_grad``; kernels' wrappers and plain versions in
ops/kernels/conv4s2.py) on the CPU: the PatchGAN's first conv and the
U-Net's outermost down conv.

Two routes run here. The ops' own CPU route is F.conv3d and aten's
convolution_backward. The kernel route (what a bfloat16 CUDA tensor takes)
runs with ``conv._on_kernels`` patched to accept CPU tensors, so each
wrapper runs its plain version (float32 F.conv3d, conv3d_input or
conv3d_weight rounded once, as the kernels round). Both are held to
F.conv3d's autograd, to the JAX package's conv3d (mra_gan_tpu/ops/conv.py:35)
and, on even boxes with pad 1, to conv3d_s2d_stride2
(mra_gan_tpu/ops/s2d.py:618, the form the JAX Conv3D takes for this conv),
and their VJPs.

Bars: float32 at atol 1e-5 (sums of up to 64 x 32 products at O(1) scale in
another order; a weight or bias gradient, a sum over N x the output box, at
its own scale), and rtol 1e-5 besides against JAX. bfloat16 against the
float32 result of the same bf16-rounded inputs: |got - ref| <= 2^-8 |ref| +
2^-12 max|ref|, half an ulp of each element (one rounding) plus 1/16 of an
ulp at the output's scale for the order of the float32 sums. Networks: the
PARITY.md section 1 bar (rtol 1e-3, atol 1e-4) on the forward and on every
gradient scaled to O(1)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from mra_gan_tpu.models.networks import define_d as jax_define_d
from mra_gan_tpu.models.networks import define_g as jax_define_g
from mra_gan_tpu.ops.conv import conv3d as jax_conv3d
from mra_gan_tpu.ops.s2d import conv3d_s2d_stride2
from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
from mra_gan_tpu_torch.models.networks import define_d, define_g
from mra_gan_tpu_torch.ops import conv
from mra_gan_tpu_torch.ops.kernels import conv4s2

from torch_port_util import jax_params, to_ncdhw, to_ndhwc

F32_ATOL = 1e-5
F32_RTOL = 1e-5

# (N, C, input box, pads): N in {1, 3}, C in {4, 32}, even and odd boxes, the
# PatchGAN's pads and the U-Net's depth shard's
SHAPES = [(1, 4, (8, 10, 12), (1, 1, 1)), (3, 32, (9, 11, 7), (1, 1, 1)),
          (3, 4, (10, 8, 12), (0, 1, 1)), (1, 32, (7, 9, 10), (0, 1, 1)),
          (3, 32, (12, 12, 12), (1, 1, 1)), (1, 4, (11, 8, 9), (0, 0, 0))]
IDS = ["n{}-c{}-{}-p{}".format(n, c, "x".join(map(str, b)), "".join(map(str, p)))
       for n, c, b, p in SHAPES]


def _case(n, c, box, pads, seed=0, bias=True):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (n, 1, *box)).astype(np.float32)
    w = (rs.randn(c, 1, 4, 4, 4) / 8.0).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32) if bias else None
    g = rs.uniform(-1, 1, (n, c, *conv4s2.out_shape(box, pads))).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return t(x), t(w), t(b), t(g)


def _grads(fn, x, w, b, g, dtype):
    """fn's output and the gradients of <fn(x, w, b), g> for x, w and b."""
    leaves = [t.detach().to(dtype).requires_grad_() for t in (x, w, b)]
    y = fn(*leaves)
    y.backward(g.to(dtype))
    return [y.detach()] + [t.grad for t in leaves]


def _ours(pads):
    return lambda x, w, b: conv.conv3d(x, w, b, 2, pads)


def _ref(pads):
    return lambda x, w, b: F.conv3d(x, w, b, 2, pads)


@pytest.fixture
def kernel_route(monkeypatch):
    """Every tensor takes the kernel route: on the CPU, the wrappers' plain
    versions."""
    monkeypatch.setattr(conv, "_on_kernels", lambda t: True)


@pytest.mark.parametrize("route", ["ops", "kernels"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_matches_conv3d_float32(shape, route, monkeypatch):
    if route == "kernels":
        monkeypatch.setattr(conv, "_on_kernels", lambda t: True)
    n, c, box, pads = shape
    x, w, b, g = _case(*shape)
    got = _grads(_ours(pads), x, w, b, g, torch.float32)
    for name, a, r in zip(("y", "x", "weight", "bias"), got,
                          _grads(_ref(pads), x, w, b, g, torch.float32)):
        # the weight and bias gradients sum N x the output box's terms: the
        # bar at their scale
        torch.testing.assert_close(a, r, rtol=0, atol=F32_ATOL * max(1.0, float(r.abs().max())),
                                   msg=name)


def _within_bf16_bar(got, ref) -> bool:
    err = (got.float() - ref).abs()
    return bool((err <= 2 ** -8 * ref.abs() + 2 ** -12 * ref.abs().max()).all())


@pytest.mark.parametrize("route", ["ops", "kernels"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_rounds_once(shape, route, monkeypatch):
    if route == "kernels":
        monkeypatch.setattr(conv, "_on_kernels", lambda t: True)
    n, c, box, pads = shape
    x, w, b, g = (t.bfloat16() for t in _case(*shape, seed=2))
    got = _grads(_ours(pads), x, w, b, g, torch.bfloat16)
    ref = _grads(_ref(pads), *(t.float() for t in (x, w, b, g)), torch.float32)
    for name, a, r in zip(("y", "x", "weight", "bias"), got, ref):
        assert a.dtype == torch.bfloat16
        assert _within_bf16_bar(a, r), f"{route} {name}"


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_kernel_route_matches_jax_conv3d(shape, kernel_route):
    """The forward, the input gradient and the weight gradient against the
    JAX package's conv3d (NDHWC, a (4, 4, 4, 1, C) kernel, per-axis padding)
    and its VJP, float32. A weight gradient sums N x the output box's
    products, so the output gradient is scaled by 1/sqrt(that count) to keep
    it O(1)."""
    n, c, box, pads = shape
    x, w, _, g = _case(*shape, seed=3, bias=False)
    g = g / np.sqrt(g.shape[0] * g[0, 0].numel())
    jx, jw = jnp.asarray(to_ndhwc(x)), jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy())
    jy, vjp = jax.vjp(lambda a, k: jax_conv3d(a, k, 2, [(p, p) for p in pads]), jx, jw)
    jgx, jgw = vjp(jnp.asarray(to_ndhwc(g)))
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = conv.conv3d(xt, wt, None, 2, pads)
    y.backward(g)
    for got, want in ((to_ndhwc(y), jy), (to_ndhwc(xt.grad), jgx),
                      (wt.grad.permute(2, 3, 4, 1, 0).numpy(), jgw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[3] == (1, 1, 1)
                                   and all(d % 2 == 0 for d in s[2])],
                         ids=[i for s, i in zip(SHAPES, IDS) if s[3] == (1, 1, 1)
                              and all(d % 2 == 0 for d in s[2])])
def test_kernel_route_matches_jax_s2d(shape, kernel_route):
    """The same three against conv3d_s2d_stride2, the space-to-depth form
    the JAX Conv3D takes for a stride-2 conv of fewer than 8 input channels
    on even boxes (mra_gan_tpu/models/networks.py:229-233), and its VJP."""
    x, w, _, g = _case(*shape, seed=4, bias=False)
    g = g / np.sqrt(g.shape[0] * g[0, 0].numel())
    jx, jw = jnp.asarray(to_ndhwc(x)), jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy())
    jy, vjp = jax.vjp(lambda a, k: conv3d_s2d_stride2(a, k, 1), jx, jw)
    jgx, jgw = vjp(jnp.asarray(to_ndhwc(g)))
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = conv.conv3d(xt, wt, None, 2, 1)
    y.backward(g)
    for got, want in ((to_ndhwc(y), jy), (to_ndhwc(xt.grad), jgx),
                      (wt.grad.permute(2, 3, 4, 1, 0).numpy(), jgw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=F32_RTOL, atol=F32_ATOL)


def _net_parity(jnet, net, arch, spatial, seed, batch):
    """A network on the kernel route against the JAX network with the same
    weights: the forward, and the gradients of <net(x), g> for the input and
    every parameter that gets one (a norm-dead bias gets none in the port)."""
    params = jax_params(jnet, spatial, seed)
    net.load_state_dict(state_dict_from_jax(params, arch), strict=True)
    rs = np.random.RandomState(seed + 1)
    x = rs.uniform(-1, 1, (batch, *spatial, 1)).astype(np.float32)

    def loss(p, v, gv):
        out = jnet.apply(p, v, train=False)
        return jnp.sum(out * gv), out

    out_shape = jax.eval_shape(lambda v: jnet.apply(params, v, train=False), jnp.asarray(x)).shape
    g = rs.uniform(-1, 1, out_shape).astype(np.float32)
    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(g))
    grads_ref = state_dict_from_jax(jax.tree.map(np.asarray, gp), arch)

    conv4s2.reset_launches()
    xt = to_ncdhw(x).requires_grad_()
    out = net.eval()(xt)
    out.backward(to_ncdhw(g))
    assert not any(conv4s2.LAUNCHES.values())  # no launch on the CPU
    np.testing.assert_allclose(to_ndhwc(out), np.asarray(ref), rtol=1e-3, atol=1e-4)
    pairs = [("input", xt.grad, torch.from_numpy(np.array(np.moveaxis(np.asarray(gx), -1, 1))))]
    pairs += [(k, p.grad, torch.as_tensor(grads_ref[k])) for k, p in net.named_parameters()
              if p.grad is not None]
    for name, got, want in pairs:
        scale = float(want.abs().max()) or 1.0
        np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale, rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    return dict(net.named_parameters())


def test_patchgan_through_the_kernel_route_matches_jax(kernel_route):
    """A 3-layer PatchGAN at ndf 4 on 24^3 (its smallest input): its first
    conv, with a live bias, takes the c4s2 route; the JAX one takes the
    space-to-depth form."""
    params = _net_parity(jax_define_d(4, "n_layers", 3), define_d(1, 4, "n_layers", 3),
                         "n_layers", (24, 24, 24), seed=21, batch=2)
    assert params["model.0.weight"].grad is not None and params["model.0.bias"].grad is not None


def test_unet_through_the_kernel_route_matches_jax(kernel_route):
    """unet_custom at ngf 4 on 32^3 (2^5 voxels an axis, its smallest
    input): its outermost down conv, with no bias, takes the c4s2 route."""
    params = _net_parity(jax_define_g(1, 4, "unet_custom"), define_g(1, 1, 4, "unet_custom"),
                         "unet_custom", (32, 32, 32), seed=22, batch=1)
    first = [p for p in params.values() if tuple(p.shape) == (4, 1, 4, 4, 4)]
    assert len(first) == 1 and first[0].grad is not None


def _counting(monkeypatch):
    """Count the calls of the three functions the route runs."""
    calls = {"forward": 0, "input_grad": 0, "weight_grad": 0}
    for key, name in (("forward", "_c4s2_forward"), ("input_grad", "_c4s2_input_grad"),
                      ("weight_grad", "_c4s2_weight_grad")):
        fn = getattr(conv, name)

        def counted(*args, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(conv, name, counted)
    return calls


@pytest.mark.parametrize("route", ["function", "custom_op"])
def test_backward_computes_only_what_the_engine_runs(route, monkeypatch):
    """The generator update's pattern: the conv's weight is a cast of a
    parameter (``CastParams``) and autograd.grad asks for the input's leaf
    only, so no weight gradient runs; asked for the parameter, no input
    gradient runs; asked for both (and for a leaf weight) both run. Through
    the autograd Function and through the custom op (under a dispatch mode,
    FlopCounterMode, as the benchmark counts)."""
    calls = _counting(monkeypatch)
    x, w, b, _ = _case(2, 4, (8, 8, 8), (1, 1, 1), seed=5)
    mode = FlopCounterMode(display=False) if route == "custom_op" else torch.no_grad()

    def run(leaf_w, asked):
        for k in calls:
            calls[k] = 0
        x0, p, bp = x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone()
        bp.requires_grad_()
        with torch.enable_grad():
            cast = p if leaf_w else conv.CastParams.apply(torch.float32, p)[0]
            y = conv.conv3d(x0 * 2, cast, bp, 2, 1)
            want = {"x": [x0], "w": [p, bp], "xw": [x0, p, bp]}[asked]
            torch.autograd.grad(y.square().sum(), want)
        return dict(calls)

    with mode if route == "custom_op" else torch.enable_grad():
        assert run(False, "x") == {"forward": 1, "input_grad": 1, "weight_grad": 0}
        assert run(False, "w") == {"forward": 1, "input_grad": 0, "weight_grad": 1}
        assert run(False, "xw") == {"forward": 1, "input_grad": 1, "weight_grad": 1}
        assert run(True, "x") == {"forward": 1, "input_grad": 1, "weight_grad": 0}
        assert run(True, "xw") == {"forward": 1, "input_grad": 1, "weight_grad": 1}


def test_train_step_runs_each_direction_as_often_as_the_card_counts(monkeypatch):
    """A train step (resnet + 3-layer PatchGAN, float32, the kernel route on
    the CPU): 4 discriminator forwards, 2 input gradients (the generator
    update, through the fakes) and 2 weight gradients (the discriminator
    update), as chip_smoke counts the conv4s2 launches of a step on the card;
    its gradients equal the ops' route's."""
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step

    rs = np.random.RandomState(9)
    a, b = (torch.from_numpy(rs.uniform(-1, 1, (1, 1, 24, 24, 24)).astype(np.float32))
            for _ in range(2))
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=3, gan_mode="lsgan", pool_size=0)

    def step_grads():
        state = create_state(cfg, 3, (24, 24, 24), device="cpu")
        make_train_step(cfg)(state, a, b, 2e-4)
        return {f"{name}.{k}": p.grad for name, net in state.nets.items()
                for k, p in net.named_parameters() if p.grad is not None}

    ref = step_grads()
    monkeypatch.setattr(conv, "_on_kernels", lambda t: True)
    calls = _counting(monkeypatch)
    got = step_grads()
    assert calls == {"forward": 4, "input_grad": 2, "weight_grad": 2}
    assert got.keys() == ref.keys() and "d_a.model.0.weight" in got
    for k, g in ref.items():
        torch.testing.assert_close(got[k], g, rtol=1e-4, atol=F32_ATOL, msg=k)


@pytest.mark.parametrize("cin, cout, k, stride, padding, routed", [
    (1, 32, 4, 2, 1, True), (1, 4, 4, (2, 2, 2), (0, 1, 1), True), (1, 8, 4, 2, 0, True),
    (1, 1, 4, 2, (1, 0, 1), True), (2, 32, 4, 2, 1, False), (1, 32, 4, 1, 1, False),
    (1, 32, 4, 2, 2, False), (1, 32, 3, 2, 1, False), (32, 1, 4, 2, 1, False),
    (1, 32, 4, (2, 2, 1), 1, False), (32, 64, 4, 2, 1, False)])
def test_routing_rule(cin, cout, k, stride, padding, routed):
    """conv3d sends exactly the (C, 1, 4, 4, 4) stride-2 convs padded 0 or 1
    on each axis to the c4s2 op, and everything else to aten.convolution."""
    assert conv.single_channel_4s2((cout, cin, k, k, k), stride, padding) is routed
    x = torch.zeros(1, cin, 10, 10, 10)
    w = torch.zeros(cout, cin, k, k, k)
    with FlopCounterMode(display=False) as counter:
        conv.conv3d(x, w, torch.zeros(cout), stride, padding)
    ops = {str(op) for op in counter.get_flop_counts()["Global"]}
    assert ops == ({"mra_torch.c4s2_convolution"} if routed else {"aten.convolution"})


def _counts(fn, x, w, b, g, need_x=True):
    leaves = [t.clone().requires_grad_(i > 0 or need_x) for i, t in enumerate((x, w, b))]
    with FlopCounterMode(display=False) as counter:
        fn(*leaves).backward(g)
    return {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}


@pytest.mark.parametrize("need_x", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:4], ids=IDS[:4])
def test_flop_counts_equal_aten(shape, need_x):
    """Forward, input gradient and weight gradient: each op's count equals
    aten's for the same work, and the total is the same; with no input
    gradient asked (the discriminator update's real and pooled inputs), the
    forward and the weight gradient only."""
    n, c, box, pads = shape
    x, w, b, g = _case(*shape)
    ours = _counts(_ours(pads), x, w, b, g, need_x)
    aten = _counts(_ref(pads), x, w, b, g, need_x)
    fwd = aten["aten.convolution"]
    want = {"mra_torch.c4s2_convolution": fwd, "mra_torch.c4s2_convolution_weight_grad": fwd}
    if need_x:
        want["mra_torch.c4s2_convolution_input_grad"] = fwd
    assert ours == want
    assert aten["aten.convolution_backward"] == (2 if need_x else 1) * fwd
    assert sum(ours.values()) == sum(aten.values())


def test_op_names_contain_convolution():
    """The benchmark counts the ops whose name contains 'convolution'."""
    for op in (torch.ops.mra_torch.c4s2_convolution,
               torch.ops.mra_torch.c4s2_convolution_input_grad,
               torch.ops.mra_torch.c4s2_convolution_weight_grad):
        assert "convolution" in str(op.default)


def test_meta_tensors_take_the_fake_route():
    """Shapes only (the benchmark's full-size FLOP count runs on meta)."""
    x = torch.empty(16, 1, 64, 64, 64, device="meta", dtype=torch.bfloat16)
    w = torch.empty(32, 1, 4, 4, 4, device="meta", dtype=torch.bfloat16)
    assert conv.conv3d(x, w, None, 2, 1).shape == (16, 32, 32, 32, 32)
    assert conv.c4s2_convolution(x, w, None, [0, 1, 1]).shape == (16, 32, 31, 32, 32)
    g = torch.empty(16, 32, 32, 32, 32, device="meta", dtype=torch.bfloat16)
    assert conv.c4s2_convolution_input_grad(g, w, [1, 1, 1], [64, 64, 64]).shape == x.shape
    dw, db = conv.c4s2_convolution_weight_grad(g, x, w, [1, 1, 1], True)
    assert dw.shape == w.shape and dw.dtype == w.dtype and db.shape == (32,)
    assert conv.c4s2_convolution_weight_grad(g, x, w, [1, 1, 1], False)[1].shape == (0,)


def test_ops_route_weight_grad_is_aten():
    """Off the kernels (the CPU, float32 on CUDA) the weight and bias
    gradients are aten's convolution_backward's, bit for bit."""
    x, w, _, g = _case(3, 4, (10, 9, 8), (0, 1, 1), seed=11)
    dw, db = conv.c4s2_convolution_weight_grad(g, x, w, [0, 1, 1], True)
    ref = torch.ops.aten.convolution_backward(g, x, w, [4], [2] * 3, [0, 1, 1], [1] * 3, False,
                                              [0] * 3, 1, [False, True, True])
    assert torch.equal(dw, ref[1]) and torch.equal(db, ref[2])


def test_plain_versions_round_once():
    """The wrappers on the CPU: float32 F.conv3d, conv3d_input and
    conv3d_weight of the same inputs rounded once; no launch counted."""
    x, w, b, g = (t.bfloat16() for t in _case(2, 8, (9, 10, 11), (0, 1, 1), seed=6))
    pads = (0, 1, 1)
    taps = w[:, 0].contiguous()
    conv4s2.reset_launches()
    y = conv4s2.conv4s2_spread(x, taps, b, pads)
    dx = conv4s2.conv4s2_gather(g, taps, pads, (9, 10, 11))
    dw, db = conv4s2.conv4s2_wgrad(x, g, pads)
    assert torch.equal(y, F.conv3d(x.float(), w.float(), b.float(), 2, pads).bfloat16())
    assert torch.equal(dx, torch.nn.grad.conv3d_input(x.shape, w.float(), g.float(), 2, pads)
                       .bfloat16())
    assert torch.equal(dw, torch.nn.grad.conv3d_weight(x.float(), w.shape, g.float(), 2, pads)
                       [:, 0].bfloat16())
    assert torch.equal(db, g.float().sum((0, 2, 3, 4)).bfloat16())
    assert not any(conv4s2.LAUNCHES.values())


@pytest.mark.parametrize("p, c", [(1, 4), (7, 32), (37, 40), (528, 32), (264, 32), (264, 40),
                                  (132, 32), (132, 40)])
def test_wgrad_reduce_plain_version_keeps_the_kernels_order(p, c):
    """The reduce's plain version sums as csrc/conv4s2.cu's reduce does:
    per warp w the partials w, w + 8, ... in order from zero, then the 8
    warps' sums in order, in float32, rounded once; written out here in
    numpy, bit for bit, and within float32 rounding of the float64 sum."""
    rs = np.random.RandomState(p)
    cp = -(-c // conv4s2.GROUP) * conv4s2.GROUP
    partial = rs.randn(p, conv4s2.ROWS, cp).astype(np.float32)
    dw, db = conv4s2.conv4s2_wgrad_reduce(torch.from_numpy(partial), c)
    sums = []
    for w in range(conv4s2.REDUCE_WARPS):
        s = np.zeros((conv4s2.ROWS, cp), np.float32)
        for k in range(w, p, conv4s2.REDUCE_WARPS):
            s = s + partial[k]
        sums.append(s)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    want = torch.from_numpy(np.ascontiguousarray(total[:, :c].T)).bfloat16()
    assert dw.shape == (c, 4, 4, 4) and db.shape == (c,) and dw.dtype == torch.bfloat16
    assert torch.equal(dw.reshape(c, 64), want[:, :64]) and torch.equal(db, want[:, 64])
    exact = partial.astype(np.float64).sum(0)[:, :c].T
    assert np.allclose(np.concatenate([dw.reshape(c, 64).float().numpy(),
                                       db.float().numpy()[:, None]], 1), exact,
                       rtol=2 ** -8, atol=1e-5 * np.abs(exact).max())


def test_wrappers_refuse_other_devices_and_dtypes():
    """No fallback: a tensor neither on the CPU nor on CUDA raises, and the
    kernels' argument check refuses another dtype, shape or layout, and a
    pad the kernels do not take."""
    cl = torch.channels_last_3d
    meta = dict(device="meta", dtype=torch.bfloat16)
    x = torch.empty(1, 1, 8, 8, 8, **meta)
    w = torch.empty(4, 4, 4, 4, **meta)
    g = torch.empty(1, 4, 4, 4, 4, **meta).contiguous(memory_format=cl)
    for fn in (lambda: conv4s2.conv4s2_spread(x, w), lambda: conv4s2.conv4s2_wgrad(x, g, (1,) * 3),
               lambda: conv4s2.conv4s2_gather(g, w, (1,) * 3, (8, 8, 8)),
               lambda: conv4s2.conv4s2_wgrad_reduce(torch.empty(2, 65, 32, device="meta"), 4)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn()
    what, dev = "conv4s2_gather", torch.device("cpu")
    gc = torch.zeros(1, 4, 4, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=cl)
    conv4s2.check_tensor(gc, dev, what, "g", (1, 4, 4, 4, 4), True)  # what the kernel takes
    with pytest.raises(TypeError, match="bfloat16"):
        conv4s2.check_tensor(gc.float(), dev, what, "g", (1, 4, 4, 4, 4), True)
    with pytest.raises(ValueError, match="channels_last_3d"):
        conv4s2.check_tensor(gc.contiguous(), dev, what, "g", (1, 4, 4, 4, 4), True)
    with pytest.raises(ValueError, match="shape"):
        conv4s2.check_tensor(gc, dev, what, "g", (1, 4, 4, 4, 5), True)
    with pytest.raises(ValueError, match="pads"):
        conv4s2.launch_params("spread", 1, 4, (8, 8, 8), (2, 1, 1), True, True)
    with pytest.raises(ValueError, match="no output"):
        conv4s2.launch_params("gather", 1, 4, (1, 8, 8), (0, 1, 1), True, True)


# ---------------------------------------------------------------------------
# the host-side geometry

BOXES = [((64, 64, 64), (1, 1, 1)), ((34, 64, 64), (0, 1, 1)), ((21, 18, 23), (1, 1, 1)),
         ((128, 128, 128), (1, 1, 1)), ((9, 11, 7), (0, 1, 1)), ((4, 5, 6), (0, 0, 0))]
BOX_IDS = ["x".join(map(str, b)) + "-p" + "".join(map(str, p)) for b, p in BOXES]


def _covered(span, tile, counts):
    """Each index of each axis in exactly one tile, and no tile empty."""
    for s, t, k in zip(span, tile, counts):
        hits = np.zeros(s, int)
        for i in range(k):
            assert i * t < s
            hits[i * t:min((i + 1) * t, s)] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("box, pads", BOXES, ids=BOX_IDS)
def test_tiles_cover_every_output_and_every_cell_once(box, pads):
    """The spread's and the weight gradient's tiles cover the output box,
    the gather's the cells, each voxel once; every voxel of the input box
    lies in one cell (i + p = 2 q + r), and every output reads inside the
    padded box."""
    out = conv4s2.out_shape(box, pads)
    for kind in ("spread", "wgrad"):
        tile, counts = conv4s2.tile_of(kind, out)
        assert tile[2] <= conv4s2.MAX_TILE_W
        _covered(out, tile, counts)
    span = conv4s2.cells(box, pads)
    tile, counts = conv4s2.tile_of("gather", span)
    assert np.prod(tile) <= conv4s2.MAX_CELLS and tile[2] <= conv4s2.GATHER_MAX_W
    _covered(span, tile, counts)
    for s, p, q, o in zip(box, pads, span, out):
        assert sorted({(i + p) // 2 for i in range(s)}) == list(range(q))
        assert 2 * (o - 1) + 3 - p <= s - 1 + p  # the last output's window ends in the pad


@pytest.mark.parametrize("box, pads", BOXES, ids=BOX_IDS)
def test_blocks_fit_and_the_grid_is_fixed_by_the_shape(box, pads):
    """Each kind's shared memory fits a block of sm_90 on both paths; the
    weight gradient's grid is at most TMA_BLOCKS (TMA) or WGRAD_BLOCKS
    (staged) and at most the tiles, the TMA forward's at most TMA_BLOCKS,
    the staged forward's and the gather's the tiles: all fixed by the shape,
    the path and nothing else."""
    out = conv4s2.out_shape(box, pads)
    for kind, span in (("spread", out), ("wgrad", out), ("gather", conv4s2.cells(box, pads))):
        tile, _ = conv4s2.tile_of(kind, span)
        assert conv4s2.smem_bytes(kind, tile) <= conv4s2.SMEM_LIMIT, kind
        if kind != "gather":
            assert conv4s2.smem_bytes(kind, tile, True) <= conv4s2.SMEM_LIMIT, kind
    for n in (1, 2, 16):
        tiles = n * np.prod(conv4s2.tile_of("wgrad", out)[1])
        for aligned, blocks in ((True, conv4s2.TMA_BLOCKS), (False, conv4s2.WGRAD_BLOCKS)):
            tma = box[2] % 8 == 0 and aligned
            grid = conv4s2.wgrad_grid(n, out, tma)
            assert grid == min(tiles, conv4s2.TMA_BLOCKS if tma else conv4s2.WGRAD_BLOCKS)
            params, _, _ = conv4s2.launch_params("wgrad", n, 32, box, pads, True, aligned)
            assert params[12] == grid and params[:8] == (n, 32, *box, *pads)
            assert params == conv4s2.launch_params("wgrad", n, 32, box, pads, True, aligned)[0]
        spread_tiles = n * np.prod(conv4s2.tile_of("spread", out)[1])
        for aligned in (True, False):
            params, _, _ = conv4s2.launch_params("spread", n, 32, box, pads, True, aligned)
            tma = box[2] % 8 == 0 and aligned
            assert params[12] == (min(spread_tiles, conv4s2.TMA_BLOCKS) if tma else spread_tiles)


def test_constants_match_the_kernels():
    """The Python constants against csrc/conv4s2.cu's."""
    src = (Path(conv4s2.__file__).parent / "csrc" / "conv4s2.cu").read_text()
    consts = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kGroup"] == conv4s2.GROUP
    assert consts["kVox"] == conv4s2.VOX
    assert consts["kSpreadRow"] == conv4s2.SPREAD_ROW
    assert consts["kPlane"] == conv4s2.PLANE
    assert consts["kMaxTileW"] == conv4s2.MAX_TILE_W
    assert consts["kMaxCells"] == conv4s2.MAX_CELLS
    assert consts["kGatherMaxW"] == conv4s2.GATHER_MAX_W
    assert consts["kReduceWarps"] == conv4s2.REDUCE_WARPS
    assert consts["kThreads"] == 32 * conv4s2.WARPS
    assert "constexpr int kRows = kTaps + 1;" in src and conv4s2.ROWS == consts["kTaps"] + 1
    assert consts["kWgradWarps"] == conv4s2.WGRAD_WARPS
    assert consts["kSpreadWarps"] == conv4s2.SPREAD_WARPS
    assert consts["kSpreadMPW"] == conv4s2.SPREAD_MPW
    assert "constexpr int kSpreadThreads = 32 * (kSpreadWarps + 1);" in src
    assert consts["kSlot"] == conv4s2.SLOT == 2 * conv4s2.GROUP
    assert consts["kSpreadStages"] == conv4s2.SPREAD_STAGES
    assert consts["kWgradStages"] == conv4s2.WGRAD_STAGES
    assert consts["kAlign"] == conv4s2.ALIGN
    assert "constexpr int kWgradThreads = 32 * (kWgradWarps + 1);" in src
    # the launch's int array: csrc/conv4s2.cu reads the path at p[13] and
    # the pitch at p[14], the grid at p[12]
    assert conv4s2.PARAMS.index("grid") == 12 and "p[12]" in src
    assert conv4s2.PARAMS.index("tma") == 13 and "p[13]" in src
    assert conv4s2.PARAMS.index("pitch") == 14 and "p[14]" in src


# ---------------------------------------------------------------------------
# the two paths: the plan, the rings, the TMA weight gradient's walk

# chip_smoke.py's phase-2 shapes (C4S2_CASES and the cases for each path)
# besides BOXES: (N, C, input box, pads)
PATH_SHAPES = [(16, 32, (64, 64, 64), (1, 1, 1)), (8, 32, (64, 64, 64), (1, 1, 1)),
               (2, 32, (64, 64, 64), (1, 1, 1)), (1, 32, (64, 64, 64), (1, 1, 1)),
               (2, 32, (21, 18, 23), (1, 1, 1)), (2, 4, (20, 22, 18), (1, 1, 1)),
               (2, 5, (19, 20, 22), (1, 1, 1)), (2, 40, (20, 22, 18), (1, 1, 1)),
               (1, 32, (34, 64, 64), (0, 1, 1)), (2, 32, (21, 18, 23), (0, 1, 1)),
               (1, 32, (128, 128, 128), (1, 1, 1)), (2, 40, (20, 22, 24), (1, 1, 1)),
               (2, 64, (18, 20, 16), (0, 1, 1)), (3, 8, (9, 11, 16), (1, 1, 1))]
PATH_IDS = ["n{}-c{}-{}-p{}".format(n, c, "x".join(map(str, b)), "".join(map(str, p)))
            for n, c, b, p in PATH_SHAPES]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n, c, box, pads", PATH_SHAPES, ids=PATH_IDS)
def test_the_plan_picks_the_path_from_the_shape(n, c, box, pads, aligned):
    """The forward and the weight gradient take the TMA path exactly where
    W % 8 == 0, C % 8 == 0 and the sources are 16-byte aligned; the gather
    never. The plan is a function of its arguments: the same call gives the
    same parameters, the path at p[13] and a window pitch only on TMA."""
    want = box[2] % 8 == 0 and c % 8 == 0 and aligned
    for kind in ("spread", "wgrad", "gather"):
        params, arr, _ = conv4s2.launch_params(kind, n, c, box, pads, c % 8 == 0, aligned)
        plan = dict(zip(conv4s2.PARAMS, params))
        tma = want and kind != "gather"
        assert plan["tma"] == int(tma) == int(conv4s2.takes_tma(kind, c, box, aligned)), kind
        assert list(arr) == list(params) and len(params) == len(conv4s2.PARAMS)
        assert (plan["pitch"] > 0) == tma
        if tma:
            tile = (plan["td"], plan["th"], plan["tw"])
            assert plan["pitch"] == conv4s2.tile_pitch(kind, tile)


@pytest.mark.parametrize("c", [4, 5, 32, 40])
@pytest.mark.parametrize("box, pads", BOXES, ids=BOX_IDS)
def test_the_plan_picks_the_path_at_every_box(box, pads, c):
    """At every box of the geometry tests and C = 4, 5, 32, 40: TMA exactly
    where W % 8 == 0, C % 8 == 0 and the sources are aligned, for the
    forward and the weight gradient alike, and a TMA plan's tile fits its
    window pitch and its grid."""
    for aligned in (True, False):
        want = box[2] % 8 == 0 and c % 8 == 0 and aligned
        for kind in ("spread", "wgrad"):
            params, _, _ = conv4s2.launch_params(kind, 2, c, box, pads, c % 8 == 0, aligned)
            plan = dict(zip(conv4s2.PARAMS, params))
            assert plan["tma"] == int(want)
            if want:
                tw = plan["tw"] if kind == "spread" else 16 * -(-plan["tw"] // 16)
                assert plan["pitch"] >= 2 * tw + 10 and plan["pitch"] % 8 == 0
                assert 1 <= plan["grid"] <= conv4s2.TMA_BLOCKS


def _banks_conflict_free(words) -> bool:
    """A warp's 32-bit shared-memory loads: each bank serves one address."""
    seen = {}
    for a in set(words):
        seen.setdefault(a % 32, set()).add(a)
    return all(len(v) == 1 for v in seen.values())


@pytest.mark.parametrize("width", list(range(2, 87, 4)))
def test_window_pitch_rows_fit_and_avoid_bank_conflicts(width):
    """The TMA window's row: at least the voxels a tile reads, a multiple
    of 8 (16-byte box rows) and at most 256 (a box's limit); a warp's A
    loads, two rows a pitch apart, conflict-free for the forward's outputs
    along a row and the weight gradient's (kh, kw, tq) words."""
    pitch = conv4s2.window_pitch(width)
    assert width <= pitch <= 256 and pitch % 8 == 0
    words = pitch // 2
    # forward: lane (gq, tq) reads word vw0 + gq + (tq & 1) + (tq >> 1) * pitch / 2
    assert _banks_conflict_free([g + (t & 1) + (t >> 1) * words
                                 for g in range(8) for t in range(4)])
    # weight gradient: word (gq >> 2) * pitch / 2 + 2 tq + ((gq >> 1) & 1), and the next
    for step in (0, 1):
        assert _banks_conflict_free([(g >> 2) * words + 2 * t + ((g >> 1) & 1) + step
                                     for g in range(8) for t in range(4)])


@pytest.mark.parametrize("n, c, box, pads", [s for s in PATH_SHAPES
                                             if s[2][2] % 8 == 0 and s[1] % 8 == 0],
                         ids=[i for s, i in zip(PATH_SHAPES, PATH_IDS)
                              if s[2][2] % 8 == 0 and s[1] % 8 == 0])
def test_the_tma_forward_reads_its_windows_in_bounds(n, c, box, pads):
    """A model of conv4s2_spread_tma_kernel's reads: each tile's window row
    starts at window_x0(2 ow0 - pw); output vw's taps kw, kw + 1 sit e = e0
    + 2 vw + kw voxels in, and the words a pair takes (one where e is even,
    those at e - 1 and e + 1 where odd) lie in the row of ``pitch`` voxels,
    e = -1 only for the low pad."""
    out = conv4s2.out_shape(box, pads)
    params, _, _ = conv4s2.launch_params("spread", n, c, box, pads, True, True)
    plan = dict(zip(conv4s2.PARAMS, params))
    assert plan["tma"] == 1
    tw = plan["tw"]
    _, (_, _, nw) = conv4s2.tile_of("spread", out)
    for w_ in range(nw):
        w0 = 2 * w_ * tw - pads[2]
        e0 = w0 - conv4s2.window_x0(w0)
        for vw in range(tw):
            for kw in (0, 2):
                e = e0 + 2 * vw + kw
                assert conv4s2.window_x0(w0) + e == 2 * (w_ * tw + vw) - pads[2] + kw
                last = e + 1 if e % 2 == 0 else e + 2
                assert -1 <= e and last < plan["pitch"]
                assert e != -1 or (w_ == 0 and vw == 0 and kw == 0 and pads[2] == 1)


def _chunk_offset(u: int, q: int) -> int:
    """csrc/conv4s2.cu chunk_offset: chunk q of voxel u under the 64-byte swizzle."""
    return u * conv4s2.SLOT + ((q ^ ((u >> 1) & 3)) << 4)


def test_the_swizzled_tiles_are_conflict_free():
    """The 64-byte swizzle of a TMA tile: the 8 voxels of an ldmatrix
    phase (the weight gradient's B) and of a warp's accumulator stores (the
    forward's epilogue, 4 bytes a lane) fall in distinct bank groups."""
    assert "return u * kSlot + ((q ^ ((u >> 1) & 3)) << 4);" in (
        Path(conv4s2.__file__).parent / "csrc" / "conv4s2.cu").read_text()
    for u0 in range(0, 64, 8):
        for q in range(4):
            groups = {(_chunk_offset(u0 + r, q) % 128) // 16 for r in range(8)}
            assert len(groups) == 8
            words = [(_chunk_offset(u0 + g, q) + 4 * t) // 4 for g in range(8) for t in range(4)]
            assert _banks_conflict_free(words)


@pytest.mark.parametrize("n, c, box, pads", [s for s in PATH_SHAPES
                                             if s[2][2] % 8 == 0 and s[1] % 8 == 0],
                         ids=[i for s, i in zip(PATH_SHAPES, PATH_IDS)
                              if s[2][2] % 8 == 0 and s[1] % 8 == 0])
def test_rings_fit_one_block_an_sm(n, c, box, pads):
    """The TMA kernels' rings (at least two stages), output tiles and
    barriers fit a block's shared memory on sm_90, so the persistent grid
    of at most TMA_BLOCKS blocks, one an SM of an H100's 132, is resident
    at once."""
    assert conv4s2.TMA_BLOCKS <= 132
    out = conv4s2.out_shape(box, pads)
    for kind in ("spread", "wgrad"):
        tile, _ = conv4s2.tile_of(kind, out)
        smem = conv4s2.smem_bytes(kind, tile, True)
        assert smem <= conv4s2.SMEM_LIMIT, (kind, smem)
        if kind == "spread":  # a warp's m-tiles sit in registers
            assert np.prod(tile) <= 16 * conv4s2.SPREAD_MPW * conv4s2.SPREAD_WARPS
        window = (2 * tile[0] + 2) * (2 * tile[1] + 2) * conv4s2.tile_pitch(kind, tile) * 2
        stages = conv4s2.SPREAD_STAGES if kind == "spread" else conv4s2.WGRAD_STAGES
        assert stages >= 2 and stages * window < smem


@pytest.mark.parametrize("n, box, pads", [(1, (64, 64, 64), (1, 1, 1)), (3, (9, 11, 16), (1, 1, 1)),
                                          (2, (18, 20, 16), (0, 1, 1)),
                                          (2, (20, 22, 24), (1, 1, 1)),
                                          (1, (34, 64, 64), (0, 1, 1))])
def test_the_tma_weight_gradient_sums_each_output_once(n, box, pads):
    """A model of conv4s2_wgrad_tma_kernel's walk: block b takes tiles b, b
    + grid, ...; a tile's g box is TD x TH rows of TWr voxels (TMA zero past
    the output box), and A is zeroed at voxels j >= TW of a row. Every
    (sample, output voxel) meets an unzeroed A exactly once over the grid,
    and every window read (x index 2 o + t - p) lies in the tile's box of
    ``pitch`` voxels a row."""
    out = conv4s2.out_shape(box, pads)
    params, _, _ = conv4s2.launch_params("wgrad", n, 32, box, pads, True, True)
    plan = dict(zip(conv4s2.PARAMS, params))
    assert plan["tma"] == 1
    td, th, tw = plan["td"], plan["th"], plan["tw"]
    twr = 16 * -(-tw // 16)
    _, (nd, nh, nw) = conv4s2.tile_of("wgrad", out)
    tiles, grid = n * nd * nh * nw, plan["grid"]
    hits = np.zeros((n, *out), int)
    walked = sorted(t for b in range(grid) for t in range(b, tiles, grid))
    assert walked == list(range(tiles))
    for t in walked:
        w_, h_, d_, s_ = t % nw, t // nw % nh, t // (nw * nh) % nd, t // (nw * nh * nd)
        w0 = 2 * w_ * tw - pads[2]
        x0 = conv4s2.window_x0(w0)
        assert x0 >= 0 and x0 % 8 == 0 and -1 <= w0 - x0 <= 7
        for r in range(td * th):
            od, oh = d_ * td + r // th, h_ * th + r % th
            for j in range(twr):
                ow = w_ * tw + j
                live = j < tw and od < out[0] and oh < out[1] and ow < out[2]
                if live:
                    hits[s_, od, oh, ow] += 1
                for kw in range(4):
                    # tap kw of output j: x index w0 + 2 j + kw, e voxels into
                    # the row; its pair's words reach e + 3 at most
                    e = w0 - x0 + 2 * j + kw
                    assert x0 + e == 2 * ow - pads[2] + kw
                    assert -1 <= e and (e & ~1) + 3 < plan["pitch"]
                    if e == -1:
                        assert ow == 0 and kw == 0 and pads[2] == 1  # the pad, read as zero
    assert (hits == 1).all()
