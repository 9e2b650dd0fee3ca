"""The train step's host-side routes (mra_gan_tpu_torch/ops/conv.py) on the
CPU: each gives the bits of the route it stands in for.

- ``CastParams`` / ``param_casts``: a network's parameters cast to the
  compute dtype in one foreach copy per apply, and the gradients cast back
  in one, against ``t.to(dtype)`` per conv and its autograd backward.
- ``C7Convolution``: the 7^3 single-channel conv as a plain autograd
  Function, against the ``mra_torch::c7_convolution`` custom op, which
  ``conv3d`` still takes under a dispatch mode (FlopCounterMode).
- ``train_host``: the probe refuses to run without a card.

Every comparison is bit for bit: the routes run the same arithmetic."""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mra_gan_tpu_torch.models import cycle_gan
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step
from mra_gan_tpu_torch.ops import conv

PATCH = (16, 16, 16)


def _params(rs, shapes):
    return [torch.from_numpy(rs.randn(*s).astype(np.float32)).requires_grad_() for s in shapes]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cast_params_match_to(dtype):
    """Casts bit-equal to ``.to``; each gradient ``.to``'s backward, summed
    over two uses in float32 as autograd sums two ``.to`` nodes; a cast no
    gradient reaches gives None."""
    rs = np.random.RandomState(0)
    shapes = [(4, 3, 3, 3, 3), (4,), (2, 4, 3, 3, 3), (5,)]
    ours, ref = _params(rs, shapes), None
    ref = [p.detach().clone().requires_grad_() for p in ours]
    gs = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dtype) for s in shapes[:3]]

    def loss(casts):
        # parameter 3 is cast and never used; 0 and 2 are used twice
        return sum((c * g).float().sum() for c, g in zip(casts[:3], gs)) + \
            (casts[0] * gs[0] * 3).float().sum() + (casts[2] * gs[2]).float().sum()

    casts = conv.CastParams.apply(dtype, *ours)
    for c, p in zip(casts, ref):
        assert c.dtype == dtype and torch.equal(c, p.to(dtype))
    got = torch.autograd.grad(loss(casts), ours, allow_unused=True)
    want = torch.autograd.grad(loss([p.to(dtype) for p in ref]), ref, allow_unused=True)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert got[3] is None


def test_param_casts_scope():
    """Inside, ``_cast`` and ``param_cast`` return the group's casts; outside,
    without gradients or without a cast to make, nothing changes."""
    net = torch.nn.Conv3d(2, 3, 3)
    w = net.weight
    with conv.param_casts(net, torch.bfloat16):
        held = conv._cast(w, torch.bfloat16)
        assert held is conv.param_cast(w) and held.dtype == torch.bfloat16
        assert held.grad_fn is not None and torch.equal(held, w.to(torch.bfloat16))
    assert conv.param_cast(w) is w
    with torch.no_grad(), conv.param_casts(net, torch.bfloat16):
        assert conv.param_cast(w) is w
    with conv.param_casts(net, torch.float32):
        assert conv.param_cast(w) is w


def _run_steps(dtype, remat, grouped, monkeypatch):
    """Two train steps at a small config: losses, parameters and raw
    gradients, with the grouped casts on or patched out."""
    if not grouped:
        monkeypatch.setattr(cycle_gan, "param_casts", lambda net, dtype: contextlib.nullcontext())
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=2, dtype=dtype, remat=remat)
    state = create_state(cfg, 0, PATCH, device="cpu")
    step = make_train_step(cfg)
    rs = np.random.RandomState(1)
    a, b = (torch.from_numpy(rs.uniform(-1, 1, (2, 1, *PATCH)).astype(np.float32))
            for _ in range(2))
    losses = [step(state, a, b, 2e-4)[1] for _ in range(2)]
    params = {f"{n}.{k}": p.detach().clone() for n, net in state.nets.items()
              for k, p in net.named_parameters()}
    grads = {f"{n}.{k}": p.grad for n, net in state.nets.items() for k, p in net.named_parameters()}
    monkeypatch.undo()
    return losses, params, grads


@pytest.mark.parametrize("dtype, remat", [(torch.bfloat16, False), (torch.bfloat16, True),
                                          (torch.float32, False)],
                         ids=["bf16", "bf16-remat", "f32"])
def test_train_step_grouped_casts_bit_equal(dtype, remat, monkeypatch):
    """The step with ``param_casts`` around each network apply gives the
    bits of the step that casts at every conv: losses, parameters, raw
    gradients, and None for the same norm-dead biases."""
    got = _run_steps(dtype, remat, True, monkeypatch)
    want = _run_steps(dtype, remat, False, monkeypatch)
    for m, n in zip(got[0], want[0]):
        assert m.keys() == n.keys() and all(torch.equal(m[k], n[k]) for k in m)
    for k, p in want[1].items():
        assert torch.equal(got[1][k], p), k
    nones = 0
    for k, g in want[2].items():
        assert (got[2][k] is None) == (g is None), k
        nones += g is None
        assert g is None or torch.equal(got[2][k], g), k
    assert nones > 0  # the norm-dead biases


def _c7_case(cin, cout, seed=0):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.uniform(-1, 1, (2, cin, 10, 11, 9)).astype(np.float32))
    w = torch.from_numpy((rs.randn(cout, cin, 7, 7, 7) / 20).astype(np.float32))
    b = torch.from_numpy((0.1 * rs.randn(cout)).astype(np.float32))
    g = torch.from_numpy(rs.uniform(-1, 1, (2, cout, 4, 5, 3)).astype(np.float32))
    return x, w, b, g


def _c7_grads(fn, x, w, b, g):
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = fn(*leaves)
    y.backward(g)
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("kernels", [False, True], ids=["aten", "kernel-route"])
@pytest.mark.parametrize("cin, cout", [(1, 4), (4, 1)], ids=["spread", "gather"])
def test_c7_function_matches_custom_op(cin, cout, kernels, monkeypatch):
    """``C7Convolution`` and the custom op: the same output and gradients,
    bit for bit, on the CPU route and on the kernel route (the wrappers'
    plain versions)."""
    if kernels:
        monkeypatch.setattr(conv, "_on_kernels", lambda t: True)
    x, w, b, g = _c7_case(cin, cout)
    got = _c7_grads(conv.C7Convolution.apply, x, w, b, g)
    want = _c7_grads(conv.c7_convolution, x, w, b, g)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_conv3d_takes_the_custom_op_only_under_a_mode():
    """Outside a dispatch mode ``conv3d`` records a ``C7Convolution`` node;
    under FlopCounterMode the custom ops, which the counter sees."""
    x, w, b, g = _c7_case(1, 4)
    x.requires_grad_()
    assert type(conv.conv3d(x, w, b).grad_fn).__name__ == "C7ConvolutionBackward"
    with FlopCounterMode(display=False) as counter:
        conv.conv3d(x, w, b).backward(g)
    assert {str(k) for k in counter.get_flop_counts()["Global"]} == {
        "mra_torch.c7_convolution", "mra_torch.c7_convolution_input_grad"}


def test_train_host_needs_a_card(capsys):
    from mra_gan_tpu_torch import train_host

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert train_host.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
