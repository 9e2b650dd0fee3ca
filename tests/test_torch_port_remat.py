"""``--remat`` in the port's train step on the CPU: three steps with the
generators' activations recomputed in the backward are bit-equal to three
without (a resnet with dropout, whose masks must be drawn again alike, the
U-Net and the DynUNet, whose whole apply is one segment), and the recompute
runs each generator norm once more per step. The step against the JAX
package's ``remat=True`` step is in test_torch_port_remat_jax.py."""
import dataclasses

import numpy as np
import pytest
import torch

from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step
from mra_gan_tpu_torch.models.networks import ResnetGenerator3D, remat_segments
from mra_gan_tpu_torch.ops import norm

from torch_port_util import assert_tree_equal

torch.set_num_threads(2)

CASES = {
    "resnet_dropout": (dict(net_g="resnet_6blocks", no_dropout=False), (16, 16, 16)),
    "unet_custom": (dict(net_g="unet_custom"), (32, 32, 32)),
    "Dynet": (dict(net_g="Dynet", dynet_sizes=(16, 16, 16)), (16, 16, 16)),
}


def _run(cfg, patch, steps: int = 3):
    state = create_state(cfg, 0, patch, device="cpu")
    step = make_train_step(cfg)
    rs = np.random.RandomState(1)
    out = []
    for _ in range(steps):
        a, b = (torch.from_numpy(rs.uniform(-1, 1, (2, 1, *patch)).astype(np.float32))
                for _ in range(2))
        _, metrics = step(state, a, b, 2e-4)
        out.append({k: float(v) for k, v in metrics.items()})
    grads = {f"{n}.{k}": p.grad for n, net in state.nets.items()
             for k, p in net.named_parameters()}
    return state, out, grads


@pytest.mark.parametrize("case", list(CASES))
def test_remat_steps_are_bit_equal_to_plain_steps(case):
    fields, patch = CASES[case]
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=1, pool_size=2, gan_mode="lsgan",
                         dtype=torch.float32, **fields)
    plain, plain_losses, plain_grads = _run(cfg, patch)
    remat, remat_losses, remat_grads = _run(dataclasses.replace(cfg, remat=True), patch)
    assert remat_losses == plain_losses
    raw_remat, raw_plain = state_to_dict(remat), state_to_dict(plain)
    assert raw_remat["config"].pop("remat") and not raw_plain["config"].pop("remat")
    assert_tree_equal(raw_remat, raw_plain)
    assert remat_grads.keys() == plain_grads.keys()
    for k, g in plain_grads.items():
        assert (g is None) == (remat_grads[k] is None), k
        assert g is None or torch.equal(g, remat_grads[k]), k


def test_resnet_segments_cut_at_the_jax_boundaries():
    net = CycleGANConfig(ngf=4).build_generator("g_a", torch.Generator().manual_seed(0))
    stem, trunk, head = remat_segments(net)
    assert len(trunk) == 6 and len(list(stem)) == 11 and len(head) == 9
    x = torch.randn(1, 1, 16, 16, 16)
    with torch.no_grad():
        h = stem(x)
        assert h.shape == (1, 16, 4, 4, 4)  # ngf * 4 channels at a quarter
        assert torch.equal(head(trunk(h)), net(x))
    assert list(net.state_dict()) == list(ResnetGenerator3D(ngf=4, n_blocks=6).state_dict())


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_remat_runs_every_generator_norm_once_more(monkeypatch, remat):
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=2, pool_size=0, gan_mode="lsgan",
                         dtype=torch.float32, remat=remat)
    calls = [0]
    real = norm.instance_norm_act_plain_fwd

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(norm, "instance_norm_act_plain_fwd", counted)
    state = create_state(cfg, 0, (16, 16, 16), device="cpu")
    with torch.no_grad():
        state.g_a(torch.zeros(1, 1, 16, 16, 16))
    per_g = calls[0]
    assert per_g == 17  # stem, 2 downs, 12 in the trunk, 2 ups
    calls[0] = 0
    x = torch.zeros(1, 1, 16, 16, 16)
    make_train_step(cfg)(state, x, x, 2e-4)
    per_d = 2  # the 2-layer PatchGAN
    assert calls[0] == 4 * per_g + 4 * per_d + (4 * per_g if remat else 0)
