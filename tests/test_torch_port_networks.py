"""The port's ResnetGenerator3D (mra_gan_tpu_torch/models/networks.py) against
the JAX generator with the same weights, in float32 on the CPU, at the
PARITY.md section 1 bar (rtol 1e-3, atol 1e-4); weights travel through the
port's ``state_dict_from_jax`` and through a ``.pth`` written by the JAX
package's ``save_torch_network``."""
import jax
import numpy as np
import pytest
import torch

from mra_gan_tpu.checkpoint import save_torch_network
from mra_gan_tpu.ops import init as jax_init
from mra_gan_tpu_torch.ops import init as port_init
from mra_gan_tpu_torch.checkpoint.io import load_reference_pth, state_dict_from_jax
from mra_gan_tpu_torch.models.networks import (
    ResnetGenerator3D,
    define_g,
    spatial_granularity,
)

from torch_port_util import jax_forward, jax_generator, to_ncdhw, to_ndhwc


def _input(seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (2, 16, 16, 16, 1)).astype(np.float32)


def _port_forward(net, x):
    with torch.inference_mode():
        return to_ndhwc(net(to_ncdhw(x)))


@pytest.mark.parametrize("n_blocks", [6, 9])
def test_generator_matches_jax(n_blocks):
    jnet, params = jax_generator(n_blocks=n_blocks, seed=n_blocks)
    x = _input()
    ref = np.asarray(jax_forward(jnet, params)(x))
    net = ResnetGenerator3D(1, 1, 4, n_blocks).eval()
    net.load_state_dict(state_dict_from_jax(params, f"resnet_{n_blocks}blocks"))
    got = _port_forward(net, x)
    assert got.shape == ref.shape == (2, 16, 16, 16, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_reference_pth_from_jax_export_loads(tmp_path):
    jnet, params = jax_generator(seed=1)
    pth = tmp_path / "latest_net_G_A.pth"
    save_torch_network(params, pth, arch="resnet_6blocks")
    net = load_reference_pth(pth, ResnetGenerator3D(1, 1, 4, 6).eval())
    x = _input(1)
    np.testing.assert_allclose(_port_forward(net, x),
                               np.asarray(jax_forward(jnet, params)(x)),
                               rtol=1e-3, atol=1e-4)


def test_dropout_shifts_the_second_block_conv(tmp_path):
    """With dropout a residual block's second conv sits at conv_block.6
    (reference layout); dropout is off at inference, so the output equals
    JAX's train=False forward."""
    jnet, params = jax_generator(use_dropout=True, seed=2)
    sd = state_dict_from_jax(params, "resnet_6blocks", use_dropout=True)
    assert "model.10.conv_block.6.weight" in sd and "model.10.conv_block.5.weight" not in sd
    net = ResnetGenerator3D(1, 1, 4, 6, use_dropout=True).eval()
    net.load_state_dict(sd)
    x = _input(2)
    np.testing.assert_allclose(_port_forward(net, x),
                               np.asarray(jax_forward(jnet, params)(x)),
                               rtol=1e-3, atol=1e-4)
    pth = tmp_path / "g.pth"
    save_torch_network(params, pth, arch="resnet_6blocks", use_dropout=True)
    with pytest.raises(RuntimeError, match="conv_block"):
        load_reference_pth(pth, ResnetGenerator3D(1, 1, 4, 6, use_dropout=False))


def test_define_g_and_granularity():
    gen = torch.Generator().manual_seed(0)
    net = define_g(1, 1, 4, "resnet_9blocks", generator=gen)
    assert sum(isinstance(m, type(net.model[10])) for m in net.modules()) == 9
    w = net.model[1].weight.detach()
    assert abs(float(w.std()) - 0.02) < 0.005 and float(net.model[1].bias.detach().abs().max()) == 0
    assert spatial_granularity(net) == (4, 4, 4)
    assert spatial_granularity(define_g(1, 1, 4, "unet_custom")) == (32, 32, 32)
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_g(1, 1, 4, "unet_64")
    with pytest.raises(ValueError, match="residual blocks"):
        state_dict_from_jax(jax_generator()[1], "resnet_9blocks")


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_init_schemes_match_jax(init_type):
    """The two frameworks' random streams differ, so the moments are held:
    the same std (13824 draws: rtol 5%), and for orthogonal the same
    structure, rows of the kernel reversed to (Cout, ...) orthonormal."""
    shape = (3, 3, 3, 16, 32)
    ours = port_init.get_initializer(init_type, 0.02)(
        shape, torch.Generator().manual_seed(0)).numpy()
    ref = np.asarray(jax_init.get_initializer(init_type, 0.02)(jax.random.PRNGKey(0), shape))
    assert ours.shape == ref.shape == shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours.std(), ref.std(), rtol=0.05)
    if init_type == "orthogonal":
        for k in (ours, ref):
            rows = k.T.reshape(32, -1)
            np.testing.assert_allclose(rows @ rows.T, 0.02 ** 2 * np.eye(32), atol=1e-7)
