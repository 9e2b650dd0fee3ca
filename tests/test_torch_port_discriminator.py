"""The port's PatchGAN (``NLayerDiscriminator3D`` in
mra_gan_tpu_torch/models/networks.py) against the JAX discriminator with the
same weights, in float32 on the CPU, at the PARITY.md section 1 bar (rtol
1e-3, atol 1e-4); its checkpoint layout against the JAX package's
``save_torch_network``; and which conv biases the port detaches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.checkpoint import save_torch_network
from mra_gan_tpu.models.networks import define_d as jax_define_d
from mra_gan_tpu_torch.checkpoint.io import (
    load_reference_pth,
    read_reference_pth,
    state_dict_from_jax,
)
from mra_gan_tpu_torch.models.networks import (
    NLayerDiscriminator3D,
    PixelDiscriminator3D,
    define_d,
    define_g,
)

from torch_port_util import dead_bias_keys, random_conv_tree, to_ncdhw, to_ndhwc


def _jax_d(n_layers: int, use_sigmoid: bool, size: int, seed: int):
    net = jax_define_d(4, "n_layers", n_layers, use_sigmoid=use_sigmoid)
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.zeros((1, size, size, size, 1)),
                                               train=False), jax.random.PRNGKey(0))
    return net, random_conv_tree(shapes, seed)


@pytest.mark.parametrize("use_sigmoid", [False, True])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_discriminator_matches_jax(n_layers, use_sigmoid):
    size = 3 * 2 ** n_layers if n_layers == 3 else 16  # 24^3 is the least for 3 layers
    jnet, params = _jax_d(n_layers, use_sigmoid, size, seed=n_layers)
    x = np.random.RandomState(n_layers).uniform(-1, 1, (2, size, size, size, 1)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda t: jnet.apply(params, t, train=False))(x))
    net = define_d(1, 4, "n_layers", n_layers, use_sigmoid=use_sigmoid)
    net.load_state_dict(state_dict_from_jax(params, "n_layers"))
    with torch.inference_mode():
        got = to_ndhwc(net(to_ncdhw(x)))
    assert got.shape == ref.shape and got.shape[1] >= 1
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_small_input_is_refused_as_in_jax():
    net = define_d(1, 4, "n_layers", 3)
    with pytest.raises(ValueError, match=r"needs every spatial dim >= 24"):
        net(torch.zeros(1, 1, 16, 24, 24))
    jnet, params = _jax_d(3, False, 24, seed=0)
    with pytest.raises(ValueError, match=r"needs every spatial dim >= 24"):
        jnet.apply(params, jnp.zeros((1, 16, 24, 24, 1)), train=False)


@pytest.mark.parametrize("n_layers", [1, 3])
def test_state_dict_keys_are_the_jax_exports(n_layers, tmp_path):
    _, params = _jax_d(n_layers, False, 24, seed=4)
    pth = tmp_path / "d.pth"
    save_torch_network(params, pth, arch="n_layers")
    net = NLayerDiscriminator3D(1, 4, n_layers)
    assert set(read_reference_pth(pth)) == set(net.state_dict())
    assert list(state_dict_from_jax(params, "n_layers")) == list(net.state_dict())
    load_reference_pth(pth, net)
    torch.testing.assert_close(net.state_dict()["model.0.weight"],
                               state_dict_from_jax(params, "n_layers")["model.0.weight"])


def test_define_d_names():
    assert define_d(1, 4, "basic").n_layers == 3
    assert define_d(1, 4, "n_layers", 2).n_layers == 2
    assert isinstance(define_d(1, 4, "basic", use_sigmoid=True).model[-1], torch.nn.Sigmoid)
    assert isinstance(define_d(1, 4, "pixel"), PixelDiscriminator3D)
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_d(1, 4, "patch")


def test_norm_dead_biases_are_detached():
    """The bias of every conv that feeds an instance norm is detached (JAX
    stop_gradients it): in G every conv but the head, in D the middle and
    the stride-1 convs. Their .grad stays None; the others get one."""
    g = define_g(1, 1, 4, "resnet_6blocks")
    d = define_d(1, 4, "n_layers", 3)
    want_g = {"model.1.bias", "model.4.bias", "model.7.bias", "model.16.bias", "model.19.bias"}
    want_g |= {f"model.{10 + i}.conv_block.{j}.bias" for i in range(6) for j in (1, 5)}
    assert dead_bias_keys(g) == want_g
    assert dead_bias_keys(d) == {"model.2.bias", "model.5.bias", "model.8.bias"}
    x = torch.rand(1, 1, 24, 24, 24) * 2 - 1
    d(g(x)).square().mean().backward()
    for net, dead in ((g, want_g), (d, dead_bias_keys(d))):
        for name, p in net.named_parameters():
            assert (p.grad is None) == (name in dead), name
