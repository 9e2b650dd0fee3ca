"""The rest of the port's network zoo (mra_gan_tpu_torch/models/networks.py)
against the JAX package's ``define_g``/``define_d`` nets with the same
weights, in float32 on the CPU, at the PARITY.md section 1 bar (rtol 1e-3,
atol 1e-4): every generator and discriminator name under every norm the
JAX factory builds (the Dynet takes no norm), eval mode included, which
under batch norm still normalizes with the batch's statistics. The JAX
weights are drawn with numpy on the shapes of ``jax.eval_shape`` of the
JAX net's ``init`` and carried over by ``state_dict_from_jax``, which
places every leaf of the tree or raises, so the flax ``Norm3D_k`` names
are taken from the JAX nets themselves.

Sizes: unet_custom at 32^3 (its smallest input), resnet and the
discriminators at 12^3, the Dynet at 16^3 on three schedules; ngf = ndf =
4. unet_128 and unet_256 are held by their key layout and parameter
shapes under each norm, and by one forward each at 128^3 and 256^3, their
smallest inputs (a few seconds each on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.models.networks import define_d as jax_define_d
from mra_gan_tpu.models.networks import define_g as jax_define_g
from mra_gan_tpu.models.networks import dynunet_schedule as jax_dynunet_schedule
from mra_gan_tpu.models.networks import spatial_granularity as jax_spatial_granularity
from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
from mra_gan_tpu_torch.models.networks import (
    BatchNorm3d,
    check_patch,
    define_d,
    define_g,
    dynunet_schedule,
    granularity,
    spatial_granularity,
)

from torch_port_util import jax_params, random_conv_tree, to_ncdhw, to_ndhwc

NORMS = ("instance", "batch", "none")
# (net_g, spatial, dynet sizes, dynet spacings)
DYNETS = {
    "iso": ((16, 16, 16), (16, 16, 16), (1.5, 1.5, 1.5)),
    "strides_2_2_1": ((16, 16, 8), (32, 32, 16), (1.5, 1.5, 1.5)),  # test_dynet_parity.py
    "spacing_1_1_3": ((16, 16, 16), (16, 16, 16), (1.0, 1.0, 3.0)),  # a (3, 3, 1) kernel
}


def _input(spatial, seed=0, batch=2):
    return np.random.RandomState(seed).uniform(-1, 1, (batch, *spatial, 1)).astype(np.float32)


def _both(jnet, net, arch, spatial, seed, batch=2):
    """(JAX forward, port forward) of one input, train=False / eval()."""
    params = jax_params(jnet, spatial, seed)
    net.load_state_dict(state_dict_from_jax(params, arch), strict=True)
    x = _input(spatial, seed, batch)
    ref = np.asarray(jax.jit(lambda v: jnet.apply(params, v, train=False))(jnp.asarray(x)))
    with torch.inference_mode():
        got = to_ndhwc(net.eval()(to_ncdhw(x)))
    return ref, got


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("net_g, spatial", [("resnet_6blocks", (12, 12, 12)),
                                            ("resnet_9blocks", (12, 12, 12)),
                                            ("unet_custom", (32, 32, 32))])
def test_generator_matches_jax(net_g, spatial, norm):
    ref, got = _both(jax_define_g(1, 4, net_g, norm), define_g(1, 1, 4, net_g, norm), net_g,
                     spatial, seed=len(net_g) + NORMS.index(norm))
    assert got.shape == ref.shape == (2, *spatial, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("schedule", list(DYNETS))
def test_dynet_matches_jax(schedule):
    spatial, sizes, spacings = DYNETS[schedule]
    jnet = jax_define_g(1, 4, "Dynet", dynet_sizes=sizes, dynet_spacings=spacings)
    net = define_g(1, 1, 4, "Dynet", dynet_sizes=sizes, dynet_spacings=spacings)
    ref, got = _both(jnet, net, "Dynet", spatial, seed=3)
    assert got.shape == ref.shape == (2, *spatial, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("net_d, n_layers", [("n_layers", 1), ("basic", 3), ("pixel", 3)])
def test_discriminator_matches_jax(net_d, n_layers, norm):
    spatial = (24, 24, 24) if net_d == "basic" else (12, 12, 12)
    jnet = jax_define_d(4, net_d, n_layers, norm, use_sigmoid=net_d == "pixel")
    net = define_d(1, 4, net_d, n_layers, norm, use_sigmoid=net_d == "pixel")
    ref, got = _both(jnet, net, net_d, spatial, seed=7 + NORMS.index(norm))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("net_g, side", [("unet_128", 128), ("unet_256", 256)])
def test_deep_unet_layout_matches_jax(net_g, side, norm):
    """Key layout and parameter shapes from ``jax.eval_shape`` of the JAX
    ``init`` at the smallest input the net takes, under each norm."""
    jnet = jax_define_g(1, 4, net_g, norm, use_dropout=True)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, side, side, side, 1)), train=False),
        jax.random.PRNGKey(0))
    want = state_dict_from_jax(random_conv_tree(shapes, 0), net_g, use_dropout=True)
    net = define_g(1, 1, 4, net_g, norm, use_dropout=True)
    got = net.state_dict()
    assert list(got) == list(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in want.items()}
    downs = {"unet_128": 7, "unet_256": 8}[net_g]
    assert sum(k.endswith("weight") and v.dim() == 5 for k, v in got.items()) == 2 * downs
    assert sum(isinstance(m, BatchNorm3d) for m in net.modules()) == (
        2 * downs - 3 if norm == "batch" else 0)


@pytest.mark.parametrize("net_g, side", [("unet_128", 128), ("unet_256", 256)])
def test_deep_unet_forward_matches_jax(net_g, side):
    ref, got = _both(jax_define_g(1, 4, net_g), define_g(1, 1, 4, net_g), net_g,
                     (side,) * 3, seed=side, batch=1)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("sizes, spacings", [((128, 128, 64), (1.5, 1.5, 1.5)),
                                             ((16, 16, 16), (1.5, 1.5, 1.5)),
                                             ((32, 32, 16), (1.5, 1.5, 1.5)),
                                             ((16, 16, 16), (1.0, 1.0, 3.0)),
                                             ((96, 80, 40), (0.8, 0.8, 2.5))])
def test_schedule_and_granularity_match_jax(sizes, spacings):
    assert dynunet_schedule(sizes, spacings) == jax_dynunet_schedule(sizes, spacings)
    jnet = jax_define_g(1, 4, "Dynet", dynet_sizes=sizes, dynet_spacings=spacings)
    net = define_g(1, 1, 4, "Dynet", dynet_sizes=sizes, dynet_spacings=spacings)
    assert spatial_granularity(net) == jax_spatial_granularity(jnet)


def test_granularity_of_every_generator_matches_jax():
    for name in ("resnet_6blocks", "resnet_9blocks", "unet_custom", "unet_128", "unet_256"):
        assert spatial_granularity(define_g(1, 1, 4, name)) == jax_spatial_granularity(
            jax_define_g(1, 4, name)) == granularity(name), name
    assert spatial_granularity(define_g(1, 1, 4, "Dynet")) == (32, 32, 16)


def test_dynet_reference_default_structure():
    """At the options' default (128, 128, 64): six levels, filters 32 to 320,
    a last stride (2, 2, 1) whose upsampler has kernel = stride = (2, 2, 1),
    and 28 instance norms (input block 3, four downsamples x 3, bottleneck
    3, five upsamples x 2)."""
    net = define_g(1, 1, 32, "Dynet")
    assert [b.conv1.conv.weight.shape[0] for b in (net.input_block, *net.downsamples,
                                                   net.bottleneck)] == [32, 64, 128, 256, 320,
                                                                        320]
    assert net.bottleneck.conv1.conv.stride == (2, 2, 1)
    assert net.upsamples[0].transp_conv.conv.weight.shape == (320, 320, 2, 2, 1)
    norms = [n for n, _ in net.named_modules() if n.split(".")[-1].startswith("norm")]
    assert len(norms) == 28


def test_batch_norm_uses_batch_statistics_in_eval_mode():
    """Train and eval mode give the same output, the batch's normalization
    with the affine, where ``nn.BatchNorm3d.eval()`` would use running
    statistics."""
    bn = BatchNorm3d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5]))
        bn.bias.copy_(torch.tensor([0.0, -1.0, 3.0]))
    x = torch.randn(2, 3, 4, 5, 6, generator=torch.Generator().manual_seed(0)) * 3 + 2
    ref = torch.nn.functional.batch_norm(x, None, None, bn.weight, bn.bias, training=True)
    torch.testing.assert_close(bn.train()(x), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.eval()(x), ref, rtol=1e-5, atol=1e-5)
    assert set(bn.state_dict()) == {"weight", "bias"}


def test_too_small_unet_input_raises_the_jax_message():
    net = define_g(1, 1, 4, "unet_128")
    with pytest.raises(ValueError, match=r"num_downs=7 needs every spatial dim >= 128"):
        net(torch.zeros(1, 1, 64, 128, 128))
    with pytest.raises(ValueError, match="unet_custom=5 downs"):
        check_patch("unet_custom", (64, 64, 16))
    check_patch("unet_custom", (32, 32, 32))
    check_patch("Dynet", (8, 8, 8))


def test_factories_refuse_unknown_names():
    with pytest.raises(NotImplementedError, match=r"Generator model name \[unet_64\]"):
        define_g(1, 1, 4, "unet_64")
    with pytest.raises(NotImplementedError, match=r"Discriminator model name \[patch\]"):
        define_d(1, 4, "patch")
    with pytest.raises(NotImplementedError, match=r"normalization layer \[group\]"):
        define_g(1, 1, 4, "resnet_6blocks", "group")
