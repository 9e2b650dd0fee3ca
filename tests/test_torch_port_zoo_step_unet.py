"""The port's train step with a U-Net generator (``unet_custom``, 5 downs)
and the PatchGAN against the JAX package's jitted step, on the CPU in
float32, at 32^3 (the U-Net's smallest input), ngf = ndf = 4, a 2-layer
PatchGAN, a pool of 1 fed the JAX draws; the bars are those of
``torch_port_util.steps_match_jax``. The JAX jit of this step has the file
to itself, so that pytest-xdist spreads it beside the other step files."""
from torch_port_util import steps_match_jax


def test_unet_custom_steps_match_jax():
    common = dict(ngf=4, ndf=4, net_g="unet_custom", net_d="n_layers", n_layers_d=2,
                  gan_mode="lsgan", pool_size=1)
    steps_match_jax(common, (32, 32, 32))
