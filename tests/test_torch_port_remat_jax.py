"""The port's train step under ``--remat`` (resnet_6blocks, 2-layer
PatchGAN, 16^3, ngf = ndf = 4, float32, a pool of 1 fed the JAX draws)
against the JAX package's jitted ``remat=True`` step, at the bars of
``torch_port_util.steps_match_jax``. The JAX jit has the file to itself, so
that pytest-xdist spreads it beside the other step files."""
from torch_port_util import steps_match_jax


def test_remat_steps_match_jax():
    common = dict(ngf=4, ndf=4, net_g="resnet_6blocks", net_d="n_layers", n_layers_d=2,
                  gan_mode="lsgan", pool_size=1, remat=True)
    jcfg, _, state = steps_match_jax(common, (16, 16, 16))
    assert jcfg.remat and state.cfg.remat
