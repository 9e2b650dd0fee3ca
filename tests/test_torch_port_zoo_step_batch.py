"""The port's train step under ``norm='batch'`` against the JAX package's
jitted step, on the CPU in float32: resnet_6blocks and a 2-layer PatchGAN
at 16^3 (the step tests' patch), ngf = ndf = 4, batch 2, a pool of 2 fed
the JAX draws; the bars are those of ``torch_port_util.steps_match_jax``.
Two choices of the configuration are measured, not arbitrary:

- at 12^3 the generator's trunk runs at 3^3 and the run is chaotic: a
  1e-7 relative change of g_a's weights alone moves g_b's parameters by a
  mean 0.07 (k + 1) lr within the port itself after 3 steps (5e-4 at
  16^3), so the float32 differences of the two frameworks reach the
  Adam-walk bar;
- with seed 0 one pre-activation of g_b's last relu on fake_b lies 6.9e-8
  from the kink, inside the two frameworks' float32 rounding of the
  forward: they put it on opposite sides, and the cycle term's gradient
  with respect to fake_b then differs by 1.3% of its largest element,
  where each framework agrees with a float64 forward on its own side to
  5e-6. With seed 1 the nearest of those pre-activations lies 1.6e-5
  from its kink.

Batch statistics couple the samples of one apply, so the step runs the
unfused applies, six of the generators and four of the discriminators, as
JAX does; the stacked applies of instance norm would give other losses,
which the second test shows."""
import numpy as np
import torch

from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step

from torch_port_util import steps_match_jax

COMMON = dict(ngf=4, ndf=4, net_g="resnet_6blocks", net_d="n_layers", n_layers_d=2,
              norm="batch", gan_mode="lsgan", pool_size=2)
PATCH = (16, 16, 16)


def test_batch_norm_steps_match_jax():
    steps_match_jax(COMMON, PATCH, batch=2, seed=1)


def test_batch_norm_runs_six_plus_four_applies():
    """The G loss applies each generator three times and the D loss each
    discriminator twice, one input each: every apply sees B samples."""
    cfg = CycleGANConfig(**COMMON)
    state = create_state(cfg, 0, PATCH, device="cpu")
    seen = {name: [] for name in state.nets}
    for name, net in state.nets.items():
        net.register_forward_hook(lambda m, inp, out, name=name: seen[name].append(inp[0].shape[0]))
    rs = np.random.RandomState(3)
    a, b = (torch.from_numpy(rs.uniform(-1, 1, (2, 1, *PATCH)).astype(np.float32))
            for _ in range(2))
    make_train_step(cfg)(state, a, b, 2e-4)
    assert seen == {"g_a": [2, 2, 2], "g_b": [2, 2, 2], "d_a": [2, 2, 2], "d_b": [2, 2, 2]}
