"""The port's train step with the pixel discriminator (``--netD pixel``)
against the JAX package's jitted step, on the CPU in float32:
resnet_6blocks at 16^3 (the step tests' patch), ngf = ndf = 4, a pool of 1 fed the JAX draws, the
bars of ``torch_port_util.steps_match_jax``; then the JAX state after
those steps, saved by its ``CheckpointManager`` and read back by
``restore_raw``, into the port through ``load_jax_state``, held exactly."""
import jax
import numpy as np
import torch

from mra_gan_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from mra_gan_tpu_torch.checkpoint.jax_import import load_jax_state
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state

from torch_port_util import assert_jax_state_imported, steps_match_jax

COMMON = dict(ngf=4, ndf=4, net_g="resnet_6blocks", net_d="pixel", gan_mode="lsgan",
              pool_size=1)
PATCH = (16, 16, 16)


def test_pixel_d_steps_match_jax_and_its_state_imports(tmp_path):
    _, jstate, _ = steps_match_jax(COMMON, PATCH)
    mgr = JaxCheckpointManager(tmp_path, "run")
    mgr.save(3, jstate, also_latest=False)
    tree = mgr.restore_raw(3)
    state = create_state(CycleGANConfig(**COMMON), 7, PATCH, device="cpu")
    assert_jax_state_imported(load_jax_state(state, tree), tree)
