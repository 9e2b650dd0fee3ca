"""The port's train step with the Dynet generator (MONAI's DynUNet) and the
PatchGAN against the JAX package's jitted step, on the CPU in float32, at
16^3 with ``dynet_sizes = (16, 16, 16)`` (three levels), ndf = 4, a
2-layer PatchGAN, a pool of 1 fed the JAX draws; the bars are those of
``torch_port_util.steps_match_jax``. The JAX step runs this Dynet and
keeps its pools in its S2D(4) cell layout; the port in the plain one. Then
the JAX state after those steps, saved by its ``CheckpointManager`` and
read back by ``restore_raw``, into the port through ``load_jax_state``,
held exactly: the affine norms' scales and biases and their Adam moments
included."""
from mra_gan_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from mra_gan_tpu_torch.checkpoint.jax_import import load_jax_state
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state

from torch_port_util import assert_jax_state_imported, steps_match_jax

COMMON = dict(ndf=4, net_g="Dynet", net_d="n_layers", n_layers_d=2, gan_mode="lsgan",
              pool_size=1, dynet_sizes=(16, 16, 16))
PATCH = (16, 16, 16)


def test_dynet_steps_match_jax_and_its_state_imports(tmp_path):
    jcfg, jstate, _ = steps_match_jax(COMMON, PATCH)
    assert jcfg.uses_cells(PATCH)
    mgr = JaxCheckpointManager(tmp_path, "run")
    mgr.save(3, jstate, also_latest=False)
    tree = mgr.restore_raw(3)
    assert tree["pool_fake_a"]["images"].shape == (1, 4, 4, 4, 64)  # the cell layout
    state = create_state(CycleGANConfig(**COMMON), 7, PATCH, device="cpu")
    assert_jax_state_imported(load_jax_state(state, tree), tree)
