"""Checkpoints of the port (counterpart of mra_gan_tpu/checkpoint): the
train state's ``CheckpointManager`` and network weights in the reference
torch layout."""
from .io import (
    load_jax_nets,
    load_reference_pth,
    reference_state_dict,
    save_reference_pth,
    state_dict_from_jax,
)
from .manager import CheckpointManager

__all__ = ["CheckpointManager", "load_jax_nets", "load_reference_pth", "reference_state_dict",
           "save_reference_pth", "state_dict_from_jax"]
