"""Epoch-level training schedules (counterpart of mra_gan_tpu/training)."""
