"""Generators and the inference forward (counterpart of mra_gan_tpu/models)."""
