"""Whole-volume forward on one device (counterpart of mra_gan_tpu/parallel)."""
