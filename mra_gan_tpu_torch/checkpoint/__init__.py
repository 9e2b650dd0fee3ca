"""Generator weights in the reference torch layout (counterpart of
mra_gan_tpu/checkpoint)."""
