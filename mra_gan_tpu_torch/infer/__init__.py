"""Full-volume decode (counterpart of mra_gan_tpu/infer)."""
