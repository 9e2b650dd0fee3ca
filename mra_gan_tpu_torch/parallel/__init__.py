"""Parallel decodes and train steps over torch.distributed process groups
(counterpart of mra_gan_tpu/parallel)."""
