"""PyTorch/CUDA port of mra_gan_tpu for one NVIDIA H100.

The JAX package ``mra_gan_tpu`` is the reference; this package mirrors its
module names so that each counterpart is easy to find. It imports torch,
numpy and scipy only, never JAX and nothing of ``mra_gan_tpu``.

Entry points: ``python -m mra_gan_tpu_torch.train`` (the training driver),
``.test`` (the full-volume decode), ``.serve`` (the serving daemon),
``.evaluate`` (image-quality metrics) and ``.convert_checkpoint``. Every
instance norm, forward and backward, runs through the hand-written CUDA
kernels of ``ops/kernels/csrc/instance_norm.cu``. Entry points run on CUDA
unless the caller passes ``device="cpu"`` (``--device cpu``).
"""
