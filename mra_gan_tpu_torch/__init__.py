"""PyTorch/CUDA port of mra_gan_tpu for one NVIDIA H100.

The JAX package ``mra_gan_tpu`` is the reference; this package mirrors its
module names so that each counterpart is easy to find. It imports torch,
numpy and scipy only, never JAX and nothing of ``mra_gan_tpu``.

Implemented so far: the serving path, i.e. the full-volume decode of a
resnet generator (``python -m mra_gan_tpu_torch.test``), with every forward
instance norm running through the hand-written CUDA kernels of
``ops/kernels/csrc/instance_norm.cu``. Entry points run on CUDA unless the
caller passes ``device="cpu"`` (``--device cpu``).
"""
