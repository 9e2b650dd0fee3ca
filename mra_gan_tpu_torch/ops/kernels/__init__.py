"""Hand-written CUDA kernels (csrc/), their nvcc build (build.py) and their
ctypes wrappers with plain PyTorch versions beside them."""
