"""Tensor ops of the port: convs over torch.nn.functional, init schemes, and
the instance norm that runs on the hand-written CUDA kernels."""
