"""Precision policy (counterpart of mra_gan_tpu/core/dtypes.py).

Parameters stay float32; the forward computes in the policy's dtype (convs
cast their weights to the activation dtype, as the JAX Conv3D does)."""
from __future__ import annotations

import torch

_COMPUTE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def compute_dtype(name: str = "bfloat16") -> torch.dtype:
    if name not in _COMPUTE:
        raise ValueError(f"unknown precision policy {name!r}; options: {list(_COMPUTE)}")
    return _COMPUTE[name]


def set_conv_precision(dtype: torch.dtype) -> None:
    """Under float32 compute, turn TF32 off for cuDNN convolutions and for
    matmuls. cuDNN runs float32 convs in TF32 by default (about three decimal
    digits), which would break float32 parity with the JAX package on the
    card; matmuls default to full float32 already, set here explicitly all
    the same. bfloat16 compute leaves both flags alone."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
