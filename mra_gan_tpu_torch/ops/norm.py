"""Instance norm for (N, C, D, H, W) volumes (counterpart of
mra_gan_tpu/ops/norm.py:53,99).

torch ``nn.InstanceNorm3d(affine=False)`` numerics: biased variance over the
spatial dims, eps 1e-5 inside the square root, statistics in float32 under
bfloat16 compute. A CPU tensor takes the plain version, which follows the JAX
``_in_fwd_core`` step by step; a CUDA tensor takes the hand-written kernels
(ops/kernels/csrc/instance_norm.cu). The JAX package's grouped-lane variant
(``instance_norm_act_grouped``) is a TPU layout rewrite of the same function
and maps to the same call here."""
from __future__ import annotations

import torch

from .kernels.instance_norm import EPS, instance_norm_act_fused, instance_norm_act_plain


def instance_norm_act(x: torch.Tensor, eps: float = EPS, act: str = "none",
                      negative_slope: float = 0.2) -> torch.Tensor:
    """act in {'none', 'relu', 'leaky_relu', 'tanh'}; forward only."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, act, negative_slope, eps)
    if x.requires_grad:
        raise NotImplementedError(
            "instance_norm_act has no backward on CUDA yet: its backward "
            "kernels (Pallas _bwd_sum_kernel/_bwd_apply_kernel) come with the "
            "training slice (ROADMAP Queue A); run under "
            "torch.inference_mode() or torch.no_grad()")
    return instance_norm_act_fused(x, act, negative_slope, eps)


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return instance_norm_act(x, eps, "none")
