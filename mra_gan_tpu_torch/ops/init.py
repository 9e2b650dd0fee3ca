"""Weight initializers of the reference's ``init_weights`` schemes: normal,
xavier, kaiming and orthogonal on conv kernels, biases zero (counterpart of
mra_gan_tpu/ops/init.py:63).

Each initializer draws in the JAX package's kernel shape (kd, kh, kw, Cin,
Cout), so the fans and the orthogonal flattening are exactly the JAX ones,
from an explicit ``torch.Generator``. The two frameworks' random streams
differ: the same seed gives other values with the same distribution."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def _fans(shape):
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _normal(shape, generator):
    return torch.randn(shape, generator=generator, dtype=torch.float32)


def normal_init(gain: float = 0.02) -> Callable:
    return lambda shape, generator=None: gain * _normal(shape, generator)


def xavier_normal_init(gain: float = 0.02) -> Callable:
    def init(shape, generator=None):
        fan_in, fan_out = _fans(shape)
        return gain * math.sqrt(2.0 / (fan_in + fan_out)) * _normal(shape, generator)

    return init


def kaiming_normal_init() -> Callable:
    # torch kaiming_normal_(a=0, mode='fan_in'): std = sqrt(2 / fan_in)
    def init(shape, generator=None):
        fan_in, _ = _fans(shape)
        return math.sqrt(2.0 / fan_in) * _normal(shape, generator)

    return init


def orthogonal_init(gain: float = 0.02) -> Callable:
    def init(shape, generator=None):
        # torch flattens trailing dims: rows = out, cols = everything else
        n_rows = shape[-1]
        n_cols = math.prod(shape) // n_rows
        flat = _normal((max(n_rows, n_cols), min(n_rows, n_cols)), generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        rev = tuple(reversed(range(len(shape))))
        return gain * q.reshape(tuple(reversed(shape))).permute(rev).reshape(shape)

    return init


def get_initializer(init_type: str = "normal", gain: float = 0.02) -> Callable:
    """-> init(shape, generator) drawing a float32 kernel of the JAX shape."""
    if init_type == "normal":
        return normal_init(gain)
    if init_type == "xavier":
        return xavier_normal_init(gain)
    if init_type == "kaiming":
        return kaiming_normal_init()
    if init_type == "orthogonal":
        return orthogonal_init(gain)
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


@torch.no_grad()
def init_conv_(weight: torch.Tensor, bias: Optional[torch.Tensor], transposed: bool,
               init: Callable, generator: Optional[torch.Generator] = None) -> None:
    """Fill a torch conv weight in place: (Cout, Cin, k, k, k) for a conv,
    (Cin, Cout, k, k, k) for a transposed conv; the bias to zero."""
    if transposed:
        cin, cout = weight.shape[:2]
        perm = (3, 4, 0, 1, 2)  # DHWIO -> IODHW
    else:
        cout, cin = weight.shape[:2]
        perm = (4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    kernel = init((*weight.shape[2:], cin, cout), generator)
    weight.copy_(kernel.permute(perm))
    if bias is not None:
        bias.zero_()
