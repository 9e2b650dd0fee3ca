"""CycleGAN configuration and the inference forward (counterpart of
mra_gan_tpu/models/cycle_gan.py:39,476).

Only the generator fields are here; the discriminator, loss and optimiser
fields arrive with the training slice."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtypes import set_conv_precision
from .networks import define_g


@dataclasses.dataclass(frozen=True)
class CycleGANConfig:
    input_nc: int = 1
    output_nc: int = 1
    ngf: int = 32
    net_g: str = "resnet_6blocks"
    norm: str = "instance"
    no_dropout: bool = True
    init_type: str = "normal"
    init_gain: float = 0.02
    dtype: torch.dtype = torch.float32

    def build_generator(self, which: str = "g_a",
                        generator: Optional[torch.Generator] = None) -> nn.Module:
        """g_a maps domain A (input_nc channels) to B (output_nc), g_b back.
        float32 parameters on the CPU, drawn from ``generator``."""
        if which not in ("g_a", "g_b"):
            raise ValueError(f"which must be 'g_a' or 'g_b', got {which!r}")
        cin, cout = ((self.input_nc, self.output_nc) if which == "g_a"
                     else (self.output_nc, self.input_nc))
        return define_g(cin, cout, self.ngf, self.net_g, self.norm, not self.no_dropout,
                        self.init_type, self.init_gain, generator)


class GenerateFn:
    """A generator bound to its device and compute dtype. ``fn(x)`` takes
    (B, C, D, H, W), casts it to the compute dtype on the generator's device
    and runs the forward under ``torch.inference_mode()``; the output is in
    the compute dtype."""

    def __init__(self, net: nn.Module, dtype: torch.dtype, device: torch.device):
        self.net, self.dtype, self.device = net, dtype, device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.net(x.to(self.device, self.dtype))


def make_generate_fn(cfg: CycleGANConfig, which: str = "g_a",
                     device: Optional[Union[str, torch.device]] = None,
                     seed: int = 0) -> GenerateFn:
    """Build generator ``which`` (weights from ``seed``; load real ones into
    ``.net`` with checkpoint.load_reference_pth or load_state_dict), in eval
    mode on ``device`` (CUDA by default; channels_last_3d there)."""
    dev = resolve_device(device)
    set_conv_precision(cfg.dtype)
    net = cfg.build_generator(which, torch.Generator().manual_seed(seed)).eval()
    if dev.type == "cuda":
        net = net.to(dev, memory_format=torch.channels_last_3d)
    return GenerateFn(net, cfg.dtype, dev)
