"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to CUDA. Without a card
they raise instead of quietly running on the CPU: the CPU path exists for the
tests and has to be asked for by name."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises RuntimeError for CUDA without a card,
    ValueError for any device type other than cuda and cpu."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU explicitly")
    return dev
