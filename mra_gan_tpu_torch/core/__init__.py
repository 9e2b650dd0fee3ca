from .device import resolve_device
from .dtypes import compute_dtype, set_conv_precision

__all__ = ["resolve_device", "compute_dtype", "set_conv_precision"]
