"""Loss log, step timers and image-quality metrics (counterpart of
mra_gan_tpu/utils)."""
from .timers import StepTimer, count_params, print_networks
from .visualizer import Visualizer

__all__ = ["StepTimer", "Visualizer", "count_params", "print_networks"]
