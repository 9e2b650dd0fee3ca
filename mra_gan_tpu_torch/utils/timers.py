"""Step and data timing, and the parameter summary (counterpart of
mra_gan_tpu/utils/timers.py); the profiler trace is the training driver's
``--profile_dir``."""
from __future__ import annotations

import time
from typing import List

from torch import nn


class StepTimer:
    """Wall time of each data wait (``data_ready``) and of the work after it
    up to ``step_done``. ``t_data`` and ``t_comp`` are the last of each, as
    in the JAX package; ``data_s`` and ``comp_s`` keep every one."""

    def __init__(self):
        self._last = time.perf_counter()
        self.t_data = 0.0
        self.t_comp = 0.0
        self.data_s: List[float] = []
        self.comp_s: List[float] = []

    def data_ready(self):
        now = time.perf_counter()
        self.t_data = now - self._last
        self.data_s.append(self.t_data)
        self._last = now

    def step_done(self):
        now = time.perf_counter()
        self.t_comp = now - self._last
        self.comp_s.append(self.t_comp)
        self._last = now


def count_params(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())


def print_networks(nets: dict, verbose: bool = False) -> None:
    """Parameter counts of ``{"g_a": ..., "g_b": ..., "d_a": ..., "d_b": ...}``
    (a CycleGANState's ``nets``) in the JAX package's format; with
    ``verbose``, every parameter's name and shape too."""
    print("---------- Networks initialized -------------")
    for group, key in (("G_A", "g_a"), ("G_B", "g_b"), ("D_A", "d_a"), ("D_B", "d_b")):
        net = nets[key]
        if verbose:
            for name, p in net.named_parameters():
                print(f"  {group}/{name}: {tuple(p.shape)}")
        print(f"[Network {group}] Total number of parameters : "
              f"{count_params(net) / 1e6:.3f} M")
    print("-----------------------------------------------")
