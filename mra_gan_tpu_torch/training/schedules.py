"""Learning-rate policies of the reference's get_scheduler (the port's copy
of mra_gan_tpu/training/schedules.py:18-63). Each gives the lr of a whole
epoch, on the host; the train step takes lr as an argument.

- lambda:  lr * (1 - max(0, c + 1 + epoch_count - niter) / (niter_decay + 1)),
           c = epoch - epoch_count
- step:    lr * 0.1^((epoch - 1) // lr_decay_iters)
- plateau: ReduceLROnPlateau(mode=min, factor=0.2, threshold=0.01, patience=5)
- cosine:  0.5 * lr * (1 + cos(pi * (epoch - 1) / niter))

One departure from the JAX package, for lambda only: c counts the epochs of
this run, as the reference's scheduler does (it is created at the start of
the run, so its counter starts at 0 whatever ``epoch_count`` is). The JAX
package takes c = epoch - 1, which equals it when epoch_count is 1 and
otherwise decays epoch_count - 1 epochs early, so that a run resumed with
``--epoch_count`` would not train at the lr of the run that never stopped.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class LRScheduler:
    policy: str
    base_lr: float
    niter: int = 500
    niter_decay: int = 100
    epoch_count: int = 1
    lr_decay_iters: int = 50
    # plateau state
    _best: float = field(default=math.inf)
    _num_bad: int = field(default=0)
    _plateau_lr: float = field(default=0.0)

    def __post_init__(self):
        self._plateau_lr = self.base_lr

    def lr_for_epoch(self, epoch: int, metric: Optional[float] = None) -> float:
        """lr to use during ``epoch`` (1-based, like the reference loop)."""
        if self.policy == "lambda":
            e = epoch - self.epoch_count
            factor = 1.0 - max(0, e + 1 + self.epoch_count - self.niter) / float(
                self.niter_decay + 1)
            return self.base_lr * factor
        if self.policy == "step":
            e = epoch - 1
            return self.base_lr * (0.1 ** (e // self.lr_decay_iters))
        if self.policy == "plateau":
            if metric is not None:
                # threshold-relative 'min' mode, factor 0.2, patience 5
                if metric < self._best * (1 - 0.01):
                    self._best = metric
                    self._num_bad = 0
                else:
                    self._num_bad += 1
                    if self._num_bad > 5:
                        self._plateau_lr *= 0.2
                        self._num_bad = 0
            return self._plateau_lr
        if self.policy == "cosine":
            e = epoch - 1
            return 0.5 * self.base_lr * (1 + math.cos(math.pi * e / self.niter))
        raise NotImplementedError(f"learning rate policy [{self.policy}] is not implemented")
