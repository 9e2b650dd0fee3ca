"""Loss logging in the reference's format (the port's copy of
mra_gan_tpu/utils/visualizer.py): appends loss lines to
``<checkpoints_dir>/<name>/loss_log.txt`` and prints them."""
from __future__ import annotations

import time
from pathlib import Path


class Visualizer:
    def __init__(self, opt):
        self.name = opt.name
        self.log_path = Path(opt.checkpoints_dir) / opt.name / "loss_log.txt"
        self.log_path.parent.mkdir(parents=True, exist_ok=True)
        now = time.strftime("%c")
        with open(self.log_path, "a") as f:
            f.write(f"================ Training Loss ({now}) ================\n")

    def print_current_losses(self, epoch: int, iters: int, losses: dict,
                             t_comp: float, t_data: float) -> None:
        msg = f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, data: {t_data:.3f}) "
        msg += " ".join(f"{k}: {float(v):.3f}" for k, v in losses.items())
        print(msg)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")
