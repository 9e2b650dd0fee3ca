"""The port's loss log, step timer, parameter counts and learning-rate
schedules against the JAX package's: the loss line byte for byte, the
parameter counts of a small state, and every epoch's lr bit for bit."""
import argparse
import math
import re
import time

import jax
import numpy as np
import pytest
import torch

from mra_gan_tpu.training.schedules import LRScheduler as JaxLRScheduler
from mra_gan_tpu.utils.timers import count_params as jax_count_params
from mra_gan_tpu.utils.visualizer import Visualizer as JaxVisualizer
from mra_gan_tpu_torch.training.schedules import LRScheduler
from mra_gan_tpu_torch.utils import StepTimer, Visualizer, count_params, print_networks

LOSSES = {"G_A": 0.8291, "G_B": 0.6939, "cycle_A": 8.99849, "cycle_B": 399.1716,
          "idt_A": 199.6049, "idt_B": 4.5465, "cor_coe_GA": 1.99995, "cor_coe_GB": 2.0,
          "D_A": 0.69351, "D_B": 0.70149}


def test_loss_line_is_byte_equal_to_jax(tmp_path, capsys):
    jax_opt = argparse.Namespace(name="exp", checkpoints_dir=str(tmp_path / "jax"))
    port_opt = argparse.Namespace(name="exp", checkpoints_dir=str(tmp_path / "port"))
    # the drivers hand both loggers the step's float32 losses
    torch_losses = {k: torch.tensor(v, dtype=torch.float32) for k, v in LOSSES.items()}
    jax_losses = {k: float(np.float32(v)) for k, v in LOSSES.items()}
    for epoch, iters, t_comp, t_data in ((3, 40, 0.123, 0.004), (12, 7, 1.23456, 0.0)):
        JaxVisualizer(jax_opt).print_current_losses(epoch, iters, jax_losses, t_comp, t_data)
        jax_line = capsys.readouterr().out
        Visualizer(port_opt).print_current_losses(epoch, iters, torch_losses, t_comp, t_data)
        assert capsys.readouterr().out == jax_line
    jax_log = (tmp_path / "jax" / "exp" / "loss_log.txt").read_text()
    port_log = (tmp_path / "port" / "exp" / "loss_log.txt").read_text()
    strip = re.compile(r"\(.*\) =+$", re.M)  # the header's time stamp
    assert strip.sub("", port_log) == strip.sub("", jax_log)
    assert port_log.count("================ Training Loss (") == 2  # append mode


def test_step_timer_splits_data_and_compute():
    t = StepTimer()
    time.sleep(0.02)
    t.data_ready()
    time.sleep(0.01)
    t.step_done()
    assert t.t_data >= 0.015
    assert 0.005 <= t.t_comp < t.t_data
    assert t.data_s == [t.t_data] and t.comp_s == [t.t_comp]


def test_parameter_counts_equal_the_jax_state(capsys):
    from mra_gan_tpu.models.cycle_gan import CycleGANConfig as JaxConfig
    from mra_gan_tpu.models.cycle_gan import create_state as jax_create_state
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state

    common = dict(ngf=4, ndf=4, n_layers_d=2, pool_size=0)
    jstate = jax.eval_shape(lambda: jax_create_state(JaxConfig(**common),
                                                     jax.random.PRNGKey(0), (16, 16, 16)))
    state = create_state(CycleGANConfig(**common), 0, (16, 16, 16), device="cpu")
    for name in ("g_a", "g_b"):
        assert count_params(state.nets[name]) == jax_count_params(jstate.g_params[name])
    for name in ("d_a", "d_b"):
        assert count_params(state.nets[name]) == jax_count_params(jstate.d_params[name])
    print_networks(state.nets, verbose=True)
    out = capsys.readouterr().out
    n = count_params(state.g_a)
    assert f"[Network G_A] Total number of parameters : {n / 1e6:.3f} M" in out
    assert "G_A/model.1.weight: (4, 1, 7, 7, 7)" in out


@pytest.mark.parametrize("policy, kw", [
    ("lambda", dict(niter=5, niter_decay=7)),
    ("lambda", dict(niter=500, niter_decay=100)),
    ("step", dict(lr_decay_iters=3)),
    ("step", dict(lr_decay_iters=3, epoch_count=4)),
    ("cosine", dict(niter=9)),
    ("cosine", dict(niter=9, epoch_count=3)),
])
def test_lr_is_bit_equal_to_jax_every_epoch(policy, kw):
    port, ref = LRScheduler(policy, 2e-4, **kw), JaxLRScheduler(policy, 2e-4, **kw)
    start = kw.get("epoch_count", 1)
    for epoch in range(start, kw.get("niter", 10) + kw.get("niter_decay", 10) + 1):
        assert port.lr_for_epoch(epoch) == ref.lr_for_epoch(epoch), epoch


def test_plateau_lr_is_bit_equal_to_jax_over_a_metric_sequence():
    rs = np.random.RandomState(4)
    metrics = [None, 5.0, 4.0, 3.99, 3.98, 3.97, 3.96, 3.95, 3.94, 3.5] + list(
        3.5 + rs.rand(20)) + [1.0] + [1.0] * 14
    port, ref = LRScheduler("plateau", 1e-3), JaxLRScheduler("plateau", 1e-3)
    lrs = []
    for epoch, m in enumerate(metrics, start=1):
        lrs.append(port.lr_for_epoch(epoch, metric=m))
        assert lrs[-1] == ref.lr_for_epoch(epoch, metric=m), epoch
    assert len(set(lrs)) >= 3  # the sequence reaches several reductions


def test_lambda_resumed_run_continues_the_schedule():
    """Under --epoch_count N the lambda lr of epoch E is the straight run's,
    as the reference's scheduler gives it (its counter starts at 0 in every
    run). The JAX package counts from epoch 1 instead and decays N - 1
    epochs early in a resumed run; the port departs from it there only."""
    kw = dict(niter=4, niter_decay=4)
    straight = LRScheduler("lambda", 1e-3, **kw)
    want = {e: straight.lr_for_epoch(e) for e in range(1, 9)}
    for start in (2, 5):
        resumed = LRScheduler("lambda", 1e-3, epoch_count=start, **kw)
        assert [resumed.lr_for_epoch(e) for e in range(start, 9)] == \
            [want[e] for e in range(start, 9)]
    jax_resumed = JaxLRScheduler("lambda", 1e-3, epoch_count=5, **kw)
    assert jax_resumed.lr_for_epoch(5) != want[5]
    assert want[3] == 1e-3 and math.isclose(want[4], 0.8e-3) and want[8] == 0.0
