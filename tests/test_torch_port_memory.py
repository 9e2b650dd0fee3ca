"""The port's memory levers on the CPU, with the peak reader injected where
a card would measure: the preflight's trial step leaves the state bit-equal,
refuses over the limit or on an out-of-memory trial with
tests/test_memory.py's advice, is skipped by the environment and
--no_mem_check, and is silent on the CPU; the single pass refuses an
out-of-memory volume with the decode advice, and the directory decode skips
that volume and writes the others."""
import numpy as np
import pytest
import torch

from mra_gan_tpu_torch import test as decode_cli
from mra_gan_tpu_torch import train as port_train
from mra_gan_tpu_torch.checkpoint.io import save_reference_pth
from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
from mra_gan_tpu_torch.core import memory
from mra_gan_tpu_torch.data import nifti
from mra_gan_tpu_torch.models.cycle_gan import (CycleGANConfig, GenerateFn, create_state,
                                                make_generate_fn, make_train_step)
from mra_gan_tpu_torch.parallel.spatial import single_pass_apply

from torch_port_util import assert_tree_equal, write_train_data

torch.set_num_threads(2)

CFG = CycleGANConfig(ngf=4, ndf=4, n_layers_d=1, pool_size=2, no_dropout=False,
                     gan_mode="lsgan", dtype=torch.float32)
PATCH = (16, 16, 16)
GIB = 2 ** 30


def _inputs(seed: int, batch: int = 2):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.uniform(-1, 1, (batch, 1, *PATCH)).astype(np.float32))
            for _ in range(2)]


def _snapshot(state):
    grads = [p.grad for net in state.nets.values() for p in net.parameters()]
    return state_to_dict(state), grads


def _assert_unchanged(state, before):
    raw, grads = before
    assert_tree_equal(state_to_dict(state), raw)
    after = [p.grad for net in state.nets.values() for p in net.parameters()]
    assert all(a is b for a, b in zip(after, grads))


def _reader(peak: int, calls: list):
    def read(trial):
        calls.append(trial())
        return peak
    return read


@pytest.mark.parametrize("steps_before", [0, 2], ids=["fresh", "after_two_steps"])
def test_preflight_leaves_the_state_bit_equal(capsys, steps_before):
    state = create_state(CFG, 0, PATCH, device="cpu")
    step = make_train_step(CFG)
    for k in range(steps_before):
        step(state, *_inputs(k), 2e-4)
    before = _snapshot(state)
    calls = []
    est = memory.preflight(step, state, 2, 2e-4, limit_bytes=GIB,
                           peak_reader=_reader(GIB // 2, calls))
    # one trial of TRIAL_STEPS real steps
    assert len(calls) == 1 and len(calls[0]) == memory.TRIAL_STEPS == 2
    assert all(out[0] is state for out in calls[0])
    assert est == {"peak": GIB // 2, "state": memory.state_bytes(state)}
    assert "train step: device memory ~0.50 GiB (trial steps' peak" in capsys.readouterr().out
    _assert_unchanged(state, before)
    # and the run goes on as if there had been no preflight
    other = create_state(CFG, 0, PATCH, device="cpu")
    for k in range(steps_before):
        step(other, *_inputs(k), 2e-4)
    step(state, *_inputs(9), 2e-4)
    step(other, *_inputs(9), 2e-4)
    assert_tree_equal(state_to_dict(state), state_to_dict(other))


def test_over_the_limit_exits_with_the_train_advice():
    state = create_state(CFG, 0, PATCH, device="cpu")
    before = _snapshot(state)
    with pytest.raises(SystemExit) as ei:
        memory.preflight(make_train_step(CFG), state, 2, 2e-4, limit_bytes=GIB,
                         peak_reader=_reader(2 * GIB, []))
    msg = str(ei.value)
    assert "--remat" in msg and "--spatial_parallel" in msg and "2.00 GiB" in msg
    _assert_unchanged(state, before)


def test_an_out_of_memory_trial_exits_with_the_same_advice():
    state = create_state(CFG, 0, PATCH, device="cpu")
    step = make_train_step(CFG)
    step(state, *_inputs(0), 2e-4)
    before = _snapshot(state)

    def oom(trial):
        trial()  # the step runs, then the allocator gives up
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    with pytest.raises(SystemExit) as ei:
        memory.preflight(step, state, 2, 2e-4, peak_reader=oom)
    assert "--remat" in str(ei.value) and "--spatial_parallel" in str(ei.value)
    _assert_unchanged(state, before)


def test_the_env_skips_it_and_the_cpu_is_silent(monkeypatch, capsys):
    state = create_state(CFG, 0, PATCH, device="cpu")
    step = make_train_step(CFG)
    assert memory.preflight(step, state, 2, 2e-4) is None  # no card, no reader
    assert capsys.readouterr().out == ""
    assert memory.step_memory_estimate(step, state, 2, 2e-4) is None
    assert state.step == 0 and not state.opt_g.state
    monkeypatch.setenv("MRA_GAN_TPU_NO_MEM_CHECK", "1")
    calls = []
    assert memory.preflight(step, state, 2, 2e-4, limit_bytes=1,
                            peak_reader=_reader(2, calls)) is None
    assert calls == []


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_train_data(tmp_path_factory.mktemp("mem_data"))


@pytest.mark.parametrize("flags, limit", [([], None), (["--hbm_limit_gib", "2"], 2 * GIB),
                                          (["--no_mem_check"], "skipped")],
                         ids=["card", "hbm_limit_gib", "no_mem_check"])
def test_the_driver_runs_the_preflight(data, tmp_path, monkeypatch, flags, limit):
    calls = []

    def record(step, state, batch_size, lr, limit_bytes=None):
        calls.append((state.step, batch_size, lr, limit_bytes))

    monkeypatch.setattr(port_train, "preflight", record)
    port_train.main(["--data_path", str(data), "--checkpoints_dir", str(tmp_path), "--name", "r",
                     "--patch_size", "16", "16", "16", "--ngf", "4", "--ndf", "4",
                     "--n_layers_D", "1", "--precision", "float32", "--batch_size", "2",
                     "--niter", "1", "--niter_decay", "0", "--device", "cpu", *flags])
    assert calls == ([] if limit == "skipped" else [(0, 2, 2e-4, limit)])


def test_over_the_limit_ends_the_driver_before_any_step(data, tmp_path, monkeypatch):
    monkeypatch.setattr(memory, "step_memory_estimate",
                        lambda step, state, b, lr, reader=None: {"peak": 3 * GIB, "state": 1})
    with pytest.raises(SystemExit, match="--remat"):
        port_train.main(["--data_path", str(data), "--checkpoints_dir", str(tmp_path),
                         "--name", "r", "--patch_size", "16", "16", "16", "--ngf", "4",
                         "--ndf", "4", "--n_layers_D", "1", "--precision", "float32",
                         "--niter", "1", "--niter_decay", "0", "--device", "cpu",
                         "--hbm_limit_gib", "1"])
    assert not (tmp_path / "r" / "ckpt_latest.pt").exists()


def _oom_above(monkeypatch, voxels: int):
    real = GenerateFn.__call__

    def call(self, x):
        if x[0, 0].numel() > voxels:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(self, x)

    monkeypatch.setattr(GenerateFn, "__call__", call)


def test_single_pass_out_of_memory_raises_the_decode_advice(monkeypatch):
    gen = make_generate_fn(CycleGANConfig(ngf=4, dtype=torch.float32), device="cpu")
    vol = np.random.RandomState(0).uniform(-1, 1, (12, 12, 9)).astype(np.float32)
    assert single_pass_apply(gen, vol).shape == (12, 12, 9)
    _oom_above(monkeypatch, 1000)
    for _ in range(2):  # a refused geometry keeps refusing
        with pytest.raises(RuntimeError) as ei:
            single_pass_apply(gen, vol)
        msg = str(ei.value)
        assert "(12, 12, 9)" in msg and "sliding-window" in msg
        assert "shard the whole volume across a mesh with --spatial_shard" in msg
        assert "not ported" not in msg and "--remat" not in msg


def test_the_directory_decode_skips_the_volume_that_does_not_fit(tmp_path, monkeypatch, capsys):
    gen = make_generate_fn(CycleGANConfig(ngf=4, dtype=torch.float32), device="cpu", seed=3)
    (tmp_path / "ck" / "run").mkdir(parents=True)
    save_reference_pth(gen.net, tmp_path / "ck" / "run" / "latest_net_G_A.pth")
    rs = np.random.RandomState(1)
    (tmp_path / "in").mkdir()
    shapes = {"0.nii.gz": (12, 12, 8), "1.nii.gz": (28, 24, 20), "2.nii": (10, 14, 6)}
    for name, shape in shapes.items():
        nifti.save(nifti.NiftiImage(data=(rs.rand(*shape) * 80).astype(np.float32),
                                    affine=np.eye(4)), tmp_path / "in" / name)
    _oom_above(monkeypatch, 16 * 16 * 16)
    failed = decode_cli.main(["--image", str(tmp_path / "in"), "--result", str(tmp_path / "out"),
                              "--checkpoints_dir", str(tmp_path / "ck"), "--name", "run",
                              "--device", "cpu", "--ngf", "4", "--precision", "float32",
                              "--patch_size", "16", "16", "16", "--single_pass"])
    assert failed == ["1.nii.gz"]
    out = capsys.readouterr().out
    assert "SKIPPED 1.nii.gz: RuntimeError" in out and "sliding-window" in out
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["0.nii.gz", "2.nii"]
    for name in ("0.nii.gz", "2.nii"):
        assert nifti.load(tmp_path / "out" / name).data.shape == shapes[name]
