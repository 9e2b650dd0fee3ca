"""The port's training driver (``python -m mra_gan_tpu_torch.train``) on the
CPU at a small config: the same final state, bit for bit, as a hand loop of
create_state + make_train_step over the port's loader and scheduler; the
files a run leaves; --continue_train bit-equal to the straight run; and a
checkpoint converted from reference .pth files resuming under another
objective and dtype."""
import numpy as np
import pytest
import torch

from mra_gan_tpu_torch import convert_checkpoint
from mra_gan_tpu_torch import train as port_train
from mra_gan_tpu_torch.checkpoint import CheckpointManager
from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
from mra_gan_tpu_torch.data import nifti
from mra_gan_tpu_torch.data.dataset import PatchLoader, UnpairedVolumeDataset
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step
from mra_gan_tpu_torch.training.schedules import LRScheduler

from torch_port_util import assert_tree_equal, write_train_data

# tests/test_e2e.py's SMALL: 16^3 patches, ngf = ndf = 4, a 1-layer PatchGAN
SMALL = ["--patch_size", "16", "16", "16", "--ngf", "4", "--ndf", "4", "--n_layers_D", "1",
         "--precision", "float32", "--pool_size", "2", "--batch_size", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_train_data(tmp_path_factory.mktemp("train_data"))


def _argv(data, ck, name, *extra):
    return ["--data_path", str(data), "--checkpoints_dir", str(ck), "--name", name, *SMALL,
            "--no_mem_check", *extra]


def test_two_epochs_equal_a_hand_loop_and_leave_every_file(data, tmp_path):
    out = port_train.main(_argv(data, tmp_path, "run", "--niter", "1", "--niter_decay", "1",
                                "--print_freq", "2", "--save_epoch_freq", "1",
                                "--no_lsgan", "--workers", "2"))
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=1, gan_mode="lsgan", pool_size=2,
                         dtype=torch.float32)
    state = create_state(cfg, 0, (16, 16, 16), device="cpu")
    step = make_train_step(cfg)
    loader = PatchLoader(UnpairedVolumeDataset(data, patch_size=(16, 16, 16), seed=0),
                         batch_size=2, shuffle=True, workers=0)
    sched = LRScheduler("lambda", 2e-4, niter=1, niter_decay=1)
    for epoch in (1, 2):
        lr = sched.lr_for_epoch(epoch)
        for a, b in loader.epoch(epoch):
            step(state, torch.from_numpy(a).permute(0, 4, 1, 2, 3),
                 torch.from_numpy(b).permute(0, 4, 1, 2, 3), lr)
    assert state.step == out["state"].step == 4
    assert_tree_equal(state_to_dict(out["state"]), state_to_dict(state))
    assert [r["lr"] for r in out["epochs"]] == [1e-4, 0.0]
    assert [r["steps"] for r in out["epochs"]] == [2, 2]

    run = tmp_path / "run"
    for e in ("1", "2", "latest"):
        assert (run / f"ckpt_{e}.pt").exists()
        for net in ("G_A", "G_B", "D_A", "D_B"):
            assert (run / f"{e}_net_{net}.pth").exists()
    assert_tree_equal(CheckpointManager(tmp_path, "run").restore_raw("latest"),
                      state_to_dict(state))
    log = (run / "loss_log.txt").read_text()
    assert log.count("(epoch: 1, iters: 2,") == 1 and log.count("(epoch: 2, iters: 4,") == 1
    assert "cycle_A:" in log and "D_B:" in log
    opt_txt = (run / "opt.txt").read_text()
    assert "no_lsgan: False" in opt_txt and "device: cpu" in opt_txt


@pytest.mark.parametrize("policy", ["step", "lambda"])
def test_continue_train_is_bit_equal_to_the_straight_run(data, tmp_path, policy):
    """step: 1 epoch, then --continue_train --epoch_count 2 for a second,
    against 2 straight epochs. lambda: the straight run's own ckpt_1, then
    --continue_train --which_epoch 1 --epoch_count 2 for epochs 2 and 3, at
    the straight run's lr (0.5 and 0 of the base)."""
    if policy == "step":
        sched = ["--lr_policy", "step", "--lr_decay_iters", "1"]
        straight = port_train.main(_argv(data, tmp_path / "a", "s", "--niter", "2",
                                          "--niter_decay", "0", *sched))
        port_train.main(_argv(data, tmp_path / "b", "r", "--niter", "1", "--niter_decay", "0",
                              *sched))
        resumed = port_train.main(_argv(data, tmp_path / "b", "r", "--niter", "2",
                                         "--niter_decay", "0", "--continue_train",
                                         "--epoch_count", "2", *sched))
    else:
        straight = port_train.main(_argv(data, tmp_path / "a", "s", "--niter", "2",
                                          "--niter_decay", "1", "--save_epoch_freq", "1"))
        resumed = port_train.main(_argv(data, tmp_path / "a", "s", "--niter", "2",
                                         "--niter_decay", "1", "--continue_train",
                                         "--which_epoch", "1", "--epoch_count", "2"))
    n = len(resumed["epochs"])
    assert [r["lr"] for r in resumed["epochs"]] == [r["lr"] for r in straight["epochs"][-n:]]
    assert resumed["epochs"][0]["lr"] > 0
    assert resumed["state"].step == straight["state"].step
    assert_tree_equal(state_to_dict(resumed["state"]), state_to_dict(straight["state"]))


def test_dump_patches_writes_the_first_pairs(data, tmp_path):
    port_train.main(_argv(data, tmp_path, "d", "--niter", "1", "--niter_decay", "0",
                          "--dump_patches", "3", "--workers", "0"))
    dumps = sorted((tmp_path / "d" / "patch_dumps").glob("*.nii.gz"))
    assert [p.name for p in dumps] == [
        f"patch_{i:04d}_{t}.nii.gz" for i in range(3) for t in ("A", "B")]
    loader = PatchLoader(UnpairedVolumeDataset(data, patch_size=(16, 16, 16), seed=0),
                         batch_size=2, workers=0)
    pairs = [(a[k, ..., 0], b[k, ..., 0]) for a, b in loader.epoch(1) for k in range(2)]
    for i in range(3):
        for tag, want in zip("AB", pairs[i]):
            got = nifti.load(tmp_path / "d" / "patch_dumps" / f"patch_{i:04d}_{tag}.nii.gz")
            assert got.data.shape == (16, 16, 16)
            np.testing.assert_array_equal(got.data, want)


def test_converted_checkpoint_resumes_under_another_objective(data, tmp_path, monkeypatch):
    """Reference .pth files -> ``convert_checkpoint --from_torch`` (which
    writes the config's defaults: vanilla GAN, float32) -> ``train
    --continue_train --no_lsgan`` in bfloat16: the restore takes the
    networks from the file and the objective and dtype from the flags."""
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=1, pool_size=2)
    src = create_state(cfg, 5, (16, 16, 16), device="cpu")
    torch_dir = tmp_path / "torch"
    CheckpointManager(torch_dir, "ref").save("latest", src, also_latest=False)
    convert_checkpoint.main(["--from_torch", "--torch_dir", str(torch_dir / "ref"),
                             "--checkpoints_dir", str(tmp_path / "ck"), "--name", "run",
                             "--ngf", "4", "--ndf", "4", "--n_layers_D", "1",
                             "--patch_size", "16", "16", "16", "--pool_size", "2",
                             "--device", "cpu"])
    seen = {}
    real = port_train.make_train_step

    def first_state(cfg):
        step = real(cfg)

        def wrapped(state, a, b, lr):
            if not seen:
                seen["cfg"] = state.cfg
                seen["nets"] = {k: {n: v.clone() for n, v in net.state_dict().items()}
                                for k, net in state.nets.items()}
                seen["pool_dtype"] = state.pool_fake_a.images.dtype
                seen["betas"] = state.opt_g.param_groups[0]["betas"]
            return step(state, a, b, lr)

        return wrapped

    monkeypatch.setattr(port_train, "make_train_step", first_state)
    argv = _argv(data, tmp_path / "ck", "run", "--niter", "1", "--niter_decay", "0",
                 "--continue_train", "--no_lsgan", "--beta1", "0.7")
    argv[argv.index("float32")] = "bfloat16"
    out = port_train.main(argv)
    assert seen["cfg"].gan_mode == "lsgan" and seen["cfg"].dtype == torch.bfloat16
    assert seen["pool_dtype"] == torch.bfloat16 and seen["betas"] == (0.7, 0.999)
    for name, net in src.nets.items():
        assert_tree_equal(seen["nets"][name], dict(net.state_dict()), name)
    assert out["state"].step == 2


def test_profile_dir_writes_a_chrome_trace_of_the_first_epoch(data, tmp_path):
    import json

    port_train.main(_argv(data, tmp_path, "p", "--niter", "2", "--niter_decay", "0",
                          "--profile_dir", str(tmp_path / "trace")))
    traces = sorted((tmp_path / "trace").iterdir())
    assert [p.name for p in traces] == ["train_epoch1.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv3d" in str(e.get("name", "")) for e in events)
