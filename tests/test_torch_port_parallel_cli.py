"""The parallel flags through the port's entry points on gloo ranks of the
CPU (tests/torch_port_parallel_ranks.py, the process group joined before
``main`` is called, as torchrun's would be):

- ``python -m mra_gan_tpu_torch.train`` with --data_parallel (2 ranks, and
  with --augment --dump_patches 2), --spatial_parallel (2 ranks) and both
  with --space_devices (2 x 2 on 4 ranks), one short epoch: rank 0 alone
  writes the loss lines and the checkpoint, which restores into a
  one-device state bit-equal to every rank's final state; the augmented
  run's dumps are the one-device run's and its checkpoint is within the
  Adam walk of the one-device run's; --spatial_parallel --space_devices 2
  on 4 ranks leaves two ranks idle, as the JAX driver leaves devices idle,
  and the memory preflight of the two busy ranks reduces over their mesh
  alone; a rank that runs out of memory inside its trial steps, before a
  collective its peers wait in, ends all four ranks with the preflight's
  SystemExit, over the data axis and over the space axis;
- the JAX driver's SystemExits for the parallel flags (train.py:89-145);
- ``python -m mra_gan_tpu_torch.test`` with --spatial_shard and
  --data_parallel on 2 ranks against the one-device decodes (the single
  pass and the sliding window), rank 0 alone writing."""
from __future__ import annotations

import argparse
import gzip
import time

import numpy as np
import pytest
import torch

from mra_gan_tpu_torch import test as decode_cli
from mra_gan_tpu_torch import train as train_cli
from mra_gan_tpu_torch.checkpoint import CheckpointManager
from mra_gan_tpu_torch.checkpoint.io import save_reference_pth
from mra_gan_tpu_torch.data import nifti
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_generate_fn
from mra_gan_tpu_torch.train import check_parallel
from torch_port_parallel_ranks import (rank_decode_main, rank_train_main, rank_train_preflight,
                                      start_ranks)
from torch_port_util import write_train_data

PATCH = ["--patch_size", "16", "16", "16"]
SMALL = ["--ngf", "4", "--ndf", "4", "--n_layers_D", "1", "--precision", "float32",
         "--niter", "1", "--niter_decay", "0", "--num_samples", "2", "--workers", "0",
         "--batch_size", "2", "--print_freq", "2", "--device", "cpu"]


@pytest.mark.parametrize("flags, world, busy", [
    (["--data_parallel"], 2, 2),
    (["--data_parallel", "--augment", "--dump_patches", "2"], 2, 2),
    (["--spatial_parallel"], 2, 2),
    (["--data_parallel", "--spatial_parallel", "--space_devices", "2"], 4, 4),
    (["--spatial_parallel", "--space_devices", "2"], 4, 2),
], ids=["data_parallel", "data_parallel_augment_dumps", "spatial_parallel", "data_x_space",
        "space_devices_idle"])
def test_train_cli_runs_over_ranks_and_saves_a_one_device_checkpoint(tmp_path, flags, world,
                                                                      busy):
    data = write_train_data(tmp_path / "data", n=2, shape=(20, 20, 20))
    argv = ["--data_path", str(data), "--checkpoints_dir", str(tmp_path / "ck"),
            "--name", "run", *PATCH, *SMALL, *flags]
    wait = start_ranks(rank_train_main, world, tmp_path, argv)
    one = None
    if "--dump_patches" in flags:  # the one-device run beside it, on the same data
        one = train_cli.main(["--data_path", str(data), "--checkpoints_dir", str(tmp_path / "one"),
                              "--name", "run", *PATCH, *SMALL, *flags[1:]])
    results = wait()
    assert [r["step"] is not None for r in results] == [True] * busy + [False] * (world - busy)
    run = tmp_path / "ck" / "run"
    lines = [ln for ln in (run / "loss_log.txt").read_text().splitlines()
             if ln.startswith("(epoch: 1")]
    assert len(lines) == 2 and "G_A:" in lines[0] and "D_B:" in lines[-1]  # rank 0 only
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=1, dtype=torch.float32)
    state = CheckpointManager(tmp_path / "ck", "run").restore(
        "latest", create_state(cfg, 9, (16, 16, 16), device="cpu"))
    assert state.step == results[0]["step"] == 2
    assert state.pool_fake_a.count == 4
    for r in results[:busy]:
        for name, net in state.nets.items():
            for key, v in net.state_dict().items():
                assert torch.equal(r["params"][name][key], v), f"{name} {key}"
    if one is not None:
        # the same four patches, written by rank 0 whatever rows it loads
        dumps = sorted(p.name for p in (run / "patch_dumps").iterdir())
        assert dumps == [f"patch_{i:04d}_{t}.nii.gz" for i in range(2) for t in "AB"]
        for name in dumps:  # gzip headers carry the write time; the NIfTI bytes
            assert gzip.decompress((run / "patch_dumps" / name).read_bytes()) == gzip.decompress(
                (tmp_path / "one" / "run" / "patch_dumps" / name).read_bytes()), name
        # the steps differ by their sums' order only: within the Adam walk
        # bound of two steps (tests/torch_port_util.py steps_match_jax)
        lr = 2e-4
        assert one["state"].step == state.step
        for name, net in one["state"].nets.items():
            for key, v in net.state_dict().items():
                d = (state.nets[name].state_dict()[key] - v).abs()
                assert float(d.max()) <= 2 * 2 * lr and float(d.mean()) <= 0.15 * 2 * lr, \
                    f"{name} {key}: max {float(d.max()):.3g}, mean {float(d.mean()):.3g}"


@pytest.mark.parametrize("limit, oom_rank, message", [
    ("3", -1, None),
    ("1.5", -1, "device memory 2.00 GiB exceeds the 1.50 GiB limit"),
    ("3", 1, "out of device memory in the trial steps"),
], ids=["under_limit", "over_limit", "out_of_memory"])
def test_preflight_reduces_over_the_mesh_with_idle_ranks(tmp_path, limit, oom_rank, message):
    """--spatial_parallel --space_devices 2 on 4 ranks: ranks 2 and 3 are
    idle and run no preflight, so the busy ranks' reduction must not wait
    for them. The largest peak (rank 1's 2 GiB) reaches both busy ranks,
    and an exit on either, over the limit or out of memory, ends both."""
    data = write_train_data(tmp_path / "data", n=2, shape=(20, 20, 20))
    argv = ["--data_path", str(data), "--checkpoints_dir", str(tmp_path / "ck"),
            "--name", "run", *PATCH, *SMALL, "--spatial_parallel", "--space_devices", "2",
            "--hbm_limit_gib", limit]
    results = start_ranks(rank_train_preflight, 4, tmp_path, argv, oom_rank, timeout_s=60)()
    assert [r["est"] for r in results[2:]] == [[], []]
    if message is None:
        assert [r["exit"] for r in results] == [None] * 4
        assert [r["est"][0]["peak"] for r in results[:2]] == [2 << 30] * 2
    else:
        assert all(message in r["exit"] and "--spatial_parallel" in r["exit"]
                   for r in results[:2]), [r["exit"] for r in results]
        assert [r["exit"] for r in results[2:]] == [None, None]


@pytest.mark.parametrize("flags", [
    ["--data_parallel", "--batch_size", "4"],
    ["--spatial_parallel"],
], ids=["data_axis", "space_axis"])
def test_preflight_ends_the_mesh_when_a_rank_runs_out_inside_its_trial(tmp_path, flags):
    """Rank 1 of 4 runs out of memory at the start of its first trial step,
    before the step's first collective, which ranks 0, 2 and 3 enter and
    would wait in until the group's timeout (90 s): every rank must end with
    the preflight's SystemExit, and the spawn well within 45 s."""
    data = write_train_data(tmp_path / "data", n=2, shape=(20, 20, 20))
    argv = ["--data_path", str(data), "--checkpoints_dir", str(tmp_path / "ck"),
            "--name", "run", *PATCH, *SMALL, *flags, "--hbm_limit_gib", "3"]
    t0 = time.monotonic()
    results = start_ranks(rank_train_preflight, 4, tmp_path, argv, 1, True, timeout_s=45)()
    assert time.monotonic() - t0 < 45
    for r in results:
        assert r["est"] == [] and "out of device memory in the trial steps" in r["exit"] \
            and "--spatial_parallel" in r["exit"], r["exit"]
        assert r["seconds"][0] < 30, r["seconds"]


def _opt(**kw):
    base = dict(data_parallel=False, spatial_parallel=False, space_devices=0, batch_size=4)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw, world, message", [
    (dict(data_parallel=True, batch_size=3), 2,
     "--data_parallel requires batch_size (3) divisible by the device count (2); "
     "pick e.g. --batch_size 4"),
    (dict(spatial_parallel=True, space_devices=8), 4,
     "--space_devices 8 exceeds the device count (4)"),
    (dict(spatial_parallel=True, data_parallel=True), 4,
     "--data_parallel + --spatial_parallel needs --space_devices dividing the device count (4)"),
    (dict(spatial_parallel=True, space_devices=3), 3,
     "--spatial_parallel over 3 devices requires a per-device patch depth (D/3 of D=16) "
     "divisible by 4 and >= 4 for net_g=resnet_6blocks"),
    (dict(spatial_parallel=True, data_parallel=True, space_devices=2, batch_size=3), 4,
     "batch_size (3) must be divisible by the data-axis size (2)"),
], ids=["dp_batch", "space_devices", "grid_needs_space_devices", "depth", "grid_batch"])
def test_train_cli_refuses_what_the_jax_driver_refuses(kw, world, message):
    cfg = CycleGANConfig(ngf=4, dtype=torch.float32)
    with pytest.raises(SystemExit) as ei:
        check_parallel(_opt(**kw), cfg, (16, 16, 16), world)
    assert str(ei.value) == message


def test_train_cli_grid_shapes():
    cfg = CycleGANConfig(ngf=4, dtype=torch.float32)
    assert check_parallel(_opt(data_parallel=True), cfg, (16, 16, 16), 4) == (4, 1)
    assert check_parallel(_opt(spatial_parallel=True), cfg, (16, 16, 16), 4) == (1, 4)
    assert check_parallel(_opt(spatial_parallel=True, data_parallel=True, space_devices=2),
                          cfg, (16, 16, 16), 4) == (2, 2)
    assert check_parallel(_opt(data_parallel=True), cfg, (16, 16, 16), 1) is None


def test_decode_cli_over_two_ranks_matches_the_one_device_decodes(tmp_path):
    gen = make_generate_fn(CycleGANConfig(ngf=4, dtype=torch.float32), device="cpu", seed=4)
    (tmp_path / "ck" / "run").mkdir(parents=True)
    save_reference_pth(gen.net, tmp_path / "ck" / "run" / "latest_net_G_A.pth")
    vol = (np.random.RandomState(4).rand(22, 20, 17) * 80 + 10).astype(np.float32)
    nifti.save(nifti.NiftiImage(data=vol, affine=np.diag([1.0, 1.2, 2.0, 1.0])),
               tmp_path / "in.nii.gz")

    def argv(out, *flags):
        return ["--image", str(tmp_path / "in.nii.gz"), "--result", str(tmp_path / out),
                "--checkpoints_dir", str(tmp_path / "ck"), "--name", "run", "--ngf", "4",
                *PATCH, "--stride_inplane", "8", "--stride_layer", "8", "--decode_batch", "2",
                "--precision", "float32", "--device", "cpu", *flags]

    wait = [start_ranks(rank_decode_main, 2, tmp_path, argv(f"{name}.nii", flag))
            for name, flag in (("shard", "--spatial_shard"), ("dp", "--data_parallel"))]
    assert decode_cli.main(argv("one.nii", "--single_pass")) == []
    assert decode_cli.main(argv("sw.nii")) == []
    for w in wait:
        assert w() == [[], []]
    one, sw = nifti.load(tmp_path / "one.nii"), nifti.load(tmp_path / "sw.nii")
    shard, dp = nifti.load(tmp_path / "shard.nii"), nifti.load(tmp_path / "dp.nii")
    np.testing.assert_allclose(shard.affine, one.affine)
    # the 0-255 range: the generator bar (atol 1e-4 on [-1, 1]) times 127.5
    np.testing.assert_allclose(shard.data, one.data, rtol=0, atol=0.0128)
    np.testing.assert_allclose(dp.data, sw.data, rtol=0, atol=0.0128)
