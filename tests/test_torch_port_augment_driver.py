"""The training driver with ``--augment`` on the CPU at a small config: the
same final state, bit for bit, as a hand loop that augments each loader
batch with the draws of (seed, epoch, step); a run resumed at an epoch
boundary bit-equal to the straight run; ``--dump_patches`` writing the
patches before augmentation; the value range each pipeline passes."""
import numpy as np
import pytest
import torch

from mra_gan_tpu_torch import train as port_train
from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
from mra_gan_tpu_torch.data import augment, nifti
from mra_gan_tpu_torch.data.dataset import PatchLoader, UnpairedVolumeDataset
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step
from mra_gan_tpu_torch.training.schedules import LRScheduler

from torch_port_util import assert_tree_equal, write_train_data

torch.set_num_threads(2)

SMALL = ["--patch_size", "16", "16", "16", "--ngf", "4", "--ndf", "4", "--n_layers_D", "1",
         "--precision", "float32", "--pool_size", "2", "--batch_size", "2", "--device", "cpu",
         "--no_mem_check", "--print_freq", "1"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_train_data(tmp_path_factory.mktemp("aug_data"))


def _argv(data, ck, name, *extra):
    return ["--data_path", str(data), "--checkpoints_dir", str(ck), "--name", name, *SMALL,
            *extra]


def test_augmented_run_equals_a_hand_loop(data, tmp_path):
    out = port_train.main(_argv(data, tmp_path, "run", "--augment", "--augment_extended",
                                "--niter", "1", "--niter_decay", "1", "--no_lsgan"))
    cfg = CycleGANConfig(ngf=4, ndf=4, n_layers_d=1, gan_mode="lsgan", pool_size=2,
                         dtype=torch.float32)
    state = create_state(cfg, 0, (16, 16, 16), device="cpu")
    step = make_train_step(cfg)
    loader = PatchLoader(UnpairedVolumeDataset(data, patch_size=(16, 16, 16), seed=0),
                         batch_size=2, shuffle=True, workers=0)
    sched = LRScheduler("lambda", 2e-4, niter=1, niter_decay=1)
    plain = create_state(cfg, 0, (16, 16, 16), device="cpu")
    for epoch in (1, 2):
        lr = sched.lr_for_epoch(epoch)
        for i, (a, b) in enumerate(loader.epoch(epoch)):
            a = torch.from_numpy(a).permute(0, 4, 1, 2, 3)
            b = torch.from_numpy(b).permute(0, 4, 1, 2, 3)
            step(plain, a, b, lr)
            # the default monai pipeline: each member's own range
            a, b = augment.augment_batch(a, b, augment.step_generators(0, epoch, i, "cpu"),
                                         value_range=None, extended=True)
            step(state, a, b, lr)
    assert state.step == out["state"].step == 4
    assert_tree_equal(state_to_dict(out["state"]), state_to_dict(state))
    diff = max(float((p - q).abs().max()) for p, q in zip(state.g_a.parameters(),
                                                           plain.g_a.parameters()))
    assert diff > 0  # the augmentation changed what the step saw


@pytest.mark.parametrize("extended", [False, True], ids=["active8", "extended13"])
def test_augmented_resume_is_bit_equal_to_the_straight_run(data, tmp_path, extended):
    flags = ["--augment", *(["--augment_extended"] if extended else []), "--lr_policy", "step",
             "--lr_decay_iters", "1", "--niter_decay", "0"]
    straight = port_train.main(_argv(data, tmp_path / "a", "s", *flags, "--niter", "2"))
    port_train.main(_argv(data, tmp_path / "b", "r", *flags, "--niter", "1"))
    resumed = port_train.main(_argv(data, tmp_path / "b", "r", *flags, "--niter", "2",
                                    "--continue_train", "--epoch_count", "2"))
    assert straight["state"].step == resumed["state"].step == 4
    assert_tree_equal(state_to_dict(resumed["state"]), state_to_dict(straight["state"]))


def test_dump_patches_are_the_loader_patches(data, tmp_path):
    port_train.main(_argv(data, tmp_path, "d", "--augment", "--dump_patches", "3",
                          "--niter", "1", "--niter_decay", "0"))
    loader = PatchLoader(UnpairedVolumeDataset(data, patch_size=(16, 16, 16), seed=0),
                         batch_size=2, shuffle=True, workers=0)
    batches = list(loader.epoch(1))
    want = [(a[k, ..., 0], b[k, ..., 0]) for a, b in batches for k in range(a.shape[0])][:3]
    dumps = tmp_path / "d" / "patch_dumps"
    assert len(list(dumps.iterdir())) == 6
    for i, (a, b) in enumerate(want):
        np.testing.assert_array_equal(nifti.load(dumps / f"patch_{i:04d}_A.nii.gz").data, a)
        np.testing.assert_array_equal(nifti.load(dumps / f"patch_{i:04d}_B.nii.gz").data, b)


@pytest.mark.parametrize("pipeline, value_range", [("legacy", (-1.0, 1.0)), ("monai", None)])
def test_each_pipeline_passes_its_value_range(data, tmp_path, monkeypatch, pipeline,
                                              value_range):
    seen = []

    def record(a, b, generators, value_range=None, extended=False):
        seen.append((value_range, extended, generators[1].device.type, tuple(a.shape)))
        return a, b

    monkeypatch.setattr(port_train, "augment_batch", record)
    port_train.main(_argv(data, tmp_path, "p", "--augment", "--pipeline", pipeline,
                          "--niter", "1", "--niter_decay", "0"))
    assert seen and all(s == (value_range, False, "cpu", (2, 1, 16, 16, 16)) for s in seen)
