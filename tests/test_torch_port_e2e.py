"""End to end through the port's entry points on the CPU, the counterpart of
tests/test_e2e.py:32 at its SMALL config: ``python -m
mra_gan_tpu_torch.train``, ``--continue_train`` for another epoch, the
decode CLI on the saved latest_net_G_A.pth (sliding window, --wire f16,
--single_pass, sub-patch volumes in both pad modes, a directory with a
corrupt file), ``python -m mra_gan_tpu_torch.evaluate`` on the result, and
the serving daemon on the same run. Every file the JAX e2e test checks
exists and opens."""
import shutil

import numpy as np
import pytest
import torch

from mra_gan_tpu_torch import evaluate as eval_cli
from mra_gan_tpu_torch import serve as serve_cli
from mra_gan_tpu_torch import test as test_cli
from mra_gan_tpu_torch import train as train_cli
from mra_gan_tpu_torch.checkpoint import CheckpointManager
from mra_gan_tpu_torch.data import nifti

from torch_port_util import write_train_data

SMALL = ["--patch_size", "16", "16", "16", "--ngf", "4", "--ndf", "4", "--n_layers_D", "1",
         "--precision", "float32", "--device", "cpu"]


@pytest.fixture()
def data_root(tmp_path):
    write_train_data(tmp_path / "train")
    (tmp_path / "test/images").mkdir(parents=True)
    rng = np.random.RandomState(1)
    nifti.save(nifti.NiftiImage(data=rng.rand(26, 24, 22).astype(np.float32) * 80,
                                affine=np.diag([1.0, 1.0, 2.0, 1.0])),
               tmp_path / "test/images/0.nii")
    return tmp_path


def test_train_resume_decode_evaluate(data_root):
    ck = str(data_root / "ck")
    common = ["--data_path", str(data_root / "train"), "--checkpoints_dir", ck, "--name", "e2e",
              *SMALL, "--pool_size", "2", "--batch_size", "2", "--print_freq", "2",
              "--save_epoch_freq", "1", "--no_mem_check"]
    first = train_cli.main(common + ["--niter", "1", "--niter_decay", "0",
                                     "--dump_patches", "3"])
    run = data_root / "ck/e2e"
    assert (run / "ckpt_latest.pt").exists()
    assert (run / "loss_log.txt").read_text().count("epoch: 1") >= 1
    assert "netG: resnet_6blocks" in (run / "opt.txt").read_text()
    dumps = sorted((run / "patch_dumps").glob("*.nii.gz"))
    assert [p.name for p in dumps] == [
        f"patch_{i:04d}_{t}.nii.gz" for i in range(3) for t in ("A", "B")]
    d0 = nifti.load(dumps[0])
    assert d0.data.shape == (16, 16, 16) and np.isfinite(d0.data).all()

    resumed = train_cli.main(common + ["--niter", "2", "--niter_decay", "0",
                                       "--continue_train", "--epoch_count", "2"])
    assert [r["epoch"] for r in resumed["epochs"]] == [2]
    assert resumed["state"].step == 2 * first["state"].step
    assert "epoch: 2" in (run / "loss_log.txt").read_text()
    raw = CheckpointManager(ck, "e2e").restore_raw("latest")
    assert raw["step"] == resumed["state"].step
    g_a = resumed["state"].g_a.state_dict()
    pth = torch.load(run / "latest_net_G_A.pth", weights_only=True)
    assert all(torch.equal(pth[k], v) for k, v in g_a.items())

    image = data_root / "test/images/0.nii"
    decode = ["--checkpoints_dir", ck, "--name", "e2e", *SMALL, "--stride_inplane", "8",
              "--stride_layer", "8"]
    out = data_root / "fake.nii"
    assert test_cli.main(["--image", str(image), "--result", str(out), *decode]) == []
    res, inp = nifti.load(out), nifti.load(image)
    assert res.data.shape == inp.data.shape and np.isfinite(res.data).all()
    np.testing.assert_allclose(res.affine, inp.affine, atol=1e-5)

    out_w = data_root / "fake_w16.nii"
    test_cli.main(["--image", str(image), "--result", str(out_w), *decode, "--wire", "f16"])
    assert float(np.abs(nifti.load(out_w).data - res.data).max()) < 0.2

    metrics = eval_cli.main(["--pred", str(out), "--target", str(image), "--device", "cpu"])
    assert set(metrics) == {"ssim", "psnr", "mae", "pearson_r"}
    assert np.isfinite(list(metrics.values())).all()

    # --spatial_shard on a world of one rank: the one-device decode, as the
    # JAX CLI falls through on one device
    test_cli.main(["--image", str(image), "--result", str(data_root / "s.nii"), *decode,
                   "--spatial_shard"])
    np.testing.assert_array_equal(nifti.load(data_root / "s.nii").data, res.data)
    out_1p = data_root / "fake_single.nii"
    test_cli.main(["--image", str(image), "--result", str(out_1p), *decode, "--single_pass"])
    res_1p = nifti.load(out_1p)
    assert res_1p.data.shape == inp.data.shape and np.isfinite(res_1p.data).all()

    small = data_root / "test/images/small.nii"
    nifti.save(nifti.NiftiImage(
        data=np.random.RandomState(1).rand(10, 12, 14).astype(np.float32) * 80,
        affine=np.eye(4)), small)
    for mode in ("reference", "symmetric"):
        out_s = data_root / f"fake_small_{mode}.nii"
        test_cli.main(["--image", str(small), "--result", str(out_s), *decode,
                       "--pad_mode", mode])
        res_s = nifti.load(out_s)
        assert res_s.data.shape == (10, 12, 14) and np.isfinite(res_s.data).all()

    in_dir = data_root / "batch_in"
    in_dir.mkdir()
    for p in (data_root / "train/images").iterdir():
        shutil.copy(p, in_dir / p.name)
    (in_dir / "corrupt.nii").write_bytes(b"not a nifti")
    assert test_cli.main(["--image", str(in_dir), "--result", str(data_root / "batch_out"),
                          *decode]) == ["corrupt.nii"]
    for i in range(2):
        got = nifti.load(data_root / "batch_out" / f"{i}.nii")
        assert got.data.shape == (24, 24, 24) and np.isfinite(got.data).all()
    dir_eval = eval_cli.main(["--pred", str(data_root / "batch_out"),
                              "--target", str(data_root / "train/labels"), "--device", "cpu"])
    assert np.isfinite(list(dir_eval.values())).all()

    served = serve_cli.main(["--watch", str(in_dir), "--result", str(data_root / "served"),
                             *decode, "--once", "--poll_secs", "0.05"])
    assert served == (2, 1)
    for i in range(2):
        np.testing.assert_array_equal(nifti.load(data_root / "served" / f"{i}.nii").data,
                                      nifti.load(data_root / "batch_out" / f"{i}.nii").data)
