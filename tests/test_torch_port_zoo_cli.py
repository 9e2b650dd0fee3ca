"""The port's entry points with the rest of the zoo, on the CPU at small
sizes: ``python -m mra_gan_tpu_torch.train`` for one epoch with ``--netG
unet_custom`` (32^3 patches) and with ``--netG Dynet`` (16^3 patches,
``--dynet_sizes 16 16 16``), then the run's ``latest_net_G_A.pth`` decoded
by ``python -m mra_gan_tpu_torch.test`` (sliding window and
``--single_pass``) and served by ``python -m mra_gan_tpu_torch.serve
--once``. Each output is held against the JAX CLI's ``inference`` on the
same weights, imported into the JAX net by the JAX package's own
``load_torch_network``, at the decode CLI's bar (0.05 on the 0-255 scale,
tests/test_torch_port_cli.py); the served volume equals the port's own
decode bit for bit."""
import argparse
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from mra_gan_tpu.checkpoint import load_torch_network
from mra_gan_tpu.models.cycle_gan import CycleGANConfig as JaxConfig
from mra_gan_tpu.models.networks import define_g as jax_define_g
from mra_gan_tpu_torch import serve as serve_cli
from mra_gan_tpu_torch import test as port_cli
from mra_gan_tpu_torch import train as port_train
from mra_gan_tpu_torch.data import nifti

from torch_port_util import jax_params, write_train_data

REPO = Path(__file__).resolve().parents[1]
TOL_0_255 = 0.05
# netG -> (patch, extra network flags, training volume shape, decoded
# volume shape, stride)
NETS = {
    "unet_custom": ((32, 32, 32), [], (36, 36, 36), (40, 34, 33), 16),
    "Dynet": ((16, 16, 16), ["--dynet_sizes", "16", "16", "16"], (24, 24, 24), (20, 18, 17), 8),
}


def _net_flags(net_g):
    patch, extra = NETS[net_g][:2]
    return ["--netG", net_g, "--patch_size", *map(str, patch), *extra]
COMMON = ["--ngf", "4", "--precision", "float32", "--device", "cpu"]


@pytest.fixture(scope="module", params=list(NETS))
def trained(request, tmp_path_factory):
    """(netG, the checkpoints directory of a one-epoch run, the train
    driver's result, a directory with one volume to decode)."""
    net_g = request.param
    train_shape, shape = NETS[net_g][2:4]
    root = tmp_path_factory.mktemp(net_g)
    data = write_train_data(root / "data", n=2, shape=train_shape)
    out = port_train.main(["--data_path", str(data), "--checkpoints_dir", str(root / "ck"),
                           "--name", "run", "--ndf", "4", "--n_layers_D", "1",
                           "--pool_size", "2", "--num_samples", "1", "--niter", "1",
                           "--niter_decay", "0", "--lr_policy", "step", "--save_epoch_freq",
                           "1", "--print_freq", "1", "--no_mem_check", "--workers", "0",
                           *_net_flags(net_g), *COMMON])
    (root / "in").mkdir()
    data = (np.random.RandomState(5).rand(*shape) * 80 + 10).astype(np.float32)
    nifti.save(nifti.NiftiImage(data=data, affine=np.diag([1.0, 1.2, 2.0, 1.0])),
               root / "in" / "v.nii.gz")
    return net_g, root, out


def _decode_args(root, net_g, *extra):
    stride = NETS[net_g][4]
    return ["--checkpoints_dir", str(root / "ck"), "--name", "run", "--stride_inplane",
            str(stride), "--stride_layer", str(stride), *_net_flags(net_g), *COMMON, *extra]


def _jax_loaded(root, net_g):
    """The JAX CLI's (cfg, forward, params, net) for the run's G_A."""
    sizes = (16, 16, 16) if net_g == "Dynet" else (128, 128, 64)
    jnet = jax_define_g(1, 4, net_g, dynet_sizes=sizes)
    params = load_torch_network(root / "ck" / "run" / "latest_net_G_A.pth",
                                jax_params(jnet, NETS[net_g][0]), arch=net_g)
    forward = jax.jit(lambda x: jnet.apply(params, x, train=False))
    return JaxConfig(ngf=4, net_g=net_g, dynet_sizes=sizes), forward, params, jnet


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_test_cli", REPO / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_one_epoch_trains_and_saves(trained):
    net_g, root, out = trained
    state = out["state"]
    assert state.step == 2 and state.cfg.net_g == net_g and out["epochs"][0]["lr"] == 2e-4
    run = root / "ck" / "run"
    for f in ("ckpt_1.pt", "ckpt_latest.pt", "latest_net_G_A.pth", "latest_net_D_B.pth"):
        assert (run / f).exists(), f
    lines = [ln for ln in (run / "loss_log.txt").read_text().splitlines() if "G_A" in ln]
    assert lines and all("nan" not in ln for ln in lines)


@pytest.mark.parametrize("mode", ["sliding_window", "single_pass"])
def test_decode_matches_the_jax_cli(trained, mode, tmp_path):
    net_g, root, _ = trained
    extra = ["--single_pass"] if mode == "single_pass" else []
    args = _decode_args(root, net_g, "--image", str(root / "in" / "v.nii.gz"), "--result",
                        str(tmp_path / "out.nii"), *extra)
    assert port_cli.main(args) == []
    got = nifti.load(tmp_path / "out.nii")
    src = nifti.load(root / "in" / "v.nii.gz")
    assert got.data.shape == src.data.shape and np.all(np.isfinite(got.data))
    np.testing.assert_allclose(got.affine, src.affine, atol=1e-6)
    ref = _jax_cli().inference(port_cli.parse(args), loaded=_jax_loaded(root, net_g),
                               save=False)
    np.testing.assert_allclose(got.data, ref.data, atol=TOL_0_255)


def test_serve_once_matches_the_decode_and_the_jax_cli(trained, tmp_path):
    net_g, root, _ = trained
    args = _decode_args(root, net_g, "--watch", str(root / "in"), "--result",
                        str(tmp_path / "served"), "--once", "--poll_secs", "0.05")
    assert serve_cli.main(args) == (1, 0)
    got = nifti.load(tmp_path / "served" / "v.nii.gz")
    opt = serve_cli.parse(args)
    sub = argparse.Namespace(**vars(opt))
    sub.image = str(root / "in" / "v.nii.gz")
    want = port_cli.inference(sub, port_cli.load_generator(opt), save=False)
    np.testing.assert_array_equal(got.data, want.data)
    ref = _jax_cli().inference(sub, loaded=_jax_loaded(root, net_g), save=False)
    np.testing.assert_allclose(got.data, ref.data, atol=TOL_0_255)
