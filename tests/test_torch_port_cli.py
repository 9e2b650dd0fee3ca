"""The port's decode CLI (``python -m mra_gan_tpu_torch.test``) on synthetic
NIfTIs, against the JAX package's ``test.inference`` with the same weights,
and the import guard of the port package."""
import argparse
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mra_gan_tpu.checkpoint import save_torch_network
from mra_gan_tpu.models.cycle_gan import CycleGANConfig
from mra_gan_tpu_torch import test as port_cli
from mra_gan_tpu_torch.data import nifti
from mra_gan_tpu_torch.options.test_options import build_parser

from torch_port_util import jax_forward, jax_generator

REPO = Path(__file__).resolve().parents[1]
# one decode, float32 both sides, in the 0-255 output range: the generator
# bar (atol 1e-4 on [-1, 1]) times 127.5, with room for the blend's division
TOL_0_255 = 0.05
SMALL = ["--ngf", "4", "--patch_size", "16", "16", "16", "--stride_inplane", "8",
         "--stride_layer", "8", "--decode_batch", "4", "--precision", "float32"]


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_test_cli", REPO / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    jnet, params = jax_generator(seed=11)
    (root / "ck" / "run").mkdir(parents=True)
    save_torch_network(params, root / "ck" / "run" / "latest_net_G_A.pth",
                       arch="resnet_6blocks")
    rng = np.random.RandomState(12)
    (root / "in").mkdir()
    affines = [np.diag([1.0, 1.0, 2.0, 1.0]), np.array(
        [[0.0, -1.2, 0.0, 10.0], [1.2, 0.0, 0.0, -4.0], [0.0, 0.0, 1.5, 3.0], [0, 0, 0, 1.0]])]
    for i, (shape, aff) in enumerate(zip([(26, 20, 17), (18, 21, 15)], affines)):
        data = (rng.rand(*shape) * 80 + 10).astype(np.float32)
        nifti.save(nifti.NiftiImage(data=data, affine=aff), root / "in" / f"{i}.nii.gz")
    return root, jnet, params


def _args(root, image, result, *extra):
    return ["--image", str(image), "--result", str(result), "--checkpoints_dir",
            str(root / "ck"), "--name", "run", "--device", "cpu", *SMALL, *extra]


def test_single_file_matches_jax_cli(setup, tmp_path):
    root, jnet, params = setup
    image = root / "in" / "0.nii.gz"  # odd Z: edge-padded to even, then cropped
    out = tmp_path / "out.nii"
    assert port_cli.main(_args(root, image, out)) == []
    got = nifti.load(out)
    src = nifti.load(image)
    assert got.data.shape == src.data.shape == (26, 20, 17)
    np.testing.assert_allclose(got.affine, src.affine, atol=1e-6)

    opt = port_cli.parse(_args(root, image, out))
    cfg = CycleGANConfig(ngf=4)
    ref = _jax_cli().inference(opt, loaded=(cfg, jax_forward(jnet, params), params, jnet),
                               save=False)
    assert np.all(np.isfinite(got.data))
    np.testing.assert_allclose(got.data, ref.data, atol=TOL_0_255)


def test_directory_mode_decodes_every_volume(setup, tmp_path):
    root, _, _ = setup
    assert port_cli.main(_args(root, root / "in", tmp_path / "out")) == []
    for name in ("0.nii.gz", "1.nii.gz"):
        src, got = nifti.load(root / "in" / name), nifti.load(tmp_path / "out" / name)
        assert got.data.shape == src.data.shape
        np.testing.assert_allclose(got.affine, src.affine, atol=1e-6)
        assert np.all(np.isfinite(got.data))
    single = tmp_path / "single.nii"
    port_cli.main(_args(root, root / "in" / "1.nii.gz", single, "--single_pass"))
    assert nifti.load(single).data.shape == (18, 21, 15)


def test_unported_wire_is_refused(setup, tmp_path):
    """Every wire mode of the JAX CLI is ported; a mode that neither CLI
    has is refused by both parsers, and nothing is written."""
    root, _, _ = setup
    with pytest.raises(SystemExit):
        port_cli.main(_args(root, root / "in" / "0.nii.gz", tmp_path / "o.nii",
                            "--wire", "bf16"))
    with pytest.raises(SystemExit):
        _jax_decode_parser().parse_args(["--wire", "bf16"])
    assert not (tmp_path / "o.nii").exists()


@pytest.mark.parametrize("wire", ["exact", "f32", "f16"])
def test_wire_modes_match_the_jax_cli(setup, tmp_path, wire):
    """Each mode within the CLI's bar of the JAX CLI in the same mode; under
    f16 both round to float16 after the decode, and two values within the
    bar can round one float16 step apart (2^-11 below 1, 127.5 times that
    on the 0-255 scale), so the bar grows by that step."""
    root, jnet, params = setup
    tol = TOL_0_255 + (127.5 * 2.0 ** -11 if wire == "f16" else 0.0)
    image, out = root / "in" / "0.nii.gz", tmp_path / "out.nii"
    assert port_cli.main(_args(root, image, out, "--wire", wire)) == []
    opt = port_cli.parse(_args(root, image, out, "--wire", wire))
    ref = _jax_cli().inference(opt, loaded=(CycleGANConfig(ngf=4), jax_forward(jnet, params),
                                            params, jnet), save=False)
    np.testing.assert_allclose(nifti.load(out).data, ref.data, atol=tol)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_wire_f16_is_float16_rounding_of_exact(setup, precision):
    """f16 rounds the [-1, 1] decode once to float16 (at most 2^-12, half an
    ulp below 1, times 127.5 on the 0-255 scale); f32 uploads float32, which
    the generator casts to its compute dtype as 'exact' uploads it, so the
    two are bit-equal."""
    root, _, _ = setup
    opt = port_cli.parse(_args(root, root / "in" / "0.nii.gz", "unused.nii"))
    opt.precision = precision
    if precision == "bfloat16":
        opt.patch_size, opt.stride_inplane, opt.stride_layer = [16, 16, 16], 8, 8
    gen = port_cli.load_generator(opt)
    outs = {}
    for wire in ("exact", "f32", "f16"):
        opt.wire = wire
        outs[wire] = port_cli.inference(opt, gen, save=False).data
    np.testing.assert_array_equal(outs["f32"], outs["exact"])
    diff = np.abs(outs["f16"] - outs["exact"])
    assert 0 < diff.max() <= 127.5 * 2.0 ** -12 + 1e-4


def test_directory_mode_is_bit_equal_to_one_at_a_time_inference(setup, tmp_path):
    """The overlapped directory decode (read ahead, writes behind) writes
    what a plain inference call per file returns."""
    root, _, _ = setup
    src = tmp_path / "in"
    shutil.copytree(root / "in", src)
    nifti.save(nifti.load(root / "in" / "1.nii.gz"), src / "2.nii")
    assert port_cli.main(_args(root, src, tmp_path / "out")) == []
    opt = port_cli.parse(_args(root, src, tmp_path / "out"))
    gen = port_cli.load_generator(opt)
    for name in ("0.nii.gz", "1.nii.gz", "2.nii"):
        sub = argparse.Namespace(**vars(opt))
        sub.image = str(src / name)
        want = port_cli.inference(sub, gen, save=False)
        got = nifti.load(tmp_path / "out" / name)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)


def test_directory_mode_reports_a_failed_write_as_skipped(setup, tmp_path, monkeypatch, capsys):
    root, _, _ = setup
    real_save = nifti.save

    def save(img, path):
        if Path(path).name == "1.nii.gz":
            raise OSError("disk full")
        return real_save(img, path)

    monkeypatch.setattr(nifti, "save", save)
    assert port_cli.main(_args(root, root / "in", tmp_path / "out")) == ["1.nii.gz"]
    out = capsys.readouterr().out
    assert "FAILED WRITE" in out and "disk full" in out and "1/2 volumes skipped" in out
    assert sorted(os.listdir(tmp_path / "out")) == ["0.nii.gz"]


@pytest.mark.parametrize("flags, error, match", [
    # the parallel flags are ported (tests/test_torch_port_parallel_cli.py);
    # with a world of one rank they fall through to the one-device decode,
    # as the JAX CLI's len(jax.devices()) > 1 guard does
    (["--spatial_shard"], None, None),
    (["--data_parallel"], None, None),
    (["--spatial_parallel"], None, None),  # a training flag the decode ignores
    # every netG is ported; a U-Net deeper than the patch allows is refused
    # with the JAX package's message before any work
    (["--netG", "unet_128"], ValueError, "num_downs=7 needs every spatial dim >= 128"),
], ids=["spatial_shard", "data_parallel", "spatial_parallel", "netG"])
def test_unported_paths_are_refused(setup, tmp_path, flags, error, match):
    root, _, _ = setup
    image = root / "in" / "0.nii.gz"
    if error is not None:
        with pytest.raises(error, match=match):
            port_cli.main(_args(root, image, tmp_path / "o.nii", *flags))
        assert not (tmp_path / "o.nii").exists()
        return
    assert port_cli.main(_args(root, image, tmp_path / "o.nii", *flags)) == []
    assert port_cli.main(_args(root, image, tmp_path / "plain.nii")) == []
    np.testing.assert_array_equal(nifti.load(tmp_path / "o.nii").data,
                                  nifti.load(tmp_path / "plain.nii").data)


def _jax_decode_parser():
    """The JAX decode CLI's parser: base and test options, and the 'test'
    model's --model_suffix (its two-phase parse)."""
    from mra_gan_tpu.models import get_option_setter
    from mra_gan_tpu.options import TestOptions

    parser = TestOptions().initialize(argparse.ArgumentParser())
    return get_option_setter("test")(parser, False)


def test_port_parser_accepts_every_jax_decode_flag_with_its_default():
    jax_parser, port_parser = _jax_decode_parser(), build_parser()
    names = {s for a in port_parser._actions for s in a.option_strings}
    jax_actions = [a for a in jax_parser._actions if a.dest != "help"]
    missing = {s for a in jax_actions for s in a.option_strings} - names
    assert not missing, f"the port's decode parser lacks {sorted(missing)}"
    for a in jax_actions:
        assert port_parser.get_default(a.dest) == jax_parser.get_default(a.dest), a.dest


def test_suffix_renames_the_run_directory_as_jax_does(setup, tmp_path):
    """--suffix {netG} decodes from <checkpoints_dir>/run_resnet_6blocks, the
    name the JAX parse gives; flags a one-GPU decode has no use for are
    accepted and ignored."""
    from mra_gan_tpu.options import TestOptions

    root, _, _ = setup
    ck = tmp_path / "ck"
    (ck / "run_resnet_6blocks").mkdir(parents=True)
    shutil.copy(root / "ck" / "run" / "latest_net_G_A.pth", ck / "run_resnet_6blocks")
    args = ["--image", str(root / "in" / "1.nii.gz"), "--result", str(tmp_path / "o.nii"),
            "--checkpoints_dir", str(ck), "--name", "run", "--suffix", "{netG}"]
    jax_opt = TestOptions().parse(args)
    port_opt = port_cli.parse(args)
    assert port_opt.name == jax_opt.name == "run_resnet_6blocks"
    ignored = ["--gpu_ids", "0,1", "--seed", "3", "--workers", "4", "--verbose", "--model",
               "cycle_gan", "--phase", "val", "--batch_size", "2", "--netD", "pixel"]
    assert port_cli.main([*args, "--device", "cpu", *SMALL, *ignored]) == []
    assert nifti.load(tmp_path / "o.nii").data.shape == (18, 21, 15)


def test_directory_mode_skips_unreadable_volumes(setup, tmp_path):
    """An empty file and a truncated .nii.gz beside good volumes: the good
    ones decode, the bad ones are reported as skipped, and the exit code is 1."""
    root, _, _ = setup
    src = tmp_path / "in"
    shutil.copytree(root / "in", src)
    (src / "empty.nii").write_bytes(b"")
    whole = (root / "in" / "0.nii.gz").read_bytes()
    (src / "truncated.nii.gz").write_bytes(whole[: len(whole) // 2])
    proc = _run(["-m", "mra_gan_tpu_torch.test", *_args(root, src, tmp_path / "out")])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "SKIPPED empty.nii" in proc.stdout and "SKIPPED truncated.nii.gz" in proc.stdout
    assert "2/4 volumes skipped" in proc.stdout
    assert sorted(os.listdir(tmp_path / "out")) == ["0.nii.gz", "1.nii.gz"]


def _run(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_cli_without_cuda_or_cpu_request_fails_clearly(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    root, _, _ = setup
    proc = _run(["-m", "mra_gan_tpu_torch.test", "--image", str(root / "in"),
                 "--result", str(tmp_path / "o"), "--checkpoints_dir", str(root / "ck"),
                 "--name", "run", "--ngf", "4"])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without pulling
    in jax, flax, optax, orbax or any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mra_gan_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mra_gan_tpu')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in banned)\n"
        "need = {'train', 'serve', 'evaluate', 'models.test', 'options.base_options',\n"
        "        'options.train_options', 'utils.visualizer', 'utils.timers',\n"
        "        'utils.metrics', 'training.schedules', 'data.dataset', 'data.transforms',\n"
        "        'data.augment', 'data.registration', 'core.memory',\n"
        "        'organize_folder_structure', 'core.mesh', 'core.spatial_ctx',\n"
        "        'parallel.collectives', 'parallel.sharding', 'data.native',\n"
        "        'check_loader_patches'}\n"
        "missing = sorted(n for n in need if 'mra_gan_tpu_torch.' + n not in names)\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 45 else 0)\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
