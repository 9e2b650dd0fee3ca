"""The port's options layer and model registry against the JAX package's:
the two-phase parse with model-injected flags, every JAX training flag with
its default, opt.txt byte for byte (apart from --device), --suffix and the
inverted --no_lsgan; and the parallel flags' fall-through to the one-device
step on a world of one rank."""
import argparse
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mra_gan_tpu.options import TrainOptions as JaxTrainOptions
from mra_gan_tpu_torch import models as port_models
from mra_gan_tpu_torch import train as port_train
from mra_gan_tpu_torch.models import CycleGANConfig, find_model_using_name, get_option_setter
from mra_gan_tpu_torch.options.train_options import TrainOptions

REPO = Path(__file__).resolve().parents[1]


def _jax_train_module():
    spec = importlib.util.spec_from_file_location("jax_train_cli", REPO / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parse(tmp_path, extra=()):
    return TrainOptions().parse(["--checkpoints_dir", str(tmp_path), *extra])


def test_registry_convention_discovery():
    saved = dict(port_models._MODELS)
    try:
        port_models._MODELS.clear()
        assert find_model_using_name("cycle_gan") is CycleGANConfig
        port_models._MODELS.clear()
        assert get_option_setter("test") is not None
        with pytest.raises(KeyError, match="no module"):
            find_model_using_name("definitely_not_a_model")
    finally:
        port_models._MODELS.clear()
        port_models._MODELS.update(saved)


def test_model_injects_flags(tmp_path):
    opt = _parse(tmp_path)
    assert opt.lambda_A == 10.0 and opt.lambda_B == 10.0
    assert opt.lambda_identity == 0.5
    assert opt.lambda_co_A == 2.0 and opt.lambda_co_B == 2.0
    assert opt.no_dropout is True  # set_defaults override


def test_test_model_injects_model_suffix_and_refuses_training():
    parser = get_option_setter("test")(argparse.ArgumentParser(), False)
    assert parser.get_default("model_suffix") == "_A"
    assert parser.get_default("no_dropout") is True
    with pytest.raises(ValueError, match="train mode"):
        get_option_setter("test")(argparse.ArgumentParser(), True)


def _jax_train_parser():
    opts = JaxTrainOptions()
    parser = opts.initialize(argparse.ArgumentParser())
    from mra_gan_tpu.models import get_option_setter as jax_setter

    return jax_setter("cycle_gan")(parser, True)


def _port_train_parser():
    parser = TrainOptions().initialize(argparse.ArgumentParser())
    return get_option_setter("cycle_gan")(parser, True)


def test_port_train_parser_takes_every_jax_flag_with_its_default():
    jax_parser, port_parser = _jax_train_parser(), _port_train_parser()
    port_flags = {s for a in port_parser._actions for s in a.option_strings}
    jax_actions = [a for a in jax_parser._actions if a.dest != "help"]
    missing = {s for a in jax_actions for s in a.option_strings} - port_flags
    assert not missing, f"the port's train parser lacks {sorted(missing)}"
    for a in jax_actions:
        assert port_parser.get_default(a.dest) == jax_parser.get_default(a.dest), a.dest
    extra = port_flags - {s for a in jax_actions for s in a.option_strings} - {"-h", "--help"}
    assert extra == {"--device"}
    assert port_parser.get_default("device") == "cuda"


@pytest.mark.parametrize("argv", [
    [], ["--no_lsgan", "--ngf", "8", "--patch_size", "16", "16", "32", "--suffix", "{netG}",
         "--lr_policy", "step", "--gpu_ids", "0,1", "--dump_patches", "2"],
], ids=["defaults", "flags"])
def test_opt_txt_is_byte_equal_to_jax_apart_from_device(tmp_path, argv, capsys):
    jax_opt = JaxTrainOptions().parse(["--checkpoints_dir", str(tmp_path / "jax"), *argv])
    port_opt = TrainOptions().parse(["--checkpoints_dir", str(tmp_path / "port"), *argv])
    assert port_opt.name == jax_opt.name
    jax_txt = (tmp_path / "jax" / jax_opt.name / "opt.txt").read_text()
    port_txt = (tmp_path / "port" / port_opt.name / "opt.txt").read_text()
    port_lines = port_txt.split("\n")
    device = [ln for ln in port_lines if ln.split(":")[0].strip() == "device"]
    assert device == [f"{'device':>25}: {'cuda':<30}"]
    port_lines.remove(device[0])
    assert "\n".join(port_lines).replace(str(tmp_path / "port"), str(tmp_path / "jax")) \
        == jax_txt


def test_no_lsgan_default_matches_jax(tmp_path):
    jax_train = _jax_train_module()
    for extra, mode in (([], "vanilla"), (["--no_lsgan"], "lsgan")):
        opt = _parse(tmp_path, extra)
        assert opt.no_lsgan is (mode == "vanilla")
        cfg = port_train.config_from_opt(opt)
        jcfg = jax_train.config_from_opt(JaxTrainOptions().parse(
            ["--checkpoints_dir", str(tmp_path), *extra]))
        assert cfg.gan_mode == jcfg.gan_mode == mode
    assert CycleGANConfig().gan_mode == "vanilla"


def test_config_from_opt_matches_jax_field_by_field(tmp_path):
    argv = ["--checkpoints_dir", str(tmp_path), "--ngf", "8", "--ndf", "16", "--n_layers_D",
            "2", "--lambda_A", "3", "--lambda_identity", "0.25", "--pool_size", "7",
            "--beta1", "0.9", "--precision", "float32", "--init_type", "xavier", "--remat"]
    cfg = port_train.config_from_opt(TrainOptions().parse(argv))
    jcfg = _jax_train_module().config_from_opt(JaxTrainOptions().parse(argv))
    for f in ("input_nc", "output_nc", "ngf", "ndf", "net_g", "net_d", "n_layers_d", "norm",
              "no_dropout", "init_type", "init_gain", "gan_mode", "lambda_a", "lambda_b",
              "lambda_identity", "lambda_co_a", "lambda_co_b", "pool_size", "beta1", "remat"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.dtype == torch.float32


def test_suffix_templating_and_cache_dir(tmp_path):
    opt = _parse(tmp_path, ["--suffix", "{model}_{netG}"])
    assert opt.name.endswith("cycle_gan_resnet_6blocks")
    assert opt.cache_dir == os.path.join(str(tmp_path), opt.name, "cache")


@pytest.mark.parametrize("flags, printed", [
    (["--data_parallel"], None),
    (["--spatial_parallel"], "WARNING: --spatial_parallel ignored — only one device is "
                             "visible; running the single-chip step"),
], ids=["data_parallel", "spatial_parallel"])
def test_train_refuses_unported_paths(tmp_path, capsys, flags, printed):
    """The parallel flags are ported (tests/test_torch_port_parallel_cli.py
    runs them on several ranks). With a world of one rank they fall through
    to the one-device step, as the JAX driver does on one device, with its
    warning for --spatial_parallel: the run is the plain run's, bit for
    bit."""
    from torch_port_util import write_train_data

    data = write_train_data(tmp_path / "data", n=1, shape=(20, 20, 20))
    base = ["--data_path", str(data), "--patch_size", "16", "16", "16", "--ngf", "4",
            "--ndf", "4", "--n_layers_D", "1", "--precision", "float32", "--niter", "1",
            "--niter_decay", "0", "--num_samples", "1", "--workers", "0", "--device", "cpu"]
    plain = port_train.main([*base, "--checkpoints_dir", str(tmp_path / "a")])["state"]
    capsys.readouterr()
    run = port_train.main([*base, "--checkpoints_dir", str(tmp_path / "b"), *flags])["state"]
    out = capsys.readouterr().out
    assert (printed in out) if printed else "WARNING" not in out
    assert run.step == plain.step == 1
    for name, net in plain.nets.items():
        for key, v in net.state_dict().items():
            assert torch.equal(run.nets[name].state_dict()[key], v), f"{name} {key}"


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("module, extra", [
    ("train", ["--data_path", "nowhere"]),
    ("serve", ["--watch", ".", "--result", "served_out", "--once"]),
    ("evaluate", ["--pred", "a.nii", "--target", "b.nii"]),
])
def test_entry_points_without_cuda_or_cpu_request_fail_clearly(tmp_path, module, extra):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    args = ["-m", f"mra_gan_tpu_torch.{module}", *extra]
    if module != "evaluate":
        args += ["--checkpoints_dir", str(tmp_path)]
    if module == "serve":
        args[args.index("served_out")] = str(tmp_path / "served_out")
    proc = _run(args)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr and "--device cpu" in proc.stderr
