"""Checkpoints of the rest of the zoo (mra_gan_tpu_torch/checkpoint/io.py,
manager.py and the converter) against the JAX package's torch import and
export, on the CPU, with weights drawn with numpy on the shapes of the JAX
nets (``jax.eval_shape`` of their ``init``):

- a ``.pth`` written by the JAX ``save_torch_network`` of each arch
  strict-loads into the port through ``load_reference_pth``, and the
  port's ``reference_state_dict`` of the same weights equals it key for
  key and value for value, under instance norm;
- the two departures, stated where they show: under batch norm the JAX
  export writes zero conv biases the reference's convs lack and leaves out
  the norms' weight and bias, and its import reads conv weights only (a
  fault of the JAX package, ROADMAP Queue C), where the port writes and
  reads them under the reference's norm keys; under ``norm='none'`` the
  JAX export writes running-stat buffers at norm slots that hold nothing,
  the port none (it reads them and drops them);
- a Dynet ``.pth`` carries MONAI's duplicate ``skip_layers`` keys both
  ways; an alias that diverges from its twin, or names no block, raises;
- ``CheckpointManager`` save, restore into a state from another seed and
  resume bit-equal to the straight run for a Dynet + pixel-discriminator
  configuration under batch norm, and the restore's refusal of other
  Dynet sizes;
- the converter (``python -m mra_gan_tpu_torch.convert_checkpoint``) round
  trip of JAX files for every arch, and of the port's own batch-norm files.
"""
import jax
import numpy as np
import pytest
import torch

from mra_gan_tpu.checkpoint import load_torch_network, save_torch_network
from mra_gan_tpu.models.networks import define_d as jax_define_d
from mra_gan_tpu.models.networks import define_g as jax_define_g
from mra_gan_tpu_torch import convert_checkpoint as port_convert
from mra_gan_tpu_torch.checkpoint import (
    CheckpointManager,
    load_reference_pth,
    reference_state_dict,
    save_reference_pth,
    state_dict_from_jax,
)
from mra_gan_tpu_torch.checkpoint.io import read_reference_pth
from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step
from mra_gan_tpu_torch.models.networks import define_d, define_g

from torch_port_util import assert_tree_equal, jax_params

SIZES = (16, 16, 16)
# arch -> (JAX net, port net, spatial of the JAX init)
NETS = {
    "unet_custom": (lambda n: jax_define_g(1, 4, "unet_custom", n),
                    lambda n: define_g(1, 1, 4, "unet_custom", n), (32, 32, 32)),
    "unet_128": (lambda n: jax_define_g(1, 4, "unet_128", n),
                 lambda n: define_g(1, 1, 4, "unet_128", n), (128, 128, 128)),
    "Dynet": (lambda n: jax_define_g(1, 4, "Dynet", dynet_sizes=SIZES),
              lambda n: define_g(1, 1, 4, "Dynet", n, dynet_sizes=SIZES), SIZES),
    "resnet_6blocks": (lambda n: jax_define_g(1, 4, "resnet_6blocks", n),
                       lambda n: define_g(1, 1, 4, "resnet_6blocks", n), (12, 12, 12)),
    "n_layers": (lambda n: jax_define_d(4, "n_layers", 2, n),
                 lambda n: define_d(1, 4, "n_layers", 2, n), (16, 16, 16)),
    "pixel": (lambda n: jax_define_d(4, "pixel", norm=n),
              lambda n: define_d(1, 4, "pixel", norm=n), (8, 8, 8)),
}


def _pair(arch, norm="instance", seed=0):
    """(numpy JAX tree, port net holding the same weights)."""
    jnet, net, spatial = NETS[arch]
    tree = jax_params(jnet(norm), spatial, seed)
    net = net(norm)
    net.load_state_dict(state_dict_from_jax(tree, arch))
    return tree, net


def _assert_same_entries(got, want, ordered=True):
    if ordered:
        assert list(got) == list(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


@pytest.mark.parametrize("arch", ["unet_custom", "unet_128", "Dynet", "pixel"])
def test_jax_pth_loads_and_port_export_equals_it(arch, tmp_path):
    tree, net = _pair(arch, seed=len(arch))
    save_torch_network(tree, tmp_path / "jax.pth", arch=arch)
    loaded = load_reference_pth(tmp_path / "jax.pth", NETS[arch][1]("instance"))
    _assert_same_entries(loaded.state_dict(), net.state_dict())
    save_reference_pth(net, tmp_path / "port.pth", arch)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    # the JAX Dynet export lists each block's convs before its norms; the
    # port keeps MONAI's registration order
    _assert_same_entries(got, want, ordered=arch != "Dynet")
    n_buffers = {"unet_custom": 7, "unet_128": 11, "Dynet": 0, "pixel": 1}[arch]
    assert sum(k.endswith(".running_var") for k in got) == n_buffers


@pytest.mark.parametrize("arch", ["resnet_6blocks", "unet_custom", "n_layers", "pixel"])
def test_batch_norm_pth_departs_from_the_jax_export(arch, tmp_path):
    """The JAX package's fault (ROADMAP Queue C): its batch-norm file lacks
    the norms' weight and bias (and, but for the U-Net, holds zero conv
    biases the reference's bias-free convs lack), so the reference's strict
    load, and the port's, refuse it; its import of the port's file keeps
    the template's norm scales, or, for the resnet, refuses the file: it
    takes the residual block's second norm weight at conv_block.6 for the
    dropout layout. The port's own file carries the norms under the
    reference's BatchNorm3d keys and round-trips exactly."""
    tree, net = _pair(arch, "batch", seed=3)
    save_torch_network(tree, tmp_path / "jax.pth", arch=arch)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_pth(tmp_path / "jax.pth", NETS[arch][1]("batch"))
    jax_sd = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert not any(k.endswith(".weight") and v.dim() == 1 for k, v in jax_sd.items())

    save_reference_pth(net, tmp_path / "port.pth", arch)
    port_sd = torch.load(tmp_path / "port.pth", weights_only=True)
    norms = [k[:-len(".running_var")] for k in port_sd if k.endswith(".running_var")]
    assert norms and all(f"{n}.weight" in port_sd and f"{n}.bias" in port_sd for n in norms)
    assert {k for k in port_sd if not k.endswith(".num_batches_tracked")} >= {
        k for k, v in jax_sd.items() if v.dim() == 5}
    again = load_reference_pth(tmp_path / "port.pth", NETS[arch][1]("batch"))
    _assert_same_entries(again.state_dict(), net.state_dict())

    template = jax_params(NETS[arch][0]("batch"), NETS[arch][2], seed=9)
    if arch == "resnet_6blocks":
        # the JAX import takes the second norm's weight at conv_block.6 for
        # the dropout layout's second conv and refuses the file
        with pytest.raises(ValueError, match="conv count mismatch"):
            load_torch_network(tmp_path / "port.pth", template, arch=arch)
        return
    imported = load_torch_network(tmp_path / "port.pth", template, arch=arch)
    got = state_dict_from_jax(imported, arch)
    want = state_dict_from_jax(template, arch)
    for n in norms:  # the JAX import leaves the norm where the template had it
        assert torch.equal(got[f"{n}.weight"], want[f"{n}.weight"])
        assert not torch.equal(got[f"{n}.weight"], net.state_dict()[f"{n}.weight"])


def test_none_norm_pth_departs_only_by_the_buffers(tmp_path):
    tree, net = _pair("resnet_6blocks", "none", seed=4)
    save_torch_network(tree, tmp_path / "jax.pth", arch="resnet_6blocks")
    save_reference_pth(net, tmp_path / "port.pth", "resnet_6blocks")
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    stats = (".running_mean", ".running_var", ".num_batches_tracked")
    _assert_same_entries(got, {k: v for k, v in want.items() if not k.endswith(stats)})
    loaded = load_reference_pth(tmp_path / "jax.pth", NETS["resnet_6blocks"][1]("none"))
    _assert_same_entries(loaded.state_dict(), net.state_dict())


def test_dynet_aliases_are_written_and_checked(tmp_path):
    tree, net = _pair("Dynet", seed=5)
    sd = reference_state_dict(net, "Dynet")
    aliases = [k for k in sd if k.startswith("skip_layers.")]
    # every block twice but the output block
    assert len(aliases) == len(net.state_dict()) - 2
    assert torch.equal(sd["skip_layers.next_layer.next_layer.conv1.conv.weight"],
                       sd["bottleneck.conv1.conv.weight"])
    assert torch.equal(sd["skip_layers.upsample.conv_block.norm2.bias"],
                       sd["upsamples.1.conv_block.norm2.bias"])
    torch.save(sd, tmp_path / "port.pth")
    # the JAX package's MONAI-layout import takes the port's file
    imported = load_torch_network(tmp_path / "port.pth", tree, arch="Dynet")
    _assert_same_entries(state_dict_from_jax(imported, "Dynet"), net.state_dict())

    bad = dict(sd)
    bad["skip_layers.next_layer.downsample.norm1.weight"] = (
        bad["skip_layers.next_layer.downsample.norm1.weight"] + 1e-3)
    torch.save(bad, tmp_path / "diverged.pth")
    with pytest.raises(ValueError, match="diverges from its canonical twin "
                                         "downsamples.0.norm1.weight"):
        read_reference_pth(tmp_path / "diverged.pth")
    stray = dict(sd)
    stray["skip_layers.next_layer.next_layer.next_layer.conv1.conv.weight"] = torch.zeros(1)
    torch.save(stray, tmp_path / "stray.pth")
    with pytest.raises(ValueError, match="no alias"):
        read_reference_pth(tmp_path / "stray.pth")


ZOO_CFG = dict(ngf=4, ndf=4, net_g="Dynet", net_d="pixel", norm="batch", pool_size=2,
               gan_mode="lsgan", dynet_sizes=SIZES)


def test_zoo_resume_is_bit_equal(tmp_path):
    cfg = CycleGANConfig(**ZOO_CFG)
    step = make_train_step(cfg)
    rs = np.random.RandomState(0)
    batches = [tuple(torch.from_numpy(rs.uniform(-1, 1, (2, 1, *SIZES)).astype(np.float32))
                     for _ in range(2)) for _ in range(4)]
    straight = create_state(cfg, 0, SIZES, device="cpu")
    want = [step(straight, a, b, 2e-4)[1] for a, b in batches]
    first = create_state(cfg, 0, SIZES, device="cpu")
    got = [step(first, a, b, 2e-4)[1] for a, b in batches[:2]]
    mgr = CheckpointManager(tmp_path, "run")
    mgr.save(2, first)
    assert sum(k.startswith("skip_layers.") for k in
               torch.load(mgr.root / "2_net_G_A.pth", weights_only=True)) > 0
    resumed = mgr.restore(2, create_state(cfg, 1, SIZES, device="cpu"))
    got += [step(resumed, a, b, 2e-4)[1] for a, b in batches[2:]]
    for k, (w, g) in enumerate(zip(want, got)):
        assert_tree_equal(w, g, f"metrics of step {k}")
    assert_tree_equal(state_to_dict(straight), state_to_dict(resumed), "state")
    other = CycleGANConfig(**{**ZOO_CFG, "dynet_sizes": (32, 32, 16)})
    with pytest.raises(ValueError, match="config field 'dynet_sizes'"):
        mgr.restore(2, create_state(other, 0, SIZES, device="cpu"))
    # a checkpoint of an earlier version has no Dynet fields: the defaults
    raw = mgr.restore_raw(2)
    assert raw["config"]["dynet_sizes"] == SIZES
    legacy = CycleGANConfig(**{**ZOO_CFG, "net_g": "resnet_6blocks", "dynet_sizes": (128, 128, 64)})
    state = create_state(legacy, 0, SIZES, device="cpu")
    mgr.save(3, state)
    raw = mgr.restore_raw(3)
    for k in ("dynet_sizes", "dynet_spacings"):
        del raw["config"][k]
    torch.save(raw, mgr.path(3))
    mgr.restore(3, create_state(legacy, 1, SIZES, device="cpu"))


# (netG, netD, norm, flags): the converter's network flags per case
CONVERT = {
    "unet_custom": ("unet_custom", "n_layers", "instance", ["--patch_size", "32", "32", "32"]),
    "Dynet": ("Dynet", "n_layers", "instance", ["--patch_size", *map(str, SIZES),
                                                "--dynet_sizes", *map(str, SIZES)]),
    "pixel": ("resnet_6blocks", "pixel", "instance", ["--patch_size", "12", "12", "12"]),
}


@pytest.mark.parametrize("case", list(CONVERT))
def test_converter_round_trip_gives_back_jax_files(case, tmp_path):
    net_g, net_d, norm, flags = CONVERT[case]
    jax_dir = tmp_path / "jax_pth"
    jax_dir.mkdir()
    for i, (suffix, arch) in enumerate((("G_A", net_g), ("G_B", net_g), ("D_A", net_d),
                                        ("D_B", net_d))):
        tree, _ = _pair(arch, norm, seed=20 + i)
        save_torch_network(tree, jax_dir / f"5_net_{suffix}.pth", arch=arch)
    port = ["--checkpoints_dir", str(tmp_path / "ck"), "--name", "run", "--which_epoch", "5",
            "--ngf", "4", "--ndf", "4", "--n_layers_D", "2", "--netG", net_g, "--netD", net_d,
            "--norm", norm, "--device", "cpu", *flags]
    port_convert.main(["--from_torch", "--torch_dir", str(jax_dir), *port])
    port_convert.main(["--to_torch", "--torch_dir", str(tmp_path / "port_pth"), *port])
    for suffix in ("G_A", "G_B", "D_A", "D_B"):
        want = torch.load(jax_dir / f"5_net_{suffix}.pth", weights_only=True)
        got = torch.load(tmp_path / "port_pth" / f"5_net_{suffix}.pth", weights_only=True)
        _assert_same_entries(got, want, ordered=case != "Dynet")


def test_converter_round_trip_of_batch_norm_files(tmp_path):
    cfg = CycleGANConfig(ngf=4, ndf=4, net_g="unet_custom", net_d="pixel", norm="batch",
                         pool_size=2)
    state = create_state(cfg, 3, (32, 32, 32), device="cpu")
    CheckpointManager(tmp_path / "a", "run").save(1, state, also_latest=False)
    port = ["--name", "run", "--which_epoch", "1", "--ngf", "4", "--ndf", "4", "--netG",
            "unet_custom", "--netD", "pixel", "--norm", "batch", "--patch_size", "32", "32",
            "32", "--device", "cpu"]
    port_convert.main(["--from_torch", "--torch_dir", str(tmp_path / "a" / "run"),
                       "--checkpoints_dir", str(tmp_path / "b"), *port])
    raw = CheckpointManager(tmp_path / "b", "run").restore_raw(1)
    for name, net in state.nets.items():
        assert_tree_equal({k: v.detach() for k, v in net.state_dict().items()},
                          raw["nets"][name], name)
    for suffix in ("G_A", "D_B"):
        a = torch.load(tmp_path / "a" / "run" / f"1_net_{suffix}.pth", weights_only=True)
        b = torch.load(tmp_path / "b" / "run" / f"1_net_{suffix}.pth", weights_only=True)
        _assert_same_entries(b, a)
