"""The port's checkpoints (mra_gan_tpu_torch/checkpoint/manager.py and io.py)
and its dropout, on the CPU.

At the small configuration of the port's step tests (16^3, ngf = ndf = 4, a
2-layer PatchGAN) with pool_size 4 and batch 2, so that the pools fill in
two steps and swap after: exact resume (k + m straight steps against k
steps, save, restore into a state made from another seed, m steps) held
bit for bit, with and without dropout; the round trip of every field; the
``latest`` alias; the restore's refusals of what the state's tensors
cannot take, and the live objective, beta1 and dtype it keeps; the atomic
write; the
reference ``.pth`` files against the JAX package's ``save_torch_network`` on
the same weights, bit for bit; and a port-trained run decoded by the decode
CLI."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.checkpoint import save_torch_network
from mra_gan_tpu.models.networks import define_d
from mra_gan_tpu_torch import test as port_cli
from mra_gan_tpu_torch.checkpoint import (
    CheckpointManager,
    reference_state_dict,
    save_reference_pth,
    state_dict_from_jax,
)
from mra_gan_tpu_torch.checkpoint.manager import state_to_dict
from mra_gan_tpu_torch.data import nifti
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step
from mra_gan_tpu_torch.models.networks import Dropout

from torch_port_util import STEP_LR, STEP_PATCH, jax_generator, random_conv_tree

K_STEPS, M_STEPS, BATCH = 3, 2, 2


def _cfg(dropout: bool = False, **kw) -> CycleGANConfig:
    return CycleGANConfig(ngf=4, ndf=4, n_layers_d=2, pool_size=4, gan_mode="lsgan",
                          no_dropout=not dropout, **kw)


def _batches(n: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    return [tuple(torch.from_numpy(rs.uniform(-1, 1, (BATCH, 1, *STEP_PATCH)).astype(np.float32))
                  for _ in range(2)) for _ in range(n)]


def _run(state, step, batches) -> list:
    return [step(state, a, b, STEP_LR)[1] for a, b in batches]


def _assert_tree_equal(a, b, where: str = "") -> None:
    """Plain containers of tensors, equal bit for bit (and in type)."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), f"{where} differs"
    else:
        assert a == b, where


def _assert_states_equal(s1, s2) -> None:
    """Every field of two states bit for bit: parameters, Adam state
    (moments and step counts), pools, both generators' states, step."""
    _assert_tree_equal(state_to_dict(s1), state_to_dict(s2), "state")


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
def test_exact_resume_is_bit_equal(dropout, tmp_path):
    cfg = _cfg(dropout)
    step = make_train_step(cfg)
    batches = _batches(K_STEPS + M_STEPS)
    straight = create_state(cfg, 0, STEP_PATCH, device="cpu")
    want = _run(straight, step, batches)

    first = create_state(cfg, 0, STEP_PATCH, device="cpu")
    got = _run(first, step, batches[:K_STEPS])
    assert first.pool_fake_a.count == first.pool_fake_b.count == cfg.pool_size
    CheckpointManager(tmp_path, "run").save(K_STEPS, first)
    resumed = CheckpointManager(tmp_path, "run").restore(
        K_STEPS, create_state(cfg, 1, STEP_PATCH, device="cpu"))
    assert resumed.step == K_STEPS
    got += _run(resumed, step, batches[K_STEPS:])

    assert resumed.step == straight.step == K_STEPS + M_STEPS
    for k, (w, g) in enumerate(zip(want, got)):
        _assert_tree_equal(w, g, f"metrics of step {k}")
    _assert_states_equal(straight, resumed)


@pytest.mark.parametrize("which", ["generator", "dropout_generator"])
def test_resume_depends_on_the_saved_generators(which, tmp_path):
    """The control of the exact-resume test: with one of the two saved
    generators reseeded after the restore, the resumed run leaves the
    straight one (the pools swap other images; dropout drops other voxels)."""
    cfg = _cfg(dropout=True)
    step = make_train_step(cfg)
    batches = _batches(K_STEPS + M_STEPS)
    straight = create_state(cfg, 0, STEP_PATCH, device="cpu")
    _run(straight, step, batches)
    first = create_state(cfg, 0, STEP_PATCH, device="cpu")
    _run(first, step, batches[:K_STEPS])
    mgr = CheckpointManager(tmp_path, "run")
    mgr.save(K_STEPS, first)
    resumed = mgr.restore(K_STEPS, create_state(cfg, 1, STEP_PATCH, device="cpu"))
    getattr(resumed, which).manual_seed(12345)
    _run(resumed, step, batches[K_STEPS:])
    assert not torch.equal(straight.g_a.model[1].weight, resumed.g_a.model[1].weight)


def test_round_trip_restores_every_field(tmp_path):
    cfg = _cfg(dropout=True)
    state = create_state(cfg, 0, STEP_PATCH, device="cpu")
    _run(state, make_train_step(cfg), _batches(K_STEPS))
    mgr = CheckpointManager(tmp_path, "run")
    mgr.save("5", state)
    fresh = create_state(cfg, 9, STEP_PATCH, device="cpu")
    assert not torch.equal(fresh.g_a.model[1].weight, state.g_a.model[1].weight)
    assert mgr.restore("5", fresh) is fresh
    _assert_states_equal(state, fresh)
    for opt in (fresh.opt_g, fresh.opt_d):
        for group in opt.param_groups:
            for p in group["params"]:
                for v in opt.state.get(p, {}).values():
                    if v.dim():
                        assert v.stride() == p.stride()
    raw = mgr.restore_raw("5")
    assert raw["config"]["dtype"] == "float32" and raw["patch_shape"] == list(STEP_PATCH)
    assert raw["step"] == K_STEPS and raw["pool_fake_a"]["images"].shape == (4, 1, *STEP_PATCH)


def test_latest_alias_and_also_latest(tmp_path):
    cfg = _cfg()
    mgr = CheckpointManager(tmp_path, "run")
    assert mgr.root == (tmp_path / "run").resolve() and not mgr.has("latest")
    state = create_state(cfg, 0, STEP_PATCH, device="cpu")
    mgr.save(1, state)
    nets = ("G_A", "G_B", "D_A", "D_B")
    assert sorted(os.listdir(mgr.root)) == sorted(
        ["ckpt_1.pt", "ckpt_latest.pt"] + [f"{e}_net_{n}.pth" for e in ("1", "latest")
                                           for n in nets])
    assert mgr.restore_raw("latest")["step"] == 0
    state.step = 2
    mgr.save(2, state, also_latest=False)
    assert mgr.has(2) and mgr.restore_raw("latest")["step"] == 0
    state.step = 3
    mgr.save("latest", state, also_latest=True)
    assert mgr.restore_raw("latest")["step"] == 3
    assert not any("latest_latest" in f or "ckpt_latest_" in f for f in os.listdir(mgr.root))
    with pytest.raises(FileNotFoundError):
        mgr.restore_raw(7)


def _tamper_tensor(path):
    raw = torch.load(path, weights_only=True)
    raw["nets"]["d_b"]["model.0.weight"] = torch.zeros(8, 1, 4, 4, 4)
    torch.save(raw, path)


@pytest.mark.parametrize("case, match", [
    ("config", "config field 'ngf'"),
    ("pool_size", "config field 'pool_size'"),
    ("dropout", "config field 'no_dropout'"),
    ("patch_shape", "patch_shape"),
    ("tensor_shape", r"nets\.d_b\.model\.0\.weight"),
    ("format", "format"),
])
def test_strict_restore_refuses_what_differs(case, match, tmp_path):
    """What the state's tensors cannot take: a network field, the pool
    size, the patch shape, a tensor's shape; and another format."""
    cfg = _cfg()
    state = create_state(cfg, 0, STEP_PATCH, device="cpu")
    _run(state, make_train_step(cfg), _batches(1))
    mgr = CheckpointManager(tmp_path, "run")
    mgr.save(1, state, also_latest=False)
    target_cfg, patch = cfg, STEP_PATCH
    if case == "config":
        target_cfg = dataclasses.replace(cfg, ngf=8)
    elif case == "pool_size":
        target_cfg = dataclasses.replace(cfg, pool_size=3)
    elif case == "dropout":
        target_cfg = _cfg(dropout=True)
    elif case == "patch_shape":
        patch = (32, 32, 32)
    elif case == "tensor_shape":
        _tamper_tensor(mgr.path(1))
    else:
        raw = torch.load(mgr.path(1), weights_only=True)
        raw["format"] = "something else"
        torch.save(raw, mgr.path(1))
    target = create_state(target_cfg, 4, patch, device="cpu")
    before = state_to_dict(target)
    with pytest.raises(ValueError, match=match):
        mgr.restore(1, target)
    _assert_tree_equal(state_to_dict(target), before, "untouched after a refusal")


@pytest.mark.parametrize("field, value", [
    ("gan_mode", "vanilla"), ("lambda_a", 5.0), ("lambda_identity", 0.0),
    ("lambda_co_b", 1.0), ("beta1", 0.9), ("dtype", torch.bfloat16),
    ("init_type", "xavier"),
], ids=["gan_mode", "lambda_a", "lambda_identity", "lambda_co_b", "beta1", "dtype", "init_type"])
def test_restore_keeps_the_live_objective_beta1_and_dtype(field, value, tmp_path):
    """As the JAX driver restores its saved tree into a state made from the
    flags: the networks, Adam moments, pools, generators and step come from
    the file; the objective, beta1 and the compute dtype stay the live
    state's (the pool images cast to its dtype), and its step runs."""
    cfg = _cfg()
    state = create_state(cfg, 0, STEP_PATCH, device="cpu")
    _run(state, make_train_step(cfg), _batches(K_STEPS))
    mgr = CheckpointManager(tmp_path, "run")
    mgr.save(1, state, also_latest=False)
    live_cfg = dataclasses.replace(cfg, **{field: value})
    live = mgr.restore(1, create_state(live_cfg, 4, STEP_PATCH, device="cpu"))
    assert live.cfg == live_cfg and live.step == K_STEPS
    saved, got = state_to_dict(state), state_to_dict(live)
    _assert_tree_equal(got["nets"], saved["nets"], "nets")
    for name in ("opt_g", "opt_d"):
        _assert_tree_equal(got[name]["state"], saved[name]["state"], name)
        assert all(g["betas"] == (live_cfg.beta1, 0.999)
                   for g in getattr(live, name).param_groups)
    for name in ("pool_fake_a", "pool_fake_b"):
        pool = getattr(live, name)
        assert pool.images.dtype == live_cfg.dtype and pool.count == saved[name]["count"]
        assert torch.equal(pool.images, saved[name]["images"].to(live_cfg.dtype))
    _, metrics = make_train_step(live_cfg)(live, *_batches(1, seed=5)[0], STEP_LR)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.parametrize("dropout", [False, True])
def test_dropout_generator_of_another_device_type(dropout, tmp_path):
    """A checkpoint written on another device type (its dropout generator's
    state a CUDA one) loads into a CPU state without dropout, which never
    draws from that generator; with dropout it is refused."""
    cfg = _cfg(dropout=dropout)
    state = create_state(cfg, 0, STEP_PATCH, device="cpu")
    _run(state, make_train_step(cfg), _batches(1))
    mgr = CheckpointManager(tmp_path, "run")
    mgr.save(1, state, also_latest=False)
    raw = mgr.restore_raw(1)
    raw["dropout_generator"] = {"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
    torch.save(raw, mgr.path(1))
    target = create_state(cfg, 4, STEP_PATCH, device="cpu")
    drop_state = target.dropout_generator.get_state()
    if dropout:
        with pytest.raises(ValueError, match="dropout_generator is a cuda generator"):
            mgr.restore(1, target)
        return
    mgr.restore(1, target)
    assert torch.equal(target.dropout_generator.get_state(), drop_state)
    _assert_tree_equal(state_to_dict(target)["nets"], state_to_dict(state)["nets"], "nets")


def test_save_is_atomic_and_leaves_no_temporary_file(tmp_path, monkeypatch):
    cfg = _cfg()
    state = create_state(cfg, 0, STEP_PATCH, device="cpu")
    mgr = CheckpointManager(tmp_path, "run")
    mgr.save(1, state)
    files = sorted(os.listdir(mgr.root))
    assert not any(f.endswith(".tmp") for f in files)
    real_save = torch.save

    class Crash(BaseException):
        pass

    def crash(obj, f, *a, **kw):  # half a file, then the process is interrupted
        real_save(obj, f, *a, **kw)
        f.truncate(100)
        raise Crash

    monkeypatch.setattr(torch, "save", crash)
    state.step = 9
    with pytest.raises(Crash):
        mgr.save(2, state)
    monkeypatch.undo()
    assert sorted(os.listdir(mgr.root)) == files  # no ckpt_2, no temporary left
    assert mgr.restore_raw("latest")["step"] == 0  # the old latest is whole


def _jax_patchgan_tree(seed: int):
    net = define_d(4, "n_layers", 2)
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.zeros((1, 16, 16, 16, 1)), train=False),
                            jax.random.PRNGKey(seed))
    return random_conv_tree(shapes, seed)


@pytest.mark.parametrize("arch, dropout", [("resnet_6blocks", False), ("resnet_6blocks", True),
                                           ("n_layers", False)],
                         ids=["generator", "generator_dropout", "patchgan"])
def test_reference_pth_equals_jax_save_torch_network(arch, dropout, tmp_path):
    if arch == "n_layers":
        tree = _jax_patchgan_tree(3)
        net = CycleGANConfig(ndf=4, n_layers_d=2).build_discriminator("d_a")
    else:
        _, tree = jax_generator(use_dropout=dropout, seed=3)
        net = CycleGANConfig(ngf=4, no_dropout=not dropout).build_generator("g_a")
    net.load_state_dict(state_dict_from_jax(tree, arch, dropout))
    save_torch_network(tree, tmp_path / "jax.pth", arch=arch, use_dropout=dropout)
    save_reference_pth(net, tmp_path / "port.pth", arch, dropout)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    assert list(got) == list(want)
    n_norms = {"n_layers": 2}.get(arch, 17)
    assert sum(k.endswith(".running_var") for k in got) == n_norms
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].is_contiguous(), k
        assert torch.equal(got[k], w), k
    wrong = ("basic", False) if arch == "n_layers" else (arch, not dropout)
    with pytest.raises(ValueError, match="layout"):
        reference_state_dict(net, *wrong)


def test_dropout_draws_from_the_state_generator():
    """Dropout modules sit at conv_block.4 (the second conv keeps .6), draw
    from ``state.dropout_generator``, and are the identity in eval mode."""
    state = create_state(_cfg(dropout=True), 3, STEP_PATCH, device="cpu")
    drops = [m for m in state.g_a.modules() if isinstance(m, Dropout)]
    assert len(drops) == 6 and all(m.generator is state.dropout_generator for m in drops)
    assert "model.10.conv_block.6.weight" in state.g_a.state_dict()
    x = torch.randn(2, 16, 4, 4, 4)
    d = drops[0]
    gen_state = state.dropout_generator.get_state()
    y1 = d(x)
    state.dropout_generator.set_state(gen_state)
    torch.testing.assert_close(d(x), y1, rtol=0, atol=0)
    kept = y1 != 0
    assert 0.35 < float(kept.float().mean()) < 0.65
    torch.testing.assert_close(y1[kept], 2 * x[kept], rtol=0, atol=0)
    assert d.eval()(x) is x


def test_port_trained_run_decodes_through_the_cli(tmp_path):
    cfg = _cfg()
    state = create_state(cfg, 0, STEP_PATCH, device="cpu")
    _run(state, make_train_step(cfg), _batches(2))
    CheckpointManager(tmp_path / "ck", "run").save(2, state)
    rng = np.random.RandomState(1)
    data = (rng.rand(20, 18, 17) * 90 + 5).astype(np.float32)
    nifti.save(nifti.NiftiImage(data=data, affine=np.diag([1.0, 1.0, 2.0, 1.0])),
               tmp_path / "in.nii.gz")
    args = ["--image", str(tmp_path / "in.nii.gz"), "--checkpoints_dir", str(tmp_path / "ck"),
            "--name", "run", "--ngf", "4", "--patch_size", "16", "16", "16",
            "--stride_inplane", "8", "--stride_layer", "8", "--precision", "float32",
            "--device", "cpu"]
    assert port_cli.main(args + ["--result", str(tmp_path / "latest.nii")]) == []
    assert port_cli.main(args + ["--result", str(tmp_path / "two.nii"),
                                 "--which_epoch", "2"]) == []
    got = nifti.load(tmp_path / "latest.nii")
    assert got.data.shape == data.shape and np.all(np.isfinite(got.data))
    np.testing.assert_array_equal(got.data, nifti.load(tmp_path / "two.nii").data)
    # the decode ran the trained generator: the same as the state's own g_a
    opt = port_cli.parse(args + ["--result", str(tmp_path / "x.nii")])
    gen = port_cli.load_generator(opt)
    for k, v in state.g_a.state_dict().items():
        assert torch.equal(gen.net.state_dict()[k], v), k
