"""A JAX run's state imported into the port (mra_gan_tpu_torch/checkpoint/
jax_import.py) and the port's checkpoint converter
(``python -m mra_gan_tpu_torch.convert_checkpoint``), on the CPU, against
the JAX package.

Three JAX ``make_train_step`` steps at the port's small step configuration
(16^3, ngf = ndf = 4, a 2-layer PatchGAN) with pool_size 4 at batch 2, so
that the pools fill and swap; the JAX ``CheckpointManager`` saves them, and
``restore_raw``'s numpy tree goes into ``load_jax_state``. At 16^3 the JAX
step keeps its pools in the S2D(4) cell layout, which the import undoes.

- The import is held exactly: parameters, Adam moments and counts, pools
  and step equal the JAX tree after the transposes.
- One more step on each side, with the JAX pool draws injected, is held at
  the step-0 bars of tests/test_torch_port_train_step.py: losses at rtol
  1e-4 (all ten are computed from the imported state), parameters within
  the one-step Adam walk bound (max |diff| <= 2 lr, mean <= 0.15 lr), the
  pools' new images at atol 1e-5 (generator outputs in [-1, 1]).
- The converter round trip (JAX ``--to_torch``, the port's
  ``--from_torch``, the port's ``--to_torch``) gives back JAX's files bit
  for bit.

This file holds the JAX jit of the step (~45 s) on its own, so that
pytest-xdist spreads it beside the other jitted step tests."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from mra_gan_tpu.models.cycle_gan import CycleGANConfig as JaxConfig
from mra_gan_tpu.models.cycle_gan import create_state as jax_create_state
from mra_gan_tpu.models.cycle_gan import make_train_step as jax_make_train_step
from mra_gan_tpu.ops.s2d import depth_to_space as jax_depth_to_space
from mra_gan_tpu_torch import convert_checkpoint as port_convert
from mra_gan_tpu_torch.checkpoint import CheckpointManager, state_dict_from_jax
from mra_gan_tpu_torch.checkpoint.jax_import import (
    depth_to_space,
    load_jax_state,
    pool_images_from_jax,
)
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state, make_train_step

from torch_port_util import (
    STEP_LR,
    STEP_PATCH,
    dead_bias_keys,
    jax_state_dicts,
    jax_step_pool_draws,
    numpy_tree,
    to_ncdhw,
)

REPO = Path(__file__).resolve().parents[1]
COMMON = dict(ngf=4, ndf=4, net_g="resnet_6blocks", net_d="n_layers", n_layers_d=2,
              norm="instance", gan_mode="lsgan", pool_size=4)
BATCH, JAX_STEPS = 2, 3


def _inputs(k: int):
    rs = np.random.RandomState(100 + k)
    return tuple(rs.uniform(-1, 1, (BATCH, *STEP_PATCH, 1)).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(JAX step, JAX state after 3 steps, its restore_raw tree, the
    checkpoints directory the JAX CheckpointManager wrote it to)."""
    jcfg = JaxConfig(**COMMON)
    assert jcfg.uses_cells(STEP_PATCH)
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0), STEP_PATCH)
    jstep = jax.jit(jax_make_train_step(jcfg))
    for k in range(JAX_STEPS):
        a, b = _inputs(k)
        jstate, _ = jstep(jstate, jnp.asarray(a), jnp.asarray(b), jax.random.PRNGKey(k), STEP_LR)
    assert int(jstate.pool_fake_a.count) == 4
    ck = tmp_path_factory.mktemp("jax_ck")
    mgr = JaxCheckpointManager(ck, "run")
    mgr.save(JAX_STEPS, jstate, also_latest=False)
    return jstep, jstate, mgr.restore_raw(JAX_STEPS), ck


def _imported(tree):
    state = create_state(CycleGANConfig(**COMMON, dtype=torch.float32), 5, STEP_PATCH,
                         device="cpu")
    return load_jax_state(state, tree)


def test_import_equals_the_jax_tree(jax_run):
    _, _, tree, _ = jax_run
    state = _imported(tree)
    assert state.step == JAX_STEPS
    want = jax_state_dicts(tree["g_params"], tree["d_params"])
    for name, net in state.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[name][k]), f"{name} {k}"
    for opt_name, names in (("opt_g", ("g_a", "g_b")), ("opt_d", ("d_a", "d_b"))):
        opt = getattr(state, opt_name)
        jt = tree[opt_name]
        for name in names:
            arch = "resnet_6blocks" if name.startswith("g") else "n_layers"
            mu = state_dict_from_jax(numpy_tree(jt["mu"][name]), arch)
            nu = state_dict_from_jax(numpy_tree(jt["nu"][name]), arch)
            dead = dead_bias_keys(state.nets[name])
            for k, p in state.nets[name].named_parameters():
                st = opt.state.get(p, {})
                if k in dead:  # JAX holds zero moments for them, the port none
                    assert not st and not mu[k].any() and not nu[k].any()
                    continue
                assert float(st["step"]) == int(jt["count"]) == JAX_STEPS
                assert torch.equal(st["exp_avg"], mu[k]), f"{opt_name} mu {name} {k}"
                assert torch.equal(st["exp_avg_sq"], nu[k]), f"{opt_name} nu {name} {k}"
    for pool_name in ("pool_fake_a", "pool_fake_b"):
        jp = tree[pool_name]
        assert jp["images"].shape == (4, 4, 4, 4, 64)  # the cell layout
        plain = np.asarray(jax_depth_to_space(jnp.asarray(jp["images"]), 4))
        pool = getattr(state, pool_name)
        assert pool.count == int(jp["count"]) == 4
        np.testing.assert_array_equal(pool.images.numpy(), np.moveaxis(plain, -1, 1))


def test_pool_layouts_and_config_checks():
    rs = np.random.RandomState(0)
    cells = rs.randn(3, 2, 3, 4, 64 * 2).astype(np.float32)
    np.testing.assert_array_equal(depth_to_space(cells),
                                  np.asarray(jax_depth_to_space(jnp.asarray(cells), 4)))
    plain = rs.randn(3, 8, 12, 16, 2).astype(np.float32)
    np.testing.assert_array_equal(pool_images_from_jax(plain, (8, 12, 16), 2).numpy(),
                                  np.moveaxis(plain, -1, 1))
    with pytest.raises(ValueError, match="cell layout"):
        pool_images_from_jax(plain, (8, 12, 12), 2)
    state = create_state(CycleGANConfig(**COMMON), 0, STEP_PATCH, device="cpu")
    with pytest.raises(ValueError, match="config field 'pool_size'"):
        load_jax_state(state, {}, CycleGANConfig(**{**COMMON, "pool_size": 2}))


def test_one_more_step_agrees_with_jax(jax_run):
    jstep, jstate, tree, _ = jax_run
    state = _imported(tree)
    a, b = _inputs(JAX_STEPS)
    rng = jax.random.PRNGKey(JAX_STEPS)
    jnext, want = jstep(jstate, jnp.asarray(a), jnp.asarray(b), rng, STEP_LR)
    want = jax.device_get(want)
    draws = jax_step_pool_draws(rng, BATCH, COMMON["pool_size"])
    assert sum(p > 0.5 for pair in draws.values() for p in pair[0]) > 0  # a swap happens
    _, got = make_train_step(state.cfg)(state, to_ncdhw(a), to_ncdhw(b), STEP_LR,
                                        pool_draws=draws)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(float(got[name]), float(w), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert state.step == int(jnext.step) == JAX_STEPS + 1
    ref = jax_state_dicts(jnext.g_params, jnext.d_params)
    for name, net in state.nets.items():
        dead = dead_bias_keys(net)
        for k, v in net.state_dict().items():
            diff = (v - ref[name][k]).abs()
            if k in dead:
                assert float(diff.max()) == 0.0, f"{name} {k}: a norm-dead bias moved"
                continue
            assert float(diff.max()) <= 2 * STEP_LR * 1.05, f"{name} {k}"
            assert float(diff.mean()) <= 0.15 * STEP_LR, f"{name} {k}"
    for pool_name in ("pool_fake_a", "pool_fake_b"):
        jp = getattr(jnext, pool_name)
        plain = np.asarray(jax_depth_to_space(jp.images, 4))
        pool = getattr(state, pool_name)
        assert pool.count == int(jp.count)
        np.testing.assert_allclose(pool.images.numpy(), np.moveaxis(plain, -1, 1), atol=1e-5)


def _root_convert():
    spec = importlib.util.spec_from_file_location("jax_convert_checkpoint",
                                                  REPO / "convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_converter_round_trip_gives_back_jax_files(jax_run, tmp_path):
    _, _, _, jax_ck = jax_run
    net_flags = ["--which_epoch", str(JAX_STEPS), "--ngf", "4", "--ndf", "4",
                 "--n_layers_D", "2", "--name", "run"]
    _root_convert().main(["--to_torch", "--torch_dir", str(tmp_path / "jax_pth"),
                          "--checkpoints_dir", str(jax_ck), *net_flags])
    port = ["--checkpoints_dir", str(tmp_path / "port_ck"), "--device", "cpu", *net_flags]
    port_convert.main(["--from_torch", "--torch_dir", str(tmp_path / "jax_pth"),
                       "--patch_size", *map(str, STEP_PATCH), "--pool_size", "4", *port])
    raw = CheckpointManager(tmp_path / "port_ck", "run").restore_raw(JAX_STEPS)
    assert raw["step"] == 0 and not raw["opt_g"]["state"]  # fresh Adam moments
    port_convert.main(["--to_torch", "--torch_dir", str(tmp_path / "port_pth"), *port])
    for net in ("G_A", "G_B", "D_A", "D_B"):
        name = f"{JAX_STEPS}_net_{net}.pth"
        want = torch.load(tmp_path / "jax_pth" / name, weights_only=True)
        got = torch.load(tmp_path / "port_pth" / name, weights_only=True)
        assert list(got) == list(want), net
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), f"{net} {k}"
    with pytest.raises(SystemExit, match="missing generator"):
        port_convert.main(["--from_torch", "--torch_dir", str(tmp_path), *port])
    with pytest.raises(SystemExit, match="dropout"):
        port_convert.main(["--from_torch", "--torch_dir", str(tmp_path / "jax_pth"),
                           "--use_dropout", *port])
