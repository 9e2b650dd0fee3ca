"""What the port's training driver hands its step, against the JAX driver
(the root train.py): with the step replaced by a recorder in both, the
(real_a, real_b, lr) stream of every step of every epoch is bit-equal, and
so are the --dump_patches files."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mra_gan_tpu.data import native as jax_native
from mra_gan_tpu_torch import train as port_train
from mra_gan_tpu_torch.data import nifti

from torch_port_util import write_train_data

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--patch_size", "16", "16", "16", "--ngf", "4", "--ndf", "4", "--n_layers_D", "1",
         "--precision", "float32", "--pool_size", "2", "--no_mem_check"]


def _jax_train_module():
    spec = importlib.util.spec_from_file_location("jax_train_cli", REPO / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _JaxWithoutJit:
    """The jax module with jit the identity, for the JAX driver's
    ``jax.jit(make_train_step(cfg), donate_argnums=0)`` of a recorder."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        return fn


@pytest.mark.parametrize("pipeline, extra", [
    ("monai", ["--batch_size", "2", "--workers", "2", "--niter", "2", "--niter_decay", "1"]),
    ("legacy", ["--batch_size", "1", "--workers", "0", "--niter", "1", "--niter_decay", "1",
                "--which_direction", "BtoA", "--lr_policy", "cosine", "--seed", "3"]),
], ids=["monai-b2-w2-lambda", "legacy-b1-w0-BtoA-cosine"])
def test_step_stream_bit_equal_to_the_jax_driver(tmp_path, monkeypatch, pipeline, extra):
    data = write_train_data(tmp_path / "data", n=3)
    jax_train = _jax_train_module()
    monkeypatch.setattr(jax_native, "available", lambda: False)
    streams = {"jax": [], "port": []}

    def jax_step(cfg):
        def step(state, a, b, rng, lr):
            streams["jax"].append((np.asarray(a), np.asarray(b), lr))
            return state, {"G_A": jnp.zeros((), jnp.float32)}
        return step

    def port_step(cfg):
        def step(state, a, b, lr):
            streams["port"].append((np.moveaxis(a.numpy(), 1, -1), np.moveaxis(b.numpy(), 1, -1),
                                    lr))
            return state, {"G_A": a.new_zeros(())}
        return step

    monkeypatch.setattr(jax_train, "make_train_step", jax_step)
    monkeypatch.setattr(jax_train, "jax", _JaxWithoutJit())
    monkeypatch.setattr(port_train, "make_train_step", port_step)
    common = ["--data_path", str(data), "--pipeline", pipeline, *SMALL, *extra,
              "--save_epoch_freq", "100", "--dump_patches", "3", "--print_freq", "2"]
    jax_train.main(["--checkpoints_dir", str(tmp_path / "jax"), *common])
    port_train.main(["--checkpoints_dir", str(tmp_path / "port"), *common, "--device", "cpu"])

    assert len(streams["port"]) == len(streams["jax"]) >= 6
    lrs = []
    for (pa, pb, plr), (ja, jb, jlr) in zip(streams["port"], streams["jax"]):
        assert pa.shape == ja.shape and pa.dtype == ja.dtype == np.float32
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pb, jb)
        assert plr == jlr
        lrs.append(plr)
    assert len(set(lrs)) >= 2  # the schedule moved
    dumps = sorted(p.name for p in (tmp_path / "port/experiment_name/patch_dumps").iterdir())
    assert dumps == sorted(p.name for p in (tmp_path / "jax/experiment_name/patch_dumps")
                           .iterdir())
    assert len(dumps) == 6
    for name in dumps:
        np.testing.assert_array_equal(
            nifti.load(tmp_path / "port/experiment_name/patch_dumps" / name).data,
            nifti.load(tmp_path / "jax/experiment_name/patch_dumps" / name).data)
