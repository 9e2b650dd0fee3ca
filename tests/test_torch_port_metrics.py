"""The port's image-quality metrics (mra_gan_tpu_torch/utils/metrics.py) and
its evaluation CLI (``python -m mra_gan_tpu_torch.evaluate``) against the
JAX package's, in float32 on seeded volumes.

Bars: each metric within rtol 1e-5 of the JAX one, SSIM within 1e-4 (its
box filters sum in another order), both far below what the metrics' own
float32 arithmetic can resolve between two decodes."""
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.utils import metrics as jm
from mra_gan_tpu_torch import evaluate as port_eval
from mra_gan_tpu_torch.data import nifti
from mra_gan_tpu_torch.utils import metrics as pm

REPO = Path(__file__).resolve().parents[1]
RTOL = {"mae": 1e-5, "mse": 1e-5, "psnr": 1e-5, "pearson_r": 1e-5, "ssim": 1e-4}


def _pair(seed, shape=(18, 20, 16)):
    rs = np.random.RandomState(seed)
    a = (rs.rand(*shape) * 200).astype(np.float32)
    b = np.clip(a + rs.randn(*shape).astype(np.float32) * 15, -50, 250).astype(np.float32)
    b[b < 60] = 0.0  # a zero background for --mask-fg
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["mae", "mse", "psnr", "pearson_r", "ssim3d"])
def test_metric_matches_jax(name, seed):
    a, b = _pair(seed)
    got = float(getattr(pm, name)(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)))
    assert got == pytest.approx(want, rel=RTOL.get(name, RTOL["ssim"]))


def test_metrics_with_a_data_range_match_jax():
    a, b = _pair(2)
    for name in ("psnr", "ssim3d"):
        got = float(getattr(pm, name)(a, b, data_range=255.0))
        want = float(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b), data_range=255.0))
        assert got == pytest.approx(want, rel=RTOL.get(name, RTOL["ssim"])), name
    assert float(pm.ssim3d(a, b, win=5)) == pytest.approx(
        float(jm.ssim3d(jnp.asarray(a), jnp.asarray(b), win=5)), rel=RTOL["ssim"])


@pytest.mark.parametrize("use_mask", [False, True])
def test_volume_metrics_match_jax(use_mask):
    a, b = _pair(3)
    mask = b > 0
    got = pm.volume_metrics(torch.from_numpy(a), torch.from_numpy(b),
                            mask=torch.from_numpy(mask) if use_mask else None,
                            use_mask=use_mask)
    want = jm.volume_metrics(jnp.asarray(a), jnp.asarray(b),
                             mask=jnp.asarray(mask) if use_mask else None, use_mask=use_mask)
    assert set(got) == set(want) == {"ssim", "psnr", "mae", "pearson_r"}
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL[k]), k
    if use_mask:  # the weighted forms equal the boolean-indexed metrics
        assert float(got["mae"]) == pytest.approx(float(pm.mae(a[mask], b[mask])), rel=1e-5)


def _jax_eval():
    spec = importlib.util.spec_from_file_location("jax_evaluate_cli", REPO / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "file":
            assert got[k] == v
        else:
            assert got[k] == pytest.approx(v, rel=RTOL[k]), k


@pytest.mark.parametrize("mask_fg", [False, True])
def test_evaluate_cli_matches_the_jax_cli(tmp_path, capsys, mask_fg):
    preds, targs = tmp_path / "pred", tmp_path / "targ"
    preds.mkdir()
    targs.mkdir()
    for i in range(3):
        a, b = _pair(10 + i)
        nifti.save(nifti.NiftiImage(data=a, affine=np.eye(4)), preds / f"v{i}.nii.gz")
        nifti.save(nifti.NiftiImage(data=b, affine=np.eye(4)), targs / f"v{i}.nii")
    # a prediction on another grid is resampled onto its target's
    a, _ = _pair(13, (9, 10, 8))
    nifti.save(nifti.NiftiImage(data=a, affine=np.diag([2.0, 2.0, 2.0, 1.0])),
               preds / "v3.nii")
    nifti.save(nifti.NiftiImage(data=_pair(14)[1], affine=np.eye(4)), targs / "v3.nii")
    nifti.save(nifti.NiftiImage(data=a, affine=np.eye(4)), preds / "orphan.nii")
    flags = ["--mask-fg"] if mask_fg else []
    capsys.readouterr()
    want_mean = _jax_eval().main(["--pred", str(preds), "--target", str(targs), *flags])
    want = capsys.readouterr()
    got_mean = port_eval.main(["--pred", str(preds), "--target", str(targs), *flags,
                               "--device", "cpu"])
    got = capsys.readouterr()
    assert len(_lines(got.out)) == len(_lines(want.out)) == 5
    for g, w in zip(_lines(got.out), _lines(want.out)):
        _close(g, w)
    _close(got_mean, want_mean)
    assert "orphan" in got.err and "excluded from the mean" in got.err
    single = port_eval.main(["--pred", str(preds / "v0.nii.gz"), "--target",
                             str(targs / "v0.nii"), *flags, "--device", "cpu"])
    _close(single, {k: v for k, v in _lines(want.out)[0].items() if k != "file"})
