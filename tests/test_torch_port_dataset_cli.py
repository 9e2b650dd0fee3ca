"""The port's dataset-organization CLI (python -m
mra_gan_tpu_torch.organize_folder_structure) against the root
organize_folder_structure.py on the CPU: the same files, byte for byte,
without registration; a known affine recovered under 1 voxel with it; CUDA
by default."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mra_gan_tpu_torch import organize_folder_structure as port_cli
from mra_gan_tpu_torch.data import nifti
from mra_gan_tpu_torch.data.registration import apply_transform

from test_torch_port_registration import _blob_volume, _mean_displacement, _true_params

REPO = Path(__file__).resolve().parents[1]
OUT_FILES = [f"{s}/{k}/{j}.nii" for s, js in (("train", (0, 1)), ("test", (0,)))
             for k in ("images", "labels") for j in js]


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_organize",
                                                  REPO / "organize_folder_structure.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_raw(root: Path, pairs) -> None:
    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i, (img, lbl, aff) in enumerate(pairs):
        nifti.save(nifti.NiftiImage(data=img, affine=aff), root / "images" / f"{i}.nii.gz")
        nifti.save(nifti.NiftiImage(data=lbl, affine=aff), root / "labels" / f"{i}.nii")


def test_no_register_output_is_byte_equal_to_the_jax_cli(tmp_path):
    rs = np.random.RandomState(0)
    pairs = []
    for i, shape in enumerate([(12, 10, 8), (9, 11, 7), (10, 10, 10)]):
        aff = np.diag([1.2, 0.9, 2.0, 1.0])
        aff[:3, 3] = [-5.0 + i, 3.0, 7.5]
        pairs.append((rs.rand(*shape).astype(np.float32) * 100,
                      (rs.rand(*shape) > 0.6).astype(np.float32), aff))
    _write_raw(tmp_path / "raw", pairs)
    common = ["--images", str(tmp_path / "raw" / "images"), "--labels",
              str(tmp_path / "raw" / "labels"), "--split", "1", "--resolution", "1.5", "1.5",
              "1.5", "--no-register"]
    _jax_cli().main([*common, "--out", str(tmp_path / "jax")])
    records = port_cli.main([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert [(r["split"], r["j"]) for r in records] == [("train", 0), ("train", 1), ("test", 0)]
    for f in OUT_FILES:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert nifti.load(tmp_path / "port" / "train/images/0.nii").data.shape == (10, 6, 11)


def test_register_recovers_a_known_affine(tmp_path):
    """label 1 is label 0 under a known affine (label0(x) = label1(T(x))) and
    image 1 lies in label 1's frame: both registrations of pair 1 recover T."""
    shape = (32, 32, 32)
    base = _blob_volume(0, shape)
    p_true = _true_params(3.0, np.array([2.0, -1.5, 1.0], np.float32))
    label0 = apply_transform(base, p_true, shape, device="cpu")
    aff = np.diag([1.0, 1.0, 1.0, 1.0])
    pairs = [(np.sqrt(label0 + 1.0), label0, aff), (np.sqrt(base + 1.0), base, aff)]
    _write_raw(tmp_path / "raw", pairs)
    records = port_cli.main(["--images", str(tmp_path / "raw" / "images"), "--labels",
                             str(tmp_path / "raw" / "labels"), "--split", "1", "--out",
                             str(tmp_path / "out"), "--device", "cpu"])
    pair1 = records[1]
    assert (pair1["split"], pair1["j"]) == ("test", 0)
    for which in ("label", "image"):
        err = _mean_displacement(pair1[which], p_true, shape)
        assert err < 1.0, f"{which}: mean displacement error {err:.3f} voxels"
    assert _mean_displacement(records[0]["label"], np.zeros(12, np.float32), shape) < 0.5
    assert pair1["features_s"] > 0 and pair1["levels_s"] > 0 and pair1["resample_s"] > 0
    out = nifti.load(tmp_path / "out" / "test" / "labels" / "0.nii").data
    sl = tuple(slice(s // 4, 3 * s // 4) for s in shape)
    assert np.corrcoef(out[sl].ravel(), label0[sl].ravel())[0, 1] > 0.98


def test_the_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    _write_raw(tmp_path / "raw", [(np.ones((4, 4, 4), np.float32),) * 2 + (np.eye(4),)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main(["--images", str(tmp_path / "raw" / "images"), "--labels",
                       str(tmp_path / "raw" / "labels"), "--split", "0", "--out",
                       str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
