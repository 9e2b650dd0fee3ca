"""The rest of the legacy chain's transforms in the port
(mra_gan_tpu_torch/data/transforms.py) against the JAX package's: each of
the nine bit-equal on the same seeded inputs, ``confidence_crop`` with the
same np.random.Generator."""
import numpy as np
import pytest

from mra_gan_tpu.data import transforms as jt
from mra_gan_tpu.data.nifti import NiftiImage as JaxNiftiImage
from mra_gan_tpu_torch.data import transforms as pt
from mra_gan_tpu_torch.data.nifti import NiftiImage


def _volume(seed, shape=(14, 12, 10), sparse=False):
    rs = np.random.RandomState(seed)
    x = (rs.rand(*shape) * 90 - 20).astype(np.float32)
    if sparse:
        x[x < 50] = 0.0
    return x


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    ("statistical_normalize", {}), ("statistical_normalize", {"sigma": 1.0}),
    ("manual_normalize", {"window_min": -5.0, "window_max": 40.0}),
    ("manual_normalize", {"window_min": 3.0, "window_max": 3.0}),
    ("adaptive_equalize", {}), ("adaptive_equalize", {"alpha": 0.3, "tiles": 2}),
    ("adaptive_equalize_itk", {"radius": 1}), ("adaptive_equalize_itk",
                                               {"alpha": 0.0, "beta": 0.0, "radius": 2}),
    ("invert_intensity", {}), ("laplacian_sharpen", {}), ("laplacian_sharpen", {"sigma": 2.0}),
], ids=lambda c: f"{c[0]}-{'-'.join(map(str, c[1].values())) or 'default'}")
def test_intensity_transforms_bit_equal(case):
    name, kw = case
    x = _volume(len(name))
    _equal(getattr(pt, name)(x, **kw), getattr(jt, name)(x, **kw))


def test_constant_volumes_bit_equal():
    x = np.full((6, 6, 6), 7.0, np.float32)
    for name in ("statistical_normalize", "adaptive_equalize", "adaptive_equalize_itk",
                 "invert_intensity", "laplacian_sharpen"):
        _equal(getattr(pt, name)(x), getattr(jt, name)(x))


def test_align_to_stamps_the_reference_affine():
    ref_aff = np.array([[0.0, -1.2, 0.0, 10.0], [1.2, 0.0, 0.0, -4.0],
                        [0.0, 0.0, 1.5, 3.0], [0, 0, 0, 1.0]])
    x = _volume(3)
    got = pt.align_to(NiftiImage(data=x, affine=np.eye(4), descrip=b"img"),
                      NiftiImage(data=x[:2], affine=ref_aff))
    want = jt.align_to(JaxNiftiImage(data=x, affine=np.eye(4), descrip=b"img"),
                       JaxNiftiImage(data=x[:2], affine=ref_aff))
    assert got.data is x and got.descrip == want.descrip == b"img"
    _equal(got.affine, want.affine)


@pytest.mark.parametrize("shape, patch", [((20, 18, 16), (8, 8, 8)), ((6, 9, 5), (8, 8, 8))])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_crop_background_bit_equal(shape, patch, sparse):
    img, lbl = _volume(5, shape, sparse), _volume(6, shape)
    for threshold in (0.0, 60.0, 1e9):
        for got, want in zip(pt.crop_background(img, lbl, patch, threshold),
                             jt.crop_background(img, lbl, patch, threshold)):
            _equal(got, want)


@pytest.mark.parametrize("shape, patch", [((20, 18, 16), (8, 8, 8)), ((6, 9, 5), (8, 8, 8))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confidence_crop_bit_equal_with_the_same_generator(shape, patch, seed):
    img, lbl = _volume(seed, shape), _volume(seed + 10, shape, sparse=True)
    for label in (lbl, np.zeros_like(lbl)):
        got = pt.confidence_crop(img, label, patch, np.random.default_rng(seed))
        want = jt.confidence_crop(img, label, patch, np.random.default_rng(seed))
        for g, w in zip(got, want):
            _equal(g, w)
