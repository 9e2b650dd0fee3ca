"""The port's copies of the training transforms (mra_gan_tpu_torch/data/
transforms.py) against the JAX package's: each bit-equal on the same seeded
inputs and the same np.random.Generator."""
import numpy as np
import pytest

from mra_gan_tpu.data import transforms as jt
from mra_gan_tpu_torch.data import transforms as pt
from mra_gan_tpu_torch.data.nifti import NiftiImage
from mra_gan_tpu.data.nifti import NiftiImage as JaxNiftiImage

AFFINES = [
    np.eye(4),
    np.diag([-1.0, 1.0, 2.0, 1.0]),
    np.array([[0.0, -1.2, 0.0, 10.0], [1.2, 0.0, 0.0, -4.0], [0.0, 0.0, -1.5, 3.0],
              [0, 0, 0, 1.0]]),
    np.array([[0.1, 0.0, -0.9, 1.0], [-1.1, 0.05, 0.0, 2.0], [0.0, 1.3, 0.1, 3.0],
              [0, 0, 0, 1.0]]),
]


def _gen(seed):
    return np.random.Generator(np.random.Philox(key=seed, counter=[1, 2, 0, 0]))


def _volume(seed, shape=(20, 22, 18), sparse=False):
    rs = np.random.RandomState(seed)
    x = (rs.rand(*shape) * 90 - 20).astype(np.float32)
    if sparse:
        x[x < 50] = 0.0
    return x


@pytest.mark.parametrize("k", range(len(AFFINES)))
def test_orientation_and_to_ras_bit_equal(k):
    aff = AFFINES[k]
    assert pt.orientation_codes(aff) == jt.orientation_codes(aff)
    data = _volume(k)
    got = pt.to_ras(NiftiImage(data=data, affine=aff))
    want = jt.to_ras(JaxNiftiImage(data=data, affine=aff))
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine, want.affine)
    assert got.data.flags.c_contiguous


@pytest.mark.parametrize("nonzero", [False, True])
def test_zscore_bit_equal(nonzero):
    x = _volume(3, sparse=True)
    np.testing.assert_array_equal(pt.zscore_normalize(x, nonzero),
                                  jt.zscore_normalize(x, nonzero))


@pytest.mark.parametrize("threshold, margin, empty", [
    (0.0, 0, False), (10.0, 2, False), (0.0, 0, True)])
def test_crop_foreground_bit_equal(threshold, margin, empty):
    img = np.zeros((20, 22, 18), np.float32)
    if not empty:
        img[4:13, 7:19, 2:9] = _volume(5, (9, 12, 7))
    lbl = _volume(6)
    gi, gl, gs = pt.crop_foreground(img, lbl, threshold, margin)
    wi, wl, ws = jt.crop_foreground(img, lbl, threshold, margin)
    assert gs == ws
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)


def test_counted_mask_is_argwhere():
    mask = _volume(7) > 40
    got, want = pt._CountedMask(mask), jt._CountedMask(mask)
    assert got.count == want.count == int(mask.sum())
    every = np.argwhere(mask)
    for r in list(range(0, got.count, 37)) + [got.count - 1]:
        assert got.nth_true(r) == want.nth_true(r) == tuple(int(v) for v in every[r])


@pytest.mark.parametrize("case", ["pos", "pos_neg", "empty_label", "small_volume"])
def test_rand_crop_by_pos_neg_bit_equal(case):
    img, lbl = _volume(8), _volume(9, sparse=True)
    kw = dict(num_samples=5, pos=20.0, neg=0.0, image_threshold=-1.0)
    if case == "pos_neg":
        kw.update(pos=1.0, neg=1.0, image_threshold=10.0)
    elif case == "empty_label":
        lbl = np.zeros_like(lbl)
    elif case == "small_volume":
        img, lbl = img[:6, :9, :5], lbl[:6, :9, :5]
    patch = (8, 8, 8)
    gi, gl, gs = pt.rand_crop_starts_by_pos_neg(img, lbl, patch, _gen(1), **kw)
    wi, wl, ws = jt.rand_crop_starts_by_pos_neg(img, lbl, patch, _gen(1), **kw)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    got = pt.rand_crop_by_pos_neg(img, lbl, patch, _gen(2), **kw)
    want = jt.rand_crop_by_pos_neg(img, lbl, patch, _gen(2), **kw)
    assert len(got) == len(want) == 5
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("drop_ratio, min_pixel", [(0.0, 1), (0.0, 200), (0.3, 400)])
def test_random_crop_bit_equal(drop_ratio, min_pixel):
    img, lbl = _volume(10), _volume(11, sparse=True)
    img, lbl = pt.pad_to_size(img, (8, 8, 8), where="end"), pt.pad_to_size(lbl, (8, 8, 8),
                                                                              where="end")
    g, w = _gen(3), _gen(3)
    for _ in range(6):
        np.testing.assert_array_equal(
            pt.random_crop_start(img, lbl, (8, 8, 8), g, drop_ratio, min_pixel),
            jt.random_crop_start(img, lbl, (8, 8, 8), w, drop_ratio, min_pixel))
    gi, gl = pt.random_crop(img[:6], lbl[:6], (8, 8, 8), _gen(4), drop_ratio, min_pixel)
    wi, wl = jt.random_crop(img[:6], lbl[:6], (8, 8, 8), _gen(4), drop_ratio, min_pixel)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
