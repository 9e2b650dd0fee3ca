"""The port's on-device augmentation (mra_gan_tpu_torch/data/augment.py)
against the JAX package's (mra_gan_tpu/data/augment.py) on the CPU: the
8-choice policy per sample (torch_port_util.check_augment_policy states the
tolerances; the 13-choice one is in test_torch_port_augment_extended.py),
each op against its JAX function, and the port's own draws."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from mra_gan_tpu.data import augment as jaug
from mra_gan_tpu_torch.data import augment as aug

from torch_port_util import (AUG_INTENSITY_ATOL, AUG_KEY, AUG_KEYS, AUG_RESAMPLING_ATOL,
                             AUG_SHAPE, augment_batch_data, check_augment_policy,
                             jax_augment_draw)


@pytest.fixture(scope="module")
def draws():
    return [jax_augment_draw(k, False) for k in jax.random.split(AUG_KEY, AUG_KEYS)]


def test_the_keys_cover_every_choice():
    keys = jax.random.split(AUG_KEY, AUG_KEYS)
    assert {jax_augment_draw(k, True)[0] for k in keys} == set(range(13))
    assert {jax_augment_draw(k, False)[0] for k in keys} == set(range(8))


@pytest.mark.parametrize("segmentation", [False, True], ids=["both", "segmentation"])
@pytest.mark.parametrize("value_range", [(-1.0, 1.0), None], ids=["range", "per_member"])
def test_policy_matches_jax_per_sample(draws, value_range, segmentation):
    check_augment_policy(draws, value_range, segmentation, extended=False)


def _volume(shape=(16, 18, 20), seed=3):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _t5(x):
    return torch.from_numpy(x)[None, None]


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.5])
def test_blur_matches_jax(sigma):
    x = _volume()
    got = aug.gaussian_blur(_t5(x), sigma)[0, 0].numpy()
    np.testing.assert_allclose(got, np.asarray(jaug.gaussian_blur(jnp.asarray(x), sigma)),
                               rtol=0, atol=2 * AUG_INTENSITY_ATOL)


@pytest.mark.parametrize("angles", [(0.3, -0.5, 1.2), (0.0, 0.0, -2.9), (-0.61, 0.4, 0.05)])
def test_rotation_matches_jax(angles):
    x = _volume()
    want = np.asarray(jaug.rotate3d(jnp.asarray(x), jnp.asarray(angles, jnp.float32)))
    got = aug.rotate3d(_t5(x), angles)[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * AUG_RESAMPLING_ATOL)


def test_noise_bspline_translate_flip_match_jax():
    x = _volume()
    key = jax.random.PRNGKey(7)
    field = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    np.testing.assert_allclose(
        aug.add_gaussian_noise(torch.from_numpy(x), torch.from_numpy(field), 0.01, 0.02).numpy(),
        np.asarray(jaug.add_gaussian_noise(jnp.asarray(x), key, 0.01, 0.02)),
        rtol=0, atol=2 * AUG_INTENSITY_ATOL)
    disp = np.asarray(jax.random.uniform(key, (3, 10, 10, 10), minval=0.0, maxval=10.0))
    np.testing.assert_allclose(
        aug.bspline_deform(_t5(x), torch.from_numpy(disp))[0, 0].numpy(),
        np.asarray(jaug.bspline_deform(jnp.asarray(x), key)), rtol=0, atol=2 * AUG_RESAMPLING_ATOL)
    shift = np.asarray(jax.random.randint(key, (2,), -40, 40)).tolist()
    for s in (shift, [3, -5], [-2, 0]):
        want = np.asarray(jax.scipy.ndimage.map_coordinates(
            jnp.asarray(x), list(np.meshgrid(*[np.arange(n, dtype=np.float32) for n in x.shape],
                                             indexing="ij")
                                 - np.array([s[0], s[1], 0], np.float32)[:, None, None, None]),
            order=1, mode="nearest"))
        np.testing.assert_array_equal(aug.translate3d(_t5(x), s)[0, 0].numpy(), want)
    np.testing.assert_array_equal(aug.translate3d(_t5(x), shift)[0, 0].numpy(),
                                  np.asarray(jaug.translate3d(jnp.asarray(x), key)))
    axis = int(jax.random.randint(key, (), 0, 2))
    np.testing.assert_array_equal(aug.flip3d(_t5(x), axis)[0, 0].numpy(),
                                  np.asarray(jaug.flip3d(jnp.asarray(x), key)))


def test_choice_frequencies_pass_chi_square():
    for extended, n in ((False, 8), (True, 13)):
        gen, dev_gen = aug.step_generators(5, 1, 0, "cpu")
        draws = aug.draw_batch(2600, (4, 4, 4), gen, dev_gen, extended=extended)
        counts = np.bincount([c for c, _ in draws], minlength=n)
        assert len(counts) == n
        assert stats.chisquare(counts).pvalue > 1e-3, counts


def test_drawn_scalars_lie_in_the_reference_ranges():
    gen, dev_gen = aug.step_generators(9, 3, 7, "cpu")
    draws = aug.draw_batch(1500, (12, 12, 12), gen, dev_gen, extended=True)
    seen = set()
    for choice, p in draws:
        name = aug.BRANCHES[choice]
        seen.add(name)
        if name == "noise":
            assert 0 <= p["mean"] < 1 and 0 <= p["std"] < 2
            assert p["noise"].shape == (12, 12, 12) and abs(float(p["noise"].std()) - 1) < 0.2
        elif name == "blur":
            assert 0 <= p["sigma"] < 1.5
        elif name in ("rotate", "rotate_z", "rotate_x", "rotate_y"):
            deg = [a * 180 / math.pi for a in p["angles"]]
            assert all(abs(d - round(d)) < 1e-9 for d in deg)
            lim = {"rotate": [(-40, 40), (-40, 40), (-180, 180)],
                   "rotate_z": [(0, 1), (0, 1), (-180, 180)],
                   "rotate_x": [(-40, 40), (0, 1), (0, 1)],
                   "rotate_y": [(0, 1), (-40, 40), (0, 1)]}[name]
            assert all(lo <= round(d) < hi for d, (lo, hi) in zip(deg, lim)), (name, deg)
        elif name == "bspline":
            assert p["disp"].shape == (3, 10, 10, 10)
            assert 0 <= float(p["disp"].min()) and float(p["disp"].max()) < 10
        elif name == "flip":
            assert p["axis"] in (0, 1)
        elif name in ("brightness", "contrast"):
            assert -20 <= p["c"] < 20
        elif name == "translate":
            assert all(-40 <= s < 40 for s in p["shift"])
        elif name == "imadjust":
            assert 1 <= p["gamma"] < 2
    assert seen == set(aug.BRANCHES)


def test_the_same_step_key_draws_the_same():
    def draws(seed, epoch, step):
        return aug.draw_batch(16, (12, 12, 12), *aug.step_generators(seed, epoch, step, "cpu"),
                              extended=True)

    def flat(ds):
        return [(c, {k: (v.tolist() if torch.is_tensor(v) else v) for k, v in p.items()})
                for c, p in ds]

    assert flat(draws(0, 2, 5)) == flat(draws(0, 2, 5))
    assert flat(draws(0, 2, 5)) != flat(draws(0, 2, 6))
    assert flat(draws(0, 2, 5)) != flat(draws(0, 3, 5))
    assert flat(draws(0, 2, 5)) != flat(draws(1, 2, 5))


def test_augment_batch_is_the_apply_of_its_draws():
    img, lbl = augment_batch_data(4, zscored=False)
    a, b = torch.from_numpy(img[:6, None]), torch.from_numpy(lbl[:6, None])
    out_a, out_b = aug.augment_batch(a, b, aug.step_generators(0, 1, 2, "cpu"), (-1.0, 1.0))
    draws = aug.draw_batch(6, AUG_SHAPE, *aug.step_generators(0, 1, 2, "cpu"))
    ref_a, ref_b = aug.apply_batch(a, b, draws, (-1.0, 1.0))
    assert out_a.shape == a.shape and out_b.shape == b.shape
    assert torch.equal(out_a, ref_a) and torch.equal(out_b, ref_b)
