"""The port's affine registration (mra_gan_tpu_torch/data/registration.py)
against the JAX package's (mra_gan_tpu/data/registration.py) on the CPU:
each piece on the same inputs, a pyramid level fed JAX's own sample indices,
the resampling, and known-transform recovery with the port's own draws at
tests/test_registration.py's bars. Tolerances: 1e-5 relative for the voxel
map and the MI (float32 in another summation order), 1e-5 absolute on unit
data for the sampling, 2e-5 on the parameters and relative on the losses
after 20 Adam steps (measured: 1.6e-6, the float32 differences of the
gradient carried through the optimiser)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.data import registration as jreg
from mra_gan_tpu_torch.data import registration as reg

torch.set_num_threads(2)

SHAPE = (32, 32, 32)


def _blob_volume(seed: int = 0, shape=SHAPE) -> np.ndarray:
    """tests/test_registration.py's smooth structured volume."""
    from scipy import ndimage as ndi

    rs = np.random.RandomState(seed)
    vol = ndi.gaussian_filter(rs.rand(*shape).astype(np.float32), 3.0)
    ii, jj, kk = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    for _ in range(5):
        c = rs.uniform(8, 24, 3) * np.asarray(shape) / 32.0
        r2 = (ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2
        vol += rs.uniform(0.5, 1.5) * np.exp(-r2 / rs.uniform(8, 30))
    return vol


def _true_params(angle_deg: float, t) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                   np.float32)
    p = np.zeros(12, np.float32)
    p[:9] = (rot - np.eye(3)).ravel()
    p[9:12] = t
    return p


def _mean_displacement(p_est, p_true, shape=SHAPE) -> float:
    """Mean |T_est(x) - T_true(x)| over the central half of the grid."""
    c = np.array([(s - 1) / 2.0 for s in shape], np.float32)
    axes = [np.arange(s // 4, 3 * s // 4, dtype=np.float32) for s in shape]
    pts = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")])
    d_a = (p_est[:9] - p_true[:9]).reshape(3, 3)
    d_t = (p_est[9:12] - p_true[9:12])[:, None]
    return float(np.mean(np.linalg.norm(d_a @ (pts - c[:, None]) + d_t, axis=0)))


@pytest.mark.parametrize("n_params", [6, 12], ids=["rigid", "affine"])
def test_transform_grid_matches_jax(n_params):
    shape = (5, 6, 7)
    p = np.random.RandomState(n_params).uniform(-0.3, 0.3, n_params).astype(np.float32)
    p[-3:] *= 10
    center = [(s - 1) / 2.0 for s in shape]
    want = np.asarray(jreg._transform_grid(shape, jnp.asarray(p), jnp.asarray(center)))
    got = reg.transform_grid(shape, torch.from_numpy(p), center).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_trilinear_sample_matches_jax_inside_and_outside():
    rs = np.random.RandomState(1)
    vol = rs.rand(6, 7, 8).astype(np.float32)
    # points inside, on the faces, within one voxel outside and far outside
    coords = rs.uniform(-2.0, 10.0, (3, 500)).astype(np.float32)
    coords[:, :8] = [[0, 5, -0.5, 5.5, 2, 2, -3, 0.25], [0, 6, 3, 3, -0.75, 6.5, 1, 6],
                     [0, 7, 4, 4, 4, 7.25, 1, 7]]
    want = np.asarray(jreg._trilinear_sample(jnp.asarray(vol), jnp.asarray(coords)))
    got = reg.trilinear_sample(torch.from_numpy(vol), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (want[(coords < -1).any(0) | (coords > 9).any(0)] == 0).all()


def test_soft_mi_normalize_sobel_and_init_match_jax():
    rs = np.random.RandomState(2)
    a, b = rs.rand(4096).astype(np.float32), rs.rand(4096).astype(np.float32) ** 2
    for x, y in ((a, b), (a, a), (a, 1 - a)):
        np.testing.assert_allclose(
            float(reg.soft_mutual_information(torch.from_numpy(x), torch.from_numpy(y))),
            float(jreg.soft_mutual_information(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)
    v = rs.randn(7, 8, 9).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(reg.normalize01(torch.from_numpy(v)).numpy(),
                               np.asarray(jreg._normalize01(jnp.asarray(v))), rtol=0, atol=1e-6)
    vol = _blob_volume(4, (16, 16, 16))
    np.testing.assert_array_equal(reg.sobel_magnitude(vol), jreg.sobel_magnitude(vol))
    moved = np.roll(vol, (2, -1, 3), (0, 1, 2))
    np.testing.assert_array_equal(reg.center_of_mass_init(vol, moved),
                                  jreg.center_of_mass_init(vol, moved))


@pytest.mark.parametrize("n_params", [6, 12], ids=["rigid", "affine"])
def test_register_level_on_jax_indices_matches_jax(n_params):
    shape, n_iters, seed, lr = (16, 16, 16), 20, 3, 0.05
    moving = _blob_volume(5, shape)
    p_true = _true_params(4.0, np.array([1.0, -1.5, 0.5], np.float32))
    fixed = jreg.apply_transform(moving, p_true, shape)
    ff, mf = jreg.sobel_magnitude(fixed), jreg.sobel_magnitude(moving)
    p0 = np.zeros(n_params, np.float32)
    p0[-3:] = [0.3, -0.2, 0.1]
    want, want_losses = jreg._register_level(jnp.asarray(ff), jnp.asarray(mf), jnp.asarray(p0),
                                             lr, shape, n_iters=n_iters, seed=seed)
    n_total = int(np.prod(shape))
    n_sample = max(1024, int(n_total * 0.1))
    idx = np.stack([np.asarray(jax.random.randint(k, (n_sample,), 0, n_total))
                    for k in jax.random.split(jax.random.PRNGKey(seed), n_iters)])
    got, losses = reg.register_level(torch.from_numpy(ff), torch.from_numpy(mf),
                                     torch.from_numpy(p0), lr, n_iters=n_iters, seed=seed,
                                     indices=torch.from_numpy(idx).long())
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    assert np.abs(np.asarray(want) - p0).max() > 0.05  # the level moved


@pytest.mark.parametrize("interpolation", ["nearest", "linear", "bspline"])
def test_apply_transform_matches_jax(interpolation):
    moving = _blob_volume(6, (12, 14, 16))
    p = _true_params(7.0, np.array([1.5, -2.0, 0.7], np.float32))
    p[:9] += np.random.RandomState(0).uniform(-0.02, 0.02, 9).astype(np.float32)
    out_shape = (13, 12, 15)
    want = jreg.apply_transform(moving, p, out_shape, interpolation)
    got = reg.apply_transform(moving, p, out_shape, interpolation, device="cpu")
    assert got.shape == out_shape and got.dtype == np.float32
    assert (want == 0).sum() > 0  # points outside the volume take 0
    if interpolation == "nearest":  # a coordinate at .5 may round either way
        assert np.mean(got != want) < 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.ptp(moving)))


def test_known_transform_recovery():
    """tests/test_registration.py's bars with the port's own draws: a 3-degree
    rotation and a ~2-voxel shift recovered under 1 voxel, and the resampled
    moving image correlating above 0.98 with the fixed one."""
    moving = _blob_volume()
    p_true = _true_params(3.0, np.array([2.0, -1.5, 1.0], np.float32))
    fixed = reg.apply_transform(moving, p_true, SHAPE, device="cpu")
    times = {}
    p_est = reg.register_affine(fixed, moving, iters_per_level=100, device="cpu", times=times)
    err = _mean_displacement(p_est, p_true)
    assert err < 1.0, f"mean displacement error {err:.3f} voxels"
    realigned = reg.apply_transform(moving, p_est, SHAPE, device="cpu")
    sl = tuple(slice(s // 4, 3 * s // 4) for s in SHAPE)
    r = np.corrcoef(realigned[sl].ravel(), fixed[sl].ravel())[0, 1]
    assert r > 0.98, f"post-registration correlation {r:.4f}"
    assert times["features_s"] > 0 and times["levels_s"] > 0


def test_pure_translation_recovery_intensity_mode():
    moving = _blob_volume(seed=3)
    p_true = _true_params(0.0, np.array([-2.0, 1.0, 2.5], np.float32))
    fixed = reg.apply_transform(moving, p_true, SHAPE, device="cpu")
    p_est = reg.register_affine(fixed, moving, iters_per_level=100,
                                use_gradient_features=False, device="cpu")
    assert _mean_displacement(p_est, p_true) < 1.0


def test_rigid_mode_recovers_a_rotation():
    moving = _blob_volume(seed=1)
    p_true = _true_params(3.0, np.array([1.0, 0.5, -1.0], np.float32))
    fixed = reg.apply_transform(moving, p_true, SHAPE, device="cpu")
    p6 = reg.register_affine(fixed, moving, mode="rigid", iters_per_level=100, device="cpu")
    assert p6.shape == (6,)
    a, t = reg.affine_matrix(torch.from_numpy(p6))
    p12 = np.concatenate([(a.numpy() - np.eye(3)).ravel(), t.numpy()]).astype(np.float32)
    assert _mean_displacement(p12, p_true) < 1.0


def test_center_of_mass_init_translation():
    ii, jj, kk = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE], indexing="ij")

    def blob(c):
        r2 = (ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2
        return np.exp(-r2 / 12.0).astype(np.float32)

    p = reg.center_of_mass_init(blob((19, 16, 14)), blob((16, 16, 16)))
    np.testing.assert_allclose(p[9:12], [-3.0, 0.0, 2.0], atol=0.25)


def test_the_levels_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    vol = _blob_volume(0, (8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.register_affine(vol, vol, iters_per_level=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.apply_transform(vol, np.zeros(12, np.float32), (8, 8, 8))
