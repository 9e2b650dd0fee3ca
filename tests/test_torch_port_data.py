"""The port's training data pipeline (mra_gan_tpu_torch/data/dataset.py)
against the JAX package's: for the same seed, every epoch's batches bit-equal
to the JAX PatchLoader's, for both pipelines, both directions, inline and
threaded workers, on a cold and then a warm disk cache; and the cache
writer's pending-before-disk read and flush."""
import numpy as np
import pytest

from mra_gan_tpu.data import dataset as jax_dataset
from mra_gan_tpu.data import native as jax_native
from mra_gan_tpu_torch.data import dataset as port_dataset
from mra_gan_tpu_torch.data import nifti

# several orientations on one grid and one spacing: the legacy pipeline pairs
# an image with a random label volume, so its volumes (resampled or not)
# must share a grid, as the reference's do
AFFINES = [np.diag([1.0, 1.0, 1.5, 1.0]), np.diag([-1.0, 1.0, 1.5, 1.0]),
           np.array([[0.0, -1.0, 0.0, 10.0], [1.0, 0.0, 0.0, -4.0], [0.0, 0.0, 1.5, 3.0],
                     [0, 0, 0, 1.0]])]
SHAPES = [(20, 22, 18)] * 3
PATCH = (8, 8, 8)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Three image/label pairs in several orientations, with a zero
    background around the foreground, as .nii and .nii.gz."""
    root = tmp_path_factory.mktemp("data")
    rs = np.random.RandomState(0)
    for sub in ("images", "labels"):
        (root / sub).mkdir()
    for i, (shape, aff) in enumerate(zip(SHAPES, AFFINES)):
        img = np.zeros(shape, np.float32)
        img[2:-3, 1:-2, 3:-1] = rs.rand(shape[0] - 5, shape[1] - 3, shape[2] - 4) * 90 + 10
        lbl = (rs.rand(*shape) * 100).astype(np.float32)
        lbl[lbl < 70] = 0.0
        ext = ".nii.gz" if i % 2 else ".nii"
        nifti.save(nifti.NiftiImage(data=img, affine=aff), root / "images" / f"{i}{ext}")
        nifti.save(nifti.NiftiImage(data=lbl, affine=aff), root / "labels" / f"{i}{ext}")
    return root


def _loader(mod, root, cache, pipeline, direction, workers, resample=False):
    ds = mod.UnpairedVolumeDataset(
        root, patch_size=PATCH, pipeline=pipeline, num_samples=3,
        shuffle_labels=(pipeline == "legacy"), which_direction=direction,
        resample=resample, new_resolution=(1.3, 1.0, 0.9), min_pixel=0.1, drop_ratio=0.1,
        cache_dir=str(cache), seed=7)
    return mod.PatchLoader(ds, batch_size=2, shuffle=True, workers=workers)


@pytest.mark.parametrize("pipeline, direction, workers, resample", [
    ("monai", "AtoB", 0, False), ("monai", "BtoA", 2, False), ("monai", "AtoB", 2, False),
    ("legacy", "AtoB", 0, False), ("legacy", "BtoA", 2, False), ("legacy", "AtoB", 2, True),
], ids=["monai-AtoB-w0", "monai-BtoA-w2", "monai-AtoB-w2", "legacy-AtoB-w0",
        "legacy-BtoA-w2", "legacy-AtoB-w2-resample"])
def test_batches_bit_equal_to_jax_every_epoch(data_root, tmp_path, monkeypatch, pipeline,
                                              direction, workers, resample):
    # the JAX package's pure-Python reader and numpy gather against the port's
    # native ones (tests/test_torch_port_native.py holds native against JAX's)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    port = _loader(port_dataset, data_root, tmp_path / "port", pipeline, direction, workers,
                   resample)
    ref = _loader(jax_dataset, data_root, tmp_path / "jax", pipeline, direction, workers,
                  resample)
    assert port.steps_per_epoch() == ref.steps_per_epoch() == 4
    for epoch in (0, 1, 2):  # epoch 0 on a cold cache, then warm
        if epoch == 1:
            port_dataset.flush_cache_writes()
            assert sorted(p.name.split(".", 1)[1] for p in (tmp_path / "port").iterdir()) \
                == ["image.npy"] * 3 + ["label.npy"] * 3
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 4
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.shape == (2, *PATCH, 1) and gi.dtype == np.float32
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    assert not np.array_equal(got[0][0], list(port.epoch(0))[0][0])  # epochs differ


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_loader_raises_what_a_sample_raises(workers):
    """A volume that cannot be sampled ends the epoch with its error at any
    worker count, after the batches before it."""
    class Flaky:
        seed, num_samples = 0, 1

        def __len__(self):
            return 6

        def sample_patches(self, idx, epoch=0):
            if idx == 4:
                raise OSError("truncated volume 4")
            x = np.full((2, 2, 2, 1), float(idx), np.float32)
            return [(x, x)]

    got = []
    with pytest.raises(OSError, match="truncated volume 4"):
        for b, _ in port_dataset.PatchLoader(Flaky(), batch_size=1, shuffle=False,
                                             workers=workers).epoch(0):
            got.append(float(b[0, 0, 0, 0, 0]))
    assert got == [0.0, 1.0, 2.0, 3.0]


def test_list_nifti_orders_numerically(tmp_path):
    for name in ("10.nii", "2.nii.gz", "b.nii", "a.nii", "1.nii", "x.txt"):
        (tmp_path / name).write_bytes(b"")
    assert [p.name for p in port_dataset.list_nifti(tmp_path)] == \
        [p.name for p in jax_dataset.list_nifti(tmp_path)] == \
        ["1.nii", "2.nii.gz", "10.nii", "a.nii", "b.nii"]


def test_dataset_refuses_mismatched_or_empty_dirs(tmp_path):
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    with pytest.raises(ValueError, match="no NIfTI"):
        port_dataset.UnpairedVolumeDataset(tmp_path)
    (tmp_path / "images" / "0.nii").write_bytes(b"")
    with pytest.raises(ValueError, match="count mismatch"):
        port_dataset.UnpairedVolumeDataset(tmp_path)


def test_cache_writer_flush_drains_after_dead_thread(tmp_path):
    w = port_dataset._AsyncCacheWriter()
    path = tmp_path / "x.npy"
    arr = np.arange(6, dtype=np.float32)
    with w._lock:  # queued as submit() would, with no drain thread started
        w._pending[path] = arr
    w._q.put((path, arr))
    w.flush()
    assert path.exists()
    np.testing.assert_array_equal(np.load(path), arr)
    assert w.get_pending(path) is None


def test_preprocess_reads_pending_before_disk(tmp_path):
    """With the image half of a cached pair on disk and the label half still
    in the writer's queue, the sampler reads both from the cache and never
    preprocesses again."""
    rs = np.random.RandomState(0)
    for sub in ("images", "labels"):
        (tmp_path / sub).mkdir()
        nifti.save(nifti.NiftiImage(data=rs.rand(12, 12, 12).astype(np.float32) * 100 + 1,
                                    affine=np.eye(4)), tmp_path / sub / "0.nii")
    ds = port_dataset.UnpairedVolumeDataset(tmp_path, patch_size=PATCH, pipeline="monai",
                                            cache_dir=str(tmp_path / "cache"))
    img, lbl = ds._preprocess(0, 0)
    port_dataset.flush_cache_writes()
    lp = ds._cache_key(ds.image_paths[0], ds.label_paths[0]).with_suffix(".label.npy")
    assert lp.exists()
    lbl_arr = np.array(lbl)
    lp.unlink()
    with port_dataset._CACHE_WRITER._lock:
        port_dataset._CACHE_WRITER._pending[lp] = lbl_arr
    try:
        def boom(*a, **k):
            raise AssertionError("full preprocessing re-ran on a cached pair")

        ds._load = boom
        img2, lbl2 = ds._preprocess(0, 0)
        np.testing.assert_array_equal(np.asarray(img2), np.asarray(img))
        np.testing.assert_array_equal(np.asarray(lbl2), lbl_arr)
    finally:
        with port_dataset._CACHE_WRITER._lock:
            port_dataset._CACHE_WRITER._pending.pop(lp, None)
