"""The port's native data path (mra_gan_tpu_torch/data/native.py, its own copy
of the C++ reader and gather in data/csrc/nifti_io.cc, built with g++ into
build/native/) against the JAX package's (mra_gan_tpu/data/native.py, the
committed native/libmra_native.so), against the port's pure-Python reader and
numpy slicing, and through the loader, whose batches are bit-equal with the
native path and without it. Mirrors tests/test_native.py.

The bars: voxel data bit for bit everywhere, except against JAX's library
where scl_slope != 1. JAX's library is built with -march=native and
contracts s * slope + inter into one FMA; the port builds with
-ffp-contract=off and rounds twice, as numpy (the pure-Python reader) does.
For a product and an intercept of one sign the two differ by at most 1 ulp
of the result. Affines to atol 1e-5 of the written one, and to the
pure-Python reader's at JAX's rtol 1e-6."""
import gzip
import struct
import threading

import numpy as np
import pytest

from mra_gan_tpu.data import native as jax_native
from mra_gan_tpu_torch.data import dataset as port_dataset
from mra_gan_tpu_torch.data import native, nifti


@pytest.fixture(scope="module")
def built():
    """The port's library; the tests skip only where no compiler exists."""
    status = native.build_status()
    if not status["ok"]:
        if status["compiler"] is None:
            pytest.skip(f"the native data path cannot be built: {status['error']}")
        pytest.fail(f"the native library does not build: {status['error']}")
    return status


AFFINE = np.array([[0, -1.1, 0, 5], [1.2, 0, 0, -3], [0, 0, 2.0, 7], [0, 0, 0, 1]])


def _img(shape=(20, 24, 18), seed=0):
    rng = np.random.RandomState(seed)
    return nifti.NiftiImage(data=(rng.rand(*shape) * 500).astype(np.float32), affine=AFFINE)


def _patch_header(path, **fields):
    """Rewrite header fields of a saved .nii/.nii.gz: qform_code, sform_code
    (int16 at 252, 254), scl_slope, scl_inter (float32 at 112, 116)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = bytearray(f.read())
    for name, (fmt, off) in {"qform_code": ("<h", 252), "sform_code": ("<h", 254),
                             "scl_slope": ("<f", 112), "scl_inter": ("<f", 116)}.items():
        if name in fields:
            struct.pack_into(fmt, raw, off, fields[name])
    with opener(path, "wb") as f:
        f.write(bytes(raw))


def _three_readers(path):
    """(port native, JAX native, port pure-Python) reads of ``path``."""
    got = native.load_nifti(path)
    jax = jax_native.load_nifti(path)
    py = nifti.load(path)
    assert got is not None and jax is not None
    return got, jax, py


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_native_reader_matches_jax_and_python(built, tmp_path, ext):
    img = _img()
    p = tmp_path / ("x" + ext)
    nifti.save(img, p)
    (data, affine), (jdata, jaffine), py = _three_readers(p)
    assert data.dtype == np.float32 and data.shape == img.data.shape
    np.testing.assert_array_equal(data, img.data)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(data, py.data)
    np.testing.assert_allclose(affine, img.affine, atol=1e-5)
    np.testing.assert_array_equal(affine, jaffine)
    np.testing.assert_allclose(affine, py.affine, rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float64])
def test_native_reader_dtypes(built, tmp_path, dtype):
    img = _img()
    p = tmp_path / "x.nii"
    nifti.save(img.with_data(img.data.astype(dtype)), p)
    (data, _), (jdata, _), py = _three_readers(p)
    assert data.dtype == np.float32
    np.testing.assert_array_equal(data, img.data.astype(dtype).astype(np.float32))
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(data, py.data.astype(np.float32))


@pytest.mark.parametrize("codes", [(1, 1), (1, 0), (0, 0)], ids=["sform", "qform", "neither"])
@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_native_reader_affine_codes(built, tmp_path, codes, ext):
    """sform_code > 0 takes the sform rows, else qform_code > 0 the
    quaternion (port data/nifti.py's _quaternion_to_affine), else the
    pixdim diagonal."""
    img = _img(seed=1)
    p = tmp_path / ("x" + ext)
    nifti.save(img, p)
    _patch_header(p, qform_code=codes[0], sform_code=codes[1])
    (data, affine), (jdata, jaffine), py = _three_readers(p)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(data, py.data)
    np.testing.assert_array_equal(affine, jaffine)
    np.testing.assert_allclose(affine, py.affine, rtol=1e-6, atol=1e-12)
    if codes != (0, 0):
        np.testing.assert_allclose(affine, img.affine, atol=1e-5)
    else:
        np.testing.assert_allclose(affine, np.diag([1.2, 1.1, 2.0, 1.0]), atol=1e-6)


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_native_reader_scaling(built, tmp_path, ext):
    """scl_slope = 1.7, scl_inter = 3.1 on int16 and float64 data: bit-equal
    to the pure-Python reader; within 1 ulp of JAX's library (its FMA)."""
    rng = np.random.RandomState(2)
    for dtype in (np.int16, np.float64):
        raw = (rng.rand(20, 24, 18) * 3000).astype(dtype)
        p = tmp_path / (f"x_{np.dtype(dtype).name}" + ext)
        nifti.save(nifti.NiftiImage(data=raw, affine=AFFINE), p)
        _patch_header(p, scl_slope=1.7, scl_inter=3.1)
        (data, _), (jdata, _), py = _three_readers(p)
        np.testing.assert_array_equal(data, py.data)
        want = raw.astype(np.float32) * np.float32(1.7) + np.float32(3.1)
        np.testing.assert_array_equal(data, want)
        np.testing.assert_array_max_ulp(data, jdata, maxulp=1)


def test_native_reader_rejects_garbage(built, tmp_path):
    p = tmp_path / "bad.nii"
    p.write_bytes(b"x" * 400)
    assert native.load_nifti(p) is None
    good = tmp_path / "short.nii"
    nifti.save(_img(), good)
    good.write_bytes(good.read_bytes()[:5000])  # truncated voxel data
    assert native.load_nifti(good) is None
    assert native.load_nifti(tmp_path / "missing.nii") is None


def test_patch_extraction_matches_jax_and_numpy(built, tmp_path):
    rng = np.random.RandomState(0)
    vol = rng.rand(30, 28, 26).astype(np.float32)
    starts = np.stack([rng.randint(0, 30 - 8, 50), rng.randint(0, 28 - 8, 50),
                       rng.randint(0, 26 - 8, 50)], 1)
    out = native.extract_patches(vol, starts, (8, 8, 8), n_threads=3)
    np.testing.assert_array_equal(out, jax_native.extract_patches(vol, starts, (8, 8, 8)))
    for i, s in enumerate(starts):
        np.testing.assert_array_equal(
            out[i], vol[s[0]:s[0] + 8, s[1]:s[1] + 8, s[2]:s[2] + 8])
    # the warm cache's read-only memory map, and a non-contiguous view
    np.save(tmp_path / "v.npy", vol)
    mm = np.load(tmp_path / "v.npy", mmap_mode="r")
    assert not mm.flags.writeable
    np.testing.assert_array_equal(native.extract_patches(mm, starts, (8, 8, 8)), out)
    view = np.asfortranarray(vol)
    np.testing.assert_array_equal(native.extract_patches(view, starts, (8, 8, 8), 1), out)


@pytest.mark.parametrize("starts", [[[4, 0, 0]], [[0, -1, 0]], [[0, 0, 1]]])
def test_patch_extraction_bounds_check(built, starts):
    vol = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(ValueError, match="out of bounds"):
        native.extract_patches(vol, np.array(starts), (8, 8, 8))


def test_build_lands_in_build_native_and_is_reused(built, tmp_path, monkeypatch):
    assert built["path"] == str(native.library_path())
    assert native.library_path().parent.parts[-2:] == ("build", "native")
    # concurrent builds into an empty directory publish one library, no leftovers
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(native.build())) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(paths) == 3 and len(set(paths)) == 1 and paths[0].parent == tmp_path / "native"
    assert [p.name for p in (tmp_path / "native").iterdir()] == [paths[0].name]
    mtime = paths[0].stat().st_mtime_ns
    assert native.build() == paths[0] and paths[0].stat().st_mtime_ns == mtime


def test_without_a_compiler_the_loader_falls_back(tmp_path, monkeypatch):
    """No g++: available() is False, the readers return None, build_status()
    says why, and the dataset reads with the pure-Python reader."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", None)
    assert not native.available()
    status = native.build_status()
    assert not status["ok"] and status["compiler"] is None and "g++" in status["error"]
    p = tmp_path / "x.nii"
    nifti.save(_img(), p)
    assert native.load_nifti(p) is None
    assert native.extract_patches(np.zeros((8, 8, 8), np.float32), [[0, 0, 0]], (8, 8, 8)) \
        is None
    np.testing.assert_array_equal(port_dataset.UnpairedVolumeDataset._load(p).data,
                                  _img().data)


# the loader: image/label pairs in several orientations and dtypes, .nii and .nii.gz
LOADER_AFFINES = [np.diag([1.0, 1.0, 1.5, 1.0]), np.diag([-1.0, 1.0, 1.5, 1.0]),
                  np.array([[0.0, -1.0, 0.0, 10.0], [1.0, 0.0, 0.0, -4.0],
                            [0.0, 0.0, 1.5, 3.0], [0, 0, 0, 1.0]])]


@pytest.fixture(scope="module")
def loader_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_data")
    rs = np.random.RandomState(3)
    for sub in ("images", "labels"):
        (root / sub).mkdir()
    for i, (aff, dtype) in enumerate(zip(LOADER_AFFINES, (np.float32, np.int16, np.float32))):
        shape = (20, 22, 18)
        img = np.zeros(shape, np.float32)
        img[2:-3, 1:-2, 3:-1] = rs.rand(shape[0] - 5, shape[1] - 3, shape[2] - 4) * 90 + 10
        lbl = (rs.rand(*shape) * 100).astype(np.float32)
        lbl[lbl < 70] = 0.0
        ext = ".nii.gz" if i % 2 else ".nii"
        nifti.save(nifti.NiftiImage(data=img.astype(dtype), affine=aff),
                   root / "images" / f"{i}{ext}")
        nifti.save(nifti.NiftiImage(data=lbl, affine=aff), root / "labels" / f"{i}{ext}")
    return root


def _epochs(root, cache, pipeline, workers):
    ds = port_dataset.UnpairedVolumeDataset(
        root, patch_size=(8, 8, 8), pipeline=pipeline, num_samples=3,
        shuffle_labels=(pipeline == "legacy"), min_pixel=0.1, drop_ratio=0.1,
        cache_dir=str(cache), seed=5)
    loader = port_dataset.PatchLoader(ds, batch_size=2, shuffle=True, workers=workers)
    out = []
    for epoch in (0, 1):  # a cold cache, then the warm one's memory maps
        out.append(list(loader.epoch(epoch)))
        port_dataset.flush_cache_writes()
    return out


@pytest.mark.parametrize("pipeline, workers", [("monai", 2), ("legacy", 0)])
def test_loader_batches_bit_equal_with_and_without_native(built, loader_root, tmp_path,
                                                          monkeypatch, pipeline, workers):
    calls = {"load_nifti": 0, "extract_patches": 0}

    def counted(name):
        fn = getattr(native, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    with monkeypatch.context() as m:
        for name in calls:
            m.setattr(native, name, counted(name))
        fast = _epochs(loader_root, tmp_path / "fast", pipeline, workers)
    assert calls["load_nifti"] >= 6 and calls["extract_patches"] == 2 * 2 * 3
    monkeypatch.setattr(native, "available", lambda: False)
    slow = _epochs(loader_root, tmp_path / "slow", pipeline, workers)
    assert [len(e) for e in fast] == [len(e) for e in slow] == [4, 4]
    for fe, se in zip(fast, slow):
        for (fi, fl), (si, sl) in zip(fe, se):
            assert fi.shape == (2, 8, 8, 8, 1) and fi.dtype == np.float32
            np.testing.assert_array_equal(fi, si)
            np.testing.assert_array_equal(fl, sl)
