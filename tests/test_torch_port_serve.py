"""The port's serving daemon (``python -m mra_gan_tpu_torch.serve``) on the
CPU: every behaviour of tests/test_serve.py (drain once, the ready gate, a
file deleted and restored, a corrupt input isolated, hidden files skipped,
--watch equal to --result refused, a failed decode retried, --stop_file
mid-batch, concurrent saves to one target), and each served volume
bit-equal to the port's own ``inference`` of the file and within the decode
CLI's bar of the JAX CLI's."""
import argparse
import importlib.util
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from mra_gan_tpu.checkpoint import save_torch_network
from mra_gan_tpu.models.cycle_gan import CycleGANConfig as JaxConfig
from mra_gan_tpu_torch import serve as serve_cli
from mra_gan_tpu_torch import test as test_cli
from mra_gan_tpu_torch.data import nifti

from torch_port_util import jax_forward, jax_generator

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--patch_size", "16", "16", "16", "--ngf", "4", "--ndf", "4", "--n_layers_D", "1",
         "--precision", "float32", "--stride_inplane", "8", "--stride_layer", "8",
         "--device", "cpu"]
# the decode CLI's bar against the JAX CLI (tests/test_torch_port_cli.py)
TOL_0_255 = 0.05


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A checkpoint directory with latest_net_G_A.pth of a seeded JAX
    generator, and the JAX generator itself."""
    root = tmp_path_factory.mktemp("serve_ck")
    jnet, params = jax_generator(seed=21)
    (root / "srv").mkdir()
    save_torch_network(params, root / "srv" / "latest_net_G_A.pth", arch="resnet_6blocks")
    return root, jnet, params


def _save(path, seed, shape=(20, 18, 16), aff=None):
    data = np.random.RandomState(seed).rand(*shape).astype(np.float32) * 90
    nifti.save(nifti.NiftiImage(data=data, affine=np.eye(4) if aff is None else aff), path)


def _args(ck, watch, out, *extra):
    return ["--watch", str(watch), "--result", str(out), "--checkpoints_dir", str(ck),
            "--name", "srv", "--model_suffix", "_A", *SMALL, *extra]


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):
    """Two good volumes and one corrupt file, drained by --once."""
    ck = weights[0]
    tmp = tmp_path_factory.mktemp("serve")
    watch, out = tmp / "watch", tmp / "out"
    watch.mkdir()
    aff = np.diag([1.0, 1.0, 2.0, 1.0])
    _save(watch / "v0.nii", 0, aff=aff)
    _save(watch / "v1.nii.gz", 1, (19, 21, 15), aff)
    (watch / "corrupt.nii").write_bytes(b"not a nifti at all")
    served_n, failures = serve_cli.main(_args(ck, watch, out, "--once", "--poll_secs", "0.05"))
    return watch, out, aff, served_n, failures


def test_serve_once_drains_directory(served):
    watch, out, aff, served_n, failures = served
    assert served_n == 2 and failures == 1
    for name in ("v0.nii", "v1.nii.gz"):
        res, inp = nifti.load(out / name), nifti.load(watch / name)
        assert res.data.shape == inp.data.shape
        assert np.allclose(res.affine, aff)
        assert np.isfinite(res.data).all()
        assert 0 <= float(res.data.min()) and float(res.data.max()) <= 255.0


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_test_cli", REPO / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_served_volumes_equal_inference_and_the_jax_cli(served, weights):
    watch, out, _, _, _ = served
    ck, jnet, params = weights
    opt = serve_cli.parse(_args(ck, watch, out))
    gen = test_cli.load_generator(opt)
    loaded = (JaxConfig(ngf=4), jax_forward(jnet, params), params, jnet)
    jax_cli = _jax_cli()
    for name in ("v0.nii", "v1.nii.gz"):
        sub = argparse.Namespace(**vars(opt))
        sub.image = str(watch / name)
        want = test_cli.inference(sub, gen, save=False)
        got = nifti.load(out / name)
        np.testing.assert_array_equal(got.data, want.data)
        ref = jax_cli.inference(sub, loaded=loaded, save=False)
        np.testing.assert_allclose(got.data, ref.data, atol=TOL_0_255)


def test_serve_isolates_corrupt_inputs(served):
    _, out, _, _, failures = served
    assert failures == 1
    log = (out / "failed.log").read_text()
    assert "corrupt.nii" in log and "decode" in log
    assert not (out / "corrupt.nii").exists()
    assert not [p for p in out.iterdir() if p.name.startswith(".tmp-")]


def test_ready_gate_semantics():
    done = {}
    assert serve_cli._ready({"a.nii": (10, 1.0)}, {}, done) == []
    assert serve_cli._ready({"a.nii": (10, 1.0)}, {"a.nii": (10, 1.0)}, done) == ["a.nii"]
    done["a.nii"] = (10, 1.0)
    assert serve_cli._ready({"a.nii": (10, 1.0)}, {"a.nii": (10, 1.0)}, done) == []
    assert serve_cli._drained({"a.nii": (10, 1.0)}, done)
    # a file that grows after it was served is served again once it settles
    assert not serve_cli._drained({"a.nii": (99, 2.0)}, done)
    assert serve_cli._ready({"a.nii": (99, 2.0)}, {"a.nii": (10, 1.0)}, done) == []
    assert serve_cli._ready({"a.nii": (99, 2.0)}, {"a.nii": (99, 2.0)}, done) == ["a.nii"]
    done["a.nii"] = (99, 2.0)
    assert not serve_cli._drained({"a.nii": (120, 3.0)}, done)


def test_scan_skips_hidden_files(tmp_path):
    (tmp_path / "good.nii").write_bytes(b"x")
    (tmp_path / ".tmp-123-0-good.nii").write_bytes(b"x")
    (tmp_path / ".hidden.nii.gz").write_bytes(b"x")
    (tmp_path / "notes.txt").write_bytes(b"x")
    assert sorted(serve_cli._scan(tmp_path)) == ["good.nii"]


def test_serve_rejects_watch_equals_result(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    with pytest.raises(SystemExit, match="different directories"):
        serve_cli.main(_args(tmp_path / "no_ck", d, d, "--once"))


def _wait_for(cond, timeout=120):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_serve_reserves_deleted_then_restored_file(weights, tmp_path):
    watch, out, stop = tmp_path / "watch", tmp_path / "out", tmp_path / "stop"
    watch.mkdir()
    _save(watch / "a.nii", 0)
    result = {}

    def run():
        result["rv"] = serve_cli.main(_args(weights[0], watch, out, "--poll_secs", "0.05",
                                            "--stop_file", str(stop)))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        assert _wait_for(lambda: (out / "a.nii").exists())
        sig = (watch / "a.nii").stat()
        data = (watch / "a.nii").read_bytes()
        (out / "a.nii").unlink()
        (watch / "a.nii").unlink()
        time.sleep(0.5)  # several polls without the file
        (watch / "a.nii").write_bytes(data)
        os.utime(watch / "a.nii", (sig.st_atime, sig.st_mtime))
        assert (watch / "a.nii").stat().st_size == sig.st_size
        assert _wait_for(lambda: (out / "a.nii").exists()), \
            "identically-restored file was never re-served"
    finally:
        stop.write_text("")
        t.join(timeout=120)
    assert not t.is_alive()
    assert result["rv"] == (2, 0)


def test_transient_decode_failure_is_retried(weights, tmp_path, monkeypatch):
    watch, out = tmp_path / "watch", tmp_path / "out"
    watch.mkdir()
    _save(watch / "a.nii", 0)
    real_inference = test_cli.inference
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated device failure")
        return real_inference(*a, **kw)

    monkeypatch.setattr(test_cli, "inference", flaky)
    served_n, failures = serve_cli.main(_args(weights[0], watch, out, "--once",
                                              "--poll_secs", "0.01"))
    assert calls["n"] == 2, "failed decode was never retried"
    assert (served_n, failures) == (1, 1)
    assert (out / "a.nii").exists()
    assert "will retry" not in (out / "failed.log").read_text()


def test_decode_failures_give_up_after_max_attempts(weights, tmp_path, monkeypatch):
    watch, out = tmp_path / "watch", tmp_path / "out"
    watch.mkdir()
    _save(watch / "a.nii", 0)
    calls = {"n": 0}

    def broken(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("always fails")

    monkeypatch.setattr(test_cli, "inference", broken)
    served_n, failures = serve_cli.main(_args(weights[0], watch, out, "--once",
                                              "--poll_secs", "0.01"))
    assert calls["n"] == serve_cli.MAX_DECODE_ATTEMPTS == 3
    assert (served_n, failures) == (0, 3)
    assert (out / "failed.log").read_text().count("a.nii\tdecode") == 3


def test_stop_file_breaks_mid_batch(weights, tmp_path, monkeypatch):
    watch, out, stop = tmp_path / "watch", tmp_path / "out", tmp_path / "stop"
    watch.mkdir()
    for i in range(3):
        _save(watch / f"v{i}.nii", i)
    real_inference = test_cli.inference

    def stopping_inference(*a, **kw):
        res = real_inference(*a, **kw)
        stop.write_text("")  # stop requested while the batch is draining
        return res

    monkeypatch.setattr(test_cli, "inference", stopping_inference)
    served_n, failures = serve_cli.main(_args(weights[0], watch, out, "--poll_secs", "0.05",
                                              "--stop_file", str(stop)))
    assert (served_n, failures) == (1, 0)
    assert (out / "v0.nii").exists()
    assert not (out / "v2.nii").exists()


def test_concurrent_saves_to_same_target_do_not_corrupt(tmp_path):
    rs = np.random.RandomState(0)
    imgs = [nifti.NiftiImage(data=rs.rand(12, 10, 8).astype(np.float32), affine=np.eye(4))
            for _ in range(2)]
    target = tmp_path / "same.nii"
    errs = []

    def run(img):
        try:
            serve_cli._atomic_save(img, target)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=run, args=(img,)) for img in imgs for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in ts)
    got = nifti.load(target)
    assert any(np.array_equal(got.data, img.data) for img in imgs)
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp-")]


def test_serve_parser_is_the_decode_parser_plus_the_daemon_flags():
    from mra_gan_tpu_torch.options.test_options import build_parser

    serve_flags = {s for a in serve_cli.build_serve_parser()._actions for s in a.option_strings}
    decode_flags = {s for a in build_parser()._actions for s in a.option_strings}
    assert serve_flags - decode_flags == {"--watch", "--poll_secs", "--once", "--stop_file"}
    opt = serve_cli.parse(["--watch", "w", "--suffix", "{netG}"])
    assert opt.name == "experiment_name_resnet_6blocks" and opt.poll_secs == 2.0
