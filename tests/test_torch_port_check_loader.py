"""``python -m mra_gan_tpu_torch.check_loader_patches`` against the root
check_loader_patches.py of the JAX package on the same synthetic data, index
and seed: the printed line and the drawn patches equal, for both pipelines;
the --out contact sheet a readable PNG; the scroll-wheel viewer clamped at
both ends, under Agg with fake scroll events."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from matplotlib.backend_bases import MouseEvent  # noqa: E402

from mra_gan_tpu_torch import check_loader_patches as port_check  # noqa: E402
from mra_gan_tpu_torch.data import nifti  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_check_loader_patches",
                                                  REPO / "check_loader_patches.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("check_data")
    rs = np.random.RandomState(21)
    for sub in ("images", "labels"):
        (root / sub).mkdir()
    for i, aff in enumerate([np.diag([1.0, 1.0, 1.5, 1.0]), np.diag([-1.0, 1.0, 1.5, 1.0]),
                             np.diag([1.0, -1.0, 1.5, 1.0])]):
        shape = (20, 22, 18)
        img = np.zeros(shape, np.float32)
        img[2:-3, 1:-2, 3:-1] = rs.rand(shape[0] - 5, shape[1] - 3, shape[2] - 4) * 90 + 10
        lbl = (rs.rand(*shape) * 100).astype(np.float32)
        lbl[lbl < 60] = 0.0
        nifti.save(nifti.NiftiImage(data=img, affine=aff), root / "images" / f"{i}.nii.gz")
        nifti.save(nifti.NiftiImage(data=lbl, affine=aff), root / "labels" / f"{i}.nii")
    return root


def _recording(mod, monkeypatch):
    """Replace the script's dataset class with one that records what
    sample_patches returns."""
    drawn = []

    class Recording(mod.UnpairedVolumeDataset):
        def sample_patches(self, idx, epoch=0):
            out = super().sample_patches(idx, epoch)
            drawn.append((idx, epoch, out))
            return out

    monkeypatch.setattr(mod, "UnpairedVolumeDataset", Recording)
    return drawn


@pytest.mark.parametrize("pipeline, index, seed", [("monai", 1, 0), ("legacy", 2, 3)])
def test_line_and_patches_equal_the_jax_script(data_root, tmp_path, monkeypatch, capsys,
                                               pipeline, index, seed):
    jax_mod = _jax_script()
    args = ["--data_path", str(data_root), "--patch_size", "8", "8", "8", "--pipeline",
            pipeline, "--num_samples", "3", "--index", str(index), "--seed", str(seed)]
    port_drawn = _recording(port_check, monkeypatch)
    jax_drawn = _recording(jax_mod, monkeypatch)
    port_check.main(args + ["--out", str(tmp_path / "port.png")])
    port_out = capsys.readouterr().out.splitlines()
    jax_mod.main(args + ["--out", str(tmp_path / "jax.png")])
    jax_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == jax_out[0]
    assert port_out[0].startswith(f"volume {index}: image patch (8, 8, 8) [")
    assert port_out[1:] == [f"wrote {tmp_path / 'port.png'}"]
    assert len(port_drawn) == len(jax_drawn) == 1
    (pi, pe, pp), (ji, je, jp) = port_drawn[0], jax_drawn[0]
    assert (pi, pe) == (ji, je) == (index, 0) and len(pp) == len(jp) == 3
    for (a, b), (c, d) in zip(pp, jp):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_random_index_draws_from_the_global_rng_as_jax_does(data_root, capsys):
    jax_mod = _jax_script()
    args = ["--data_path", str(data_root), "--patch_size", "8", "8", "8", "--out", os.devnull]
    lines = []
    for main in (port_check.main, jax_mod.main):
        np.random.seed(17)
        main(args)
        lines.append(capsys.readouterr().out.splitlines()[0])
    assert lines[0] == lines[1]
    np.random.seed(17)
    assert lines[0].startswith(f"volume {np.random.randint(3)}: ")


def test_out_writes_a_readable_png(data_root, tmp_path):
    out = tmp_path / "sheet.png"
    port_check.main(["--data_path", str(data_root), "--patch_size", "8", "8", "8",
                     "--index", "0", "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    img = plt.imread(out)
    assert img.shape[:2] == (720, 1080)  # 9 x 6 inches at 120 dpi
    assert float(img[..., :3].std()) > 0.0


def test_module_runs_as_a_cli(data_root, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), MPLBACKEND="Agg")
    proc = subprocess.run([sys.executable, "-m", "mra_gan_tpu_torch.check_loader_patches",
                           "--data_path", str(data_root), "--patch_size", "8", "8", "8",
                           "--index", "0", "--out", str(tmp_path / "x.png")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("volume 0: image patch (8, 8, 8)")
    assert (tmp_path / "x.png").exists()


def _scroll(fig, button):
    event = MouseEvent("scroll_event", fig.canvas, 10, 10, button=button,
                       step=1 if button == "up" else -1)
    fig.canvas.callbacks.process("scroll_event", event)


def test_scroller_clamps_at_both_ends():
    vol = np.arange(5 * 4 * 3, dtype=np.float32).reshape(5, 4, 3)
    fig, ax = plt.subplots()
    s = port_check.SliceScroller(ax, vol, "image")
    fig.canvas.mpl_connect("scroll_event", s.on_scroll)
    assert s.z == 2 and ax.get_title() == "image" and ax.get_ylabel() == "slice 2"
    for _ in range(4):
        _scroll(fig, "up")
    assert s.z == 4 and ax.get_ylabel() == "slice 4"
    np.testing.assert_array_equal(s.im.get_array(), vol[4])
    for _ in range(7):
        _scroll(fig, "down")
    assert s.z == 0 and ax.get_ylabel() == "slice 0"
    np.testing.assert_array_equal(s.im.get_array(), vol[0])
    plt.close(fig)


def test_viewer_mode_scrolls_both_patches(data_root, monkeypatch, capsys):
    """Without --out, main opens the viewer: both panels scroll together from
    the middle slice. The events are sent from inside plt.show, where the
    viewer blocks (the canvas holds its scrollers' callbacks weakly)."""
    seen = []

    def show():
        fig = plt.gcf()
        ax1, ax2 = fig.axes
        seen.append((ax1.get_title(), ax2.get_title(), ax1.get_ylabel()))
        _scroll(fig, "up")
        seen.append((ax1.get_ylabel(), ax2.get_ylabel()))
        for _ in range(10):
            _scroll(fig, "down")
        seen.append((ax1.get_ylabel(), ax2.get_ylabel()))
        plt.close(fig)

    monkeypatch.setattr(plt, "show", show)
    port_check.main(["--data_path", str(data_root), "--patch_size", "8", "8", "8",
                     "--index", "0"])
    assert capsys.readouterr().out.startswith("volume 0: ")
    assert seen == [("image", "label", "slice 4"), ("slice 5", "slice 5"),
                    ("slice 0", "slice 0")]
