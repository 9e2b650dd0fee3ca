"""Pipeline QA CLI (counterpart of the root check_loader_patches.py; the
reference's check_loader_patches.py:35-80). Draws one volume's sample patches
through the training pipeline and either saves an orthogonal-slice PNG
contact sheet (``--out``, headless) or opens the scroll-wheel slice viewer
(with a display):

    python -m mra_gan_tpu_torch.check_loader_patches --data_path <dir with
        images/ labels/> --index 0 --out patches.png

Host code only: no device. matplotlib is imported after the patches are
drawn and printed, so the summary line needs none.
"""
from __future__ import annotations

import argparse

import numpy as np

from .data.dataset import UnpairedVolumeDataset


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data_path", type=str, default="./Data_folder/train/")
    p.add_argument("--patch_size", type=int, nargs=3, default=[64, 64, 64])
    p.add_argument("--pipeline", type=str, default="monai", choices=["monai", "legacy"])
    p.add_argument("--num_samples", type=int, default=2)
    p.add_argument("--index", type=int, default=-1, help="volume index (-1 = random)")
    p.add_argument("--out", type=str, default="", help="save PNG here instead of showing")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


class SliceScroller:
    """Mouse-wheel z-scroll viewer (the reference IndexTracker idea): one
    axial slice of ``vol`` on ``ax``, moved one slice per wheel step and
    clamped to the volume."""

    def __init__(self, ax, vol, title):
        self.ax = ax
        self.vol = vol
        self.z = vol.shape[0] // 2
        self.im = ax.imshow(vol[self.z], cmap="gray")
        ax.set_title(title)
        self.update()

    def on_scroll(self, event):
        self.z = int(np.clip(self.z + (1 if event.button == "up" else -1),
                             0, self.vol.shape[0] - 1))
        self.update()

    def update(self):
        self.im.set_data(self.vol[self.z])
        self.ax.set_ylabel(f"slice {self.z}")
        self.im.axes.figure.canvas.draw()


def contact_sheet(img: np.ndarray, lbl: np.ndarray, out: str) -> None:
    """A 2 x 3 PNG of the image's and the label's axial, coronal and
    sagittal mid-slices, written under Agg."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(9, 6))
    mids = [s // 2 for s in img.shape]
    views = [
        ("axial", img[mids[0]], lbl[mids[0]]),
        ("coronal", img[:, mids[1]], lbl[:, mids[1]]),
        ("sagittal", img[:, :, mids[2]], lbl[:, :, mids[2]]),
    ]
    for col, (name, iv, lv) in enumerate(views):
        axes[0, col].imshow(iv, cmap="gray")
        axes[0, col].set_title(f"image {name}")
        axes[1, col].imshow(lv, cmap="gray")
        axes[1, col].set_title(f"label {name}")
        for r in range(2):
            axes[r, col].axis("off")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def show(img: np.ndarray, lbl: np.ndarray) -> None:
    """The scroll-wheel viewer of the image and label patches, side by side."""
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2)
    s1 = SliceScroller(ax1, img, "image")
    s2 = SliceScroller(ax2, lbl, "label")
    fig.canvas.mpl_connect("scroll_event", s1.on_scroll)
    fig.canvas.mpl_connect("scroll_event", s2.on_scroll)
    plt.show()


def main(argv=None):
    args = parse_args(argv)
    ds = UnpairedVolumeDataset(
        args.data_path, patch_size=args.patch_size, pipeline=args.pipeline,
        num_samples=args.num_samples, shuffle_labels=(args.pipeline == "legacy"),
        seed=args.seed)
    idx = np.random.randint(len(ds)) if args.index < 0 else args.index
    img, lbl = ds.sample_patches(idx, epoch=0)[0]
    img, lbl = img[..., 0], lbl[..., 0]
    print(f"volume {idx}: image patch {img.shape} [{img.min():.2f}, {img.max():.2f}], "
          f"label patch {lbl.shape} [{lbl.min():.2f}, {lbl.max():.2f}]")
    if args.out:
        contact_sheet(img, lbl, args.out)
        print(f"wrote {args.out}")
        return
    show(img, lbl)


if __name__ == "__main__":
    main()
