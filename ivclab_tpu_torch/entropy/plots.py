"""Distribution plotting helpers, headless.

Port of ``ivclab_tpu/entropy/plots.py`` (the course reference's
plot_histogram and plot_image_and_joint_histogram): figures are returned
and optionally saved, and shown only with ``show=True``. matplotlib is
imported inside the functions, so the package needs it only for plots.
"""

from __future__ import annotations

import sys

import numpy as np

from ivclab_tpu_torch.utils.io import _host


def _plt():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg", "module://matplotlib_inline.backend_inline"):
        if not sys.stdout.isatty():
            matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_histogram(image, grayscale: bool = False, title: str | None = None,
                   save_path: str | None = None, show: bool = False):
    """Image + per-channel intensity histograms (one panel per channel).
    ``image`` is an array, a tensor or a file path. Returns the figure."""
    plt = _plt()
    if isinstance(image, str):
        from ivclab_tpu_torch.utils.io import imread

        if title is None:
            title = image.rsplit("/", 1)[-1]
        image = imread(image)
    img = _host(image)
    if grayscale and img.ndim == 3:
        from ivclab_tpu_torch.ops.color import rgb2gray

        # rgb2gray keeps a channel axis; the JAX package's version then
        # indexes three channels of it and fails
        img = rgb2gray(img.astype(np.float32)).numpy()[..., 0]
    if img.dtype != np.uint8:
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)

    gray = img.ndim == 2
    fig, axes = plt.subplots(1, 2 if gray else 4, figsize=(18, 4))
    fig.suptitle(f"Histogram for {title}" if title else "Histogram")

    axes[0].imshow(img, cmap="gray" if gray else None)
    axes[0].set_axis_off()
    axes[0].set_title("Original Image")

    if gray:
        hist = np.bincount(img.reshape(-1), minlength=256)
        axes[1].bar(range(256), hist, color="gray")
        axes[1].set_title("Grayscale Histogram")
        axes[1].set_xlabel("Intensity")
        axes[1].set_ylabel("Frequency")
    else:
        for i, color in enumerate(("red", "green", "blue")):
            hist = np.bincount(img[:, :, i].reshape(-1), minlength=256)
            axes[i + 1].bar(range(256), hist, color=color)
            axes[i + 1].set_title(f"{color.upper()} Channel")
            axes[i + 1].set_xlabel("Intensity")
            axes[i + 1].set_ylabel("Frequency")

    fig.tight_layout()
    fig.subplots_adjust(top=0.85)
    if save_path:
        fig.savefig(save_path)
    if show:
        plt.show()
    return fig


def plot_image_and_joint_histogram(image, joint_pmf, title: str = "", to_gray: bool = False,
                                   save_path: str | None = None, show: bool = False):
    """Image beside its horizontal-pair joint pmf as a heat map.
    ``joint_pmf`` is the flat ``[B*B]`` pmf of
    :func:`ivclab_tpu_torch.entropy.stats.stats_joint` or a ``[B, B]``
    matrix. Returns the figure."""
    plt = _plt()
    pmf = _host(joint_pmf)
    if pmf.ndim == 1:
        b = int(round(np.sqrt(pmf.size)))
        pmf = pmf.reshape(b, b)

    fig, (ax_img, ax_joint) = plt.subplots(1, 2, figsize=(10, 4))
    ax_img.imshow(_host(image), cmap=None if to_gray else "gray")
    ax_img.set_title(f"Original Image: {title}")
    ax_img.set_axis_off()

    im = ax_joint.imshow(pmf, cmap="hot", interpolation="nearest")
    ax_joint.set_title("Joint Histogram (horizontal pairs)")
    ax_joint.set_xlabel("Pixel i")
    ax_joint.set_ylabel("Pixel i+1")
    fig.colorbar(im, ax=ax_joint, label="Probability")

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    if show:
        plt.show()
    return fig
